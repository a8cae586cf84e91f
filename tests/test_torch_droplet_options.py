"""The LC droplet's options against ludwig_tpu's, on the CPU: the split
stresses of `fe_force_method relaxation_antisymmetric`, in-lattice solids
(solid planes, a porous map), every fluid stencil and advection orders
3-5 of make_droplet_step, and the sheared step's stencil and order.

The same numpy arrays, made from a seed at 8x8x16, go through the JAX
function and its counterpart in ludwig_tpu_torch.  The JAX steps run
eagerly (the jit's __wrapped__ function): an XLA compile of each
configuration would cost more than the steps.  Tolerances are those of
tests/test_torch_droplet.py: f64 rtol 1e-12 / atol 1e-14 for the free
energy's methods, rtol 1e-10 / atol 1e-12 after three whole steps."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import lc_droplet_sim as jsim
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.ops.lees_edwards import LeesEdwardsConfig as JLE
from ludwig_tpu_torch import lc_droplet
from ludwig_tpu_torch.convert import droplet_params_from_jax
from ludwig_tpu_torch.io.map_file import GEOMETRIES
from ludwig_tpu_torch.ops.lees_edwards import LeesEdwardsConfig
from ludwig_tpu_torch.ops.stencil import GRADIENTS
from ludwig_tpu_torch.ops.stream import wall_solid_mask
from test_torch_droplet import N, STEP_TOL, TOL, _fes, _phi_q, _stack


def _cfgs(order=1, gradient="3d_7pt_fluid", method="stress_divergence",
          size=N, walls=(False, False, False)):
    jfe, _tfe = _fes(zeta0=0.002, zeta1=0.01)
    jcfg = jsim.LCDropletConfig(
        lb=JLBConfig(size=size, nvel=19, eta_shear=0.5, dtype="float64",
                     walls=walls),
        fe=jfe, mobility=0.05, gamma=0.5, advection_order=order,
        gradient=gradient, force_method=method)
    return jcfg, droplet_params_from_jax(dataclasses.asdict(jcfg),
                                         device="cpu")


@pytest.mark.parametrize("method", ["stress_symm", "stress_anti"])
def test_split_stresses_match_jax(method):
    """stress_symm (with the active term) and stress_anti, and their sum
    the whole qh stress."""
    phi, q = _phi_q()
    jfields = jsim.droplet_fields(jnp.asarray(phi), jnp.asarray(q),
                                  "3d_7pt_fluid")
    tfields = lc_droplet.droplet_fields(torch.as_tensor(phi),
                                        torch.as_tensor(q))
    jfe, tfe = _fes(zeta0=0.002, zeta1=0.01)
    want = np.asarray(getattr(jfe, method)(jfields))
    got = _stack(getattr(tfe, method)(tfields))
    np.testing.assert_allclose(got, want, **TOL)
    whole = _stack(tfe.stress_symm(tfields)) + _stack(
        tfe.stress_anti(tfields))
    np.testing.assert_allclose(whole, _stack(tfe.stress_qh(tfields)),
                               rtol=1e-12, atol=1e-15)


def _porous_map(size=N):
    """A simple-cubic porous map (io/map_file.GEOMETRIES) with solid walls
    on x: what the CLI's solid_mask makes of both keys."""
    return GEOMETRIES["simple_cubic"](size, 4) != 0


CASES = {
    "solid-planes": dict(walls=(False, False, True)),
    "porous": dict(porous=True),
    "relaxation_antisymmetric": dict(method="relaxation_antisymmetric"),
    "relaxation_antisymmetric-walls": dict(method="relaxation_antisymmetric",
                                           walls=(True, False, False),
                                           porous=True, order=2),
    **{g: dict(gradient=g) for g in GRADIENTS},
    **{f"order-{o}": dict(order=o) for o in (3, 4, 5)},
}


@pytest.mark.parametrize("name", list(CASES))
def test_droplet_step_options_match_jax(name):
    """Three steps of make_droplet_step against ludwig_tpu's, eagerly, at
    the droplet tests' tolerance; the solid sites keep their
    populations."""
    case = dict(CASES[name])
    porous = case.pop("porous", False)
    walls = case.pop("walls", (False, False, False))
    jcfg, tcfg = _cfgs(walls=walls, **case)
    solid = wall_solid_mask(N, walls)
    if porous:
        solid = solid | _porous_map()
    if not solid.any():
        solid = None
    phi, q = _phi_q(3)
    js = jsim.initial_droplet(jcfg, phi, q)
    ts = lc_droplet.initial_droplet(tcfg, phi, q)
    jstep = jsim.make_droplet_step(
        jcfg, None if solid is None else jnp.asarray(solid)).__wrapped__
    tstep = lc_droplet.make_droplet_step(
        tcfg, None if solid is None else torch.as_tensor(solid))
    f0 = ts[0].clone()
    for t in range(3):
        js, jrho = jstep(js, t)
        ts, trho = tstep(ts, t)
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), **STEP_TOL)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP_TOL)
    if solid is not None:
        s = torch.as_tensor(solid)
        assert torch.equal(ts[0][:, s], f0[:, s])


def test_droplet_nstep_is_n_steps_with_a_solid():
    """make_droplet_nstep with a solid and the relaxation force: bitwise
    n single steps."""
    _jcfg, tcfg = _cfgs(order=3, gradient="3d_27pt_fluid",
                        method="relaxation_antisymmetric")
    solid = torch.as_tensor(_porous_map())
    phi, q = _phi_q(4)
    state = lc_droplet.initial_droplet(tcfg, phi, q)
    chained = lc_droplet.make_droplet_nstep(tcfg, solid)(state, 3)
    step = lc_droplet.make_droplet_step(tcfg, solid)
    for t in range(3):
        state, _rho = step(state, t)
    for a, b in zip(state, chained):
        assert torch.equal(a, b)


@pytest.mark.parametrize("gradient,order", [("3d_27pt_fluid", 3),
                                            ("2d_5pt_fluid", 5)])
def test_droplet_le_step_options_match_jax(gradient, order):
    """The sheared step takes the stencil (the 27-point one; the others
    the 7-point form, as the JAX package's le_gradient) and the order: two
    steps against ludwig_tpu's make_droplet_le_step, eagerly."""
    size = (16, 8, 16)
    jcfg, tcfg = _cfgs(order=order, gradient=gradient, size=size)
    jle = JLE(nplanes=2, uy=0.04, nx=size[0])
    tle = LeesEdwardsConfig(nplanes=2, uy=0.04, nx=size[0])
    rng = np.random.default_rng(7)
    phi = 0.05 * (rng.random(size) - 0.5)
    q = 0.05 * rng.standard_normal((5,) + size)
    u = 1e-3 * rng.standard_normal((3,) + size)
    js = jsim.initial_droplet(jcfg, phi, q)
    js = js[:3] + (jnp.asarray(u),)
    ts = lc_droplet.initial_droplet(tcfg, phi, q)
    ts = ts[:3] + (torch.as_tensor(u),)
    jstep = jsim.make_droplet_le_step(jcfg, jle).__wrapped__
    tstep = lc_droplet.make_droplet_le_step(tcfg, tle)
    for t in range(2):
        js, jrho = jstep(js, t)
        ts, trho = tstep(ts, t)
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), **STEP_TOL)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP_TOL)


def test_droplet_le_step_refuses_the_relaxation_force():
    """The JAX package's sheared step forces the whole qh stress whatever
    fe_force_method says; the port refuses the relaxation force there."""
    _jcfg, tcfg = _cfgs(method="relaxation_antisymmetric", size=(16, 8, 16))
    with pytest.raises(NotImplementedError, match="relaxation_antisym"):
        lc_droplet.make_droplet_le_step(
            tcfg, LeesEdwardsConfig(nplanes=2, uy=0.04, nx=16))
