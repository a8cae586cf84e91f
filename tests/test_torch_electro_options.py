"""The electrolyte's float32 kernel route on a porous solid against
ludwig_tpu's, on the CPU.

The port's route (sor_solve, np_gradmu and the solid K2; on the CPU their
twins) runs over the Gouy-Chapman walls joined with a simple-cubic porous
map and walls on y, as the CLI's solid_mask makes them; the JAX side is
its three Pallas kernels in interpret mode, as tests/
test_torch_fused_electro.py runs them over the charged walls alone.  The
bounds are that test's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import electro as jel
from ludwig_tpu import electro_sim as jes
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.ops import fused as jfused
from ludwig_tpu.ops import fused_electro as jfe
from ludwig_tpu_torch import electro_sim as tes
from ludwig_tpu_torch.convert import electro_params_from_jax
from ludwig_tpu_torch.io.map_file import GEOMETRIES
from ludwig_tpu_torch.ops import fused_electro as tfe
from ludwig_tpu_torch.ops.stream import wall_solid_mask
from test_torch_fused_electro import _jax_f32_step, _t

SIZE = (8, 8, 16)


def _porous_solid(size=SIZE):
    """The charged walls on x, walls on y and a simple-cubic porous map:
    scattered solid sites with fluid on every side of many of them."""
    _psi, _rho, boundary = jes.init_gouy_chapman(size, 1.04e-3, 3.125e-2)
    solid = (boundary | wall_solid_mask(size, (False, True, False))
             | (GEOMETRIES["simple_cubic"](size, 4) != 0))
    return boundary, solid


def test_np_gradmu_twin_on_a_porous_mask_matches_pallas_interpret():
    """np_gradmu over an irregular fluid mask, f32: the force after the
    mean within 1e-7, rho' within 1e-8; no flux through a solid face (the
    charge in each species conserved to f32 rounding)."""
    jek = jel.ElectroConfig(valency=(1, -1), diffusivity=(0.01, 0.0095),
                            beta=3.0e-4, epsilon=3.3e3, rel_tol=1e-6,
                            abs_tol=1e-7, max_its=500, solver="sor")
    jcfg = jes.ElectroSimConfig(
        lb=JLBConfig(size=SIZE, nvel=19, eta_shear=0.1, dtype="float32"),
        ek=jek)
    tcfg = electro_params_from_jax(dataclasses.asdict(jcfg), device="cpu")
    rng = np.random.default_rng(6)
    _b, solid = _porous_solid()
    fl = ~solid
    rho = ((1e-3 + 1e-4 * rng.random((2,) + SIZE)) * fl).astype(np.float32)
    psi = (1e-3 * rng.standard_normal(SIZE)).astype(np.float32)
    u = (1e-3 * rng.standard_normal((3,) + SIZE) * fl).astype(np.float32)
    n = float(np.prod(SIZE))
    jr, jf, js = jfe.np_gradmu_fused(jnp.asarray(psi), jnp.asarray(rho),
                                     jnp.asarray(u), jnp.asarray(fl), jcfg,
                                     0.5, interpret=True)
    tr, tf, ts = tfe.np_gradmu_fused(_t(psi), _t(rho), _t(u), _t(fl), tcfg,
                                     0.5)
    np.testing.assert_allclose((tf - (ts / n)[:, None, None, None]).numpy(),
                               np.asarray(jf - (js / n)[:, None, None, None]),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-8)
    for k in range(2):
        assert float(tr[k].double().sum()) == pytest.approx(
            float(rho[k].astype(np.float64).sum()), rel=1e-6)


def test_f32_electro_step_on_a_porous_solid_matches_pallas_pieces():
    """Three float32 steps of the port's kernel route against the Pallas
    kernels in interpret mode over the porous solid: psi within 2e-5, rho
    within 1e-8, f and u (on the fluid) within 1e-6, the walls' momentum
    within 1e-6 of its link terms' total; the counter-charge sits on the
    union's fluid and the charge is conserved."""
    jek = jel.ElectroConfig(valency=(1, -1), diffusivity=(0.01, 0.01),
                            beta=3.0e4, epsilon=3.3e3, rel_tol=1e-8,
                            abs_tol=1e-15, max_its=10000, solver="sor")
    jcfg = jes.ElectroSimConfig(
        lb=JLBConfig(size=SIZE, nvel=19, eta_shear=0.1, dtype="float32"),
        ek=jek)
    tcfg = electro_params_from_jax(dataclasses.asdict(jcfg), device="cpu")
    psi0, rho0, _b = jes.init_gouy_chapman(SIZE, 1.04e-3, 3.125e-2)
    boundary, solid = _porous_solid()
    rho_j = jes.electroneutral(rho0, (1, -1), solid)
    rho_t = tes.electroneutral(rho0, (1, -1), solid)
    np.testing.assert_array_equal(rho_t, rho_j)
    assert (rho_t[1][solid] == rho0[1][solid]).all()
    rho0 = rho_j.astype(np.float32)
    f0 = np.broadcast_to(np.asarray(jcfg.lb.model.wv, np.float32)[
        :, None, None, None], (19,) + SIZE).copy()
    z3 = np.zeros((3,) + SIZE, np.float32)
    jstate = tuple(jnp.asarray(a) for a in (f0, psi0.astype(np.float32),
                                            rho0, z3,
                                            np.zeros(3, np.float32)))
    tstate = tes.initial_electro(tcfg, _t(f0), psi0, rho0)
    jstep = jax.jit(_jax_f32_step(jcfg, jnp.asarray(solid),
                                  jfused.FusedPlan(4, 8)))
    tstep = tes.make_electro_step(tcfg, solid=_t(solid))
    for t in range(3):
        jstate = jstep(jstate)
        tstate, (_rho, sor) = tstep(tstate, t)
        assert int(sor[0]) < 9999
    fluid = ~solid
    links = 3 * 2 * 5 * float(solid.sum()) * 2.0 / 18.0
    tol = {"f": 1e-6, "psi": 2e-5, "rho": 1e-8, "u": 1e-6,
           "gwall": 1e-6 * links}
    for name, a, b in zip(tol, tstate, jstate):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == np.float32
        if name == "u":
            a, b = a * fluid, b * fluid
        np.testing.assert_allclose(a, b, rtol=0, atol=tol[name],
                                   err_msg=name)
    for k in range(2):
        assert float(tstate[2][k].double().sum()) == pytest.approx(
            float(rho0[k].astype(np.float64).sum()), rel=1e-6)
    assert torch.equal(tstate[2][:, _t(solid)], _t(rho0)[:, _t(solid)])
