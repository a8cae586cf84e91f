"""The port's bounded and optional blue-phase routes against ludwig_tpu's,
on the CPU.

The same numpy inputs from a seed at 8x8x16 go through the JAX function
(its jitted steps run op by op) and the port's: the Beris-Edwards update
with halo walls and solid sites and without hydrodynamics, the velocity
gradient tensor beside walls, make_lc_step with walls (both anchoring
styles), porous solids, the dynamic redshift, the electric field,
`hydrodynamics off` and advection orders 3-5, the walls' surface free
energy, redshift_compute and the random rectangle.  float64: rtol 1e-12 /
atol 1e-14 for the modules, rtol 1e-10 / atol 1e-12 after 3 chained
steps."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import lc as jlc
from ludwig_tpu.dynamics import beris_edwards as jbe
from ludwig_tpu.fe import blue_phase as jbp
from ludwig_tpu.fe import lc_init as jinit
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.ops import lc_anchor as janch
from ludwig_tpu.ops import walls as jwalls
from ludwig_tpu_torch import lc
from ludwig_tpu_torch.dynamics import beris_edwards as be
from ludwig_tpu_torch.fe import blue_phase as tbp
from ludwig_tpu_torch.fe import lc_init
from ludwig_tpu_torch.lb import LBConfig
from ludwig_tpu_torch.ops import lc_anchor as tanch
from ludwig_tpu_torch.ops import walls as twalls

N = (8, 8, 16)
FE = dict(a0=0.01, gamma=3.0, q0=0.19635, kappa0=0.000648456,
          kappa1=0.0007, xi=0.7, redshift=0.95)
EFIELD = dict(epsilon=41.4 / (12.0 * np.pi), e0=(0.0, 0.003, 0.01))
TOL = dict(rtol=1e-12, atol=1e-14)
STEP_TOL = dict(rtol=1e-10, atol=1e-12)


def _q5(seed=1):
    rng = np.random.default_rng(seed)
    return (jinit.lc_init_o8m(N, FE["q0"], -0.2)
            + 0.02 * rng.standard_normal((5,) + N))


def _u(seed=2):
    return 0.01 * np.random.default_rng(seed).standard_normal((3,) + N)


def _porous(seed=3):
    return np.random.default_rng(seed).uniform(size=N) < 0.1


def _anch(mod, style, kind="normal"):
    return mod.AnchoringParams(
        kappa0=FE["kappa0"], kappa1=FE["kappa1"], q0=FE["q0"],
        amplitude=jbp.BluePhaseFE(**FE).amplitude0, wall=kind,
        wall_w1=0.01, wall_w2=0.002 if kind == "planar" else 0.0,
        wall_nfix=(0.0, 0.6, 0.8), method=style)


def _cfgs(walls=None, style=None, kind="normal", fe=None, **kw):
    """(JAX LCConfig, port LCConfig) with the same options."""
    fe = dict(FE, **(fe or {}))
    gradient = {"two": "3d_7pt_solid", "s7": "s7_anchoring",
                None: "3d_7pt_fluid"}[style]
    out = []
    for mod, lbc, fec, anch, ws, extra in (
            (jlc, JLBConfig, jbp.BluePhaseFE, janch, jwalls, {}),
            (lc, LBConfig, tbp.BluePhaseFE, tanch, twalls,
             {"device": "cpu"})):
        out.append(mod.LCConfig(
            lb=lbc(size=N, nvel=19, eta_shear=0.1, dtype="float64",
                   **extra),
            fe=fec(**fe), gamma=0.5, gradient=gradient,
            anchoring=None if style is None else _anch(anch, style, kind),
            wallspec=None if walls is None else ws.WallSpec(walls=walls),
            keep_grads=True, **kw))
    return out


def _run_steps(jcfg, tcfg, solid=None, nsteps=3):
    """nsteps chained steps of each package from the same start (Q from a
    seed, the fluid at rest); every leaf held at STEP_TOL."""
    q0 = _q5()
    js, ts = jlc.initial_lc(jcfg, q0), lc.initial_lc(tcfg, q0)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    jstep = jlc.make_lc_step(jcfg, solid=None if solid is None
                             else jnp.asarray(solid)).__wrapped__
    tstep = lc.make_lc_step(tcfg, solid=None if solid is None
                            else torch.as_tensor(solid))
    for t in range(nsteps):
        js, jrho = jstep(js, t)
        ts, trho = tstep(ts, t)
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP_TOL)
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), **STEP_TOL)
    return ts


def _h(fe_kw=None):
    q = _q5(5)
    fe = dict(FE, **(fe_kw or {}))
    jf = jlc.lc_fields(jnp.asarray(q), "3d_7pt_fluid")
    tf = lc.lc_fields(torch.as_tensor(q))
    return (q, jbp.BluePhaseFE(**fe).molecular_field(jf),
            tbp.BluePhaseFE(**fe).molecular_field(tf))


@pytest.mark.parametrize("case", ["walls", "solid", "walls+solid",
                                  "hydrodynamics off"])
def test_beris_edwards_update_with_walls_and_solids(case):
    q, jh, th = _h()
    u = None if case == "hydrodynamics off" else _u()
    walls = (True, False, True) if "walls" in case else None
    solid = _porous() if "solid" in case else None
    kw_j, kw_t = {}, {}
    if walls is not None:
        kw_j["wallspec"] = jwalls.WallSpec(walls=walls)
        kw_t["wallspec"] = twalls.WallSpec(walls=walls)
    if solid is not None:
        kw_j.update(solid=jnp.asarray(solid),
                    fluid_mask=jnp.asarray(~solid))
        kw_t.update(solid=torch.as_tensor(solid),
                    fluid_mask=torch.as_tensor(~solid))
    for order in (1, 3, 5):
        want = jbe.beris_edwards_update(
            jnp.asarray(q), jh, None if u is None else jnp.asarray(u),
            jbe.BerisEdwardsParams(0.5, FE["xi"], order), **kw_j)
        got = be.beris_edwards_update(
            torch.as_tensor(q), th, None if u is None else torch.as_tensor(u),
            be.BerisEdwardsParams(0.5, FE["xi"], order), **kw_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_velocity_gradient_tensor_beside_walls():
    u = _u(7)
    jws = jwalls.WallSpec(walls=(True, True, False), ubot=(0.01, 0.0, 0.0),
                          utop=(-0.01, 0.002, 0.0))
    tws = twalls.WallSpec(walls=(True, True, False), ubot=(0.01, 0.0, 0.0),
                          utop=(-0.01, 0.002, 0.0))
    jw = jbe.velocity_gradient_tensor(jnp.asarray(u), jws)
    tw = be.velocity_gradient_tensor(torch.as_tensor(u), tws)
    for a in range(3):
        for b in range(3):
            np.testing.assert_allclose(tw[a][b].numpy(),
                                       np.asarray(jw[a][b]), **TOL)


@pytest.mark.parametrize("walls,style,kind", [
    ((False, False, True), "s7", "normal"),
    ((True, False, False), "s7", "planar"),
    ((False, True, False), "s7", "fixed"),
    ((False, False, True), "two", "planar"),
    ((True, True, True), "two", "normal")],
    ids=["z-s7-normal", "x-s7-planar", "y-s7-fixed", "z-two-planar",
         "xyz-two-normal"])
def test_lc_step_with_walls(walls, style, kind):
    """Halo walls with the anchoring stencils: the state carries gwall
    (the stress' one-sided fluxes and the bounce-back transfer)."""
    jcfg, tcfg = _cfgs(walls, style, kind)
    ts = _run_steps(jcfg, tcfg)
    assert ts[3].shape == (3,) and float(ts[3].abs().sum()) > 0.0


def test_lc_step_with_walls_fluid_stencil():
    """Halo walls with the 7-point fluid stencil (no anchoring)."""
    _run_steps(*_cfgs((False, True, False)))


@pytest.mark.parametrize("style", [None, "two"])
def test_lc_step_with_porous_solid(style):
    """Porous solid sites: no update, collision or flux there, bounce-back
    on their links.  As in the JAX package, make_lc_step evaluates the
    anchoring gradient with no status map, so the porous sites do not
    anchor Q: with the solid stencil the step is the fluid stencil's."""
    solid = _porous()
    jcfg, tcfg = _cfgs(None, style)
    ts = _run_steps(jcfg, tcfg, solid=solid)
    assert np.array_equal(ts[1].numpy()[:, solid], _q5()[:, solid])
    if style is not None:
        fluid_cfg = dataclasses.replace(tcfg, gradient="3d_7pt_fluid",
                                        anchoring=None)
        plain = lc.initial_lc(fluid_cfg, _q5())
        step = lc.make_lc_step(fluid_cfg, solid=torch.as_tensor(solid))
        for t in range(3):
            plain, _ = step(plain, t)
        for a, b in zip(plain, ts):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-15)


def test_lc_step_with_redshift_update():
    jcfg, tcfg = _cfgs(redshift_update=True)
    ts = _run_steps(jcfg, tcfg)
    # (f, q5, u, redshift, grad, delsq): the redshift moved off its start
    assert ts[3].shape == () and float(ts[3]) != FE["redshift"]


def test_lc_step_with_walls_and_redshift():
    _run_steps(*_cfgs((False, False, True), "s7", redshift_update=True))


def test_lc_step_with_electric_field():
    _run_steps(*_cfgs(fe=EFIELD))


def test_lc_step_hydrodynamics_off():
    jcfg, tcfg = _cfgs((False, False, True), "s7", hydrodynamics=False)
    ts = _run_steps(jcfg, tcfg)
    assert float(ts[2].abs().max()) == 0.0


@pytest.mark.parametrize("order", [3, 4, 5])
def test_lc_step_advection_orders(order):
    """The force sets the fluid moving in the first step; the next two
    advect Q at the order."""
    _run_steps(*_cfgs(advection_order=order))


@pytest.mark.parametrize("method", ["fed", "molecular_field", "stress"])
def test_free_energy_with_electric_field(method):
    q = _q5(11)
    jf = jlc.lc_fields(jnp.asarray(q), "3d_7pt_fluid")
    tf = lc.lc_fields(torch.as_tensor(q))
    want = getattr(jbp.BluePhaseFE(**FE, **EFIELD), method)(jf)
    got = getattr(tbp.BluePhaseFE(**FE, **EFIELD), method)(tf)
    if method == "molecular_field":
        got = torch.stack([torch.stack(r) for r in got])
        want = jnp.stack([jnp.stack(r) for r in want])
    elif method == "stress":
        got = torch.stack([torch.stack(r) for r in got])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["normal", "planar", "fixed"])
def test_lc_surface_fe(kind):
    """The walls' surface free energy: with walls on two axes only the
    last axis' terms survive, as in the reference."""
    jcfg, tcfg = _cfgs((True, False, True), "two", kind)
    q = _q5(13)
    want = jlc.lc_surface_fe(jcfg, jnp.asarray(q))
    got = lc.lc_surface_fe(tcfg, torch.as_tensor(q))
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), **TOL)
        assert float(a) != 0.0


@pytest.mark.parametrize("scale", [1.0, 0.0])
def test_redshift_compute(scale):
    """The new redshift from two whole-lattice sums; with no gradients
    (a uniform Q) the square term vanishes and the old value stays."""
    q = _q5(17) * scale + (1.0 - scale) * np.ones((5,) + N) * 0.1
    jf = jlc.lc_fields(jnp.asarray(q), "3d_7pt_fluid")
    tf = lc.lc_fields(torch.as_tensor(q))
    want = jbp.redshift_compute(jbp.BluePhaseFE(**FE), jf,
                                jnp.asarray(0.83))
    got = tbp.redshift_compute(tbp.BluePhaseFE(**FE), tf,
                               torch.tensor(0.83, dtype=torch.float64))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert (float(got) == 0.83) == (scale == 0.0)


def test_random_rectangle_bitwise():
    base = _q5(19)
    want = jinit.lc_init_random_rectangle(N, base, (2, 1, 3), (6, 8, 11))
    got = lc_init.lc_init_random_rectangle(N, base, (2, 1, 3), (6, 8, 11))
    assert np.array_equal(got, want) and not np.array_equal(got, base)
