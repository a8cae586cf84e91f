"""The port's electrokinetic reference route against ludwig_tpu's jnp route.

The same inputs, made from numpy seeds, go through ludwig_tpu.electro /
electro_sim / ops.stream and their counterparts in ludwig_tpu_torch, in
float64 on the CPU.  The port's reference route is the JAX package's jnp
route op for op, so the tolerance is rtol 1e-12 / atol 1e-14 (sums over
the lattice run in another order) unless a test states otherwise; the
SOR solve must stop at the same iteration on the same criterion."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import electro as jel
from ludwig_tpu import electro_sim as jes
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.ops.stream import wall_momentum_transfer as jwall
from ludwig_tpu_torch import electro as tel
from ludwig_tpu_torch import electro_sim as tes
from ludwig_tpu_torch.convert import (electro_params_from_jax,
                                      electro_state_from_jax)
from ludwig_tpu_torch.lb import LBConfig
from ludwig_tpu_torch.ops.stream import wall_momentum_transfer

TOL = dict(rtol=1e-12, atol=1e-14)
# tests/test_fused_electro.py:18-33: a loose SOR tolerance and 500
# iterations at most, so that the solve stops on a criterion
EK = dict(valency=(1, -1), diffusivity=(0.01, 0.0095), beta=3.0e-4,
          epsilon=3.3e3, rel_tol=1e-6, abs_tol=1e-7, max_its=500,
          solver="sor")


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _cfgs(size, e0=(0.0, 0.0, 0.0), hydro=True, stencil=7, **ek):
    jek = jel.ElectroConfig(**{**EK, **ek})
    jcfg = jes.ElectroSimConfig(
        lb=JLBConfig(size=size, nvel=19, eta_shear=0.1, dtype="float64"),
        ek=jek, e0=e0, hydrodynamics=hydro, stencil=stencil)
    return jcfg, electro_params_from_jax(dataclasses.asdict(jcfg),
                                         device="cpu")


def _fields(size, seed=5):
    """tests/test_fused_electro.py:25-33's fields and wall mask."""
    rng = np.random.default_rng(seed)
    rho = 1e-3 + 1e-4 * rng.random((2,) + size)
    psi = 1e-3 * rng.standard_normal(size)
    u = 1e-3 * rng.standard_normal((3,) + size)
    solid = np.zeros(size, bool)
    solid[0] = solid[-1] = True
    return psi, rho, u, solid


def _neighbours(size, e0):
    return (jes.make_psi_neighbours(size, e0, "float64"),
            tes.make_psi_neighbours(size, e0, torch.float64, "cpu"))


@pytest.mark.parametrize("size,e0", [
    ((16, 16, 32), (0.0, 0.0, 0.0)),
    ((15, 8, 8), (0.0, 0.0, 0.0)),        # odd X: same colours meet
    ((15, 8, 8), (2e-4, 0.0, -1e-4))])    # the potential jump on the wrap
def test_poisson_sor_ref_matches_jax(size, e0):
    jcfg, tcfg = _cfgs(size, e0)
    psi, rho, _u, _s = _fields(size)
    (jup, jdn), (tup, tdn) = _neighbours(size, e0)
    rel = jel.rho_elec(jnp.asarray(rho), jcfg.ek)
    jp, jn, jr, jw = jes.poisson_sor_ref(jnp.asarray(psi), rel, jcfg.ek,
                                         jup, jdn, return_iters=True)
    tp, tn, tr, tw = tes.poisson_sor_ref(
        _t(psi), tel.rho_elec(_t(rho), tcfg.ek), tcfg.ek, tup, tdn,
        return_iters=True)
    assert int(tn) == int(jn) < jcfg.ek.max_its - 1
    assert int(tw) == int(jw)
    # the residual at the stop (~5e-8) is a difference of terms of size
    # eps |psi| and keeps their roundoff, summed over the sites in another
    # order: atol 1e-14 eps max|psi| sqrt(sites)
    scale = jcfg.ek.epsilon * float(np.abs(np.asarray(jp)).max())
    np.testing.assert_allclose(float(tr), float(jr), rtol=0,
                               atol=1e-14 * scale * np.sqrt(psi.size))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-12)


def test_poisson_sor_ref_f32_stall_guard_matches_jax():
    """float32: the stall guard stops both at the same check (the sums
    run in another order, so the residual may differ in its last bits)."""
    size = (16, 16, 32)
    jcfg, tcfg = _cfgs(size, rel_tol=1e-8, abs_tol=1e-15, max_its=2000)
    psi, rho, _u, _s = _fields(size)
    jup, jdn = jes.make_psi_neighbours(size, (0.0,) * 3, "float32")
    tup, tdn = tes.make_psi_neighbours(size, (0.0,) * 3, "float32", "cpu")
    psi32, rho32 = psi.astype(np.float32), rho.astype(np.float32)
    jp, jn, _jr, jw = jes.poisson_sor_ref(
        jnp.asarray(psi32), jel.rho_elec(jnp.asarray(rho32), jcfg.ek),
        jcfg.ek, jup, jdn, return_iters=True)
    tp, tn, _tr, tw = tes.poisson_sor_ref(
        _t(psi32), tel.rho_elec(_t(rho32), tcfg.ek), tcfg.ek, tup, tdn,
        return_iters=True)
    assert tp.dtype == torch.float32
    assert int(jn) < 1999 and abs(int(tn) - int(jn)) <= 15
    assert int(tw) == int(jw)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=2e-5)


def test_gradmu_force_matches_jax():
    size = (8, 6, 10)
    jcfg, tcfg = _cfgs(size, e0=(1e-4, 0.0, 0.0))
    psi, rho, _u, _s = _fields(size, 7)
    (jup, jdn), (tup, tdn) = _neighbours(size, jcfg.e0)
    n = float(np.prod(size))
    want = jes.gradmu_force(jnp.asarray(psi), jnp.asarray(rho), jcfg, jup,
                            jdn, n)
    got = tes.gradmu_force(_t(psi), _t(rho), tcfg, tup, tdn, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hydro", [True, False])
def test_np_step_matches_jax(hydro):
    size = (8, 6, 10)
    jcfg, tcfg = _cfgs(size)
    psi, rho, u, solid = _fields(size, 8)
    (jup, jdn), (tup, tdn) = _neighbours(size, jcfg.e0)
    fluid = ~solid
    want = jes.np_step(jnp.asarray(rho), jnp.asarray(psi),
                       jnp.asarray(u) if hydro else None, jnp.asarray(fluid),
                       jcfg, jup, jdn, 0.5)
    got = tes.np_step(_t(rho), _t(psi), _t(u) if hydro else None,
                      _t(fluid), tcfg, tup, tdn, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("npoints", [19, 27])
def test_np_step_d3qx_matches_jax(npoints):
    size = (6, 8, 7)
    jcfg, tcfg = _cfgs(size, e0=(0.0, 1e-4, 0.0), stencil=npoints)
    psi, rho, u, solid = _fields(size, 9)
    (jup, jdn), (tup, tdn) = _neighbours(size, jcfg.e0)
    want = jes.np_step_d3qx(jnp.asarray(rho), jnp.asarray(psi),
                            jnp.asarray(u), jnp.asarray(~solid), jcfg, jup,
                            jdn, 1.0, npoints=npoints)
    got = tes.np_step_d3qx(_t(rho), _t(psi), _t(u), _t(~solid), tcfg, tup,
                           tdn, 1.0, npoints=npoints)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_poisson_fft_matches_jax():
    """Two FFT libraries (pocketfft in torch, XLA's on the CPU) round
    differently: psi ~ 1e-2 here, atol 1e-14."""
    size = (8, 12, 10)
    jcfg, tcfg = _cfgs(size)
    _psi, rho, _u, _s = _fields(size, 10)
    rel = rho[0] - rho[1]
    want = jel.poisson_fft(jnp.asarray(rel), jcfg.ek)
    got = tel.poisson_fft(_t(rel), tcfg.ek)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-14)


def test_fe_electro_fed_and_rho_elec_match_jax():
    size = (6, 5, 4)
    jcfg, tcfg = _cfgs(size)
    psi, rho, _u, _s = _fields(size, 11)
    rho[1, 0] = 0.0                   # the wall species' empty sites
    for args in ((), (psi,)):
        want = jel.fe_electro_fed(jnp.asarray(rho), jcfg.ek,
                                  *map(jnp.asarray, args))
        got = tel.fe_electro_fed(_t(rho), tcfg.ek, *map(_t, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        tel.rho_elec(_t(rho), tcfg.ek).numpy(),
        np.asarray(jel.rho_elec(jnp.asarray(rho), jcfg.ek)))


def test_initial_conditions_match_jax():
    size = (10, 4, 6)
    v = (1, -1)
    gc_j, gc_t = (mod.init_gouy_chapman(size, 1.04e-3, 3.125e-2)
                  for mod in (jes, tes))
    lj_j, lj_t = (mod.init_liquid_junction(size, 1e-3, 2e-4)
                  for mod in (jes, tes))
    un_j, un_t = (mod.init_uniform(size, 1e-3) for mod in (jes, tes))
    for a, b in zip(gc_j + lj_j + un_j, gc_t + lj_t + un_t):
        np.testing.assert_array_equal(a, b)
    for rho, solid in ((gc_j[1], gc_j[2]), (lj_j[1], None)):
        np.testing.assert_array_equal(tes.electroneutral(rho, v, solid),
                                      jes.electroneutral(rho, v, solid))


def test_wall_momentum_transfer_matches_jax():
    from ludwig_tpu_torch.lattice import lb_model
    from ludwig_tpu.lattice import lb_model as jlb_model
    size = (8, 6, 10)
    rng = np.random.default_rng(12)
    f = 0.05 + 0.01 * rng.random((19,) + size)
    solid = np.zeros(size, bool)
    solid[0] = solid[-1] = True
    solid[4, 2:4, 3:7] = True
    want = jwall(jnp.asarray(f), jlb_model(19), jnp.asarray(solid))
    got = wall_momentum_transfer(_t(f), lb_model(19), _t(solid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


GC_SIZE = (12, 4, 6)
# the Gouy-Chapman bench of ludwig_tpu perf_bench.py:86-110 at a small
# size, with a loose enough SOR tolerance for a few dozen iterations
GC_EK = dict(valency=(1, -1), diffusivity=(0.01, 0.01), beta=3.0e4,
             epsilon=3.3e3, rel_tol=1e-8, abs_tol=1e-15, max_its=10000)


def _gc_state(jcfg, tcfg):
    psi0, rho0, boundary = jes.init_gouy_chapman(GC_SIZE, 1.04e-3, 3.125e-2)
    rho0 = jes.electroneutral(rho0, (1, -1), boundary)
    model = jcfg.lb.model
    f0 = np.broadcast_to(np.asarray(model.wv)[:, None, None, None],
                         (19,) + GC_SIZE).copy()
    jstate = (jnp.asarray(f0), jnp.asarray(psi0), jnp.asarray(rho0),
              jnp.zeros((3,) + GC_SIZE), jnp.zeros(3))
    tstate = tes.initial_electro(tcfg, _t(f0), psi0, rho0)
    return jstate, tstate, boundary


@pytest.mark.parametrize("solver", ["sor", "fft"])
def test_electro_step_matches_jax(solver):
    """Three steps of the reference route (float64) on a Gouy-Chapman
    state: f, psi, rho, u on the fluid sites (the collision zeroes it at
    solid sites in both), the wall momentum, and the SOR report."""
    jcfg, tcfg = _cfgs(GC_SIZE, solver=solver, **GC_EK)
    jstate, tstate, boundary = _gc_state(jcfg, tcfg)
    jstep = jes.make_electro_step(jcfg, solid=jnp.asarray(boundary))
    tstep = tes.make_electro_step(tcfg, solid=_t(boundary))
    for t in range(3):
        jstate, (jrho, jsor) = jstep(jstate, t)
        tstate, (trho, tsor) = tstep(tstate, t)
        assert [int(v) for v in (tsor[0], tsor[2])] == [
            int(v) for v in (jsor[0], jsor[2])]
    fluid = ~boundary
    for name, a, b in zip(("f", "psi", "rho", "u", "gwall"), tstate,
                          electro_state_from_jax(*jstate, "cpu",
                                                 "float64")):
        if name == "u":
            a, b = a * _t(fluid), b * _t(fluid)
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL, err_msg=name)
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), **TOL)
    # the solve did work: charge moved, walls took momentum
    assert float(tstate[4].abs().max()) > 0.0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_step_without_rho_lb(dtype):
    """return_rho_lb=False, the CLI's step, returns no collision-time
    density and the same state as the default step, on the float64
    reference route and the float32 kernel route (twins on the CPU)."""
    _jcfg, tcfg = _cfgs(GC_SIZE, **GC_EK)
    tcfg = dataclasses.replace(
        tcfg, lb=dataclasses.replace(tcfg.lb, dtype=dtype))
    psi0, rho0, boundary = jes.init_gouy_chapman(GC_SIZE, 1.04e-3, 3.125e-2)
    rho0 = jes.electroneutral(rho0, (1, -1), boundary)
    f0 = torch.as_tensor(np.broadcast_to(
        np.asarray(tcfg.lb.model.wv)[:, None, None, None],
        (19,) + GC_SIZE).copy(), dtype=tcfg.lb.tdtype)
    state = tes.initial_electro(tcfg, f0, psi0, rho0)
    with_rho = tes.make_electro_step(tcfg, solid=_t(boundary))
    without = tes.make_electro_step(tcfg, solid=_t(boundary),
                                    return_rho_lb=False)
    a, (rho_lb, sor_a) = with_rho(state)
    b, (none, sor_b) = without(state)
    assert none is None
    assert rho_lb.shape == GC_SIZE and rho_lb.dtype == tcfg.lb.tdtype
    assert [int(v) for v in sor_a[::2]] == [int(v) for v in sor_b[::2]]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_convert_round_trip():
    jcfg, tcfg = _cfgs((8, 4, 4), e0=(1e-3, 0.0, 0.0), hydro=False,
                       stencil=19)
    assert tcfg.ek == tel.ElectroConfig(**EK)
    assert (tcfg.e0, tcfg.hydrodynamics, tcfg.stencil) == ((1e-3, 0.0, 0.0),
                                                           False, 19)
    assert tcfg.lb == LBConfig(size=(8, 4, 4), nvel=19, eta_shear=0.1,
                               dtype="float64", device="cpu")
    bad = dataclasses.replace(jcfg, periodic=(False, True, True))
    with pytest.raises(NotImplementedError, match="periodic"):
        electro_params_from_jax(dataclasses.asdict(bad), device="cpu")
