"""The port's fluctuating routes against ludwig_tpu's, on the CPU.

Three steps of each route from the same state, made from a numpy seed,
in float64 at 8x8x16 (16x8x16 beside Lees-Edwards planes; two steps,
each a rebuild, at 16^3 with colloids, whose JAX steps run op by op):
the single fluid's make_step on the stateless threefry stream
(NoiseConfig(kiss=False)) and the n-step loop, which draws that stream
whatever the configuration says; the binary step with kiss=False, the CH
flux noise included; the unfused blue-phase step with the Q noise
(noise_kt), with and without hydrodynamics; make_colloid_step with the
KISS stream at the fluid sites, 2 particles on the reference-order route
and 6 in float32 on the segment-sum route; the subgrid step with the
particles' Langevin kick; the Brazovskii fluid with the KISS stream,
periodic and sheared.

The JAX steps run eagerly (the jitted functions' bodies). Tolerances:
rtol 1e-12 / atol 1e-14 for the single fluid and the subgrid step; the
bounds the JAX modules' own port tests use elsewhere (rtol 1e-10 / atol
1e-12 for the binary and LC steps, the colloids bitwise in float64 and
at rtol 1e-5 / atol 1e-6 in float32); KISS and LCG states bitwise."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import binary as jbinary
from ludwig_tpu import binary_le as jbinary_le
from ludwig_tpu import colloids as jc
from ludwig_tpu import lb as jlb
from ludwig_tpu import lc as jlc
from ludwig_tpu import subgrid as jsg
from ludwig_tpu.fe.blue_phase import BluePhaseFE as JFE
from ludwig_tpu.fe.brazovskii import BrazovskiiFE as JBraz
from ludwig_tpu.fe.symmetric import SymmetricFE as JSymm
from ludwig_tpu.noise import NoiseConfig as JNoise
from ludwig_tpu.ops import lees_edwards as jle
from ludwig_tpu_torch import binary, binary_le, lc
from ludwig_tpu_torch import colloids as tc
from ludwig_tpu_torch import lb as tlb
from ludwig_tpu_torch import subgrid as tsg
from ludwig_tpu_torch.convert import (binary_params_from_jax,
                                      colloid_state_from_jax,
                                      lc_params_from_jax, params_from_jax,
                                      state_leaves_from_jax)
from ludwig_tpu_torch.ops import lees_edwards as tle
from test_torch_colloids import F32, _unjitted, setup
from test_torch_lc import FE, _q5

N = (8, 8, 16)
TOL = dict(rtol=1e-12, atol=1e-14)
STEP_TOL = dict(rtol=1e-10, atol=1e-12)
KT = 2e-5


def _rand(shape, seed, scale=0.05):
    return scale * np.random.default_rng(seed).standard_normal(shape)


def _eager(jitted):
    return getattr(jitted, "__wrapped__", jitted)


def _lb_cfgs(size=N, **kw):
    jcfg = jlb.LBConfig(size=size, nvel=19, eta_shear=0.1, eta_bulk=0.12,
                        dtype="float64", **kw)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    return jcfg, params_from_jax(fields, device="cpu")


def _hold(ts, js, nwords=0, tol=STEP_TOL):
    """The port's leaves against the JAX package's: the last nwords
    (KISS states) bitwise, the rest within tol."""
    assert len(ts) == len(js)
    for k, (a, b) in enumerate(zip(ts, js)):
        if k >= len(ts) - nwords:
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(b).astype(np.int64))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("ghosts", [True, False])
def test_threefry_make_step(ghosts):
    jcfg, tcfg = _lb_cfgs(noise=JNoise(kt=KT, seed=13, rho=True, kiss=False),
                          ghost_modes_on=ghosts,
                          force_global=(1e-5, 0.0, 0.0))
    f0 = np.asarray(jlb.initial_rest(jcfg)) + _rand((19,) + N, 1, 1e-4)
    jf, tf = jnp.asarray(f0), torch.as_tensor(f0)
    jstep, tstep = _eager(jlb.make_step(jcfg)), tlb.make_step(tcfg)
    for t in range(3):
        jf, jrho, ju = jstep(jf, t)
        tf, trho, tu = tstep(tf, t)
    _hold((tf, trho, tu), (jf, jrho, ju), tol=TOL)


def test_threefry_nstep():
    """The n-step loop draws the threefry stream even for a KISS
    configuration (the JAX package's scan passes no state)."""
    jcfg, tcfg = _lb_cfgs(noise=JNoise(kt=KT, rho=True))
    f0 = np.asarray(jlb.initial_rest(jcfg)) + _rand((19,) + N, 2, 1e-4)
    jf = jlb.make_nstep(jcfg)(jnp.asarray(f0), 3, 2)
    tf = tlb.make_nstep(tcfg)(torch.as_tensor(f0), 3, 2)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)


@pytest.mark.parametrize("noise", ["rho_phi", "phi"])
def test_binary_threefry_step(noise):
    """symmetric_noise's CH flux noise (seed + 104729) and the LB's, from
    the stateless stream."""
    nz = JNoise(kt=KT, seed=7, rho=noise == "rho_phi", phi=True, kiss=False)
    jcfg = jbinary.BinaryConfig(
        lb=jlb.LBConfig(size=N, nvel=19, eta_shear=6.25e-3,
                        dtype="float64", noise=nz),
        fe=JSymm(a=-6.25e-3, b=6.25e-3, kappa=4e-3),
        mobility=0.45)
    tcfg = binary_params_from_jax(dataclasses.asdict(jcfg), device="cpu")
    assert not tcfg.lb.noise.kiss
    js = list(jbinary.initial_binary(jcfg, jbinary.spinodal_phi(N, seed=3)))
    assert len(js) == 3            # no KISS state rides
    js[2] = jnp.asarray(_rand((3,) + N, 4, 0.01))
    js = tuple(js)
    ts = state_leaves_from_jax(js, "cpu", torch.float64)
    jstep = _eager(jbinary.make_binary_step(jcfg))
    tstep = binary.make_binary_step(tcfg)
    for t in range(1, 4):
        js, jrho = jstep(js, t)
        ts, trho = tstep(ts, t)
    _hold(ts + (trho,), js + (jrho,))


def _lc_cfgs(**kw):
    jcfg = jlc.LCConfig(
        lb=jlb.LBConfig(size=N, nvel=19, eta_shear=0.1, dtype="float64"),
        fe=JFE(**FE), gamma=0.5, noise_kt=1e-4, noise_seed=13, **kw)
    return jcfg, lc_params_from_jax(dataclasses.asdict(jcfg), device="cpu")


@pytest.mark.parametrize("hydro", [True, False], ids=["hydro", "no_hydro"])
def test_lc_noise_step(hydro):
    jcfg, tcfg = _lc_cfgs(hydrodynamics=hydro)
    assert (tcfg.noise_kt, tcfg.noise_seed) == (1e-4, 13)
    q0 = _q5(4)
    js, ts = jlc.initial_lc(jcfg, q0), lc.initial_lc(tcfg, q0)
    jstep, tstep = _eager(jlc.make_lc_step(jcfg)), lc.make_lc_step(tcfg)
    quiet = lc.make_lc_step(dataclasses.replace(tcfg, noise_kt=0.0))
    tq = ts
    for t in range(3):
        js, jrho = jstep(js, t)
        ts, trho = tstep(ts, t)
        tq, _ = quiet(tq, t)
    _hold(ts + (trho,), js + (jrho,))
    # the noise moved Q, and kept it traceless and symmetric (q5 form)
    assert float(torch.max(torch.abs(ts[1] - tq[1]))) > 1e-6


def _colloid_chain(n, dtype, nsteps=2):
    """(JAX state, port state, port step) after nsteps of the colloid step
    with the LB's KISS stream, from the same start (test_torch_colloids'
    setup: moving particles, gravity)."""
    kw, f, R, V, W, m = setup(n=n, seed=5)
    kw["gravity"] = (0.0, 0.0, -1e-4)
    dr = 0.3 * np.random.RandomState(6).standard_normal((n, 3))
    dt = np.float64 if dtype == "float64" else np.float32
    size = (16, 16, 16)
    nz = JNoise(kt=KT, rho=True)
    jcfg, tcfg = _lb_cfgs(size=size, noise=nz)
    jcfg = dataclasses.replace(jcfg, dtype=dtype, eta_bulk=None)
    tcfg = dataclasses.replace(tcfg, dtype=dtype, eta_bulk=None)
    leaves = [f, R, V, W, dr, R, m]
    js = jc.ColloidState(*[jnp.asarray(a.astype(dt)) for a in leaves])
    jstep = jc.make_colloid_step(jcfg, jc.ColloidParams(**kw))
    tstep = tc.make_colloid_step(tcfg, tc.ColloidParams(**kw))
    raw = _unjitted(jstep)
    js = jstep.prepare(js)
    ts = colloid_state_from_jax(tuple(js), device="cpu")
    assert ts.noise is not None and ts.noise.dtype == torch.int64
    for t in range(1, nsteps + 1):
        js, _ = raw(js, t, True)
        js = jstep.prepare(js)
        ts, _ = tstep(ts, t)
    return js, ts, tstep


@pytest.mark.parametrize("name", ["f64-n2-ordered", "f32-n6-segment"])
def test_colloid_step_kiss(name):
    """The KISS stream at the fluid sites only: the solid sites' state
    frozen, their deviates zero (the state bitwise on both routes)."""
    n, dtype, route = {"f64-n2-ordered": (2, "float64", "ordered"),
                       "f32-n6-segment": (6, "float32", "segment")}[name]
    js, ts, tstep = _colloid_chain(n, dtype)
    assert tstep.route == route
    np.testing.assert_array_equal(ts.noise.numpy(),
                                  np.asarray(js.noise).astype(np.int64))
    inside = ts.pmap[1]
    assert not torch.equal(ts.noise[:, ~inside],
                           tc.noise_kiss.kiss_init(0, (16,) * 3,
                                                   device="cpu")[:, ~inside])
    for i in range(7):
        if dtype == "float64":
            np.testing.assert_array_equal(ts[i].numpy(), np.asarray(js[i]))
        else:
            np.testing.assert_allclose(ts[i].numpy(), np.asarray(js[i]),
                                       **F32)


@pytest.mark.parametrize("kiss", [True, False], ids=["kiss", "threefry"])
def test_subgrid_langevin_kick(kiss):
    """The particles' kick from their serial LCG streams (the states
    bitwise), with the LB noise from either stream."""
    n = 5
    box = (16, 16, 16)
    rng = np.random.RandomState(4)
    R = rng.uniform(0.0, 16.0, (n, 3))
    V = 1e-3 * rng.standard_normal((n, 3))
    kw = dict(a0=(0.178,) * n, ah=(0.2,) * n, gravity=(0.0, 0.0, -1e-4),
              types=("subgrid",) * n)
    al = [1.58] * n
    jcfg, tcfg = _lb_cfgs(size=box, noise=JNoise(kt=KT, rho=True,
                                                 kiss=kiss))
    f = np.asarray(jlb.initial_rest(jcfg)) + 1e-4 * rng.standard_normal(
        (19,) + box)
    rngs = np.array([1 + i for i in range(n - 1)] + [123456789], np.int64)
    jstep = _eager(jsg.make_subgrid_step(jcfg, jc.ColloidParams(**kw), al,
                                         rng0=jnp.asarray(rngs)))
    tstep = tsg.make_subgrid_step(tcfg, tc.ColloidParams(**kw), al)
    js = (jnp.asarray(f), jnp.asarray(R), jnp.asarray(V))
    ts = tuple(torch.as_tensor(x) for x in (f, R, V))
    if kiss:
        nst = tc.noise_kiss.kiss_init(0, box, device="cpu")
        js = js + (jnp.asarray(nst.numpy().astype(np.uint32)),)
        ts = ts + (nst,)
    js, ts = js + (jnp.asarray(rngs),), ts + (torch.as_tensor(rngs),)
    for t in range(1, 4):
        js, _ = jstep(js, t)
        ts, _ = tstep(ts, t)
    assert ts[-1].device.type == "cpu"
    np.testing.assert_array_equal(ts[-1].numpy(), np.asarray(js[-1]))
    assert not np.array_equal(ts[-1].numpy(), rngs)
    _hold(ts[:-1], js[:-1], nwords=int(kiss), tol=TOL)


def test_langevin_kick_rejections():
    """The polar pair rejects rsq >= 1 and the component rejects |g| >= 3:
    drawn by hand from one LCG seed, the helper's values agree."""
    s, g0, g1 = tsg._reap_gaussian(1)
    t = 1
    while True:
        t, u0 = tsg._lcg_uniform(t)
        t, u1 = tsg._lcg_uniform(t)
        z0, z1 = 2 * u0 - 1, 2 * u1 - 1
        rsq = z0 * z0 + z1 * z1
        if 0 < rsq < 1:
            break
    f = np.sqrt(-2.0 * np.log(rsq) / rsq)
    assert (s, g0, g1) == (t, f * z0, f * z1)
    new, kicks = tsg.langevin_kicks([1, 2], 1e-4, [0.5, 0.25])
    assert kicks.shape == (2, 3) and np.all(np.abs(kicks[0]) < 3 * np.sqrt(
        2 * 1e-4 * 0.5))
    assert all(0 < x < tsg.RANLCG_M for x in new)


BRAZ = dict(a=-0.0005, b=0.0005, kappa=-0.0006, c=0.00076)


def _braz_cfgs(size):
    jcfg = jbinary.BinaryConfig(
        lb=jlb.LBConfig(size=size, nvel=19, eta_shear=0.1, eta_bulk=0.1,
                        dtype="float64", noise=JNoise(kt=KT, rho=True)),
        fe=JBraz(**BRAZ), mobility=0.05, advection_order=2)
    return jcfg, binary_params_from_jax(dataclasses.asdict(jcfg),
                                        device="cpu")


def test_brazovskii_kiss_step():
    jcfg, tcfg = _braz_cfgs(N)
    assert tcfg.fourth_order and tcfg.lb.noise.kiss
    js = list(jbinary.initial_binary(jcfg, _rand(N, 1, 0.01)))
    js[2] = jnp.asarray(_rand((3,) + N, 2, 0.01))
    js = tuple(js)
    ts = state_leaves_from_jax(js, "cpu", torch.float64)
    tinit = binary.initial_binary(tcfg, _rand(N, 1, 0.01))
    assert len(tinit) == len(js) == 4
    jstep = _eager(jbinary.make_binary_step(jcfg))
    tstep = binary.make_binary_step(tcfg)
    for t in range(1, 4):
        js, jrho = jstep(js, t)
        ts, trho = tstep(ts, t)
    _hold(ts, js, nwords=1)
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), **STEP_TOL)


def test_sheared_brazovskii_kiss_step():
    """Two planes at uy 0.04 on 16x8x16 with the KISS stream after u and
    the LE gradients at the tail."""
    size = (16, 8, 16)
    jcfg, tcfg = _braz_cfgs(size)
    le = dict(nplanes=2, uy=0.04, nx=size[0])
    jstep = _eager(jbinary_le.make_binary_le_step(jbinary_le.BinaryLEConfig(
        binary=jcfg, le=jle.LeesEdwardsConfig(**le)), keep_grads=True))
    tstep = binary_le.make_binary_le_step(binary_le.BinaryLEConfig(
        binary=tcfg, le=tle.LeesEdwardsConfig(**le)), keep_grads=True)
    js = list(jbinary.initial_binary(jcfg, _rand(size, 3, 0.05)))
    js[2] = jnp.asarray(_rand((3,) + size, 4, 0.01))
    js = tuple(js) + (jnp.zeros((3,) + size), jnp.zeros(size))
    ts = state_leaves_from_jax(js, "cpu", torch.float64)
    for t in range(1, 4):
        js, jrho = jstep(js, t)
        ts, trho = tstep(ts, t)
    np.testing.assert_array_equal(ts[3].numpy(),
                                  np.asarray(js[3]).astype(np.int64))
    _hold(ts[:3] + ts[4:], js[:3] + js[4:])
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), **STEP_TOL)
