"""The binary fluid's unfused routes of the port against ludwig_tpu's, on
the CPU: 3 whole steps of binary.make_binary_step (halo walls 0_0_1 and
1_1_0, porous media with wetting, the phi-grad-mu force with grad_mu,
the Arrhenius viscosity, `hydrodynamics off`, the KISS phi and rho
noise, alone and beside walls), binary.make_binary_open_step (open x
beside walls) and binary_le.make_binary_le_step (27-point gradients,
advection order 3, the LB's KISS noise) from the same state made from a
numpy seed, in float64.  The configuration crosses through
convert.binary_params_from_jax and the state through
convert.state_leaves_from_jax.

The JAX steps run eagerly (the jitted functions' __wrapped__), which
skips XLA's compiles of each variant.  Tolerances: rtol 1e-10 / atol
1e-12 for the fields after 3 steps (the
bound tests/test_fused.py:190 holds the fused binary step to); the KISS
states bitwise."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import binary as jbinary
from ludwig_tpu import binary_le as jbinary_le
from ludwig_tpu.fe.symmetric import SymmetricFE as JFE
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.noise import NoiseConfig as JNoise
from ludwig_tpu.ops import lees_edwards as jle
from ludwig_tpu.ops.open_bc import OpenBCConfig as JOpen
from ludwig_tpu.ops.walls import WallSpec as JWalls
from ludwig_tpu.visc import ViscArrhenius as JVisc
from ludwig_tpu_torch import binary, binary_le
from ludwig_tpu_torch.convert import (binary_params_from_jax,
                                      state_leaves_from_jax)
from ludwig_tpu_torch.ops import lees_edwards as tle
from ludwig_tpu_torch.ops.open_bc import OpenBCConfig
from ludwig_tpu_torch.ops.walls import WallSpec

N = (8, 8, 16)
STEP_TOL = dict(rtol=1e-10, atol=1e-12)
FE = dict(a=-6.25e-3, b=6.25e-3, kappa=4e-3)
KT = 2e-5


def _rand(shape, seed, scale=0.05):
    return scale * np.random.default_rng(seed).standard_normal(shape)


def _porous():
    m = np.random.default_rng(3).random(N) < 0.1
    m[0] = True
    return m


def _wetting():
    rng = np.random.default_rng(4)
    return 0.01 * rng.random(N), 0.002 * rng.standard_normal(N)


# route -> (BinaryConfig changes, LBConfig changes, halo walls, porous)
ROUTES = {
    "walls_0_0_1": (dict(gradient="3d_27pt_solid", wetting=(0.02, -0.001)),
                    {}, (False, False, True), False),
    "walls_1_1_0": ({}, {}, (True, True, False), False),
    "porous_wetting": (dict(gradient="3d_27pt_solid",
                            wetting=_wetting()), {}, None, True),
    "porous_7pt_solid": (dict(gradient="3d_7pt_solid", wetting=(0.01, 0.0)),
                         {}, None, True),
    "phi_gradmu_grad_mu": (dict(force_method="phi_gradmu",
                                gradmu_ex=(1e-4, 0.0, -2e-4)), {}, None,
                           True),
    "arrhenius_order_3": (dict(visc_model=JVisc(0.01, 0.004),
                               advection_order=3), {}, None, False),
    "hydrodynamics_off": (dict(hydrodynamics=False, advection_order=5), {},
                          None, False),
    "kiss_phi_rho": ({}, dict(noise=JNoise(kt=KT, rho=True, phi=True)),
                     None, False),
    "kiss_porous_27pt": (dict(gradient="3d_27pt_fluid"),
                         dict(noise=JNoise(kt=KT, rho=True, phi=True)),
                         None, True),
    "walls_kiss": ({}, dict(noise=JNoise(kt=KT, rho=True, phi=True)),
                   (False, True, False), False),
}


def _cfgs(bchanges, lbchanges, size=N):
    jcfg = jbinary.BinaryConfig(
        lb=JLBConfig(size=size, nvel=19, eta_shear=6.25e-3, dtype="float64",
                     **lbchanges),
        fe=JFE(**FE), mobility=0.45, **bchanges)
    if isinstance(jcfg.wetting[0], np.ndarray):
        jcfg = dataclasses.replace(jcfg, wetting=tuple(
            jnp.asarray(w) for w in jcfg.wetting))
    return jcfg, binary_params_from_jax(dataclasses.asdict(jcfg),
                                        device="cpu")


def _start(jcfg, walls, size=N, seed=11):
    """The JAX package's initial state with phi from a seed, u random
    and f perturbed; gwall (zeros) after u where there are halo walls."""
    phi0 = jbinary.spinodal_phi(size, seed=seed)
    st = list(jbinary.initial_binary(jcfg, phi0))
    st[0] = st[0] + jnp.asarray(_rand((19,) + size, seed + 1, 1e-4))
    st[2] = jnp.asarray(_rand((3,) + size, seed + 2, 0.01))
    if walls:
        st.insert(3, jnp.zeros((3,), jnp.float64))
    return tuple(st)


def _eager(jitted):
    """The JAX step op by op: its jitted function's Python body."""
    return getattr(jitted, "__wrapped__", jitted)


def _hold(ts, js, nkiss):
    """The port's state ts against the JAX package's js: the KISS states
    (the last nkiss leaves) bitwise, the rest within STEP_TOL."""
    assert len(ts) == len(js)
    for k, (a, b) in enumerate(zip(ts, js)):
        if k >= len(ts) - nkiss:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b)
                                          .astype(np.int64))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **STEP_TOL)


@pytest.mark.parametrize("route", list(ROUTES))
def test_binary_route_matches_jax(route):
    bchanges, lbchanges, walls, porous = ROUTES[route]
    jcfg, tcfg = _cfgs(bchanges, lbchanges)
    solid = _porous() if porous else None
    kw_j, kw_t = {}, {}
    if walls:
        kw_j["wallspec"] = JWalls(walls=walls)
        kw_t["wallspec"] = WallSpec(walls=walls)
    if solid is not None:
        kw_j["solid"] = jnp.asarray(solid)
        kw_t["solid"] = torch.as_tensor(solid)
    js = _start(jcfg, walls)
    ts = state_leaves_from_jax(js, "cpu", torch.float64)
    jstep = _eager(jbinary.make_binary_step(jcfg, **kw_j))
    tstep = binary.make_binary_step(tcfg, **kw_t)
    nz = lbchanges.get("noise")
    nkiss = 0 if nz is None else int(nz.phi) + int(nz.rho)
    for t in range(1, 4):
        js, jrho = jstep(js, t)
        ts, trho = tstep(ts, t)
    _hold(ts, js, nkiss)
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), **STEP_TOL)


def test_initial_binary_noise_states_match_jax():
    """initial_binary's KISS states (phi's on the extended ring) are the
    JAX package's words."""
    jcfg, tcfg = _cfgs({}, dict(noise=JNoise(kt=KT, rho=True, phi=True)))
    phi0 = jbinary.spinodal_phi(N, seed=5)
    js = jbinary.initial_binary(jcfg, phi0)
    ts = binary.initial_binary(tcfg, phi0)
    assert ts[3].shape == (4,) + tuple(n + 2 for n in N)
    _hold(ts, js, 2)


@pytest.mark.parametrize("walls", [(False, True, True), (False, False, True)],
                         ids=["0_1_1", "0_0_1"])
def test_binary_open_step_matches_jax(walls):
    jcfg, tcfg = _cfgs(dict(advection_order=2), {})
    js = _start(jcfg, True)
    ts = state_leaves_from_jax(js, "cpu", torch.float64)
    obc = dict(u0=(1e-3, 0.0, 0.0), rho0=1.0)
    jstep = _eager(jbinary.make_binary_open_step(jcfg, JWalls(walls=walls),
                                                 JOpen(**obc), -0.8))
    tstep = binary.make_binary_open_step(tcfg, WallSpec(walls=walls),
                                         OpenBCConfig(**obc), -0.8)
    for t in range(1, 4):
        js, _ = jstep(js, t)
        ts, _ = tstep(ts, t)
    _hold(ts, js, 0)
    jops = jbinary.open_x_scalar_ops(jcfg, JWalls(walls=walls), -0.8)
    tops = binary.open_x_scalar_ops(tcfg, WallSpec(walls=walls), -0.8)
    for a, b in zip(tops, jops):
        np.testing.assert_allclose(a(ts[1]).numpy(), np.asarray(b(js[1])),
                                   rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("noise", [False, True], ids=["quiet", "kiss_rho"])
def test_binary_le_27pt_matches_jax(noise):
    """The sheared step with 27-point gradients and order-3 advection, with
    and without the LB's KISS noise (the state then carries it after
    u), 16x8x16 with two planes at uy 0.04."""
    size = (16, 8, 16)
    lbch = dict(noise=JNoise(kt=KT, rho=True)) if noise else {}
    jcfg, tcfg = _cfgs(dict(gradient="3d_27pt_fluid", advection_order=3),
                       lbch, size)
    le = dict(nplanes=2, uy=0.04, nx=size[0])
    jstep = _eager(jbinary_le.make_binary_le_step(jbinary_le.BinaryLEConfig(
        binary=jcfg, le=jle.LeesEdwardsConfig(**le))))
    tstep = binary_le.make_binary_le_step(binary_le.BinaryLEConfig(
        binary=tcfg, le=tle.LeesEdwardsConfig(**le)))
    js = _start(jcfg, False, size)
    ts = state_leaves_from_jax(js, "cpu", torch.float64)
    for t in range(1, 4):
        js, _ = jstep(js, t)
        ts, _ = tstep(ts, t)
    _hold(ts, js, int(noise))
