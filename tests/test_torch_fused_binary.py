"""The port's fused binary step and its kernels' twins against ludwig_tpu.

The JAX side runs as its own tests run it (tests/test_fused.py:156-195):
the Pallas kernels in interpret mode, or the jnp step they are held to.
Inputs are numpy arrays made from a seed at 8x8x16; the JAX package's
padded states are unpadded before comparing.  Tolerances: f64 rtol 1e-10
/ atol 1e-12 (test_fused.py:190; the twins reproduce the Pallas
kernels' term order, so the f64 results agree far closer), f32 rtol 1e-6
/ atol 1e-8 (test_fused.py:47)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import binary as jbinary
from ludwig_tpu.fe.symmetric import SymmetricFE as JFE
from ludwig_tpu.lattice import lb_model as jlb_model
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.ops import fused as jfused
from ludwig_tpu.ops import fused_binary as jfb
from ludwig_tpu.ops.collide import CollisionParams as JParams
from ludwig_tpu.ops.fused_lc import pad_q
from ludwig_tpu_torch import binary
from ludwig_tpu_torch.convert import (binary_params_from_jax,
                                      binary_state_from_jax)
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.lattice import lb_model
from ludwig_tpu_torch.ops import fused
from ludwig_tpu_torch.ops import fused_binary as fb
from ludwig_tpu_torch.ops.collide import CollisionParams

N = (8, 8, 16)
FE = dict(a=-6.25e-3, b=6.25e-3, kappa=4e-3)
TOL = {"float64": dict(rtol=1e-10, atol=1e-12),
       "float32": dict(rtol=1e-6, atol=1e-8)}


def _rand(shape, seed, scale):
    return scale * np.random.default_rng(seed).standard_normal(shape)


def _close(got, want, dtype="float64"):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("order", [1, 2])
def test_binary_twin_matches_pallas_interpret(order):
    phi, u = _rand(N, 1, 0.05), _rand((3,) + N, 2, 0.01)
    pp, jforce = jfb.binary_phi_force_step(
        jfb.pad_phi(jnp.asarray(phi)), pad_q(jnp.asarray(u)), JFE(**FE),
        0.45, order, jfb.BinaryPlan(4, 8), interpret=True)
    tphi, tforce = fb.binary_phi_force_step(
        torch.as_tensor(phi), torch.as_tensor(u), SymmetricFE(**FE), 0.45,
        order)
    _close(tphi, jfb.unpad_phi(pp))
    _close(tforce, jforce)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_force_twin_matches_pallas_interpret(dtype):
    """D3Q19 M10 with a per-site force and a global one."""
    model = jlb_model(19)
    fg = (1e-4, 0.0, -5e-5)
    jp = JParams(model=model, eta_shear=0.1, eta_bulk=0.14, force_global=fg)
    tp = CollisionParams(model=lb_model(19), eta_shear=0.1, eta_bulk=0.14,
                         force_global=fg)
    f = (model.wv.reshape(-1, 1, 1, 1)
         * (1.0 + _rand((19,) + N, 3, 0.05))).astype(dtype)
    frc = _rand((3,) + N, 4, 1e-4).astype(dtype)
    jout, ju = jfused.fused_force_step(
        jfused.pad_state(jnp.asarray(f), zpad=False), jnp.asarray(frc),
        model, jp, jfused.FusedPlan(4, 8), interpret=True)
    tout, tu = fused.fused_force_step(torch.as_tensor(f),
                                      torch.as_tensor(frc), tp.model, tp)
    assert tout.dtype == getattr(torch, dtype)
    _close(tout, jfused.unpad_state(jout), dtype)
    _close(tu, ju, dtype)


def _bcfgs(order):
    jcfg = jbinary.BinaryConfig(
        lb=JLBConfig(size=N, nvel=19, eta_shear=6.25e-3, dtype="float64"),
        fe=JFE(**FE), mobility=0.45, advection_order=order)
    return jcfg, binary_params_from_jax(dataclasses.asdict(jcfg),
                                        device="cpu")


@pytest.mark.parametrize("order", [1, 2])
def test_fused_binary_step_matches_jnp_step(order):
    """3 steps of the port's fused step (K1 + K2 twins) against the JAX
    package's jnp step, as test_fused.py:156 holds the Pallas pair."""
    jcfg, tcfg = _bcfgs(order)
    phi0 = jbinary.spinodal_phi(N, seed=11)
    js = jbinary.initial_binary(jcfg, phi0)
    ts = fb.initial_fused_binary(tcfg, phi0)
    jstep, tstep = jbinary.make_binary_step(jcfg), fb.make_fused_binary_step(
        tcfg)
    for t in range(3):
        js, _ = jstep(js, t)
        ts = tstep(ts, t)
    for a, b in zip(ts, js):
        _close(a, b)


def test_fused_and_unfused_port_steps_agree():
    _, tcfg = _bcfgs(2)
    phi0 = jbinary.spinodal_phi(N, seed=5)
    a = fb.initial_fused_binary(tcfg, phi0)
    b = binary.initial_binary(tcfg, phi0)
    step_a, step_b = fb.make_fused_binary_step(tcfg), binary.make_binary_step(
        tcfg)
    for t in range(2):
        a = step_a(a, t)
        b, _ = step_b(b, t)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL["float64"])


def test_convert_round_trip():
    """The JAX fused binary state (padded) and BinaryConfig cross into the
    port's unpadded state and config."""
    jcfg, tcfg = _bcfgs(1)
    assert tcfg.fe == SymmetricFE(**FE)
    assert (tcfg.mobility, tcfg.advection_order) == (0.45, 1)
    assert tcfg.lb.size == N and tcfg.lb.device == "cpu"
    jp, tp = jcfg.lb.collision_params(), tcfg.lb.collision_params()
    assert (tp.rtau_shear, tp.rtau_bulk) == (jp.rtau_shear, jp.rtau_bulk)
    phi0 = jbinary.spinodal_phi(N, seed=3)
    u = _rand((3,) + N, 6, 0.01)
    fpad, ppad, _ = jfb.initial_fused_binary(jcfg, phi0)
    ts = binary_state_from_jax(fpad, ppad, u, "cpu", "float64")
    want = fb.initial_fused_binary(tcfg, phi0)
    assert torch.equal(ts[0], want[0]) and torch.equal(ts[1], want[1])
    np.testing.assert_array_equal(ts[2].numpy(), u)
    assert all(x.is_contiguous() for x in ts)
    with pytest.raises(ValueError):
        binary_state_from_jax(fpad, ppad[:, :-1], u, "cpu", "float64")


def test_fused_binary_rejects_what_it_cannot_run():
    _, tcfg = _bcfgs(2)
    phi = torch.as_tensor(_rand(N, 7, 0.05))
    u = torch.zeros((3,) + N, dtype=torch.float64)
    fe = SymmetricFE(**FE)
    with pytest.raises(ValueError):
        fb.binary_phi_force_step(phi, u, fe, 0.45, 3)
    with pytest.raises(ValueError):
        fb.binary_phi_force_step(phi, u[:2], fe, 0.45, 2)
    with pytest.raises(TypeError):
        fb.binary_phi_force_step(phi, u.float(), fe, 0.45, 2)
    with pytest.raises(ValueError):
        fb.binary_phi_force_step(phi.to("meta"), u.to("meta"), fe, 0.45, 2)
    f = binary.initial_binary(tcfg, phi.numpy())[0]
    params = tcfg.lb.collision_params()
    with pytest.raises(ValueError):
        fused.fused_force_step(f, u[:, :4], params.model, params)
    with pytest.raises(TypeError):
        fused.fused_force_step(f, u.float(), params.model, params)
