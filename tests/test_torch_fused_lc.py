"""The port's fused liquid-crystal step and its K1 twin against ludwig_tpu.

The JAX side runs as its own tests run it (tests/test_fused.py:93-125):
the Pallas kernels in interpret mode, or the jnp step they are held to.
Inputs are numpy arrays made from a seed at 8x8x16; the JAX package's
padded states are unpadded before comparing.  Tolerances: f64 rtol 1e-10
/ atol 1e-12 (test_fused.py:122; the twin reproduces the Pallas kernel's
term order, so the f64 results agree far closer: the test says whether
they are bitwise), f32 rtol 1e-5 / atol 1e-7 (single-precision rounding
of ~2 000 operations a site on O(1e-1) values)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import lc as jlc
from ludwig_tpu.fe.blue_phase import BluePhaseFE as JFE
from ludwig_tpu.fe.lc_init import lc_init_o8m
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.ops import fused as jfused
from ludwig_tpu.ops import fused_lc as jfl
from ludwig_tpu_torch import lc
from ludwig_tpu_torch.convert import lc_params_from_jax, lc_state_from_jax
from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE
from ludwig_tpu_torch.ops import fused_lc as fl

N = (8, 8, 16)
FE = dict(a0=0.01, gamma=3.0, q0=0.19635, kappa0=0.000648456,
          kappa1=0.000648456, xi=0.7)
GAMMA = 0.5
TOL = {"float64": dict(rtol=1e-10, atol=1e-12),
       "float32": dict(rtol=1e-5, atol=1e-7)}


def _rand(shape, seed, scale):
    return scale * np.random.default_rng(seed).standard_normal(shape)


def _q_u(dtype="float64"):
    """A blue-phase Q with noise on it and a velocity of both signs."""
    q = lc_init_o8m(N, FE["q0"], -0.2) + _rand((5,) + N, 1, 0.02)
    return q.astype(dtype), _rand((3,) + N, 2, 0.01).astype(dtype)


@pytest.mark.parametrize("dtype,extra", [
    ("float64", {}), ("float32", {}),
    ("float64", dict(zeta0=0.002, zeta1=0.01)),
    ("float64", dict(redshift=0.93))])
def test_lc_twin_matches_pallas_interpret(dtype, extra):
    q, u = _q_u(dtype)
    jq, jforce = jfl.lc_q_force_step(
        jfl.pad_q(jnp.asarray(q)), jfl.pad_q(jnp.asarray(u)),
        JFE(**FE, **extra), GAMMA, FE["xi"], jfl.LCPlan(4, 8),
        interpret=True)
    tq, tforce = fl.lc_q_force_step(torch.as_tensor(q), torch.as_tensor(u),
                                    BluePhaseFE(**FE, **extra), GAMMA)
    assert tq.dtype == getattr(torch, dtype)
    want_q, want_f = np.asarray(jfl.unpad_q(jq)), np.asarray(jforce)
    np.testing.assert_allclose(tq.numpy(), want_q, **TOL[dtype])
    np.testing.assert_allclose(tforce.numpy(), want_f, **TOL[dtype])
    print("bitwise:", np.array_equal(tq.numpy(), want_q),
          np.array_equal(tforce.numpy(), want_f))


def _cfgs(**extra):
    jcfg = jlc.LCConfig(
        lb=JLBConfig(size=N, nvel=19, eta_shear=0.1, dtype="float64"),
        fe=JFE(**FE, **extra), gamma=GAMMA)
    return jcfg, lc_params_from_jax(dataclasses.asdict(jcfg), device="cpu")


def test_fused_lc_step_matches_jax_fused_step():
    """Two steps of the port's fused step (K1 + K2 twins) against the JAX
    package's two Pallas kernels in interpret mode and its jnp step, as
    test_fused.py:93-125 holds them together."""
    jcfg, tcfg = _cfgs()
    q0 = lc_init_o8m(N, FE["q0"], -0.2)
    jf = jfl.initial_fused_lc(jcfg, q0)
    jr = jlc.initial_lc(jcfg, q0)
    ts = fl.initial_fused_lc(tcfg, q0)
    jfstep = jfl.make_fused_lc_step(jcfg, jfl.LCPlan(4, 8),
                                    lb_plan=jfused.FusedPlan(4, 8),
                                    interpret=True)
    jrstep, tstep = jlc.make_lc_step(jcfg), fl.make_fused_lc_step(tcfg)
    for t in range(2):
        jf = jfstep(jf, t)
        jr, _ = jrstep(jr, t)
        ts = tstep(ts, t)
    want = (jfused.unpad_state(jf[0]), jfl.unpad_q(jf[1]), jf[2])
    for a, b, c in zip(ts, want, jr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   **TOL["float64"])
        np.testing.assert_allclose(a.numpy(), np.asarray(c),
                                   **TOL["float64"])


def test_fused_and_unfused_port_steps_agree():
    _, tcfg = _cfgs(zeta0=0.001, zeta1=0.02)
    q0 = lc_init_o8m(N, FE["q0"], -0.2)
    a, b = fl.initial_fused_lc(tcfg, q0), lc.initial_lc(tcfg, q0)
    step_a, step_b = fl.make_fused_lc_step(tcfg), lc.make_lc_step(tcfg)
    for t in range(2):
        a = step_a(a, t)
        b, _ = step_b(b, t)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL["float64"])


def test_convert_round_trip():
    """The JAX fused LC state (padded) and LCConfig cross into the port's
    unpadded state and config."""
    jcfg, tcfg = _cfgs(redshift=0.9, zeta1=0.01)
    assert tcfg.fe == BluePhaseFE(**FE, redshift=0.9, zeta1=0.01)
    assert (tcfg.gamma, tcfg.advection_order) == (GAMMA, 1)
    assert tcfg.lb.size == N and tcfg.lb.device == "cpu"
    q0 = lc_init_o8m(N, FE["q0"], -0.2)
    u = _rand((3,) + N, 6, 0.01)
    fpad, qpad, _ = jfl.initial_fused_lc(jcfg, q0)
    ts = lc_state_from_jax(fpad, qpad, u, "cpu", "float64")
    want = fl.initial_fused_lc(tcfg, q0)
    assert torch.equal(ts[0], want[0]) and torch.equal(ts[1], want[1])
    np.testing.assert_array_equal(ts[2].numpy(), u)
    assert all(x.is_contiguous() for x in ts)
    with pytest.raises(ValueError):
        lc_state_from_jax(fpad, qpad[:, :-1], u, "cpu", "float64")
    # the LC options are carried; the noise alone is refused
    from ludwig_tpu.ops.lc_anchor import AnchoringParams as JAnch
    from ludwig_tpu.ops.walls import WallSpec as JWallSpec
    anch = JAnch(kappa0=0.01, kappa1=0.01, q0=0.2, amplitude=0.3,
                 wall="planar", wall_w1=0.01, wall_w2=0.002, method="s7")
    for field, value in (("redshift_update", True),
                         ("hydrodynamics", False),
                         ("advection_order", 3),
                         ("wallspec", JWallSpec(walls=(False, True, False))),
                         ("gradient", "s7_anchoring")):
        extra = {"anchoring": anch} if field == "gradient" else {}
        got = lc_params_from_jax(dataclasses.asdict(dataclasses.replace(
            jcfg, **{field: value}, **extra)), device="cpu")
        want = getattr(dataclasses.replace(jcfg, **{field: value}), field)
        if field == "wallspec":
            assert got.wallspec.walls == (False, True, False)
        else:
            assert getattr(got, field) == want
        if extra:
            assert dataclasses.asdict(got.anchoring) == dataclasses.asdict(
                anch)
    efield = dataclasses.asdict(jcfg)
    efield["fe"]["e0"] = (0.0, 0.0, 0.01)
    efield["fe"]["epsilon"] = 0.5 / (12.0 * np.pi)
    got = lc_params_from_jax(efield, device="cpu")
    assert got.fe.e0 == (0.0, 0.0, 0.01) and got.fe.has_efield
    noisy = dataclasses.asdict(dataclasses.replace(jcfg, noise_kt=1e-4,
                                                   noise_seed=7))
    got = lc_params_from_jax(noisy, device="cpu")
    assert (got.noise_kt, got.noise_seed) == (1e-4, 7)


def test_fused_lc_rejects_what_it_cannot_run():
    _, tcfg = _cfgs()
    q, u = (torch.as_tensor(x) for x in _q_u())
    fe = BluePhaseFE(**FE)
    with pytest.raises(ValueError):
        fl.lc_q_force_step(q[:4], u, fe, GAMMA)
    with pytest.raises(ValueError):
        fl.lc_q_force_step(q, u[:2], fe, GAMMA)
    with pytest.raises(TypeError):
        fl.lc_q_force_step(q, u.float(), fe, GAMMA)
    with pytest.raises(ValueError):
        fl.lc_q_force_step(q.transpose(1, 2), u.transpose(1, 2), fe, GAMMA)
    with pytest.raises(ValueError):
        fl.lc_q_force_step(q.to("meta"), u.to("meta"), fe, GAMMA)
    with pytest.raises(ValueError, match="order-1"):
        fl.make_fused_lc_step(dataclasses.replace(tcfg, advection_order=2))
