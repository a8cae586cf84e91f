"""The port's sheared blue phase (lc.make_lc_le_step,
lc.make_lc_le_column_fix, ops/fused_lc.make_fused_lc_le_step) and the
gradients its unfused LC steps keep, against ludwig_tpu's, on the CPU.

The same numpy inputs from a seed, 16x8x16 with 2 planes at uy 0.04 (the
JAX package's tests/test_fused.py:353 lattice and blue-phase
parameters), go through both packages in float64, 3 steps each, at rtol
1e-10 / atol 1e-12: the column fix against the JAX fix, the unfused step
against make_lc_le_step(keep_grads=True), the fused step against the
JAX make_fused_lc_le_step with its Pallas kernels in interpret mode, and
the plain unfused step's kept gradients against make_lc_step's.  The
JAX steps run as test_torch_binary_le.py runs them."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import lc as jlc
from ludwig_tpu.fe import lc_init
from ludwig_tpu.fe.blue_phase import BluePhaseFE as JFE
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.ops import fused as jfused
from ludwig_tpu.ops import fused_lc as jfl
from ludwig_tpu.ops import le_ref as jlr
from ludwig_tpu.ops import lees_edwards as jle
from ludwig_tpu_torch import lc
from ludwig_tpu_torch.convert import lc_le_state_from_jax
from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE
from ludwig_tpu_torch.lb import LBConfig
from ludwig_tpu_torch.ops import fused_lc as fl
from ludwig_tpu_torch.ops import lees_edwards as tle
from test_torch_binary_le import (TOL, cols, eager, hold_cols,  # noqa: F401
                                  jit_kernels)

N = (16, 8, 16)
FE = dict(a0=0.01, gamma=3.0, q0=0.19635, kappa0=0.000648456,
          kappa1=0.000648456, xi=0.7)
LE = dict(nplanes=2, uy=0.04, nx=N[0])


def configs(**fe_extra):
    jc = jlc.LCConfig(lb=JLBConfig(size=N, nvel=19, eta_shear=0.1,
                                   dtype="float64"),
                      fe=JFE(**FE, **fe_extra), gamma=0.5)
    tc = lc.LCConfig(lb=LBConfig(size=N, nvel=19, eta_shear=0.1,
                                 dtype="float64", device="cpu"),
                     fe=BluePhaseFE(**FE, **fe_extra), gamma=0.5)
    return jc, tc, jle.LeesEdwardsConfig(**LE), tle.LeesEdwardsConfig(**LE)


def start(jc, jlecfg):
    """(f, q5, u) as numpy: the sheared profile, O8M and a random u."""
    q5 = np.asarray(lc_init.lc_init_o8m(N, FE["q0"], -0.2))
    u = 0.01 * np.random.default_rng(2).standard_normal((3,) + N)
    return (np.asarray(jle.le_init_shear_profile(jc.lb, jlecfg)), q5, u)


@pytest.mark.parametrize("t,active", [(0, False), (7, True)],
                         ids=["t0", "t7-active"])
def test_lc_le_column_fix_matches_jax(t, active):
    extra = dict(zeta0=0.002, zeta1=0.01) if active else {}
    jc, tc, jlecfg, tlecfg = configs(**extra)
    _f, q5, u = start(jc, jlecfg)
    jq, jf = jlc.make_lc_le_column_fix(jc, jlecfg)(jnp.asarray(q5),
                                                   jnp.asarray(u), t)
    (qi, qv), (fi, fv) = lc.make_lc_le_column_fix(tc, tlecfg)(
        torch.as_tensor(q5), torch.as_tensor(u), t)
    hold_cols(cols(qi, qv, 1), jq)
    hold_cols(cols(fi, fv, 1), jf)


def test_lc_le_step_matches_jax():
    """3 unfused sheared steps, the kept LE gradients included."""
    jc, tc, jlecfg, tlecfg = configs()
    f, q5, u = start(jc, jlecfg)
    jgrad, jdsq = jlr.le_gradient(jnp.asarray(q5), jlecfg, 0)
    js = tuple(jnp.asarray(a) for a in (f, q5, u)) + (jgrad, jdsq)
    ts = tuple(torch.as_tensor(np.array(a)) for a in js)
    jstep = eager(jlc.make_lc_le_step(jc, jlecfg, keep_grads=True))
    tstep = lc.make_lc_le_step(tc, tlecfg, keep_grads=True)
    for t in range(1, 4):
        js, _ = jstep(js, t)
        ts, _ = tstep(ts, t)
    assert len(ts) == len(js) == 5
    for a, b in zip(ts, lc_le_state_from_jax(js, "cpu", "float64")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_fused_lc_le_step_matches_jax_interpret(jit_kernels):
    jc, tc, jlecfg, tlecfg = configs()
    f, q5, u = start(jc, jlecfg)
    js = (jfused.pad_state(jnp.asarray(f), zpad=False),
          jfl.pad_q(jnp.asarray(q5)), jnp.asarray(u))
    ts = tuple(torch.as_tensor(np.array(a)) for a in (f, q5, u))
    jstep = eager(jfl.make_fused_lc_le_step(
        jc, jlecfg, jfl.LCPlan(4, 8), lb_plan=jfused.FusedPlan(4, 8),
        interpret=True))
    tstep = fl.make_fused_lc_le_step(tc, tlecfg)
    for t in range(1, 4):
        js = jstep(js, t)
        ts = tstep(ts, t)
    want = lc_le_state_from_jax(js, "cpu", "float64")
    np.testing.assert_array_equal(want[1].numpy(), jfl.unpad_q(js[1]))
    for a, b in zip(ts, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_fused_lc_le_step_matches_unfused():
    jc, tc, jlecfg, tlecfg = configs()
    state = tuple(torch.as_tensor(np.array(a)) for a in start(jc, jlecfg))
    fused, unfused = state, state
    fstep = fl.make_fused_lc_le_step(tc, tlecfg)
    ustep = lc.make_lc_le_step(tc, tlecfg)
    for t in range(1, 4):
        fused = fstep(fused, t)
        unfused, _rho = ustep(unfused, t)
    for a, b in zip(fused, unfused):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_lc_step_keeps_the_gradients_jax_keeps():
    """The plain unfused LC step with keep_grads: (f, q5, u, grad_q,
    delsq_q), the gradients of the pre-update Q, as the JAX package's
    unfused CLI route (LCConfig.keep_grads) carries them; initial_lc
    starts the tail with Q's own gradients."""
    jc, tc, jlecfg, _ = configs()
    jc = dataclasses.replace(jc, keep_grads=True)
    tc = dataclasses.replace(tc, keep_grads=True)
    _f, q5, _u = start(jc, jlecfg)
    js = jlc.initial_lc(jc, q5)
    ts = lc.initial_lc(tc, q5)
    assert len(ts) == len(js) == 5
    jstep = eager(jlc.make_lc_step(jc))
    tstep = lc.make_lc_step(tc)
    for t in range(1, 3):
        js, _ = jstep(js, t)
        ts, _ = tstep(ts, t)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_lc_le_fix_refusals():
    jc, tc, _jle, tlecfg = configs()
    with pytest.raises(ValueError, match="order-1"):
        lc.make_lc_le_column_fix(dataclasses.replace(tc, advection_order=2),
                                 tlecfg)
    with pytest.raises(ValueError, match="separation"):
        lc.make_lc_le_column_fix(tc, dataclasses.replace(tlecfg, nplanes=3))
