"""The port's sheared LC droplet (lc_droplet.make_droplet_le_step,
lc_droplet.make_droplet_le_column_fix, ops/fused_droplet.
make_fused_droplet_le_step) against ludwig_tpu's, on the CPU.

The same numpy inputs from a seed, 16x8x16 with 2 planes at uy 0.04 (8
columns apart: the fused fix's separation), go through both packages in
float64, 3 steps each, at rtol 1e-10 / atol 1e-12: the column fix
against the JAX fix (with the anchoring term on), the unfused step
against make_droplet_le_step, the fused step against the JAX
make_fused_droplet_le_step with its Pallas kernel in interpret mode.
The JAX steps run as test_torch_binary_le.py runs them."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import lc_droplet_sim as jds
from ludwig_tpu.fe.blue_phase import BluePhaseFE as JBP
from ludwig_tpu.fe.lc_droplet import LCDropletFE as JFE
from ludwig_tpu.fe.symmetric import SymmetricFE as JSymm
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.ops import fused as jfused
from ludwig_tpu.ops import fused_binary as jfb
from ludwig_tpu.ops import fused_droplet as jfd
from ludwig_tpu.ops import fused_lc as jfl
from ludwig_tpu.ops import lees_edwards as jle
from ludwig_tpu_torch import lc_droplet
from ludwig_tpu_torch.convert import droplet_le_state_from_jax
from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE
from ludwig_tpu_torch.fe.lc_droplet import LCDropletFE
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.lb import LBConfig
from ludwig_tpu_torch.ops import fused_droplet as fd
from ludwig_tpu_torch.ops import lees_edwards as tle
from test_torch_binary_le import (TOL, cols, eager, hold_cols,  # noqa: F401
                                  jit_kernels)

N = (16, 8, 16)
SYMM = dict(a=-0.0625, b=0.0625, kappa=0.053)
LC = dict(a0=0.1, gamma=3.0, q0=0.19635, kappa0=0.01, kappa1=0.01, xi=0.7)
DROP = dict(gamma0=2.586, delta=0.25)
LE = dict(nplanes=2, uy=0.04, nx=N[0])


def configs(w=0.0):
    jc = jds.LCDropletConfig(
        lb=JLBConfig(size=N, nvel=19, eta_shear=0.5, dtype="float64"),
        fe=JFE(symm=JSymm(**SYMM), lc=JBP(**LC), w=w, **DROP),
        mobility=0.05, gamma=0.5)
    tc = lc_droplet.LCDropletConfig(
        lb=LBConfig(size=N, nvel=19, eta_shear=0.5, dtype="float64",
                    device="cpu"),
        fe=LCDropletFE(symm=SymmetricFE(**SYMM), lc=BluePhaseFE(**LC), w=w,
                       **DROP),
        mobility=0.05, gamma=0.5)
    return jc, tc, jle.LeesEdwardsConfig(**LE), tle.LeesEdwardsConfig(**LE)


def start(jc, jlecfg, seed=11):
    """(f, phi, q5, u) as numpy: the sheared profile, a random phi, a
    random uniaxial Q and a random u."""
    rng = np.random.default_rng(seed)
    phi = 0.5 * (rng.random(N) - 0.5)
    n = rng.normal(size=(3,) + N)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    q = 0.2 * np.stack([n[0] * n[0] - 1 / 3, n[0] * n[1], n[0] * n[2],
                        n[1] * n[1] - 1 / 3, n[1] * n[2]])
    u = 0.01 * rng.standard_normal((3,) + N)
    return (np.asarray(jle.le_init_shear_profile(jc.lb, jlecfg)), phi, q, u)


@pytest.mark.parametrize("t,w", [(0, 0.0), (7, 0.02)], ids=["t0", "t7-W"])
def test_droplet_le_column_fix_matches_jax(t, w):
    jc, tc, jlecfg, tlecfg = configs(w)
    _f, phi, q5, u = start(jc, jlecfg)
    jp, jq, jf = jds.make_droplet_le_column_fix(jc, jlecfg)(
        jnp.asarray(phi), jnp.asarray(q5), jnp.asarray(u), t)
    idx, pv, qv, fv = lc_droplet.make_droplet_le_column_fix(tc, tlecfg)(
        torch.as_tensor(phi), torch.as_tensor(q5), torch.as_tensor(u), t)
    hold_cols(cols(idx, pv, 0), jp)
    hold_cols(cols(idx, qv, 1), jq)
    hold_cols(cols(idx, fv, 1), jf)


def test_droplet_le_step_matches_jax():
    jc, tc, jlecfg, tlecfg = configs(0.02)
    state = start(jc, jlecfg)
    js = tuple(jnp.asarray(a) for a in state)
    ts = tuple(torch.as_tensor(np.array(a)) for a in state)
    jstep = eager(jds.make_droplet_le_step(jc, jlecfg))
    tstep = lc_droplet.make_droplet_le_step(tc, tlecfg)
    for t in range(1, 4):
        js, _ = jstep(js, t)
        ts, _ = tstep(ts, t)
    for a, b in zip(ts, droplet_le_state_from_jax(js, "cpu", "float64")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_fused_droplet_le_step_matches_jax_interpret(jit_kernels):
    jc, tc, jlecfg, tlecfg = configs()
    f, phi, q5, u = start(jc, jlecfg)
    js = (jfused.pad_state(jnp.asarray(f), zpad=False),
          jfb.pad_phi(jnp.asarray(phi)), jfl.pad_q(jnp.asarray(q5)),
          jnp.asarray(u))
    ts = tuple(torch.as_tensor(np.array(a)) for a in (f, phi, q5, u))
    jstep = eager(jfd.make_fused_droplet_le_step(
        jc, jlecfg, jfd.DropletPlan(4, 8), lb_plan=jfused.FusedPlan(4, 8),
        interpret=True))
    tstep = fd.make_fused_droplet_le_step(tc, tlecfg)
    for t in range(1, 4):
        js = jstep(js, t)
        ts = tstep(ts, t)
    want = droplet_le_state_from_jax(js, "cpu", "float64")
    np.testing.assert_array_equal(want[2].numpy(), jfl.unpad_q(js[2]))
    for a, b in zip(ts, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_fused_droplet_le_step_matches_unfused():
    jc, tc, jlecfg, tlecfg = configs(0.02)
    state = tuple(torch.as_tensor(np.array(a)) for a in start(jc, jlecfg))
    fused, unfused = state, state
    fstep = fd.make_fused_droplet_le_step(tc, tlecfg)
    ustep = lc_droplet.make_droplet_le_step(tc, tlecfg)
    for t in range(1, 4):
        fused = fstep(fused, t)
        unfused, _rho = ustep(unfused, t)
    for a, b in zip(fused, unfused):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_droplet_le_fix_refusals():
    _jc, tc, _jle, tlecfg = configs()
    with pytest.raises(ValueError, match="order-1"):
        lc_droplet.make_droplet_le_column_fix(
            dataclasses.replace(tc, advection_order=2), tlecfg)
    with pytest.raises(ValueError, match="separation"):
        lc_droplet.make_droplet_le_column_fix(
            tc, dataclasses.replace(tlecfg, nplanes=3))
