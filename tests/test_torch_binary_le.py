"""The port's sheared binary fluid (binary_le.py, ops/fused_binary.
make_fused_binary_le_step) against ludwig_tpu's, on the CPU.

The same numpy inputs from a seed, 16x8x16 with 2 planes at uy 0.04 (the
JAX package's tests/test_fused.py:384-399 lattice), go through both
packages in float64: the column fix against the JAX fix, the unfused
step (with the gradients it keeps) against make_binary_le_step, and the
fused step against the JAX make_fused_binary_le_step with its Pallas
kernels in interpret mode, 3 steps each, at rtol 1e-10 / atol 1e-12 (the
tolerance of tests/test_fused.py:353, :399, :658).

The JAX steps run eagerly (their jit's __wrapped__ function): compiling
a whole sheared step takes XLA tens of seconds on the CPU, longer than
running it.  The Pallas kernels inside run through jax.jit (the
`jit_kernels` fixture), so each compiles once, not at every call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import binary as jbinary
from ludwig_tpu import binary_le as jble
from ludwig_tpu.fe.symmetric import SymmetricFE as JFE
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.ops import fused as jfused
from ludwig_tpu.ops import fused_binary as jfb
from ludwig_tpu.ops import fused_droplet as jfd
from ludwig_tpu.ops import fused_lc as jfl
from ludwig_tpu.ops import lees_edwards as jle
from ludwig_tpu_torch import binary, binary_le
from ludwig_tpu_torch.convert import binary_le_state_from_jax
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.lb import LBConfig
from ludwig_tpu_torch.ops import fused_binary as fb
from ludwig_tpu_torch.ops import lees_edwards as tle

N = (16, 8, 16)
FE = dict(a=-6.25e-3, b=6.25e-3, kappa=4e-3)
LE = dict(nplanes=2, uy=0.04, nx=N[0])
TOL = dict(rtol=1e-10, atol=1e-12)


def configs(order, nplanes=2):
    le = dict(LE, nplanes=nplanes)
    jc = jble.BinaryLEConfig(
        binary=jbinary.BinaryConfig(
            lb=JLBConfig(size=N, nvel=19, eta_shear=0.1, dtype="float64"),
            fe=JFE(**FE), mobility=1.25, advection_order=order),
        le=jle.LeesEdwardsConfig(**le))
    tc = binary_le.BinaryLEConfig(
        binary=binary.BinaryConfig(
            lb=LBConfig(size=N, nvel=19, eta_shear=0.1, dtype="float64",
                        device="cpu"),
            fe=SymmetricFE(**FE), mobility=1.25, advection_order=order),
        le=tle.LeesEdwardsConfig(**le))
    return jc, tc


def fields(seed=1):
    rng = np.random.default_rng(seed)
    return (0.05 * rng.standard_normal(N),
            0.01 * rng.standard_normal((3,) + N))


def start(jc):
    """(f, phi, u) as numpy: the sheared profile, a random phi and u."""
    phi, u = fields()
    return (np.asarray(jle.le_init_shear_profile(jc.binary.lb, jc.le)), phi,
            u)


@pytest.fixture
def jit_kernels(monkeypatch):
    """The JAX package's Pallas kernel entry points through jax.jit, for
    this test only (static: free energy, constants, plans, interpret)."""
    kernels = ((jfb, "binary_phi_force_step", (2, 3, 4, 5)),
               (jfl, "lc_q_force_step", (2, 3, 4, 5)),
               (jfd, "droplet_phi_q_force_step", (3, 4, 5, 6, 7)),
               (jfused, "fused_force_step", (2, 3, 4)))
    for mod, name, static in kernels:
        monkeypatch.setattr(mod, name, jax.jit(
            getattr(mod, name), static_argnums=static,
            static_argnames=("interpret",)))


def eager(step):
    """A jitted JAX step's Python function, run op by op."""
    return step.__wrapped__


def cols(idx, vals, axis):
    """The port's (idx, values) as the JAX fix's {column: values}."""
    return {int(i): np.take(vals.numpy(), k, axis=axis)
            for k, i in enumerate(idx)}


def hold_cols(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for col, v in want.items():
        np.testing.assert_allclose(got[col], np.asarray(v), **TOL)


@pytest.mark.parametrize("order,t", [(1, 0), (1, 7), (2, 7)])
def test_binary_le_column_fix_matches_jax(order, t):
    jc, tc = configs(order)
    phi, u = fields()
    jp, jf = jble.make_binary_le_column_fix(jc)(jnp.asarray(phi),
                                                jnp.asarray(u), t)
    (pi, pv), (fi, fv) = binary_le.make_binary_le_column_fix(tc)(
        torch.as_tensor(phi), torch.as_tensor(u), t)
    hold_cols(cols(pi, pv, 0), jp)
    hold_cols(cols(fi, fv, 1), jf)


@pytest.mark.parametrize("order", [1, 2])
def test_binary_le_step_matches_jax(order):
    """3 unfused steps, the kept LE gradients of the pre-update phi
    included."""
    jc, tc = configs(order)
    f, phi, u = start(jc)
    jgrad, jdsq = jble.le_gradient(jnp.asarray(phi), jc.le, 0)
    js = tuple(jnp.asarray(a) for a in (f, phi, u)) + (jgrad, jdsq)
    ts = tuple(torch.as_tensor(np.array(a)) for a in js)
    jstep = eager(jble.make_binary_le_step(jc, keep_grads=True))
    tstep = binary_le.make_binary_le_step(tc, keep_grads=True)
    for t in range(1, 4):
        js, _ = jstep(js, t)
        ts, _ = tstep(ts, t)
    assert len(ts) == len(js) == 5
    for a, b in zip(ts, binary_le_state_from_jax(js, "cpu", "float64")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_fused_binary_le_step_matches_jax_interpret(jit_kernels):
    """3 fused steps: the K1 and K2 twins, the column fix and the LE
    post-pass against the JAX package's Pallas kernels in interpret mode
    with its column fix and post-pass."""
    jc, tc = configs(1)
    f, phi, u = start(jc)
    js = (jfused.pad_state(jnp.asarray(f), zpad=False),
          jfb.pad_phi(jnp.asarray(phi)), jnp.asarray(u))
    ts = tuple(torch.as_tensor(np.array(a)) for a in (f, phi, u))
    jstep = eager(jfb.make_fused_binary_le_step(
        jc, jfb.BinaryPlan(4, 8), lb_plan=jfused.FusedPlan(4, 8),
        interpret=True))
    tstep = fb.make_fused_binary_le_step(tc)
    for t in range(1, 4):
        js = jstep(js, t)
        ts = tstep(ts, t)
    want = binary_le_state_from_jax(js, "cpu", "float64")
    np.testing.assert_array_equal(want[1].numpy(), jfb.unpad_phi(js[1]))
    for a, b in zip(ts, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("order", [1, 2])
def test_fused_binary_le_step_matches_unfused(order):
    """The port's two routes, 3 steps from the sheared profile."""
    _jc, tc = configs(order)
    jc, _ = configs(order)
    state = tuple(torch.as_tensor(np.array(a)) for a in start(jc))
    fused, unfused = state, state
    fstep = fb.make_fused_binary_le_step(tc)
    ustep = binary_le.make_binary_le_step(tc)
    for t in range(1, 4):
        fused = fstep(fused, t)
        unfused, _rho = ustep(unfused, t)
    for a, b in zip(fused, unfused):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_binary_le_fix_refusals():
    """The column fix needs advection order 1-2 and planes 6 columns
    apart, as the JAX fix does."""
    _jc, tc = configs(1, nplanes=3)
    with pytest.raises(ValueError, match="separation"):
        binary_le.make_binary_le_column_fix(tc)
