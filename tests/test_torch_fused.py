"""The port's fused collide+stream twins against ludwig_tpu's fused kernels.

The JAX side runs as its own tests run it: the Pallas kernels in
interpret mode, or the jnp collide+stream they are held to.  Compared on
the unpadded state.  Tolerances: f64 rtol 1e-12 / atol 1e-14 (same
unrolled arithmetic on both sides), f32 rtol 1e-6 / atol 1e-8 as
tests/test_fused.py holds the Pallas kernel to the jnp path; the n-step
twin is bitwise n single-step twins, as test_fused.py:293 holds the
Pallas n-step kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu.lattice import lb_model as jlb_model
from ludwig_tpu.ops import fused as jfused
from ludwig_tpu.ops.collide import CollisionParams as JParams
from ludwig_tpu.ops.collide import RelaxationScheme as JScheme
from ludwig_tpu.ops.collide import collide as jcollide
from ludwig_tpu.ops.stream import stream as jstream
from ludwig_tpu_torch.lattice import lb_model
from ludwig_tpu_torch.ops import fused
from ludwig_tpu_torch.ops.collide import CollisionParams, RelaxationScheme

SHAPE = (8, 16, 16)
FORCE_G = (1e-4, -2e-4, 5e-5)
TOL = {"float64": dict(rtol=1e-12, atol=1e-14),
       "float32": dict(rtol=1e-6, atol=1e-8)}


def _rand_f(nvel, seed, dtype="float64", shape=SHAPE):
    rng = np.random.default_rng(seed)
    w = lb_model(nvel).wv.reshape(-1, 1, 1, 1)
    return (w * (1.0 + 0.05 * rng.standard_normal((nvel,) + shape))
            ).astype(dtype)


def _both_params(nvel, scheme="m10", eta=0.1, eta_bulk=0.14,
                 force=FORCE_G):
    jp = JParams(model=jlb_model(nvel), eta_shear=eta, eta_bulk=eta_bulk,
                 scheme=JScheme(scheme), force_global=force)
    tp = CollisionParams(model=lb_model(nvel), eta_shear=eta,
                         eta_bulk=eta_bulk,
                         scheme=RelaxationScheme(scheme),
                         force_global=force)
    return jp, tp


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("delta", [True, False])
def test_fused_twin_matches_pallas_interpret(delta, dtype):
    f = _rand_f(19, seed=1, dtype=dtype)
    jp, tp = _both_params(19)
    plan = jfused.FusedPlan(BX=4, BY=8)   # multiple blocks in both axes
    expect = jfused.unpad_state(
        jfused.fused_step(jfused.pad_state(jnp.asarray(f)), jp.model, jp,
                          plan, interpret=True, z=SHAPE[2], delta=delta),
        z=SHAPE[2])
    out = fused.fused_step(torch.as_tensor(f), tp.model, tp, delta=delta)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                               **TOL[dtype])


@pytest.mark.parametrize("nvel", [15, 19, 27])
@pytest.mark.parametrize("scheme", ["m10", "bgk", "trt"])
@pytest.mark.parametrize("delta", [True, False])
def test_fused_twin_matches_jnp_collide_stream(nvel, scheme, delta):
    """Every velocity set and relaxation scheme, both back-transform
    forms, against the jnp collide + stream the Pallas kernel is held to
    (in f64 the two forms differ only by rounding)."""
    f = _rand_f(nvel, seed=nvel)
    jp, tp = _both_params(nvel, scheme)
    if scheme == "trt" and nvel == 27:
        # no TRT ghost split for D3Q27 (ref asserts): the port refuses too
        with pytest.raises(ValueError):
            fused.fused_step(torch.as_tensor(f), tp.model, tp, delta=delta)
        return
    expect = jstream(jcollide(jnp.asarray(f), jp)[0], jp.model)
    out = fused.fused_step(torch.as_tensor(f), tp.model, tp, delta=delta)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("nsteps", [2, 3, 4])
@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("plan", [fused.FusedPlan(),
                                  fused.FusedPlan(5, 7, 9)],
                         ids=["default", "ragged"])
def test_fusedn_twin_is_n_single_steps(nsteps, delta, plan):
    """Bitwise, on the kernel's own tiling; the ragged plan leaves
    partial tiles on every axis."""
    f = torch.as_tensor(_rand_f(19, seed=11))
    _, tp = _both_params(19, eta_bulk=0.1)
    ref = f
    for _ in range(nsteps):
        ref = fused.fused_step(ref, tp.model, tp, delta=delta)
    out = fused.fusedn_step(f, tp.model, tp, nsteps, plan, delta=delta)
    assert torch.equal(out, ref)
    # and chained through the n-step loops
    out2 = fused.make_fusedn_nstep(tp.model, tp, nsteps, plan,
                                   delta=delta)(f, 2 * nsteps)
    ref2 = fused.make_fused_nstep(tp.model, tp, delta=delta)(f, 2 * nsteps)
    assert torch.equal(out2, ref2)


def test_fusedn_twin_matches_pallas_interpret():
    """n=2 once against the Pallas n-step kernel (absolute form, its
    default)."""
    f = _rand_f(19, seed=13)
    jp, tp = _both_params(19)
    plan = jfused.FusedPlan(BX=4, BY=8)
    expect = jfused.unpad_staten(
        jfused.fusedn_step(jfused.pad_staten(jnp.asarray(f), 2), jp.model,
                           jp, 2, plan, interpret=True), 2)
    out = fused.fusedn_step(torch.as_tensor(f), tp.model, tp, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                               rtol=1e-12, atol=1e-14)


def test_fused_rejects_what_it_cannot_run():
    _, tp = _both_params(19)
    f = torch.as_tensor(_rand_f(19, seed=2))
    with pytest.raises(TypeError):        # noise is a FusedNoise
        fused.fused_step(f, tp.model, tp, noise=object())
    with pytest.raises(ValueError):
        fused.fusedn_step(f, tp.model, tp, fused.NSTEPS_MAX + 1)
    with pytest.raises(ValueError):
        fused.fused_step(f[:, :, :, ::2], tp.model, tp)     # not contiguous
    with pytest.raises(ValueError):
        fused.fused_step(f.to("meta"), tp.model, tp)        # no kernel
    with pytest.raises(TypeError):
        fused.fused_step(f.to(torch.float16), tp.model, tp)
