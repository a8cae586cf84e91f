"""The port's in-kernel fluctuations (FusedNoise) against ludwig_tpu's.

The counter-hash deviates and noise fields must be bitwise the JAX
package's (its int32 wrap-around hash, here on 32-bit words in int64),
also where t * 0x9e3779b9 wraps and for a seed above 2^31.  The fused
twin with noise runs 3 steps against the Pallas kernel with FusedNoise
in interpret mode, f64 rtol 1e-12 / atol 1e-14 and f32 rtol 1e-5 / atol
1e-7 (tests/test_fused.py:615 holds the kernel to the jnp path at the
f64 tolerance); the noise moves neither mass nor momentum."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import noise as jnoise
from ludwig_tpu.lattice import lb_model as jlb_model
from ludwig_tpu.ops import fused as jfused
from ludwig_tpu.ops.collide import CollisionParams as JParams
from ludwig_tpu.ops.collide import RelaxationScheme as JScheme
from ludwig_tpu_torch.convert import fused_noise_from_jax
from ludwig_tpu_torch.lattice import lb_model
from ludwig_tpu_torch.ops import fused
from ludwig_tpu_torch.ops.collide import (CollisionParams, RelaxationScheme,
                                          collide)
from ludwig_tpu_torch.ops.stream import stream

SHAPE = (8, 8, 16)
KT = 1e-5
TOL = {"float64": dict(rtol=1e-12, atol=1e-14),
       "float32": dict(rtol=1e-5, atol=1e-7)}
STEPS = [0, 1, 7, 2 ** 20 + 3]
SEEDS = [8361235, 2 ** 31 + 5]


def _params(scheme="m10", force=(1e-5, 0.0, 0.0), nvel=19):
    kw = dict(eta_shear=0.05, eta_bulk=0.07, force_global=force)
    jp = JParams(model=jlb_model(nvel), scheme=JScheme(scheme), **kw)
    tp = CollisionParams(model=lb_model(nvel),
                         scheme=RelaxationScheme(scheme), **kw)
    return jp, tp


def _noise(jp, seed=12345):
    jn = jfused.FusedNoise(
        seed=seed, v_eta=jnoise.var_eta(1.0 / jp.rtau_shear, KT),
        v_bulk=jnoise.var_bulk(1.0 / jp.rtau_bulk, KT),
        v_ghost=tuple(jnoise.var_ghost(jp.model, jp.rtau_ghost, KT)))
    return jn, fused_noise_from_jax(jn)


def _rand_f(nvel, seed, dtype):
    rng = np.random.default_rng(seed)
    w = lb_model(nvel).wv.reshape(-1, 1, 1, 1)
    return (w * (1.0 + 0.05 * rng.standard_normal((nvel,) + SHAPE))
            ).astype(dtype)


def _coords():
    X, Y, Z = SHAPE
    j = (jnp.arange(X, dtype=jnp.int32)[:, None, None],
         jnp.arange(Y, dtype=jnp.int32)[None, :, None],
         jnp.arange(Z, dtype=jnp.int32)[None, None, :])
    t = (torch.arange(X)[:, None, None], torch.arange(Y)[None, :, None],
         torch.arange(Z)[None, None, :])
    return j, t


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("t", STEPS)
def test_window_deviates_bitwise(seed, t):
    (jx, jy, jz), (tx, ty, tz) = _coords()
    want = jfused._window_deviates(SHAPE, jx, jy, jz,
                                   jnp.asarray(t, jnp.int32), seed, 15,
                                   np.float64)
    got = fused._window_deviates(tx, ty, tz, t, seed, 15, torch.float64)
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(
            jnp.broadcast_to(w, SHAPE)).tobytes()


def test_hash_matches_int32_wraparound():
    """The 32-bit-word hash is the JAX int32 one bit for bit, on keys
    whose products wrap (negative as int32)."""
    rng = np.random.default_rng(0)
    h = rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=np.int64)
    want = np.asarray(jfused._hash_u32(jnp.asarray(h, jnp.int32)))
    got = fused._hash_u32(torch.as_tensor(h & 0xFFFFFFFF)).numpy()
    assert np.array_equal(got.astype(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("t", [3, 2 ** 20 + 3])
def test_fused_noise_fields_bitwise(dtype, t):
    jp, tp = _params()
    jn, tn = _noise(jp, seed=SEEDS[1])
    js, jg = jfused.fused_noise_fields(jp.model, jn, SHAPE, t,
                                       getattr(np, dtype))
    ts, tg = fused.fused_noise_fields(tp.model, tn, SHAPE, t,
                                      getattr(torch, dtype), device="cpu")
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert tg.numpy().tobytes() == np.asarray(jg).tobytes()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("delta", [True, False])
def test_fused_noise_twin_matches_pallas_interpret(dtype, delta):
    jp, tp = _params()
    jn, tn = _noise(jp)
    f0 = _rand_f(19, seed=21, dtype=dtype)
    fp = jfused.pad_state(jnp.asarray(f0))
    ft = torch.as_tensor(f0)
    for t in range(1, 4):
        fp = jfused.fused_step(fp, jp.model, jp, jfused.FusedPlan(4, 8),
                               interpret=True, z=SHAPE[2], noise=jn, t=t,
                               delta=delta)
        ft = fused.fused_step(ft, tp.model, tp, noise=tn, t=t, delta=delta)
    np.testing.assert_allclose(
        ft.numpy(), np.asarray(jfused.unpad_state(fp, z=SHAPE[2])),
        **TOL[dtype])


@pytest.mark.parametrize("nvel,scheme", [(19, "m10"), (19, "trt"),
                                         (15, "m10"), (27, "bgk")])
def test_fused_noise_twin_is_collide_plus_stream(nvel, scheme):
    """The twin with noise equals ops.collide fed the same noise fields,
    then the pull stream (absolute form, as collide computes), and the
    noise leaves mass and momentum alone."""
    jp, tp = _params(scheme, nvel=nvel)
    _jn, tn = _noise(jp)
    f = torch.as_tensor(_rand_f(nvel, seed=nvel, dtype="float64"))
    a = b = quiet = f
    for t in range(3):
        a = fused.fused_step(a, tp.model, tp, noise=tn, t=t, delta=False)
        shat, ghat = fused.fused_noise_fields(tp.model, tn, SHAPE, t,
                                              torch.float64, device="cpu")
        b = stream(collide(b, tp, shat=shat, ghat=ghat)[0], tp.model)
        quiet = fused.fused_step(quiet, tp.model, tp, delta=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)
    cv = torch.as_tensor(np.asarray(tp.model.cv, np.float64))
    for x in (a, quiet):
        assert abs(float(x.sum() - f.sum())) < 1e-12 * f[0].numel()
    g_noise = torch.einsum("qxyz,qa->a", a, cv)
    g_quiet = torch.einsum("qxyz,qa->a", quiet, cv)
    assert float((g_noise - g_quiet).abs().max()) < 1e-12 * f[0].numel()
    assert float((a - quiet).abs().max()) > 1e-6


def test_step_counter_must_fit_int32():
    _jp, tp = _params()
    _jn, tn = _noise(_jp)
    f = torch.as_tensor(_rand_f(19, seed=1, dtype="float64"))
    with pytest.raises(ValueError, match="int32"):
        fused.fused_step(f, tp.model, tp, noise=tn, t=2 ** 31)
