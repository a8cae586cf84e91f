"""D2Q9 on the port's one-step fused kernels against ludwig_tpu's, on the
CPU.

The twins of fused_step with and without its in-kernel fluctuations
(the plain versions of csrc/fused_lb.cu's D2Q9 library fused_lb_q9) are
held to the JAX package's _fused_kernel (and its FusedNoise variant) in
interpret mode at 16x16x1 and 32x24x1: f64 at rtol 1e-12 / atol 1e-14,
f32 at rtol 1e-6 / atol 1e-8 (tests/test_fused.py:47), with noise the
f32 tolerance of tests/test_torch_fused_noise.py.  The kernels the JAX
package does not run with D2Q9 (the n-step kernel on its hardware, the
force kernel anywhere) are refused by name; the n-step twin stays
bitwise n single steps.  The 2-D CLI routes match the JAX package's: the
fluctuating shear layer on the fused noise step, and the electrolyte on
a Z = 1 lattice in float32 (the whole-log check of the noiseless shear
layer under `tpu_fused on` is tests/test_torch_fulllog.py's)."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import noise as jnoise
from ludwig_tpu.lattice import lb_model as jlb_model
from ludwig_tpu.ludwig import run_text as jrun_text
from ludwig_tpu.ops import fused as jfused
from ludwig_tpu.ops.collide import CollisionParams as JParams
from ludwig_tpu.ops.collide import RelaxationScheme as JScheme
from ludwig_tpu_torch.convert import fused_noise_from_jax
from ludwig_tpu_torch.lattice import lb_model
from ludwig_tpu_torch.ludwig import run_text
from ludwig_tpu_torch.ops import fused
from ludwig_tpu_torch.ops.collide import CollisionParams, RelaxationScheme
from test_ludwig_run import _stat_floats
from test_torch_cli import ELECTRO_INPUT
from test_torch_fulllog import KH_INPUT

SHAPES = [(16, 16, 1), (32, 24, 1)]
TOL = {"float64": dict(rtol=1e-12, atol=1e-14),
       "float32": dict(rtol=1e-6, atol=1e-8)}
NOISE_TOL = {"float64": TOL["float64"],
             "float32": dict(rtol=1e-5, atol=1e-7)}
KT = 1e-5


def _rand_f(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    w = lb_model(9).wv.reshape(-1, 1, 1, 1)
    return (w * (1.0 + 0.05 * rng.standard_normal((9,) + shape))
            ).astype(dtype)


def _params(scheme):
    kw = dict(eta_shear=0.1, eta_bulk=0.14, force_global=(1e-4, -2e-4, 0.0))
    return (JParams(model=jlb_model(9), scheme=JScheme(scheme), **kw),
            CollisionParams(model=lb_model(9),
                            scheme=RelaxationScheme(scheme), **kw))


def _jax_steps(f, jp, shape, n, noise=None, delta=True):
    fp = jfused.pad_state(jnp.asarray(f))
    for t in range(1, n + 1):
        fp = jfused.fused_step(fp, jp.model, jp, jfused.FusedPlan(4, 8),
                               interpret=True, z=shape[2], noise=noise, t=t,
                               delta=delta)
    return np.asarray(jfused.unpad_state(fp, z=shape[2]))


@pytest.mark.parametrize("shape", SHAPES, ids=["16x16x1", "32x24x1"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_d2q9_fused_twin_matches_pallas_interpret(shape, dtype):
    """One step of each back-transform form; M10 on the square lattice,
    BGK on the other."""
    jp, tp = _params("m10" if shape[0] == shape[1] else "bgk")
    f = _rand_f(shape, seed=9, dtype=dtype)
    for delta in (True, False):
        want = _jax_steps(f, jp, shape, 1, delta=delta)
        got = fused.fused_step(torch.as_tensor(f), tp.model, tp,
                               delta=delta)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("shape", SHAPES, ids=["16x16x1", "32x24x1"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_d2q9_noise_twin_matches_pallas_interpret(shape, dtype):
    """The fluctuating step: 6 + 3 deviates a site, the three ghosts'."""
    jp, tp = _params("m10")
    jn = jfused.FusedNoise(
        seed=2 ** 31 + 5, v_eta=jnoise.var_eta(1.0 / jp.rtau_shear, KT),
        v_bulk=jnoise.var_bulk(1.0 / jp.rtau_bulk, KT),
        v_ghost=tuple(jnoise.var_ghost(jp.model, jp.rtau_ghost, KT)))
    tn = fused_noise_from_jax(jn)
    f = _rand_f(shape, seed=19, dtype=dtype)
    want = _jax_steps(f, jp, shape, 1, noise=jn)
    got = fused.fused_step(torch.as_tensor(f), tp.model, tp, noise=tn, t=1)
    np.testing.assert_allclose(got.numpy(), want, **NOISE_TOL[dtype])


def test_d2q9_refusals_and_the_nstep_twin():
    """The force kernel takes no D2Q9 (the JAX package's fails on its
    third velocity component); the n-step twin on the CPU stays bitwise
    n single steps (the CUDA launcher refuses D2Q9, as the JAX n-step
    kernel needs Z % 128 == 0 on its hardware)."""
    _jp, tp = _params("m10")
    f = torch.as_tensor(_rand_f((16, 16, 1), seed=3, dtype="float64"))
    force = torch.zeros((3, 16, 16, 1), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="D2Q9"):
        fused.fused_force_step(f, force, tp.model, tp)
    ref = f
    for _ in range(3):
        ref = fused.fused_step(ref, tp.model, tp, delta=False)
    out = fused.fusedn_step(f, tp.model, tp, 3, fused.FusedPlan(8, 8, 4))
    assert torch.equal(out, ref)


NOISE_KH = KH_INPUT + ("temperature 0.00002\nisothermal_fluctuations on\n"
                       "random_seed 8361235\n")


@pytest.mark.parametrize("name", ["kh-noise", "electro-2d-f32"])
def test_2d_cli_routes_match_jax(name):
    """The fluctuating shear layer through the fused noise step (in
    float64 the step follows the JAX package's gate: `interpret` takes
    the kernel, `on` the KISS route), and the electrolyte on a 16x8x1
    D2Q9 lattice in float32, whose LB update the JAX package's route
    collides unfused (its fused gate needs Z % 128 == 0).  Statistics
    floats at rtol 1e-9 / atol 1e-11; in float32 rtol 1e-5 / atol 1e-6,
    the rounding of a 128-site f32 total of values up to 1."""
    if name == "kh-noise":
        jtext = text = "tpu_fused interpret\n" + NOISE_KH
        tol = dict(rtol=1e-9, atol=1e-11)
    else:
        jtext = text = (ELECTRO_INPUT.replace("size 16_4_4", "size 16_8_1")
                        .replace("dtype float64", "dtype float32")
                        .replace("N_cycles 6", "N_cycles 2")
                        .replace("freq_statistics 3", "freq_statistics 1"))
        tol = dict(rtol=1e-5, atol=1e-6)
    a, b = io.StringIO(), io.StringIO()
    jrun_text(jtext, out=a)
    sys_ = run_text(text, out=b, device="cpu")
    assert sys_.lb_cfg.nvel == 9
    if name == "kh-noise":
        assert sys_.fused_mode == "plain"
    x, y = _stat_floats(a.getvalue()), _stat_floats(b.getvalue())
    assert x.size == y.size > 0
    np.testing.assert_allclose(y, x, **tol)
    assert b.getvalue().rstrip().endswith("Ludwig finished normally.")
