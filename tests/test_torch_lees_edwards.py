"""The port's Lees-Edwards planes (ops/lees_edwards.py, lb.make_step(le=),
ops/fused.make_fused_le_step) against ludwig_tpu's, on the CPU.

The same random states, made with numpy from a seed, go through both
packages' jnp / torch routes.  The column passes are held bitwise in f64
and f32 (t, the plane speed and the slide in the state's dtype, the
boost's sums in the JAX package's order), at a small t and in f32 at
t = 10^6, with 2 planes, X/2 planes (2 columns apart) and X planes (1
column apart: apply_le_fused must gather every column before it writes
one).  The fused step holds the unfused one at rtol 1e-12."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import lb as jlb
from ludwig_tpu.lattice import lb_model as jlb_model
from ludwig_tpu.ops import fused as jfused
from ludwig_tpu.ops import lees_edwards as jle
from ludwig_tpu.ops.stream import stream as jstream
from ludwig_tpu_torch import lb as tlb
from ludwig_tpu_torch.convert import le_state_from_jax, params_from_jax
from ludwig_tpu_torch.lattice import lb_model
from ludwig_tpu_torch.ops import fused as tfused
from ludwig_tpu_torch.ops import lees_edwards as tle
from ludwig_tpu_torch.ops.stream import stream as tstream

SIZE = (16, 12, 8)
UY = 0.05
PLANES = {"2": 2, "X/2": SIZE[0] // 2, "X": SIZE[0]}
TIMES = {"float64": (7,), "float32": (7, 1_000_003)}
CASES = [(n, dt, t) for n in PLANES for dt in TIMES for t in TIMES[dt]]
IDS = [f"{n}-{dt}-t{t}" for n, dt, t in CASES]


def _rand(seed, dtype, size=SIZE):
    w = np.asarray(jlb_model(19).wv).reshape(-1, 1, 1, 1)
    rng = np.random.default_rng(seed)
    return (w * (1.0 + 0.05 * rng.standard_normal((19,) + size))).astype(
        dtype)


def _le(mod, planes, nx=SIZE[0]):
    return mod.LeesEdwardsConfig(nplanes=PLANES[planes], uy=UY, nx=nx)


def test_plane_columns_match_jax():
    for n in range(1, 17):
        assert (tle.LeesEdwardsConfig(nplanes=n, uy=UY, nx=16).plane_cols
                == jle.LeesEdwardsConfig(nplanes=n, uy=UY, nx=16).plane_cols)


@pytest.mark.parametrize("planes,dtype,t", CASES, ids=IDS)
def test_apply_lb_le_matches_jax(planes, dtype, t):
    f = _rand(1, dtype)
    want = jle.apply_lb_le(jnp.asarray(f), jlb_model(19), _le(jle, planes), t)
    got = tle.apply_lb_le(torch.as_tensor(f), lb_model(19),
                          _le(tle, planes), t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("planes,dtype,t", CASES, ids=IDS)
def test_apply_le_fused_matches_jax(planes, dtype, t):
    """The post-pass on the port's unpadded state against the JAX
    package's on its padded state (pad_state without z lanes)."""
    f = _rand(2, dtype)
    want = jle.apply_le_fused(jfused.pad_state(jnp.asarray(f), zpad=False),
                              jlb_model(19), _le(jle, planes), t)
    got = tle.apply_le_fused(torch.as_tensor(f), lb_model(19),
                             _le(tle, planes), t)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfused.unpad_state(want, z=SIZE[2])))


@pytest.mark.parametrize("dtype,t", [("float64", 7), ("float32", 7),
                                     ("float32", 1_000_003)])
def test_apply_le_fused_is_le_conjugated_through_streaming(dtype, t):
    """stream(apply_lb_le(f*)) == apply_le_fused(stream(f*)) bitwise with
    planes 2 columns apart (X/2): the fused pass reads columns a
    neighbouring plane writes, so it must gather them all first."""
    model = lb_model(19)
    le = _le(tle, "X/2")
    fpost = torch.as_tensor(_rand(3, dtype))
    want = tstream(tle.apply_lb_le(fpost, model, le, t), model)
    got = tle.apply_le_fused(tstream(fpost, model), model, le, t)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _cfgs(dtype="float64"):
    jcfg = jlb.LBConfig(size=SIZE, nvel=19, eta_shear=0.1, eta_bulk=0.14,
                        force_global=(0.0, 1e-5, 0.0), dtype=dtype)
    tcfg = params_from_jax({f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(jcfg)},
                           device="cpu")
    return jcfg, tcfg


@pytest.mark.parametrize("planes", ["2"])
def test_make_step_le_matches_jax(planes):
    """collide -> LE -> stream, 3 steps from t = 1, f64 (the denser
    planes through the column passes above: the JAX step's compile
    grows with them)."""
    jcfg, tcfg = _cfgs()
    f0 = _rand(4, "float64")
    jstep = jlb.make_step(jcfg, le=_le(jle, planes))
    tstep = tlb.make_step(tcfg, le=_le(tle, planes))
    jf, tf = jnp.asarray(f0), le_state_from_jax(f0, "cpu", "float64")[0]
    for t in range(1, 4):
        jf, _jrho, ju = jstep(jf, t)
        tf, _trho, tu = tstep(tf, t)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("planes", ["2", "X/2"])
def test_fused_le_step_matches_unfused(planes):
    """The port's fused LE step (the kernel's twin plus the column
    post-pass) holds its unfused step, 3 steps, f64.  Not with planes 1
    column apart: there the unfused pass reads a column the plane before
    it wrote, the fused one the column as streamed (in the JAX package
    alike)."""
    _jcfg, tcfg = _cfgs()
    le = _le(tle, planes)
    f0 = torch.as_tensor(_rand(5, "float64"))
    fused = tfused.make_fused_le_step(tcfg, le)
    unfused = tlb.make_step(tcfg, le=le)
    fs, fu = (f0,), f0
    for t in range(1, 4):
        fs = fused(fs, t)
        fu, _rho, _u = unfused(fu, t)
    torch.testing.assert_close(fs[0], fu, rtol=1e-12, atol=1e-15)


def test_fused_le_step_state_from_jax_padded():
    """le_state_from_jax unpads the JAX package's fused LE state."""
    f = _rand(6, "float64")
    fpad = np.asarray(jfused.pad_state(jnp.asarray(f)))
    (got,) = le_state_from_jax(fpad, "cpu", "float64", size=SIZE)
    np.testing.assert_array_equal(got.numpy(), f)


@pytest.mark.parametrize("sign", [+1, -1])
@pytest.mark.parametrize("uy_component", [False, True])
def test_le_xneighbor_matches_jax(sign, uy_component):
    x = np.random.default_rng(7).standard_normal((3,) + SIZE)
    want = jle.le_xneighbor(jnp.asarray(x), _le(jle, "2"), 5.5, sign,
                            uy_component)
    got = tle.le_xneighbor(torch.as_tensor(x), _le(tle, "2"), 5.5, sign,
                           uy_component)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_shear_profiles_match_jax():
    jcfg, tcfg = _cfgs()
    for planes in ("2", "X/2"):
        want = jle.le_init_shear_profile(jcfg, _le(jle, planes))
        got = tle.le_init_shear_profile(tcfg, _le(tle, planes))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        x = np.arange(SIZE[0])
        np.testing.assert_array_equal(
            tle.le_steady_profile(_le(tle, planes), x),
            jle.le_steady_profile(_le(jle, planes), x))


def test_oscillatory_planes_match_jax():
    """The oscillatory speed and slide (omega != 0) in the state's dtype,
    through apply_lb_le."""
    f = _rand(8, "float32")
    jcfg = dataclasses.replace(_le(jle, "2"), omega=0.013)
    tcfg = dataclasses.replace(_le(tle, "2"), omega=0.013)
    want = jle.apply_lb_le(jnp.asarray(f), jlb_model(19), jcfg, 101)
    got = tle.apply_lb_le(torch.as_tensor(f), lb_model(19), tcfg, 101)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-8)


def test_stream_matches_jax():
    f = _rand(9, "float64")
    np.testing.assert_array_equal(
        tstream(torch.as_tensor(f), lb_model(19)).numpy(),
        np.asarray(jstream(jnp.asarray(f), jlb_model(19))))
