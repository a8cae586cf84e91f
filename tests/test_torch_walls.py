"""The port's halo plane walls (ops/walls.py, lb.make_wall_step,
ops/fused.make_fused_wall_step) against ludwig_tpu's, on the CPU.

The same random states, made with numpy from a seed, go through both
packages.  The port's fused fix reads the populations the walls reflect
from the kernel's periodic output (the JAX package collides the
boundary planes again); given the same values it is bitwise the JAX
fix.  The bounce-back values are held bitwise in f32 and f64 (both
evaluate f* - corr in double, the JAX package's numpy constants
promote); the walls' momentum at rtol 1e-12 in f64 and to 1e-5 of the
summed |f*| in f32 (the plane sums run in another order).  The fused
wall step holds the unfused one at rtol 1e-12 (f) and atol 1e-12
(gwall), and the JAX package's Pallas fused wall step (interpret mode,
the file's one Pallas run) at rtol 1e-12."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import lb as jlb
from ludwig_tpu.lattice import lb_model as jlb_model
from ludwig_tpu.ops import fused as jfused
from ludwig_tpu.ops import walls as jwalls
from ludwig_tpu.ops.stream import stream as jstream
from ludwig_tpu_torch import lb as tlb
from ludwig_tpu_torch.convert import params_from_jax, wall_state_from_jax
from ludwig_tpu_torch.lattice import lb_model
from ludwig_tpu_torch.ops import fused as tfused
from ludwig_tpu_torch.ops import walls as twalls

SIZE = (8, 16, 12)
AXES = {"x": (True, False, False), "y": (False, True, False),
        "xy": (True, True, False)}


def _spec(mod, walls, moving, slip=False):
    kw = dict(walls=walls)
    if moving:
        kw.update(ubot=(-0.01, 0.0, 0.0), utop=(0.02, 0.0, 0.0))
    if slip:
        kw.update(slip_bot=(0.5, 0.25, 0.0), slip_top=(0.25, 1.0, 0.0),
                  slip_active=True)
    return mod.WallSpec(**kw)


def _rand(shape, seed, dtype):
    model = jlb_model(19)
    rng = np.random.default_rng(seed)
    w = np.asarray(model.wv).reshape(-1, 1, 1, 1)
    return (w * (1.0 + 0.05 * rng.standard_normal((19,) + shape))).astype(
        dtype)


def _gw_close(got, want, fq, dtype):
    got = got.cpu().numpy()
    want = np.asarray(want, np.float64)
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * float(np.abs(fq).sum()))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("moving", [False, True])
@pytest.mark.parametrize("axes", list(AXES))
def test_wall_bounce_back_matches_jax(axes, moving, dtype):
    walls = AXES[axes]
    model = jlb_model(19)
    fpost = _rand(SIZE, 1, dtype)
    fnew = np.array(jstream(jnp.asarray(fpost), model))
    jf, _, jgw = jwalls.wall_bounce_back(
        jnp.asarray(fnew), jnp.asarray(fpost), model,
        _spec(jwalls, walls, moving), rho0=1.0)
    tf, _, tgw = twalls.wall_bounce_back(
        torch.as_tensor(fnew), torch.as_tensor(fpost), lb_model(19),
        _spec(twalls, walls, moving), rho0=1.0)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    _gw_close(tgw, jgw, fpost, dtype)


def test_wall_bounce_back_fluid_mask_and_second_distribution():
    """Colloid-covered wall sites take the rest value, and an ndist=2
    order-parameter distribution bounces with f."""
    model = jlb_model(19)
    walls = AXES["xy"]
    fpost, gpost = _rand(SIZE, 2, "float64"), _rand(SIZE, 3, "float64")
    fnew, gnew = (np.array(jstream(jnp.asarray(a), model))
                  for a in (fpost, gpost))
    fluid = np.random.default_rng(4).random(SIZE) > 0.3
    jf, jg, jgw = jwalls.wall_bounce_back(
        jnp.asarray(fnew), jnp.asarray(fpost), model,
        _spec(jwalls, walls, True), g_post=jnp.asarray(gpost),
        g_new=jnp.asarray(gnew), fluid=jnp.asarray(fluid))
    tf, tg, tgw = twalls.wall_bounce_back(
        torch.as_tensor(fnew), torch.as_tensor(fpost), lb_model(19),
        _spec(twalls, walls, True), g_post=torch.as_tensor(gpost),
        g_new=torch.as_tensor(gnew), fluid=torch.as_tensor(fluid))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    _gw_close(tgw, jgw, fpost, "float64")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("axes", list(AXES))
def test_wall_bounce_back_slip_matches_jax(axes, dtype):
    walls = AXES[axes]
    model = jlb_model(19)
    fpost = _rand(SIZE, 5, dtype)
    fnew = np.array(jstream(jnp.asarray(fpost), model))
    jf = jwalls.wall_bounce_back_slip(
        jnp.asarray(fnew), jnp.asarray(fpost), model,
        _spec(jwalls, walls, False, slip=True))
    tf = twalls.wall_bounce_back_slip(
        torch.as_tensor(fnew), torch.as_tensor(fpost), lb_model(19),
        _spec(twalls, walls, False, slip=True))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def _plane2(f, ax):
    idx = [slice(None)] * 4
    n = f.shape[1 + ax]
    return np.concatenate([f[tuple(idx[:1 + ax] + [slice(0, 1)])],
                           f[tuple(idx[:1 + ax] + [slice(n - 1, n)])]],
                          axis=1 + ax)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("moving", [False, True])
@pytest.mark.parametrize("axes", list(AXES))
def test_wall_bounce_back_fused_matches_jax(axes, moving, dtype):
    """The fix of a periodic collide+stream output: the port's on the
    unpadded output, reading the reflected populations where the stream
    wrapped them (every axis' before any write), against the JAX
    package's on the padded output, given the boundary planes of the
    same post-collision state; the duct's edges included."""
    walls = AXES[axes]
    model = jlb_model(19)
    fpost = _rand(SIZE, 6, dtype)
    f = np.array(jstream(jnp.asarray(fpost), model))
    jf, jgw = jwalls.wall_bounce_back_fused(
        jfused.pad_state(jnp.asarray(f), zpad=False),
        {ax: jnp.asarray(_plane2(fpost, ax)) for ax in range(3)
         if walls[ax]}, model, _spec(jwalls, walls, moving), rho0=1.0)
    tf, tgw = twalls.wall_bounce_back_fused(
        torch.as_tensor(f), lb_model(19), _spec(twalls, walls, moving),
        rho0=1.0)
    np.testing.assert_array_equal(
        tf.numpy(), np.asarray(jfused.unpad_state(jf, z=SIZE[2])))
    _gw_close(tgw, jgw, sum(np.abs(_plane2(fpost, ax)).sum()
                            for ax in range(3) if walls[ax]), dtype)


def _cfgs(walls, dtype="float64", size=SIZE):
    jcfg = jlb.LBConfig(size=size, nvel=19, eta_shear=0.1, eta_bulk=0.14,
                        force_global=(0.0, 1e-5, 2e-5), dtype=dtype)
    tcfg = params_from_jax({f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(jcfg)},
                           device="cpu")
    return jcfg, tcfg


@pytest.mark.parametrize("axes", list(AXES))
def test_make_wall_step_matches_jax(axes):
    """The unfused wall step (collide, stream, bounce-back, the walls'
    momentum as the difference of compensated totals), 3 steps."""
    walls = AXES[axes]
    jcfg, tcfg = _cfgs(walls)
    f0 = _rand(SIZE, 8, "float64")
    jstep = jlb.make_wall_step(jcfg, _spec(jwalls, walls, True))
    tstep = tlb.make_wall_step(tcfg, _spec(twalls, walls, True))
    js = (jnp.asarray(f0), jnp.zeros((3,)))
    ts = wall_state_from_jax(f0, np.zeros(3), "cpu", "float64")
    for t in range(1, 4):
        js, _jrho, ju = jstep(js, t)
        ts, _trho, tu = tstep(ts, t)
    np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0]), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(ts[1].numpy(), np.asarray(js[1]), rtol=1e-10,
                               atol=1e-14)


@pytest.mark.parametrize("axes", list(AXES))
def test_fused_wall_step_matches_unfused_wall_step(axes):
    """The port's fused wall step (the kernel's twin plus the O(surface)
    fix) holds its unfused wall step over 3 steps: f to roundoff, the
    walls' momentum (per-link sums against differences of totals) to
    atol 1e-12 (ludwig_tpu tests/test_ludwig_run.py:285 holds the same
    pair at the statistics' rtol 1e-9)."""
    walls = AXES[axes]
    _jcfg, tcfg = _cfgs(walls)
    spec = _spec(twalls, walls, True)
    f0 = torch.as_tensor(_rand(SIZE, 9, "float64"))
    zero = torch.zeros(3, dtype=torch.float64)
    fs, us = (f0, zero), (f0, zero)
    fused = tfused.make_fused_wall_step(tcfg, spec)
    unfused = tlb.make_wall_step(tcfg, spec)
    for t in range(1, 4):
        fs = fused(fs, t)
        us, _rho, _u = unfused(us, t)
    torch.testing.assert_close(fs[0], us[0], rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(fs[1], us[1], rtol=0, atol=1e-12)


def test_fused_wall_step_matches_jax_pallas():
    """The duct (walls on x and y, moving) through the JAX package's
    make_fused_wall_step (its Pallas kernel in interpret mode on the
    padded state) and the port's, 2 steps, f64."""
    walls = AXES["xy"]
    size = (8, 16, 16)
    jcfg, tcfg = _cfgs(walls, size=size)
    f0 = _rand(size, 10, "float64")
    jstep = jfused.make_fused_wall_step(jcfg, _spec(jwalls, walls, True),
                                        jfused.FusedPlan(4, 8),
                                        interpret=True)
    tstep = tfused.make_fused_wall_step(tcfg, _spec(twalls, walls, True))
    js = (jfused.pad_state(jnp.asarray(f0)), jnp.zeros((3,)))
    ts = wall_state_from_jax(*js, "cpu", "float64", size=size)
    np.testing.assert_array_equal(ts[0].numpy(), f0)
    for t in range(1, 3):
        js = jstep(js, t)
        ts = tstep(ts, t)
    want = wall_state_from_jax(*js, "cpu", "float64", size=size)
    torch.testing.assert_close(ts[0], want[0], rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(ts[1], want[1], rtol=1e-12, atol=1e-15)


def test_state_from_jax_refuses_a_foreign_shape():
    with pytest.raises(ValueError, match="neither unpadded nor padded"):
        wall_state_from_jax(np.zeros((19, 9, 16, 12)), np.zeros(3), "cpu",
                            "float64", size=SIZE)
