"""The port's plain-fluid stepping (lb.py) against ludwig_tpu.lb, in f64.

Configurations and states cross through ludwig_tpu_torch.convert as
plain values and numpy arrays.  Tolerance rtol 1e-12 / atol 1e-14: the
same unrolled arithmetic on both sides (XLA:CPU without FMA,
conftest.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import lb as jlb
from ludwig_tpu.ops.collide import RelaxationScheme as JScheme
from ludwig_tpu_torch import lb as tlb
from ludwig_tpu_torch.convert import params_from_jax, state_from_jax
from ludwig_tpu_torch.noise import NoiseConfig

RTOL, ATOL = 1e-12, 1e-14
SIZE = (8, 16, 16)


def _jcfg(**kw):
    base = dict(size=SIZE, nvel=19, eta_shear=0.1, eta_bulk=0.14,
                force_global=(1e-4, -2e-4, 5e-5), dtype="float64")
    base.update(kw)
    return jlb.LBConfig(**base)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _noisy_state(jcfg, seed):
    rng = np.random.default_rng(seed)
    f = np.asarray(jlb.initial_rest(jcfg))
    return f * (1.0 + 0.05 * rng.standard_normal(f.shape))


def _close(a, b):
    np.testing.assert_allclose(a.cpu().numpy(), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("scheme", ["m10", "bgk", "trt"])
@pytest.mark.parametrize("walls", [(False, False, False),
                                   (True, False, False)])
def test_make_step_matches_jax(scheme, walls):
    jcfg = _jcfg(scheme=JScheme(scheme), walls=walls,
                 wall_u=(0.0, 0.01, 0.0) if any(walls) else (0.0,) * 3)
    tcfg = params_from_jax(_fields(jcfg), device="cpu")
    f0 = _noisy_state(jcfg, seed=3)
    jstep = jlb.make_step(jcfg, solid=jlb.solid_mask(jcfg))
    tstep = tlb.make_step(tcfg, solid=tlb.solid_mask(tcfg))
    jf, tf = jnp.asarray(f0), state_from_jax(f0, "cpu", "float64")
    for t in range(3):
        jf, jrho, ju = jstep(jf, t)
        tf, trho, tu = tstep(tf, t)
        _close(tf, jf)
        _close(trho, jrho)
        _close(tu, ju)


def test_make_nstep_matches_jax():
    jcfg = _jcfg()
    tcfg = params_from_jax(_fields(jcfg), device="cpu")
    f0 = _noisy_state(jcfg, seed=5)
    jf = jlb.make_nstep(jcfg)(jnp.asarray(f0), 3)
    tf = tlb.make_nstep(tcfg)(state_from_jax(f0, "cpu", torch.float64), 3)
    _close(tf, jf)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_initial_states_match_jax(dtype):
    jcfg = _jcfg(dtype=dtype, rho0=1.1)
    tcfg = params_from_jax(_fields(jcfg), device="cpu")
    tf = tlb.initial_rest(tcfg)
    assert tf.dtype == getattr(torch, dtype) and tf.is_contiguous()
    np.testing.assert_array_equal(tf.numpy(),
                                  np.asarray(jlb.initial_rest(jcfg)))
    rng = np.random.default_rng(7)
    rho = 1.0 + 0.01 * rng.standard_normal(SIZE)
    u = 0.02 * rng.standard_normal((3,) + SIZE)
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == "float64" else dict(
        rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(
        tlb.initial_from_hydro(tcfg, rho, u).numpy(),
        np.asarray(jlb.initial_from_hydro(jcfg, rho, u)), **tol)


def test_hydro_fields_match_jax():
    jcfg = _jcfg()
    f0 = _noisy_state(jcfg, seed=9)
    jrho, jg = jlb.hydro_fields(jnp.asarray(f0), jcfg.model)
    tcfg = params_from_jax(_fields(jcfg), device="cpu")
    trho, tg = tlb.hydro_fields(torch.as_tensor(f0), tcfg.model)
    _close(trho, jrho)
    _close(tg, jg)


def test_convert_round_trip():
    jcfg = _jcfg(scheme=JScheme.TRT, ghost_modes_on=False,
                 walls=(False, True, False), wall_u=(0.0, 0.0, 0.02))
    tcfg = params_from_jax(_fields(jcfg), device="cpu")
    for name, value in _fields(jcfg).items():
        got = getattr(tcfg, name)
        if name == "scheme":
            assert got.value == value.value
        else:
            assert got == value, name
    assert tcfg.device == "cpu"
    jp, tp = jcfg.collision_params(), tcfg.collision_params()
    assert (tp.rtau_shear, tp.rtau_bulk) == (jp.rtau_shear, jp.rtau_bulk)
    np.testing.assert_array_equal(tp.rtau_ghost, jp.rtau_ghost)
    f0 = _noisy_state(jcfg, seed=1)
    tf = state_from_jax(f0, "cpu", "float32")
    assert tf.dtype == torch.float32 and tf.is_contiguous()
    np.testing.assert_array_equal(tf.numpy(), f0.astype(np.float32))
    with pytest.raises(ValueError):
        state_from_jax(f0[0], "cpu", "float64")


def test_port_refuses_unported_features():
    # the JAX package's stateless threefry noise stream is ported
    # (tests/test_torch_threefry.py): its configuration is taken
    assert not tlb.LBConfig(size=SIZE, noise=NoiseConfig(
        kt=1e-5, rho=True, kiss=False)).noise.kiss
    with pytest.raises(TypeError):
        tlb.LBConfig(size=SIZE, noise=object())
    cfg = tlb.LBConfig(size=SIZE, device="cpu")
    assert tlb.LBConfig(size=SIZE).device == "cuda"   # the card by default
    # the n-step loop and a step without a KISS state draw the threefry
    # stream, as the JAX package's do (Lees-Edwards planes and open
    # boundaries, refused here before, are ported too:
    # test_torch_lees_edwards.py, test_torch_open_bc.py)
    noisy = dataclasses.replace(cfg, noise=NoiseConfig(kt=1e-5, rho=True))
    shat, ghat = tlb._noise_terms(noisy, noisy.collision_params(), 0)
    assert shat.shape == (3, 3) + SIZE and ghat.shape == (19,) + SIZE
    f = tlb.make_nstep(noisy)(tlb.initial_rest(noisy), 1)
    assert f.shape == (19,) + SIZE and bool(torch.isfinite(f).all())
    with pytest.raises(ValueError):
        tlb.LBConfig(size=SIZE, dtype="bfloat16")
