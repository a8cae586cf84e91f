"""The port's stateless threefry stream against jax.random, on the CPU.

ludwig_tpu_torch/noise.py reproduces the JAX package's counter-based
noise (ludwig_tpu/noise.py): jax.random.key(seed), fold_in(key, step)
and randint(key, shape, 0, 8) under jax_threefry_partitionable, in
int64 words masked to 32 bits.  The integer draws and the discrete
deviates are held bit for bit, the scaled combinations built on them
(the fluctuating stress, the ghost noise, the CH random flux, the
Q-tensor noise) at rtol 1e-15."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import noise as jnoise
from ludwig_tpu.lattice import lb_model as jlb_model
from ludwig_tpu_torch import noise as tnoise
from ludwig_tpu_torch.lattice import lb_model

SEEDS = [0, 13, 8361235, 8361235 + 7919]
SHAPES = [(3, 5, 7, 11), (9, 16, 16, 1), (5, 8, 16, 16)]
TDT = {"float64": torch.float64, "float32": torch.float32}
NDT = {"float64": jnp.float64, "float32": jnp.float32}


def test_partitionable_threefry_is_what_the_port_assumes():
    """The port reproduces the partitionable threefry key derivation and
    bit layout; a JAX whose default changes fails here by name."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_bitwise(seed, shape):
    for step in range(4):
        key = jax.random.fold_in(jax.random.key(seed), step)
        want = np.asarray(jax.random.randint(key, shape, 0, 8,
                                             dtype=jnp.int32))
        got = tnoise.threefry_randint8(seed, step, shape, device="cpu")
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want)


def test_fold_in_under_jit_matches():
    """The JAX package passes a traced step counter: fold_in of a traced
    int32 gives the same key as of the Python int."""
    seed, shape = 8361235, (5, 4, 4, 4)

    @jax.jit
    def draw(t):
        return jnoise.discrete_deviates(seed, t, 5, shape[1:], jnp.float64)

    for step in (0, 3, 1000):
        want = np.asarray(draw(jnp.int32(step)))
        got = tnoise.discrete_deviates(seed, step, 5, shape[1:],
                                       torch.float64, device="cpu")
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("seed", [13, 8361235])
def test_discrete_deviates_bitwise(seed, dtype):
    for step in range(2):
        want = np.asarray(jnoise.discrete_deviates(seed, step, 6, (4, 6, 8),
                                                   NDT[dtype]))
        got = tnoise.discrete_deviates(seed, step, 6, (4, 6, 8), TDT[dtype],
                                       device="cpu")
        assert got.dtype == TDT[dtype]
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("ndim", [3, 2])
def test_fluctuating_stress(ndim):
    ve, vb = jnoise.var_eta(0.8, 2e-5), jnoise.var_bulk(0.9, 2e-5)
    for step in range(3):
        want = np.asarray(jnoise.fluctuating_stress(
            8361235, step, (4, 6, 8), ve, vb, ndim=ndim, dtype=jnp.float64))
        got = tnoise.fluctuating_stress(8361235, step, (4, 6, 8), ve, vb,
                                        ndim=ndim, dtype=torch.float64,
                                        device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("nvel", [19, 15, 9])
def test_ghost_noise(nvel):
    rtau = np.linspace(0.5, 1.5, nvel)
    vg = jnoise.var_ghost(jlb_model(nvel), rtau, 3e-5)
    assert np.array_equal(vg, tnoise.var_ghost(lb_model(nvel), rtau, 3e-5))
    for step in range(2):
        want = np.asarray(jnoise.ghost_noise(8361235 + 7919, step,
                                             (4, 6, 8), jlb_model(nvel), vg,
                                             dtype=jnp.float64))
        got = tnoise.ghost_noise(8361235 + 7919, step, (4, 6, 8),
                                 lb_model(nvel), vg, dtype=torch.float64,
                                 device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)


def test_ch_random_flux():
    for step in range(2):
        want = jnoise.ch_random_flux(7, step, (4, 6, 8), 2e-5, 0.15,
                                     dtype=jnp.float64)
        got = tnoise.ch_random_flux(7, step, (4, 6, 8), 2e-5, 0.15,
                                    dtype=torch.float64, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15,
                                       atol=0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_qab_noise5(dtype):
    for step in range(3):
        want = np.asarray(jnoise.qab_noise5(8361235, step, (4, 6, 8), 1e-4,
                                            0.5, dtype=NDT[dtype]))
        got = tnoise.qab_noise5(8361235, step, (4, 6, 8), 1e-4, 0.5,
                                dtype=TDT[dtype], device="cpu")
        assert got.dtype == TDT[dtype]
        rtol = 1e-15 if dtype == "float64" else 1e-7
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)
        assert got.shape == (5, 4, 6, 8)


def test_threefry_known_answer():
    """The Random123 known-answer vector of threefry2x32 with 20 rounds
    (key and counts zero)."""
    o0, o1 = tnoise.threefry2x32(0, 0, torch.zeros(3, dtype=torch.int64))
    assert o0.tolist() == [0x6B200159] * 3
    assert o1.tolist() == [0x99BA4EFE] * 3
