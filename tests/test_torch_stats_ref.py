"""The port's reference-ordered statistics against ludwig_tpu.stats.

The site-order scans (seq_sum, field_stats_ref in its three modes,
rho_stats_ref, momentum_total_ref) must be bitwise the JAX package's
lax.scan results in float64 and float32, with and without a fluid mask
(a masked site adds an exact 0 or, in the Kahan scans, is skipped); the
port's CPU twin loops over scalars of the field's dtype.
_compensated_stats sums with torch reductions in another order than
XLA's, so it is held to a few ulps of its values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import stats as jstats
from ludwig_tpu.lattice import lb_model as jlb_model
from ludwig_tpu_torch import stats as tstats
from ludwig_tpu_torch.lattice import lb_model

SHAPE = (8, 8, 16)
DTYPES = {"float64": (np.float64, torch.float64),
          "float32": (np.float32, torch.float32)}


def _field(dtype, seed=0, offset=0.3):
    """Values of both signs around `offset`, with an exact zero, so the
    compensations and the Klein branches are all exercised."""
    rng = np.random.default_rng(seed)
    x = offset + rng.standard_normal(SHAPE) * np.exp(
        rng.uniform(-12, 2, SHAPE))
    x[0, 0, 0] = 0.0
    return x.astype(DTYPES[dtype][0])


def _mask(seed=1):
    return np.random.default_rng(seed).random(SHAPE) > 0.3


def _pair(x, mask):
    tm = None if mask is None else torch.as_tensor(mask)
    jm = None if mask is None else jnp.asarray(mask)
    return jnp.asarray(x), torch.as_tensor(x), jm, tm


def _bitwise(t_vals, j_vals):
    for a, b in zip(t_vals, j_vals):
        a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
        b = np.asarray(b)
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes(), (a, b)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("klein", ["klein", "kahan", False])
def test_field_stats_ref_bitwise(dtype, masked, klein):
    x = _field(dtype)
    jx, tx, jm, tm = _pair(x, _mask() if masked else None)
    _bitwise(tstats.field_stats_ref(tx, tm, klein=klein),
             jstats.field_stats_ref(jx, jm, klein=klein))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
def test_seq_sum_bitwise(dtype, masked):
    x = _field(dtype, seed=2, offset=0.0)
    jx, tx, jm, tm = _pair(x, _mask() if masked else None)
    _bitwise([tstats.seq_sum(tx, tm)], [jstats.seq_sum(jx, jm)])


def _state(nvel, dtype, seed):
    """Distributions near rest whose momentum totals nearly cancel: the
    near-zero totals carry the summation order's roundoff."""
    rng = np.random.default_rng(seed)
    w = lb_model(nvel).wv.reshape(-1, 1, 1, 1)
    return (w * (1.0 + 1e-3 * rng.standard_normal((nvel,) + SHAPE))).astype(
        DTYPES[dtype][0])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nvel", [19, 27])
def test_rho_and_momentum_ref_bitwise(dtype, masked, nvel):
    f = _state(nvel, dtype, seed=nvel)
    jf, tf, jm, tm = _pair(f, _mask(seed=3) if masked else None)
    jmodel, model = jlb_model(nvel), lb_model(nvel)
    _bitwise(tstats.rho_stats_ref(tf, model, tm),
             jstats.rho_stats_ref(jf, jmodel, jm))
    _bitwise([tstats.momentum_total_ref(tf, model, tm)],
             [jstats.momentum_total_ref(jf, jmodel, jm)])


def test_masked_kahan_skips_instead_of_adding_zero():
    """A Kahan add of 0 moves the sum once the compensation is non-zero;
    the masked scans must skip, and do, like the JAX package's."""
    x = np.array([-3.21547450143e-09, -2.9671837099839e-07, -7.6e-18,
                  1.83712323088948e-06, -4.404682e-13], np.float64)
    keep = np.array([True, True, True, True, False])
    skipped = tstats.field_stats_ref(torch.as_tensor(x),
                                     torch.as_tensor(keep), klein="kahan")
    zeroed = tstats.field_stats_ref(torch.as_tensor(np.where(keep, x, 0.0)),
                                    None, klein="kahan")
    assert float(skipped[0]) != float(zeroed[0])
    _bitwise(skipped[:1], jstats.field_stats_ref(
        jnp.asarray(x), jnp.asarray(keep), klein="kahan")[:1])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
def test_compensated_stats_match_jax(dtype, masked):
    x = _field(dtype, seed=4, offset=1.0)
    jx, tx, jm, tm = _pair(x, _mask() if masked else None)
    got = tstats._compensated_stats(tx, tm)
    want = jstats._compensated_stats(jx, jm)
    eps = np.finfo(DTYPES[dtype][0]).eps
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=4 * eps)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-3 if dtype == "float32" else 1e-9)
    _bitwise(got[3:], want[3:])
