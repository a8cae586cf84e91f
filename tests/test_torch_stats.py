"""The port's plain-reduction statistics against ludwig_tpu.stats, in f64.

The port sums in torch's reduction order, the JAX package in the
reference's site order (compensated for field_stats), so totals agree to
roundoff: rtol 1e-12 / atol 1e-14.  Min/max and the formats are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import stats as jstats
from ludwig_tpu.lattice import lb_model as jlb_model
from ludwig_tpu_torch import stats
from ludwig_tpu_torch.lattice import lb_model

SHAPE = (8, 16, 16)


def _f(nvel, seed=0):
    rng = np.random.default_rng(seed)
    return lb_model(nvel).wv.reshape(-1, 1, 1, 1) * (
        1.0 + 0.05 * rng.standard_normal((nvel,) + SHAPE))


def test_field_stats_match_jax():
    x = 1.0 + 0.01 * np.random.default_rng(1).standard_normal(SHAPE)
    got = [float(v) for v in stats.field_stats(torch.as_tensor(x))]
    want = [float(v) for v in jstats.field_stats(jnp.asarray(x))]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("nvel", [15, 19, 27])
def test_momentum_total_matches_jax(nvel):
    f = _f(nvel, seed=nvel)
    got = stats.momentum_total_plain(torch.as_tensor(f), lb_model(nvel))
    want = jstats.momentum_total_plain(jnp.asarray(f), jlb_model(nvel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-14)


def test_velocity_minmax_and_formats_match_jax():
    u = 0.01 * np.random.default_rng(2).standard_normal((3,) + SHAPE)
    u[2] = -np.abs(u[2])             # all non-positive: FLT_MIN seed shows
    got = stats.velocity_minmax(torch.as_tensor(u))
    want = jstats.velocity_minmax(jnp.asarray(u))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (stats.format_velocity_block(*got)
            == jstats.format_velocity_block(*want))
    vals = (1024.0, 1.0, -2.2e-16, 0.99, 1.01)
    assert stats.format_rho_block(*vals) == jstats.format_rho_block(*vals)
    g, gw = (0.1, -2e-12, 0.0), (1e-3, 0.0, 5.0)
    assert (stats.format_momentum_block(g, g, gw)
            == jstats.format_momentum_block(g, g, gw))


def test_binary_formats_match_jax():
    vals = (-0.3133627812, -3.06e-4, 8.44e-4, -0.0499717, 0.0497398)
    assert (stats.format_phi_line("phi", *vals)
            == jstats.format_phi_line("phi", *vals))
    assert (stats.format_fed_block(20, -1.3e-7, 2.5e-9)
            == jstats.format_fed_block(20, -1.3e-7, 2.5e-9))
