"""The port's collide / stream / bounce-back against ludwig_tpu's, in f64.

Same inputs (numpy, from a seed) through both packages.  Both unroll the
mode transforms in the same order and XLA:CPU runs without FMA
(conftest.py), so they agree to rtol 1e-12 / atol 1e-14; streaming is a
permutation and agrees exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu.lattice import lb_model as jlb_model
from ludwig_tpu.ops import collide as jcollide
from ludwig_tpu.ops import stream as jstream
from ludwig_tpu_torch.lattice import lb_model
from ludwig_tpu_torch.ops import collide as tcollide
from ludwig_tpu_torch.ops import stream as tstream

SHAPE = (8, 16, 16)
RTOL, ATOL = 1e-12, 1e-14
FORCE_G = (1e-4, -2e-4, 5e-5)


def _rand_f(nvel, seed):
    rng = np.random.default_rng(seed)
    w = lb_model(nvel).wv.reshape(-1, 1, 1, 1)
    return w * (1.0 + 0.05 * rng.standard_normal((nvel,) + SHAPE))


def _params(mod, nvel, scheme_name):
    model = (jlb_model if mod is jcollide else lb_model)(nvel)
    return mod.CollisionParams(
        model=model, eta_shear=0.1, eta_bulk=0.14,
        scheme=mod.RelaxationScheme(scheme_name), force_global=FORCE_G)


@pytest.mark.parametrize("nvel", [15, 19, 27])
@pytest.mark.parametrize("scheme", ["m10", "bgk", "trt"])
def test_collide_matches_jax(nvel, scheme):
    f = _rand_f(nvel, seed=nvel)
    force = 1e-4 * np.random.default_rng(1).standard_normal((3,) + SHAPE)
    jp, tp = _params(jcollide, nvel, scheme), _params(tcollide, nvel, scheme)
    if scheme == "trt" and nvel == 27:
        # the reference defines no TRT ghost split for D3Q27: both raise
        with pytest.raises(ValueError):
            jp.rtau_ghost
        with pytest.raises(ValueError):
            tp.rtau_ghost
        return
    jf, jrho, ju = jcollide.collide(jnp.asarray(f), jp,
                                    force=jnp.asarray(force))
    tf, trho, tu = tcollide.collide(torch.as_tensor(f), tp,
                                    force=torch.as_tensor(force))
    for a, b in ((tf, jf), (trho, jrho), (tu, ju)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("nvel", [15, 19, 27])
def test_collide_fluid_mask_and_equilibrium(nvel):
    f = _rand_f(nvel, seed=3)
    solid = np.zeros(SHAPE, bool)
    solid[0] = solid[-1] = True
    jp, tp = _params(jcollide, nvel, "m10"), _params(tcollide, nvel, "m10")
    jf, _, ju = jcollide.collide(jnp.asarray(f), jp,
                                 fluid_mask=jnp.asarray(~solid))
    tf, _, tu = tcollide.collide(torch.as_tensor(f), tp,
                                 fluid_mask=torch.as_tensor(~solid))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL,
                               atol=ATOL)
    rng = np.random.default_rng(5)
    rho = 1.0 + 0.01 * rng.standard_normal(SHAPE)
    u = 0.01 * rng.standard_normal((3,) + SHAPE)
    je = jcollide.equilibrium(jlb_model(nvel), jnp.asarray(rho),
                              jnp.asarray(u))
    te = tcollide.equilibrium(lb_model(nvel), torch.as_tensor(rho),
                              torch.as_tensor(u))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("nvel", [15, 19, 27])
def test_stream_matches_jax(nvel):
    f = _rand_f(nvel, seed=7)
    np.testing.assert_array_equal(
        tstream.stream(torch.as_tensor(f), lb_model(nvel)).numpy(),
        np.asarray(jstream.stream(jnp.asarray(f), jlb_model(nvel))))


@pytest.mark.parametrize("nvel", [15, 19, 27])
def test_stream_bounce_back_matches_jax(nvel):
    f = _rand_f(nvel, seed=9)
    solid = jstream.wall_solid_mask(SHAPE, (True, False, False))
    np.testing.assert_array_equal(
        solid, tstream.wall_solid_mask(SHAPE, (True, False, False)))
    solid[3, 5:9, 2:6] = True            # an interior obstacle too
    wall_u = (0.0, 0.01, -0.02)
    jout = jstream.stream_bounce_back(jnp.asarray(f), jlb_model(nvel),
                                      solid=jnp.asarray(solid),
                                      wall_u=wall_u)
    tout = tstream.stream_bounce_back(torch.as_tensor(f), lb_model(nvel),
                                      solid=torch.as_tensor(solid),
                                      wall_u=wall_u)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(
        tstream.solid_neighbour_masks(lb_model(nvel),
                                      torch.as_tensor(solid)).numpy(),
        np.asarray(jstream.solid_neighbour_masks(jlb_model(nvel),
                                                 jnp.asarray(solid))))
