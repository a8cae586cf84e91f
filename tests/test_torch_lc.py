"""The port's liquid-crystal modules against ludwig_tpu's, on the CPU.

The same numpy arrays, made from a seed at 8x8x16, go through the JAX
function and its counterpart in ludwig_tpu_torch.  Tolerances: f64 rtol
1e-12 / atol 1e-14 for the free energy's methods and the Beris-Edwards
update (same term order; what is left is XLA's own rounding of a
division by a constant), rtol 1e-10 / atol 1e-12 after two whole steps
(tests/test_fused.py:122); the initial conditions are numpy on both sides
and must be equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import lc as jlc
from ludwig_tpu.dynamics import beris_edwards as jbe
from ludwig_tpu.fe import lc_init as jinit
from ludwig_tpu.fe.blue_phase import BluePhaseFE as JFE
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu_torch import lc
from ludwig_tpu_torch.dynamics import beris_edwards as be
from ludwig_tpu_torch.fe import lc_init
from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE
from ludwig_tpu_torch.lb import LBConfig
from ludwig_tpu_torch.ops.lc_anchor import AnchoringParams

N = (8, 8, 16)
FE = dict(a0=0.01, gamma=3.0, q0=0.19635, kappa0=0.000648456,
          kappa1=0.0007, xi=0.7, redshift=0.95, zeta0=0.002, zeta1=0.01)
TOL = dict(rtol=1e-12, atol=1e-14)
STEP_TOL = dict(rtol=1e-10, atol=1e-12)


def _q5(seed=1):
    rng = np.random.default_rng(seed)
    return (jinit.lc_init_o8m(N, FE["q0"], -0.2)
            + 0.02 * rng.standard_normal((5,) + N))


def _stack(x):
    """A tensor, or a (nested) list of tensors, as one numpy array."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.stack([_stack(v) for v in x])


@pytest.mark.parametrize("method", ["fed", "fed_bulk_grad",
                                    "molecular_field", "stress",
                                    "active_stress"])
def test_blue_phase_fe_matches_jax(method):
    q = _q5()
    jfields = jlc.lc_fields(jnp.asarray(q), "3d_7pt_fluid")
    tfields = lc.lc_fields(torch.as_tensor(q))
    for key in ("q", "grad_q", "delsq_q"):
        np.testing.assert_allclose(tfields[key].numpy(),
                                   np.asarray(jfields[key]), **TOL)
    want = getattr(JFE(**FE), method)(jfields)
    got = getattr(BluePhaseFE(**FE), method)(tfields)
    if method == "molecular_field":
        want = jnp.stack([jnp.stack(row) for row in want])
    np.testing.assert_allclose(_stack(got), np.asarray(want), **TOL)


def test_blue_phase_scalars_match_jax():
    jfe, tfe = JFE(**FE), BluePhaseFE(**FE)
    assert tfe.amplitude0 == jfe.amplitude0 and tfe._rr == jfe._rr
    passive = dataclasses.replace(tfe, zeta0=0.0, zeta1=0.0)
    assert passive.active_stress(None) is None


@pytest.mark.parametrize("mode,args", [
    ("lc_init_o8m", (N, 0.19635, -0.2)),
    ("lc_init_o8m", (N, 0.19635, 0.3, (10.0, 20.0, 30.0))),
    ("lc_init_o2", (N, 0.19635, 0.3)),
    ("lc_init_twist", (N, 0.19635, 0.3, 0)),
    ("lc_init_twist", (N, 0.19635, 0.3, 1)),
    ("lc_init_twist", (N, 0.19635, 0.3, 2)),
    ("lc_init_nematic", (N, 0.3, (1.0, 1.0, 0.0))),
    ("lc_init_random", (N, 0.3)),
    ("lc_init_random_xy", (N, 0.3)),
    ("lc_init_active_nematic_q2d", (N, 0.3, 0)),
    ("lc_init_active_nematic_q2d", (N, 0.3, 1))])
def test_lc_init_equals_jax(mode, args):
    got, want = getattr(lc_init, mode)(*args), getattr(jinit, mode)(*args)
    assert got.shape == (5,) + N
    np.testing.assert_array_equal(got, want)


def test_beris_edwards_update_matches_jax():
    q = _q5(2)
    u = 0.01 * np.random.default_rng(3).standard_normal((3,) + N)
    jh = JFE(**FE).molecular_field(jlc.lc_fields(jnp.asarray(q),
                                                 "3d_7pt_fluid"))
    th = BluePhaseFE(**FE).molecular_field(lc.lc_fields(torch.as_tensor(q)))
    for order in (1, 2):
        want = jbe.beris_edwards_update(
            jnp.asarray(q), jh, jnp.asarray(u),
            jbe.BerisEdwardsParams(0.5, FE["xi"], order))
        got = be.beris_edwards_update(
            torch.as_tensor(q), th, torch.as_tensor(u),
            be.BerisEdwardsParams(0.5, FE["xi"], order))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jw = jbe.velocity_gradient_tensor(jnp.asarray(u))
    tw = be.velocity_gradient_tensor(torch.as_tensor(u))
    np.testing.assert_allclose(_stack(tw), np.asarray(jnp.stack(
        [jnp.stack(row) for row in jw])), **TOL)


@pytest.mark.parametrize("order", [1, 2])
def test_lc_step_matches_jax(order):
    """Two steps of make_lc_step (and make_lc_nstep) against ludwig_tpu.lc."""
    jcfg = jlc.LCConfig(
        lb=JLBConfig(size=N, nvel=19, eta_shear=0.1, dtype="float64"),
        fe=JFE(**FE), gamma=0.5, advection_order=order)
    tcfg = lc.LCConfig(
        lb=LBConfig(size=N, nvel=19, eta_shear=0.1, dtype="float64",
                    device="cpu"),
        fe=BluePhaseFE(**FE), gamma=0.5, advection_order=order)
    q0 = _q5(4)
    js, ts = jlc.initial_lc(jcfg, q0), lc.initial_lc(tcfg, q0)
    assert lc.total_free_energy(tcfg, ts[1]) == pytest.approx(
        jlc.total_free_energy(jcfg, js[1]), rel=1e-12)
    jstep, tstep = jlc.make_lc_step(jcfg), lc.make_lc_step(tcfg)
    chained = lc.make_lc_nstep(tcfg)(ts, 2)
    for t in range(2):
        js, jrho = jstep(js, t)
        ts, trho = tstep(ts, t)
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), **STEP_TOL)
    for a, b, c in zip(ts, js, chained):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP_TOL)
        assert torch.equal(a, c)


def test_lc_config_refuses_what_is_not_ported():
    """The options of the JAX package's LCConfig are ported and carried:
    advection orders 3-5, the solid stencils with their anchoring, the
    redshift update and the Q noise (noise_kt, noise_seed); nothing is
    refused any more."""
    lb = LBConfig(size=N, nvel=19, eta_shear=0.1, device="cpu")
    for order in (3, 4, 5):
        cfg = lc.LCConfig(lb=lb, fe=BluePhaseFE(**FE), advection_order=order)
        assert cfg.advection_order == order
    anch = AnchoringParams(kappa0=FE["kappa0"], kappa1=FE["kappa1"],
                           q0=FE["q0"], amplitude=0.3, wall="normal",
                           wall_w1=0.01, method="s7")
    q = torch.as_tensor(_q5(9))
    fields = lc.lc_fields(q, "s7_anchoring", anchoring=anch)
    # no solid anywhere: the plain 7-point stencil
    plain = lc.lc_fields(q)
    np.testing.assert_allclose(fields["grad_q"].numpy(),
                               plain["grad_q"].numpy(), rtol=1e-12,
                               atol=1e-14)
    cfg = lc.LCConfig(lb=lb, fe=BluePhaseFE(**FE), redshift_update=True,
                      gradient="s7_anchoring", anchoring=anch,
                      hydrodynamics=False)
    assert cfg.redshift_update and not cfg.hydrodynamics
    assert cfg.anchoring == anch
    cfg = lc.LCConfig(lb=lb, fe=BluePhaseFE(**FE), noise_kt=1e-4,
                      noise_seed=7)
    assert (cfg.noise_kt, cfg.noise_seed) == (1e-4, 7)
