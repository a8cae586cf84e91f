"""The port's LC-droplet modules against ludwig_tpu's, on the CPU.

The same numpy arrays, made from a seed at 8x8x16, go through the JAX
function and its counterpart in ludwig_tpu_torch.  Tolerances: f64 rtol
1e-12 / atol 1e-14 for the stencil and the free energy's methods (the
same arithmetic in the same order; what is left is the order of the
mean's sum in body_force), rtol 1e-10 / atol 1e-12 after three whole
steps (tests/test_fused.py:240)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import lc_droplet_sim as jsim
from ludwig_tpu.fe.blue_phase import BluePhaseFE as JBP
from ludwig_tpu.fe.lc_droplet import LCDropletFE as JFE
from ludwig_tpu.fe.symmetric import SymmetricFE as JSymm
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.ops import stencil as jstencil
from ludwig_tpu_torch import lc_droplet
from ludwig_tpu_torch.convert import droplet_params_from_jax
from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE
from ludwig_tpu_torch.fe.lc_droplet import LCDropletFE
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.lb import LBConfig
from ludwig_tpu_torch.ops import stencil

N = (8, 8, 16)
TOL = dict(rtol=1e-12, atol=1e-14)
STEP_TOL = dict(rtol=1e-10, atol=1e-12)
# tests/test_fused.py:214-220, with the chirality and zetas switched on
SYMM = dict(a=-0.0625, b=0.0625, kappa=0.053)
LC = dict(a0=0.1, gamma=2.586, q0=0.19635, kappa0=0.01, kappa1=0.012,
          xi=0.7, redshift=0.93)
DROP = dict(gamma0=2.586, delta=0.25, w=0.02)


def _fes(**extra):
    jfe = JFE(symm=JSymm(**SYMM), lc=JBP(**LC), **DROP, **extra)
    tfe = LCDropletFE(symm=SymmetricFE(**SYMM), lc=BluePhaseFE(**LC),
                      **DROP, **extra)
    return jfe, tfe


def _phi_q(seed=1):
    """A phi of both phases with noise, and a random-director Q."""
    rng = np.random.default_rng(seed)
    phi = 0.05 * (rng.random(N) - 0.5)
    n = rng.normal(size=(3,) + N)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    amp = 0.2
    q = np.stack([amp * (n[0] * n[0] - 1 / 3), amp * n[0] * n[1],
                  amp * n[0] * n[2], amp * (n[1] * n[1] - 1 / 3),
                  amp * n[1] * n[2]])
    return phi, q


def _stack(x):
    """A tensor, or a (nested) list of tensors, as one numpy array."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.stack([_stack(v) for v in x])


def test_dab_7pt_matches_jax():
    phi = np.random.default_rng(2).standard_normal(N)
    want = np.asarray(jstencil.dab_7pt(jnp.asarray(phi)))
    got = stencil.dab_7pt(torch.as_tensor(phi))
    np.testing.assert_allclose(_stack(got), want, **TOL)
    assert got[0][1] is got[1][0]


@pytest.mark.parametrize("method,extra", [
    ("fed", {}), ("mu", {}), ("molecular_field", {}), ("stress_qh", {}),
    ("stress_qh", dict(zeta0=0.002, zeta1=0.01)), ("body_force", {})])
def test_lc_droplet_fe_matches_jax(method, extra):
    phi, q = _phi_q()
    jfields = jsim.droplet_fields(jnp.asarray(phi), jnp.asarray(q),
                                  "3d_7pt_fluid")
    tfields = lc_droplet.droplet_fields(torch.as_tensor(phi),
                                        torch.as_tensor(q))
    jfe, tfe = _fes(**extra)
    if method == "body_force":
        jmu, tmu = jfe.mu(jfields), tfe.mu(tfields)
        want = jfe.body_force(jfields, jmu, jfe.molecular_field(jfields))
        got = tfe.body_force(tfields, tmu, tfe.molecular_field(tfields))
    else:
        want = getattr(jfe, method)(jfields)
        got = getattr(tfe, method)(tfields)
    if method == "molecular_field":
        want = jnp.stack([jnp.stack(row) for row in want])
    np.testing.assert_allclose(_stack(got), np.asarray(want), **TOL)
    assert float(tfe.gamma(0.5)) == jfe.gamma(0.5)


def _cfgs(order):
    jfe, _tfe = _fes()
    jcfg = jsim.LCDropletConfig(
        lb=JLBConfig(size=N, nvel=19, eta_shear=0.5, dtype="float64"),
        fe=jfe, mobility=0.05, gamma=0.5, advection_order=order)
    return jcfg, droplet_params_from_jax(dataclasses.asdict(jcfg),
                                         device="cpu")


@pytest.mark.parametrize("order", [1, 2])
def test_droplet_step_matches_jax(order):
    """Three steps of make_droplet_step (and make_droplet_nstep) against
    ludwig_tpu.lc_droplet_sim."""
    jcfg, tcfg = _cfgs(order)
    phi, q = _phi_q(3)
    js = jsim.initial_droplet(jcfg, phi, q)
    ts = lc_droplet.initial_droplet(tcfg, phi, q)
    jstep, tstep = jsim.make_droplet_step(jcfg), lc_droplet.make_droplet_step(
        tcfg)
    chained = lc_droplet.make_droplet_nstep(tcfg)(ts, 3)
    for t in range(3):
        js, jrho = jstep(js, t)
        ts, trho = tstep(ts, t)
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), **STEP_TOL)
    for a, b, c in zip(ts, js, chained):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP_TOL)
        assert torch.equal(a, c)


def test_droplet_config_refuses_what_is_not_ported():
    """An order or a stencil the JAX package does not have raises
    ValueError, a force method its droplet step runs as stress_divergence
    NotImplementedError, naming the field; the fused step refuses what its
    kernels do not take."""
    from ludwig_tpu_torch.ops.fused_droplet import make_fused_droplet_step
    _jcfg, tcfg = _cfgs(1)
    for field, value, err in (("advection_order", 6, ValueError),
                              ("gradient", "3d_7pt_solid", ValueError),
                              ("force_method", "phi_gradmu",
                               NotImplementedError)):
        with pytest.raises(err, match=field):
            dataclasses.replace(tcfg, **{field: value})
    with pytest.raises(ValueError, match="3d_7pt_solid"):
        lc_droplet.droplet_fields(torch.zeros(N), torch.zeros((5,) + N),
                                  "3d_7pt_solid")
    for field, value in (("advection_order", 3),
                         ("gradient", "3d_27pt_fluid"),
                         ("force_method", "relaxation_antisymmetric")):
        with pytest.raises(ValueError, match="fused droplet"):
            make_fused_droplet_step(dataclasses.replace(tcfg,
                                                        **{field: value}))
