"""The port's fused LC-droplet step and its K1 twin against ludwig_tpu.

The JAX side runs as its own tests run it (tests/test_fused.py:198-242):
the Pallas kernels in interpret mode.  Inputs are numpy arrays made from
a seed at 8x8x16; the JAX package's padded states are unpadded before
comparing.  Tolerances: f64 rtol 1e-10 / atol 1e-12 (test_fused.py:240).
The twin follows the Pallas kernel's term order and XLA:CPU runs without
FMA (conftest.py), so in f64 phi' and the force come out bitwise and q'
within an ulp (the test prints which); f32 rtol 1e-5 / atol 1e-7
(single-precision rounding of ~2 000 operations a site on O(1e-1)
values).  Each interpret call of the Pallas kernel takes seconds on the
CPU, so this file makes few of them."""

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
from ludwig_tpu.ops import fused as jfused
from ludwig_tpu.ops import fused_droplet as jfd
from ludwig_tpu.ops.fused_binary import pad_phi, unpad_phi
from ludwig_tpu.ops.fused_lc import pad_q, unpad_q
from ludwig_tpu_torch import lc_droplet
from ludwig_tpu_torch.convert import (droplet_params_from_jax,
                                      droplet_state_from_jax)
from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE
from ludwig_tpu_torch.fe.lc_droplet import LCDropletFE
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.ops import fused_droplet as fd

N = (8, 8, 16)
# tests/test_fused.py:214-222: delta 0.25 and W 0.02, so that mixing up
# the two molecular fields (gamma(phi), gamma(phi')) or dropping the
# anchoring shows
SYMM = dict(a=-0.0625, b=0.0625, kappa=0.053)
LC = dict(a0=0.1, gamma=2.586, q0=0.0, kappa0=0.01, kappa1=0.01, xi=0.7)
DROP = dict(gamma0=2.586, delta=0.25, w=0.02)
MOBILITY, GAMMA = 0.05, 0.5
TOL = {"float64": dict(rtol=1e-10, atol=1e-12),
       "float32": dict(rtol=1e-5, atol=1e-7)}


def _phi_q_u(seed=11):
    """tests/test_fused.py:226-233's fields, and a velocity of both
    signs so that both upwind branches occur."""
    rng = np.random.default_rng(seed)
    phi = 0.05 * (rng.random(N) - 0.5)
    n = rng.normal(size=(3,) + N)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    amp = 0.2
    q = np.stack([amp * (n[0] * n[0] - 1 / 3), amp * n[0] * n[1],
                  amp * n[0] * n[2], amp * (n[1] * n[1] - 1 / 3),
                  amp * n[1] * n[2]])
    return phi, q, 0.01 * rng.standard_normal((3,) + N)


def _jfe():
    return JFE(symm=JSymm(**SYMM), lc=JBP(**LC), **DROP)


def _tfe():
    return LCDropletFE(symm=SymmetricFE(**SYMM), lc=BluePhaseFE(**LC),
                       **DROP)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("order", [1, 2])
def test_droplet_twin_matches_pallas_interpret(dtype, order):
    phi, q, u = (x.astype(dtype) for x in _phi_q_u())
    jp, jq, jforce = jfd.droplet_phi_q_force_step(
        pad_phi(jnp.asarray(phi)), pad_q(jnp.asarray(q)),
        pad_q(jnp.asarray(u)), _jfe(), GAMMA, MOBILITY, order,
        jfd.DropletPlan(4, 8), interpret=True)
    got = fd.droplet_phi_q_force_step(
        torch.as_tensor(phi), torch.as_tensor(q), torch.as_tensor(u), _tfe(),
        GAMMA, MOBILITY, order)
    want = (np.asarray(unpad_phi(jp)), np.asarray(unpad_q(jq)),
            np.asarray(jforce))
    for a, b in zip(got, want):
        assert a.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(a.numpy(), b, **TOL[dtype])
    print("bitwise (phi', q', force):",
          [np.array_equal(a.numpy(), b) for a, b in zip(got, want)])


def _cfgs(order=1):
    jcfg = jsim.LCDropletConfig(
        lb=JLBConfig(size=N, nvel=19, eta_shear=0.5, dtype="float64"),
        fe=_jfe(), mobility=MOBILITY, gamma=GAMMA, advection_order=order)
    return jcfg, droplet_params_from_jax(dataclasses.asdict(jcfg),
                                         device="cpu")


def test_fused_droplet_step_matches_jax_fused_step():
    """Three steps of the port's fused step (K1 + mean + K2 twins) against
    the JAX package's two Pallas kernels in interpret mode, with
    test_fused.py:214-242's configuration and initial fields."""
    jcfg, tcfg = _cfgs()
    phi, q, _u = _phi_q_u()
    jf = jfd.initial_fused_droplet(jcfg, phi, q)
    ts = fd.initial_fused_droplet(tcfg, phi, q)
    jstep = jfd.make_fused_droplet_step(jcfg, plan=jfd.DropletPlan(4, 8),
                                        lb_plan=jfused.FusedPlan(4, 8),
                                        interpret=True)
    tstep = fd.make_fused_droplet_step(tcfg)
    for t in range(3):
        jf = jstep(jf, t)
        ts = tstep(ts, t)
    want = droplet_state_from_jax(*jf, "cpu", "float64")
    for a, b in zip(ts, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL["float64"])


@pytest.mark.parametrize("order", [1, 2])
def test_fused_and_unfused_port_steps_agree(order):
    _, tcfg = _cfgs(order)
    phi, q, _u = _phi_q_u(5)
    a = fd.initial_fused_droplet(tcfg, phi, q)
    b = lc_droplet.initial_droplet(tcfg, phi, q)
    step_a = fd.make_fused_droplet_step(tcfg)
    step_b = lc_droplet.make_droplet_step(tcfg)
    for t in range(3):
        a = step_a(a, t)
        b, _ = step_b(b, t)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL["float64"])
    # the flux form conserves phi; the mean subtraction, momentum
    assert float(a[1].sum()) == pytest.approx(float(phi.sum()), abs=1e-13)


def test_convert_round_trip():
    """The JAX fused droplet state (padded) and LCDropletConfig cross into
    the port's unpadded state and config."""
    jcfg, tcfg = _cfgs(2)
    assert tcfg.fe == _tfe() and tcfg.lb.device == "cpu"
    assert (tcfg.mobility, tcfg.gamma, tcfg.advection_order) == (
        MOBILITY, GAMMA, 2)
    phi, q, u = _phi_q_u(6)
    fpad, ppad, qpad, _ = jfd.initial_fused_droplet(jcfg, phi, q)
    ts = droplet_state_from_jax(fpad, ppad, qpad, u, "cpu", "float64")
    want = fd.initial_fused_droplet(tcfg, phi, q)
    for a, b in zip(ts[:3], want[:3]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(ts[3].numpy(), u)
    assert all(x.is_contiguous() for x in ts)
    with pytest.raises(ValueError):
        droplet_state_from_jax(fpad, ppad, qpad[:, :-1], u, "cpu", "float64")
    # the unfused step's options cross; what the JAX droplet runs as
    # stress_divergence, or does not have, raises naming the field
    for field, value in (("force_method", "relaxation_antisymmetric"),
                         ("gradient", "3d_27pt_fluid"),
                         ("advection_order", 3)):
        ok = dataclasses.asdict(dataclasses.replace(jcfg, **{field: value}))
        assert getattr(droplet_params_from_jax(ok, device="cpu"),
                       field) == value
    for field, value, err in (("force_method", "phi_gradmu",
                               NotImplementedError),
                              ("gradient", "3d_7pt_solid", ValueError),
                              ("advection_order", 6, ValueError)):
        bad = dataclasses.asdict(dataclasses.replace(jcfg, **{field: value}))
        with pytest.raises(err, match=field):
            droplet_params_from_jax(bad, device="cpu")
    bad = dataclasses.asdict(jcfg)
    bad["fe"]["lc"]["e0"] = (0.0, 0.0, 0.01)
    with pytest.raises(NotImplementedError, match="e0"):
        droplet_params_from_jax(bad, device="cpu")


def test_fused_droplet_rejects_what_it_cannot_run():
    phi, q, u = (torch.as_tensor(x) for x in _phi_q_u())
    fe = _tfe()
    with pytest.raises(ValueError, match="order"):
        fd.droplet_phi_q_force_step(phi, q, u, fe, GAMMA, MOBILITY, 3)
    with pytest.raises(ValueError):
        fd.droplet_phi_q_force_step(phi[None], q, u, fe, GAMMA, MOBILITY, 1)
    with pytest.raises(ValueError):
        fd.droplet_phi_q_force_step(phi, q[:4], u, fe, GAMMA, MOBILITY, 1)
    with pytest.raises(TypeError):
        fd.droplet_phi_q_force_step(phi, q, u.float(), fe, GAMMA, MOBILITY,
                                    1)
    with pytest.raises(ValueError):
        fd.droplet_phi_q_force_step(phi.transpose(0, 1), q, u, fe, GAMMA,
                                    MOBILITY, 1)
    with pytest.raises(ValueError):
        fd.droplet_phi_q_force_step(phi.to("meta"), q.to("meta"),
                                    u.to("meta"), fe, GAMMA, MOBILITY, 1)
