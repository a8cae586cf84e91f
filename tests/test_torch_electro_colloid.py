"""The port's electrokinetics with resolved colloids
(ludwig_tpu_torch/electro_colloid.py) against ludwig_tpu's, on the CPU.

The same numpy inputs from a seed, D3Q19 in float64 at 12^3 with a
charged particle of radius 2.3 (two for the bookkeeping functions), go
through both packages: each function of the module and three chained
steps (rebuild_freq 2) under both force methods, with an external field
on x, at rtol 1e-10 / atol 1e-12.  The JAX step runs eagerly (its jitted
body, unwrapped)."""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import colloids as jc
from ludwig_tpu import electro as jel
from ludwig_tpu import electro_colloid as jec
from ludwig_tpu import electro_sim as jes
from ludwig_tpu.lb import LBConfig as JLB
from ludwig_tpu_torch import colloids as tc
from ludwig_tpu_torch import electro_colloid as tec
from ludwig_tpu_torch import electro_sim as tes
from ludwig_tpu_torch.convert import electro_params_from_jax

S = (12, 12, 12)
TOL = dict(rtol=1e-10, atol=1e-12)
EK = dict(valency=(1, -1), diffusivity=(0.01, 0.0095), beta=3.0e-4,
          epsilon=3.3e3, rel_tol=1e-6, abs_tol=1e-7, max_its=200,
          solver="sor")
TWO = dict(a0=(2.3, 2.3), ah=(2.3, 2.3))
R_TWO = np.array([[3.6, 5.2, 4.8], [8.4, 6.3, 7.1]])
R_MOVED = R_TWO + np.array([0.6, -0.5, 0.7])
Q = np.array([[4.0, 0.0], [0.0, 2.5]])


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _cfgs(e0=(0.0, 0.0, 0.0)):
    jcfg = jes.ElectroSimConfig(
        lb=JLB(size=S, nvel=19, eta_shear=0.1, dtype="float64"),
        ek=jel.ElectroConfig(**EK), e0=e0)
    return jcfg, electro_params_from_jax(dataclasses.asdict(jcfg),
                                         device="cpu")


def _maps(R):
    pid, inside = jc.build_map(jnp.asarray(R), jc.ColloidParams(**TWO), S)
    return np.asarray(pid), np.asarray(inside)


def _rho(seed=3):
    rng = np.random.RandomState(seed)
    return 1e-3 + 1e-4 * rng.uniform(size=(2,) + S)


def test_colloid_rho_set():
    pid, inside = _maps(R_TWO)
    dq = np.array([[0.3, -0.1], [-4.0, 0.2]])      # one charge clipped to 0
    want = jec.colloid_rho_set(jnp.asarray(_rho()), jnp.asarray(inside),
                               jnp.asarray(pid), jnp.asarray(Q),
                               jnp.asarray(dq), 2)
    got = tec.colloid_rho_set(T(_rho()), T(inside), T(pid), T(Q), T(dq), 2)
    close(got, want)


def test_colloid_charge_remove_replace():
    po, io_ = _maps(R_TWO)
    pn, in_ = _maps(R_MOVED)
    dq0 = np.array([[0.1, 0.0], [0.0, -0.2]])
    want = jec.colloid_charge_remove_replace(
        jnp.asarray(_rho(4)), jnp.asarray(io_), jnp.asarray(in_),
        jnp.asarray(po), jnp.asarray(pn), jnp.asarray(dq0), 2)
    got = tec.colloid_charge_remove_replace(T(_rho(4)), T(io_), T(in_),
                                            T(po), T(pn), T(dq0), 2)
    for a, b in zip(got, want):
        close(a, b)
    assert float(torch.max(torch.abs(got[1]))) > 0.0


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_charge_conservation_putback(sign):
    """A charge to put back, and (sign -1) one larger than the boundary
    sites hold, so that some links refuse and deltaq keeps the rest."""
    pid, inside = _maps(R_MOVED)
    rho = _rho(5)
    dq = sign * np.array([[2e-2, 1e-3], [5e-4, 3e-2]])
    want = jec.charge_conservation_putback(
        jnp.asarray(rho), jnp.asarray(~inside), jnp.asarray(inside),
        jnp.asarray(pid), jnp.asarray(dq), 2)
    for a0max in (None, 2.3):
        got = tec.charge_conservation_putback(T(rho), T(~inside), T(inside),
                                              T(pid), T(dq), 2, a0max=a0max)
        for a, b in zip(got, want):
            close(a, b)
    if sign < 0:
        assert np.all(np.asarray(want[1]) != 0.0)


def _psi_fields(seed=6, e0=(0.0, 0.0, 0.0)):
    rng = np.random.RandomState(seed)
    psi = 1e-3 * rng.standard_normal(S)
    jcfg, tcfg = _cfgs(e0)
    jn = jes.make_psi_neighbours(S, e0, "float64")
    tn = tes.make_psi_neighbours(S, e0, torch.float64, "cpu")
    return psi, jcfg, tcfg, jn, tn


@pytest.mark.parametrize("method", ["gradmu", "divstress"])
def test_colloid_force(method):
    psi, jcfg, tcfg, jn, tn = _psi_fields(e0=(1e-4, 0.0, 0.0))
    pid, inside = _maps(R_TWO)
    jfn = getattr(jec, f"{method}_force_colloid")
    tfn = getattr(tec, f"{method}_force_colloid")
    want = jfn(jnp.asarray(psi), jnp.asarray(_rho()), jcfg, *jn,
               jnp.asarray(~inside), jnp.asarray(inside), jnp.asarray(pid), 2)
    got = tfn(T(psi), T(_rho()), tcfg, *tn, T(~inside), T(inside), T(pid), 2)
    for a, b in zip(got, want):
        close(a, b)


def test_zeta_potential():
    psi = _psi_fields()[0]
    pid, inside = _maps(R_TWO[:1])
    want = jec.zeta_potential(jnp.asarray(psi), jnp.asarray(~inside),
                              jnp.asarray(inside))
    got = tec.zeta_potential(T(psi), T(~inside), T(inside))
    close(got, want)


@pytest.mark.parametrize("method", ["phi_gradmu_correction",
                                    "stress_divergence"])
def test_electro_colloid_steps(method):
    """Three steps from one charged particle moving in a uniform
    electrolyte with a field on x: every leaf, the collision density and
    velocity and the SOR report."""
    jcfg, tcfg = _cfgs(e0=(2e-5, 0.0, 0.0))
    one = dict(a0=(2.3,), ah=(2.3,))
    jp, tp = jc.ColloidParams(**one), tc.ColloidParams(**one)
    q = np.array([[5.0, 0.0]])
    psi0, rho0 = jes.init_uniform(S, 1e-3)
    rho0 = np.asarray(rho0)
    R0, V0 = np.array([[5.6, 5.3, 6.2]]), np.array([[0.02, -0.01, 0.015]])
    js = jec.initial_electro_colloid(jcfg, jp, psi0, rho0, R0, V0)
    ts = tec.initial_electro_colloid(tcfg, tp, psi0, rho0, R0, V0)
    js = js[:4] + (jnp.asarray(V0),) + js[5:]          # a move at once
    ts = ts[:4] + (T(V0),) + ts[5:]
    jstep = inspect.getclosurevars(jec.make_electro_colloid_step(
        jcfg, jp, q, rebuild_freq=2, force_method=method)).nonlocals[
        "_step"].__wrapped__
    tstep = tec.make_electro_colloid_step(tcfg, tp, T(q), rebuild_freq=2,
                                          force_method=method)
    for t in range(3):
        js, jaux = jstep(js, t, t % 2 == 0)
        ts, taux = tstep(ts, t)
    assert len(ts) == len(js) == 11
    for a, b in zip(ts, js):
        close(a, b)
    close(taux[0], jaux[0])
    close(taux[1], jaux[1])
    for a, b in zip(taux[2], jaux[2]):
        close(a, b)
    assert float(torch.max(torch.abs(ts[2]))) > 0.0
