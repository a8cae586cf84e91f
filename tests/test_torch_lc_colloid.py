"""The port's liquid crystal with resolved colloids
(ludwig_tpu_torch/lc_colloid.py, binary_colloid.colloid_fe_force)
against ludwig_tpu's, on the CPU.

The same numpy inputs from a seed go through both packages in float64:
the particles' reaction force, the Q given to newly fluid sites, the
particles' surface free energy (rtol 1e-12 / atol 1e-14), and
make_lc_colloid_step over a rebuild step and a plain step (rebuild_freq
2), periodic and beside a wall on z, hydrodynamics on and off, at 12^3
with two particles of radius 2.3 (rtol 1e-10 / atol 1e-12).  The JAX
step runs op by op (its jitted body, unwrapped): the per-particle link
sums are the bulk of this file's time."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import binary_colloid as jbc
from ludwig_tpu import lc as jlc
from ludwig_tpu import lc_colloid as jlcc
from ludwig_tpu.colloids import ColloidParams as JCP
from ludwig_tpu.colloids import build_map as jbuild_map
from ludwig_tpu.fe.blue_phase import BluePhaseFE as JFE
from ludwig_tpu.lattice import lb_model as jlb_model
from ludwig_tpu.lb import LBConfig as JLB
from ludwig_tpu.ops.lc_anchor import AnchoringParams as JA
from ludwig_tpu.ops.walls import WallSpec as JW
from ludwig_tpu_torch import binary_colloid as tbc
from ludwig_tpu_torch import lc as tlc
from ludwig_tpu_torch import lc_colloid as tlcc
from ludwig_tpu_torch.colloids import ColloidParams as TCP
from ludwig_tpu_torch.colloids import build_map
from ludwig_tpu_torch.convert import lc_colloid_state_from_jax
from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE as TFE
from ludwig_tpu_torch.lattice import lb_model
from ludwig_tpu_torch.lb import LBConfig as TLB
from ludwig_tpu_torch.ops.lc_anchor import AnchoringParams as TA
from ludwig_tpu_torch.ops.walls import WallSpec as TW

S = (12, 12, 12)
FE = dict(a0=0.01, gamma=3.0, q0=0.19635, kappa0=0.01, kappa1=0.01, xi=0.7)
ANCH = dict(kappa0=0.01, kappa1=0.01, q0=0.19635, amplitude=0.3,
            wall="normal", wall_w1=0.01, coll="normal", coll_w1=0.02,
            method="s7")
PART = dict(a0=(2.3, 2.3), ah=(2.3, 2.3), gravity=(0.0, 0.0, -1e-4))
R0 = np.array([[3.5, 5.2, 5.8], [8.6, 6.3, 6.1]])
TOL = dict(rtol=1e-12, atol=1e-14)
STEP_TOL = dict(rtol=1e-10, atol=1e-12)


def _q5(seed=1):
    return 0.1 * np.random.RandomState(seed).standard_normal((5,) + S)


def _map(R=R0):
    """(pid, inside) of the two particles, numpy, from the JAX builder."""
    pid, inside = jbuild_map(jnp.asarray(R), JCP(**PART), S)
    return np.asarray(pid), np.asarray(inside)


@pytest.mark.parametrize("walls", [(False, False, False),
                                   (False, False, True)])
def test_colloid_fe_force(walls):
    pth = np.random.RandomState(3).standard_normal((3, 3) + S)
    pid, inside = _map(R0 + np.array([0.0, 0.0, 2.4]))   # one at the wall
    want = jbc.colloid_fe_force(jnp.asarray(pth), jnp.asarray(pid),
                                jnp.asarray(inside), jlb_model(19), 2,
                                walls=walls)
    got = tbc.colloid_fe_force(torch.as_tensor(pth), torch.as_tensor(pid),
                               torch.as_tensor(inside), lb_model(19), 2,
                               walls=walls)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_q_replace_newly_fluid():
    q = _q5(4)
    _pid, old = _map()
    _pid, new = _map(R0 + np.array([0.7, -0.4, 0.3]))
    want = jlcc.q_replace_newly_fluid(jnp.asarray(q), jnp.asarray(old),
                                      jnp.asarray(new), jlb_model(19))
    got = tlcc.q_replace_newly_fluid(torch.as_tensor(q),
                                     torch.as_tensor(old),
                                     torch.as_tensor(new), lb_model(19))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not np.array_equal(got.numpy(), q)


@pytest.mark.parametrize("kind", ["normal", "planar"])
def test_lc_colloid_surface_fe(kind):
    q = _q5(5)
    pid, inside = _map()
    anch = dict(ANCH, coll=kind, coll_w2=0.003 if kind == "planar" else 0.0)
    want = jlcc.lc_colloid_surface_fe(JFE(**FE), JA(**anch), jnp.asarray(q),
                                      jnp.asarray(pid), jnp.asarray(inside),
                                      jnp.asarray(R0), S)
    got = tlcc.lc_colloid_surface_fe(TFE(**FE), TA(**anch),
                                     torch.as_tensor(q), torch.as_tensor(pid),
                                     torch.as_tensor(inside),
                                     torch.as_tensor(R0), S)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), **TOL)
    assert float(got[1]) > 0.0


def _cfg(mods, walls, hydro):
    lbc, fec, ac, wc, lcm, extra = mods
    return lcm.LCConfig(
        lb=lbc(size=S, nvel=19, eta_shear=0.1, dtype="float64", **extra),
        fe=fec(**FE), gamma=0.5, gradient="s7_anchoring",
        anchoring=ac(**ANCH), hydrodynamics=hydro,
        wallspec=wc(walls=(False, False, True)) if walls else None)


@pytest.mark.parametrize("walls,hydro", [(False, True), (True, True),
                                         (False, False), (True, False)],
                         ids=["periodic", "walled", "periodic-hydro-off",
                              "walled-hydro-off"])
def test_lc_colloid_steps(walls, hydro):
    """A rebuild step then a plain step (rebuild_freq 2) from the same
    start: every leaf of the state, rho and u."""
    jc = _cfg((JLB, JFE, JA, JW, jlc, {}), walls, hydro)
    tc = _cfg((TLB, TFE, TA, TW, tlc, {"device": "cpu"}), walls, hydro)
    jp, tp = JCP(**PART), TCP(**PART)
    V0 = 0.01 * np.random.RandomState(1).standard_normal((2, 3))
    q0 = _q5()
    js = jlcc.initial_lc_colloid(jc, jp, q0, R0, V0)
    ts = tlcc.initial_lc_colloid(tc, tp, q0, R0, V0)
    assert len(ts) == len(js) == (12 if walls else 11)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    jstep = jlcc.make_lc_colloid_step(jc, jp, rebuild_freq=2)
    raw = inspect.getclosurevars(jstep).nonlocals["_step"].__wrapped__
    tstep = tlcc.make_lc_colloid_step(tc, tp, rebuild_freq=2)
    for t in range(2):
        js, (jrho, ju) = raw(js, t, t % 2 == 0)
        ts, (trho, tu) = tstep(ts, t)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP_TOL)
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), **STEP_TOL)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **STEP_TOL)
    # the JAX state converts to the port's, leaf for leaf
    conv = lc_colloid_state_from_jax([np.asarray(x) for x in js], "cpu")
    assert all(torch.equal(a, torch.as_tensor(np.asarray(b)))
               for a, b in zip(conv, js))
    # the map of Rmap holds the particles; with hydrodynamics they moved
    # off it in the plain step
    assert int(build_map(ts[5], tp, S)[1].sum()) > 0
    assert torch.equal(ts[1], ts[5]) != hydro
