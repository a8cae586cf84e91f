"""The port's colloid interactions (ludwig_tpu_torch/interactions.py),
dipolar Ewald sums (ewald.py) and subgrid particles (subgrid.py) against
ludwig_tpu's, on the CPU, in float64.

Positions, velocities and dipoles from a numpy seed (6 particles in a
16^3 box, close enough that every cut-off is crossed): each force at
rtol 1e-12 / atol 1e-15 (the JAX package's sums over j and its exp, log
and pow round differently from torch's in the last place); the subgrid
step (the Peskin spreading and interpolation), 3 steps of 8 particles
with gravity and a FENE bond, at rtol 1e-12 / atol 1e-15."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import colloids as jc
from ludwig_tpu import ewald as jew
from ludwig_tpu import interactions as ji
from ludwig_tpu import subgrid as jsg
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.lb import initial_rest as jrest
from ludwig_tpu_torch import colloids as tc
from ludwig_tpu_torch import ewald as tew
from ludwig_tpu_torch import interactions as ti
from ludwig_tpu_torch import subgrid as tsg
from ludwig_tpu_torch.lb import LBConfig

BOX = (16, 16, 16)
TOL = dict(rtol=1e-12, atol=1e-15)


def inputs(n=6, seed=2):
    rng = np.random.RandomState(seed)
    # a loose cluster: pairs from contact to a few radii apart
    R = 8.0 + rng.uniform(-3.5, 3.5, (n, 3))
    R[1] = R[0] + np.array([4.7, 0.1, -0.05])      # near contact (a 2.3)
    V = 0.01 * rng.standard_normal((n, 3))
    S = rng.standard_normal((n, 3))
    S /= np.linalg.norm(S, axis=1, keepdims=True)
    ah = tuple(rng.uniform(2.0, 2.4, n))
    return R, V, S, ah


def hold(a, b):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


PAIR = {
    "soft_sphere": (lambda m, R, V, ah: m.soft_sphere_forces(
        R, ah, BOX, 0.0004, 0.1, 1.0, 1.5)[0]),
    "soft_sphere_energy": (lambda m, R, V, ah: m.soft_sphere_forces(
        R, ah, BOX, 0.0004, 0.1, 1.0, 1.5)[1]),
    "yukawa": lambda m, R, V, ah: m.yukawa_forces(R, BOX, 0.1, 0.5, 6.0),
    "lennard_jones": lambda m, R, V, ah: m.lj_cut_forces(R, BOX, 0.01, 4.0,
                                                         6.0),
    "lubrication_normal": (lambda m, R, V, ah: m.lubrication_normal(
        R, V, ah, BOX, 0.1, 0.8)),
    "lubrication_tangential": (lambda m, R, V, ah: m.lubrication_tangential(
        R, V, ah, BOX, 0.1, 0.8)),
}


@pytest.mark.parametrize("name", list(PAIR))
def test_pair_interactions(name):
    R, V, _S, ah = inputs()
    fn = PAIR[name]
    a = fn(ji, jnp.asarray(R), jnp.asarray(V), jnp.asarray(np.array(ah)))
    b = fn(ti, torch.as_tensor(R), torch.as_tensor(V), ah)
    hold(a, b)
    assert np.any(np.asarray(a) != 0.0)


def test_soft_sphere_by_type_pair():
    R, _V, _S, ah = inputs()
    it = np.array([0, 1, 0, 1, 1, 0])
    mats = [np.array(m)[np.ix_(it, it)] for m in (
        [[0.0004, 0.0002], [0.0002, 0.0]], [[0.1, 0.2], [0.2, 1.0]],
        [[1.0, 2.0], [2.0, 1.0]], [[1.5, 1.0], [1.0, 1.0]])]
    a = ji.soft_sphere_ij_forces(jnp.asarray(R), jnp.asarray(np.array(ah)),
                                 BOX, *mats)
    b = ti.soft_sphere_ij_forces(torch.as_tensor(R), ah, BOX, *mats)
    for x, y in zip(a, b):
        hold(x, y)


def test_bonds_and_angles():
    R, _V, _S, _ah = inputs()
    bonds = np.array([[0, 1], [1, 2], [3, 5]])
    angles = np.array([[0, 1, 2], [2, 3, 5]])
    hold(ji.fene_bond_forces(jnp.asarray(R), BOX, bonds, 0.01, 9.0),
         ti.fene_bond_forces(torch.as_tensor(R), BOX, bonds, 0.01, 9.0))
    hold(ji.angle_cosine_forces(jnp.asarray(R), BOX, angles, 0.02),
         ti.angle_cosine_forces(torch.as_tensor(R), BOX, angles, 0.02))


def test_ewald_sums():
    R, _V, S, _ah = inputs()
    for jfn, tfn in ((jew.real_space, tew.real_space),
                     (jew.fourier_space, tew.fourier_space)):
        a = jfn(jnp.asarray(R), jnp.asarray(S), 0.3, 6.0, BOX)
        b = tfn(torch.as_tensor(R), torch.as_tensor(S), 0.3, 6.0, BOX)
        for x, y in zip(a, b):
            hold(x, y)
    assert tew.ewald_params(0.3, 6.0, BOX) == jew.ewald_params(0.3, 6.0, BOX)
    assert tew.self_energy(0.3, 6.0, 6) == jew.self_energy(0.3, 6.0, 6)


def test_subgrid_steps():
    n = 8
    rng = np.random.RandomState(4)
    R = rng.uniform(0.0, 16.0, (n, 3))
    V = 1e-3 * rng.standard_normal((n, 3))
    kw = dict(a0=(0.178,) * n, ah=(0.2,) * n, gravity=(0.0, 0.0, -1e-4),
              types=("subgrid",) * n)
    al = [1.58] * n
    bonds = np.array([[0, 1], [2, 3]])
    jcfg = JLBConfig(size=BOX, nvel=19, eta_shear=0.1, dtype="float64")
    f = (np.asarray(jrest(jcfg))
         + 1e-4 * rng.standard_normal((19,) + BOX))
    jstep = jsg.make_subgrid_step(
        jcfg, jc.ColloidParams(**kw), al,
        force_fn=lambda R_, V_: ji.fene_bond_forces(R_, BOX, bonds, 0.01,
                                                    9.0))
    tstep = tsg.make_subgrid_step(
        LBConfig(size=BOX, nvel=19, eta_shear=0.1, dtype="float64",
                 device="cpu"), tc.ColloidParams(**kw), al,
        force_fn=lambda R_, V_: ti.fene_bond_forces(R_, BOX, bonds, 0.01,
                                                    9.0))
    js = tuple(jnp.asarray(x) for x in (f, R, V))
    ts = tuple(torch.as_tensor(x) for x in (f, R, V))
    for t in range(1, 4):
        js, _ = jstep(tuple(jnp.array(x) for x in js), t)
        ts, _ = tstep(ts, t)
    for x, y in zip(js, ts):
        hold(x, y)


def test_ahydro_calibration_report():
    """stats_extra.AhydroCalibration (numpy, as the JAX package's) fed the
    same measurements writes the same banner and report."""
    import io

    from ludwig_tpu import stats_extra as jse
    from ludwig_tpu_torch import stats_extra as tse
    args = (2.3, 2.3, 0.1, 1.0, 1.0, (32, 32, 32), (1e-3, -2e-4, -1.7e-3))
    a, b = jse.AhydroCalibration(*args), tse.AhydroCalibration(*args)
    rng = np.random.RandomState(8)
    for _ in range(6):
        v_new, v_old, rel = (1e-3 * rng.standard_normal(3) for _ in range(3))
        a.accumulate(v_new, v_old, rel)
        b.accumulate(v_new, v_old, rel)
    oa, ob = io.StringIO(), io.StringIO()
    for calib, out in ((a, oa), (b, ob)):
        calib.banner(out)
        calib.report(out)
    assert ob.getvalue() == oa.getvalue() and "Hydrodynamic radius" in \
        ob.getvalue()
    assert b.wants(b.nstart * b.nfreq) and not b.wants(b.nstart - 1)
