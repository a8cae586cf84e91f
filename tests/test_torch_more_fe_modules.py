"""The modules of the port's other free energies against ludwig_tpu's, on
the CPU.

Each function - the Brazovskii, surfactant, ternary, polar active and
electro-symmetric free energies (fed, mu, stress, molecular field), the
fourth-order fields of binary.fe_fields, both fourth-order Lees-Edwards
forms of ops/le_ref.py at t = 0, 3 and 7, ops/solid_stencil's ternary
wetting stencils beside walls and a porous mask, symmetric_lb's
g_moments / g_collide, the Leslie-Ericksen update and the
variable-permittivity SOR with its iteration count - runs beside its JAX
counterpart on the same numpy inputs made from a seed, at 8x8x16
(16x8x16 with two planes for the sheared forms), in float64, held at
rtol 1e-12 / atol 1e-14: the same element-wise arithmetic in the same
order on both sides (XLA:CPU without FMA, conftest.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import binary as jbinary
from ludwig_tpu import binary_lb as jbinary_lb
from ludwig_tpu import electro_symm as jelectro_symm
from ludwig_tpu import polar as jpolar
from ludwig_tpu import two_field as jtwo_field
from ludwig_tpu.dynamics import leslie_ericksen as jle_dyn
from ludwig_tpu.electro import ElectroConfig as JEK
from ludwig_tpu.electro_sim import make_psi_neighbours as jneighbours
from ludwig_tpu.fe.brazovskii import BrazovskiiFE as JBraz
from ludwig_tpu.fe.electro_symmetric import ElectroSymmetricFE as JES
from ludwig_tpu.fe.polar_active import PolarActiveFE as JPolar
from ludwig_tpu.fe.surfactant import SurfactantFE as JSurf
from ludwig_tpu.fe.symmetric import SymmetricFE as JSymm
from ludwig_tpu.fe.ternary import TernaryFE as JTern
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.ops import le_ref as jlr
from ludwig_tpu.ops import lees_edwards as jle
from ludwig_tpu.ops import solid_stencil as jsolid
from ludwig_tpu_torch import binary, binary_lb, electro_symm, polar, two_field
from ludwig_tpu_torch.convert import binary_lb_params_from_jax
from ludwig_tpu_torch.dynamics import leslie_ericksen as le_dyn
from ludwig_tpu_torch.electro import ElectroConfig
from ludwig_tpu_torch.electro_sim import make_psi_neighbours
from ludwig_tpu_torch.fe.brazovskii import BrazovskiiFE
from ludwig_tpu_torch.fe.electro_symmetric import ElectroSymmetricFE
from ludwig_tpu_torch.fe.polar_active import PolarActiveFE
from ludwig_tpu_torch.fe.surfactant import SurfactantFE
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.fe.ternary import TernaryFE
from ludwig_tpu_torch.ops import le_ref as tlr
from ludwig_tpu_torch.ops import lees_edwards as tle
from ludwig_tpu_torch.ops import solid_stencil

N = (8, 8, 16)
TOL = dict(rtol=1e-12, atol=1e-14)
# the JAX package's test parameters (tests/test_more_fe.py,
# tests/test_electro_symmetric.py)
BRAZ = dict(a=-5e-4, b=5e-4, kappa=-6e-4, c=7.6e-4)
SURF = dict(a=-0.0208333, b=0.0208333, kappa=0.12, kt=0.00056587,
            epsilon=0.03, beta=0.01, w=0.002)
TERN = dict(alpha=1.0, kappa1=0.01, kappa2=0.02, kappa3=0.05, h1=0.001,
            h2=-0.002, h3=0.0035)
POLAR = dict(a=-0.1, b=0.1, kappa1=0.01, delta=0.3, lambda_=0.1, zeta=0.001)
SYMM = dict(a=-6.25e-3, b=6.25e-3, kappa=4e-3)
EK = dict(valency=(1, -1), epsilon=100.0, beta=3.0e4, rel_tol=1e-8,
          abs_tol=1e-15, max_its=2000)
ES = dict(epsilon1=300.0, epsilon2=100.0, deltamu=(0.5, -0.5))


def _rand(shape, seed, scale=0.05):
    return scale * np.random.default_rng(seed).standard_normal(shape)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, tol=TOL):
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _porous(seed=3):
    m = np.random.default_rng(seed).random(N) < 0.15
    m[0] = True
    return m


# -- free energies -----------------------------------------------------

@pytest.mark.parametrize("gradient", ["3d_7pt_fluid", "3d_27pt_fluid",
                                      "2d_5pt_fluid"])
def test_brazovskii_fe_and_fourth_order_fields_match_jax(gradient):
    phi = _rand(N, 1, 0.3)
    jf = jbinary.fe_fields(jnp.asarray(phi), gradient, fourth_order=True)
    tf = binary.fe_fields(_t(phi), gradient, fourth_order=True)
    assert set(tf) == set(jf)
    for key in jf:
        _close(tf[key], jf[key])
    jfe, tfe = JBraz(**BRAZ), BrazovskiiFE(**BRAZ)
    _close(tfe.fed(tf), jfe.fed(jf))
    _close(tfe.mu(tf), jfe.mu(jf))
    _close(tfe.stress(tf), jfe.stress(jf))
    assert tfe.amplitude == jfe.amplitude
    assert tfe.wavelength == jfe.wavelength


def test_brazovskii_fourth_order_solid_fields_match_jax():
    """The second pass through the 27-point wetting stencil (one pass for
    grad and delsq, `both`) beside a porous mask."""
    phi = _rand(N, 2, 0.3)
    solid = _porous()
    kw = dict(gradient="3d_27pt_solid", wetting=(0.01, -0.002))
    jcfg = jbinary.BinaryConfig(lb=JLBConfig(size=N, dtype="float64"),
                                fe=JBraz(**BRAZ), **kw)
    tcfg = binary.BinaryConfig(
        lb=binary.LBConfig(size=N, dtype="float64", device="cpu"),
        fe=BrazovskiiFE(**BRAZ), **kw)
    assert tcfg.fourth_order and jcfg.fourth_order
    jops = jbinary.binary_solid_ops(jcfg, solid=jnp.asarray(solid))
    tops = binary.binary_solid_ops(tcfg, solid=_t(solid))
    jf = jbinary.fe_fields(jnp.asarray(phi), kw["gradient"], True, jops)
    tf = binary.fe_fields(_t(phi), kw["gradient"], True, solid_ops=tops)
    for key in jf:
        _close(tf[key], jf[key])


@pytest.mark.parametrize("name", ["surfactant", "ternary"])
def test_two_field_fe_match_jax(name):
    phi = _rand(N, 3, 0.5)
    psi = (0.3 + 0.2 * np.random.default_rng(4).random(N)
           if name == "surfactant" else _rand(N, 4, 0.3))
    jf = jtwo_field.two_fields(jnp.asarray(phi), jnp.asarray(psi),
                               "3d_7pt_fluid")
    tf = two_field.two_fields(_t(phi), _t(psi), "3d_7pt_fluid")
    for key in jf:
        _close(tf[key], jf[key])
    if name == "surfactant":
        jfe, tfe = JSurf(**SURF), SurfactantFE(**SURF)
        assert tfe.xi0 == jfe.xi0 and tfe.sigma0 == jfe.sigma0
    else:
        jfe, tfe = JTern(**TERN), TernaryFE(**TERN)
    _close(tfe.fed(tf), jfe.fed(jf))
    _close(list(tfe.mu(tf)), list(jfe.mu(jf)))
    _close(tfe.stress(tf), jfe.stress(jf))


@pytest.mark.parametrize("gradient", ["3d_7pt_fluid", "3d_27pt_fluid"])
def test_polar_fe_match_jax(gradient):
    p = _rand((3,) + N, 5, 0.4)
    jf = jpolar.polar_fields(jnp.asarray(p), gradient)
    tf = polar.polar_fields(_t(p), gradient)
    for key in jf:
        _close(tf[key], jf[key])
    jfe, tfe = JPolar(**POLAR), PolarActiveFE(**POLAR)
    _close(tfe.fed(tf), jfe.fed(jf))
    jh, th = jfe.molecular_field(jf), tfe.molecular_field(tf)
    _close(th, jh)
    _close(tfe.stress(tf, h=th), jfe.stress(jf, h=jh))
    _close(tfe.stress(tf), jfe.stress(jf))


def _es():
    jek, tek = JEK(**EK), ElectroConfig(**EK)
    return (JES(symm=JSymm(**SYMM), electro=jek, **ES),
            ElectroSymmetricFE(symm=SymmetricFE(**SYMM), electro=tek, **ES))


def test_electro_symmetric_fe_match_jax():
    jfe, tfe = _es()
    assert (tfe.epsilonbar, tfe.gamma) == (jfe.epsilonbar, jfe.gamma)
    phi = _rand(N, 6, 0.5)
    psi = _rand(N, 7, 0.01)
    rho = 0.01 + _rand((2,) + N, 8, 0.001)
    e = _rand((3,) + N, 9, 1e-3)
    jf = jbinary.fe_fields(jnp.asarray(phi), "3d_7pt_fluid")
    tf = binary.fe_fields(_t(phi), "3d_7pt_fluid")
    e2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
    _close(tfe.var_epsilon(_t(phi)), jfe.var_epsilon(jnp.asarray(phi)))
    _close(tfe.mu_solv(_t(phi)), jfe.mu_solv(jnp.asarray(phi)))
    _close(tfe.mu_phi(tf, _t(rho), _t(psi)),
           jfe.mu_phi(jf, jnp.asarray(rho), jnp.asarray(psi)))
    _close(tfe.mu_phi_coupled(tf, _t(rho), _t(e2)),
           jfe.mu_phi_coupled(jf, jnp.asarray(rho), jnp.asarray(e2)))
    _close(tfe.stress_coupled(tf, _t(rho), _t(e), _t(e2)),
           jfe.stress_coupled(jf, jnp.asarray(rho), jnp.asarray(e),
                              jnp.asarray(e2)))
    _close(tfe.fed_coupled(tf, _t(rho), _t(psi)),
           jfe.fed_coupled(jf, jnp.asarray(rho), jnp.asarray(psi)))


# -- the fourth-order Lees-Edwards fields -------------------------------

NLE = (16, 8, 16)
LE = dict(nplanes=2, uy=0.04, nx=NLE[0])


@pytest.mark.parametrize("t", (0, 3, 7))
@pytest.mark.parametrize("form", ["le_fields_2d5pt_d4", "le_fields_27pt_d4"])
def test_le_fields_d4_match_jax(form, t):
    """Both fourth-order LE forms: the four fields, and the buffer columns
    of every plane (the port's plane axis against the JAX package's
    per-plane dict)."""
    phi = _rand(NLE, 10, 0.3)
    jcfg, tcfg = jle.LeesEdwardsConfig(**LE), tle.LeesEdwardsConfig(**LE)
    jout = getattr(jlr, form)(jnp.asarray(phi), jcfg, t)
    tout = getattr(tlr, form)(_t(phi), tcfg, t)
    for k in range(4):
        _close(tout[k], jout[k])
    for side in ("b1", "d0"):
        for n, (leaf, axis) in enumerate(zip(tout[4][side],
                                             (0, 1, 0, 1, 0))):
            for k, c in enumerate(jcfg.plane_cols):
                _close(leaf.select(axis, k), jout[4][c][side][n])


# -- the ternary wetting stencils ----------------------------------------

@pytest.mark.parametrize("case", ["3d_walls", "3d_porous", "2d_walls",
                                  "2d_porous", "3d_none"])
def test_ternary_solid_ops_match_jax(case):
    two_d = case.startswith("2d")
    size = (8, 8, 1) if two_d else N
    phi = _rand(size, 11, 0.4)
    walls = (False, True, False) if "walls" in case else (False,) * 3
    fluid = None
    if "porous" in case:
        fluid = ~(np.random.default_rng(12).random(size) < 0.15)
    jops = jsolid.ternary_solid_ops(
        size, -0.0021, fluid=None if fluid is None else jnp.asarray(fluid),
        walls=walls, two_d=two_d)
    tops = solid_stencil.ternary_solid_ops(
        size, -0.0021, fluid=None if fluid is None else _t(fluid),
        walls=walls, two_d=two_d)
    jg, jd = (op(jnp.asarray(phi)) for op in jops)
    tg, td = tops.both(_t(phi))
    _close(tg, jg)
    _close(td, jd)
    _close(tops.grad(_t(phi)), jg)
    _close(tops.delsq(_t(phi)), jd)


# -- symmetric_lb's order-parameter distribution ---------------------------

@pytest.mark.parametrize("nvel", [19, 27])
def test_g_moments_and_collide_match_jax(nvel):
    jcfg = jbinary_lb.BinaryLBConfig(
        lb=JLBConfig(size=N, nvel=nvel, dtype="float64"), fe=JSymm(**SYMM),
        mobility=0.15)
    tcfg = binary_lb_params_from_jax(dataclasses.asdict(jcfg), device="cpu")
    g = _rand((nvel,) + N, 13, 0.02)
    phi = _rand(N, 14, 0.5)
    u = _rand((3,) + N, 15, 0.01)
    mu = _rand(N, 16, 1e-3)
    model = jcfg.lb.model
    jphi, jj = jbinary_lb.g_moments(jnp.asarray(g), model)
    tphi, tj = binary_lb.g_moments(_t(g), tcfg.lb.model)
    _close(tphi, jphi)
    _close(tj, jj)
    _close(binary_lb.g_collide(_t(g), _t(phi), _t(u), _t(mu), tcfg),
           jbinary_lb.g_collide(jnp.asarray(g), jnp.asarray(phi),
                                jnp.asarray(u), jnp.asarray(mu), jcfg))


# -- the polar gel's dynamics -----------------------------------------------

@pytest.mark.parametrize("case", ["flow_order1", "swim_order2", "no_flow"])
def test_leslie_ericksen_update_matches_jax(case):
    p = _rand((3,) + N, 17, 0.4)
    h = [_rand(N, 18 + a, 1e-3) for a in range(3)]
    u = None if case == "no_flow" else _rand((3,) + N, 21, 0.02)
    kw = dict(gamma=0.3, lambda_=0.1,
              swim=0.05 if case.startswith("swim") else 0.0,
              advection_order=2 if case.endswith("2") else 1)
    want = jle_dyn.leslie_ericksen_update(
        jnp.asarray(p), [jnp.asarray(x) for x in h],
        None if u is None else jnp.asarray(u),
        jle_dyn.LeslieEricksenParams(**kw))
    got = le_dyn.leslie_ericksen_update(
        _t(p), [_t(x) for x in h], None if u is None else _t(u),
        le_dyn.LeslieEricksenParams(**kw))
    _close(got, want)


# -- the variable-permittivity SOR --------------------------------------------

SOR_CASES = {"relative": (dict(rel_tol=0.03), 12, 1),
             "absolute": (dict(abs_tol=100.0), 11, 0),
             "max_its": (dict(max_its=23), 22, 1)}


@pytest.mark.parametrize("case", list(SOR_CASES))
def test_var_epsilon_sor_matches_jax(case):
    """psi, the printed iteration index, the residual and the criterion
    of the heterogeneous SOR across a tanh interface, with the external
    field's jump on x.  Across the interface the reference's iteration
    stalls at a residual of ~2% of the right-hand side's norm, so the
    tolerances sit above it; each case stops at an iteration the port's
    read-back (every 5) does not fall on."""
    kw, n_want, which = SOR_CASES[case]
    ek = dict(EK, **kw)
    jek, tek = JEK(**ek), ElectroConfig(**ek)
    phi = np.tanh((np.arange(N[0]) - 4.0) / 2.0)[:, None, None] * np.ones(N)
    pert = 0.003 * np.random.default_rng(22).standard_normal(N)
    rho = np.stack([0.01 + pert - pert.mean(), np.full(N, 0.01)])
    psi0 = _rand(N, 23, 1e-3)
    jfe, tfe = _es()
    e0 = (1e-5, 0.0, 0.0)
    jup, jdn = jneighbours(N, e0, "float64")
    tup, tdn = make_psi_neighbours(N, e0, torch.float64, "cpu")
    jeps = jfe.var_epsilon(jnp.asarray(phi))
    teps = tfe.var_epsilon(_t(phi))
    want = jelectro_symm.poisson_sor_var_eps_ref(
        jnp.asarray(psi0), jnp.asarray(jek.e * (rho[0] - rho[1])), jeps, jek,
        jup, jdn, [jnp.roll(jeps, -1, a) for a in range(3)],
        [jnp.roll(jeps, 1, a) for a in range(3)], return_iters=True)
    got = electro_symm.poisson_sor_var_eps_ref(
        _t(psi0), _t(tek.e * (rho[0] - rho[1])), teps, tek, tup, tdn,
        [torch.roll(teps, -1, a) for a in range(3)],
        [torch.roll(teps, 1, a) for a in range(3)], return_iters=True)
    _close(got[0], want[0])
    assert int(got[1]) == int(want[1]) == n_want
    _close(got[2], want[2], dict(rtol=1e-10, atol=0.0))
    assert int(got[3]) == int(want[3]) == which
