"""The port's routes of the other free energies against ludwig_tpu's, on
the CPU: 3 whole steps of the Brazovskii binary fluid (periodic, and
sheared by two Lees-Edwards planes), the surfactant, the ternary fluid
with its phi-grad-mu force (periodic, and between walls with the 2-D
ternary wetting stencil), a two-field `hydrodynamics off` step, the
polar active gel (with and without hydrodynamics), symmetric_lb
(periodic, between walls, with Lees-Edwards planes, with the LB's KISS
noise) and fe_electro_symmetric with a dielectric contrast, each from
the same state made from a numpy seed, in float64.  The configurations
cross through convert.*_params_from_jax and the states through
convert.state_leaves_from_jax.

The JAX steps run eagerly (the jitted functions' __wrapped__), which
skips XLA's compiles of each variant.  Tolerances: rtol 1e-10 / atol
1e-12 for the fields after 3 steps; the KISS states bitwise."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import binary as jbinary
from ludwig_tpu import binary_le as jbinary_le
from ludwig_tpu import binary_lb as jbinary_lb
from ludwig_tpu import electro_symm as jelectro_symm
from ludwig_tpu import polar as jpolar
from ludwig_tpu import two_field as jtwo_field
from ludwig_tpu.electro import ElectroConfig as JEK
from ludwig_tpu.electro_sim import init_gouy_chapman
from ludwig_tpu.fe.brazovskii import BrazovskiiFE as JBraz
from ludwig_tpu.fe.electro_symmetric import ElectroSymmetricFE as JES
from ludwig_tpu.fe.polar_active import PolarActiveFE as JPolar
from ludwig_tpu.fe.surfactant import SurfactantFE as JSurf
from ludwig_tpu.fe.symmetric import SymmetricFE as JSymm
from ludwig_tpu.fe.ternary import TernaryFE as JTern
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.noise import NoiseConfig as JNoise
from ludwig_tpu.ops import lees_edwards as jle
from ludwig_tpu.ops.solid_stencil import ternary_solid_ops as jternary_ops
from ludwig_tpu.ops.walls import WallSpec as JWalls
from ludwig_tpu_torch import (binary, binary_le, binary_lb, electro_symm,
                              polar, two_field)
from ludwig_tpu_torch.convert import (binary_lb_params_from_jax,
                                      binary_params_from_jax,
                                      electro_symm_params_from_jax,
                                      polar_params_from_jax,
                                      state_leaves_from_jax,
                                      two_field_params_from_jax)
from ludwig_tpu_torch.ops import lees_edwards as tle
from ludwig_tpu_torch.ops.solid_stencil import ternary_solid_ops
from ludwig_tpu_torch.ops.walls import WallSpec
from test_torch_more_fe_modules import BRAZ, EK, ES, POLAR, SURF, SYMM, TERN

N = (8, 8, 16)
STEP_TOL = dict(rtol=1e-10, atol=1e-12)
KT = 2e-5


def _rand(shape, seed, scale=0.05):
    return scale * np.random.default_rng(seed).standard_normal(shape)


def _lb(size=N, nvel=19, **kw):
    return JLBConfig(size=size, nvel=nvel, eta_shear=0.1, eta_bulk=0.1,
                     dtype="float64", **kw)


def _eager(jitted):
    """The JAX step op by op: its jitted function's Python body."""
    return getattr(jitted, "__wrapped__", jitted)


def _perturb(state, nvel, size, seed, u_at):
    """f perturbed and u random, as numpy-seeded JAX arrays."""
    st = list(state)
    st[0] = st[0] + jnp.asarray(_rand((nvel,) + size, seed, 1e-4))
    st[u_at] = jnp.asarray(_rand((3,) + size, seed + 1, 0.01))
    return tuple(st)


def _run(jstep, tstep, js, nkiss=0, t0=1):
    """3 steps of both from the same state; the port's state held to the
    JAX package's (the last nkiss leaves, KISS states, bitwise)."""
    ts = state_leaves_from_jax(js, "cpu", torch.float64)
    for t in range(t0, t0 + 3):
        js, jaux = jstep(js, t)
        ts, taux = tstep(ts, t)
    assert len(ts) == len(js)
    for k, (a, b) in enumerate(zip(ts, js)):
        if k >= len(ts) - nkiss:
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(b).astype(np.int64))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP_TOL)
    return ts, taux, js, jaux


def test_brazovskii_step_matches_jax():
    jcfg = jbinary.BinaryConfig(lb=_lb(), fe=JBraz(**BRAZ), mobility=0.05,
                                advection_order=2)
    tcfg = binary_params_from_jax(dataclasses.asdict(jcfg), device="cpu")
    assert tcfg.fourth_order
    js = jbinary.initial_binary(jcfg, _rand(N, 1, 0.01))
    js = _perturb(js, 19, N, 2, 2)
    _, trho, _, jrho = _run(_eager(jbinary.make_binary_step(jcfg)),
                            binary.make_binary_step(tcfg), js)
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), **STEP_TOL)


@pytest.mark.parametrize("gradient", ["3d_7pt_fluid", "3d_27pt_fluid"])
def test_sheared_brazovskii_step_matches_jax(gradient):
    """Two planes at uy 0.04 on 16x8x16; the 7-point input takes the
    JAX package's 5-point fourth-order LE fields, the 27-point one its
    27-point form; the state carries the LE gradients."""
    size = (16, 8, 16)
    jcfg = jbinary.BinaryConfig(lb=_lb(size), fe=JBraz(**BRAZ),
                                mobility=0.05, gradient=gradient)
    tcfg = binary_params_from_jax(dataclasses.asdict(jcfg), device="cpu")
    le = dict(nplanes=2, uy=0.04, nx=size[0])
    jstep = _eager(jbinary_le.make_binary_le_step(jbinary_le.BinaryLEConfig(
        binary=jcfg, le=jle.LeesEdwardsConfig(**le)), keep_grads=True))
    tstep = binary_le.make_binary_le_step(binary_le.BinaryLEConfig(
        binary=tcfg, le=tle.LeesEdwardsConfig(**le)), keep_grads=True)
    js = jbinary.initial_binary(jcfg, _rand(size, 3, 0.05))
    js = _perturb(js, 19, size, 4, 2)
    js = js + (jnp.zeros((3,) + size), jnp.zeros(size))
    _run(jstep, tstep, js)


def _two_field_cfgs(name, size=N, nvel=19, **kw):
    fe = JSurf(**SURF) if name == "surfactant" else JTern(**TERN)
    jcfg = jtwo_field.TwoFieldConfig(lb=_lb(size, nvel), fe=fe,
                                     mobilities=(0.15, 0.1), **kw)
    return jcfg, two_field_params_from_jax(dataclasses.asdict(jcfg),
                                           device="cpu")


def _two_field_start(jcfg, size, seed, walls=False):
    phi0 = _rand(size, seed, 0.3)
    psi0 = 0.3 + 0.1 * np.random.default_rng(seed + 1).random(size)
    js = jtwo_field.initial_two_field(jcfg, phi0, psi0)
    js = _perturb(js, jcfg.lb.nvel, size, seed + 2, 3)
    if walls:
        js = js + (jnp.zeros((3,)),)
    return js


@pytest.mark.parametrize("route", ["surfactant", "ternary_phi_gradmu",
                                   "surfactant_hydrodynamics_off"])
def test_two_field_step_matches_jax(route):
    name = route.split("_")[0]
    kw = dict(advection_order=2)
    if route == "ternary_phi_gradmu":
        kw["force_method"] = "phi_gradmu"
    if route.endswith("off"):
        kw["hydrodynamics"] = False
    jcfg, tcfg = _two_field_cfgs(name, **kw)
    js = _two_field_start(jcfg, N, 5)
    _, trho, _, jrho = _run(_eager(jtwo_field.make_two_field_step(jcfg)),
                            two_field.make_two_field_step(tcfg), js)
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), **STEP_TOL)


def test_ternary_walls_2d_solid_step_matches_jax():
    """The ternary fluid between halo walls (y) with the 2-D ternary
    wetting stencil, hrka from (h1, h2, h3) as the JAX package's
    build_system forms it, 16x8x1 D2Q9; the state carries the walls'
    momentum."""
    size = (16, 8, 1)
    jcfg, tcfg = _two_field_cfgs("ternary", size, 9,
                                 gradient="2d_ternary_solid",
                                 force_method="phi_gradmu")
    fe = jcfg.fe
    a2 = fe.alpha * fe.alpha
    hrka = ((-fe.h1 / fe.kappa1 + fe.h2 / fe.kappa2) / a2,
            (-fe.h3 / fe.kappa3) / a2)
    walls = (False, True, False)
    jops = tuple(jternary_ops(size, h, walls=walls, two_d=True) for h in hrka)
    tops = tuple(ternary_solid_ops(size, h, walls=walls, two_d=True)
                 for h in hrka)
    jstep = _eager(jtwo_field.make_two_field_step(
        jcfg, wallspec=JWalls(walls=walls), solid_ops=jops))
    tstep = two_field.make_two_field_step(tcfg, wallspec=WallSpec(walls=walls),
                                          solid_ops=tops)
    _run(jstep, tstep, _two_field_start(jcfg, size, 7, walls=True))


@pytest.mark.parametrize("hydro", [True, False], ids=["flow", "hydro_off"])
def test_polar_step_matches_jax(hydro):
    jcfg = jpolar.PolarConfig(lb=_lb(), fe=JPolar(**dict(POLAR, delta=0.0)),
                              gamma=0.3, swim=0.02, advection_order=2,
                              hydrodynamics=hydro)
    tcfg = polar_params_from_jax(dataclasses.asdict(jcfg), device="cpu")
    p0 = jpolar.polar_init_aster(N)
    np.testing.assert_array_equal(polar.polar_init_aster(N), p0)
    js = _perturb(jpolar.initial_polar(jcfg, p0), 19, N, 8, 2)
    _run(_eager(jpolar.make_polar_step(jcfg)), polar.make_polar_step(tcfg),
         js)


# route -> (walls, LE planes, KISS noise)
LB2_ROUTES = {"periodic": (None, None, False),
              "walls_27pt_solid": ((False, False, True), None, False),
              "le_27pt": (None, 2, False),
              "kiss": (None, None, True)}


@pytest.mark.parametrize("route", list(LB2_ROUTES))
def test_symmetric_lb_step_matches_jax(route):
    walls, nplanes, kiss = LB2_ROUTES[route]
    size = (16, 8, 16) if nplanes else N
    gradient = {"walls_27pt_solid": "3d_27pt_solid",
                "le_27pt": "3d_27pt_fluid"}.get(route, "3d_7pt_fluid")
    lbkw = dict(noise=JNoise(kt=KT, rho=True)) if kiss else {}
    jcfg = jbinary_lb.BinaryLBConfig(lb=_lb(size, **lbkw), fe=JSymm(**SYMM),
                                     mobility=0.15, gradient=gradient)
    tcfg = binary_lb_params_from_jax(dataclasses.asdict(jcfg), device="cpu")
    js = jbinary_lb.initial_binary_lb(jcfg, _rand(size, 9, 0.3))
    js = _perturb(js, 19, size, 10, 2)
    kw_j, kw_t = {}, {}
    if walls:
        kw_j["wallspec"] = JWalls(walls=walls)
        kw_t["wallspec"] = WallSpec(walls=walls)
        js = js[:3] + (jnp.zeros((3,)),) + js[3:]
    if nplanes:
        le = dict(nplanes=nplanes, uy=0.04, nx=size[0])
        kw_j["le"] = jle.LeesEdwardsConfig(**le)
        kw_t["le"] = tle.LeesEdwardsConfig(**le)
        js = js + (jnp.zeros((3,) + size), jnp.zeros(size))
    ts, taux, _, jaux = _run(
        _eager(jbinary_lb.make_binary_lb_step(jcfg, **kw_j)),
        binary_lb.make_binary_lb_step(tcfg, **kw_t), js, nkiss=int(kiss))
    for a, b in zip(taux, jaux):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP_TOL)


@pytest.mark.parametrize("method", ["stress_divergence",
                                    "phi_gradmu_correction"])
def test_electro_symm_step_matches_jax(method):
    """The Gouy-Chapman electrolyte on 16x4x4 with a tanh interface, the
    contrast epsilon1 != epsilon2 (the heterogeneous SOR), two NP
    sub-steps with the solvation potentials."""
    size = (16, 4, 4)
    ek = dict(EK, max_its=400, multisteps=2, diffusivity=(0.01, 0.02),
              rel_tol=0.03)
    jek = JEK(**ek)
    jfe = JES(symm=JSymm(**SYMM), electro=jek, **ES)
    jcfg = jelectro_symm.ElectroSymmConfig(
        lb=_lb(size), ek=jek, fe=jfe, mobility=0.1, force_method=method)
    tcfg = electro_symm_params_from_jax(dataclasses.asdict(jcfg),
                                        device="cpu")
    psi0, rho_k, _ = init_gouy_chapman(size, 0.01, 0.03125)
    phi0 = np.tanh((np.arange(size[0]) - 8.0) / 2.0)[:, None, None] \
        * np.ones(size)
    js = (jnp.asarray(jbinary.initial_rest(jcfg.lb)), jnp.asarray(phi0),
          jnp.asarray(psi0), jnp.asarray(rho_k), jnp.zeros((3,) + size))
    js = _perturb(js, 19, size, 11, 4)
    _, (trho, tsor), _, (jrho, jsor) = _run(
        _eager(jelectro_symm.make_electro_symm_step(jcfg)),
        electro_symm.make_electro_symm_step(tcfg), js)
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), **STEP_TOL)
    assert int(tsor[0]) == int(jsor[0]) and int(tsor[2]) == int(jsor[2])
