"""The modules of the port's binary boundaries and options against
ludwig_tpu's, on the CPU.

Each function (ops/stencil's stencils by name and its 7-point solid
stencil, ops/solid_stencil's 27-point wetting stencil with walls, a
porous mask and per-site (C, H), advection orders 3-5 and the no-flux
masks, the grad-mu, map-aware and phi-grad-mu forces, the wall helpers,
the Cahn-Hilliard update with each of its arguments, the CH noise flux,
the Arrhenius viscosity and the patches initialisation) runs beside its
JAX counterpart on the same numpy inputs made from a seed, at 8x8x16
(8x8x1 for the 2-D stencils), in float64, held at rtol 1e-12 / atol
1e-14: the same element-wise arithmetic in the same order on both sides
(XLA:CPU without FMA, conftest.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import noise as jnoise
from ludwig_tpu import ref_rng as jref_rng
from ludwig_tpu import visc as jvisc
from ludwig_tpu.dynamics import cahn_hilliard as jch
from ludwig_tpu.fe.symmetric import SymmetricFE as JFE
from ludwig_tpu.ops import advect as jadvect
from ludwig_tpu.ops import force as jforce
from ludwig_tpu.ops import solid_stencil as jsolid
from ludwig_tpu.ops import stencil as jstencil
from ludwig_tpu.ops import walls as jwalls
from ludwig_tpu_torch import noise, noise_kiss, ref_rng, visc
from ludwig_tpu_torch.dynamics import cahn_hilliard as ch
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.ops import advect, force, solid_stencil, stencil, walls

N = (8, 8, 16)
TOL = dict(rtol=1e-12, atol=1e-14)
FE = dict(a=-6.25e-3, b=6.25e-3, kappa=4e-3)
WALLS = {"0_0_1": (False, False, True), "1_1_0": (True, True, False)}


def _rand(shape, seed, scale=0.05):
    return scale * np.random.default_rng(seed).standard_normal(shape)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _porous(seed=3):
    """A porous mask: a few solid sites and a solid plane at x = 0."""
    m = np.random.default_rng(seed).random(N) < 0.15
    m[0] = True
    return m


def _wetting(seed=4):
    """Per-site (C, H) map data."""
    rng = np.random.default_rng(seed)
    return 0.01 * rng.random(N), 0.002 * rng.standard_normal(N)


@pytest.mark.parametrize("le_field", [False, True], ids=["plain", "le"])
@pytest.mark.parametrize("name", ["3d_7pt_fluid", "3d_27pt_fluid",
                                  "dm3q27", "2d_5pt_fluid",
                                  "2d_tomita_fluid"])
def test_gradient_stencils_match_jax(name, le_field):
    shape = N if name.startswith(("3d", "dm")) else (8, 8, 1)
    phi = _rand(shape, 1)
    tg, td = stencil.gradient_ops(name, le_field=le_field)
    jg, jd = jstencil.gradient_ops(name, le_field=le_field)
    _close(tg(_t(phi)), jg(jnp.asarray(phi)))
    _close(td(_t(phi)), jd(jnp.asarray(phi)))


@pytest.mark.parametrize("wet", ["neutral", "scalar", "per_site"])
def test_solid_7pt_stencil_matches_jax(wet):
    solid = _porous()
    c, h = {"neutral": (0.0, 0.0), "scalar": (0.02, -0.003),
            "per_site": _wetting()}[wet]
    phi = _rand(N, 5)
    targs = (c, h) if wet != "per_site" else (_t(c), _t(h))
    jargs = (c, h) if wet != "per_site" else (jnp.asarray(c), jnp.asarray(h))
    tops = stencil.solid_gradient_ops(_t(solid), FE["kappa"], *targs)
    jg, jd = jstencil.solid_gradient_ops(jnp.asarray(solid), FE["kappa"],
                                         *jargs)
    tg, td = tops
    _close(tg(_t(phi)), jg(jnp.asarray(phi)))
    _close(td(_t(phi)), jd(jnp.asarray(phi)))
    both = tops.both(_t(phi))
    _close(both[0], jg(jnp.asarray(phi)))
    _close(both[1], jd(jnp.asarray(phi)))


@pytest.mark.parametrize("case", ["walls_0_0_1", "walls_1_1_0", "porous",
                                  "porous_walls_per_site"])
def test_solid_27pt_stencil_matches_jax(case):
    """The wetting stencil with halo walls, a porous mask (scalar C, H)
    and a porous mask beside a wall with per-site (C, H)."""
    wl = WALLS.get(case[6:], (False,) * 3) if case.startswith("walls") \
        else ((False, False, True) if "walls" in case else (False,) * 3)
    fluid = None if case.startswith("walls") else ~_porous()
    c, h = _wetting() if "per_site" in case else (0.03, -0.002)
    rk = 1.0 / FE["kappa"]
    phi = _rand(N, 6)
    tops = solid_stencil.solid27_scalar_ops(
        N, fluid=None if fluid is None else _t(fluid), walls=wl, rkappa=rk,
        c=_t(c) if np.ndim(c) else c, h=_t(h) if np.ndim(h) else h)
    jg, jd = jsolid.solid27_scalar_ops(
        N, fluid=None if fluid is None else jnp.asarray(fluid), walls=wl,
        rkappa=rk, c=jnp.asarray(c) if np.ndim(c) else c,
        h=jnp.asarray(h) if np.ndim(h) else h)
    tg, td = tops
    _close(tg(_t(phi)), jg(jnp.asarray(phi)))
    _close(td(_t(phi)), jd(jnp.asarray(phi)))
    g, d = tops.both(_t(phi))
    _close(g, jg(jnp.asarray(phi)))
    _close(d, jd(jnp.asarray(phi)))


@pytest.mark.parametrize("order", [3, 4, 5])
def test_advection_orders_3_to_5_match_jax(order):
    u, phi = _rand((3,) + N, 7, 0.01), _rand(N, 8)
    tfl = advect.advective_fluxes(_t(u), _t(phi), order)
    jfl = jadvect.advective_fluxes(jnp.asarray(u), jnp.asarray(phi), order)
    for a, b in zip(tfl, jfl):
        _close(a, b)
    solid = _porous()
    for a, b in zip(advect.no_flux_at_solid(tfl, _t(solid)),
                    jadvect.no_flux_at_solid(jfl, jnp.asarray(solid))):
        _close(a, b)
    pre = advect.blocked_faces(_t(solid))
    for a, b in zip(advect.no_flux_at_solid(tfl, pre),
                    jadvect.no_flux_at_solid(jfl, jnp.asarray(solid))):
        _close(a, b)


def _stress(seed):
    phi = _rand(N, seed)
    jfe = JFE(**FE)
    fields = {"phi": jnp.asarray(phi),
              "grad_phi": jstencil.grad_27pt(jnp.asarray(phi)),
              "delsq_phi": jstencil.delsq_27pt(jnp.asarray(phi))}
    return np.asarray(jfe.stress(fields)), np.asarray(jfe.mu(fields)), phi


@pytest.mark.parametrize("walls_key", [None, "0_0_1", "1_1_0"])
def test_forces_match_jax(walls_key):
    pth, mu, phi = _stress(9)
    wl = WALLS.get(walls_key, (False,) * 3)
    fluid = ~_porous()
    tws = walls.WallSpec(walls=wl) if walls_key else None
    jws = jwalls.WallSpec(walls=wl) if walls_key else None
    _close(force.stress_divergence_force_map(_t(pth), _t(fluid), tws),
           jforce.stress_divergence_force_map(jnp.asarray(pth),
                                              jnp.asarray(fluid), jws))
    gm = _rand((3,) + N, 10)
    _close(force.grad_mu_force(_t(phi), _t(gm)),
           jforce.grad_mu_force(jnp.asarray(phi), jnp.asarray(gm)))
    mu2, phi2 = _rand(N, 11), _rand(N, 12)
    for solid in (None, _porous()):
        _close(force.phi_grad_mu_force(
            (_t(phi), _t(phi2)), (_t(mu), _t(mu2)), walls=wl,
            solid=None if solid is None else _t(solid)),
            jforce.phi_grad_mu_force(
                (jnp.asarray(phi), jnp.asarray(phi2)),
                (jnp.asarray(mu), jnp.asarray(mu2)), walls=wl,
                solid=None if solid is None else jnp.asarray(solid)))


@pytest.mark.parametrize("walls_key", ["0_0_1", "1_1_0"])
def test_wall_helpers_match_jax(walls_key):
    pth, _, _ = _stress(13)
    wl = WALLS[walls_key]
    tws, jws = walls.WallSpec(walls=wl), jwalls.WallSpec(walls=wl)
    tf, tw = walls.stress_divergence_force_walls(_t(pth), tws)
    jf, jw = jwalls.stress_divergence_force_walls(jnp.asarray(pth), jws)
    _close(tf, jf)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-12,
                               atol=1e-16)
    fl = [_rand((2,) + N, 14 + a) for a in range(3)]
    for a, b in zip(walls.no_flux_at_walls([_t(x) for x in fl], tws),
                    jwalls.no_flux_at_walls([jnp.asarray(x) for x in fl],
                                            jws)):
        _close(a, b)


CH_CASES = {
    "solid": dict(solid=True),
    "walls": dict(wallspec=True),
    "random_flux": dict(random_flux=True),
    "noise_stencil": dict(random_flux=True, noise_stencil=True),
    "gradmu_ex": dict(gradmu_ex=(1e-3, -2e-3, 5e-4)),
    "diffusion_only": dict(u=False, solid=True),
    "all": dict(solid=True, wallspec=True, random_flux=True,
                noise_stencil=True, gradmu_ex=(1e-3, 0.0, 0.0))}


@pytest.mark.parametrize("order", [1, 3, 5])
@pytest.mark.parametrize("case", list(CH_CASES))
def test_cahn_hilliard_arguments_match_jax(case, order):
    kw = CH_CASES[case]
    phi, mu, u = _rand(N, 15), _rand(N, 16, 0.01), _rand((3,) + N, 17, 0.01)
    solid = _porous()
    rf = [_rand(N, 18 + a, 1e-3) for a in range(3)]
    targs, jargs = {}, {}
    if kw.get("solid"):
        targs["solid"], jargs["solid"] = _t(solid), jnp.asarray(solid)
    if kw.get("wallspec"):
        targs["wallspec"] = walls.WallSpec(walls=(False, True, True))
        jargs["wallspec"] = jwalls.WallSpec(walls=(False, True, True))
    if kw.get("random_flux"):
        targs["random_flux"] = [_t(x) for x in rf]
        jargs["random_flux"] = [jnp.asarray(x) for x in rf]
    for key in ("noise_stencil", "gradmu_ex"):
        if key in kw:
            targs[key] = jargs[key] = kw[key]
    with_u = kw.get("u", True)
    got = ch.cahn_hilliard_update(
        _t(phi), _t(mu), _t(u) if with_u else None,
        ch.CahnHilliardParams(mobility=0.45, advection_order=order), **targs)
    want = jch.cahn_hilliard_update(
        jnp.asarray(phi), jnp.asarray(mu), jnp.asarray(u) if with_u else None,
        jch.CahnHilliardParams(mobility=0.45, advection_order=order), **jargs)
    _close(got, want)


def test_ch_noise_flux_from_kiss_matches_jax():
    """The phi stream's deviates on the one-site-extended ring, bitwise
    the JAX package's, and the face fluxes built from them."""
    from ludwig_tpu import noise_kiss as jkiss
    ts = noise_kiss.kiss_init(0, N, extended=True, device="cpu")
    js = jkiss.kiss_init(0, N, extended=True)
    for _ in range(2):
        ts, tr = noise_kiss.reap(ts, 3, torch.float64)
        js, jr = jkiss.reap(js, 3, jnp.float64)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        for a, b in zip(noise.ch_flux_from_deviates(tr, 2e-5, 0.45),
                        jnoise.ch_flux_from_deviates(jr, 2e-5, 0.45)):
            _close(a, b)


def test_arrhenius_viscosity_matches_jax():
    phi = _rand(N, 21, 0.8)
    for kw in (dict(eta_minus=0.01, eta_plus=0.004),
               dict(eta_minus=0.1, eta_plus=0.02, phistar=0.7)):
        _close(visc.ViscArrhenius(**kw).eta(_t(phi)),
               jvisc.ViscArrhenius(**kw).eta(jnp.asarray(phi)))


@pytest.mark.parametrize("patch,vol", [(1, 0.5), (2, 0.3), (3, 0.7)])
def test_patches_ref_is_bitwise(patch, vol):
    np.testing.assert_array_equal(
        ref_rng.patches_ref(N, 8361235, patch, vol),
        jref_rng.patches_ref(N, 8361235, patch, vol))


def test_symmetric_fe_on_solid_stencils_matches_jax():
    """mu, stress and fed of the symmetric free energy on the 27-point
    wetting stencil's fields (the free energy with the solid stencils)."""
    fluid = ~_porous()
    phi = _rand(N, 22)
    tops = solid_stencil.solid27_scalar_ops(N, fluid=_t(fluid),
                                            rkappa=1.0 / FE["kappa"],
                                            c=0.01, h=0.001)
    jg, jd = jsolid.solid27_scalar_ops(N, fluid=jnp.asarray(fluid),
                                       rkappa=1.0 / FE["kappa"], c=0.01,
                                       h=0.001)
    tg, td = tops.both(_t(phi))
    tf = {"phi": _t(phi), "grad_phi": tg, "delsq_phi": td}
    jf = {"phi": jnp.asarray(phi), "grad_phi": jg(jnp.asarray(phi)),
          "delsq_phi": jd(jnp.asarray(phi))}
    tfe, jfe = SymmetricFE(**FE), JFE(**FE)
    for name in ("fed", "mu", "stress"):
        _close(getattr(tfe, name)(tf), getattr(jfe, name)(jf))
