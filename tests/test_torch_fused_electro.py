"""The twins of the electrokinetic kernels against ludwig_tpu's Pallas
kernels in interpret mode, and the port's float32 step.

The JAX side runs as its own tests run it (tests/test_fused_electro.py):
the Pallas kernels with interpret=True, x64 on.  Inputs are numpy arrays
made from seeds, at that file's shapes ((16, 16, 128) for the SOR and
Nernst-Planck kernels) or smaller where an interpret call of the
collide+stream kernel would take tens of seconds.  The bounds are those
of tests/test_fused_electro.py unless a test states otherwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import electro as jel
from ludwig_tpu import electro_sim as jes
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.ops import fused as jfused
from ludwig_tpu.ops import fused_electro as jfe
from ludwig_tpu.ops.collide import collide as jcollide
from ludwig_tpu.ops.stream import stream_bounce_back as jbounce
from ludwig_tpu.ops.stream import wall_momentum_transfer as jwall
from ludwig_tpu_torch import electro as tel
from ludwig_tpu_torch import electro_sim as tes
from ludwig_tpu_torch.convert import electro_params_from_jax
from ludwig_tpu_torch.lb import LBConfig
from ludwig_tpu_torch.ops import fused, fused_electro as tfe

SIZE = (16, 16, 128)


def _t(a):
    return torch.as_tensor(np.array(a))


def _setup(dtype, size=SIZE):
    """tests/test_fused_electro.py:18-33."""
    jek = jel.ElectroConfig(valency=(1, -1), diffusivity=(0.01, 0.0095),
                            beta=3.0e-4, epsilon=3.3e3, rel_tol=1e-6,
                            abs_tol=1e-7, max_its=500, solver="sor")
    jcfg = jes.ElectroSimConfig(
        lb=JLBConfig(size=size, nvel=19, eta_shear=0.1, dtype=dtype),
        ek=jek)
    rng = np.random.default_rng(5)
    rho = (1e-3 + 1e-4 * rng.random((2,) + size)).astype(dtype)
    psi = (1e-3 * rng.standard_normal(size)).astype(dtype)
    u = (1e-3 * rng.standard_normal((3,) + size)).astype(dtype)
    solid = np.zeros(size, bool)
    solid[0] = solid[-1] = True
    tcfg = electro_params_from_jax(dataclasses.asdict(jcfg), device="cpu")
    return jcfg, tcfg, psi, rho, u, ~solid


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sor_twin_matches_pallas_interpret(dtype):
    """f64: the same stop, criterion and residual, psi within 1e-12; f32:
    both stop on the stall guard within 15 iterations of each other
    (tests/test_fused_electro.py:35-72)."""
    jcfg, tcfg, psi, rho, _u, _fl = _setup(dtype)
    jrel = jel.rho_elec(jnp.asarray(rho), jcfg.ek)
    jp, jn, jr, jw = jfe.sor_solve_fused(jnp.asarray(psi), jrel, jcfg.ek,
                                         interpret=True)
    tp, tn, tr, tw = tfe.sor_solve_fused(
        _t(psi), tel.rho_elec(_t(rho), tcfg.ek), tcfg.ek)
    assert tp.dtype == getattr(torch, dtype)
    if dtype == "float64":
        assert int(tn) == int(jn) and int(tw) == int(jw)
        np.testing.assert_allclose(float(tr), float(jr), rtol=1e-10)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-12)
    else:
        assert abs(int(tn) - int(jn)) <= 15
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                   atol=2e-5)


def test_sor_twin_matches_reference_route_at_odd_x():
    """Odd X: two red sites meet across the wrap; the twin's sweeps read
    the pre-sweep field as the reference route's do (f64, the same stop
    and criterion, psi within 1e-12 after the route's own mean shift)."""
    size = (15, 8, 8)
    _jcfg, tcfg, psi, rho, _u, _fl = _setup("float64", size)
    rel = tel.rho_elec(_t(rho), tcfg.ek)
    up, dn = tes.make_psi_neighbours(size, tcfg.e0, torch.float64, "cpu")
    rp, rn, _rr, rw = tes.poisson_sor_ref(_t(psi), rel, tcfg.ek, up, dn,
                                          return_iters=True)
    rp = rp - rp.sum() / rp.numel()
    tp, tn, _tr, tw = tfe.sor_solve_fused(_t(psi), rel, tcfg.ek)
    assert (int(tn), int(tw)) == (int(rn), int(rw))
    np.testing.assert_allclose(tp.numpy(), rp.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("hydro", [True, False])
def test_np_gradmu_twin_matches_pallas_interpret(hydro):
    """f32 against the Pallas kernel (force after the mean within 1e-7,
    rho' within 1e-8, tests/test_fused_electro.py:82-98); f64 against
    the port's reference route (gradmu_force + np_step) within 1e-14
    (the Pallas kernel's constants are float32 even for f64 fields)."""
    jcfg, tcfg, psi, rho, u, fl = _setup("float32")
    n = float(np.prod(SIZE))
    jr, jf, js = jfe.np_gradmu_fused(jnp.asarray(psi), jnp.asarray(rho),
                                     jnp.asarray(u) if hydro else None,
                                     jnp.asarray(fl), jcfg, 0.5,
                                     interpret=True)
    tr, tf, ts = tfe.np_gradmu_fused(_t(psi), _t(rho),
                                     _t(u) if hydro else None, _t(fl), tcfg,
                                     0.5)
    assert tr.dtype == tf.dtype == ts.dtype == torch.float32
    np.testing.assert_allclose((tf - (ts / n)[:, None, None, None]).numpy(),
                               np.asarray(jf - (js / n)[:, None, None, None]),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-8)

    _j, tcfg, psi, rho, u, fl = _setup("float64")
    up, dn = tes.make_psi_neighbours(SIZE, tcfg.e0, torch.float64, "cpu")
    tr, tf, ts = tfe.np_gradmu_fused(_t(psi), _t(rho),
                                     _t(u) if hydro else None, _t(fl), tcfg,
                                     0.5)
    want_f = tes.gradmu_force(_t(psi), _t(rho), tcfg, up, dn, n)
    want_r = tes.np_step(_t(rho), _t(psi), _t(u) if hydro else None, _t(fl),
                         tcfg, up, dn, 0.5)
    np.testing.assert_allclose(
        (tf - (ts / n)[:, None, None, None]).numpy(), want_f.numpy(), rtol=0,
        atol=1e-14)
    np.testing.assert_allclose(tr.numpy(), want_r.numpy(), rtol=0,
                               atol=1e-14)


def _solid_case(size):
    cfg = JLBConfig(size=size, nvel=19, eta_shear=0.1, dtype="float64")
    rng = np.random.default_rng(23)
    f0 = 0.05 + 0.01 * rng.random((19,) + size)
    force = 1e-4 * rng.standard_normal((3,) + size)
    solid = np.zeros(size, bool)
    solid[0] = solid[-1] = True
    solid[size[0] // 2, 3:6, size[2] // 4:size[2] // 2] = True  # obstacle
    tcfg = LBConfig(size=size, nvel=19, eta_shear=0.1, dtype="float64",
                    device="cpu")
    return cfg, tcfg, f0, force, solid


def test_fused_force_step_solid_twin_matches_jnp_route():
    """The twin against collide(fluid_mask) + stream_bounce_back and
    wall_momentum_transfer with an interior obstacle, f64: f and u on the
    fluid sites within 1e-13, gw within 1e-11
    (tests/test_fused_electro.py:100-140)."""
    cfg, tcfg, f0, force, solid = _solid_case((16, 16, 32))
    model, params = cfg.model, cfg.collision_params()
    fp, _rho, u_ref = jcollide(jnp.asarray(f0), params,
                               force=jnp.asarray(force),
                               fluid_mask=jnp.asarray(~solid))
    gw_ref = jwall(fp, model, jnp.asarray(solid))
    f_ref = jbounce(fp, model, solid=jnp.asarray(solid))
    f, u, gw = fused.fused_force_step(_t(f0), _t(force), tcfg.model,
                                      tcfg.collision_params(),
                                      solid=_t(solid))
    fl3 = (~solid)[None]
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(u.numpy() * fl3, np.asarray(u_ref) * fl3,
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_ref), rtol=0,
                               atol=1e-11)


def test_fused_force_step_solid_twin_matches_pallas_interpret():
    """The twin against the Pallas kernel's `with_solid` variant in
    interpret mode (f64, an 8x8x16 lattice: the interpret call costs
    seconds per block).  The twin follows the kernel's term order: f and
    u bitwise where XLA does not reassociate, within 1e-15 here; gw (a sum
    over the lattice in another order) within 1e-13."""
    cfg, tcfg, f0, force, solid = _solid_case((8, 8, 16))
    model, params = cfg.model, cfg.collision_params()
    fpad, u_j, gw_j = jfused.fused_force_step(
        jfused.pad_state(jnp.asarray(f0), zpad=False), jnp.asarray(force),
        model, params, jfused.FusedPlan(4, 8), interpret=True,
        solid=jnp.asarray(solid))
    f, u, gw = fused.fused_force_step(_t(f0), _t(force), tcfg.model,
                                      tcfg.collision_params(),
                                      solid=_t(solid))
    np.testing.assert_allclose(f.numpy(),
                               np.asarray(jfused.unpad_state(fpad, z=16)),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=0,
                               atol=1e-15)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j), rtol=0,
                               atol=1e-13)


def test_solid_push_form_is_the_twin():
    """csrc/fused_lb.cu's solid kernel pushes each fluid site's
    post-collision values: to x + c_q when that site is fluid, else back
    into its own antipode (the wall taking -c_q times the value); solid
    sites keep their pre-collision values.  This loop, site by site, must
    give the twin's pull-form result exactly."""
    size = (6, 5, 7)
    _cfg, tcfg, f0, force, solid = _solid_case(size)
    model, params = tcfg.model, tcfg.collision_params()
    f0, force = _t(f0), _t(force)
    anti, _par = fused._eo_tables(model)
    cvs = [tuple(int(c) for c in model.cv[q]) for q in range(19)]
    fl = [f0[q] for q in range(19)]
    modes, _u = fused._collide_mode_deltas(model, params, fl,
                                           force=[force[a] for a in range(3)])
    out = torch.full_like(f0, float("nan"))
    w = [0.0, 0.0, 0.0]
    fluid_sites = [s for s in np.ndindex(size) if not solid[s]]

    def push(v, q):
        for s in fluid_sites:
            d = tuple((s[a] + cvs[q][a]) % size[a] for a in range(3))
            if not solid[d]:
                out[(q,) + d] = v[s]
                continue
            out[(anti[q],) + s] = v[s]
            for a in range(3):
                w[a] -= cvs[q][a] * float(v[s])

    fused._assemble_eo_deltas(model, fl, modes, push)
    out = torch.where(_t(solid)[None], f0, out)
    want_f, _u, want_gw = fused.fused_force_step(f0, force, model, params,
                                                 solid=_t(solid))
    assert torch.equal(out, want_f)
    np.testing.assert_allclose(-2.0 * np.array(w), want_gw.numpy(), rtol=0,
                               atol=1e-15)


def _jax_f32_step(jcfg, solid, interpret_plan):
    """ludwig_tpu electro_sim.make_electro_step's float32 kernel route,
    built from its three Pallas kernels in interpret mode (the step itself
    would launch them compiled, which the CPU cannot)."""
    model, params = jcfg.lb.model, jcfg.lb.collision_params()
    size = jcfg.lb.size
    n_sites = float(np.prod(size))
    fl = jnp.logical_not(solid)

    def step(state):
        f, psi, rho, u, gwall = state
        psi, *_sor = jfe.sor_solve_fused(psi, jel.rho_elec(rho, jcfg.ek),
                                         jcfg.ek, zero_mean=True,
                                         interpret=True)
        rho, force, fsum = jfe.np_gradmu_fused(psi, rho, u, fl, jcfg, 1.0,
                                               interpret=True)
        force = force - (fsum / n_sites)[:, None, None, None]
        fpad, u, gw = jfused.fused_force_step(
            jfused.pad_state(f, zpad=False), force, model, params,
            interpret_plan, interpret=True, solid=solid)
        return (jfused.unpad_state(fpad, z=size[2]), psi, rho, u,
                gwall + gw)

    return step


def test_f32_electro_step_matches_pallas_pieces():
    """Three float32 steps of the port's kernel route (on the CPU: the
    twins) against the same three from the Pallas kernels in interpret
    mode, on a Gouy-Chapman state at 8x8x16.  The SOR solves may stop a
    few iterations apart (f32 stall guard on residuals summed in another
    order): psi within 2e-5 as in the SOR test; rho within 1e-8
    (tests/test_fused_electro.py:98); f and u within 1e-6 (the force
    differs by rho_el times the psi gap, ~1e-5 kT/e).  gwall sums ~1e3
    link terms of ~1/18 whose two walls cancel: in f32 both sides keep
    that sum's rounding, so it is held to 1e-6 of the terms' total (3
    steps, 2 walls, 5 links a wall site, -2 each)."""
    size = (8, 8, 16)
    jek = jel.ElectroConfig(valency=(1, -1), diffusivity=(0.01, 0.01),
                            beta=3.0e4, epsilon=3.3e3, rel_tol=1e-8,
                            abs_tol=1e-15, max_its=10000, solver="sor")
    jcfg = jes.ElectroSimConfig(
        lb=JLBConfig(size=size, nvel=19, eta_shear=0.1, dtype="float32"),
        ek=jek)
    tcfg = electro_params_from_jax(dataclasses.asdict(jcfg), device="cpu")
    psi0, rho0, boundary = jes.init_gouy_chapman(size, 1.04e-3, 3.125e-2)
    rho0 = jes.electroneutral(rho0, (1, -1), boundary).astype(np.float32)
    f0 = np.broadcast_to(np.asarray(jcfg.lb.model.wv, np.float32)[
        :, None, None, None], (19,) + size).copy()
    z3 = np.zeros((3,) + size, np.float32)
    jstate = tuple(jnp.asarray(a) for a in (f0, psi0.astype(np.float32),
                                            rho0, z3,
                                            np.zeros(3, np.float32)))
    tstate = tes.initial_electro(tcfg, _t(f0), psi0, rho0)
    jstep = jax.jit(_jax_f32_step(jcfg, jnp.asarray(boundary),
                                  jfused.FusedPlan(4, 8)))
    tstep = tes.make_electro_step(tcfg, solid=_t(boundary))
    for t in range(3):
        jstate = jstep(jstate)
        tstate, (_rho, sor) = tstep(tstate, t)
        assert int(sor[0]) < 9999
    fluid = ~boundary
    links = 3 * 2 * 5 * size[1] * size[2] * 2.0 / 18.0
    tol = {"f": 1e-6, "psi": 2e-5, "rho": 1e-8, "u": 1e-6,
           "gwall": 1e-6 * links}
    for name, a, b in zip(tol, tstate, jstate):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == np.float32
        if name == "u":
            a, b = a * fluid, b * fluid
        np.testing.assert_allclose(a, b, rtol=0, atol=tol[name],
                                   err_msg=name)
    # charge is conserved by the flux form, to f32 rounding
    for k in range(2):
        assert float(tstate[2][k].double().sum()) == pytest.approx(
            float(rho0[k].astype(np.float64).sum()), rel=1e-6)


def test_route_gates_keep_semantic_conditions_only():
    """No layout gates (odd extents, any Z): only the external field
    sends the float32 step to the reference route."""
    cfg = tes.ElectroSimConfig(
        lb=LBConfig(size=(9, 7, 5), device="cpu"), ek=tel.ElectroConfig())
    assert tfe.kernel_supported()
    assert not tfe.kernel_supported(e0=(0.0, 1e-3, 0.0))
    assert not tfe.kernel_supported(e0=(1e-3, 0.0, 0.0))
    with pytest.raises(TypeError, match="float32 or float64"):
        tfe.sor_solve_fused(torch.zeros((4, 4, 4), dtype=torch.float16),
                            torch.zeros((4, 4, 4)), cfg.ek)
    with pytest.raises(TypeError, match="fluid must be torch.bool"):
        tfe.np_gradmu_fused(torch.zeros((4, 4, 4)),
                            torch.zeros((2, 4, 4, 4)), None,
                            torch.zeros((4, 4, 4)), cfg, 1.0)
