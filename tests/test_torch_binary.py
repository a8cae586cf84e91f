"""The port's binary-fluid modules against ludwig_tpu's, on the CPU.

Each module (ref_rng, fe/symmetric, ops/stencil, ops/force, ops/advect,
dynamics/cahn_hilliard, binary) runs beside its JAX counterpart on the
same numpy inputs made from a seed, at 8x8x16 (tests/test_fused.py:169).
Tolerances: f64 rtol 1e-12 / atol 1e-14 per module (the same element-wise
arithmetic in the same order on both sides; XLA:CPU without FMA,
conftest.py); rtol 1e-10 / atol 1e-12 for 3 whole binary steps, the
bound tests/test_fused.py:190 holds the fused binary step to."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import binary as jbinary
from ludwig_tpu import ludwig as jludwig
from ludwig_tpu import ref_rng as jref_rng
from ludwig_tpu.dynamics import cahn_hilliard as jch
from ludwig_tpu.fe.symmetric import SymmetricFE as JFE
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.ops import advect as jadvect
from ludwig_tpu.ops import force as jforce
from ludwig_tpu.ops import stencil as jstencil
from ludwig_tpu.runtime import RunTime as JRunTime
from ludwig_tpu_torch import binary, ludwig, ref_rng
from ludwig_tpu_torch.convert import binary_params_from_jax
from ludwig_tpu_torch.dynamics import cahn_hilliard as ch
from ludwig_tpu_torch.fe.brazovskii import BrazovskiiFE
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.ops import advect, force, stencil
from ludwig_tpu_torch.runtime import RunTime

N = (8, 8, 16)
TOL = dict(rtol=1e-12, atol=1e-14)
STEP_TOL = dict(rtol=1e-10, atol=1e-12)
FE = dict(a=-6.25e-3, b=6.25e-3, kappa=4e-3)


def _rand(shape, seed, scale=0.05):
    return scale * np.random.default_rng(seed).standard_normal(shape)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _fields_both(phi):
    tf = binary.fe_fields(_t(phi), "3d_7pt_fluid")
    jf = jbinary.fe_fields(jnp.asarray(phi), "3d_7pt_fluid")
    return tf, jf


def test_spinodal_ref_is_bitwise():
    np.testing.assert_array_equal(
        ref_rng.spinodal_ref(N, 8361235, 0.01, amp=0.2),
        jref_rng.spinodal_ref(N, 8361235, 0.01, amp=0.2))
    a, b = ref_rng.RefNoise(N, -3), jref_rng.RefNoise(N, -3)
    np.testing.assert_array_equal(a.reap_uniform(), b.reap_uniform())
    np.testing.assert_array_equal(a.state, b.state)


def test_symmetric_fe_matches_jax():
    phi = _rand(N, 1)
    tf, jf = _fields_both(phi)
    tfe, jfe = SymmetricFE(**FE), JFE(**FE)
    _close(tfe.fed(tf), jfe.fed(jf))
    _close(tfe.mu(tf), jfe.mu(jf))
    _close(tfe.stress(tf), jfe.stress(jf))
    for prop in ("xi0", "phi_star", "sigma"):
        assert getattr(tfe, prop) == getattr(jfe, prop)


@pytest.mark.parametrize("name", ["3d_7pt_fluid", "3d_27pt_fluid"])
def test_stencils_match_jax(name):
    phi = _rand((2,) + N, 2)       # a leading axis, as q-tensors carry
    tgrad, tdelsq = stencil.gradient_ops(name)
    jgrad, jdelsq = jstencil.gradient_ops(name)
    _close(tgrad(_t(phi)), jgrad(jnp.asarray(phi)))
    _close(tdelsq(_t(phi)), jdelsq(jnp.asarray(phi)))
    with pytest.raises(ValueError):
        stencil.gradient_ops("3d_27pt_nonesuch")


def test_stress_divergence_force_matches_jax():
    tf, jf = _fields_both(_rand(N, 3))
    pth_t, pth_j = SymmetricFE(**FE).stress(tf), JFE(**FE).stress(jf)
    got = force.stress_divergence_force(pth_t)
    _close(got, jforce.stress_divergence_force(pth_j))
    # conservative: the total force vanishes to roundoff
    assert float(got.sum(dim=(1, 2, 3)).abs().max()) < 1e-16


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5])
def test_advection_matches_jax(order):
    u, phi = _rand((3,) + N, 4, 0.01), _rand(N, 5)
    for ax in range(3):
        _close(advect.face_velocity(_t(u), ax),
               jadvect.face_velocity(jnp.asarray(u), ax))
    tfl = advect.advective_fluxes(_t(u), _t(phi), order)
    jfl = jadvect.advective_fluxes(jnp.asarray(u), jnp.asarray(phi), order)
    for a, b in zip(tfl, jfl):
        _close(a, b)
    _close(advect.flux_divergence(tfl), jadvect.flux_divergence(jfl))
    with pytest.raises(ValueError):
        advect.advective_fluxes(_t(u), _t(phi), 6)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("with_u", [True, False])
def test_cahn_hilliard_matches_jax(order, with_u):
    phi, u = _rand(N, 6), _rand((3,) + N, 7, 0.01)
    tf, jf = _fields_both(phi)
    mu_t, mu_j = SymmetricFE(**FE).mu(tf), JFE(**FE).mu(jf)
    got = ch.cahn_hilliard_update(
        _t(phi), mu_t, _t(u) if with_u else None,
        ch.CahnHilliardParams(mobility=0.45, advection_order=order))
    want = jch.cahn_hilliard_update(
        jnp.asarray(phi), mu_j, jnp.asarray(u) if with_u else None,
        jch.CahnHilliardParams(mobility=0.45, advection_order=order))
    _close(got, want)


def _bcfgs(order, dtype="float64"):
    jcfg = jbinary.BinaryConfig(
        lb=JLBConfig(size=N, nvel=19, eta_shear=6.25e-3, dtype=dtype),
        fe=JFE(**FE), mobility=0.45, advection_order=order)
    return jcfg, binary_params_from_jax(dataclasses.asdict(jcfg),
                                        device="cpu")


@pytest.mark.parametrize("order", [1, 2])
def test_make_binary_step_matches_jax(order):
    """3 unfused steps from a spinodal phi, against binary.make_binary_step
    (the port's `tpu_fused off` route)."""
    jcfg, tcfg = _bcfgs(order)
    phi0 = jbinary.spinodal_phi(N, seed=11)
    js = jbinary.initial_binary(jcfg, phi0)
    ts = binary.initial_binary(tcfg, phi0)
    for a, b in zip(ts, js):
        _close(a, b)
    jstep, tstep = jbinary.make_binary_step(jcfg), binary.make_binary_step(
        tcfg)
    for t in range(3):
        js, jrho = jstep(js, t)
        ts, trho = tstep(ts, t)
    for a, b in zip(ts, js):
        _close(a, b, STEP_TOL)
    _close(trho, jrho, STEP_TOL)


PORTED_CHANGES = [
    dict(advection_order=3), dict(hydrodynamics=False),
    dict(gradient="3d_27pt_fluid"), dict(gradmu_ex=(1e-3, 0.0, 0.0)),
    dict(force_method="phi_gradmu"), dict(wetting=(0.1, 0.0))]


@pytest.mark.parametrize("change", PORTED_CHANGES,
                         ids=lambda c: next(iter(c)))
def test_binary_config_carries_across(change):
    """A JAX BinaryConfig using a feature the port has taken over is
    carried across field for field."""
    jcfg, _ = _bcfgs(2)
    jcfg = dataclasses.replace(jcfg, **change)
    tcfg = binary_params_from_jax(dataclasses.asdict(jcfg), device="cpu")
    for key in ("mobility", "advection_order", "gradient", "hydrodynamics",
                "force_method", "gradmu_ex", "wetting"):
        want = getattr(jcfg, key)
        assert getattr(tcfg, key) == (tuple(want) if isinstance(want, tuple)
                                      else want), key


def _refused(jcfg, name):
    from ludwig_tpu.fe.brazovskii import BrazovskiiFE
    from ludwig_tpu.noise import NoiseConfig as JNoise
    if name == "brazovskii":
        return dataclasses.replace(jcfg, fe=BrazovskiiFE(
            a=-6.25e-3, b=6.25e-3, kappa=4e-3, c=1e-3))
    if name.startswith("threefry"):
        nz = JNoise(kt=1e-5, rho=name != "threefry_phi",
                    phi=name != "threefry_rho", kiss=False)
        return dataclasses.replace(jcfg, lb=dataclasses.replace(jcfg.lb,
                                                                noise=nz))
    return dataclasses.replace(jcfg, force_method=name)


FORCE_REFUSED = ("no_force", "phi_gradmu_correction", "relaxation_symmetric",
                 "relaxation_antisymmetric")


@pytest.mark.parametrize("name", (
    "brazovskii", "threefry_rho", "threefry_phi") + FORCE_REFUSED)
def test_binary_config_refuses_what_is_not_ported(name):
    """A JAX BinaryConfig using a feature the port has not taken over (the
    force methods the JAX binary step runs as stress_divergence) is
    refused when carried across, and so is the port's own config for such
    a force method.  The Brazovskii free energy is ported: it crosses as
    the port's BrazovskiiFE, with the fourth-order fields on; so is the
    threefry noise stream, which crosses as NoiseConfig(kiss=False)."""
    jcfg, tcfg = _bcfgs(2)
    fields = dataclasses.asdict(_refused(jcfg, name))
    if name.startswith("threefry"):
        nz = binary_params_from_jax(fields, device="cpu").lb.noise
        assert not nz.kiss and nz.kt == 1e-5
        assert (nz.rho, nz.phi) == (name != "threefry_phi",
                                    name != "threefry_rho")
        return
    if name == "brazovskii":
        got = binary_params_from_jax(fields, device="cpu")
        assert got.fe == BrazovskiiFE(a=-6.25e-3, b=6.25e-3, kappa=4e-3,
                                      c=1e-3)
        assert got.fourth_order and not tcfg.fourth_order
        return
    with pytest.raises(NotImplementedError):
        binary_params_from_jax(fields, device="cpu")
    if name in FORCE_REFUSED:
        with pytest.raises(NotImplementedError):
            dataclasses.replace(tcfg, force_method=name)


@pytest.mark.parametrize("text", [
    "phi_initialisation spinodal\nphi0 0.02\nnoise 0.3\nrandom_seed 7",
    "phi_initialisation uniform\nphi0 0.3",
    "phi_initialisation drop\nphi_init_drop_radius 3.0",
    "phi_initialisation drop\nphi_init_drop_centred yes\n"
    "phi_init_drop_amplitude -1",
    "phi_initialisation block",
    "phi_initialisation block_X\nphi_init_block_dimension 3",
    "phi_initialisation block_Y",
    "phi_initialisation block_Z\nphi_init_block_dimension 5"],
    ids=["spinodal", "uniform", "drop", "drop_centred", "block", "block_X",
         "block_Y", "block_Z"])
def test_phi_init_matches_jax(text):
    fe = SymmetricFE(**FE)
    got = ludwig._phi_init(RunTime(text), N, fe)
    want = jludwig._phi_init(JRunTime(text), N, JFE(**FE))
    np.testing.assert_array_equal(got, want)
    sym = "symmetric_a -0.01\nsymmetric_b 0.02\nsymmetric_kappa 0.03\n"
    assert ludwig._symm_fe(RunTime(sym)) == SymmetricFE(-0.01, 0.02, 0.03)
    assert ludwig._symm_fe(RunTime("A -1\nB 2\nK 3\n")) == SymmetricFE(
        -1.0, 2.0, 3.0)
