"""The port's specialised observables (ludwig_tpu_torch/stats_extra.py:
measure_sigma, rheology_profiles, shear_stress_mean, TurbulentStats,
SigmaCalibration) against ludwig_tpu's, on the CPU in float64, on the
same seeded inputs: the values at rtol 1e-12 (sums in another order),
the turbulence profile's file as text."""

import jax.numpy as jnp
import numpy as np
import torch

from ludwig_tpu import stats_extra as jse
from ludwig_tpu.binary import fe_fields as jfe_fields
from ludwig_tpu.fe.symmetric import SymmetricFE as JSymmetricFE
from ludwig_tpu.lattice import lb_model as jlb_model
from ludwig_tpu_torch import stats_extra as tse
from ludwig_tpu_torch.binary import fe_fields
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.lattice import lb_model

FE = dict(a=-6.25e-3, b=6.25e-3, kappa=4.0e-2)
TOL = dict(rtol=1e-12, atol=1e-15)


def _drop(size, seed):
    """A drop of the calibration's shape with seeded noise on it."""
    cal = tse.SigmaCalibration(SymmetricFE(**FE), size, 0.5)
    rng = np.random.default_rng(seed)
    return cal.init_phi(np.float64) + 1e-3 * rng.standard_normal(size)


def test_measure_sigma_and_profiles_match_jax():
    rng = np.random.default_rng(4)
    phi = _drop((16, 8, 8), 4)
    sig = tse.measure_sigma(SymmetricFE(**FE),
                            fe_fields(torch.as_tensor(phi), "3d_7pt_fluid"))
    jsig = jse.measure_sigma(JSymmetricFE(**FE),
                             jfe_fields(jnp.asarray(phi), "3d_7pt_fluid"))
    np.testing.assert_allclose(sig, jsig, **TOL)
    u = rng.standard_normal((3, 16, 8, 8))
    pth = rng.standard_normal((3, 3, 16, 8, 8))
    for axis in range(3):
        got = tse.rheology_profiles(torch.as_tensor(u), torch.as_tensor(pth),
                                    axis)
        want = jse.rheology_profiles(jnp.asarray(u), jnp.asarray(pth), axis)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    f = rng.random((19, 8, 8, 8))
    np.testing.assert_allclose(
        tse.shear_stress_mean(torch.as_tensor(f), lb_model(19)),
        jse.shear_stress_mean(jnp.asarray(f), jlb_model(19)), **TOL)


def test_turbulent_stats_file_matches_jax(tmp_path):
    size = (4, 3, 5)
    rng = np.random.default_rng(6)
    ts, js = tse.TurbulentStats(size), jse.TurbulentStats(size)
    for _ in range(2):
        u = rng.standard_normal((3,) + size)
        ts.accumulate(torch.as_tensor(u))
        js.accumulate(jnp.asarray(u))
    ts.output(str(tmp_path / "port.dat"))
    js.output(str(tmp_path / "jax.dat"))
    assert ((tmp_path / "port.dat").read_text()
            == (tmp_path / "jax.dat").read_text())
    ts.zero()
    assert ts.time_counter == 0 and not ts.ubar.any()


def test_sigma_calibration_matches_jax():
    """The drop's initial field bitwise, its banner as text, and the
    measurement (radius, width fit, surface tension) of a noisy drop."""
    size = (16, 16, 16)
    cal = tse.SigmaCalibration(SymmetricFE(**FE), size, 0.5)
    jcal = jse.SigmaCalibration(JSymmetricFE(**FE), size, 0.5)
    assert np.array_equal(cal.init_phi(np.float64), jcal.init_phi(np.float64))
    import io
    a, b = io.StringIO(), io.StringIO()
    cal.banner(a)
    jcal.banner(b)
    assert a.getvalue() == b.getvalue()
    phi = _drop(size, 8)
    got = cal.measure(torch.as_tensor(phi),
                      fe_fields(torch.as_tensor(phi), "3d_7pt_fluid"))
    want = jcal.measure(phi, jfe_fields(jnp.asarray(phi), "3d_7pt_fluid"))
    np.testing.assert_allclose(got, want, **TOL)
