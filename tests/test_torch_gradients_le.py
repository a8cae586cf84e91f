"""The port's Lees-Edwards field machinery (ops/le_ref.py) against
ludwig_tpu/ops/le_ref.py, on the CPU.

Each function takes the same numpy fields from a seed, 16x8x16 with 2
planes at uy 0.04 (the JAX package's sheared test lattice), in float64,
at t = 0 (the clamped displacement), 3 and 7, and must agree at rtol
1e-10 / atol 1e-12; the port takes every plane at once, so its (..., P,
Y, Z) columns are compared plane by plane with the JAX package's per
plane results.  The 7- and 27-point forms are held to the JAX
package's, and so are the fourth-order (Brazovskii) forms and a sheared
Brazovskii step; what is still refused raises, naming it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu.ops import le_ref as jlr
from ludwig_tpu.ops import lees_edwards as jle
from ludwig_tpu_torch.ops import le_ref as tlr
from ludwig_tpu_torch.ops import lees_edwards as tle
from test_torch_binary_le import TOL

N = (16, 8, 16)
LE = dict(nplanes=2, uy=0.04, nx=N[0])
TIMES = (0, 3, 7)
JLE, TLE = jle.LeesEdwardsConfig(**LE), tle.LeesEdwardsConfig(**LE)


def _rand(shape, seed):
    return 0.05 * np.random.default_rng(seed).standard_normal(shape)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def by_plane(got, want_of, axis):
    """got (..., P, ...) along `axis` against want_of(c) per plane."""
    for k, c in enumerate(JLE.plane_cols):
        close(got.select(axis, k), want_of(c))


@pytest.mark.parametrize("dy", [0.0, 0.3, 2.75, -1.4, 17.2])
def test_samplers_match_jax(dy):
    col = _rand((5, 8, 16), 1)
    tdy = torch.tensor(dy, dtype=torch.float64)
    close(tlr.sample_cubic(torch.as_tensor(col), tdy),
          jlr.sample_cubic(jnp.asarray(col), jnp.asarray(dy)))
    close(tlr.sample_linear(torch.as_tensor(col), tdy),
          jlr.sample_linear(jnp.asarray(col), jnp.asarray(dy)))


@pytest.mark.parametrize("t", TIMES)
@pytest.mark.parametrize("ncomp", [0, 5], ids=["scalar", "q5"])
def test_le_gradient_and_dab_match_jax(t, ncomp):
    shape = N if ncomp == 0 else (ncomp,) + N
    phi = _rand(shape, 2)
    jg, jd = jlr.le_gradient(jnp.asarray(phi), JLE, t)
    tg, td = tlr.le_gradient(torch.as_tensor(phi), TLE, t)
    close(tg, jg)
    close(td, jd)
    if ncomp == 0:
        close(tlr.le_dab_7pt(torch.as_tensor(phi), TLE, t),
              jlr.le_dab_7pt(jnp.asarray(phi), JLE, t))


@pytest.mark.parametrize("t", TIMES)
@pytest.mark.parametrize("up", [True, False], ids=["up", "down"])
def test_buffer_columns_match_jax(t, up):
    phi, q5 = _rand(N, 3), _rand((5,) + N, 4)
    jctx = jlr.LEContext(JLE, t, jnp.float64)
    tctx = tlr.LEContext(TLE, t, torch.as_tensor(phi))
    for field, ax in ((phi, 0), (q5, 1)):
        got = tlr.le_buffer_fields(torch.as_tensor(field), tctx, up)
        for k, g in enumerate(got):
            by_plane(g, lambda c: jlr.le_buffer_fields(
                jnp.asarray(field), jctx, c, up)[k], ax + (k == 1))
    by_plane(tlr.le_buffer_dab(torch.as_tensor(phi), tctx, up),
             lambda c: jlr.le_buffer_dab(jnp.asarray(phi), jctx, c, up), 2)
    u = _rand((3,) + N, 5)
    for d in (-1, 0, 1, 2):
        by_plane(tctx.col_u(torch.as_tensor(u), d, up),
                 lambda c: jctx.col_u(jnp.asarray(u), c + d, up, c), 1)


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5])
def test_advective_fluxes_and_divergence_match_jax(order):
    t = 7
    q5, u = _rand((5,) + N, 6), _rand((3,) + N, 7)
    jctx = jlr.LEContext(JLE, t, jnp.float64)
    tctx = tlr.LEContext(TLE, t, torch.as_tensor(q5))
    jfe, jfw, jfy, jfz = jlr.le_advective_fluxes(jnp.asarray(q5),
                                                 jnp.asarray(u), jctx, order)
    tfe, tfw, tfy, tfz = tlr.le_advective_fluxes(torch.as_tensor(q5),
                                                 torch.as_tensor(u), tctx,
                                                 order)
    for a, b in ((tfe, jfe), (tfy, jfy), (tfz, jfz)):
        close(a, b)
    by_plane(tfw, lambda c: jfw[c], 1)
    close(tlr.le_flux_divergence(tfe, tfw, tfy, tfz, tctx),
          jlr.le_flux_divergence(jfe, jfw, jfy, jfz, jctx))


def test_stress_force_matches_jax():
    t = 3
    pth = _rand((3, 3) + N, 8)
    b1, d0 = _rand((3, 3, 2) + N[1:], 9), _rand((3, 3, 2) + N[1:], 10)
    jctx = jlr.LEContext(JLE, t, jnp.float64)
    tctx = tlr.LEContext(TLE, t, torch.as_tensor(pth))
    bufs = {c: (jnp.asarray(b1[:, :, k]), jnp.asarray(d0[:, :, k]))
            for k, c in enumerate(JLE.plane_cols)}
    area = float(N[1] * N[2])
    close(tlr.le_stress_force(torch.as_tensor(pth), torch.as_tensor(b1),
                              torch.as_tensor(d0), tctx, area),
          jlr.le_stress_force(jnp.asarray(pth), bufs, jctx, area))


@pytest.mark.parametrize("t", TIMES)
def test_le_gradient_27pt_matches_jax(t):
    """The 27-point LE gradient and its buffer columns (ref:
    gradient_3d_27pt_fluid.c + its _le correction)."""
    phi = _rand(N, 2)
    jg, jd = jlr.le_gradient(jnp.asarray(phi), JLE, t, "3d_27pt_fluid")
    tg, td = tlr.le_gradient(torch.as_tensor(phi), TLE, t, "3d_27pt_fluid")
    close(tg, jg)
    close(td, jd)
    jctx = jlr.LEContext(JLE, t, jnp.float64)
    tctx = tlr.LEContext(TLE, t, torch.as_tensor(phi))
    for up in (True, False):
        got = tlr.le_buffer_fields(torch.as_tensor(phi), tctx, up,
                                   "3d_27pt_fluid")
        for k, g in enumerate(got):
            by_plane(g, lambda c: jlr.le_buffer_fields(
                jnp.asarray(phi), jctx, c, up, "3d_27pt_fluid")[k],
                int(k == 1))


def _brazovskii_step():
    """Two steps of the sheared Brazovskii fluid (the 5-point fourth-order
    LE fields) against the JAX package's, eagerly."""
    import dataclasses

    from ludwig_tpu import binary as jbinary
    from ludwig_tpu import binary_le as jbinary_le
    from ludwig_tpu.fe.brazovskii import BrazovskiiFE
    from ludwig_tpu.lb import LBConfig
    from ludwig_tpu_torch.binary_le import BinaryLEConfig, make_binary_le_step
    from ludwig_tpu_torch.convert import (binary_params_from_jax,
                                          state_leaves_from_jax)
    jcfg = jbinary.BinaryConfig(
        lb=LBConfig(size=N, eta_shear=0.1, dtype="float64"),
        fe=BrazovskiiFE(a=-5e-4, b=5e-4, kappa=-6e-4, c=7.6e-4),
        mobility=0.05)
    tcfg = binary_params_from_jax(dataclasses.asdict(jcfg), device="cpu")
    jstep = jbinary_le.make_binary_le_step(
        jbinary_le.BinaryLEConfig(binary=jcfg, le=JLE)).__wrapped__
    tstep = make_binary_le_step(BinaryLEConfig(binary=tcfg, le=TLE))
    js = jbinary.initial_binary(jcfg, _rand(N, 4))
    ts = state_leaves_from_jax(js, "cpu", torch.float64)
    for t in (1, 2):
        js, _ = jstep(js, t)
        ts, _ = tstep(ts, t)
    for a, b in zip(ts, js):
        close(a, b)


def _d4(form):
    def call():
        phi = _rand(N, 2)
        for t in TIMES:
            want = getattr(jlr, form)(jnp.asarray(phi), JLE, t)
            got = getattr(tlr, form)(torch.as_tensor(phi), TLE, t)
            for k in range(4):
                close(got[k], want[k])
    return call


def _threefry_noise():
    """The threefry stream, once refused here, is ported: the deviates of
    a (16, 8, 16) draw are the JAX package's."""
    from ludwig_tpu import noise as jnoise
    from ludwig_tpu_torch import noise as tnoise
    assert not tnoise.NoiseConfig(kt=1e-5, rho=True, kiss=False).kiss
    want = jnoise.discrete_deviates(8361235, 3, 2, N, jnp.float64)
    got = tnoise.discrete_deviates(8361235, 3, 2, N, torch.float64,
                                   device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _lc_27pt():
    """The liquid crystal's other fluid stencils (lc_fields takes every
    stencil the JAX package's does)."""
    from ludwig_tpu import lc as jlc
    from ludwig_tpu_torch.lc import lc_fields
    q = _rand((5,) + N, 6)
    want = jlc.lc_fields(jnp.asarray(q), "3d_27pt_fluid")
    got = lc_fields(torch.as_tensor(q), "3d_27pt_fluid")
    for key in ("grad_q", "delsq_q"):
        close(got[key], want[key])


# the fourth-order (Brazovskii) forms, the liquid crystal's 27-point
# stencil and the threefry noise are ported: held to the JAX package's;
# anything still refused would raise, naming what is not ported
PARITY = {"brazovskii-step": _brazovskii_step,
          "27pt-d4": _d4("le_fields_27pt_d4"),
          "2d5pt-d4": _d4("le_fields_2d5pt_d4"), "lc-27pt": _lc_27pt,
          "threefry-noise": _threefry_noise}
REFUSED = {}


@pytest.mark.parametrize("case", ["brazovskii-step", "threefry-noise",
                                  "27pt-d4", "2d5pt-d4", "lc-27pt"])
def test_other_stencils_raise(case):
    if case in REFUSED:
        with pytest.raises(NotImplementedError, match="not ported"):
            REFUSED[case]()
    else:
        PARITY[case]()
