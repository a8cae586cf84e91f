"""The port's fluctuating LB on the KISS stream against ludwig_tpu.

noise_kiss (state and deviates bitwise), the noise variances and the
stress and ghost terms (noise.py), lb._noise_terms with and without a
fluid mask, the collision's shat/ghat hooks, and three steps of the KISS
make_step: the KISS state bitwise, f at rtol 1e-12 / atol 1e-14 in f64
(the same unrolled arithmetic on both sides, XLA:CPU without FMA)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import lb as jlb
from ludwig_tpu import noise as jnoise
from ludwig_tpu import noise_kiss as jkiss
from ludwig_tpu.lattice import lb_model as jlb_model
from ludwig_tpu.ops.collide import CollisionParams as JParams
from ludwig_tpu.ops.collide import RelaxationScheme as JScheme
from ludwig_tpu.ops.collide import collide as jcollide
from ludwig_tpu_torch import lb as tlb
from ludwig_tpu_torch import noise as tnoise
from ludwig_tpu_torch import noise_kiss as tkiss
from ludwig_tpu_torch.convert import (noise_state_from_jax, params_from_jax,
                                      state_from_jax)
from ludwig_tpu_torch.lattice import lb_model
from ludwig_tpu_torch.ops.collide import (CollisionParams, RelaxationScheme,
                                          collide)

RTOL, ATOL = 1e-12, 1e-14
SIZE = (8, 8, 16)
KT = 2e-5
TDT = {"float64": torch.float64, "float32": torch.float32}
NDT = {"float64": jnp.float64, "float32": jnp.float32}


def _words(t: torch.Tensor) -> np.ndarray:
    """The port's int64 KISS words as the JAX package's uint32 array."""
    a = t.numpy()
    assert a.min() >= 0 and a.max() < 2 ** 32
    return a.astype(np.uint32)


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("seed", [0, 8361235])
def test_kiss_init_bitwise(extended, seed):
    got = tkiss.kiss_init(seed, SIZE, extended=extended, device="cpu")
    want = np.asarray(jkiss.kiss_init(seed, SIZE, extended=extended))
    assert np.array_equal(_words(got), want)


@pytest.mark.parametrize("n", [6, 9])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_reap_bitwise(n, dtype):
    ts = tkiss.kiss_init(0, SIZE, device="cpu")
    js = jkiss.kiss_init(0, SIZE)
    for _ in range(3):     # a few draws: the state advances each time
        ts, tr = tkiss.reap(ts, n, TDT[dtype])
        js, jr = jkiss.reap(js, n, NDT[dtype])
        assert np.array_equal(_words(ts), np.asarray(js))
        assert tr.numpy().tobytes() == np.asarray(jr).tobytes()
    assert np.array_equal(tkiss.interior(ts).numpy(),
                          ts.numpy()[..., 1:-1, 1:-1, 1:-1])


def test_variances_and_terms_match_jax():
    model, jmodel = lb_model(19), jlb_model(19)
    params = CollisionParams(model=model, eta_shear=0.1, eta_bulk=0.14)
    rtg = np.asarray(params.rtau_ghost)
    for tau in (0.8, 1.3):
        assert tnoise.var_eta(tau, KT) == jnoise.var_eta(tau, KT)
        assert tnoise.var_bulk(tau, KT) == jnoise.var_bulk(tau, KT)
    assert np.array_equal(tnoise.var_ghost(model, rtg, KT),
                          jnoise.var_ghost(jmodel, rtg, KT))
    rng = np.random.default_rng(5)
    r = rng.choice(jkiss.RTABLE, size=(15,) + SIZE)
    ve, vb = jnoise.var_eta(1.3, KT), jnoise.var_bulk(0.9, KT)
    got = tnoise.stress_from_deviates(torch.as_tensor(r[:6]), ve, vb)
    want = jnoise.stress_from_deviates(jnp.asarray(r[:6]), ve, vb)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    vg = jnoise.var_ghost(jmodel, rtg, KT)
    got = tnoise.ghost_from_deviates(torch.as_tensor(r[6:]), model, vg)
    want = jnoise.ghost_from_deviates(jnp.asarray(r[6:]), jmodel, vg)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def _cfgs(dtype="float64", **kw):
    base = dict(size=SIZE, nvel=19, eta_shear=0.1, eta_bulk=0.14,
                force_global=(1e-5, 0.0, -2e-5), dtype=dtype,
                noise=jnoise.NoiseConfig(kt=KT, rho=True))
    base.update(kw)
    jcfg = jlb.LBConfig(**base)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    return jcfg, params_from_jax(fields, device="cpu")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ghosts", [True, False])
def test_noise_terms_match_jax(masked, ghosts):
    jcfg, tcfg = _cfgs(ghost_modes_on=ghosts)
    fluid = np.random.default_rng(2).random(SIZE) > 0.25 if masked else None
    jst = jkiss.kiss_init(0, SIZE)
    tst = noise_state_from_jax(np.asarray(jst), device="cpu")
    for t in range(2):
        jsh, jgh, jst = jlb._noise_terms(
            jcfg, jcfg.collision_params(), t, nstate=jst,
            fluid=None if fluid is None else jnp.asarray(fluid))
        tsh, tgh, tst = tlb._noise_terms(
            tcfg, tcfg.collision_params(), t, nstate=tst,
            fluid=None if fluid is None else torch.as_tensor(fluid))
        assert np.array_equal(_words(tst), np.asarray(jst))
        assert tsh.numpy().tobytes() == np.asarray(jsh).tobytes()
        if ghosts:
            assert tgh.numpy().tobytes() == np.asarray(jgh).tobytes()
        else:
            assert tgh is None and jgh is None
    if masked:
        # solid sites: the state did not advance, the deviates are 0
        solid = ~fluid
        init = tkiss.kiss_init(0, SIZE, device="cpu").numpy()
        assert np.array_equal(tst.numpy()[:, solid], init[:, solid])
        assert not tsh.numpy()[:, :, solid].any()


def test_collide_hooks_add_noise_where_jax_does():
    """ops/collide.collide adds shat to the post-collision stress and
    ghat to the relaxed (or projected) ghost modes, as ludwig_tpu's
    collide does."""
    rng = np.random.default_rng(11)
    # M10 projects the ghosts out (ghat alone), TRT relaxes them (m_g *
    # coef + ghat)
    for scheme in ("m10", "trt"):
        model, jmodel = lb_model(19), jlb_model(19)
        tp = CollisionParams(model=model, eta_shear=0.1, eta_bulk=0.3,
                             scheme=RelaxationScheme(scheme),
                             force_global=(1e-5, 0.0, 0.0))
        jp = JParams(model=jmodel, eta_shear=0.1, eta_bulk=0.3,
                     scheme=JScheme(scheme), force_global=(1e-5, 0.0, 0.0))
        f = model.wv.reshape(-1, 1, 1, 1) * (
            1.0 + 0.02 * rng.standard_normal((19,) + SIZE))
        shat = 1e-3 * rng.standard_normal((3, 3) + SIZE)
        shat = 0.5 * (shat + shat.transpose(1, 0, 2, 3, 4))
        ghat = 1e-3 * rng.standard_normal((19,) + SIZE)
        ghat[:10] = 0.0
        got = collide(torch.as_tensor(f), tp, shat=torch.as_tensor(shat),
                      ghat=torch.as_tensor(ghat))
        want = jcollide(jnp.asarray(f), jp, shat=jnp.asarray(shat),
                        ghat=jnp.asarray(ghat))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
        quiet = collide(torch.as_tensor(f), tp)[0]
        assert not torch.allclose(got[0], quiet, rtol=0, atol=1e-8)


def _rand_f(jcfg, seed):
    rng = np.random.default_rng(seed)
    f = np.asarray(jlb.initial_rest(jcfg))
    return f * (1.0 + 0.02 * rng.standard_normal(f.shape))


@pytest.mark.parametrize("walls", [False, True])
def test_kiss_make_step_matches_jax(walls):
    """Three steps of the KISS route; with a wall the solid sites keep
    their state and their f (the fluid mask)."""
    wk = dict(walls=(True, False, False)) if walls else {}
    jcfg, tcfg = _cfgs(**wk)
    f0 = _rand_f(jcfg, seed=4)
    jstep = jlb.make_step(jcfg, solid=jlb.solid_mask(jcfg))
    tstep = tlb.make_step(tcfg, solid=tlb.solid_mask(tcfg))
    jst = (jnp.array(f0), jkiss.kiss_init(0, SIZE))
    tst = (state_from_jax(f0, "cpu", "float64"),
           tkiss.kiss_init(0, SIZE, device="cpu"))
    for t in range(3):
        jst, jrho, ju = jstep(jst, t)
        tst, trho, tu = tstep(tst, t)
        assert np.array_equal(_words(tst[1]), np.asarray(jst[1]))
        np.testing.assert_allclose(tst[0].numpy(), np.asarray(jst[0]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL,
                                   atol=ATOL)


def test_kiss_step_conserves_mass_and_momentum():
    """The noise lives in the stress and ghost modes: the totals move
    only by the body force (to f64 roundoff of the sums)."""
    jcfg, tcfg = _cfgs()
    model = tcfg.model
    f = torch.as_tensor(_rand_f(jcfg, seed=6))
    st = (f, tkiss.kiss_init(0, SIZE, device="cpu"))
    cv = torch.as_tensor(np.asarray(model.cv, np.float64))
    m0, g0 = f.sum(), torch.einsum("qxyz,qa->a", f, cv)
    step = tlb.make_step(tcfg)
    for t in range(3):
        st, _rho, _u = step(st, t)
    nsite = float(np.prod(SIZE))
    assert abs(float(st[0].sum() - m0)) < 1e-12 * nsite
    g1 = torch.einsum("qxyz,qa->a", st[0], cv)
    kick = 3 * nsite * torch.tensor(tcfg.force_global, dtype=f.dtype)
    assert float((g1 - g0 - kick).abs().max()) < 1e-12 * nsite
    # and the noise did act: the stress moved away from the quiet step's
    quiet = tlb.make_step(dataclasses.replace(tcfg, noise=None))
    fq = f
    for t in range(3):
        fq, _rho, _u = quiet(fq, t)
    assert float((fq - st[0]).abs().max()) > 1e-6


def test_converter_round_trip():
    jst = jkiss.kiss_init(3, SIZE)
    t = noise_state_from_jax(np.asarray(jst), device="cpu")
    assert t.dtype == torch.int64 and np.array_equal(_words(t),
                                                     np.asarray(jst))
    with pytest.raises(ValueError, match="uint32"):
        noise_state_from_jax(np.asarray(jst).astype(np.int64), device="cpu")
    _jcfg, tcfg = _cfgs()
    assert isinstance(tcfg.noise, tnoise.NoiseConfig)
    assert tcfg.noise.kt == KT and tcfg.noise.rho and tcfg.noise.kiss


def test_threefry_routes_raise():
    """The routes that draw the stateless threefry stream, once refused,
    run: NoiseConfig(kiss=False) is taken, and _noise_terms without a KISS
    state returns the JAX package's threefry terms (stress, then the
    ghosts under seed + 7919)."""
    assert not tnoise.NoiseConfig(kt=KT, rho=True, kiss=False).kiss
    jcfg, tcfg = _cfgs()
    for t in (0, 5):
        jsh, jgh = jlb._noise_terms(jcfg, jcfg.collision_params(), t)
        tsh, tgh = tlb._noise_terms(tcfg, tcfg.collision_params(), t)
        np.testing.assert_allclose(tsh.numpy(), np.asarray(jsh),
                                   rtol=1e-15, atol=0)
        np.testing.assert_allclose(tgh.numpy(), np.asarray(jgh),
                                   rtol=1e-15, atol=0)
