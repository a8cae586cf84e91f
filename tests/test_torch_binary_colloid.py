"""The port's colloids of the binary and two-distribution families
(ludwig_tpu_torch/binary_colloid.py, binary_lb.py's colloid step, the
colloids_fast.py helpers) and the image-free remove/replace of
colloids.py, against ludwig_tpu's, on the CPU.

The same numpy inputs from a seed, D3Q19 in float64 at 12^3 with two
particles of radius 2.3 (N <= 4; one where the JAX reference-order sums
make a step slow) or five of radius 1.8 (N > 4, the segment-sum
routes), go through both packages.  The image-free
remove/replace (periodic, and beside a wall with a site that has no
donor): its distributions bitwise, its per-particle sums (the port's in
site order, the JAX package's jnp.sum in XLA's order) and the reaction
force at rtol 1e-13 / atol 1e-15; bbl_step seeded with deltam / f0_corr
/ t0_corr bitwise (its link chains run in the reference order; the
walls' momentum, a whole-lattice sum, at rtol 1e-13).  The
colloids_fast helpers, the per-particle phi bookkeeping (conserve on and
off) and three chained steps of each route (N <= 4 and N > 4, periodic
and walled, wetting C and H non-zero) at rtol 1e-10 / atol 1e-12.  The
JAX steps run eagerly (their jitted bodies, unwrapped)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import binary_colloid as jbc
from ludwig_tpu import binary_lb as jbl
from ludwig_tpu import colloids as jc
from ludwig_tpu import colloids_fast as jcf
from ludwig_tpu.binary import BinaryConfig as JBC
from ludwig_tpu.fe.symmetric import SymmetricFE as JFE
from ludwig_tpu.lattice import lb_model as jlb_model
from ludwig_tpu.lb import LBConfig as JLB
from ludwig_tpu.ops.walls import WallSpec as JW
from ludwig_tpu_torch import binary_colloid as tbc
from ludwig_tpu_torch import binary_lb as tbl
from ludwig_tpu_torch import colloids as tc
from ludwig_tpu_torch import colloids_fast as tcf
from ludwig_tpu_torch import convert
from ludwig_tpu_torch.binary import BinaryConfig as TBC
from ludwig_tpu_torch.fe.symmetric import SymmetricFE as TFE
from ludwig_tpu_torch.lattice import lb_model
from ludwig_tpu_torch.lb import LBConfig as TLB
from ludwig_tpu_torch.ops.walls import WallSpec as TW

S = (12, 12, 12)
MODEL, JMODEL = lb_model(19), jlb_model(19)
TOL = dict(rtol=1e-10, atol=1e-12)
SUMS = dict(rtol=1e-13, atol=1e-15)
FE = dict(a=-0.0625, b=0.0625, kappa=0.04)
ONE = dict(a0=(2.3,), ah=(2.3,))
TWO = dict(a0=(2.3, 2.3), ah=(2.3, 2.3))
R_TWO = np.array([[3.6, 5.2, 4.8], [8.4, 6.3, 7.1]])
FIVE = dict(a0=(1.8,) * 5, ah=(1.8,) * 5)
R_FIVE = np.array([[2.5, 2.5, 3.0], [8.5, 3.5, 2.6], [3.2, 8.6, 7.5],
                   [8.8, 8.4, 8.3], [6.0, 5.7, 9.9]])
MOVE = np.array([0.6, -0.5, 0.7])


def T(a):
    return torch.as_tensor(np.asarray(a))


def bitwise(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _maps(kw, R, R2, fast=False):
    """(pid_old, inside_old, pid_new, inside_new) of the JAX maps, numpy."""
    build = jcf.build_map_fast if fast else jc.build_map
    jp = jc.ColloidParams(**kw)
    po, io_ = build(jnp.asarray(R), jp, S)
    pn, in_ = build(jnp.asarray(R2), jp, S)
    return [np.asarray(x) for x in (po, io_, pn, in_)]


def _f(seed=1):
    return 1.0 / 19 + 1e-3 * np.random.RandomState(seed).standard_normal(
        (19,) + S)


WALL_CASES = {"periodic": (False, False, False), "wall-z": (False, False, True)}


def _rr_case(walls):
    """Two particles moved; beside a wall on z the first sits on it and
    moves off, leaving sites whose neighbours were all solid or across the
    wall (no donor)."""
    R = R_TWO.copy()
    R2 = R + MOVE
    if walls[2]:
        R[0] = [5.5, 5.5, 0.6]
        R2[0] = [5.5, 5.5, 2.4]
    rng = np.random.RandomState(3)
    return (R, R2, 0.01 * rng.standard_normal((2, 3)),
            0.01 * rng.standard_normal((2, 3)))


@pytest.mark.parametrize("name", list(WALL_CASES))
def test_remove_replace_image_free_bitwise(name):
    walls = WALL_CASES[name]
    R, R2, V, W = _rr_case(walls)
    po, io_, pn, in_ = _maps(TWO, R, R2)
    f = _f()
    want = jc.remove_replace(jnp.asarray(f), jnp.asarray(R2), jnp.asarray(V),
                             jnp.asarray(W), jnp.asarray(io_),
                             jnp.asarray(po), jnp.asarray(in_),
                             jnp.asarray(pn), JMODEL,
                             jc.ColloidParams(**TWO), S, walls=walls)
    got = tc.remove_replace(T(f), T(R2), T(io_), T(po), T(in_), T(pn), MODEL,
                            tc.ColloidParams(**TWO), S, V=T(V), W=T(W),
                            walls=walls)
    assert len(got) == 4
    bitwise(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        close(a, b, SUMS)
    if any(walls):
        _newf, wsum = tc.rr_replacement_field(T(f), T(io_), MODEL, S, walls)
        uncovered = io_ & ~in_
        assert np.any(uncovered & (wsum.numpy() <= 0.0))


def test_bbl_step_with_image_free_seeds_bitwise():
    """The reference-order bounce-back of a rebuild step seeded with the
    image-free deltam, f0_corr, t0_corr (the real copy's pass-1 sums),
    the particles on a wall on z: every output bitwise."""
    walls = (False, False, True)
    R, R2, V, W = (x[:1] for x in _rr_case(walls))
    R2[0, 2] = 1.9                    # still on the wall: wall links
    po, io_, pn, in_ = _maps(ONE, R, R2)
    f = _f(2)
    jp, tp = jc.ColloidParams(**ONE), tc.ColloidParams(**ONE)
    jf, dm, f0c, t0c = jc.remove_replace(
        jnp.asarray(f), jnp.asarray(R2), jnp.asarray(V), jnp.asarray(W),
        jnp.asarray(io_), jnp.asarray(po), jnp.asarray(in_),
        jnp.asarray(pn), JMODEL, jp, S, walls=walls)
    assert float(jnp.max(jnp.abs(dm))) > 0.0
    ext = 1e-4 * np.random.RandomState(4).standard_normal((1, 3))
    want = jc.bbl_step(jf, jnp.asarray(R2), jnp.asarray(V), jnp.asarray(W),
                       JMODEL, jp, S, ext_force=jnp.asarray(ext),
                       deltam=dm, f0_corr=f0c, t0_corr=t0c, walls=walls)
    got = tc.bbl_step(T(jf), T(R2), T(V), T(W), MODEL, tp, S, T(pn), T(in_),
                      ext_force=T(ext), deltam=T(dm), f0_corr=T(f0c),
                      t0_corr=T(t0c), walls=walls)
    assert want[3] is None            # no swimming directions given
    for a, b in zip(got[:3], want[:3]):
        bitwise(a, b)
    # the walls' account: a whole-lattice sum in each package's order
    close(got[4], want[4], SUMS)
    assert float(torch.max(torch.abs(got[4]))) > 0.0


def _stress_case(seed=7):
    rng = np.random.RandomState(seed)
    return rng.standard_normal((3, 3) + S), 0.2 * rng.standard_normal(S)


def test_colloid_fe_force_windows_and_whole_lattice():
    """The per-particle reaction force from the particles' windows and
    from the whole lattice, against the JAX function, beside a wall."""
    pth, _phi = _stress_case()
    _po, _io, pid, inside = _maps(TWO, R_TWO, R_TWO + MOVE)
    want = jbc.colloid_fe_force(jnp.asarray(pth), jnp.asarray(pid),
                                jnp.asarray(inside), JMODEL, 2,
                                walls=(False, False, True))
    for kw in ({}, dict(R=T(R_TWO + MOVE), a0=2.3)):
        got = tbc.colloid_fe_force(T(pth), T(pid), T(inside), MODEL, 2,
                                   walls=(False, False, True), **kw)
        close(got, want, SUMS)


def test_colloid_fe_force_fast():
    pth, _phi = _stress_case(8)
    _po, _io, pid, inside = _maps(FIVE, R_FIVE, R_FIVE + MOVE, fast=True)
    want = jcf.colloid_fe_force_fast(jnp.asarray(pth), jnp.asarray(pid),
                                     jnp.asarray(inside), JMODEL, 5)
    close(tcf.colloid_fe_force_fast(T(pth), T(pid), T(inside), MODEL, 5),
          want)


@pytest.mark.parametrize("conserve", [True, False])
@pytest.mark.parametrize("name", list(WALL_CASES))
def test_phi_remove_replace_conserve(conserve, name):
    walls = WALL_CASES[name]
    R, R2, _V, _W = _rr_case(walls)
    po, io_, pn, in_ = _maps(TWO, R, R2)
    _pth, phi = _stress_case(9)
    want = jbc.phi_remove_replace_conserve(
        jnp.asarray(phi), jnp.asarray(io_), jnp.asarray(in_),
        jnp.asarray(po), jnp.asarray(pn), JMODEL, 2, phi0=0.05,
        conserve=conserve, walls=walls)
    got = tbc.phi_remove_replace_conserve(T(phi), T(io_), T(in_), T(po),
                                          T(pn), MODEL, 2, phi0=0.05,
                                          conserve=conserve, walls=walls)
    close(got, want)
    assert not np.array_equal(got.numpy(), phi)


@pytest.mark.parametrize("conserve", [True, False])
def test_phi_remove_replace_conserve_fast(conserve):
    po, io_, pn, in_ = _maps(FIVE, R_FIVE, R_FIVE + MOVE, fast=True)
    _pth, phi = _stress_case(10)
    want = jcf.phi_remove_replace_conserve_fast(
        jnp.asarray(phi), jnp.asarray(io_), jnp.asarray(in_),
        jnp.asarray(po), jnp.asarray(pn), JMODEL, 5, phi0=-0.1,
        conserve=conserve)
    got = tcf.phi_remove_replace_conserve_fast(T(phi), T(io_), T(in_), T(po),
                                               T(pn), MODEL, 5, phi0=-0.1,
                                               conserve=conserve)
    close(got, want)


def test_remove_replace_fast_divides_as_jax():
    """The segment-sum remove/replace of the binary route, N > 4."""
    po, io_, pn, in_ = _maps(FIVE, R_FIVE, R_FIVE + MOVE, fast=True)
    f = _f(3)
    R2 = R_FIVE + MOVE
    want = jcf.remove_replace_fast(
        jnp.asarray(f), jnp.asarray(R2), None, None, jnp.asarray(io_),
        jnp.asarray(po), jnp.asarray(in_), jnp.asarray(pn), JMODEL,
        jc.ColloidParams(**FIVE), S)
    got = tcf.remove_replace_fast(T(f), T(R2), T(io_), T(po), T(in_), T(pn),
                                  MODEL, tc.ColloidParams(**FIVE), S)
    bitwise(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        close(a, b)


@pytest.mark.parametrize("name", list(WALL_CASES))
def test_nowall_keep(name):
    walls = WALL_CASES[name]
    for q in range(19):
        np.testing.assert_array_equal(
            tcf._nowall_keep(S, MODEL.cv[q], walls),
            np.asarray(jcf._nowall_keep(S, JMODEL.cv[q], walls)))


def _g(seed=11):
    rng = np.random.RandomState(seed)
    g = 0.01 * rng.standard_normal((19,) + S)
    g[0] += 0.3 * rng.standard_normal(S)
    return g


@pytest.mark.parametrize("name", list(WALL_CASES))
def test_g_bbl_fast(name):
    walls = WALL_CASES[name]
    _po, _io, pid, inside = _maps(FIVE, R_FIVE, R_FIVE, fast=True)
    rng = np.random.RandomState(12)
    V, W = 0.01 * rng.standard_normal((5, 3)), 0.01 * rng.standard_normal(
        (5, 3))
    g, dphi = _g(), 0.05 * rng.standard_normal(5)
    phi = g.sum(axis=0)
    want = jcf.g_bbl_fast(jnp.asarray(g), jnp.asarray(phi),
                          jnp.asarray(R_FIVE), jnp.asarray(V),
                          jnp.asarray(W), JMODEL, jc.ColloidParams(**FIVE),
                          S, jnp.asarray(dphi), walls=walls)
    got = tcf.g_bbl_fast(T(g), T(phi), T(R_FIVE), T(V), T(W), MODEL,
                         tc.ColloidParams(**FIVE), S, T(dphi), walls=walls)
    for a, b in zip(got, want):
        close(a, b)


@pytest.mark.parametrize("name", list(WALL_CASES))
def test_g_remove_replace_fast(name):
    walls = WALL_CASES[name]
    R, R2, _V, _W = _rr_case(walls)
    po, io_, pn, in_ = _maps(TWO, R, R2, fast=True)
    g = _g(13)
    want = jcf.g_remove_replace_fast(
        jnp.asarray(g), jnp.asarray(io_), jnp.asarray(in_), jnp.asarray(po),
        jnp.asarray(pn), JMODEL, 2, phi0=0.02, walls=walls)
    got = tcf.g_remove_replace_fast(T(g), T(io_), T(in_), T(po), T(pn),
                                    MODEL, 2, phi0=0.02, walls=walls)
    for a, b in zip(got, want):
        close(a, b)


def _eager(step):
    return inspect.getclosurevars(step).nonlocals["_step"].__wrapped__


# route -> (particles, positions, walls on z, wetting (C, H))
ROUTES = {"one-periodic": (ONE, R_TWO[:1], False, (0.0, 0.0)),
          "two-walled-wetting": (TWO, R_TWO, True, (-0.002, 0.001)),
          "five-periodic": (FIVE, R_FIVE, False, (0.0, 0.0)),
          "five-walled-wetting": (FIVE, R_FIVE, True, (0.003, -0.001))}


def _start(n, seed=21):
    rng = np.random.RandomState(seed)
    return (0.01 * rng.standard_normal((n, 3)),
            0.005 * rng.standard_normal((n, 3)),
            0.2 * np.tanh(rng.standard_normal(S)))


def _chain(jstep, tstep, js, ts, steps=3):
    """Three steps (rebuild_freq 2: rebuild, plain, rebuild) from the same
    state; every leaf and the returned rho, u within TOL."""
    for t in range(steps):
        js, jaux = jstep(js, t, t % 2 == 0)
        ts, taux = tstep(ts, t)
    assert len(ts) == len(js)
    for a, b in zip(list(ts) + list(taux), list(js) + list(jaux)):
        close(a, b)
    return ts


@pytest.mark.parametrize("route", list(ROUTES))
def test_binary_colloid_steps(route):
    kw, R0, walled, wet = ROUTES[route]
    n = len(kw["a0"])
    V0, W0, phi0 = _start(n)
    jl = JLB(size=S, nvel=19, eta_shear=0.1, dtype="float64")
    tl = TLB(size=S, nvel=19, eta_shear=0.1, dtype="float64", device="cpu")
    jb = JBC(lb=jl, fe=JFE(**FE), mobility=0.15, wetting=wet)
    tb = TBC(lb=tl, fe=TFE(**FE), mobility=0.15, wetting=wet)
    kwg = dict(kw, gravity=(0.0, 0.0, -2e-5))
    jp, tp = jc.ColloidParams(**kwg), tc.ColloidParams(**kwg)
    ws = (False, False, True)
    js = jbc.initial_binary_colloid(jb, jp, phi0, R0, V0, W0=W0, dr0=V0)
    ts = tbc.initial_binary_colloid(tb, tp, phi0, R0, V0, W0=W0, dr0=V0,
                                    walls=walled)
    if walled:
        js = js + (jnp.zeros((3,)),)
    jstep = _eager(jbc.make_binary_colloid_step(
        jb, jp, rebuild_freq=2, phi_ref=0.01,
        wallspec=JW(walls=ws) if walled else None))
    tstep = tbc.make_binary_colloid_step(
        tb, tp, rebuild_freq=2, phi_ref=0.01,
        wallspec=TW(walls=ws) if walled else None)
    ts = _chain(jstep, tstep, js, ts)
    assert float(torch.max(torch.abs(ts[2]))) > 0.0


# the JAX symmetric_lb colloid step takes its route from the walls alone
# (the segment sums without, the reference-order BBL beside them), not
# from N: five particles between walls run the two-particle route
LB_ROUTES = {"two-periodic": (TWO, R_TWO, False, (0.0, 0.0)),
             "two-walled-wetting": ROUTES["two-walled-wetting"],
             "five-periodic": ROUTES["five-periodic"]}


@pytest.mark.parametrize("route", list(LB_ROUTES))
def test_binary_lb_colloid_steps(route):
    kw, R0, walled, wet = LB_ROUTES[route]
    n = len(kw["a0"])
    V0, W0, phi0 = _start(n, seed=22)
    jl = JLB(size=S, nvel=19, eta_shear=0.1, dtype="float64")
    tl = TLB(size=S, nvel=19, eta_shear=0.1, dtype="float64", device="cpu")
    jcfg = jbl.BinaryLBConfig(lb=jl, fe=JFE(**FE), mobility=0.15,
                              gradient="3d_27pt_solid")
    tcfg = tbl.BinaryLBConfig(lb=tl, fe=TFE(**FE), mobility=0.15,
                              gradient="3d_27pt_solid")
    jp, tp = jc.ColloidParams(**kw), tc.ColloidParams(**kw)
    ws = (False, False, True)
    js = jbl.initial_binary_lb_colloid(jcfg, jp, phi0, R0, V0, W0=W0,
                                       dr0=V0)
    ts = tbl.initial_binary_lb_colloid(tcfg, tp, phi0, R0, V0, W0=W0,
                                       dr0=V0, walls=walled)
    if walled:
        js = js + (jnp.zeros((3,)),)
    jstep = _eager(jbl.make_binary_lb_colloid_step(
        jcfg, jp, rebuild_freq=2, phi_ref=0.01, wetting=wet,
        wallspec=JW(walls=ws) if walled else None))
    tstep = tbl.make_binary_lb_colloid_step(
        tcfg, tp, rebuild_freq=2, phi_ref=0.01, wetting=wet,
        wallspec=TW(walls=ws) if walled else None)
    ts = _chain(jstep, tstep, js, ts)
    assert float(torch.max(torch.abs(ts[9]))) > 0.0     # the deficit


def test_state_converters():
    """The JAX binary, symmetric_lb and electrolyte colloid states, the
    ColloidParams and the charges through convert.py: every leaf bitwise,
    the parameters equal, and a step of the port from the converted
    binary state the port's own."""
    import dataclasses

    from ludwig_tpu import electro as jel
    from ludwig_tpu import electro_colloid as jec
    from ludwig_tpu import electro_sim as jes
    kw = dict(FIVE, gravity=(0.0, 0.0, -1e-5), types=("default",) * 5,
              m=((1.0, 0.0, 0.0),) * 5)
    jp = jc.ColloidParams(**kw)
    tp = convert.colloid_params_from_jax(dataclasses.asdict(jp))
    assert tp == tc.ColloidParams(**kw)
    V0, W0, phi0 = _start(5)
    jl = JLB(size=S, nvel=19, eta_shear=0.1, dtype="float64")
    jb = JBC(lb=jl, fe=JFE(**FE))
    l2 = jbl.BinaryLBConfig(lb=jl, fe=JFE(**FE))
    ecfg = jes.ElectroSimConfig(lb=jl, ek=jel.ElectroConfig())
    psi0, rho0 = jes.init_uniform(S, 1e-3)
    states = {
        convert.binary_colloid_state_from_jax: jbc.initial_binary_colloid(
            jb, jp, phi0, R_FIVE, V0, W0=W0, dr0=V0) + (jnp.zeros((3,)),),
        convert.binary_lb_colloid_state_from_jax:
            jbl.initial_binary_lb_colloid(l2, jp, phi0, R_FIVE, V0),
        convert.electro_colloid_state_from_jax:
            jec.initial_electro_colloid(ecfg, jp, psi0, np.asarray(rho0),
                                        R_FIVE, V0)}
    for fn, js in states.items():
        ts = fn(js, device="cpu")
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            bitwise(a, b)
        with pytest.raises(ValueError, match="leaves"):
            fn(js[:5], device="cpu")
    q = convert.colloid_charges_from_jax(((1.0, 0.5),) * 5, device="cpu")
    assert q.shape == (5, 2) and q.dtype == torch.float64
    tb = TBC(lb=TLB(size=S, nvel=19, eta_shear=0.1, dtype="float64",
                    device="cpu"), fe=TFE(**FE))
    step = tbc.make_binary_colloid_step(tb, tp)
    conv = convert.binary_colloid_state_from_jax(
        states[convert.binary_colloid_state_from_jax][:11], device="cpu")
    own = tbc.initial_binary_colloid(tb, tp, phi0, R_FIVE, V0, W0=W0, dr0=V0)
    for a, b in zip(step(conv, 0)[0], step(own, 0)[0]):
        bitwise(a, b)
