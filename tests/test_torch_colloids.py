"""The port's resolved colloids (ludwig_tpu_torch/colloids.py,
colloids_fast.py) against ludwig_tpu's, on the CPU.

The same numpy inputs from a seed, 16^3 D3Q19 with 2-6 particles of
radius 2.3, go through both packages.  In float64 the reference-order
route is held bitwise: the map builders (pid and inside identical, ties
to the lower index), the per-image remove/replace seeds, bbl_step with
squirmers and colloid-wall links against the JAX per-particle bbl_step
and against its batched exact route, and make_colloid_step chains of 4
steps (rebuild_freq 1 and 2) against the JAX step run op by op.  The
segment-sum route is held to the JAX bbl_step_mxu and remove_replace_fast
at rtol 1e-11 / atol 1e-14 in float64 (tests/test_colloids_fast.py:127's
bound) and its float32 chains at rtol 1e-5 / atol 1e-6 of the JAX float32
route (which the test configuration's x64 promotes to float64 after the
first step).  The wall chains hold the walls' momentum at rtol 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import colloids as jc
from ludwig_tpu import colloids_fast as jcf
from ludwig_tpu.lb import LBConfig as JLBConfig
from ludwig_tpu.lb import initial_rest as jrest
from ludwig_tpu.ops.walls import WallSpec as JWallSpec
from ludwig_tpu_torch import colloids as tc
from ludwig_tpu_torch import colloids_fast as tcf
from ludwig_tpu_torch.lattice import lb_model
from ludwig_tpu_torch.lb import LBConfig
from ludwig_tpu_torch.ops.walls import WallSpec

SIZE = (16, 16, 16)
MODEL = lb_model(19)
F32 = dict(rtol=1e-5, atol=1e-6)
SEG = dict(rtol=1e-11, atol=1e-14)


def T(a):
    return torch.as_tensor(np.array(a))


def setup(n=3, active=False, seed=5, wall_x=None):
    """(kwargs of ColloidParams, f, R, V, W, M) from a numpy seed; with
    wall_x the first particle sits at that x next to a wall."""
    rng = np.random.RandomState(seed)
    R = rng.uniform(3, 13, (n, 3))
    if wall_x is not None:
        R[0, 0] = wall_x
    V = 0.01 * rng.standard_normal((n, 3))
    W = 0.005 * rng.standard_normal((n, 3))
    kw = dict(a0=(2.3,) * n, ah=(2.3,) * n)
    m = np.tile([1.0, 0.0, 0.0], (n, 1))
    if active:
        m = rng.standard_normal((n, 3))
        m /= np.linalg.norm(m, axis=1, keepdims=True)
        kw.update(b1=(0.02,) * n, b2=(0.01,) * n, m=tuple(map(tuple, m)),
                  types=("active",) * n)
    f = (np.asarray(jrest(JLBConfig(size=SIZE, nvel=19, dtype="float64")))
         + 1e-3 * rng.standard_normal((19,) + SIZE))
    return kw, f, R, V, W, m


def assert_bitwise(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_build_map_identical_ties_to_lower_index():
    """Both arithmetics against the JAX builders they replace, on random
    overlapping spheres and on two spheres a lattice vector apart, whose
    equidistant sites go to the lower index."""
    kw, _f, R, *_ = setup(n=8, seed=11)
    jp, tp = jc.ColloidParams(**kw), tc.ColloidParams(**kw)
    pairs = ((jc.build_map, "min_image"), (jcf.build_map_fast, "window"))
    tie = np.array([[6.0, 8.0, 8.0], [10.0, 8.0, 8.0]])
    tkw = dict(a0=(2.3, 2.3), ah=(2.3, 2.3))
    for jfn, arith in pairs:
        for pos, jpar, tpar in ((R, jp, tp), (tie, jc.ColloidParams(**tkw),
                                              tc.ColloidParams(**tkw))):
            pj, ij = jfn(jnp.asarray(pos), jpar, SIZE)
            pt, it = tc.build_map(T(pos), tpar, SIZE, arith)
            assert_bitwise(pj, pt)
            assert_bitwise(ij, it)
    # equidistant sites (x = 8) exist and belong to particle 0
    _p, _i = tc.build_map(T(tie), tc.ColloidParams(**tkw), SIZE)
    assert _p[8, 8, 8] == 0
    # the pillar builder of the float32 route: the min-image arithmetic
    pj, ij = jcf.build_map_cubes(jnp.asarray(R, jnp.float32), jp, SIZE)
    pt, _it = tc.build_map(T(R.astype(np.float32)), tp, SIZE, "min_image")
    assert_bitwise(pj, pt)


@pytest.fixture(scope="module")
def moved():
    """A map at R, one at R moved, and the JAX remove/replace seeds."""
    kw, f, R, V, W, _m = setup(n=3)
    jp = jc.ColloidParams(**kw)
    R2 = R + np.array([[0.4, -0.3, 0.2]] * 3)
    po, io_ = jc.build_map(jnp.asarray(R), jp, SIZE)
    pn, in_ = jc.build_map(jnp.asarray(R2), jp, SIZE)
    f1, seeds = jc.remove_replace(jnp.asarray(f), jnp.asarray(R2),
                                  jnp.asarray(V), jnp.asarray(W), io_, po,
                                  in_, pn, JLBConfig(size=SIZE).model, jp,
                                  SIZE, per_image=True)
    return dict(kw=kw, f=f, R2=R2, V=V, W=W, maps=(po, io_, pn, in_),
                f1=f1, seeds=seeds)


def test_remove_replace_per_image_bitwise(moved):
    po, io_, pn, in_ = (T(x) for x in moved["maps"])
    f1, seeds = tc.remove_replace(T(moved["f"]), T(moved["R2"]), io_, po,
                                  in_, pn, MODEL,
                                  tc.ColloidParams(**moved["kw"]), SIZE,
                                  per_image=True)
    assert_bitwise(moved["f1"], f1)
    assert_bitwise(moved["seeds"], seeds)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_remove_replace_fast(moved, dtype):
    """The segment-sum remove/replace against the JAX one (float64
    within SEG, float32 within F32 of the JAX float32 call)."""
    dt = np.float64 if dtype == "float64" else np.float32
    kw = moved["kw"]
    mj = [jnp.asarray(np.asarray(x)) for x in moved["maps"]]
    a = jcf.remove_replace_fast(
        jnp.asarray(moved["f"].astype(dt)), jnp.asarray(moved["R2"].astype(dt)),
        jnp.asarray(moved["V"]), jnp.asarray(moved["W"]), mj[1], mj[0],
        mj[3], mj[2], JLBConfig(size=SIZE).model, jc.ColloidParams(**kw),
        SIZE)
    mt = [T(x) for x in moved["maps"]]
    b = tcf.remove_replace_fast(
        T(moved["f"].astype(dt)), T(moved["R2"].astype(dt)), mt[1], mt[0],
        mt[3], mt[2], MODEL, tc.ColloidParams(**kw), SIZE)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x),
                                   **(SEG if dtype == "float64" else F32))


# the passive case is the chains' (below) and the exact route's
BBL_CASES = {"squirmers": dict(active=True),
             "walls": dict(wall_x=1.6, walls=(True, False, False))}


@pytest.mark.parametrize("case", list(BBL_CASES))
def test_bbl_step_bitwise_and_segment_sums(case):
    """The reference-order BBL bitwise the JAX per-particle bbl_step (with
    the remove/replace seeds; squirmers; colloid-wall links and the wall
    lubrication drag), and the segment-sum BBL within SEG of the JAX
    bbl_step_mxu on the same inputs."""
    spec = dict(BBL_CASES[case])
    walls = spec.pop("walls", (False, False, False))
    kw, f, R, V, W, m = setup(n=3, **spec)
    jp, tp = jc.ColloidParams(**kw), tc.ColloidParams(**kw)
    jmodel = JLBConfig(size=SIZE).model
    pid, inside = jc.build_map(jnp.asarray(R), jp, SIZE)
    rng = np.random.RandomState(7)
    ext = rng.uniform(-1e-3, 1e-3, (3, 3))
    ext_t = rng.uniform(-1e-4, 1e-4, (3, 3))
    dwall = rng.uniform(-1e-2, 0.0, (3, 3)) if any(walls) else None
    seeds = np.asarray(rng.uniform(-1e-4, 1e-4, (3, 8, 7)))
    args_j = (jnp.asarray(f), jnp.asarray(R), jnp.asarray(V), jnp.asarray(W),
              jmodel, jp, SIZE)
    a = jc.bbl_step(*args_j, ext_force=jnp.asarray(ext),
                    ext_torque=jnp.asarray(ext_t), rr_seeds=jnp.asarray(seeds),
                    M=jnp.asarray(m), walls=walls,
                    wall_drag=None if dwall is None else jnp.asarray(dwall))
    b = tc.bbl_step(T(f), T(R), T(V), T(W), MODEL, tp, SIZE, T(pid),
                    T(inside), ext_force=T(ext), ext_torque=T(ext_t),
                    rr_seeds=T(seeds), M=T(m), walls=walls,
                    wall_drag=None if dwall is None else T(dwall))
    for x, y in zip(a, b):
        assert_bitwise(x, y)
    if any(walls):
        assert np.any(np.asarray(a[4]) != 0.0)     # wall links were there
    c = jcf.bbl_step_mxu(*args_j, ext_force=jnp.asarray(ext),
                         ext_torque=jnp.asarray(ext_t), M=jnp.asarray(m),
                         walls=walls, deltam=jnp.asarray(seeds[:, 0, 0]),
                         wall_drag=None if dwall is None
                         else jnp.asarray(dwall))
    d = tcf.bbl_step_seg(T(f), T(R), T(V), T(W), MODEL, tp, SIZE, T(pid),
                         T(inside), ext_force=T(ext), ext_torque=T(ext_t),
                         M=T(m), walls=walls, deltam=T(seeds[:, 0, 0]),
                         wall_drag=None if dwall is None else T(dwall))
    for x, y in zip(c, d):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), **SEG)


def test_bbl_exact_route_bitwise():
    """n = 6 passive with seeds: the port's reference-order BBL bitwise
    the JAX batched exact route (bbl_step_exact)."""
    kw, f, R, V, W, m = setup(n=6, seed=9)
    jp, tp = jc.ColloidParams(**kw), tc.ColloidParams(**kw)
    pid, inside = jcf.build_map_fast(jnp.asarray(R), jp, SIZE)
    seeds = np.random.RandomState(4).uniform(-1e-4, 1e-4, (6, 8, 7))
    ext = np.random.RandomState(3).uniform(-1e-3, 1e-3, (6, 3))
    a = jcf.bbl_step_exact(jnp.asarray(f), jnp.asarray(R), jnp.asarray(V),
                           jnp.asarray(W), JLBConfig(size=SIZE).model, jp,
                           SIZE, ext_force=jnp.asarray(ext),
                           rr_seeds=jnp.asarray(seeds), M=jnp.asarray(m),
                           pid_inside=(pid, inside))
    b = tc.bbl_step(T(f), T(R), T(V), T(W), MODEL, tp, SIZE, T(pid),
                    T(inside), ext_force=T(ext), rr_seeds=T(seeds), M=T(m))
    for x, y in zip(a[:4], b[:4]):
        assert_bitwise(x, y)


def _unjitted(step):
    """The JAX step's traced function, to run op by op (no XLA compile)."""
    cells = dict(zip(step.__code__.co_freevars, step.__closure__))
    return cells["_call"].cell_contents.__wrapped__


def run_chains(n, dtype, rebuild_freq=1, walls=None, active=False,
               nsteps=4):
    """(JAX state, port state, port step) after nsteps from the same
    start: moving particles (dr set), gravity; with walls a particle at
    x = 1.6, wall_ss_cut and the wall lubrication."""
    kw, f, R, V, W, m = setup(n=n, active=active, seed=5,
                              wall_x=1.6 if walls else None)
    kw["gravity"] = (0.0, 0.0, -1e-4)
    dr = 0.3 * np.random.RandomState(6).standard_normal((n, 3))
    dt = np.float64 if dtype == "float64" else np.float32
    leaves = [f, R, V, W, dr, R, m]
    js = jc.ColloidState(*[jnp.asarray(a.astype(dt)) for a in leaves])
    ts = tc.ColloidState(*[torch.as_tensor(a.astype(dt)) for a in leaves])
    extra = {}
    if walls:
        js = js._replace(gwall=jnp.zeros(3, dt))
        extra = dict(lubr_rc=(0.5,) * 3, lubr_dh=(0.1,) * 3,
                     wall_ss=dict(epsilon=1e-3, sigma=0.1, nu=1.0, hc=0.5))
    jstep = jc.make_colloid_step(
        JLBConfig(size=SIZE, nvel=19, eta_shear=0.1, dtype=dtype),
        jc.ColloidParams(**kw), rebuild_freq=rebuild_freq,
        wallspec=JWallSpec(walls=walls) if walls else None, **extra)
    tstep = tc.make_colloid_step(
        LBConfig(size=SIZE, nvel=19, eta_shear=0.1, dtype=dtype,
                 device="cpu"),
        tc.ColloidParams(**kw), rebuild_freq=rebuild_freq,
        wallspec=WallSpec(walls=walls) if walls else None, **extra)
    raw = _unjitted(jstep)
    js = jstep.prepare(js)
    for t in range(1, nsteps + 1):
        js, _ = raw(js, t, t % rebuild_freq == 0)
        js = jstep.prepare(js)
        ts, _ = tstep(ts, t)
    return js, ts, tstep


CHAINS = {"f64-n2-rebuild1": (2, "float64", 1, None, False),
          "f64-n2-rebuild2": (2, "float64", 2, None, False),
          "f64-n2-walls": (2, "float64", 1, (True, False, False), False)}


@pytest.mark.parametrize("name", list(CHAINS))
def test_colloid_step_chain_bitwise(name):
    """4 steps on the reference-order route: f, R, V, W, dr, Rmap, M and
    the map bitwise the JAX step's; with walls, gwall at rtol 1e-12 (the
    JAX package sums its wall links with jnp.sum)."""
    n, dtype, rf, walls, active = CHAINS[name]
    js, ts, tstep = run_chains(n, dtype, rf, walls, active)
    assert tstep.route == "ordered"
    for i in range(7):
        assert_bitwise(js[i], ts[i])
    assert_bitwise(js.pmap[0], ts.pmap[0])
    if walls:
        np.testing.assert_allclose(ts.gwall.numpy(), np.asarray(js.gwall),
                                   rtol=1e-12, atol=1e-15)


def test_colloid_state_from_jax():
    """convert.colloid_state_from_jax carries a JAX ColloidState with its
    map cache into the port's: the leaves bitwise, the map dropped and
    rebuilt identical by the step's prepare."""
    from ludwig_tpu_torch.convert import colloid_state_from_jax
    kw, f, R, V, W, m = setup(n=2)
    leaves = [jnp.asarray(a) for a in (f, R, V, W, 0.5 * V, R, m)]
    pid, inside = jc.build_map(leaves[5], jc.ColloidParams(**kw), SIZE)
    js = jc.ColloidState(*leaves, pmap=(pid, inside, None))
    got = colloid_state_from_jax(tuple(js), device="cpu")
    assert got.pmap is None and got.gwall is None
    for i in range(7):
        assert_bitwise(js[i], got[i])
    tstep = tc.make_colloid_step(
        LBConfig(size=SIZE, nvel=19, eta_shear=0.1, dtype="float64",
                 device="cpu"), tc.ColloidParams(**kw))
    assert_bitwise(pid, tstep.prepare(got).pmap[0])


def test_solves_bitwise():
    """The batched 6x6 solves bitwise the JAX package's: solve6 (partial
    pivoting with swaps, the segment-sum route's) and gauss_solve6_ref
    (the reference's ipivot order, the reference-order route's)."""
    import jax
    rng = np.random.RandomState(0)
    A = rng.standard_normal((40, 6, 6)) + 0.3 * np.eye(6)
    b = rng.standard_normal((40, 6))
    for jfn, tfn in ((jc.solve6, tc.solve6),
                     (jc.gauss_solve6_ref, tc.gauss_solve6_ref)):
        assert_bitwise(jax.vmap(jfn)(jnp.asarray(A), jnp.asarray(b)),
                       tfn(T(A), T(b)))
