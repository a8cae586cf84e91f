"""The layout arithmetic of the n-step and SOR kernels, as pure functions.

The n-step kernel marches along x with two planes of ring a level
(ops/_cuda.py nstep_layout); the SOR kernel picks on-chip bricks, an
in-place colour sweep or the two-buffer sweep (ops/_cuda.py sor_layout).
Both choices are made in Python, so they are held here on the CPU; the
kernels themselves are held on the card by chip_smoke.py.  The in-place
SOR route's exactness is shown with a torch half-sweep that updates
plane by plane: bitwise the twin's two-buffer half-sweep where every
extent is even, and not at an odd X."""

import numpy as np
import pytest
import torch

from ludwig_tpu_torch.lattice import lb_model
from ludwig_tpu_torch.ops import _cuda, fused
from ludwig_tpu_torch.ops import fused_electro as fe
from ludwig_tpu_torch.ops.collide import CollisionParams

OPTIN = 232_448          # an H100's shared memory a block can opt into
SMS = 132                # an H100 SXM's multiprocessors
ITEMSIZE = {"float32": 4, "float64": 8}


def _windows(BY, BZ, nsteps):
    """Sites of the windows of levels 1..n-1, counted one by one."""
    return sum(len(range(-h, BY + h)) * len(range(-h, BZ + h))
               for h in range(1, nsteps))


@pytest.mark.parametrize("nsteps", range(1, fused.NSTEPS_MAX + 1))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("tile", [(16, 32), (8, 32), (16, 64)])
def test_nstep_ring_bytes(nsteps, dtype, tile):
    """Two planes of nvel values a window site and level (2 + c_x slots
    per velocity), against the opt-in: a plan whose rings fit runs as it
    is, in shared memory; one whose rings do not is narrowed or goes to
    global scratch."""
    isz = ITEMSIZE[dtype]
    model = lb_model(19)
    depths = _cuda.ring_depths(model)
    assert sum(depths) == 2 * model.nvel == 38
    ring = _cuda.nstep_ring_bytes(19, nsteps, *tile, isz)
    assert ring == sum(depths) * isz * _windows(*tile, nsteps)
    plan = fused.FusedPlan(32, *tile)
    lay = _cuda.nstep_layout(19, nsteps, plan, isz, OPTIN)
    if ring <= OPTIN:
        assert (lay.route, lay.plan, lay.ring_bytes) == ("shared", plan,
                                                         ring)
    else:
        assert ((lay.plan.BY, lay.plan.BZ) != tile
                or lay.route == "global")
    assert (lay.route == "shared") == (lay.ring_bytes <= OPTIN)
    # two f32 blocks an SM where their rings fit side by side
    two = lay.route == "shared" and 2 * (lay.ring_bytes + 1024) <= OPTIN
    assert lay.threads == (256 if isz == 8 or two else 512)


@pytest.mark.parametrize("nsteps, route, BY, BZ, threads", [
    (2, "shared", 16, 64, 512), (3, "shared", 8, 64, 512),
    (4, "shared", 8, 32, 512), (6, "global", 8, 32, 512)])
def test_nstep_layout_at_256_f32(nsteps, route, BY, BZ, threads):
    """The default plan at 256^3 f32: n = 2 keeps the 16x64 tile in
    shared memory (180,576 B of rings), n = 3 fits narrowed to 8x64
    (224,352 B), n = 4 narrowed to 8x32 (198,208 B), n = 6 fits no tile
    of at least 8x32."""
    assert _cuda.SMEM_OPTIN_H100 == OPTIN
    lay = _cuda.nstep_layout(19, nsteps, fused.FusedPlan(), 4, OPTIN)
    assert (lay.route, lay.plan.BY, lay.plan.BZ, lay.threads) == (
        route, BY, BZ, threads)
    assert lay.plan.BX == fused.FusedPlan().BX
    assert {2: 180_576, 3: 224_352, 4: 198_208}.get(
        nsteps, lay.ring_bytes) == lay.ring_bytes


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_nstep_route_for_every_n(dtype):
    """Every n in 1..8 has a route; f64 from n = 3 and f32 from n = 5
    fit no tile of at least 8x32 and take the global scratch."""
    first_global = {"float32": 5, "float64": 3}[dtype]
    for n in range(1, fused.NSTEPS_MAX + 1):
        lay = _cuda.nstep_layout(19, n, fused.FusedPlan(), ITEMSIZE[dtype],
                                 OPTIN)
        assert lay.route == ("global" if n >= first_global else "shared")
        assert lay.plan.BY >= _cuda.NSTEP_MIN_BY
        assert lay.plan.BZ >= _cuda.NSTEP_MIN_BZ
        if n == 1:
            assert lay.ring_bytes == 0      # level 0 writes fout itself


@pytest.mark.parametrize("nsteps", [3, 5])
def test_fusedn_twin_on_a_narrowed_tile(nsteps):
    """Where the launcher narrows BY, the twin tiles the same way and
    stays bitwise n single steps (f64: 16x32 narrows to 8x32)."""
    rng = np.random.default_rng(nsteps)
    model = lb_model(19)
    w = model.wv.reshape(-1, 1, 1, 1)
    f = torch.as_tensor(w * (1.0 + 0.05 * rng.standard_normal(
        (19, 6, 20, 12))))
    params = CollisionParams(model=model, eta_shear=0.1, eta_bulk=0.1,
                             force_global=(1e-5, 0.0, 0.0))
    plan = fused.FusedPlan(4, 16, 32)
    assert _cuda.nstep_layout(19, nsteps, plan, 8).plan.BY == 8
    ref = fused.make_fused_nstep(model, params, delta=False)(f, nsteps)
    out = fused.fusedn_step(f, model, params, nsteps, plan)
    assert torch.equal(out, ref)


def _inplace_half(p, rhs, mask, omega, eps, denom):
    """A half-sweep that updates psi in place, plane by plane in x order:
    a site reads every neighbour as it is then, updated or not."""
    p = p.clone()
    X = p.shape[0]
    for x in range(X):
        pl = p[x]
        nb = p[(x - 1) % X] + p[(x + 1) % X]
        nb = nb + torch.roll(pl, 1, 0) + torch.roll(pl, -1, 0)
        nb = nb + torch.roll(pl, 1, 1) + torch.roll(pl, -1, 1)
        res = eps * (nb - 6.0 * pl) + rhs[x]
        p[x] = torch.where(mask[x], pl + omega * res / denom, pl)
    return p


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(16, 16, 32), (15, 16, 32)],
                         ids=["even", "odd-x"])
def test_inplace_half_sweep_is_the_two_buffer_one(dtype, shape):
    """Every extent even: each neighbour of a site, across the wraps
    too, has the other colour, so the in-place half-sweep reads the
    pre-sweep field and equals the twin's two-buffer half-sweep bitwise.
    At X = 15, x = 0 and x = 14 share a colour across the wrap, and the
    in-place sweep reads an updated neighbour."""
    rng = np.random.default_rng(3)
    p = torch.as_tensor(1e-3 * rng.standard_normal(shape), dtype=dtype)
    rhs = torch.as_tensor(1e-4 * rng.standard_normal(shape), dtype=dtype)
    eps = 3.3e3
    denom = torch.tensor(6.0 * eps, dtype=dtype)
    om = torch.as_tensor(fe._omega_table(shape[0], shape[2], 4),
                         dtype=dtype)
    red = fe.red_mask(shape, "cpu")
    for colour, mask in enumerate((red, ~red)):
        omega = om[1, colour]
        two, _res2 = fe._sor_half_plain(p, rhs, mask, omega, eps, denom)
        one = _inplace_half(p, rhs, mask, omega, eps, denom)
        assert torch.equal(one, two) == (shape[0] % 2 == 0)


@pytest.mark.parametrize("shape, itemsize, route, brick", [
    ((128, 128, 128), 4, "on-chip", (8, 16)),
    ((64, 64, 64), 8, "on-chip", (4, 8)),
    ((48, 48, 48), 4, "in-place", (3, 6)),
    ((16, 16, 32), 8, "in-place", (1, 2)),
    ((128, 128, 128), 8, "in-place", None),
    ((256, 256, 256), 4, "in-place", None),
    ((15, 16, 32), 4, "two-buffer", None),
    ((16, 16, 31), 8, "two-buffer", None)])
def test_sor_route(shape, itemsize, route, brick):
    """Even shapes of at least 64^3 sites whose psi and rhs fit 132
    blocks of shared memory stay on chip (128^3 f32: 128 bricks of
    8x16x128, 157,696 B each); smaller and larger even ones sweep in
    place, an odd extent takes two buffers.  `brick` is the on-chip
    brick where the route fits, picked or forced (None: it does not)."""
    lay = _cuda.sor_layout(shape, itemsize, SMS, OPTIN)
    assert lay.route == route
    if brick is None:
        return
    chip = _cuda.sor_layout(shape, itemsize, SMS, OPTIN, route="on-chip")
    assert (chip.route, chip.bx, chip.by) == ("on-chip", *brick)
    assert chip.blocks(shape) <= SMS
    assert chip.smem == _cuda.sor_brick_bytes(*brick, shape[2], itemsize)
    assert chip.smem <= OPTIN
    if route == "on-chip":
        assert lay == chip
    else:
        assert shape[0] * shape[1] * shape[2] < _cuda.SOR_CHIP_MIN_SITES


def test_sor_route_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="even extents"):
        _cuda.sor_layout((15, 16, 32), 4, SMS, OPTIN, route="in-place")
    with pytest.raises(ValueError, match="do not fit"):
        _cuda.sor_layout((256, 256, 256), 4, SMS, OPTIN, route="on-chip")
    with pytest.raises(ValueError, match="int32"):
        _cuda.sor_layout((2048, 1024, 1026), 4, SMS, OPTIN)
    with pytest.raises(ValueError, match="no SOR route"):
        _cuda.sor_layout((16, 16, 32), 4, SMS, OPTIN, route="fast")
    # forced routes an even shape admits
    for route in _cuda.SOR_ROUTES:
        assert _cuda.sor_layout((16, 16, 32), 4, SMS, OPTIN,
                                route=route).route == route
