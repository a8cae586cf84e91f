"""The x-march of the binary, liquid-crystal and droplet K1 kernels, on
the CPU.

csrc/k1_march.cuh marches a block along x over a y-z tile, evaluates
level 1 once per site of the cross-shaped window the site update reads,
and keeps only what crosses sites; ops/_cuda.py k1_layout picks its
tile, segment and threads.  What the kernels read comes from the traces
their code is generated from (ops/_cuda.py k1_reads), so it is held here
against the hand list; the layout is a pure function, held over both
kernels, both dtypes and ragged shapes; and a torch march that keeps
exactly the march's buffers is bitwise the whole-tensor twins
(ops/fused_binary.py _binary_phi_force_plain, ops/fused_lc.py
_lc_q_force_plain, ops/fused_droplet.py _droplet_plain), which shows
that the buffers hold everything the site update reads.  The kernels
themselves are held on the card by chip_smoke.py (phases 7, 9, 10, 12,
13, 15)."""

import math

import numpy as np
import pytest
import torch

from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE, q33_to_q5
from ludwig_tpu_torch.fe.lc_droplet import LCDropletFE
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.ops import _cuda
from ludwig_tpu_torch.ops import fused_binary as fb
from ludwig_tpu_torch.ops import fused_droplet as fd
from ludwig_tpu_torch.ops import fused_lc as fl

OPTIN = 232_448          # an H100's shared memory a block can opt into
SMS = 132                # an H100 SXM's multiprocessors
ITEMSIZE = {"float32": 4, "float64": 8}
BIN, LC, DROP = _cuda.BINARY_KERNEL, _cuda.LC_KERNEL, _cuda.DROPLET_KERNEL
E = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
LC_FE = dict(a0=0.01, gamma=3.0, q0=0.19635, kappa0=0.000648456,
             kappa1=0.000648456, xi=0.7)


def _drop_fe(w=0.0):
    return LCDropletFE(symm=SymmetricFE(a=-0.0625, b=0.0625, kappa=0.053),
                       lc=BluePhaseFE(a0=0.1, gamma=3.0, q0=0.19635,
                                      kappa0=0.01, kappa1=0.01, xi=0.7),
                       w=w, gamma0=2.586, delta=0.25)


def _pm(e):
    return {e, tuple(-v for v in e)}


FACES = {o for e in E for o in _pm(e)}
STENCIL7 = FACES | {(0, 0, 0)}
STENCIL19 = STENCIL7 | {(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                        for c in (-1, 0, 1) if abs(a) + abs(b) + abs(c) == 2}


@pytest.mark.parametrize("kernel,order", [(LC, 1), (DROP, 1), (DROP, 2),
                                          (BIN, 1), (BIN, 2)])
def test_traced_reads_are_the_hand_list(kernel, order):
    """The site update reads pth[a][ax] only at +-e_ax (every a and ax),
    mu at the site and its six neighbours, the fields and u on the
    7-point stencil, and its own h; level 1 reads Q on the 7-point
    stencil and phi on the 19-point one (d_a d_b phi's edges); the
    binary fluid's level 1 reads phi on the 7-point stencil and its site
    update u_a only along axis a, and no h."""
    site = _cuda.k1_reads(kernel, order)
    lvl = _cuda.k1_reads(kernel, order, level1=True)
    assert site["S"] == {(a, ax) + o for a in range(3)
                         for ax in range(3) for o in _pm(E[ax])}
    if kernel == BIN:    # u_a along its own axis only: no corotation
        assert site["U"] == {(a,) + o for a in range(3)
                             for o in _pm(E[a]) | {(0, 0, 0)}}
        assert set(site) == {"S", "U", "P", "MU"}
        assert site["P"] == site["MU"] == STENCIL7
        assert lvl == {"P": STENCIL7}
        _cuda.k1_check_reads(kernel, order)
        return
    assert site["U"] == {(a,) + o for a in range(3) for o in STENCIL7}
    assert site["Q"] == {(n,) + o for n in range(5) for o in STENCIL7}
    assert lvl["Q"] == {(n,) + o for n in range(5) for o in STENCIL7}
    if kernel == LC:
        assert set(site) == {"S", "U", "Q", "H"}
        assert site["H"] == {(n,) for n in range(5)}
        assert set(lvl) == {"Q"}
    else:
        assert set(site) == {"S", "U", "Q", "P", "MU", "H"}
        assert site["MU"] == STENCIL7
        assert site["P"] == STENCIL7
        assert site["H"] == {(b, c) for b in range(3) for c in range(3)}
        assert set(lvl) == {"P", "Q"}
        assert lvl["P"] == STENCIL19
    _cuda.k1_check_reads(kernel, order)


@pytest.mark.parametrize("kernel", [LC, DROP, BIN])
@pytest.mark.parametrize("tile", [(8, 32), (16, 32), (4, 32), (3, 5)])
def test_k1_buffers_hold_the_traced_reads(kernel, tile):
    """One block's buffers, counted from the reads: five staged planes
    with a halo of 2 (q5, phi and q5, or phi), four u planes with a halo
    of 1, three planes of pth[:,0] on the tile, two of pth[:,1] and
    pth[:,2] on the tile and its faces, two of h (5, 9 or no components),
    three mu planes with a halo of 1 (droplet, binary); the bytes add the
    int32 row and column offsets of the staged window."""
    BY, BZ = tile
    ns, nh = {LC: (5, 5), DROP: (6, 9), BIN: (1, 0)}[kernel]
    want = {"staged": 5 * ns * (BY + 4) * (BZ + 4),
            "u": 4 * 3 * (BY + 2) * (BZ + 2),
            "pth_x": 3 * 3 * BY * BZ,
            "pth_yz": 2 * 3 * ((BY + 2) * BZ + BY * (BZ + 2)),
            "h": 2 * nh * BY * BZ,
            "mu": 0 if kernel == LC else 3 * (BY + 2) * (BZ + 2)}
    assert _cuda.k1_buffers(kernel, BY, BZ) == want
    for isz in (4, 8):
        assert _cuda.k1_smem_bytes(kernel, BY, BZ, isz) == (
            isz * sum(want.values()) + 4 * (BY + BZ + 8))
    assert _cuda.k1_smem_bytes(LC, 8, 32, 4) == 93_376
    assert _cuda.k1_smem_bytes(DROP, 8, 32, 4) == 114_288
    assert _cuda.k1_smem_bytes(BIN, 8, 32, 4) == 52_656


def _windows(shape, BX, BY, BZ):
    """Level-1 evaluations, counted block by block and plane by plane:
    the cross window (tile and faces) on each plane of a segment, the
    tile alone on the plane before it and the plane after it."""
    X, Y, Z = shape
    n = 0
    for _ty in range(0, Y, BY):
        for _tz in range(0, Z, BZ):
            for xs in range(0, X, BX):
                for x in range(xs - 1, min(xs + BX, X) + 1):
                    inner = xs <= x < min(xs + BX, X)
                    n += BY * BZ + (2 * BY + 2 * BZ if inner else 0)
    return n


def _blocks_per_sm(smem, threads, regs):
    """Blocks an H100 SM keeps resident: 233,472 B of shared memory with
    1 KB kept back a block, 65,536 registers in four scheduler files of
    16,384 given out to warps in units of 256, 2,048 threads, 32
    blocks."""
    per_warp = math.ceil(regs * 32 / 256) * 256
    return min(233_472 // (smem + 1024),
               4 * (16_384 // per_warp) // math.ceil(threads / 32),
               2048 // threads, 32)


SHAPES = [(128, 128, 128), (256, 256, 256), (9, 5, 3), (18, 40, 70),
          (33, 17, 100), (16, 24, 40)]


@pytest.mark.parametrize("kernel", [LC, DROP, BIN])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_layout(kernel, dtype, shape):
    """Shared bytes within the opt-in, the blocks an SM as counted here,
    one wave as full as whole segments make it, the evaluations a site as
    counted block by block (and, on a shape the layout divides, the
    formula (BX + 2) / BX + 2 (BY + BZ) / (BY BZ)), segments covering x."""
    isz = ITEMSIZE[dtype]
    cap = min(255, 65_536 // _cuda.K1_MAX_THREADS[isz])
    for regs in (None, 96, 128, 168):
        if regs is not None and regs > cap:
            continue
        lay = _cuda.k1_layout(kernel, shape, isz, SMS, OPTIN, regs)
        r = cap if regs is None else regs
        assert lay.smem == _cuda.k1_smem_bytes(kernel, lay.BY, lay.BZ, isz)
        assert lay.smem <= OPTIN
        assert lay.blocks_per_sm == _blocks_per_sm(lay.smem, lay.threads,
                                                   r) >= 1
        X, Y, Z = shape
        nseg = math.ceil(X / lay.BX)
        assert 1 <= lay.BX <= X and (nseg - 1) * lay.BX < X
        assert lay.blocks == (math.ceil(Y / lay.BY) * math.ceil(Z / lay.BZ)
                              * nseg)
        assert lay.waves == pytest.approx(
            lay.blocks / (SMS * lay.blocks_per_sm))
        # one wave where the tiles leave slots to fill: more segments
        # would not fit it, fewer would leave SMs idle
        slots = SMS * lay.blocks_per_sm
        ntiles = lay.blocks // nseg
        if ntiles <= slots:
            assert lay.waves <= 1
            assert nseg == X or ntiles * (math.ceil(X / (lay.BX - 1))
                                          if lay.BX > 1 else X) > slots
        else:
            assert lay.BX == X
        evals = _windows(shape, lay.BX, lay.BY, lay.BZ)
        assert lay.evals_per_site == pytest.approx(evals / (X * Y * Z),
                                                   rel=1e-15)
        if X % lay.BX == 0 and Y % lay.BY == 0 and Z % lay.BZ == 0:
            assert lay.evals_per_site == pytest.approx(
                (lay.BX + 2) / lay.BX
                + 2 * (lay.BY + lay.BZ) / (lay.BY * lay.BZ), rel=1e-14)


def test_k1_layout_defaults_at_the_main_sizes():
    """f32 at 128^3 and 256^3, each kernel's default plan in one wave:
    LC one 16x32 block of 512 threads an SM (167,392 B), 128 blocks, x in
    4 segments at 128^3 and one at 256^3: 1.25 and 1.1953 evaluations a
    site; droplet two 8x32 blocks of 256 threads an SM (114,288 B), 256
    blocks: 1.375 and 1.3203; against 1.66 for an 8x8x32 box with a
    halo of 1; binary four 8x32 blocks of 128 threads an SM (52,656 B),
    512 blocks, x in 8 and 2 segments: 1.4375 and 1.3281."""
    want = {LC: (16, 512, 1, 167_392, 128, (32, 256), (1.25, 1.1953)),
            DROP: (8, 256, 2, 114_288, 256, (32, 256), (1.375, 1.3203)),
            BIN: (8, 128, 4, 52_656, 512, (16, 128), (1.4375, 1.3281))}
    for kernel, (by, threads, bps, smem, blocks, bx, evals) in want.items():
        lays = [_cuda.k1_layout(kernel, (n,) * 3, 4, SMS, OPTIN)
                for n in (128, 256)]
        for lay, x, e in zip(lays, bx, evals):
            assert (lay.BY, lay.BZ, lay.threads, lay.blocks_per_sm,
                    lay.smem, lay.blocks, lay.BX) == (by, 32, threads, bps,
                                                      smem, blocks, x)
            assert round(lay.evals_per_site, 4) == e


def test_k1_layout_refuses_what_the_kernel_does_not_take():
    P = _cuda.K1Plan
    with pytest.raises(ValueError, match="threads"):
        _cuda.k1_layout(LC, (64,) * 3, 4, SMS, OPTIN, plan=P(8, 544))
    with pytest.raises(ValueError, match="threads"):
        _cuda.k1_layout(LC, (64,) * 3, 8, SMS, OPTIN, plan=P(8, 512))
    with pytest.raises(ValueError, match="threads"):
        _cuda.k1_layout(LC, (64,) * 3, 4, SMS, OPTIN, plan=P(8, 200))
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.k1_layout(DROP, (64,) * 3, 4, SMS, OPTIN, plan=P(32, 256))
    with pytest.raises(ValueError, match="int32"):
        _cuda.k1_layout(LC, (2, 65_536, 65_536), 4, SMS, OPTIN)
    # the default tile on a card with less shared memory than an H100's
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.k1_layout(DROP, (64,) * 3, 8, SMS, 100_000)


# -- a torch march ------------------------------------------------------------

def _cross(BY, BZ):
    """(ly, lz) of the cross window: the tile (row-major), its two y
    faces, its two z faces, as csrc/k1_march.cuh orders them."""
    sites = [(y, z) for y in range(BY) for z in range(BZ)]
    sites += [(-1, z) for z in range(BZ)] + [(BY, z) for z in range(BZ)]
    sites += [(y, z) for y in range(BY) for z in (-1, BZ)]
    return sites


def _march(shape, BX, BY, BZ, level1, site, nout):
    """Run K1 as the march does, plane by plane along each x segment,
    every y-z tile at once: level1(acc) -> {name: value} on window sites
    from acc(field, comp, dx, dy, dz); site(acc, S, MU, H) -> outputs on
    tile sites.  Level-1 values live only in the march's buffers (the x
    ring of pth[:,0] and mu over three planes, pth[:,1], pth[:,2], mu of
    the faces and h for two planes); a read of anything else raises.
    Returns the outputs and the level-1 evaluations made."""
    X, Y, Z = shape
    win = _cross(BY, BZ)
    ni = BY * BZ
    index = {s: k for k, s in enumerate(win)}
    tiles = [(y0, z0) for y0 in range(0, Y, BY) for z0 in range(0, Z, BZ)]
    gy = torch.tensor([[y0 + ly for ly, _ in win] for y0, _ in tiles])
    gz = torch.tensor([[z0 + lz for _, lz in win] for _, z0 in tiles])
    keep = (gy[:, :ni] < Y) & (gz[:, :ni] < Z)
    ty, tz = gy[:, :ni][keep], gz[:, :ni][keep]

    def near(dy, dz):
        return torch.tensor([index[(ly + dy, lz + dz)] for ly in range(BY)
                             for lz in range(BZ)])

    def acc_at(x, sel):
        def acc(field, comp, dx, dy, dz):
            return field[comp][(x + dx) % X, (gy[:, sel] + dy) % Y,
                               (gz[:, sel] + dz) % Z]
        return acc

    out = None
    evals = 0
    for xs in range(0, X, BX):
        xe = min(xs + BX, X)
        ring, bufs = {}, {}

        def evaluate(x, cross):
            nonlocal evals
            sel = slice(None) if cross else slice(0, ni)
            vals = level1(acc_at(x, sel))
            evals += len(tiles) * (len(win) if cross else ni)
            ring[x] = {"pth_x": [v[:, :ni] for v in vals["pth_x"]],
                       "mu": vals.get("mu")}
            ring.pop(x - 3, None)
            if cross:
                bufs[x] = {"pth_y": vals["pth_y"], "pth_z": vals["pth_z"],
                           "h": [v[:, :ni] for v in vals["h"]]}
                bufs.pop(x - 2, None)

        evaluate(xs - 1, False)
        evaluate(xs, True)
        for x in range(xs, xe):
            evaluate(x + 1, x + 1 < xe)
            assert len(ring) <= 3 and len(bufs) <= 2

            def S(a, b, dx, dy, dz, x=x):
                off = (dx, dy, dz)
                assert off in _pm(E[b]), (a, b, off)
                if b == 0:
                    return ring[x + dx]["pth_x"][a]
                key = "pth_y" if b == 1 else "pth_z"
                return bufs[x][key][a][:, near(dy, dz)]

            def MU(dx, dy, dz, x=x):
                assert (dx, dy, dz) in STENCIL7
                if dx:
                    return ring[x + dx]["mu"][:, :ni]
                return ring[x]["mu"][:, near(dy, dz)]

            def H(k, x=x):
                return bufs[x]["h"][k]

            res = site(acc_at(x, slice(0, ni)), S, MU, H)
            if out is None:
                out = [torch.zeros((n,) + shape, dtype=res[0].dtype)
                       for n in nout]
            k = 0
            for o, n in zip(out, nout):
                for c in range(n):
                    o[c][x, ty, tz] = res[k][keep]
                    k += 1
    return out, evals


def _lc_march(q5, u, fe, gamma, BX, BY, BZ):
    def level1(acc):
        h, pth = fl._level1(lambda n, *o: acc(q5, n, *o), fe)
        return {"pth_x": [pth[a][0] for a in range(3)],
                "pth_y": [pth[a][1] for a in range(3)],
                "pth_z": [pth[a][2] for a in range(3)],
                "h": q33_to_q5(h)}

    def site(acc, S, MU, H):
        qnew, force = fl._lc_site(
            lambda n, *o: acc(q5, n, *o), lambda a, *o: acc(u, a, *o), S,
            H, gamma, fe.xi, fl._where_pos)
        return qnew + force

    (q, f), evals = _march(tuple(q5.shape[1:]), BX, BY, BZ, level1, site,
                           (5, 3))
    return q, f, evals


def _drop_march(phi, q5, u, fe, be_gamma, mobility, order, BX, BY, BZ):
    fields = phi[None]

    def P(acc):
        return lambda *o: acc(fields, 0, *o)

    def level1(acc):
        F = fd._fields(P(acc), lambda n, *o: acc(q5, n, *o))
        mu, h, pth = fd._level1(F, fe)
        return {"pth_x": [pth[a][0] for a in range(3)],
                "pth_y": [pth[a][1] for a in range(3)],
                "pth_z": [pth[a][2] for a in range(3)],
                "h": [h[b][c] for b in range(3) for c in range(3)],
                "mu": mu}

    def site(acc, S, MU, H):
        Q = lambda n, *o: acc(q5, n, *o)  # noqa: E731
        F = fd._fields(P(acc), Q, dab=False)
        phinew, qnew, force = fd._droplet_site(
            F, P(acc), Q, lambda a, *o: acc(u, a, *o), MU, S,
            lambda b, c: H(3 * b + c), fe, be_gamma, mobility, order,
            fd._where_pos)
        return [phinew] + qnew + force

    (p, q, f), evals = _march(tuple(phi.shape), BX, BY, BZ, level1, site,
                              (1, 5, 3))
    return p[0], q, f, evals


def _binary_march(phi, u, fe, mobility, order, BX, BY, BZ):
    fields = phi[None]
    c = fb._consts(fe, mobility)

    def P(acc):
        return lambda *o: acc(fields, 0, *o)

    def level1(acc):
        mu, pth = fb._level1_march(P(acc), c)
        return {"pth_x": [pth[a][0] for a in range(3)],
                "pth_y": [pth[a][1] for a in range(3)],
                "pth_z": [pth[a][2] for a in range(3)], "h": [], "mu": mu}

    def site(acc, S, MU, H):
        phinew, force = fb._binary_site(P(acc), lambda a, *o: acc(u, a, *o),
                                        S, MU, c, order, fb._where_pos)
        return [phinew] + force

    (p, f), evals = _march(tuple(phi.shape), BX, BY, BZ, level1, site,
                           (1, 3))
    return p[0], f, evals


def _inputs(shape, dtype, seed=5):
    rng = np.random.default_rng(seed)

    def rnd(s, amp):
        return torch.as_tensor(amp * rng.standard_normal(s), dtype=dtype)
    return rnd(shape, 0.05), rnd((5,) + shape, 0.1), rnd((3,) + shape, 0.01)


MARCH_CASES = [((8, 16, 16), (3, 4, 8)), ((5, 6, 7), (2, 4, 4)),
               ((4, 3, 5), (4, 4, 8))]


@pytest.mark.parametrize("shape,plan", MARCH_CASES)
@pytest.mark.parametrize("extra", [{}, dict(zeta0=0.002, zeta1=0.01),
                                   dict(redshift=0.93)])
def test_lc_torch_march_is_the_twin(shape, plan, extra):
    """The LC march, holding only the march's buffers, is bitwise the
    whole-tensor twin, with as many level-1 evaluations as k1_evals."""
    _phi, q5, u = _inputs(shape, torch.float64)
    fe = BluePhaseFE(**LC_FE, **extra)
    q, f, evals = _lc_march(q5, u, fe, 0.5, *plan)
    want_q, want_f = fl._lc_q_force_plain(q5, u, fe, 0.5)
    assert torch.equal(q, want_q) and torch.equal(f, want_f)
    assert evals == _cuda.k1_evals(shape, *plan)


@pytest.mark.parametrize("shape,plan", MARCH_CASES)
@pytest.mark.parametrize("order,w,dtype", [
    (1, 0.0, torch.float64), (2, 0.02, torch.float64),
    (1, 0.02, torch.float32)])
def test_droplet_torch_march_is_the_twin(shape, plan, order, w, dtype):
    """The droplet march (mu in the x ring and on the faces as well) is
    bitwise the whole-tensor twin, both orders, with and without the
    anchoring W, f64 and f32."""
    phi, q5, u = _inputs(shape, dtype)
    fe = _drop_fe(w)
    p, q, f, evals = _drop_march(phi, q5, u, fe, 0.5, 0.05, order, *plan)
    want = fd._droplet_plain(phi, q5, u, fe, 0.5, 0.05, order)
    for got, ref in zip((p, q, f), want):
        assert torch.equal(got, ref)
    assert evals == _cuda.k1_evals(shape, *plan)


@pytest.mark.parametrize("shape,plan", MARCH_CASES)
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_binary_torch_march_is_the_twin(shape, plan, order, dtype):
    """The binary march (one staged field, mu in the x ring and on the
    faces, no h) is bitwise the whole-tensor twin, both orders, f64 and
    f32, with as many level-1 evaluations as k1_evals."""
    phi, _q5, u = _inputs(shape, dtype)
    fe = SymmetricFE(a=-0.00625, b=0.00625, kappa=0.004)
    p, f, evals = _binary_march(phi, u, fe, 1.25, order, *plan)
    want = fb._binary_phi_force_plain(phi, u, fe, 1.25, order)
    assert torch.equal(p, want[0]) and torch.equal(f, want[1])
    assert evals == _cuda.k1_evals(shape, *plan)


def test_torch_march_refuses_a_read_outside_the_buffers(monkeypatch):
    """A site update reading pth[a][b] off its axis (here pth[0][1] at
    +e_x) finds nothing in the march's buffers."""
    _phi, q5, u = _inputs((4, 4, 4), torch.float64)
    site = fl._lc_site

    def site_off_axis(Q, U, S, H, gamma, xi, select):
        S(0, 1, 1, 0, 0)
        return site(Q, U, S, H, gamma, xi, select)

    monkeypatch.setattr(fl, "_lc_site", site_off_axis)
    with pytest.raises(AssertionError):
        _lc_march(q5, u, BluePhaseFE(**LC_FE), 0.5, 2, 4, 4)
