"""The x-march of the Nernst-Planck + grad-mu kernel, on the CPU.

csrc/electro.cu np_gradmu_kernel gives a block a BY x 32 y-z tile and an
x segment and computes each face flux once: the +x face of a column in
a register carried to the next plane, the +y faces of the tile and its
halo row in shared memory, the +z faces of the tile and its halo column
by warp shuffle.  ops/_cuda.py np_layout picks its tile, segment and
threads and counts its shared bytes and face evaluations; it is a pure
function, held here over shapes, dtypes, species and both hydrodynamics
settings.  A torch march that keeps only what the kernel keeps (three
staged planes with a y-z halo of 1, the carried x faces and psi of the
plane before, one plane's y and halo z faces) is bitwise the
whole-tensor twin (ops/fused_electro.py _np_plain), with as many face
evaluations as the layout counts.  The kernel itself is held on the
card by chip_smoke.py (phases 16 and 18)."""

import itertools
import math

import numpy as np
import pytest
import torch

from ludwig_tpu_torch.ops import _cuda
from ludwig_tpu_torch.ops import fused_electro as fe

OPTIN = 232_448          # an H100's shared memory a block can opt into
SMS = 132                # an H100 SXM's multiprocessors
BZ = 32


def _hand_smem(nk, hydro, BY, isz):
    """Three slots of (psi, the mask, 3 u with hydrodynamics, nk rho) on
    (BY + 2) x 34 sites, nk x (BY + 1) x 32 y faces, nk x BY halo z
    faces, then BY + 2 + 34 int32 offsets."""
    fields = 1 + nk + (3 if hydro else 0) + 1
    return (isz * (3 * fields * (BY + 2) * 34 + nk * ((BY + 1) * 32 + BY))
            + 4 * (BY + 2 + 34))


def _blocks_per_sm(smem, threads, regs):
    """As in tests/test_torch_k1_layout.py: registers come from the four
    schedulers' files of 16,384 each (92 registers and 3 warps: 6 blocks,
    not the 7 that one file of 65,536 would hold)."""
    per_warp = math.ceil(regs * 32 / 256) * 256
    return min(233_472 // (smem + 1024),
               4 * (16_384 // per_warp) // math.ceil(threads / 32),
               2048 // threads, 32)


SHAPES = [(128, 128, 128), (256, 256, 256), (15, 16, 32), (16, 4, 4),
          (8, 16, 16), (5, 6, 7), (1, 3, 40), (33, 17, 100)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("isz", [4, 8])
def test_np_layout(shape, isz):
    """Over nk 1..8, both hydrodynamics settings, register counts and
    tiles (3 rows: three warps a block): the shared bytes of
    the hand count, the blocks an SM as counted here, one wave as full as
    whole segments make it, segments covering x, and the face
    evaluations a site of the formula (BX + 1) / BX + (BY + 1) / BY +
    33 / 32 on a shape the layout divides."""
    X, Y, Z = shape
    cap = {4: 64, 8: 255}[isz]      # the launch bounds' register caps
    for nk, hydro, regs, plan in itertools.product(
            range(1, 9), (True, False), (None, 56, 92),
            (None, _cuda.NpPlan(3), _cuda.NpPlan(4))):
        lay = _cuda.np_layout(shape, nk, hydro, isz, SMS, OPTIN, regs,
                              plan)
        assert lay.threads == lay.BY * BZ
        assert lay.smem == _hand_smem(nk, hydro, lay.BY, isz) <= OPTIN
        assert lay.blocks_per_sm == _blocks_per_sm(
            lay.smem, lay.threads, cap if regs is None else regs) >= 1
        nseg = math.ceil(X / lay.BX)
        assert 1 <= lay.BX <= X and (nseg - 1) * lay.BX < X
        ntiles = math.ceil(Y / lay.BY) * math.ceil(Z / BZ)
        assert lay.blocks == ntiles * nseg
        slots = SMS * lay.blocks_per_sm
        if ntiles <= slots:
            assert lay.waves <= 1
        else:
            assert lay.BX == X
        if X % lay.BX == 0 and Y % lay.BY == 0 and Z % BZ == 0:
            assert lay.faces_per_site == pytest.approx(
                (lay.BX + 1) / lay.BX + (lay.BY + 1) / lay.BY
                + 33 / 32, rel=1e-14)


def test_np_layout_at_the_main_sizes():
    """f32, two species, hydrodynamics: the default 8x32 tile of 256
    threads and 31,104 B; x in segments for one wave; about 3.2 face
    evaluations a site and species against the first kernel's 6."""
    for n in (128, 256):
        lay = _cuda.np_layout((n,) * 3, 2, True, 4, SMS, OPTIN, regs=64)
        assert (lay.BY, lay.threads, lay.smem) == (8, 256, 31_104)
        assert lay.waves <= 1 and lay.blocks_per_sm == 4
        assert 3.1 < lay.faces_per_site < 3.3


def test_np_layout_refuses_what_the_kernel_does_not_take():
    P = _cuda.NpPlan
    for nk in (0, 9):
        with pytest.raises(ValueError, match="species"):
            _cuda.np_layout((16, 16, 16), nk, True, 4, SMS, OPTIN)
    with pytest.raises(ValueError, match="threads"):
        _cuda.np_layout((16, 16, 16), 2, True, 4, SMS, OPTIN, plan=P(32))
    with pytest.raises(ValueError, match="threads"):
        _cuda.np_layout((16, 16, 16), 2, True, 8, SMS, OPTIN, plan=P(16))
    # 64 threads cannot stage a 2x32 tile's 4 x 34 sites two apiece
    with pytest.raises(ValueError, match="BY >= 3"):
        _cuda.np_layout((16, 16, 16), 2, True, 4, SMS, OPTIN, plan=P(2))
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.np_layout((16, 16, 16), 8, True, 8, SMS, 100_000)
    with pytest.raises(ValueError, match="segment"):
        _cuda.np_layout((16, 16, 16), 2, True, 4, SMS, OPTIN, plan=P(8, 0))


# -- a torch march ------------------------------------------------------------

def _np_march(psi, rho, u, fluid, ez, z, c, kt_e, dt, BX, BY):
    """Run the NP kernel as the march does, plane by plane along each x
    segment, every y-z tile at once.  A plane is staged once, on the tile
    and a halo of 1, and at most three are held; each face flux is
    evaluated once (_face_flux, the twin's own expression), the +x face
    carried to the next plane with psi.  Returns (rho', force, the
    blocks' partial sums of the force summed in block order, the face
    evaluations)."""
    X, Y, Z = psi.shape
    nk = rho.shape[0]
    tiles = [(y0, z0) for y0 in range(0, Y, BY) for z0 in range(0, Z, BZ)]
    gy = torch.tensor([[(y0 + r - 1) % Y for r in range(BY + 2)]
                       for y0, _ in tiles])[:, :, None]
    gz = torch.tensor([[(z0 + r - 1) % Z for r in range(BZ + 2)]
                       for _, z0 in tiles])[:, None, :]
    ty = torch.tensor([y0 for y0, _ in tiles])[:, None, None]
    tz = torch.tensor([z0 for _, z0 in tiles])[:, None, None]
    ly = torch.arange(BY)[None, :, None]
    lz = torch.arange(BZ)[None, None, :]
    keep = ((ty + ly) < Y) & ((tz + lz) < Z)
    iy, iz = (ty + ly).expand_as(keep)[keep], (tz + lz).expand_as(keep)[keep]
    fields = [psi] + list(rho) + ([] if u is None else list(u)) + [
        fluid.to(psi.dtype)]
    FR, FU, FM = 1, 1 + nk, len(fields) - 1
    own = (slice(None), slice(1, BY + 1), slice(1, BZ + 1))
    rho_out, force = torch.zeros_like(rho), torch.zeros((3,) + psi.shape,
                                                        dtype=psi.dtype)
    parts, evals = [], 0

    def face(lo, hi, k, axis):
        nonlocal evals
        evals += lo[0].numel()
        uu = (None, None) if u is None else (lo[FU + axis], hi[FU + axis])
        return fe._face_flux(lo[0], hi[0], lo[FR + k], hi[FR + k], *uu,
                             lo[FM] * hi[FM], z[k], c[k])

    def at(plane, sl):
        return [f[sl] for f in plane]

    for xs in range(0, X, BX):
        xe = min(xs + BX, X)
        staged = {}

        def stage(x):
            staged[x] = [f[x % X][gy, gz] for f in fields]
            staged.pop(x - 3, None)
            assert len(staged) <= 3

        stage(xs)
        stage(xs + 1)
        prev = [f[(xs - 1) % X][gy, gz][own] for f in fields]
        psi_prev = prev[0]
        carry = [face(prev, at(staged[xs], own), k, 0) for k in range(nk)]
        fs = torch.zeros((3, len(tiles)), dtype=psi.dtype)
        for x in range(xs, xe):
            if x + 2 <= xe:
                stage(x + 2)
            sc, sn = staged[x], staged[x + 1]
            p = sc[0]
            re = 0.0
            for k in range(nk):
                re = re + ez[k] * sc[FR + k][own]
            e = [-0.5 * (sn[0][own] - psi_prev) * kt_e,
                 -0.5 * (p[:, 2:, 1:-1] - p[:, :-2, 1:-1]) * kt_e,
                 -0.5 * (p[:, 1:-1, 2:] - p[:, 1:-1, :-2]) * kt_e]
            for a in range(3):
                f = re * e[a]
                force[a, x, iy, iz] = f[keep]
                fs[a] += torch.where(keep, f, 0.0).sum(dim=(1, 2))
            for k in range(nk):
                upx = face(at(sc, own), at(sn, own), k, 0)
                dx = upx - carry[k]
                carry[k] = upx
                # the +y faces of rows -1 .. BY-1, the +z faces of columns
                # -1 .. 31: the tile's and the halo's, once each
                fy = face(at(sc, (slice(None), slice(0, BY + 1),
                                  slice(1, BZ + 1))),
                          at(sc, (slice(None), slice(1, BY + 2),
                                  slice(1, BZ + 1))), k, 1)
                fz = face(at(sc, (slice(None), slice(1, BY + 1),
                                  slice(0, BZ + 1))),
                          at(sc, (slice(None), slice(1, BY + 1),
                                  slice(1, BZ + 2))), k, 2)
                div = dx
                div = div + (fy[:, 1:] - fy[:, :-1])
                div = div + (fz[:, :, 1:] - fz[:, :, :-1])
                n = sc[FR + k][own]
                new = torch.where(sc[FM][own] > 0, n - dt * div, n)
                rho_out[k, x, iy, iz] = new[keep]
            psi_prev = p[own]
        parts.append(fs)
    # blocks in launch order: tiles fastest, then segments
    fsum = torch.cat(parts, dim=1).sum(dim=1)
    return rho_out, force, fsum, evals


def _np_inputs(shape, nk, dtype, seed=3):
    rng = np.random.default_rng(seed)
    psi = torch.as_tensor(1e-3 * rng.standard_normal(shape), dtype=dtype)
    rho = torch.as_tensor(1e-3 + 1e-4 * rng.random((nk,) + shape),
                          dtype=dtype)
    u = torch.as_tensor(1e-3 * rng.standard_normal((3,) + shape),
                        dtype=dtype)
    fluid = torch.as_tensor(rng.random(shape) > 0.2)
    z = [(1.0, -1.0, 2.0)[k] for k in range(nk)]
    ez = [1.0 * v for v in z]
    c = [-0.5 * (0.01, 0.0095, 0.008)[k] for k in range(nk)]
    return psi, rho, u, fluid, ez, z, c, 1.0 / 3.0e-4


MARCH_CASES = [((8, 16, 16), 8, 4, 2), ((5, 6, 7), 2, 4, 1),
               ((15, 4, 4), 4, 8, 3), ((1, 3, 40), 1, 3, 2),
               ((6, 1, 5), 4, 4, 2)]


@pytest.mark.parametrize("shape,BX,BY,nk", MARCH_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("hydro", [True, False])
def test_np_torch_march_is_the_twin(shape, BX, BY, nk, dtype, hydro):
    """rho' and the force bitwise the twin's, fsum (partials per block)
    within the twin's sum of |force| times 1e-12 (f64) or 1e-6 (f32), and
    as many face evaluations as the layout counts."""
    psi, rho, u, fluid, ez, z, c, kt_e = _np_inputs(shape, nk, dtype)
    uu = u if hydro else None
    r, f, fsum, evals = _np_march(psi, rho, uu, fluid, ez, z, c, kt_e, 0.5,
                                  BX, BY)
    want = fe._np_plain(psi, rho, uu, fluid, ez, z, c, kt_e, 0.5)
    assert torch.equal(r, want[0]) and torch.equal(f, want[1])
    tol = (1e-12 if dtype == torch.float64 else 1e-6) * float(
        want[1].abs().sum())
    assert float((fsum - want[2]).abs().max()) <= tol
    assert evals == nk * _cuda.np_faces(shape, BX, BY)
    lay = _cuda.np_layout(shape, nk, hydro, psi.element_size(), SMS, OPTIN,
                          plan=_cuda.NpPlan(BY, BX))
    assert lay.faces_per_site * psi.numel() == pytest.approx(
        _cuda.np_faces(shape, BX, BY), rel=1e-14)
