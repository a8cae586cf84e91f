"""Resolved colloids in the single fluid: sphere discretisation, bounce-back
on links, implicit velocity update (Nguyen-Ladd BBL).

PyTorch port of ludwig_tpu/colloids.py (ref: src/build.c:355-445 shape and
link construction, src/bbl.c pass1 :373-520, bbl_update_colloids 6x6
implicit solve :750-900, pass2 :570-700; Nguyen & Ladd PRE 66 046708).
Links are dense masks: for each velocity q a link exists at fluid site i
when i + c_q lies inside a particle, and per-particle link sums are
reductions over the lattice.

Two routes, chosen as the JAX package's make_colloid_step chooses them
(colloids.py:1131-1170): `fast = n > 4 and not ((active or walls) and
float64)`.

* The reference-order route (every float64 run, and n <= 4 in float32):
  each particle's link sums run in the reference's order - per periodic
  image a site-major, velocity-minor sequential sum over the image's
  clipped bounding cube, then the X-Y-Z consolidation tree of
  colloid_sums_halo - so that float64 runs are bitwise the JAX package's
  per-particle bbl_step and its batched exact route (bbl_step_exact),
  which agree bitwise with each other.  The particles are batched a few
  at a time; the sequential chains run as csrc/stats_ref.cu's
  chain_sums_kernel on a GPU (one thread a chain) and as numpy's
  add.accumulate (which adds in order) on the CPU.
* The segment-sum route (colloids_fast.py; n > 4 in float32, passive,
  squirmers and walls): the sums of bbl_step_mxu as segment sums into
  N + 1 bins, whatever N, so that a step's launches do not grow with N.

Positions are 0-based lattice coordinates (the reference's 1-based ones
minus 1).  The remove/replace has the JAX package's two forms: the
per-image seeds this module's step takes, and the image-free sums with
the walls' no-donor fallback that the other families' colloid steps take
(lc_colloid.py, binary_colloid.py, binary_lb.py, electro_colloid.py).
With isothermal fluctuations the collision draws the LB noise at the
fluid sites: the per-site KISS stream (ColloidState.noise) on both routes,
or the stateless threefry stream with NoiseConfig(kiss=False).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ludwig_tpu_torch import noise_kiss
from ludwig_tpu_torch.lattice import CS2, LatticeModel
from ludwig_tpu_torch.lb import LBConfig, _noise_terms, kiss_on
from ludwig_tpu_torch.ops import _cuda
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.stencil import roll3
from ludwig_tpu_torch.ops.stream import stream

RCS2 = 1.0 / CS2
TYPES = {"default": 0, "active": 1, "subgrid": 2}


@dataclasses.dataclass(frozen=True)
class ColloidParams:
    """Static per-run colloid parameters (radii etc. are tuples over the
    N particles)."""
    a0: Tuple[float, ...]               # input radius (mass, inertia, map)
    ah: Optional[Tuple[float, ...]] = None   # hydrodynamic radius
    rho0: float = 1.0                   # colloid density
    gravity: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # squirmer parameters; m is the initial swimming direction (carried in
    # ColloidState.M and rotated by the angular velocity)
    b1: Tuple[float, ...] = ()
    b2: Tuple[float, ...] = ()
    m: Tuple[Tuple[float, float, float], ...] = ()
    types: Tuple[str, ...] = ()      # "default" | "active" | "subgrid"
    # pinned position axes, (N, 3) of 0/1 (colloid_*_isfixedr / _rxyz)
    isfixedr: Tuple[Tuple[int, int, int], ...] = ()
    # bonds (i, j) and angles (j, i, l) with i the centre, 0-based
    bonds: Tuple[Tuple[int, int], ...] = ()
    angles: Tuple[Tuple[int, int, int], ...] = ()

    @property
    def n(self) -> int:
        return len(self.a0)

    def is_active(self, n: int) -> bool:
        if len(self.types) > n:
            return self.types[n] == "active"
        return len(self.b1) > n and (self.b1[n] != 0.0 or
                                     (len(self.b2) > n and
                                      self.b2[n] != 0.0))

    @property
    def any_active(self) -> bool:
        return any(self.is_active(n) for n in range(self.n))

    def fixedr_mask(self, dtype, device):
        """(N, 3) 0/1 multiplier of the deferred position move, or None
        (ref: colloids.c colloids_info_position_update isfixedr[xyz])."""
        if not self.isfixedr or not any(any(v) for v in self.isfixedr):
            return None
        fx = np.ones((self.n, 3), np.float64)
        for i, v in enumerate(self.isfixedr):
            for a in range(3):
                if v[a]:
                    fx[i, a] = 0.0
        return _constant(fx.tobytes(), fx.shape, dtype, str(device))

    def masses(self):
        """(mass, moment) as Python floats with the reference's rounding:
        the moment from the rounded mass (ref: bbl.c:786-787)."""
        mass = [(4.0 / 3.0) * float(np.pi) * self.rho0 * a ** 3
                for a in self.a0]
        moment = [(2.0 / 5.0) * mv * a ** 2 for mv, a in zip(mass, self.a0)]
        return mass, moment


class ColloidState(NamedTuple):
    """Dynamic state carried through the step; the leaves in the JAX
    package's order, so that checkpoints interchange."""
    f: torch.Tensor        # distributions (nvel, X, Y, Z)
    R: torch.Tensor        # positions (N, 3), 0-based lattice coordinates
    V: torch.Tensor        # velocities (N, 3)
    W: torch.Tensor        # angular velocities (N, 3)
    dr: torch.Tensor       # deferred position update (ref: bbl.c:912)
    Rmap: torch.Tensor     # positions at the last map/link rebuild
    M: torch.Tensor        # swimming directions (N, 3)
    noise: Optional[torch.Tensor] = None   # the KISS state (4, X, Y, Z)
    gwall: Optional[torch.Tensor] = None   # accumulated wall momentum
    # (pid, inside) of Rmap: the map is a pure function of Rmap, so the
    # step carries it instead of rebuilding it
    pmap: Optional[tuple] = None


# -- elementary functions, rounded as the JAX package's on the CPU -------------

def _np_op(fn, x: torch.Tensor) -> torch.Tensor:
    """fn on a CPU tensor through numpy: torch's CPU sqrt, sin and cos are
    not the correctly rounded (or the XLA) ones; numpy's are, bit for bit
    with the JAX package's on the CPU.  On the GPU torch's own."""
    return torch.from_numpy(np.asarray(fn(x.detach().numpy())))


def _sqrt(x):
    return torch.sqrt(x) if x.device.type != "cpu" else _np_op(np.sqrt, x)


def _sin(x):
    return torch.sin(x) if x.device.type != "cpu" else _np_op(np.sin, x)


def _cos(x):
    return torch.cos(x) if x.device.type != "cpu" else _np_op(np.cos, x)


def _ftensor(vals, like: torch.Tensor) -> torch.Tensor:
    """The constants vals in like's dtype on its device, made once: a copy
    from the host in every step would make the host wait for the card.
    Callers do not write the result."""
    a = np.ascontiguousarray(np.asarray(vals, np.float64))
    return _constant(a.tobytes(), a.shape, like.dtype, str(like.device))


@functools.lru_cache(maxsize=512)
def _constant(raw: bytes, shape, dtype, device) -> torch.Tensor:
    a = np.frombuffer(raw, np.float64).reshape(shape).copy()
    return torch.as_tensor(a, dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def _device_array(raw: bytes, shape, npdtype: str, device) -> torch.Tensor:
    """An integer or bool host array on the device, made once."""
    return torch.as_tensor(np.frombuffer(raw, npdtype).reshape(shape).copy(),
                           device=device)


def _on_device(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return _device_array(a.tobytes(), a.shape, a.dtype.str, str(device))


def rotate_vector(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation of each v (N, 3) by the vector angle w (N, 3)
    (ref: util.c:118 rotate_vector); w = 0 leaves v untouched."""
    theta = _sqrt(w[:, 0] * w[:, 0] + w[:, 1] * w[:, 1] + w[:, 2] * w[:, 2])
    safe = torch.where(theta == 0.0, torch.ones_like(theta), theta)
    what = w / safe[:, None]
    st, ct = _sin(theta), _cos(theta)
    vdotw = v[:, 0] * what[:, 0] + v[:, 1] * what[:, 1] + v[:, 2] * what[:, 2]
    vrot = torch.stack([
        ct * v[:, 0] + st * (what[:, 1] * v[:, 2] - what[:, 2] * v[:, 1]),
        ct * v[:, 1] + st * (what[:, 2] * v[:, 0] - what[:, 0] * v[:, 2]),
        ct * v[:, 2] + st * (what[:, 0] * v[:, 1] - what[:, 1] * v[:, 0])],
        dim=1)
    out = ((1.0 - ct) * vdotw)[:, None] * what + vrot
    return torch.where((theta == 0.0)[:, None], v, out)


def solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 Gaussian elimination with partial pivoting and explicit
    row swaps (ludwig_tpu colloids.py:122, the segment-sum route's solve;
    ref: bbl.c bbl_update_colloids).  A (N, 6, 6), b (N, 6)."""
    n = 6
    N = A.shape[0]
    M = torch.cat([A, b[:, :, None]], dim=2)                      # (N, 6, 7)
    rows = torch.arange(n, device=A.device)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    for k in range(n):
        ip = k + torch.argmax(torch.abs(M[:, k:, k]), dim=1)
        swap = torch.where(rows[None] == k, ip[:, None],
                           torch.where(rows[None] == ip[:, None], k,
                                       rows[None]))
        M = torch.gather(M, 1, swap[:, :, None].expand(N, n, n + 1))
        piv = M[:, k] / M[:, k, k, None]
        fac = torch.where(rows[None] > k, M[:, :, k], zero)
        M = torch.where((rows == k)[None, :, None], piv[:, None, :],
                        M - fac[:, :, None] * piv[:, None, :])
    x = [None] * n
    for k in range(n - 1, -1, -1):
        rhs = M[:, k, n]
        for j in range(k + 1, n):
            rhs = rhs - M[:, k, j] * x[j]
        x[k] = rhs
    return torch.stack(x, dim=1)


def gauss_solve6_ref(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 Gaussian elimination transcribing bbl_update_colloids
    bitwise (ref: bbl.c:750-880; ludwig_tpu colloids.py:152): rows stay in
    place with ipivot bookkeeping, the pivot of column k is the LAST
    not-yet-pivoted row attaining max |a|, the pivot row is scaled by the
    reciprocal of the pivot, elimination touches columns j >= k of the
    rows not yet pivoted, back substitution runs in ipivot order.
    A (N, 6, 6), b (N, 6)."""
    n = 6
    N = A.shape[0]
    M, x = A.clone(), b.clone()
    ar = torch.arange(N, device=A.device)
    rows = torch.arange(n, device=A.device)
    avail = torch.ones((N, n), dtype=torch.bool, device=A.device)
    neg = torch.full((), -1.0, dtype=A.dtype, device=A.device)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    ipiv = []
    for k in range(n):
        vals = torch.where(avail, torch.abs(M[:, :, k]), neg)
        ip = (n - 1) - torch.argmax(torch.flip(vals, (1,)), dim=1)
        onehot = rows[None, :] == ip[:, None]
        avail = avail & ~onehot
        ipiv.append(ip)
        tmp = 1.0 / M[ar, ip, k]
        colk = (rows >= k)[None, :]
        Mip = M[ar, ip]
        Mp = torch.where(colk, Mip * tmp[:, None], Mip)
        M = torch.where(onehot[:, :, None], Mp[:, None, :], M)
        xp = x[ar, ip] * tmp
        x = torch.where(onehot, xp[:, None], x)
        fac = torch.where(avail, M[:, :, k], zero)
        M = M - fac[:, :, None] * torch.where(colk, Mp, zero)[:, None, :]
        x = x - fac * xp[:, None]
    for idash in range(n - 1, -1, -1):
        ip = ipiv[idash]
        tmp = x[ar, ip]
        for k2 in range(idash + 1, n):
            tmp = tmp - M[ar, ip, k2] * x[ar, ipiv[k2]]
        x = torch.where(rows[None, :] == ip[:, None], tmp[:, None], x)
    return x


def _xyz_tree(p: torch.Tensor) -> torch.Tensor:
    """colloid_sums_halo consolidation of per-periodic-image partial sums,
    one pairwise combine per dimension, X then Y then Z (ref:
    colloid_sums.c:164-166).  p: (..., 8, nt) with the image index
    [bx, by, bz], z fastest."""
    q = p.reshape(p.shape[:-2] + (2, 2, 2, p.shape[-1]))
    q = q[..., 0, :, :, :] + q[..., 1, :, :, :]
    q = q[..., 0, :, :] + q[..., 1, :, :]
    return q[..., 0, :] + q[..., 1, :]


def site_coords(size, dtype, device) -> torch.Tensor:
    """(3, X, Y, Z) site coordinates (made once for each lattice, dtype
    and device; the callers do not write them)."""
    return _site_coords(tuple(size), dtype, str(device))


@functools.lru_cache(maxsize=8)
def _site_coords(size, dtype, device):
    axes = [torch.arange(n, dtype=torch.float64, device=device) for n in size]
    return torch.stack(torch.meshgrid(*axes, indexing="ij")).to(dtype)


def _min_image(d: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    return d - L * torch.round(d / L)


def _lengths(size, like: torch.Tensor, ndim_after: int = 0) -> torch.Tensor:
    L = _ftensor([float(s) for s in size], like)
    return L.reshape((3,) + (1,) * ndim_after)


def position_update(R: torch.Tensor, dr: torch.Tensor, size) -> torch.Tensor:
    """The reference's position update in its 1-based binade, wrapped at
    [0.5, L + 0.5) (ludwig_tpu colloids.py:308; ref: colloids.c:1028,
    colloids_halo.c:355)."""
    L = _lengths(size, R)
    r1 = (R + 1.0) + dr
    r1 = torch.where(r1 >= L + 0.5, r1 - L, r1)
    r1 = torch.where(r1 < 0.5, r1 + L, r1)
    return r1 - 1.0


def build_map(R: torch.Tensor, params: ColloidParams, size,
              arith: str = "min_image"):
    """(pid, inside): the owning particle of each site (-1 for fluid) and
    the solid mask, the nearest centre by |r - R| owning a site inside
    several spheres, the lower index on ties (ref: build_update_map).

    A scatter-min over a window of w^3 sites around each centre (w from
    the largest radius): O(N w^3) work, no capacity, nothing to overflow,
    launches independent of N.  `arith` is how the JAX builder the route
    replaces forms r^2, so that the maps are identical: "min_image" the
    minimum image of (site - R) (colloids.build_map and the pillar builder
    build_map_cubes), "window" the unwrapped window coordinate minus R
    (colloids_fast.build_map_fast)."""
    N = R.shape[0]
    dev = R.device
    nsite = int(np.prod(size))
    rmax = int(np.ceil(float(np.max(params.a0))))
    w = 2 * (rmax + 1) + 1
    a2 = _ftensor(np.asarray(params.a0, np.float64) ** 2, R)
    off = torch.stack(torch.meshgrid(
        *[torch.arange(w, device=dev)] * 3, indexing="ij")).reshape(3, -1).T
    corner = torch.floor(R).to(torch.int64) - (rmax + 1)          # (N, 3)
    g = corner[:, None, :] + off[None]                            # (N, w3, 3)
    Li = _on_device(np.asarray(size, np.int64), dev)
    gm = torch.remainder(g, Li)
    if arith == "window":
        d = g.to(R.dtype) - R[:, None, :]
    elif arith == "min_image":
        d = _min_image(gm.to(R.dtype) - R[:, None, :], _ftensor(size, R))
    else:
        raise ValueError(f"arith must be 'min_image' or 'window', not {arith}")
    r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    inf = torch.full((), float("inf"), dtype=R.dtype, device=dev)
    r2 = torch.where(r2 < a2[:, None], r2, inf)
    idx = ((gm[..., 0] * size[1] + gm[..., 1]) * size[2] + gm[..., 2])
    idx = idx.reshape(-1)
    best = torch.full((nsite,), float("inf"), dtype=R.dtype, device=dev)
    best = best.scatter_reduce(0, idx, r2.reshape(-1), "amin")
    pids = torch.arange(N, dtype=torch.int64, device=dev)[:, None].expand(
        r2.shape).reshape(-1)
    cand = torch.where(torch.isfinite(r2.reshape(-1))
                       & (r2.reshape(-1) <= best[idx]), pids,
                       torch.full_like(pids, N))
    bpid = torch.full((nsite,), N, dtype=torch.int64, device=dev)
    bpid = bpid.scatter_reduce(0, idx, cand, "amin")
    inside = (bpid < N).reshape(size)
    pid = torch.where(inside, bpid.reshape(size), -1).to(torch.int32)
    return pid, inside


def map_arith(params: ColloidParams, size, dtype: str, fast: bool) -> str:
    """The r^2 arithmetic of the JAX builder a route replaces (see
    build_map): the per-particle route's, or on the segment-sum route the
    pillar builder's where the JAX package takes it (float32 with a
    pillar edge that fits, colloids_fast.cubes_supported), else
    build_map_fast's."""
    if not fast:
        return "min_image"
    if dtype == "float64":
        return "window"
    rmax = int(np.ceil(float(np.max(params.a0))))
    ok = any(c >= 2 * (rmax + 1) and size[0] % c == 0 and size[1] % c == 0
             for c in (8, 16, 32, 64))
    return "min_image" if ok else "window"


def solid_body_u(R, V, W, pid, inside, size) -> torch.Tensor:
    """ub (3, X, Y, Z): the owner's solid-body velocity at interior sites,
    (v + w_b rb_c) - w_c rb_b per component (ref: bbl.c pass0 ub)."""
    coords = site_coords(size, R.dtype, R.device)
    own = torch.clamp(pid.to(torch.int64), 0, R.shape[0] - 1)
    Ro, Vo, Wo = (torch.movedim(x[own], -1, 0) for x in (R, V, W))
    d = _min_image(coords - Ro, _lengths(size, R, 3))
    ub = torch.stack([(Vo[0] + Wo[1] * d[2]) - Wo[2] * d[1],
                      (Vo[1] + Wo[2] * d[0]) - Wo[0] * d[2],
                      (Vo[2] + Wo[0] * d[1]) - Wo[1] * d[0]])
    return torch.where(inside[None], ub, torch.zeros((), dtype=ub.dtype,
                                                     device=ub.device))


def refresh_inside(f, model: LatticeModel, inside, ub) -> torch.Tensor:
    """Interior sites to the solid-body equilibrium at unit density, the
    rest population untouched, the polynomial term for term as the
    reference's bbl_pass0 (ref: bbl.c:294-356): udotc = c_0 u_0 + c_1 u_1
    + c_2 u_2, sdotq summed over (a, b) of (q_ab u_a) u_b.  All velocities
    p >= 1 at once, each with its own constants: the same operations on
    each element as one velocity at a time."""
    cv = np.asarray(model.cv, np.float64)[1:]
    Q = cv.shape[0]

    def col(vals):
        return _ftensor(vals, f).reshape((Q,) + (1,) * 3)

    udotc = col(cv[:, 0]) * ub[0]
    for a in range(1, ub.shape[0]):
        udotc = udotc + col(cv[:, a]) * ub[a]
    sdotq = 0.0
    for ia in range(3):
        for ib in range(3):
            qab = col(cv[:, ia] * cv[:, ib] - CS2 * (ia == ib))
            sdotq = sdotq + (qab * ub[ia]) * ub[ib]
    feq = col(np.asarray(model.wv, np.float64)[1:]) * (
        1.0 + RCS2 * udotc + 0.5 * RCS2 * RCS2 * sdotq)
    return torch.cat([f[:1], torch.where(inside[None], feq, f[1:])])


# -- reference-order link sums -------------------------------------------------

def cube_extent(size, a0max: float):
    """The static edge of the clipped bounding cubes (ref: build.c:362)."""
    return tuple(min(int(2 * math.ceil(float(a0max)) + 5), int(size[a]))
                 for a in range(3))


_IMAGES = np.array([[(i >> 2) & 1, (i >> 1) & 1, i & 1] for i in range(8)],
                   np.float64)


def chain_sums(seq: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """(B, nt) sums seed + seq[:, 0] + seq[:, 1] + ..., added in that
    order, for seq (B, len, nt): the sequential scans of the reference
    order.  The GPU runs csrc/stats_ref.cu's chain_sums_kernel; the CPU
    numpy's add.accumulate, which adds in order in the array's dtype."""
    B, _n, nt = seq.shape
    if seq.device.type == "cuda":
        v = seq.permute(1, 0, 2).reshape(-1, B * nt).contiguous()
        return _cuda.chain_sums(v, seed.reshape(-1).contiguous()).reshape(
            B, nt)
    if seq.device.type != "cpu":
        raise ValueError(f"no chain sums on {seq.device}")
    a = np.concatenate([seed.detach().numpy()[:, None, :],
                        seq.detach().numpy()], axis=1)
    return torch.from_numpy(np.add.accumulate(a, axis=1)[:, -1, :].copy())


def ordered_reduce(R, a0, size, Ds, nt, make_terms, seeds=None,
                   consolidate=True):
    """Reference-order per-particle link sums, batched over particles
    (ludwig_tpu colloids.py:233 _ordered_image_reduce, colloids_fast.py:581
    ordered_reduce_batched): for each particle and each of its 8 periodic
    images, the sequential sum over the image's clipped bounding cube of
    edge Ds, site-major (x, y, z ascending), velocity-minor, of the terms
    whose site belongs to that image, from the seed; then the X-Y-Z tree.

    make_terms(nidx (B,), Rn (B, 3), cube, cc (B, 3, Dx, Dy, Dz)) ->
    (B, nt, C, Dx, Dy, Dz), masked to the particle's links (exact zeros
    elsewhere); cube(x) slices the trailing (X, Y, Z) of a lattice tensor
    (..., X, Y, Z) to (B, ..., Dx, Dy, Dz).  seeds: None, (N, nt) on the
    real copy, or (N, 8, nt) per image.  Returns (N, nt), or (N, 8, nt)
    per image with consolidate=False."""
    N = R.shape[0]
    dev, dt = R.device, R.dtype
    L = _ftensor(size, R)
    a0v = _ftensor(a0, R)
    bvec = _ftensor(_IMAGES, R)                                    # (8, 3)
    sgn = torch.where(R < 0.5 * L, 1.0, -1.0).to(dt)               # (N, 3)
    rpos = R[:, None, :] + (sgn[:, None, :] * L) * bvec[None]
    c0 = torch.floor(rpos - a0v[:, None, None]) - 1.0
    hi = _ftensor([float(size[a] - Ds[a]) for a in range(3)], R)
    corners = torch.minimum(torch.maximum(c0, torch.zeros_like(c0)),
                            hi).to(torch.int64)                   # (N, 8, 3)
    want = sgn[:, None, :] * bvec[None]                            # (N, 8, 3)
    if seeds is None:
        seeds8 = torch.zeros((N, 8, nt), dtype=dt, device=dev)
    elif seeds.dim() == 2:
        seeds8 = torch.zeros((N, 8, nt), dtype=dt, device=dev)
        seeds8[:, 0] = seeds
    else:
        seeds8 = seeds
    # a few particles a batch: the in-cube terms take B x nt x C x Ds^3
    per = 8 * nt * 18 * int(np.prod(Ds))
    chunk = max(1, (1 << 23) // per)
    rng = [torch.arange(Ds[a], device=dev) for a in range(3)]
    out = []
    for s0 in range(0, N, chunk):
        nidx = torch.arange(s0, min(N, s0 + chunk), device=dev)
        nb = nidx.shape[0]
        B = nb * 8
        corner = corners[nidx].reshape(B, 3)
        Rn = R[nidx].repeat_interleave(8, 0)
        ix, iy, iz = (corner[:, a, None] + rng[a][None] for a in range(3))

        def cube(x, ix=ix, iy=iy, iz=iz):
            c = x[..., ix[:, :, None, None], iy[:, None, :, None],
                  iz[:, None, None, :]]
            return torch.movedim(c, -4, 0)

        cc = torch.stack(torch.broadcast_tensors(
            ix[:, :, None, None].to(dt), iy[:, None, :, None].to(dt),
            iz[:, None, None, :].to(dt)), dim=1)                   # (B,3,D..)
        rnd = torch.round((cc - Rn[:, :, None, None, None])
                          / L[None, :, None, None, None])
        wb = want[nidx].reshape(B, 3)[:, :, None, None, None]
        member = torch.all(rnd == wb, dim=1)
        terms = make_terms(nidx.repeat_interleave(8), Rn, cube, cc)
        vals = terms * member[:, None, None].to(dt)
        seq = vals.permute(0, 3, 4, 5, 2, 1).reshape(B, -1, nt)
        out.append(chain_sums(seq, seeds8[nidx].reshape(B, nt)).reshape(
            nb, 8, nt))
    part = torch.cat(out)
    return _xyz_tree(part) if consolidate else part


def rr_replacement_field(f, inside_old, model: LatticeModel, size,
                         walls=(False, False, False)):
    """(newf, wsum): the wv-weighted average over the neighbours that were
    fluid before the update, with the reference's reciprocal-multiply
    normalisation (ref: build_replace_fluid :832-940).  A neighbour
    across a walled face is MAP_BOUNDARY in the reference and left out
    (ref: build_replace_order_parameter status check)."""
    fluid_old = ~inside_old
    wsum = 0.0
    newf = torch.zeros_like(f)
    for p in range(1, model.nvel):
        shift = tuple(-int(v) for v in model.cv[p])
        w = float(model.wv[p])
        m = roll3(fluid_old, shift).to(f.dtype)
        cross = _walled_faces(model, tuple(size), walls, p) if any(walls) \
            else None
        if cross is not None:
            m = m * (~_on_device(cross, f.device)).to(f.dtype)
        wsum = wsum + w * m
        newf = newf + (w * m[None]) * roll3(f, shift, first_axis=1)
    rw = 1.0 / torch.where(wsum > 0.0, wsum, torch.ones_like(wsum))
    return newf * rw[None], wsum


def rr_no_donor(f, newf, wsum, R, V, W, pid_old, inside_old,
                model: LatticeModel, size, rho0: float = 1.0):
    """newf with the sites that have no old fluid neighbour (wsum <= 0,
    beside a wall) reprojected at (rho0, the solid-body velocity of their
    old owner), the polynomial term for term as the JAX package's
    (ludwig_tpu colloids.py:452-483; ref: build.c build_replace_fluid
    nweight == 0 -> build_replace_fluid_local)."""
    ub = solid_body_u(R, V, W, pid_old, inside_old, size)
    cv = np.asarray(model.cv, np.float64)
    feq = []
    for p in range(model.nvel):
        w = float(model.wv[p])
        udotc = cv[p][0] * ub[0] + cv[p][1] * ub[1] + cv[p][2] * ub[2]
        sdotq = 0.0
        for ia in range(3):
            for ib in range(3):
                qab = float(cv[p][ia] * cv[p][ib]) - CS2 * (ia == ib)
                sdotq = sdotq + (qab * ub[ia]) * ub[ib]
        feq.append(w * (rho0 + RCS2 * udotc + 0.5 * RCS2 * RCS2 * sdotq))
    return torch.where((wsum <= 0.0)[None], torch.stack(feq), newf)


def rr_moments(f, newf, model: LatticeModel):
    """(rho_f, g_f, rho_n, gneg): the old and the replacement
    distributions' moments in the reference's accumulation order (ref:
    lb_0th_moment / lb_1st_moment; build_replace_fluid's g accumulates
    negated terms)."""
    cv = np.asarray(model.cv, np.float64)
    rho_f = f[0]
    for q in range(1, model.nvel):
        rho_f = rho_f + f[q]
    g_f = []
    for a in range(3):
        acc = 0.0
        for q in range(model.nvel):
            acc = acc + float(cv[q][a]) * f[q]
        g_f.append(acc)
    rho_n = newf[0]
    gneg = [0.0, 0.0, 0.0]
    for q in range(model.nvel):
        if q > 0:
            rho_n = rho_n + newf[q]
        for a in range(3):
            gneg[a] = gneg[a] - newf[q] * float(cv[q][a])
    return rho_f, torch.stack(g_f), rho_n, torch.stack(gneg)


def site_order_sums(R, a0, size, nt: int, make_terms,
                    like=None) -> torch.Tensor:
    """(N, nt) per-particle sums over the whole lattice in site order (x,
    y, z ascending), each from 0, of terms that vanish outside a window
    of half-width ceil(max a0) + 3 around the particle: the sum a
    sequential reduction of the masked lattice gives, read from the
    windows alone, the same on every device (the JAX package's jnp.sum
    reduces in XLA's order: the two agree to rounding).  A window's
    sites are taken in ascending lattice order, so that the sites left
    out, whose terms are exact zeros, change nothing.  R may be an int,
    the number of particles, each then summed over the whole lattice.

    make_terms(nidx (B,), flat (B, K)) -> (B, nt, K): the terms of the
    particles nidx at the flat site indices flat, in the dtype and on the
    device of `like` (R by default)."""
    whole = isinstance(R, int)
    N = R if whole else R.shape[0]
    like = R if like is None else like
    dev, dt = like.device, like.dtype
    h = max(size) if whole else int(math.ceil(float(np.max(a0)))) + 3
    idx = []
    for a in range(3):
        n_a = int(size[a])
        if 2 * h + 1 >= n_a:
            idx.append(torch.arange(n_a, device=dev)[None].expand(N, n_a))
        else:
            start = torch.floor(R[:, a]).to(torch.int64) - h
            idx.append(torch.remainder(
                start[:, None] + torch.arange(2 * h + 1, device=dev)[None],
                n_a))
    flat = ((idx[0][:, :, None, None] * size[1] + idx[1][:, None, :, None])
            * size[2] + idx[2][:, None, None, :]).reshape(N, -1)
    flat = torch.sort(flat, dim=1)[0]
    chunk = max(1, (1 << 23) // (nt * flat.shape[1]))
    out = []
    for s0 in range(0, N, chunk):
        nidx = torch.arange(s0, min(N, s0 + chunk), device=dev)
        seq = make_terms(nidx, flat[nidx]).permute(0, 2, 1).contiguous()
        out.append(chain_sums(seq, torch.zeros((nidx.shape[0], nt),
                                               dtype=dt, device=dev)))
    return torch.cat(out)


def particle_site_sums(masks_pids, values, n_part: int, like):
    """(N, len(values)) per-particle lattice sums in site order: entry
    (n, j) sums values[j] over the sites where masks_pids[j] = (mask,
    pid) has pid == n, from 0 (the JAX package's jnp.sum(m * x) with m
    the particle's masked sites)."""
    flat = [(m.reshape(-1), p.reshape(-1), x.reshape(-1))
            for (m, p), x in zip(masks_pids, values)]

    def terms(nidx, sites):
        nn = nidx[:, None]
        return torch.stack([(mf[sites] & (pf[sites] == nn)).to(like.dtype)
                            * xf[sites] for mf, pf, xf in flat], dim=1)

    return site_order_sums(n_part, 0.0, tuple(values[0].shape), len(flat),
                           terms, like=like)


def face_links(inside, pid):
    """[(mask, owner)] of the six faces (x+, x-, y+, ...): the fluid sites
    with a particle site one step away along the face, and that site's
    owner (the links of the reference's conservation put-backs)."""
    out = []
    for ax in range(3):
        for sgn in (+1, -1):
            sh = [0, 0, 0]
            sh[ax] = -sgn
            out.append((~inside & roll3(inside, tuple(sh)),
                        roll3(pid, tuple(sh))))
    return out


def remove_replace(f, R, inside_old, pid_old, inside_new, pid_new,
                   model: LatticeModel, params: ColloidParams, size,
                   rho0: float = 1.0, V=None, W=None,
                   walls=(False, False, False), per_image: bool = False):
    """Fluid removal and replacement where particles moved, in the
    reference order (ref: build.c build_remove_fluid :735-770,
    build_replace_fluid :832-940; ludwig_tpu colloids.py:420): covered
    sites give the particle their momentum and mass deficit, uncovered
    sites get the average of their old fluid neighbours and the particle
    pays for it.  Beside halo walls (`walls`) a neighbour across a wall
    is no donor, and an uncovered site with none takes the equilibrium
    at rho0 and its old owner's solid-body velocity (V, W needed then).

    Returns (f with the uncovered sites replaced, deltam (N,), f0c (N,
    3), t0c (N, 3)), the JAX package's image-free sums: per particle
    dm = -sum(cov (rho - rho0)) + sum(unc (rho_new - rho0)) and the
    momentum and torque likewise, each sum over the lattice in site
    order (site_order_sums), the covered and uncovered ones apart, then
    added.  With per_image (the plain fluid's route) it returns (f, seeds
    (N, 8, 7)) instead: per particle and periodic image the rows
    [deltam, f0 x3, t0 x3] summed in the reference's site order, which
    seed the BBL's pass-1 sums."""
    covered = inside_new & ~inside_old
    uncovered = inside_old & ~inside_new
    newf, wsum = rr_replacement_field(f, inside_old, model, size, walls)
    if any(walls):
        newf = rr_no_donor(f, newf, wsum, R, V, W, pid_old, inside_old,
                           model, size, rho0)
    rho_f, g_f, rho_n, gneg = rr_moments(f, newf, model)
    f = torch.where(uncovered[None], newf, f)
    L = _ftensor(size, R)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    if not per_image:
        dt = f.dtype
        coords = site_coords(size, dt, f.device).reshape(3, -1)
        rf, rn = (rho_f - rho0).reshape(-1), (rho_n - rho0).reshape(-1)
        gf, gn = g_f.reshape(3, -1), gneg.reshape(3, -1)
        cov_i, unc_i = covered.reshape(-1), uncovered.reshape(-1)
        pn, po = pid_new.reshape(-1), pid_old.reshape(-1)

        def terms(nidx, flat):
            nn = nidx[:, None]
            cov = (cov_i[flat] & (pn[flat] == nn)).to(dt)
            unc = (unc_i[flat] & (po[flat] == nn)).to(dt)
            d = _min_image(coords[:, flat] - R[nidx].T[:, :, None],
                           L[:, None, None])

            def rbx(ga, mask):
                return [mask * (d[1] * ga[2] - d[2] * ga[1]),
                        mask * (d[2] * ga[0] - d[0] * ga[2]),
                        mask * (d[0] * ga[1] - d[1] * ga[0])]
            gfc, gnc = gf[:, flat], gn[:, flat]
            rows = [cov * rf[flat], unc * rn[flat]]
            rows += [cov * gfc[a] for a in range(3)]
            rows += [unc * gnc[a] for a in range(3)]
            rows += rbx(gfc, cov) + rbx(gnc, unc)
            return torch.stack(rows, dim=1)

        s = site_order_sums(R, params.a0, size, 14, terms)
        return (f, -s[:, 0] + s[:, 1], s[:, 2:5] + s[:, 5:8],
                s[:, 8:11] + s[:, 11:14])
    Ds = cube_extent(size, np.max(params.a0))

    def terms(nidx, Rn, cube, cc):
        nn = nidx[:, None, None, None]
        cov = cube(covered) & (cube(pid_new) == nn)
        unc = cube(uncovered) & (cube(pid_old) == nn)
        d = _min_image(cc - Rn[:, :, None, None, None],
                       L[None, :, None, None, None])
        d = [d[:, a] for a in range(3)]

        def site_terms(mask, rho_s, g_s):
            g_s = [g_s[:, a] for a in range(3)]
            dmass = torch.where(mask, rho_s - rho0, zero)
            gm = [torch.where(mask, g_s[a], zero) for a in range(3)]
            t = [torch.where(mask, d[1] * g_s[2] - d[2] * g_s[1], zero),
                 torch.where(mask, d[2] * g_s[0] - d[0] * g_s[2], zero),
                 torch.where(mask, d[0] * g_s[1] - d[1] * g_s[0], zero)]
            return dmass, gm, t

        dmc, gc, tc = site_terms(cov, cube(rho_f), cube(g_f))
        dmu, gu, tu = site_terms(unc, cube(rho_n), cube(gneg))
        rows = ([(-dmc) + dmu] + [gc[a] + gu[a] for a in range(3)]
                + [tc[a] + tu[a] for a in range(3)])
        return torch.stack(rows, dim=1)[:, :, None]      # (B, 7, 1, D..)

    seeds = ordered_reduce(R, params.a0, size, Ds, 7, terms,
                           consolidate=False)
    return f, seeds


@functools.lru_cache(maxsize=8)
def link_tables(size, nvel: int, device: str):
    """(plus, minus), each (nvel - 1, X*Y*Z): the flat index of site + c_q
    and of site - c_q, periodic (x.flat[plus[k]] is roll3(x, -c_q))."""
    from ludwig_tpu_torch.lattice import lb_model
    cv = np.asarray(lb_model(nvel).cv[1:], np.int64)
    X, Y, Z = size
    g = np.indices(size).reshape(3, -1)
    out = []
    for sgn in (1, -1):
        t = []
        for c in cv:
            h = [(g[a] + sgn * int(c[a])) % size[a] for a in range(3)]
            t.append((h[0] * Y + h[1]) * Z + h[2])
        out.append(torch.as_tensor(np.stack(t), device=device))
    return tuple(out)


def _walled_faces(model: LatticeModel, size, walls, q: int):
    """The sites whose link q leaves the lattice across a walled face
    (LINK_BOUNDARY; ref: build.c:547), or None."""
    c = model.cv[q]
    cross = np.zeros(tuple(size), bool)
    for a in range(3):
        if walls[a] and int(c[a]) != 0:
            sel = [slice(None)] * 3
            sel[a] = (size[a] - 1) if int(c[a]) > 0 else 0
            cross[tuple(sel)] = True
    return cross if cross.any() else None


def _squirm(rb, mv, b1, b2):
    """The squirmer slip's factors (ref: bbl.c pass1 squirmer section):
    (tans, pleg, rmod) with dm_a = sum_a -delta pleg rmod tans_a c_a.
    rb, mv: 3-lists of tensors; b1, b2 tensors broadcasting with them."""
    rbmod = _sqrt(rb[0] ** 2 + rb[1] ** 2 + rb[2] ** 2)
    mmod = _sqrt(mv[0] ** 2 + mv[1] ** 2 + mv[2] ** 2)
    mod = rbmod * mmod
    zero = torch.zeros((), dtype=mod.dtype, device=mod.device)
    one = torch.ones((), dtype=mod.dtype, device=mod.device)
    rmod = torch.where(mod == 0.0, zero, 1.0 / torch.where(mod == 0.0, one,
                                                           mod))
    rdotm = rb[0] * mv[0] + rb[1] * mv[1] + rb[2] * mv[2]
    cost = rmod * rdotm
    cost = torch.where(cost * cost > 1.0, one, cost)
    sint = _sqrt(1.0 - cost * cost)
    v1 = [rb[1] * mv[2] - rb[2] * mv[1],
          rb[2] * mv[0] - rb[0] * mv[2],
          rb[0] * mv[1] - rb[1] * mv[0]]
    tans = [v1[1] * rb[2] - v1[2] * rb[1],
            v1[2] * rb[0] - v1[0] * rb[2],
            v1[0] * rb[1] - v1[1] * rb[0]]
    tmod = _sqrt(tans[0] ** 2 + tans[1] ** 2 + tans[2] ** 2)
    rtmod = torch.where(tmod == 0.0, zero,
                        1.0 / torch.where(tmod == 0.0, one, tmod))
    pleg = -sint * (b2 * cost + b1)
    return tans, pleg, rtmod


def _active_arrays(params: ColloidParams, like: torch.Tensor):
    """(active (N,) bool, b1 (N,), b2 (N,)) on like's device."""
    n = params.n
    act = _on_device(np.array([params.is_active(i) for i in range(n)]),
                     like.device)
    b1 = np.zeros(n)
    b1[:len(params.b1)] = np.asarray(params.b1, np.float64)
    b2 = np.zeros(n)
    b2[:len(params.b2)] = np.asarray(params.b2, np.float64)
    return act, _ftensor(b1, like), _ftensor(b2, like)


def bbl_step(f, R, V, W, model: LatticeModel, params: ColloidParams, size,
             pid, inside, ext_force=None, ext_torque=None, rho0: float = 1.0,
             deltam=None, f0_corr=None, t0_corr=None, M=None,
             wall_drag=None, walls=(False, False, False), rr_seeds=None):
    """Bounce-back on links with the implicit velocity update, every link
    sum in the reference's order (ludwig_tpu colloids.py:575 bbl_step, and
    colloids_fast.py:847 bbl_step_exact, which it matches bitwise):
    squirmer slip and the active mass conservation, solid-solid and
    colloid-wall virtual links, the wall lubrication drag on the
    translational diagonal.  (pid, inside) is the map of R (the positions
    at the last rebuild).  A rebuild step's remove/replace terms come as
    deltam (N,), f0_corr, t0_corr (N, 3) (the image-free form, seeding
    the real copy's pass-1 sums) or as rr_seeds (N, 8, 7) (the per-image
    form), which supersedes them.

    Returns (f after the BBL, V, W, M rotated by the new W, the momentum
    the colloid-wall links give the walls (3,))."""
    N = params.n
    dev, dt = f.device, f.dtype
    nvel = model.nvel
    Q = nvel - 1
    zero = torch.zeros((), dtype=dt, device=dev)
    L = _ftensor(size, f)
    Ds = cube_extent(size, np.max(params.a0))
    fluid = ~inside
    cq_np = np.asarray(model.cv[1:], np.float64)
    wq_np = np.asarray(model.wv[1:], np.float64)
    cq = _ftensor(cq_np, f)
    wq = _ftensor(wq_np, f)
    c5 = [cq[:, a].reshape(1, Q, 1, 1, 1) for a in range(3)]
    wq5 = wq.reshape(1, Q, 1, 1, 1)
    rev = [int(model.reverse[q]) for q in range(1, nvel)]

    # the link stacks: at outside site i, velocity q, the inside end i+c_q
    plus = link_tables(tuple(size), nvel, str(dev))[0]            # i + c_q
    inside_n = inside.reshape(-1)[plus].reshape((Q,) + tuple(size))
    pid_n = pid.reshape(-1)[plus].reshape((Q,) + tuple(size))
    fr_all = torch.stack([f[rev[k]].reshape(-1)[plus[k]] for k in range(Q)])
    fr_all = fr_all.reshape((Q,) + tuple(size))
    cross = [_walled_faces(model, size, walls, q) for q in range(1, nvel)]
    has_walls = any(c is not None for c in cross)
    crossm = _on_device(np.stack([
        c if c is not None else np.zeros(tuple(size), bool) for c in cross]),
        dev)
    mf = fluid[None] & inside_n & ~crossm        # fluid links
    mcc = inside[None] & (pid[None] != pid_n) & inside_n     # solid-solid
    mw = crossm & inside_n                       # colloid-wall links

    act, b1, b2 = _active_arrays(params, f)
    any_active = params.any_active
    if M is None:
        m_np = np.asarray(params.m if params.m else [[1.0, 0.0, 0.0]] * N,
                          np.float64)
        M = _ftensor(m_np / np.linalg.norm(m_np, axis=1, keepdims=True), f)

    def geom(Rn, cc):
        d = _min_image(cc - Rn[:, :, None, None, None],
                       L[None, :, None, None, None])
        rb = [d[:, a][:, None] + 0.5 * c5[a] for a in range(3)]
        rbxc = [rb[1] * c5[2] - rb[2] * c5[1],
                rb[2] * c5[0] - rb[0] * c5[2],
                rb[0] * c5[1] - rb[1] * c5[0]]
        return rb, rbxc

    def own(cube, mask, nidx):
        return cube(mask) & (cube(pid_n) == nidx[:, None, None, None, None])

    # phase A: the structure sums sumw, cbar, r x cbar (ref:
    # build_link_mean, consolidated by COLLOID_SUM_STRUCTURE)
    def terms_a(nidx, Rn, cube, cc):
        _, rbxc = geom(Rn, cc)
        mfc = own(cube, mf, nidx).to(dt)
        t = [wq5 * mfc] + [(wq * cq[:, a]).reshape(1, Q, 1, 1, 1) * mfc
                           for a in range(3)]
        t += [(wq5 * rbxc[a]) * mfc for a in range(3)]
        return torch.stack(t, dim=1)

    red_a = ordered_reduce(R, params.a0, size, Ds, 7, terms_a)
    sumw = red_a[:, 0]
    rsumw = 1.0 / sumw
    cbarn = red_a[:, 1:4] * rsumw[:, None]
    rxcbarn = red_a[:, 4:7] * rsumw[:, None]
    # shape-change mass deficit (ref: pc->deltam *= rsumw), the per-image
    # build partials consolidated by the structure tree
    if rr_seeds is not None:
        dmn = _xyz_tree(rr_seeds[:, :, 0:1])[:, 0] * rsumw
    elif deltam is not None:
        dmn = deltam * rsumw
    else:
        dmn = torch.zeros((N,), dtype=dt, device=dev)

    # phase B: the pass-1 sums f0, t0, zeta (upper triangle) and the slip
    # total, seeded with the remove/replace contributions (ref: bbl.c:410)
    delta_q = ((2.0 * RCS2) * wq * rho0).reshape(1, Q, 1, 1, 1)
    ztri = [(ia, ib) for ia in range(6) for ib in range(ia, 6)]

    def bcast(x, nidx):
        return x[nidx].reshape(-1, 1, 1, 1, 1)

    def slip(nidx, rb, delta):
        mv = [bcast(M[:, a], nidx) for a in range(3)]
        tans, pleg, rmod = _squirm(rb, mv, bcast(b1, nidx), bcast(b2, nidx))
        dma = 0.0
        for a in range(3):
            dma = dma + ((-delta) * pleg * rmod * tans[a] * c5[a])
        return dma

    def terms_b(nidx, Rn, cube, cc):
        rb, rbxc = geom(Rn, cc)
        mfc = own(cube, mf, nidx)
        mccc = own(cube, mcc, nidx)
        mf_f = mfc.to(dt)
        fc = cube(f[1:])
        frc = cube(fr_all)
        dmf = 2.0 * fc - wq5 * bcast(dmn, nidx)
        dma = None
        if any_active:
            dma = slip(nidx, rb, delta_q)
            dmf = torch.where(bcast(act, nidx), dmf + dma, dmf)
        dm_all = torch.where(mfc, dmf, zero)
        dm_all = dm_all + torch.where(mccc, fc + frc, zero)
        if has_walls:
            dm_all = dm_all + torch.where(own(cube, mw, nidx),
                                          wq5 * rho0 + frc, zero)
        t = [dm_all * c5[a] for a in range(3)]
        t += [dm_all * rbxc[a] for a in range(3)]
        six = [(c5[a] - bcast(cbarn[:, a], nidx)) for a in range(3)]
        six += [rbxc[a] - bcast(rxcbarn[:, a], nidx) for a in range(3)]
        for (ia, ib) in ztri:
            t.append(((delta_q * six[ia]) * six[ib]) * mf_f)
        if any_active:
            t.append(torch.where(mfc & bcast(act, nidx), dma, zero))
        else:
            t.append(torch.zeros_like(dm_all))
        return torch.stack(t, dim=1)

    if rr_seeds is not None:
        seed_b = torch.zeros((N, 8, 28), dtype=dt, device=dev)
        seed_b[:, :, 0:6] = rr_seeds[:, :, 1:7]
    elif f0_corr is not None or t0_corr is not None:
        seed_b = torch.zeros((N, 28), dtype=dt, device=dev)
        if f0_corr is not None:
            seed_b[:, 0:3] = f0_corr
        if t0_corr is not None:
            seed_b[:, 3:6] = t0_corr
    else:
        seed_b = None
    red_b = ordered_reduce(R, params.a0, size, Ds, 28, terms_b, seed_b)
    f0, t0, zpack, sump_raw = (red_b[:, 0:3], red_b[:, 3:6], red_b[:, 6:27],
                               red_b[:, 27])

    # phase C: the active mass conservation (ref: bbl_active_conservation,
    # consolidated by COLLOID_SUM_ACTIVE)
    sump = torch.where(act, sump_raw / sumw, zero)
    fc0 = torch.zeros((N, 3), dtype=dt, device=dev)
    tc0 = torch.zeros((N, 3), dtype=dt, device=dev)
    if any_active:
        def terms_c(nidx, Rn, cube, cc):
            _, rbxc = geom(Rn, cc)
            mf_f = (own(cube, mf, nidx) & bcast(act, nidx)).to(dt)
            dmq = -(wq5 * bcast(sump, nidx))
            t = [(dmq * c5[a]) * mf_f for a in range(3)]
            t += [(dmq * rbxc[a]) * mf_f for a in range(3)]
            return torch.stack(t, dim=1)

        red_c = ordered_reduce(R, params.a0, size, Ds, 6, terms_c)
        fc0, tc0 = red_c[:, 0:3], red_c[:, 3:6]

    # the colloid-wall links' account: the wall halo holds w rho0, and the
    # wall's own link list counts each link with the opposite orientation
    # (ref: wall.c wall_bbl_kernel MAP_COLLOID branch)
    gw = torch.zeros((3,), dtype=dt, device=dev)
    if has_walls:
        link = torch.stack([torch.sum(torch.where(
            mw[k] & (pid_n[k] >= 0),
            (float(wq_np[k]) * rho0 + fr_all[k]) - 2.0 * float(wq_np[k]),
            zero)) for k in range(Q)])
        gw = -(cq * link[:, None]).sum(dim=0)

    # the 6x6 implicit solve, transcribing bbl_update_colloids
    mass, moment = params.masses()
    A = torch.zeros((N, 6, 6), dtype=dt, device=dev)
    for k, (ia, ib) in enumerate(ztri):
        A[:, ia, ib] = zpack[:, k]
        A[:, ib, ia] = zpack[:, k]
    diag = torch.cat([_ftensor(mass, f)[:, None].expand(N, 3),
                      _ftensor(moment, f)[:, None].expand(N, 3)], dim=1)
    A = A + torch.diag_embed(diag)
    if wall_drag is not None:
        A = A - torch.diag_embed(torch.cat([wall_drag, torch.zeros_like(
            wall_drag)], dim=1))
    fe = torch.zeros((N, 3), dtype=dt, device=dev) if ext_force is None \
        else ext_force
    te = torch.zeros((N, 3), dtype=dt, device=dev) if ext_torque is None \
        else ext_torque
    b = torch.cat([((_ftensor(mass, f)[:, None] * V + f0) + fe) + fc0,
                   ((_ftensor(moment, f)[:, None] * W + t0) + te) + tc0],
                  dim=1)
    x = gauss_solve6_ref(A, b)
    Vn, Wn = x[:, :3], x[:, 3:]
    Mn = rotate_vector(M, Wn)

    # pass 2 with the new velocities: f[rev q](j) = f[q](i) - df for each
    # link (q at fluid site i, inside j = i + c_q); dms in the reference's
    # interleaved order v0 cb0, w0 rx0, v1 cb1, ...
    dms = None
    for a in range(3):
        t1 = Vn[:, a] * cbarn[:, a]
        dms = t1 if dms is None else dms + t1
        dms = dms + Wn[:, a] * rxcbarn[:, a]
    dms = 2.0 * RCS2 * rho0 * dms
    coords = site_coords(size, dt, dev)
    Lb = _lengths(size, f, 3)
    pad = torch.zeros((1,), dtype=dt, device=dev)
    dmn_p, dms_p, sump_p = (torch.cat([x, pad]) for x in (dmn, dms, sump))
    Vp = torch.cat([Vn, pad.expand(1, 3)])
    Wp = torch.cat([Wn, pad.expand(1, 3)])
    actp = torch.cat([act, torch.zeros((1,), dtype=torch.bool, device=dev)])
    geoms = []
    fslip = f.clone() if any_active else f
    for k, q in enumerate(range(1, nvel)):
        m = mf[k]
        c = cq_np[k]
        w = float(wq_np[k])
        ownp = torch.where(m, pid_n[k].to(torch.int64), N)
        owc = torch.clamp(pid_n[k].to(torch.int64), 0, N - 1)
        d = _min_image(coords - torch.movedim(R[owc], -1, 0), Lb)
        rb = [d[a] + 0.5 * float(c[a]) for a in range(3)]
        if any_active:
            # the slip on the outgoing distribution (ref: fdist += dm_a),
            # before pass 2 reads it
            mv = [M[owc][..., a] for a in range(3)]
            tans, pleg, rmod = _squirm(rb, mv, b1[owc], b2[owc])
            delta = 2.0 * RCS2 * w * rho0
            dm_a = 0.0
            for a in range(3):
                if c[a]:
                    dm_a = dm_a + (-delta) * pleg * rmod * tans[a] * float(
                        c[a])
            fslip[q] = f[q] + torch.where(m & actp[ownp], dm_a, zero)
        geoms.append((m, c, w, ownp, rb))
    fout = fslip.clone()
    for k, q in enumerate(range(1, nvel)):
        m, c, w, ownp, rb = geoms[k]
        Vo = torch.movedim(Vp[ownp], -1, 0)
        Wo = torch.movedim(Wp[ownp], -1, 0)
        wxrb = [Wo[1] * rb[2] - Wo[2] * rb[1],
                Wo[2] * rb[0] - Wo[0] * rb[2],
                Wo[0] * rb[1] - Wo[1] * rb[0]]
        vdotc = sum((Vo[a] + wxrb[a]) * float(c[a]) for a in range(3))
        vdotc = 2.0 * RCS2 * w * vdotc
        df = ((rho0 * vdotc + w * dmn_p[ownp]) + w * sump_p[ownp]) \
            - w * dms_p[ownp]
        shift = tuple(int(v) for v in c)
        val_at_j = roll3(torch.where(m, fslip[q] - df, zero), shift)
        mask_at_j = roll3(m, shift)
        fout[rev[k]] = torch.where(mask_at_j, val_at_j, fout[rev[k]])
    return fout, Vn, Wn, Mn, gw


# -- walls -----------------------------------------------------------------------

def wall_lubr_sphere_all(R, params: ColloidParams, walls, lubr_rc, lubr_dh,
                         eta: float, size) -> torch.Tensor:
    """(N, 3) per-axis wall lubrication drag corrections (ref: wall.c
    wall_lubr_sphere / wall_lubr_drag); 0-based positions, lmin = 0.5."""
    ah = _ftensor(params.ah, R)
    cols = []
    for a in range(3):
        zeta = torch.zeros_like(ah)
        if walls[a] and lubr_rc[a] > 0.0:
            hb = ((R[:, a] + 0.5) - lubr_dh[a]) - ah
            ht = ((float(size[a]) - 0.5 - lubr_dh[a]) - R[:, a]) - ah
            for h in (hb, ht):
                z = (-6.0 * np.pi * eta * ah * ah) * (1.0 / h
                                                      - 1.0 / lubr_rc[a])
                zeta = zeta + torch.where(h < lubr_rc[a], z,
                                          torch.zeros_like(z))
        cols.append(zeta)
    return torch.stack(cols, dim=1)


def wall_ss_cut_forces(R, params: ColloidParams, walls, epsilon, sigma, nu,
                       hc, size) -> torch.Tensor:
    """(N, 3) soft-sphere wall forces (ref: wall_ss_cut.c
    wall_ss_cut_compute); the walls' reaction is the negative sum."""
    rsigma = 1.0 / sigma
    vcut_d = -epsilon * nu * rsigma * (sigma / hc) ** (nu + 1.0)
    ah = _ftensor(params.ah, R)
    cols = []
    for a in range(3):
        fa = torch.zeros_like(ah)
        if walls[a]:
            hb = (R[:, a] + 0.5) - ah
            ht = ((float(size[a]) - 0.5) - R[:, a]) - ah
            fl = -(-epsilon * nu * rsigma * (torch.full_like(hb, sigma) / hb)
                   ** (nu + 1.0) - vcut_d)
            fu = -(-epsilon * nu * rsigma * (torch.full_like(ht, sigma) / ht)
                   ** (nu + 1.0) - vcut_d)
            fa = fa + torch.where(hb < hc, fl, torch.zeros_like(fl))
            fa = fa - torch.where(ht < hc, fu, torch.zeros_like(fu))
        cols.append(fa)
    return torch.stack(cols, dim=1)


# -- the step ----------------------------------------------------------------------

def colloid_route(cfg: LBConfig, params: ColloidParams, has_walls: bool):
    """(fast, exact): the JAX package's route choice (colloids.py:1131-
    1146): the segment-sum route for n > 4 unless the run is float64 with
    squirmers or walls; within it the reference-order sums in float64."""
    fast = (params.n > 4 and not ((params.any_active or has_walls)
                                  and cfg.dtype == "float64"))
    return fast, fast and cfg.dtype == "float64"


def make_colloid_step(cfg: LBConfig, params: ColloidParams,
                      rebuild_freq: int = 1, force_fn=None, wallspec=None,
                      lubr_rc=(0.0,) * 3, lubr_dh=(0.0,) * 3, wall_ss=None,
                      torque_fn=None):
    """step(state, t=0, rebuild=None) -> (ColloidState, (rho, u)): one
    colloid + fluid step in the reference's order (ludwig_tpu
    colloids.py:1104; ref: ludwig.c): move the particles by dr, rebuild
    the map and remove/replace the fluid on rebuild steps (t %
    rebuild_freq == 0, ref: ludwig.c:542), refresh the interior
    distributions, collide the fluid sites (gravity balanced by a uniform
    counter-force on the fluid, ref: interaction.c:448), bounce back on
    links with the implicit velocity update, stream (with halo walls, the
    wall bounce-back and its momentum).

    force_fn(R, V) / torque_fn(R, V) -> (N, 3): the pair, bond, wall,
    driving and dipolar terms at the moved positions.  step.prepare
    normalises a state (gwall, the KISS state, the map cache).  With
    isothermal fluctuations the collision draws the per-site KISS stream
    (state.noise) at the fluid sites only, the solid sites' state frozen
    and their deviates zero (ref: collision.c noise branch), or, with
    NoiseConfig(kiss=False), the stateless threefry stream.  The float32
    segment-sum route reads nothing back to the host."""
    model = cfg.model
    cparams = cfg.collision_params()
    size = tuple(cfg.size)
    has_walls = wallspec is not None and wallspec.any
    walls = wallspec.walls if has_walls else (False, False, False)
    fast, exact = colloid_route(cfg, params, has_walls)
    arith = map_arith(params, size, cfg.dtype, fast)
    segment = fast and not exact
    if segment:
        from ludwig_tpu_torch.colloids_fast import (bbl_step_seg,
                                                    remove_replace_fast)
    gravity_on = any(v != 0.0 for v in params.gravity)
    kiss_rho = kiss_on(cfg)

    def bmap(R_):
        return build_map(R_, params, size, arith)

    def _step(state: ColloidState, t, rebuild: bool):
        f, R, V, W, dr, Rmap, Msw = state[:7]
        gwall = state.gwall
        dev, dt = f.device, f.dtype
        # 1. the deferred move (ref: bbl.c:912, colloids.c:1055), every
        #    step; the map and links follow on rebuild steps only
        fxm = params.fixedr_mask(R.dtype, R.device)
        R = position_update(R, dr if fxm is None else fxm * dr, size)
        deltam = f0c = t0c = rr_seeds = None
        if rebuild:
            pid_old, inside_old = state.pmap
            Rmap = R
            pid, inside = bmap(R)
            if segment:
                f, deltam, f0c, t0c = remove_replace_fast(
                    f, R, inside_old, pid_old, inside, pid, model, params,
                    size, rho0=cfg.rho0)
            else:
                f, rr_seeds = remove_replace(
                    f, R, inside_old, pid_old, inside, pid, model, params,
                    size, rho0=cfg.rho0, per_image=True)
        else:
            pid, inside = state.pmap
        # interior sites track the solid-body velocity (ref: bbl pass0)
        f = refresh_inside(f, model, inside, solid_body_u(R, V, W, pid,
                                                          inside, size))
        # 2. collide the fluid sites
        fluid = ~inside
        grav = _ftensor(params.gravity, f)
        force = None
        if gravity_on:
            nfluid = torch.sum(fluid.to(dt))
            fb = (-grav) * (1.0 / nfluid) * float(params.n)
            force = fb[:, None, None, None].expand((3,) + size)
        nstate = state.noise if kiss_rho else None
        if kiss_rho:
            shat, ghat, nstate = _noise_terms(cfg, cparams, t, nstate=nstate,
                                              fluid=fluid)
        else:
            shat, ghat = _noise_terms(cfg, cparams, t)
        f, rho, u = collide(f, cparams, force=force, fluid_mask=fluid,
                            shat=shat, ghat=ghat)
        # 3. BBL with the implicit velocity update
        ext = grav[None].expand(params.n, 3)
        if force_fn is not None:
            ext = ext + force_fn(R, V).to(dt)
        ext_t = torque_fn(R, V).to(dt) if torque_fn is not None else None
        dwall = None
        if has_walls:
            if wall_ss is not None:
                fss = wall_ss_cut_forces(R, params, walls, wall_ss["epsilon"],
                                         wall_ss["sigma"], wall_ss["nu"],
                                         wall_ss["hc"], size)
                ext = ext + fss
                gwall = gwall - torch.sum(fss, dim=0)
            if any(r > 0.0 for r in lubr_rc):
                dwall = wall_lubr_sphere_all(R, params, walls, lubr_rc,
                                             lubr_dh, cfg.eta_shear, size)
        Vold = V
        # the links are those of the last rebuild position Rmap
        if segment:
            f, V, W, Msw, gwbb = bbl_step_seg(
                f, Rmap, V, W, model, params, size, pid, inside,
                ext_force=ext, ext_torque=ext_t, rho0=cfg.rho0,
                deltam=deltam, f0_corr=f0c, t0_corr=t0c, M=Msw,
                walls=walls, wall_drag=dwall)
        else:
            f, V, W, Msw, gwbb = bbl_step(
                f, Rmap, V, W, model, params, size, pid, inside,
                ext_force=ext, ext_torque=ext_t, rho0=cfg.rho0,
                rr_seeds=rr_seeds, M=Msw, wall_drag=dwall, walls=walls)
        if has_walls:
            gwall = gwall + gwbb
        if dwall is not None:
            # the lubrication account with the new velocity (ref: bbl.c
            # bbl_wall_lubrication_account)
            gwall = gwall - torch.sum(V * dwall, dim=0)
        dr = 0.5 * (Vold + V)       # the deferred move (ref: bbl.c:912)
        # 4. propagate; with halo walls the bounce-back at the planes,
        #    colloid-covered wall sites taking the halo's w rho0
        f_post = f
        f = stream(f, model)
        if has_walls:
            from ludwig_tpu_torch.ops.walls import wall_bounce_back
            f, _, gwb = wall_bounce_back(f, f_post, model, wallspec,
                                         rho0=cfg.rho0, fluid=fluid)
            gwall = gwall + gwb.to(dt)
        return ColloidState(f, R, V, W, dr, Rmap, Msw, noise=nstate,
                            gwall=gwall, pmap=(pid, inside)), (rho, u)

    def prepare(state) -> ColloidState:
        """The full ColloidState of a state: the KISS state (default
        seeded, as the reference's noise_init(obj, 0)), the walls'
        momentum and the map of Rmap where they are missing."""
        if not isinstance(state, ColloidState):
            state = ColloidState(*state)
        if kiss_rho and state.noise is None:
            state = state._replace(noise=noise_kiss.kiss_init(
                0, size, device=state.f.device))
        if has_walls and state.gwall is None:
            state = state._replace(gwall=torch.zeros(
                (3,), dtype=state.f.dtype, device=state.f.device))
        if state.pmap is None:
            state = state._replace(pmap=bmap(state.Rmap))
        return state

    def step(state, t=0, rebuild=None):
        state = prepare(state)
        return _step(state, t, int(t) % rebuild_freq == 0 if rebuild is None
                     else bool(rebuild))

    step.prepare = prepare
    step.route = "segment" if segment else "ordered"
    return step


def total_colloid_momentum(V, params: ColloidParams) -> torch.Tensor:
    """(3,) sum of the particles' mass times velocity."""
    mass = _ftensor([(4.0 / 3.0) * np.pi * params.rho0 * a ** 3
                     for a in params.a0], V)
    return torch.sum(mass[:, None] * V, dim=0)
