"""Solid-aware Q-tensor gradients with liquid-crystal anchoring.

PyTorch port of ludwig_tpu/ops/lc_anchor.py (ref:
src/gradient_3d_7pt_solid.c:280-640 gradient_6x6_kernel,
src/gradient_s7_anchoring.c, src/lc_anchoring.c matrices,
src/lc_anchoring_impl.h coefficient/constant-term algebra).

At a fluid site with solid neighbours, the one-sided ("half") gradients
into the solid are unknowns fixed by the anchoring boundary condition

    kappa grad Q . n  +  c(Q_s, n; anchoring) = 0

which couples the six symmetric components through the two elastic
constants.  The reference solves a per-site 6/12/18 system by
multiplying with a precomputed inverse; here the inverses are made once
in numpy and the per-site solve is three dense matrix products over
masked right-hand sides: whole-lattice tensor work, no per-site loop, no
gather or branch.  The matrices ride on the device from their first use
(_device_matrices), so a step copies nothing from the host.  The two-
and three-unknown products accumulate in float64 whatever the field's
dtype, and the trace fix divides as IEEE on every device: the unknowns
reach ~1/kappa times the anchoring term, and the trace fix subtracts
numbers of that size, so a float32 sum or a reciprocal's rounding, which
differ between devices, would show at ~1e-6.

Component order throughout: (XX, XY, XZ, YY, YZ) with ZZ = -XX-YY
appended internally (NSYMM = 6).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

XX, XY, XZ, YY, YZ, ZZ = range(6)
NQAB, NSYMM = 5, 6
_FAC6 = np.array([1.0, 2.0, 2.0, 1.0, 2.0, 1.0])   # c -> b18 factors
# (row a, col b) of the 3x3 c tensor feeding each of the 6 equations
_C_AB = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]

MAP_FLUID, MAP_BOUNDARY, MAP_COLLOID = 0, 1, 2


# -- constant matrices (numpy, made once) -------------------------------------

def bc_coefficients(kappa0: float, kappa1: float, dn) -> np.ndarray:
    """bc[n1][n2][ia]: coefficient of d_ia Q_n2 in boundary equation n1
    (ref: lc_anchoring_impl.h:290-434 lc_anchoring_coefficients)."""
    k0, k1 = kappa0, kappa1
    k2 = k0 + k1
    dx, dy, dz = (float(d) for d in dn)
    bc = np.zeros((6, 6, 3))
    bc[XX, :, 0] = [k0 * dx, -k1 * dy, -k1 * dz, 0, 0, 0]
    bc[XX, :, 1] = [k1 * dy, k0 * dx, 0, 0, 0, 0]
    bc[XX, :, 2] = [k1 * dz, 0, k0 * dx, 0, 0, 0]
    bc[XY, :, 0] = [k0 * dy, k2 * dx, 0, -k1 * dy, -k1 * dz, 0]
    bc[XY, :, 1] = [-k1 * dx, k2 * dy, -k1 * dz, k0 * dx, 0, 0]
    bc[XY, :, 2] = [0, 2.0 * k1 * dz, k0 * dy, 0, k0 * dx, 0]
    bc[XZ, :, 0] = [k0 * dz, 0, k2 * dx, 0, -k1 * dy, -k1 * dz]
    bc[XZ, :, 1] = [0, k0 * dz, 2.0 * k1 * dy, 0, k0 * dx, 0]
    bc[XZ, :, 2] = [-k1 * dx, -k1 * dy, k2 * dz, 0, 0, k0 * dx]
    bc[YY, :, 0] = [0, k0 * dy, 0, k1 * dx, 0, 0]
    bc[YY, :, 1] = [0, -k1 * dx, 0, k0 * dy, -k1 * dz, 0]
    bc[YY, :, 2] = [0, 0, 0, k1 * dz, k0 * dy, 0]
    bc[YZ, :, 0] = [0, k0 * dz, k0 * dy, 0, 2.0 * k1 * dx, 0]
    bc[YZ, :, 1] = [0, 0, -k1 * dx, k0 * dz, k2 * dy, -k1 * dz]
    bc[YZ, :, 2] = [0, -k1 * dx, 0, -k1 * dy, k2 * dz, k0 * dy]
    bc[ZZ, :, 0] = [0, 0, k0 * dz, 0, 0, k1 * dx]
    bc[ZZ, :, 1] = [0, 0, 0, 0, k0 * dz, k1 * dy]
    bc[ZZ, :, 2] = [0, 0, -k1 * dx, 0, -k1 * dy, k0 * dz]
    return bc


def anchoring_matrices(kappa0: float, kappa1: float):
    """(BC, a6inv, a12inv, a18inv): the positive-normal coefficient
    tensors and the precomputed case inverses (ref: lc_anchoring.c:84-262
    lc_anchoring_matrix1/2/3)."""
    BC = np.stack([bc_coefficients(kappa0, kappa1, np.eye(3)[a])
                   for a in range(3)])                      # (3,6,6,3)
    a6inv = np.stack([1.0 / np.diag(BC[a][:, :, a]) for a in range(3)])

    a18 = np.zeros((18, 18))
    for ia in range(3):
        for ib in range(3):
            w = 0.5 * (1.0 + (ia == ib))
            a18[ia * 6:ia * 6 + 6, ib * 6:ib * 6 + 6] = w * BC[ia][:, :, ib]

    idx = {0: [*range(0, 12)],            # xy
           1: [*range(0, 6), *range(12, 18)],   # xz
           2: [*range(6, 18)]}            # yz
    a12inv = np.stack([np.linalg.inv(a18[np.ix_(idx[k], idx[k])])
                       for k in range(3)])
    a18inv = np.linalg.inv(a18)
    return BC, a6inv, a12inv, a18inv


@lru_cache(maxsize=16)
def _device_matrices(kappa0: float, kappa1: float, dtype, device: str):
    """(BC numpy, a6inv, a12inv, a18inv, trace row) with the inverses and
    the trace fix's (1, 0, 0, 1, 0, 1) as tensors on `device`, made once
    for each elastic pair, dtype and device; a12inv and a18inv in
    float64 (_matvec)."""
    BC, a6inv, a12inv, a18inv = anchoring_matrices(kappa0, kappa1)

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    return (BC, t(a6inv).reshape(3, 6, 1, 1, 1), t(a12inv, torch.float64),
            t(a18inv, torch.float64),
            t(np.array([1.0, 0, 0, 1.0, 0, 1.0])).reshape(6, 1, 1, 1))


# -- anchoring parameter bundle ----------------------------------------------

@dataclasses.dataclass(frozen=True)
class AnchoringParams:
    """Anchoring configuration (ref: fe_lc_param_t wall/coll members;
    input keys lc_wall_anchoring, lc_coll_anchoring,
    lc_anchoring_strength[_2], lc_anchoring_strength_colloid)."""
    kappa0: float
    kappa1: float
    q0: float                 # pitch wavevector (raw, not redshifted)
    amplitude: float          # equilibrium amplitude A
    wall: str = "none"        # none | normal | planar | fixed
    wall_w1: float = 0.0
    wall_w2: float = 0.0
    wall_nfix: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    coll: str = "none"
    coll_w1: float = 0.0
    coll_w2: float = 0.0
    method: str = "two"       # 'two' (3d_7pt_solid) | 's7' (s7_anchoring)


# -- tensor helpers (vectorised over the lattice) ----------------------------

def _q33(q6):
    """3x3 symmetric tensor view from the 6-component stack."""
    return [[q6[XX], q6[XY], q6[XZ]],
            [q6[XY], q6[YY], q6[YZ]],
            [q6[XZ], q6[YZ], q6[ZZ]]]


_LEVI = np.zeros((3, 3, 3))
_LEVI[0, 1, 2] = _LEVI[1, 2, 0] = _LEVI[2, 0, 1] = 1.0
_LEVI[0, 2, 1] = _LEVI[1, 0, 2] = _LEVI[2, 1, 0] = -1.0


def _kappa1_ct(kappa1, q0, nhat, qs):
    """c_ab = -kappa1 q0 nhat_g (e_agh Q_hb + e_bgh Q_ha)
    (ref: lc_anchoring_impl.h:52-90)."""
    kq = -kappa1 * q0
    e = _LEVI
    c = [[0.0] * 3 for _ in range(3)]
    for a in range(3):
        for b in range(3):
            t = 0.0
            for g in range(3):
                for h in range(3):
                    if e[a, g, h]:
                        t = t + e[a, g, h] * nhat[g] * qs[h][b]
                    if e[b, g, h]:
                        t = t + e[b, g, h] * nhat[g] * qs[h][a]
            c[a][b] = kq * t
    return c


def _fixed_q0(nhat, amp):
    """Q0_ab = amp/2 (3 n_a n_b - d_ab)."""
    return [[0.5 * amp * (3.0 * nhat[a] * nhat[b] - float(a == b))
             for b in range(3)] for a in range(3)]


def _anchor_ct(kind, w1, w2, qs, nhat_lat, nhat_pref, kappa1, q0, amp,
               nfix=None):
    """Constant term c for one anchoring type.  nhat_lat is used in the
    kappa1 (pitch) term, nhat_pref in the preferred-Q construction
    (ref: gradient_3d_7pt_solid.c:716-775 grad_3d_7pt_bc; for the 's7'
    method both are the true normal, gradient_s7_anchoring.c:674-760)."""
    c = _kappa1_ct(kappa1, q0, nhat_lat, qs)
    if kind == "none":
        return c
    if kind in ("normal", "fixed"):
        nf = nfix if kind == "fixed" else nhat_pref
        qpref = _fixed_q0(nf, amp)
        return [[c[a][b] - w1 * (qs[a][b] - qpref[a][b]) for b in range(3)]
                for a in range(3)]
    if kind == "planar":
        qt = [[qs[a][b] + (0.5 * amp if a == b else 0.0) for b in range(3)]
              for a in range(3)]
        q2 = sum(qt[a][b] * qt[a][b] for a in range(3) for b in range(3))
        # q0_ab = P qtilde P - amp/2 d_ab with P = 1 - n n
        qpref = [[None] * 3 for _ in range(3)]
        for a in range(3):
            for b in range(3):
                acc = 0.0
                for g in range(3):
                    for h in range(3):
                        pag = (1.0 if a == g else 0.0) \
                            - nhat_pref[a] * nhat_pref[g]
                        phb = (1.0 if h == b else 0.0) \
                            - nhat_pref[h] * nhat_pref[b]
                        acc = acc + pag * qt[g][h] * phb
                qpref[a][b] = acc - (0.5 * amp if a == b else 0.0)
        return [[c[a][b] - w1 * (qs[a][b] - qpref[a][b])
                 - w2 * (2.0 * q2 - 4.5 * amp * amp) * qt[a][b]
                 for b in range(3)] for a in range(3)]
    raise ValueError(kind)


def _matvec(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """m (n, k) applied to b (k, X, Y, Z): one matrix product, summed in
    m's dtype (float64) and rounded to b's."""
    x = m @ b.reshape(b.shape[0], -1).to(m.dtype)
    return x.to(b.dtype).reshape((m.shape[0],) + b.shape[1:])


# -- the solid-aware gradient -------------------------------------------------

def anchoring_gradient(q5, params: AnchoringParams, status,
                       walls: Tuple[bool, bool, bool] = (False,) * 3,
                       pid=None, R=None, phi=None):
    """(grad (3,5,X,Y,Z), delsq (5,X,Y,Z)) with anchoring boundary
    conditions at solid neighbours.

    status: (X,Y,Z) integer tensor - 0 fluid, 1 boundary/wall, 2 colloid.
    walls:  per-axis plane walls sitting in the halo beyond the edges
            (ref: wall.c:1225-1266 wall_init_map).
    pid, R: colloid owner map / centres (0-based), for colloid normals.
    phi:    optional composition field; anchoring scales by (1+phi)/2
            (LC droplet wetting, ref: gradient_3d_7pt_solid.c:776-795).
    """
    from ludwig_tpu_torch.colloids import _ftensor, site_coords

    dtype, dev = q5.dtype, q5.device
    shape = tuple(q5.shape[1:])
    q6 = torch.cat([q5, -(q5[0:1] + q5[3:4])])
    BC, a6inv, a12inv, a18inv, trace_row = _device_matrices(
        float(params.kappa0), float(params.kappa1), dtype, str(dev))
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    three = torch.full((), 3.0, dtype=dtype, device=dev)

    # neighbour status with wall planes beyond the edges
    st_up, st_dn = [], []
    for ax in range(3):
        su = torch.roll(status, -1, ax)
        sd = torch.roll(status, 1, ax)
        if walls[ax]:
            top = [slice(None)] * 3
            top[ax] = shape[ax] - 1
            bot = [slice(None)] * 3
            bot[ax] = 0
            su = su.clone()
            sd = sd.clone()
            su[tuple(top)] = MAP_BOUNDARY
            sd[tuple(bot)] = MAP_BOUNDARY
        st_up.append(su)
        st_dn.append(sd)

    # half gradients, unknown bookkeeping
    gup = torch.stack([torch.roll(q6, -1, 1 + ax) - q6 for ax in range(3)],
                      dim=1)                                 # (6,3,XYZ)
    gdn = torch.stack([q6 - torch.roll(q6, 1, 1 + ax) for ax in range(3)],
                      dim=1)
    up_solid = torch.stack([s != MAP_FLUID for s in st_up])  # (3,XYZ)
    dn_solid = torch.stack([s != MAP_FLUID for s in st_dn])
    both = up_solid & dn_solid
    unknown = up_solid ^ dn_solid
    ih = dn_solid                                             # unknown side
    sgn = torch.where(ih, one, -one)                          # nhat sign

    gup = torch.where(both[None], zero, gup)
    gdn = torch.where(both[None], zero, gdn)

    # dq with the unknown half filled by the known one
    filled_up = torch.where((unknown & ~ih)[None], gdn, gup)
    filled_dn = torch.where((unknown & ih)[None], gup, gdn)
    dq = 0.5 * (filled_up + filled_dn)                        # (6,3,XYZ)

    # constant terms c per axis
    qs = _q33(q6)
    amp = params.amplitude
    wphi = None if phi is None else 0.5 * (1.0 + phi)
    zeros = torch.zeros(shape, dtype=dtype, device=dev)
    have_coll = pid is not None and R is not None
    if have_coll:
        coords = site_coords(shape, dtype, dev)
        L = _ftensor([float(n) for n in shape], q5).reshape(3, 1, 1, 1)
    ctile = []
    for ax in range(3):
        nhat_lat = [sgn[ax] if a == ax else zeros for a in range(3)]
        st_solid = torch.where(ih[ax], st_dn[ax], st_up[ax])
        is_coll = st_solid == MAP_COLLOID
        if have_coll:
            pid_solid = torch.where(ih[ax], torch.roll(pid, 1, ax),
                                    torch.roll(pid, -1, ax))
            own = torch.clamp(pid_solid.to(torch.int64), 0, R.shape[0] - 1)
            d = coords - torch.movedim(R[own], -1, 0)
            d = d - L * torch.round(d / L)
            rnorm = torch.sqrt(torch.sum(d * d, dim=0))
            rnorm = torch.where(rnorm > 0.0, rnorm, one)
            dnhat = [d[a] / rnorm for a in range(3)]
            nhat_pref = [torch.where(is_coll, dnhat[a], nhat_lat[a])
                         for a in range(3)]
        else:
            is_coll = torch.zeros(shape, dtype=torch.bool, device=dev)
            nhat_pref = nhat_lat
        nhat_kap = nhat_pref if params.method == "s7" else nhat_lat

        cw = _anchor_ct(params.wall, params.wall_w1, params.wall_w2, qs,
                        nhat_kap, nhat_pref, params.kappa1, params.q0,
                        amp, nfix=params.wall_nfix)
        if params.coll != "none" and pid is not None:
            cc = _anchor_ct(params.coll, params.coll_w1, params.coll_w2,
                            qs, nhat_kap, nhat_pref, params.kappa1,
                            params.q0, amp)
            c = [[torch.where(is_coll, cc[a][b], cw[a][b]) for b in range(3)]
                 for a in range(3)]
        else:
            c = cw
        if wphi is not None:
            c = [[wphi * c[a][b] for b in range(3)] for a in range(3)]
        ctile.append(c)

    nunk = (unknown[0].to(torch.int32) + unknown[1].to(torch.int32)
            + unknown[2].to(torch.int32))

    # Edge/corner sites (nunknown > 1): the reference combines the
    # outward normals into ONE unit normal and evaluates a single c term
    # entering every unknown equation (ref: gradient_s7_anchoring.c:
    # 417-500 bcse; the status defaults to MAP_BOUNDARY unless all solid
    # neighbours are colloids)
    nn_e = [torch.where(unknown[a], sgn[a], zero) for a in range(3)]
    rn_e = torch.sqrt(nn_e[0] * nn_e[0] + nn_e[1] * nn_e[1]
                      + nn_e[2] * nn_e[2])
    rn_e = torch.where(rn_e > 0.0, rn_e, one)
    nhat_e = [nn_e[a] / rn_e for a in range(3)]
    ce = _anchor_ct(params.wall, params.wall_w1, params.wall_w2, qs,
                    nhat_e, nhat_e, params.kappa1, params.q0, amp,
                    nfix=params.wall_nfix)
    if wphi is not None:
        ce = [[wphi * ce[a][b] for b in range(3)] for a in range(3)]
    # colloid-only edges keep the per-axis colloid-centre normals
    edge_coll = torch.ones(shape, dtype=torch.bool, device=dev)
    for ax in range(3):
        st_solid_ax = torch.where(ih[ax], st_dn[ax], st_up[ax])
        edge_coll = edge_coll & torch.where(
            unknown[ax], st_solid_ax == MAP_COLLOID,
            torch.ones((), dtype=torch.bool, device=dev))
    use_ce = (nunk >= 2) & ~edge_coll

    # right-hand sides b~_a (sign-absorbed, ref kernel cases 1-3)
    wib = torch.where(unknown, 0.5 * one, one)                # (3,XYZ)
    btil = []
    for ax in range(3):
        rows = []
        for n1 in range(6):
            a_, b_ = _C_AB[n1]
            c_ab = torch.where(use_ce, ce[a_][b_], ctile[ax][a_][b_])
            acc = -sgn[ax] * float(_FAC6[n1]) * c_ab
            for ib in range(3):
                if ib == ax:
                    continue
                for n2 in range(6):
                    coef = float(BC[ax][n1][n2][ib])
                    if coef != 0.0:
                        acc = acc - coef * (wib[ib] * dq[n2, ib])
            rows.append(acc)
        btil.append(torch.stack(rows))                        # (6,XYZ)

    # case solves
    x1 = [a6inv[a] * btil[a] for a in range(3)]
    pairs = [(0, 1), (0, 2), (1, 2)]
    x2 = [_matvec(a12inv[k], torch.cat([btil[a], btil[b]]))
          for k, (a, b) in enumerate(pairs)]
    x3 = _matvec(a18inv, torch.cat(btil))

    def pick(ax):
        # 1 unknown
        xa = x1[ax]
        # 2 unknowns: the pair is (ax, other-unknown)
        if ax == 0:
            two = torch.where(unknown[1][None], x2[0][:6], x2[1][:6])
        elif ax == 1:
            two = torch.where(unknown[0][None], x2[0][6:], x2[2][:6])
        else:
            two = torch.where(unknown[0][None], x2[1][6:], x2[2][6:])
        x = torch.where((nunk == 2)[None], two, xa)
        x = torch.where((nunk == 3)[None], x3[6 * ax:6 * ax + 6], x)
        # trace fix (ref: gradient_3d_7pt_solid.c:609-618), the third an
        # IEEE quotient on every device (dynamics/beris_edwards.py
        # remove_trace): the unknowns reach ~1/kappa, and the difference
        # of the trace's third from them can cancel to ~1% of it
        tr = (x[XX] + x[YY] + x[ZZ]) / three
        return x - tr[None] * trace_row

    gup5 = [gup[:NQAB, ax] for ax in range(3)]
    gdn5 = [gdn[:NQAB, ax] for ax in range(3)]
    for ax in range(3):
        xax = pick(ax)[:NQAB]
        rep_up = (unknown[ax] & ~ih[ax])[None]
        rep_dn = (unknown[ax] & ih[ax])[None]
        gup5[ax] = torch.where(rep_up, xax, gup5[ax])
        gdn5[ax] = torch.where(rep_dn, xax, gdn5[ax])

    grad = torch.stack([0.5 * (gup5[ax] + gdn5[ax])
                        for ax in range(3)])                  # (3,5,XYZ)
    delsq = (gup5[0] - gdn5[0]) + (gup5[1] - gdn5[1]) + (gup5[2] - gdn5[2])
    return grad, delsq
