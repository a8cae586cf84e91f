"""Plane walls living in the halo beyond the lattice edges.

PyTorch port of ludwig_tpu/ops/walls.py (ref: src/wall.c:
wall_init_map:1225 places MAP_BOUNDARY on the global halo planes, so all
L sites along a walled axis stay fluid; wall_bbl_kernel:860-980 does
half-way bounce-back on the links crossing the wall face and accumulates
the momentum transfer in wall->fnet).

The wall never occupies storage: streaming stays periodic and the wrap
planes of each walled axis are overwritten with the bounce-back values
afterwards.  `wall_bounce_back` and `wall_bounce_back_slip` follow the
JAX package's plane-by-plane updates; `wall_bounce_back_fused`, the fix
of the fused step's output, gathers each walled axis' into-wall
populations of both planes from that output with one advanced index,
writes them with one `index_put_` and sums the momentum transfer in one
reduction.

The JAX package forms the bounce-back values from float64 numpy
constants, so a float32 state receives `float32(f* - corr)` evaluated in
double; the port does the same.  The binary fluid's wall helpers
(no_flux_at_walls, stress_divergence_force_walls) and the liquid
crystal's wall_velocity_gradient_fix are here too.
The index masks and constants a step needs are made once per lattice
and device, so a step on the card copies nothing from the host.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from itertools import combinations
from typing import Optional, Tuple

import numpy as np
import torch

from ludwig_tpu_torch.lattice import CS2, LatticeModel


@dataclasses.dataclass(frozen=True)
class WallSpec:
    """Which axes have walls, the wall velocities (moving walls, input
    keys boundary_walls, boundary_speed_bottom/top), and per-face slip
    fractions (boundary_walls_slip_fraction_bot/top; ref: wall.c:475-707
    wall_init_boundaries_slip, wall_slip)."""
    walls: Tuple[bool, bool, bool]
    ubot: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    utop: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    slip_bot: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    slip_top: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    slip_active: bool = False

    @property
    def any(self) -> bool:
        return any(self.walls)

    def slip_value(self, sides) -> float:
        """Slip fraction for a link whose wall normal involves the given
        (axis, is_top) faces: face value, edge average, corner no-slip
        (ref: wall.c wall_slip, wall_link_slip)."""
        if len(sides) >= 3:
            return 0.0
        vals = [(self.slip_top if top else self.slip_bot)[ax]
                for ax, top in sides]
        return float(sum(vals) / len(vals))


def _corr(model: LatticeModel, q: int, uw, rho0: float):
    """The moving-wall term 2 w_q rho0 (c_q . u_w) / cs2, a float64."""
    cdotu = float(np.dot(model.cv[q], uw))
    return 2.0 * model.wv[q] * rho0 * cdotu / CS2


def _minus64(x: torch.Tensor, c) -> torch.Tensor:
    """x - c evaluated in double and rounded to x's dtype (c a float64 or
    a float64 tensor), as the JAX package's numpy constants promote."""
    return (x.double() - c).to(x.dtype)


def _overlap(model: LatticeModel, spec: WallSpec, q: int, ax: int,
             plane_shape, extents) -> np.ndarray:
    """Sites of axis `ax`'s plane whose link q was already counted by an
    earlier walled axis' plane pass (a diagonal crossing several walled
    faces; the reference's link list holds each link once)."""
    rem = [a for a in range(3) if a != ax]
    ov = np.zeros(plane_shape, bool)
    for ax2 in range(ax):
        if not spec.walls[ax2] or model.cv[q][ax2] == 0:
            continue
        p2 = 0 if model.cv[q][ax2] < 0 else extents[ax2] - 1
        sel = [slice(None)] * ov.ndim
        sel[rem.index(ax2)] = p2
        ov[tuple(sel)] = True
    return ov


@lru_cache(maxsize=16)
def _cv_tensor(nvel: int, device: str) -> torch.Tensor:
    """The velocity set as a float64 (nvel, 3) tensor on `device`."""
    from ludwig_tpu_torch.lattice import lb_model
    return torch.as_tensor(np.asarray(lb_model(nvel).cv, np.float64),
                           device=device)


@lru_cache(maxsize=256)
def _keep_tensor(nvel: int, walls, q: int, ax: int, extents,
                 device: str) -> torch.Tensor:
    """The plane sites whose link q counts on axis ax's plane pass (the
    complement of _overlap), on `device`."""
    from ludwig_tpu_torch.lattice import lb_model
    plane_shape = tuple(extents[a] for a in range(3) if a != ax)
    ov = _overlap(lb_model(nvel), WallSpec(walls=tuple(walls)), q, ax,
                  plane_shape, extents)
    return torch.as_tensor(~ov, device=device)


def wall_bounce_back(f_new: torch.Tensor, f_post: torch.Tensor,
                     model: LatticeModel, spec: WallSpec,
                     rho0: float = 1.0, g_post: Optional[torch.Tensor] = None,
                     g_new: Optional[torch.Tensor] = None, fluid=None):
    """Overwrite wrapped-in distributions at wall planes with half-way
    bounce-back, and return the momentum transferred to the walls.

    f_new: streamed distributions (rolled, so wall planes currently hold
    wrapped values); f_post: post-collision distributions.
    g_post/g_new: optional second (order-parameter) distribution for
    ndist=2 models (ref: wall_bbl_kernel LB_PHI branch).  fluid: optional
    bool mask; colloid-covered wall sites do not bounce but take the
    halo's rest value w rho0.

    Returns (f_new, g_new, gwall_inc) with
      gwall_inc = sum_links (2 f*_q - 2 w_q rho0 (c_q.u_w)/cs2 - 2 w_q) c_q
    accumulated per link with the small-constant subtraction exactly as
    the reference does (anti-roundoff; ref: wall.c:941-949).  The inputs
    are not written; f_new and g_new come back as new tensors.
    """
    cv, wv, rev = model.cv, model.wv, model.reverse
    dtype, dev = f_post.dtype, f_post.device
    extents = tuple(f_post.shape[1:])
    f_new = f_new.clone()
    if g_new is not None:
        g_new = g_new.clone()
    gw = torch.zeros((3,), dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    cvt = _cv_tensor(model.nvel, str(dev))

    for ax in range(3):
        if not spec.walls[ax]:
            continue
        for side, uw in ((0, spec.ubot), (1, spec.utop)):
            # side 0: wall below plane i=0; into-wall dirs have cv[ax]<0
            plane = 0 if side == 0 else extents[ax] - 1
            into = -1 if side == 0 else 1
            sl = [slice(None)] * 3
            sl[ax] = plane
            sl = tuple(sl)
            for q in range(model.nvel):
                if cv[q][ax] != into:
                    continue
                p = int(rev[q])
                corr = _corr(model, q, uw, rho0)
                fq = f_post[(q,) + sl]
                if fluid is None:
                    f_new[(p,) + sl] = _minus64(fq, corr)
                else:
                    f_new[(p,) + sl] = torch.where(
                        fluid[sl], _minus64(fq, corr),
                        torch.full((), float(wv[q] * rho0), dtype=dtype,
                                   device=dev))
                if g_post is not None:
                    g_new[(p,) + sl] = _minus64(g_post[(q,) + sl], corr)
                ov = _overlap(model, spec, q, ax, tuple(fq.shape), extents)
                small = corr + 2.0 * wv[q]
                if fluid is None:
                    if ov.any():
                        keep = _keep_tensor(model.nvel, spec.walls, q, ax,
                                            extents, str(dev))
                        link = (torch.sum(torch.where(keep, 2.0 * fq, zero))
                                .double() - small * float((~ov).sum()))
                    else:
                        link = (torch.sum(2.0 * fq).double()
                                - small * float(fq.numel()))
                else:
                    # small-per-link accumulation as the reference's fnet
                    # (anti-roundoff; ref: wall.c:1066-1076)
                    keep = _keep_tensor(model.nvel, spec.walls, q, ax,
                                        extents, str(dev)) & fluid[sl]
                    link = torch.sum(torch.where(
                        keep, 2.0 * fq.double() - small, 0.0))
                gw = gw + link * cvt[q]
    return f_new, g_new, gw


@dataclasses.dataclass(frozen=True)
class _AxisFix:
    """One walled axis of the fused fix, both planes at once: where the
    periodic output holds the into-wall f*_q of the plane sites (`src`)
    and where their bounce-back goes (`dst`), each an advanced index
    broadcasting to (2, n, plane...); the moving-wall terms (2, n, 1, 1)
    in float64, the sites each link counts at (None: all) and their
    number (2, n), corr + 2 w_q (2, n) and c_q (2, n, 3)."""
    src: tuple
    dst: tuple
    corr: torch.Tensor
    keep: Optional[torch.Tensor]
    nkeep: torch.Tensor
    small: torch.Tensor
    cq: torch.Tensor


def wall_fix_plan(model: LatticeModel, spec: WallSpec, extents,
                  rho0: float, device) -> Tuple[_AxisFix, ...]:
    """The index and constant tensors of wall_bounce_back_fused on
    `device`; a step builds them once."""
    cv = np.asarray(model.cv, np.int64)
    plans = []
    for ax in range(3):
        if not spec.walls[ax]:
            continue
        plane_shape = tuple(extents[a] for a in range(3) if a != ax)
        # row 0 the low plane (into-wall c_ax = -1), row 1 the high one
        q = np.array([[k for k in range(model.nvel) if cv[k][ax] == into]
                      for into in (-1, 1)])
        corr = np.array([[_corr(model, k, uw, rho0) for k in row]
                         for row, uw in zip(q, (spec.ubot, spec.utop))])
        ov = np.array([[_overlap(model, spec, k, ax, plane_shape, extents)
                        for k in row] for row in q])
        ends = np.array([[0], [extents[ax] - 1]])
        # f*_q of a plane site s sits at s + c_q in the periodic output
        src, dst = [q[..., None, None]], [model.reverse[q][..., None, None]]
        for d in range(3):
            if d == ax:
                src.append(((ends + cv[q, d]) % extents[d])[..., None, None])
                dst.append(ends[..., None, None])
            else:
                first = d == min(a for a in range(3) if a != ax)
                i = (np.arange(extents[d]) + cv[q, d][..., None]) % extents[d]
                src.append(i[..., :, None] if first else i[..., None, :])
                whole = np.arange(extents[d])
                dst.append(whole[:, None] if first else whole[None, :])

        def dev(a, kind=torch.float64):
            return torch.as_tensor(np.asarray(a), dtype=kind, device=device)

        plans.append(_AxisFix(
            src=tuple(dev(i, torch.int64) for i in src),
            dst=tuple(dev(i, torch.int64) for i in dst),
            corr=dev(corr)[..., None, None],
            keep=dev(~ov, torch.bool) if ov.any() else None,
            nkeep=dev((~ov).sum(axis=(-2, -1))),
            small=dev(corr + 2.0 * np.asarray(model.wv)[q]),
            cq=dev(cv[q])))
    return tuple(plans)


def wall_bounce_back_fused(f: torch.Tensor, model: LatticeModel,
                           spec: WallSpec, rho0: float = 1.0, plan=None):
    """Wall fix for the fused collide+stream step's output f (nvel, X, Y,
    Z), unpadded.

    The fused step streams fully periodically; here the contaminated
    (wrapped-in) populations on each walled boundary plane are
    overwritten with half-way bounce-back.  The post-collision
    populations f*_q that leave a boundary plane through the wall are
    those the periodic stream wrapped to the opposite plane, so they are
    gathered from f itself, every axis' before any write: the values
    the kernel's own collision made, where the JAX package's
    wall_bounce_back_fused takes them from a second collide of the
    boundary planes.  Axes are fixed in order, so a later axis
    overwrites the edge sites it shares with an earlier one, as in the
    JAX package.

    Writes f in place and returns (f, gwall_inc): the momentum transfer
    as the per-link sum (2 f*_q - corr - 2 w_q) c_q (ref: wall.c:941-949
    fnet), in float64, links shared with an earlier walled axis counted
    once.  `plan` is wall_fix_plan's, built here when not given.
    """
    if plan is None:
        plan = wall_fix_plan(model, spec, f.shape[1:], rho0, f.device)
    gw = torch.zeros((3,), dtype=torch.float64, device=f.device)
    fqs = [f[a.src] for a in plan]        # (2, n, plane...) each
    for a, fq in zip(plan, fqs):
        f[a.dst] = _minus64(fq, a.corr)
        if a.keep is not None:
            fq = torch.where(a.keep, fq, torch.zeros((), dtype=fq.dtype,
                                                     device=fq.device))
        link = 2.0 * fq.sum(dim=(-2, -1)).double() - a.small * a.nkeep
        gw = gw + (link[..., None] * a.cq).sum(dim=(0, 1))
    return f, gw


def wall_bounce_back_slip(f_new: torch.Tensor, f_post: torch.Tensor,
                          model: LatticeModel, spec: WallSpec,
                          rho0: float = 1.0) -> torch.Tensor:
    """Bounce-back with partial slip: the incoming distribution is the
    mix (1-s) f_noslip + s f_specular, where the specular partner comes
    from the tangentially adjacent site (ref: wall.c:475-707
    wall_init_boundaries_slip + wall_bbl_slip_kernel).

    Handles faces, edges (slip = face average) and corners (no slip)
    as plane/edge/corner slice updates, processed in order of
    increasing normal rank so overlaps resolve to the most solid case.
    Returns a new tensor.
    """
    cv, rev = model.cv, model.reverse
    shape = f_post.shape[1:]
    f_new = f_new.clone()

    def cvidx(vec):
        for qq in range(model.nvel):
            if all(int(cv[qq][a]) == int(vec[a]) for a in range(3)):
                return qq
        raise ValueError(vec)

    for q in range(1, model.nvel):
        wall_axes = [ax for ax in range(3)
                     if spec.walls[ax] and cv[q][ax] != 0]
        if not wall_axes:
            continue
        p = int(rev[q])
        for nsz in range(1, len(wall_axes) + 1):
            for S in combinations(wall_axes, nsz):
                sl = [slice(None)] * 3
                sides = []
                for ax in S:
                    into = int(cv[q][ax])
                    sl[ax] = shape[ax] - 1 if into > 0 else 0
                    sides.append((ax, into > 0))   # top if stepping up
                sl = tuple(sl)
                # the reference slip kernel has no moving-wall term
                wn = [-int(cv[q][ax]) if ax in S else 0 for ax in range(3)]
                wt = [int(cv[q][a]) + wn[a] for a in range(3)]
                s = spec.slip_value(sides)
                if all(t == 0 for t in wt) or s == 0.0:
                    val = f_post[(q,) + sl]
                else:
                    cq = [-2 * wn[a] - int(cv[q][a]) for a in range(3)]
                    fk = f_post[cvidx(cq)]
                    shifts = [-wt[a] for a in range(3) if wt[a]]
                    dims = [a for a in range(3) if wt[a]]
                    fk = torch.roll(fk, shifts, dims)
                    val = (1.0 - s) * f_post[(q,) + sl] + s * fk[sl]
                f_new[(p,) + sl] = val
    return f_new


def no_flux_at_walls(fluxes, spec: WallSpec):
    """Zero the face fluxes crossing a wall: the wrap face (between site
    N-1 and site 0) of each walled axis (ref: advection_bcs.c
    advection_bcs_no_normal_flux with the halo-wall map).  Returns new
    tensors for the walled axes."""
    if not spec.any:
        return fluxes
    out = []
    for ax in range(3):
        fl = fluxes[ax]
        if spec.walls[ax]:
            nlead = fl.dim() - 3
            sl = [slice(None)] * 3
            sl[ax] = fl.shape[nlead + ax] - 1
            fl = fl.clone()
            fl[(slice(None),) * nlead + tuple(sl)] = 0.0
        out.append(fl)
    return out


def stress_divergence_force_walls(pth: torch.Tensor, spec: WallSpec):
    """Force = -div(pth) with one-sided fluxes at the wall faces, plus
    the momentum flowing into the walls (ref: phi_force_colloid.c
    pth_force_map_kernel / pth_force_wall_kernel).

    Face flux between fluid sites: 0.5 (pth(i) + pth(i+1)); at a wall
    face the one-sided value pth(i) of the adjacent fluid site is used.
    Returns (force (3, X, Y, Z), fwall (3,)): fwall is minus everything
    injected into the fluid (the interior faces telescope; only the
    one-sided wall-face fluxes survive), with the accounting sense of
    ludwig.c:1076 [total] = g + gwall."""
    shape = pth.shape[2:]
    comps = []
    for a in range(3):
        acc = None
        for ax in range(3):
            pax = pth[a, ax]
            face = 0.5 * (pax + torch.roll(pax, -1, ax))
            lo = [slice(None)] * 3
            lo[ax] = 0
            lo = tuple(lo)
            if spec.walls[ax]:
                hi = [slice(None)] * 3
                hi[ax] = shape[ax] - 1
                hi = tuple(hi)
                # one-sided at both wall faces (the wrap face belongs to
                # the high plane's up-neighbour and the low plane's down)
                face[hi] = pax[hi]
            d = face - torch.roll(face, 1, ax)
            if spec.walls[ax]:
                # the down-face of plane 0 is the wall: one-sided pth(0)
                d[lo] = face[lo] - pax[lo]
            acc = d if acc is None else acc + d
        comps.append(-acc)
    force = torch.stack(comps)
    return force, -torch.sum(force, dim=(1, 2, 3))


def wall_velocity_gradient_fix(w, u: torch.Tensor, spec: WallSpec):
    """The central-difference velocity gradient tensor w[a][b] (a 3x3 list
    of tensors) with the wall planes' off-edge neighbour velocity taken as
    the wall's (ref: wall.c wall_set_wall_velocities; halo u = uw).
    Returns a new list; the walled axes' entries are new tensors."""
    if not spec.any:
        return w
    w = [list(row) for row in w]
    for ax in range(3):
        if not spec.walls[ax]:
            continue
        n = u.shape[1 + ax]
        lo, hi, lo2, hi2 = ([slice(None)] * 3 for _ in range(4))
        lo[ax], hi[ax], lo2[ax], hi2[ax] = 0, n - 1, 1, n - 2
        lo, hi, lo2, hi2 = tuple(lo), tuple(hi), tuple(lo2), tuple(hi2)
        for a in range(3):
            ub = float(spec.ubot[a])
            ut = float(spec.utop[a])
            wa = w[a][ax].clone()
            wa[lo] = 0.5 * (u[a][lo2] - ub)
            wa[hi] = 0.5 * (ut - u[a][hi2])
            w[a][ax] = wa
    return w
