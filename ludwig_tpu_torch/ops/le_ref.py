"""Lees-Edwards machinery for finite-difference fields.

PyTorch port of the 7- and 27-point slices of ludwig_tpu/ops/le_ref.py
(ref: src/field.c:490-596 4-point Lagrange buffer columns, src/hydro.c
hydro_lees_edwards linear interpolation with the +/-uy frame jump,
src/gradient_3d_7pt_fluid.c grad_3d_7pt_fluid_le,
src/gradient_3d_27pt_fluid.c and its _le correction, src/advection.c LE
kernels, src/phi_force.c phi_force_flux + phi_force_flux_fix_local).

No buffer columns are materialised: a cross-plane x neighbour is the
real column sampled at the time-dependent y displacement

  field values : 4-pt Lagrange at dy = +/- uy (t-1)   (t clamped at 0)
  hydro u      : linear at dy = +/- uy t, +/- uy jump on u_y
  fluxes (fix) : linear at dy = +/- uy (t-1)

Every plane is handled at once: a column of a field (..., X, Y, Z) is
taken for all planes as (..., P, Y, Z), the plane axis in place of x,
and a slab of K columns about each plane as (..., K, P, Y, Z).  Writes
go to distinct columns (planes are at least two columns apart), so one
index_copy stands for the JAX package's plane-by-plane loop; where a
pass reads what an earlier pass wrote (the stress flux at the plane
face), every plane's writes land before the next pass reads.

The displacement is computed on the device from the step counter: no
host sync.  The fourth-order (Brazovskii) forms take two passes of the
5- or 27-point operator, the second over the first's Laplacian.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ludwig_tpu_torch.ops.lees_edwards import (LeesEdwardsConfig, _t,
                                               _wrapped_mod)
from ludwig_tpu_torch.ops.stencil import dab_7pt, grad27_terms, roll3

GRADIENT = "3d_7pt_fluid"


def _rolled(col: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """jnp.roll(col, shift, axis=-2) for a 0-dim int64 shift tensor:
    out[y] = col[(y - shift) mod Y]."""
    ny = col.shape[-2]
    y = torch.arange(ny, device=col.device)
    return col.index_select(-2, torch.remainder(y - shift, ny))


def sample_cubic(col: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """4-point Lagrange sample of a (..., Y, Z) column at displacement
    dy, a 0-dim tensor (ref: field.c:552-586)."""
    ny = col.shape[-2]
    dy = _wrapped_mod(dy, ny)
    jdy = torch.floor(dy)
    fr = 1.0 - (dy - jdy)
    j = jdy.to(torch.int64)
    f0 = _rolled(col, j + 2)   # col[y - jdy - 2]
    f1 = _rolled(col, j + 1)
    f2 = _rolled(col, j)
    f3 = _rolled(col, j - 1)
    r6 = 1.0 / 6.0
    return (-r6 * fr * (fr - 1.0) * (fr - 2.0) * f0
            + 0.5 * (fr * fr - 1.0) * (fr - 2.0) * f1
            - 0.5 * fr * (fr + 1.0) * (fr - 2.0) * f2
            + r6 * fr * (fr * fr - 1.0) * f3)


def sample_linear(col: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Linear sample at displacement dy (ref: hydro.c:545-556,
    phi_cahn_hilliard.c flux fix): fr col[y-jdy-1] + (1-fr) col[y-jdy]."""
    ny = col.shape[-2]
    dy = _wrapped_mod(dy, ny)
    jdy = torch.floor(dy)
    fr = dy - jdy
    j = jdy.to(torch.int64)
    return fr * _rolled(col, j + 1) + (1.0 - fr) * _rolled(col, j)


@lru_cache(maxsize=64)
def _offset_index(cfg: LeesEdwardsConfig, offsets: tuple,
                  device: str) -> torch.Tensor:
    """(c + d) mod X for d in `offsets` (outer) and every plane column c
    (inner), as a (K P,) int64 tensor on `device`; cached, so a step
    makes no host-to-device copy."""
    return torch.as_tensor([(c + d) % cfg.nx for d in offsets
                            for c in cfg.plane_cols], device=device)


class LEContext:
    """Per-step sampling helper for all planes at once (every plane moves
    at uy, so all share one displacement).  `like` gives the dtype and
    device of the displacements."""

    def __init__(self, cfg: LeesEdwardsConfig, t, like: torch.Tensor):
        self.cfg = cfg
        tt = _t(t, like)
        # the reference clamps negative times to zero (initialisation;
        # ref: lees_edw_buffer_displacement "if (t < 0.0) t = 0.0")
        self.dy_field = cfg.displacement(torch.clamp(tt - 1.0, min=0.0))
        self.dy_hydro = cfg.displacement(tt)
        self.uy_jump = cfg.uy        # steady frame jump (buffer_du)
        self.nplanes = cfg.nplanes
        self._device = str(like.device)

    def index(self, *offsets: int) -> torch.Tensor:
        """Columns c + d of every plane, offsets outer: (K P,)."""
        return _offset_index(self.cfg, offsets, self._device)

    def col(self, field: torch.Tensor, d: int) -> torch.Tensor:
        """Column c + d of every plane, unsampled: (..., P, Y, Z)."""
        return field.index_select(field.dim() - 3, self.index(d))

    def slab(self, field: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """Columns c + lo .. c + hi of every plane: (..., K, P, Y, Z)."""
        ax = field.dim() - 3
        s = field.index_select(ax, self.index(*range(lo, hi + 1)))
        return s.unflatten(ax, (hi - lo + 1, self.nplanes))

    # -- frame-aware column fetch ---------------------------------------

    def col_field(self, field: torch.Tensor, d: int,
                  frame_lo: bool) -> torch.Tensor:
        """Column c + d of `field` as seen from the lower (frame_lo) or
        upper side of the plane after column c, for every plane."""
        col = self.col(field, d)
        if frame_lo and d > 0:
            return sample_cubic(col, self.dy_field)
        if (not frame_lo) and d <= 0:
            return sample_cubic(col, -self.dy_field)
        return col

    def col_u(self, u: torch.Tensor, d: int, frame_lo: bool) -> torch.Tensor:
        """Velocity column (3, P, Y, Z) with the +/-uy frame jump on u_y
        (ref: hydro_lees_edwards, ule)."""
        col = self.col(u, d)
        if frame_lo and d > 0:
            col = sample_linear(col, self.dy_hydro)
            col[1] += self.uy_jump
        elif (not frame_lo) and d <= 0:
            col = sample_linear(col, -self.dy_hydro)
            col[1] -= self.uy_jump
        return col

    def put(self, arr: torch.Tensor, ax: int, d: int,
            val: torch.Tensor) -> torch.Tensor:
        """arr with its columns c + d (axis ax) of every plane set to val
        (the plane axis in ax's place): a new tensor."""
        return arr.index_copy(ax, self.index(d), val)


def _colroll(col: torch.Tensor, dy_: int, dz_: int) -> torch.Tensor:
    """Neighbour fetch within a (..., Y, Z) column."""
    out = col
    if dy_:
        out = torch.roll(out, -dy_, -2)
    if dz_:
        out = torch.roll(out, -dz_, -1)
    return out


# -- slabs of K columns about each plane: (..., K, P, Y, Z) ----------

def replace_col(s: torch.Tensor, k: int, v: torch.Tensor) -> torch.Tensor:
    """Slab s (..., K, P, Y, Z) with its k-th column set to v (..., P, Y,
    Z): a new tensor."""
    return torch.cat([s[..., :k, :, :, :], v.unsqueeze(-4),
                      s[..., k + 1:, :, :, :]], dim=-4)


def slab_neighbours(s: torch.Tensor, first: int, n: int, repl=None):
    """Columns first .. first + n - 1 of the slab s (..., K, P, Y, Z),
    with the ones keyed in repl (by index in the result) replaced."""
    out = s[..., first:first + n, :, :, :]
    for k, v in (repl or {}).items():
        out = replace_col(out, k, v)
    return out


def face_slab(s: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """0.5 (s[k] + s[k + 1]) for k = lo .. lo + n - 1 of a slab."""
    return 0.5 * (s[..., lo:lo + n, :, :, :]
                  + s[..., lo + 1:lo + n + 1, :, :, :])


def yz_div(fy, fz):
    """(fy - fy(y-1)) + fz - fz(z-1) of (..., Y, Z) face fluxes."""
    return fy - torch.roll(fy, 1, -2) + fz - torch.roll(fz, 1, -1)


def le_force_cols(pth6: torch.Tensor, pth_b1: torch.Tensor,
                  pth_d0: torch.Tensor, area: float) -> torch.Tensor:
    """-div(pth) (3, 4, P, Y, Z) at columns c-1 .. c+2 of every plane
    from the stress at c-2 .. c+3 (pth6 (3, 3, 6, P, Y, Z), LE-aware at c
    and c+1) and at the buffer columns (3, 3, P, Y, Z): two-sided plane
    fluxes with the per-plane mean correction (ref: phi_force_flux +
    phi_force_flux_fix_local), le_stress_force's arithmetic."""
    rows = []
    for a in range(3):
        fea = face_slab(pth6[a, 0], 0, 5)        # faces c-2 .. c+2
        fe_c = 0.5 * (pth6[a, 0, 2] + pth_b1[a, 0])
        fw_c = 0.5 * (pth_d0[a, 0] + pth6[a, 0, 3])
        corr = torch.sum(-fe_c + fw_c, dim=(-2, -1),
                         keepdim=True) * (0.5 / area)
        fea = replace_col(fea, 2, fe_c + corr)
        west = replace_col(fea[0:4], 2, fw_c - corr)
        p = pth6[a, :, 1:5]
        fya = 0.5 * (p[1] + torch.roll(p[1], -1, -2))
        fza = 0.5 * (p[2] + torch.roll(p[2], -1, -1))
        rows.append(-(fea[1:5] - west + yz_div(fya, fza)))
    return torch.stack(rows)


def le_gradient(phi: torch.Tensor, cfg: LeesEdwardsConfig, t,
                gradient: str = GRADIENT):
    """(grad (3, ..., X, Y, Z), delsq) with LE-aware x neighbours at the
    plane columns (ref: grad_3d_7pt_fluid_operator + _le; the JAX
    package's other stencils take the 7-point form, as its le_gradient
    does)."""
    if gradient == "3d_27pt_fluid":
        return le_gradient_27pt(phi, cfg, t)
    return le_gradient_7pt(phi, cfg, t)


def le_gradient_7pt(phi: torch.Tensor, cfg: LeesEdwardsConfig, t):
    ctx = LEContext(cfg, t, phi)
    ax = phi.dim() - 3

    def sh(d, a):
        return torch.roll(phi, -d, ax + a)

    xp, xm = sh(1, 0), sh(-1, 0)
    yp, ym = sh(1, 1), sh(-1, 1)
    zp, zm = sh(1, 2), sh(-1, 2)
    # plane-column corrections: column c sees c+1 through the lower
    # frame, column c+1 sees c through the upper one
    xp = ctx.put(xp, ax, 0, ctx.col_field(phi, 1, True))
    xm = ctx.put(xm, ax, 1, ctx.col_field(phi, 0, False))
    grad = torch.stack([0.5 * (xp - xm), 0.5 * (yp - ym), 0.5 * (zp - zm)])
    delsq = xp + xm + yp + ym + zp + zm - 6.0 * phi
    return grad, delsq


def col_grad7(pm1, p0, pp1):
    """7-point gradient and Laplacian of columns p0 (..., Y, Z) from their
    x neighbours pm1 and pp1."""
    yp, ym = torch.roll(p0, -1, -2), torch.roll(p0, 1, -2)
    zp, zm = torch.roll(p0, -1, -1), torch.roll(p0, 1, -1)
    grad = torch.stack([0.5 * (pp1 - pm1), 0.5 * (yp - ym), 0.5 * (zp - zm)])
    d2 = pp1 + pm1 + yp + ym + zp + zm - 6.0 * p0
    return grad, d2


def _buffer_cols(phi, ctx: LEContext, up: bool):
    """{-1, 0, +1}: the x-neighbour chain of the buffer column adjacent
    to each plane (ref: lees_edw_ic_to_buff chains)."""
    if up:
        return {-1: ctx.col(phi, 0), 0: ctx.col_field(phi, 1, True),
                1: ctx.col_field(phi, 2, True)}
    return {-1: ctx.col_field(phi, -1, False),
            0: ctx.col_field(phi, 0, False), 1: ctx.col(phi, 1)}


def le_buffer_fields(phi, ctx: LEContext, up: bool,
                     gradient: str = GRADIENT):
    """(phi_b, grad_b, delsq_b) at the buffer column adjacent to every
    plane (above it where `up`, below it otherwise): the displaced column
    with gradients computed through the buffer chain (ref:
    grad_3d_7pt_fluid_le, nh = 1; the 27-point chain for 3d_27pt_fluid)."""
    colm = _buffer_cols(phi, ctx, up)
    if gradient == "3d_27pt_fluid":
        gx, gy, gz, d2 = grad27_terms(_col_fetch(colm), colm[0])
        return colm[0], torch.stack([gx, gy, gz]), d2
    p0 = colm[0]
    yp, ym = _colroll(p0, 1, 0), _colroll(p0, -1, 0)
    zp, zm = _colroll(p0, 0, 1), _colroll(p0, 0, -1)
    grad = torch.stack([0.5 * (colm[1] - colm[-1]),
                        0.5 * (yp - ym), 0.5 * (zp - zm)])
    d2 = colm[1] + colm[-1] + yp + ym + zp + zm - 6.0 * p0
    return p0, grad, d2


def dab_from_cols(pm1, p0, pp1) -> torch.Tensor:
    """d_a d_b tensor (3, 3, ..., Y, Z) of columns p0 from their x
    neighbours (the 7-point dab stencil, ops.stencil.dab_7pt's
    arithmetic)."""
    colm = {-1: pm1, 0: p0, 1: pp1}

    def v(dx, dy_, dz_):
        return _colroll(colm[dx], dy_, dz_)

    offs = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
    rows = [[None] * 3 for _ in range(3)]
    for a in range(3):
        oa = offs[a]
        rows[a][a] = v(*oa) - 2.0 * p0 + v(*[-x for x in oa])
        for b in range(a + 1, 3):
            ob = offs[b]
            pp = v(*[oa[i] + ob[i] for i in range(3)])
            pm = v(*[oa[i] - ob[i] for i in range(3)])
            mp = v(*[ob[i] - oa[i] for i in range(3)])
            mm = v(*[-(oa[i] + ob[i]) for i in range(3)])
            rows[a][b] = 0.25 * (pp - pm - mp + mm)
            rows[b][a] = rows[a][b]
    return torch.stack([torch.stack(r) for r in rows])


def le_dab_7pt(phi: torch.Tensor, cfg: LeesEdwardsConfig, t) -> torch.Tensor:
    """d_a d_b phi (3, 3, ..., X, Y, Z) with LE-aware x neighbours at the
    plane columns (ref: grad_3d_7pt_dab_compute +
    grad_3d_7pt_dab_le_correct)."""
    ctx = LEContext(cfg, t, phi)
    ax = phi.dim() - 3
    dab = torch.stack([torch.stack(r) for r in dab_7pt(phi)])
    # column c sees its x+1 neighbour through the lower-frame buffer;
    # column c+1 sees x-1 through the upper-frame buffer
    dab = ctx.put(dab, 2 + ax, 0, dab_from_cols(
        ctx.col(phi, -1), ctx.col(phi, 0), ctx.col_field(phi, 1, True)))
    return ctx.put(dab, 2 + ax, 1, dab_from_cols(
        ctx.col_field(phi, 0, False), ctx.col(phi, 1), ctx.col(phi, 2)))


def le_buffer_dab(phi: torch.Tensor, ctx: LEContext, up: bool):
    """dab at the buffer column adjacent to every plane (the dab analogue
    of le_buffer_fields' gradient chain)."""
    colm = _buffer_cols(phi, ctx, up)
    return dab_from_cols(colm[-1], colm[0], colm[1])


ADV_STENCIL = {1: (0, 1), 2: (0, 1), 3: (-1, 0, 1, 2), 4: (-1, 0, 1, 2),
               5: (-2, -1, 0, 1, 2, 3)}


def upwind_face(phi_cols, uf, order: int):
    """Advective flux through the face between columns 0 and +1, given a
    dict of field columns by offset (ref: advection.c kernels; the
    coefficient and branch structure of each order)."""
    if order == 1:
        return uf * torch.where(uf > 0.0, phi_cols[0], phi_cols[1])
    if order == 2:
        return uf * 0.5 * (phi_cols[0] + phi_cols[1])
    if order == 3:
        a1, a2, a3 = -0.213933, 0.927865, 0.286067
        pos = a1 * phi_cols[-1] + a2 * phi_cols[0] + a3 * phi_cols[1]
        neg = a1 * phi_cols[2] + a2 * phi_cols[1] + a3 * phi_cols[0]
        return uf * torch.where(uf > 0.0, pos, neg)
    if order == 4:
        a1, a2 = 1.0 / 16.0, 9.0 / 16.0
        return uf * (-a1 * phi_cols[-1] + a2 * phi_cols[0]
                     + a2 * phi_cols[1] - a1 * phi_cols[2])
    if order == 5:
        a = (0.055453, -0.305147, 0.916054, 0.361520, -0.027880)
        pos = (a[0] * phi_cols[-2] + a[1] * phi_cols[-1]
               + a[2] * phi_cols[0] + a[3] * phi_cols[1]
               + a[4] * phi_cols[2])
        neg = (a[0] * phi_cols[3] + a[1] * phi_cols[2] + a[2] * phi_cols[1]
               + a[3] * phi_cols[0] + a[4] * phi_cols[-1])
        return uf * torch.where(uf >= 0.0, pos, neg)
    raise ValueError(f"advection order {order}")


def le_face_u(u, ctx: LEContext, d: int, frame_lo: bool):
    """Face velocity u_x between columns c + d and c + d + 1 of every
    plane, both seen from one frame."""
    return 0.5 * (ctx.col_u(u, d, frame_lo)[0]
                  + ctx.col_u(u, d + 1, frame_lo)[0])


def le_advective_fluxes(field, u, ctx: LEContext, order: int):
    """(fe_x, fw, fy, fz): LE-aware advective face fluxes of a (..., X, Y,
    Z) field (ref: advection.c LE kernels).  fe_x holds the east fluxes
    with the plane faces evaluated from the lower frame; fw (..., P, Y,
    Z) is the plane face evaluated from the upper frame (the west flux
    of column c+1)."""
    ax = field.dim() - 3
    sten = ADV_STENCIL[order]

    def xs(x, d):
        return torch.roll(x, -d, x.dim() - 3)

    def fcol(d, lo):
        return {k: ctx.col_field(field, d + k, lo) for k in sten}

    ufx = 0.5 * (u[0] + torch.roll(u[0], -1, 0))
    fe_x = upwind_face({d: xs(field, d) for d in sten}, ufx, order)
    span = max(sten)
    for d in range(-span + 1, 1):                # lower-frame faces
        fe_x = ctx.put(fe_x, ax, d, upwind_face(
            fcol(d, True), le_face_u(u, ctx, d, True), order))
    for d in range(1, span):                     # upper-frame faces
        fe_x = ctx.put(fe_x, ax, d, upwind_face(
            fcol(d, False), le_face_u(u, ctx, d, False), order))
    fw = upwind_face(fcol(0, False), le_face_u(u, ctx, 0, False), order)

    ufy = 0.5 * (u[1] + torch.roll(u[1], -1, 1))
    ufz = 0.5 * (u[2] + torch.roll(u[2], -1, 2))
    fy = upwind_face({d: torch.roll(field, -d, ax + 1) for d in sten}, ufy,
                     order)
    fz = upwind_face({d: torch.roll(field, -d, ax + 2) for d in sten}, ufz,
                     order)
    return fe_x, fw, fy, fz


def le_flux_divergence(fe_x, fw, fy, fz, ctx: LEContext):
    """Divergence at each site with the separate west flux fw at the
    plane+1 columns (no averaging fix; ref: beris_edwards update)."""
    ax = fe_x.dim() - 3
    dy_ = fy - torch.roll(fy, 1, ax + 1)
    dz_ = fz - torch.roll(fz, 1, ax + 2)
    div = fe_x - torch.roll(fe_x, 1, ax) + fy - torch.roll(fy, 1, ax + 1) \
        + fz - torch.roll(fz, 1, ax + 2)
    rest = ctx.col(dy_, 1) + ctx.col(dz_, 1)
    return ctx.put(div, ax, 1, ctx.col(fe_x, 1) - fw + rest)


def le_stress_force(pth: torch.Tensor, pth_b1: torch.Tensor,
                    pth_d0: torch.Tensor, ctx: LEContext,
                    area: float) -> torch.Tensor:
    """Force (3, X, Y, Z) = -div(pth) with two-sided plane fluxes and the
    per-plane mean correction (ref: phi_force_flux +
    phi_force_flux_fix_local).  pth (3, 3, X, Y, Z); pth_b1, pth_d0
    (3, 3, P, Y, Z) the stresses at the buffer columns above and below
    each plane."""
    comps = []
    for a in range(3):
        fea = 0.5 * (pth[a, 0] + torch.roll(pth[a, 0], -1, 0))
        fe_c = 0.5 * (ctx.col(pth[a, 0], 0) + pth_b1[a, 0])
        fw_c = 0.5 * (pth_d0[a, 0] + ctx.col(pth[a, 0], 1))
        corr = torch.sum(-fe_c + fw_c, dim=(-2, -1),
                         keepdim=True) * (0.5 / area)
        fea = ctx.put(fea, 0, 0, fe_c + corr)
        fw_fix = fw_c - corr
        fya = 0.5 * (pth[a, 1] + torch.roll(pth[a, 1], -1, 1))
        fza = 0.5 * (pth[a, 2] + torch.roll(pth[a, 2], -1, 2))
        dfy = fya - torch.roll(fya, 1, 1)
        dfz = fza - torch.roll(fza, 1, 2)
        d = (fea - torch.roll(fea, 1, 0) + fya - torch.roll(fya, 1, 1)
             + fza - torch.roll(fza, 1, 2))
        d = ctx.put(d, 0, 1, ctx.col(fea, 1) - fw_fix + ctx.col(dfy, 1)
                    + ctx.col(dfz, 1))
        comps.append(-d)
    return torch.stack(comps)


def _col_fetch(colm):
    """v(dx, dy, dz) over the x chain colm {-1, 0, 1} of (..., Y, Z)
    columns, each y/z shift made once."""
    cache = {}

    def v(dx, dy_, dz_):
        key = (dx, dy_, dz_)
        if key not in cache:
            cache[key] = _colroll(colm[dx], dy_, dz_)
        return cache[key]
    return v


def le_gradient_27pt(phi: torch.Tensor, cfg: LeesEdwardsConfig, t):
    """27-point gradient/Laplacian with LE-aware plane columns (ref:
    gradient_3d_27pt_fluid.c + its _le correction): the periodic stencil,
    then columns c and c+1 of every plane recomputed from their x chains
    with the cross-plane column sampled in the other frame."""
    ctx = LEContext(cfg, t, phi)
    ax = phi.dim() - 3
    cache = {}

    def v_full(dx, dy_, dz_):
        key = (dx, dy_, dz_)
        if key not in cache:
            cache[key] = roll3(phi, (-dx, -dy_, -dz_), first_axis=ax)
        return cache[key]

    gx, gy, gz, d2 = grad27_terms(v_full, phi)
    grad = torch.stack([gx, gy, gz])
    # column c sees c+1 through the lower frame; c+1 sees c through the
    # upper one
    lo = {-1: ctx.col(phi, -1), 0: ctx.col(phi, 0),
          1: ctx.col_field(phi, 1, True)}
    hi = {-1: ctx.col_field(phi, 0, False), 0: ctx.col(phi, 1),
          1: ctx.col(phi, 2)}
    for d, colm in ((0, lo), (1, hi)):
        gxc, gyc, gzc, d2c = grad27_terms(_col_fetch(colm), colm[0])
        grad = ctx.put(grad, 1 + ax, d, torch.stack([gxc, gyc, gzc]))
        d2 = ctx.put(d2, ax, d, d2c)
    return grad, d2


def _op5(pm1, p0, pp1):
    """5-point gradient (z component zero) and Laplacian of columns p0
    (..., Y, Z) from their x neighbours (ref: gradient_2d_5pt_fluid.c
    operator body)."""
    yp, ym = _colroll(p0, 1, 0), _colroll(p0, -1, 0)
    d2 = pp1 + pm1 + yp + ym - 4.0 * p0
    return (torch.stack([0.5 * (pp1 - pm1), 0.5 * (yp - ym),
                         torch.zeros_like(p0)]), d2)


def _full5(phi):
    """The periodic 5-point gradient and Laplacian of a whole field."""
    ax = phi.dim() - 3
    xp, xm = torch.roll(phi, -1, ax), torch.roll(phi, 1, ax)
    yp, ym = torch.roll(phi, -1, ax + 1), torch.roll(phi, 1, ax + 1)
    return (torch.stack([0.5 * (xp - xm), 0.5 * (yp - ym),
                         torch.zeros_like(phi)]),
            xp + xm + yp + ym - 4.0 * phi)


def _op27(pm1, p0, pp1):
    """27-point gradient and Laplacian of columns p0 from their x-neighbour
    columns (ref: gradient_3d_27pt_fluid.c stencil body with icm1/icp1
    resolved to explicit columns)."""
    gx, gy, gz, d2 = grad27_terms(_col_fetch({-1: pm1, 0: p0, 1: pp1}), p0)
    return torch.stack([gx, gy, gz]), d2


def _full27(phi):
    """The periodic 27-point gradient and Laplacian of a whole field."""
    ax = phi.dim() - 3
    cache = {}

    def v(dx, dy_, dz_):
        key = (dx, dy_, dz_)
        if key not in cache:
            cache[key] = roll3(phi, (-dx, -dy_, -dz_), first_axis=ax)
        return cache[key]

    gx, gy, gz, d2 = grad27_terms(v, phi)
    return torch.stack([gx, gy, gz]), d2


def _le_fields_d4(phi: torch.Tensor, cfg: LeesEdwardsConfig, t, op, full):
    """Two LE-aware passes of one stencil (op on columns, full on the
    whole field): the level-2 fields of phi, then the same operator over
    delsq, reading the buffer-column delsq of the first pass through the
    buffer chain (ref: grad_*_fluid_d2, then _d4, each with its _le
    pass).  The chain is anchored at the real column: the -x neighbour of
    the first buffer column above a plane is the undisplaced plane
    column (lees_edw_ic_to_buff(le, ic, 0) == ic)."""
    ctx = LEContext(cfg, t, phi)
    ax = phi.dim() - 3
    grad, d2 = full(phi)
    b1, b2, b3 = (ctx.col_field(phi, d, True) for d in (1, 2, 3))
    d0, dm1, dm2 = (ctx.col_field(phi, d, False) for d in (0, -1, -2))

    g_c, d2_c = op(ctx.col(phi, -1), ctx.col(phi, 0), b1)
    g_b1, d2_b1 = op(ctx.col(phi, 0), b1, b2)
    d2_b2 = op(b1, b2, b3)[1]
    g_cu, d2_cu = op(d0, ctx.col(phi, 1), ctx.col(phi, 2))
    g_d0, d2_d0 = op(dm1, d0, ctx.col(phi, 1))
    d2_dm1 = op(dm2, dm1, d0)[1]
    grad = ctx.put(ctx.put(grad, 1 + ax, 0, g_c), 1 + ax, 1, g_cu)
    d2 = ctx.put(ctx.put(d2, ax, 0, d2_c), ax, 1, d2_cu)

    gd2, d4 = full(d2)
    g4_c, d4_c = op(ctx.col(d2, -1), ctx.col(d2, 0), d2_b1)
    g4_b1, d4_b1 = op(ctx.col(d2, 0), d2_b1, d2_b2)
    g4_cu, d4_cu = op(d2_d0, ctx.col(d2, 1), ctx.col(d2, 2))
    g4_d0, d4_d0 = op(d2_dm1, d2_d0, ctx.col(d2, 1))
    gd2 = ctx.put(ctx.put(gd2, 1 + ax, 0, g4_c), 1 + ax, 1, g4_cu)
    d4 = ctx.put(ctx.put(d4, ax, 0, d4_c), ax, 1, d4_cu)
    bufs = {"b1": (b1, g_b1, d2_b1, g4_b1, d4_b1),
            "d0": (d0, g_d0, d2_d0, g4_d0, d4_d0)}
    return grad, d2, gd2, d4, bufs


def le_fields_2d5pt_d4(phi: torch.Tensor, cfg: LeesEdwardsConfig, t):
    """Level-4 LE fields of the 2d_5pt stencil (Brazovskii; the JAX
    package's sheared step takes it for every stencil but 3d_27pt_fluid):
    (grad, delsq, grad_delsq, delsq_delsq, bufs), bufs["b1"] / ["d0"] the
    (phi, grad, delsq, grad_delsq, delsq_delsq) at the first buffer
    column above / below every plane, (..., P, Y, Z) (what the plane-face
    chemical potential and stress need; ref: gradient_2d_5pt_fluid.c
    grad_2d_5pt_fluid_d2 at nextra = 2, then _d4 at nextra = 1)."""
    return _le_fields_d4(phi, cfg, t, _op5, _full5)


def le_fields_27pt_d4(phi: torch.Tensor, cfg: LeesEdwardsConfig, t):
    """Level-4 LE fields of the 3d_27pt stencil (Brazovskii in 3-D; ref:
    gradient_3d_27pt_fluid.c grad_3d_27pt_fluid_d2 / _d4 and
    grad_3d_27pt_fluid_le), laid out as le_fields_2d5pt_d4's."""
    return _le_fields_d4(phi, cfg, t, _op27, _full27)
