"""Lees-Edwards sliding periodic boundaries for the LB distributions.

PyTorch port of ludwig_tpu/ops/lees_edwards.py (ref: src/leesedwards.c
geometry :240-241 dx_sep = Lx/nplanes, dx_min = dx_sep/2;
src/model_le.c: le_reproject :111-205, le_displace_and_interpolate
:219-300).  nplanes equally-spaced planes normal to x, each with sliding
velocity uy; the block above each plane moves at +uy relative to the
block below.

Two stages applied to post-collision distributions, before streaming:

1. reprojection: for the column just below a plane, distributions with
   c_x = +1 are Galilean-boosted by du = -uy (and +uy for c_x = -1 just
   above):  f_p += w_p (rho du.c_p / cs^2 + ds:Q_p / (2 cs^4)),
   ds_ab = g_a du_b + du_a g_b + rho du_a du_b.

2. displacement: the same crossing distributions are shifted along y by
   the accumulated slide dy = uy t with linear interpolation.

The step counter t, the plane speed and the slide are tensors of the
state's dtype, so every rounding is the JAX package's on every device.
The displacement is an index computed on the device: no host sync.
Only the crossing rows change, so only they are boosted, displaced and
written.  The boost keeps the JAX package's operation order (rho and g
summed in velocity order, the nonzero ds:Q terms in a-major order), so
float64 agrees with it to the last bit.

`apply_le_fused_sharded` (the sharded-lattice variant) is not ported:
the port runs on one card.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ludwig_tpu_torch.lattice import CS2, LatticeModel, lb_model


@dataclasses.dataclass(frozen=True)
class LeesEdwardsConfig:
    nplanes: int
    uy: float
    nx: int                      # total lattice extent along x
    omega: float = 0.0           # oscillatory shear frequency (0 = steady)

    @property
    def plane_cols(self) -> Tuple[int, ...]:
        """0-based column index just below each plane (the plane sits
        between col and col+1).  Ref ic (1-based) = dx_min + p dx_sep."""
        dx_sep = self.nx / self.nplanes
        dx_min = 0.5 * dx_sep
        return tuple(int(dx_min + p * dx_sep) - 1
                     for p in range(self.nplanes))

    def uy_now(self, t: torch.Tensor) -> torch.Tensor:
        """Instantaneous plane speed (ref: lees_edw_plane_uy_now;
        oscillatory: uy cos(omega t)), a tensor of t's dtype."""
        uy = _t(self.uy, t)
        if self.omega == 0.0:
            return uy
        return uy * torch.cos(self.omega * t)

    def displacement(self, t: torch.Tensor) -> torch.Tensor:
        """Accumulated slide (ref: lees_edw_buffer_displacement;
        oscillatory: uy sin(omega t)/omega), a tensor of t's dtype."""
        uy = _t(self.uy, t)
        if self.omega == 0.0:
            return uy * t
        return uy * torch.sin(self.omega * t) / _t(self.omega, t)


def _t(value, like: torch.Tensor) -> torch.Tensor:
    """A Python number (the step counter, the plane speed) as a 0-dim
    tensor of `like`'s dtype, rounded to nearest as the JAX package's
    jnp.asarray(t, f.dtype) rounds it.  A fill, not a copy from the
    host: a copy from pageable host memory would wait for the card to
    finish the step before the post-pass could be queued."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


@lru_cache(maxsize=None)
def _cross_tables(nvel: int):
    """Per side (cx = +1, -1): the crossing velocities and, for each,
    the coefficients the boost needs: w_p, c_py, and Q_ab = c_a c_b -
    cs2 delta_ab for the five (a, b) of a y boost, a-major."""
    model = lb_model(nvel)
    cv = np.asarray(model.cv)
    out = {}
    for cx in (+1, -1):
        rows = [p for p in range(nvel) if int(cv[p][0]) == cx]
        q = {ab: [float(cv[p][ab[0]] * cv[p][ab[1]])
                  - (CS2 if ab[0] == ab[1] else 0.0) for p in rows]
             for ab in ((0, 1), (1, 0), (1, 1), (1, 2), (2, 1))}
        out[cx] = dict(rows=rows, w=[float(model.wv[p]) for p in rows],
                       cy=[float(cv[p][1]) for p in rows], q=q)
    return out


def _moments(slab: torch.Tensor, model: LatticeModel, cv1: torch.Tensor):
    """(rho, g) of a (..., nvel, Y, Z) slab, summed in velocity order
    as the JAX package's _boost_column sums (every c_pa is 0 or +-1, so
    each product is exact and a zero term adds nothing); cv1 (4, nvel)
    holds (1, c_p)."""
    acc = torch.zeros(slab.shape[:-3] + (4,) + slab.shape[-2:],
                      dtype=slab.dtype, device=slab.device)
    for p in range(model.nvel):
        acc = torch.addcmul(acc, cv1[:, p, None, None],
                            slab[..., p:p + 1, :, :])
    return acc[..., 0:1, :, :], [acc[..., 1 + a:2 + a, :, :]
                                  for a in range(3)]


def _boost_coefs(model: LatticeModel, cxs, dtype, device):
    """(rows (C, n) int64, coefficients): per side column k the
    crossing rows (c_x = cxs[k]) and their w_p, c_py and Q_ab as
    (C, n, 1, 1) tensors of the state's dtype, and (1, c_p) as a (4,
    nvel) table for the moments."""
    tab = _cross_tables(model.nvel)

    def per_col(key, ab=None):
        vals = [tab[cx][key] if ab is None else tab[cx][key][ab]
                for cx in cxs]
        return torch.as_tensor(vals, dtype=dtype, device=device)[..., None,
                                                                 None]

    coefs = {"w": per_col("w"), "cy": per_col("cy"),
             "cv1": torch.as_tensor(
                 np.concatenate([np.ones((model.nvel, 1)),
                                 np.asarray(model.cv, np.float64)], axis=1).T,
                 dtype=dtype, device=device)}
    coefs.update({ab: per_col("q", ab) for ab in _DS_PAIRS})
    rows = torch.as_tensor([tab[cx]["rows"] for cx in cxs], device=device)
    return rows, coefs


_DS_PAIRS = ((0, 1), (1, 0), (1, 1), (1, 2), (2, 1))


def _boost_cross(slab: torch.Tensor, model: LatticeModel, rows, coefs,
                 du: torch.Tensor) -> torch.Tensor:
    """Reprojected crossing rows of column slabs (C, nvel, Y, Z): column
    k's rows `rows[k]` (_boost_coefs), boosted by du[k] along y (du (C,
    1, 1, 1)).  Returns (C, n, Y, Z)."""
    rcs2 = 1.0 / CS2
    fx = torch.gather(slab, 1, rows[..., None, None].expand(
        -1, -1, slab.shape[2], slab.shape[3]))
    rho, g = _moments(slab, model, coefs["cv1"])
    # the nonzero ds_ab of a y boost (du_x = du_z = 0), in the JAX
    # package's operation order
    ds = {(0, 1): g[0] * du, (1, 0): du * g[0],
          (1, 1): (g[1] * du + du * g[1]) + rho * du * du,
          (1, 2): du * g[2], (2, 1): g[2] * du}
    sdotq = None
    for ab in _DS_PAIRS:
        term = ds[ab] * coefs[ab]
        sdotq = term if sdotq is None else sdotq + term
    udotc = du * coefs["cy"]
    return fx + coefs["w"] * (rho * udotc * rcs2
                              + 0.5 * sdotq * rcs2 * rcs2)


def _wrapped_mod(x: torch.Tensor, n: int) -> torch.Tensor:
    """jnp.mod(x, n) for n > 0: the C remainder, moved into [0, n)."""
    m = torch.fmod(x, n)
    return torch.where(m < 0, m + n, m)


def _shift_index(dd: torch.Tensor, ny: int):
    """(jdy (C,) int64, fr (C, 1, 1, 1)) of slides dd (C,): the whole and
    fractional parts of dd mod ny (ref: model_le.c:219-300 j1 = jc + jdy,
    j2 = j1 + 1)."""
    dd = _wrapped_mod(dd, ny)
    fl = torch.floor(dd)
    return fl.to(torch.int64), (dd - fl)[:, None, None, None]


def _interp_rows(v: torch.Tensor, jdy: torch.Tensor,
                 fr: torch.Tensor) -> torch.Tensor:
    """Rows v (C, n, Y, Z) sampled at y + dy (linear interpolation,
    periodic; the slide's parts jdy (C,) and fr of each column):
    (1 - fr) v(y + jdy) + fr v(y + jdy + 1)."""
    C, n, Y, Z = v.shape
    i1 = torch.remainder(torch.arange(Y, device=v.device) + jdy[:, None], Y)

    def take(i):
        return torch.gather(v, 2, i[:, None, :, None].expand(C, n, Y, Z))

    return (1.0 - fr) * take(i1) + fr * take(torch.remainder(i1 + 1, Y))


def _side_cols(cfg: LeesEdwardsConfig):
    """Per plane, its two sides in the JAX package's order: (column,
    c_x of the crossing rows, sign of the boost, sign of the slide)."""
    out = []
    for col in cfg.plane_cols:
        cup = (col + 1) % cfg.nx
        out += [(col, +1, -1.0, +1.0), (cup, -1, +1.0, -1.0)]
    return out


def apply_lb_le(f: torch.Tensor, model: LatticeModel,
                cfg: LeesEdwardsConfig, t) -> torch.Tensor:
    """Apply LE boundary conditions to post-collision distributions
    (both stages), returning a new f (nvel, X, Y, Z).  Plane by plane
    and side by side, each side reading the columns as the sides before
    it left them (the JAX package's order)."""
    tt = _t(t, f)
    uy, dy = cfg.uy_now(tt), cfg.displacement(tt)
    Y = f.shape[2]
    f = f.clone()
    coefs = {cx: _boost_coefs(model, (cx,), f.dtype, f.device)
             for cx in (+1, -1)}
    for col, cx, su, sd in _side_cols(cfg):
        rows, coef = coefs[cx]
        new = _boost_cross(f[:, col][None], model, rows, coef,
                           (su * uy).reshape(1, 1, 1, 1))
        jdy, fr = _shift_index((sd * dy).reshape(1), Y)
        f[rows[0], col] = _interp_rows(new, jdy, fr)[0]
    return f


@dataclasses.dataclass(frozen=True)
class _LEFix:
    """Index tensors of apply_le_fused for one lattice: per side column
    k (C of them), the gather of the post-collision column (`src`,
    broadcasting to (C, nvel, Y, Z)), the crossing rows and the boost's
    coefficients (_boost_coefs), where the re-streamed crossing rows go
    (`dst`, broadcasting to (C, n, Y, Z)), and the boost's and the
    slide's signs (C,) in the state's dtype."""
    rows: torch.Tensor
    coefs: dict
    src: tuple
    dst: tuple
    su: torch.Tensor
    sd: torch.Tensor


def le_fix_plan(model: LatticeModel, cfg: LeesEdwardsConfig, size,
                dtype, device) -> _LEFix:
    """The gather and write indices and the boost's coefficients of
    apply_le_fused for a state of `dtype` on `device`; a step builds
    them once."""
    X, Y, Z = size
    cv = np.asarray(model.cv, np.int64)
    sides = _side_cols(cfg)
    tab = _cross_tables(model.nvel)
    cols = np.array([c for c, _cx, _su, _sd in sides])
    cxs = tuple(cx for _c, cx, _su, _sd in sides)
    rows = np.array([tab[cx]["rows"] for cx in cxs])          # (C, n)

    def dev(a, kind=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=kind, device=device)

    brows, coefs = _boost_coefs(model, cxs, dtype, device)
    y, z = np.arange(Y), np.arange(Z)
    cy, cz = cv[rows, 1], cv[rows, 2]
    return _LEFix(
        rows=brows, coefs=coefs,
        src=(dev(np.arange(model.nvel)[None, :, None, None]),
             dev(((cols[:, None] + cv[None, :, 0]) % X)[..., None, None]),
             dev(((y[None, :] + cv[:, 1:2]) % Y)[None, :, :, None]),
             dev(((z[None, :] + cv[:, 2:3]) % Z)[None, :, None, :])),
        # a crossing row re-streams to (x + c_x, y + c_y, z + c_z)
        dst=(dev(rows[..., None, None]),
             dev(((cols + np.array(cxs)) % X)[:, None, None, None]),
             dev(((y + cy[..., None]) % Y)[..., None]),
             dev(((z + cz[..., None]) % Z)[..., None, :])),
        su=dev([s for _c, _cx, s, _sd in sides], dtype),
        sd=dev([s for _c, _cx, _su, s in sides], dtype))


def apply_le_fused(f: torch.Tensor, model: LatticeModel,
                   cfg: LeesEdwardsConfig, t, plan=None) -> torch.Tensor:
    """LE boundary conditions conjugated through streaming, for the fused
    collide+stream step's output f (nvel, X, Y, Z), unpadded.

    The fused step applies stream@collide in one pass; the reference
    order is stream@LE@collide (ref: model_le.c:57 runs before
    propagation, ludwig.c:811).  Streaming is an exact per-velocity
    shift, so LE commutes to a post-pass stream@LE@stream^-1: every
    plane's post-collision plane-adjacent columns are reassembled by
    un-shifting each velocity from the fused output (one gather), the
    reprojection + displacement applied, and the crossing rows re-shifted
    and written back (one index_put_), after ALL gathers - planes one
    or two columns apart read columns other planes write.  O(nplanes
    nvel Y Z) column work around the unmodified O(volume) kernel.
    Writes f in place and returns it.  `plan` is le_fix_plan's, built
    here when not given.
    """
    if plan is None:
        plan = le_fix_plan(model, cfg, f.shape[1:], f.dtype, f.device)
    tt = _t(t, f)
    uy, dy = cfg.uy_now(tt), cfg.displacement(tt)
    slab = f[plan.src]                                   # (C, nvel, Y, Z)
    new = _boost_cross(slab, model, plan.rows, plan.coefs,
                       (plan.su * uy).reshape(-1, 1, 1, 1))
    jdy, fr = _shift_index(plan.sd * dy, f.shape[2])
    f[plan.dst] = _interp_rows(new, jdy, fr)
    return f


def make_le_post(model: LatticeModel, cfg: LeesEdwardsConfig):
    """post(f, t) -> apply_le_fused(f, model, cfg, t) with the plan built
    once for each device and dtype it meets (a step's post-pass)."""
    plans = {}

    def post(f: torch.Tensor, t) -> torch.Tensor:
        key = (f.device, f.dtype)
        if key not in plans:
            plans[key] = le_fix_plan(model, cfg, f.shape[1:], f.dtype,
                                     f.device)
        return apply_le_fused(f, model, cfg, t, plan=plans[key])

    return post


def _interp_y(col: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Sample a (.., Y, Z) column at y + dy (linear, periodic; dy a
    0-dim tensor)."""
    ny = col.shape[-2]
    jdy, fr = _shift_index(dy.reshape(1), ny)
    y = torch.arange(ny, device=col.device)
    i1 = torch.remainder(y + jdy, ny)
    fr = fr.reshape(())
    return ((1.0 - fr) * col.index_select(-2, i1)
            + fr * col.index_select(-2, torch.remainder(i1 + 1, ny)))


def le_xneighbor(field: torch.Tensor, cfg: LeesEdwardsConfig, t, sign: int,
                 uy_component: bool = False) -> torch.Tensor:
    """Value of `field` at the x+sign neighbour, Lees-Edwards aware.

    Standard periodic roll everywhere, except columns adjacent to a
    plane, whose cross-plane neighbour is sampled y-displaced by the
    accumulated slide (the reference's LE buffer columns,
    ref: leesedwards.c:367-474 interpolation tables).  For the y
    velocity component (uy_component=True) the frame jump +-uy is added
    so the physical field is continuous across the plane
    (ref: hydro buffer frame correction).

    field: (..., X, Y, Z); sign = +1 gives field(x+1), -1 field(x-1).
    """
    ax = field.dim() - 3
    base = torch.roll(field, -sign, dims=ax).movedim(ax, 0).clone()
    src = field.movedim(ax, 0)
    tt = _t(t, field)
    uy, dy = cfg.uy_now(tt), cfg.displacement(tt)
    for col in cfg.plane_cols:
        cup = (col + 1) % cfg.nx
        if sign == +1:
            # sites at x = col look up across the plane to col+1
            val = _interp_y(src[cup], dy)
            if uy_component:
                val = val + uy
            base[col] = val
        else:
            # sites at x = col+1 look down across the plane to col
            val = _interp_y(src[col], -dy)
            if uy_component:
                val = val - uy
            base[cup] = val
    return base.movedim(0, ax)


def le_steady_profile(cfg: LeesEdwardsConfig, x: np.ndarray) -> np.ndarray:
    """Analytic steady sawtooth u_y(x) in the stored (per-block) frame:
    with the reference's sign conventions the blocks carry slope
    +nplanes uy / X and each plane a -uy jump (the apparent velocity of
    the block above, seen from below, is -uy)."""
    slope = cfg.nplanes * cfg.uy / cfg.nx
    u = slope * (x + 0.5)
    for col in cfg.plane_cols:
        u = u - cfg.uy * (x > col)
    return u - u.mean()


def le_init_shear_profile(lb_cfg, cfg: LeesEdwardsConfig) -> torch.Tensor:
    """Initial distributions with the steady sawtooth shear profile and
    the matching off-equilibrium stress (ref: model_le.c:639-700
    lb_le_init_shear_profile; input key LE_init_profile), made in
    float64 on the host and placed on lb_cfg's device and dtype."""
    model = lb_cfg.model
    rho0 = lb_cfg.rho0
    eta = lb_cfg.eta_shear
    gammadot = cfg.nplanes * cfg.uy / cfg.nx
    dx_sep = cfg.nx / cfg.nplanes
    dx_min = 0.5 * dx_sep
    xglobal = np.arange(1, cfg.nx + 1, dtype=np.float64) - 0.5
    nplane = np.floor((dx_min + xglobal) / dx_sep)
    uy = xglobal * gammadot - cfg.uy * nplane          # (NX,)

    size = lb_cfg.size
    f = np.zeros((model.nvel,) + tuple(size))
    cs2 = 1.0 / 3.0
    rcs2 = 3.0
    for p in range(model.nvel):
        cy = float(model.cv[p][1])
        cdotu = cy * uy                                 # (NX,)
        sdotq = 0.0
        for i in range(3):
            for j in range(3):
                qij = (float(model.cv[p][i] * model.cv[p][j])
                       - cs2 * (i == j))
                uij = (uy * uy if (i == 1 and j == 1) else 0.0)
                gij = gammadot if (i == 0 and j == 1) else 0.0
                sdotq = sdotq + (rho0 * uij - eta * gij) * qij
        fp = model.wv[p] * (rho0 + rcs2 * rho0 * cdotu
                            + 0.5 * rcs2 * rcs2 * sdotq)
        f[p] = np.broadcast_to(np.asarray(fp).reshape(-1, 1, 1), size)
    return torch.as_tensor(f, dtype=lb_cfg.tdtype, device=lb_cfg.device)
