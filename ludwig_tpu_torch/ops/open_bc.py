"""Open (inflow/outflow) boundary conditions along one axis.

PyTorch port of ludwig_tpu/ops/open_bc.py (ref:
src/lb_bc_inflow_rhou.c:472-540: incoming links get the polynomial
equilibrium at (rho from the adjacent domain site, prescribed u0);
src/lb_bc_outflow_rhou.c: prescribed rho0 with u from the adjacent
site).  The reference keeps these links in halo sites; here the
periodic wrap values produced by the streaming are overwritten on the
boundary slabs after streaming, using pre-stream hydro fields.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ludwig_tpu_torch.lattice import CS2, LatticeModel


@dataclasses.dataclass(frozen=True)
class OpenBCConfig:
    u0: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # inflow velocity
    rho0: float = 1.0                                 # outflow density


def _feq_col(model: LatticeModel, p: int, rho, u):
    """Polynomial equilibrium for one velocity on a slab."""
    c = model.cv[p]
    w = float(model.wv[p])
    rcs2 = 1.0 / CS2
    udotc = sum(float(c[a]) * u[a] for a in range(3))
    sdotq = 0.0
    for a in range(3):
        for b in range(3):
            s_ab = float(c[a] * c[b]) - (CS2 if a == b else 0.0)
            sdotq = sdotq + s_ab * u[a] * u[b]
    return rho * w * (1.0 + rcs2 * udotc + 0.5 * rcs2 * rcs2 * sdotq)


def _slab(axis: int, idx: int):
    s = [slice(None)] * 3
    s[axis] = idx
    return tuple(s)


def _edge_hydro(f_pre: torch.Tensor, model: LatticeModel, axis: int):
    """(rho of the low slab, rho of the high slab, g of the high slab)."""
    nvel = model.nvel
    rho_in = sum(f_pre[(p,) + _slab(axis, 0)] for p in range(nvel))
    rho_out = sum(f_pre[(p,) + _slab(axis, -1)] for p in range(nvel))
    g_out = [sum(float(model.cv[p][a]) * f_pre[(p,) + _slab(axis, -1)]
                 for p in range(nvel) if model.cv[p][a] != 0)
             for a in range(3)]
    return rho_in, rho_out, g_out


def open_bc_edge_hydro(f_pre: torch.Tensor, model: LatticeModel,
                       axis: int = 0):
    """(rho_in_slab, u_out_slabs): the edge hydro values the NEXT step's
    boundary condition will use (the reference imposes feq with the
    hydro fields of the PREVIOUS collision; ref: ludwig.c:599 update
    before collision vs :823 impose after)."""
    rho_in, rho_out, g_out = _edge_hydro(f_pre, model, axis)
    return rho_in, torch.stack([g / rho_out for g in g_out])


def apply_open_bc(f_new: torch.Tensor, f_pre: torch.Tensor,
                  model: LatticeModel, bc: OpenBCConfig, axis: int = 0,
                  edge_hydro=None) -> torch.Tensor:
    """Fix the boundary slabs normal to `axis` after streaming; returns a
    new tensor.

    f_pre is the pre-stream (post-collision) state used for the local
    hydro values, f_new the streamed state with wrapped values to be
    replaced.  Inflow at the low face (rho from the adjacent domain
    slab, prescribed u0); outflow at the high face (prescribed rho0, u
    from the adjacent slab).

    The reference keeps the BC in the halo planes: the inflow halo site
    takes rho from the adjacent domain site and u = u0; the outflow halo
    takes rho0 and u from the adjacent domain site; the halo is then
    corner-shifted so diagonal propagation sees the right transverse
    neighbour (ref: lb_bc_inflow_rhou.c update / halo_update,
    lb_bc_outflow_rhou.c).  Equivalently: the incoming populations at
    the EDGE planes are feq evaluated with the edge hydro values rolled
    by the transverse velocity components.
    """
    nvel = model.nvel
    taxes = [a for a in range(3) if a != axis]
    dtype, dev = f_new.dtype, f_new.device

    if edge_hydro is not None:
        rho_in, u_out_s = edge_hydro
        u_out = [u_out_s[a] for a in range(3)]
    else:
        rho_in, rho_out_loc, g_out = _edge_hydro(f_pre, model, axis)
        u_out = [g / rho_out_loc for g in g_out]
    rho_out = torch.full_like(rho_in, float(bc.rho0))

    def troll(x, p):
        # shift by the transverse components: value from the halo site
        # (y - cy, z - cz) that propagates into (y, z)
        shifts = [int(model.cv[p][a2]) for a2 in taxes]
        dims = [t for t, c in enumerate(shifts) if c]
        if not dims:
            return x
        return torch.roll(x, [shifts[t] for t in dims], dims)

    shape2 = tuple(f_new[(0,) + _slab(axis, 0)].shape)

    def valid(p):
        # links whose halo site would fall outside the transverse
        # domain extent do not exist (ref: lb_bc_inflow_init_link
        # noffset+ijk bounds checks) - keep the streamed value there
        m = np.ones(shape2, bool)
        for a2, t in zip(taxes, range(2)):
            c = int(model.cv[p][a2])
            if c:
                idx = [slice(None)] * 2
                idx[t] = 0 if c > 0 else shape2[t] - 1
                m[tuple(idx)] = False
        return None if m.all() else torch.as_tensor(m, device=dev)

    f_new = f_new.clone()
    for p in range(1, nvel):
        ca = int(model.cv[p][axis])
        if ca not in (1, -1):
            continue
        edge = _slab(axis, 0 if ca == 1 else -1)
        if ca == 1:
            rin = troll(rho_in, p)
            uu = [torch.full_like(rin, float(bc.u0[a])) for a in range(3)]
            val = _feq_col(model, p, rin, uu).to(dtype)
        else:
            val = _feq_col(model, p, troll(rho_out, p),
                           [troll(u, p) for u in u_out]).to(dtype)
        m = valid(p)
        if m is not None:
            val = torch.where(m, val, f_new[(p,) + edge])
        f_new[(p,) + edge] = val
    return f_new


def apply_open_bc_x(f_new: torch.Tensor, f_pre: torch.Tensor,
                    model: LatticeModel, bc: OpenBCConfig) -> torch.Tensor:
    return apply_open_bc(f_new, f_pre, model, bc, axis=0)
