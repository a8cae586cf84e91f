"""Propagation (streaming) and link bounce-back boundaries.

PyTorch port of ludwig_tpu/ops/stream.py (ref: src/propagation.c:43-96,
src/wall.c:489-707).  The whole lattice pull-streams with ``torch.roll``
per velocity; periodicity is the roll's wrap-around.

Arrays are always (nvel, NX, NY, NZ); 2-D models use NZ == 1 and have
cv[:, 2] == 0 so the z-axis roll is a no-op.

Solid boundaries use the standard half-way bounce-back on links: a site
pulling from a solid site instead receives its own reflected
post-collision distribution, with the moving-wall momentum term
+2 w_p rho0 (c_p . u_w) / cs^2  when the wall moves (ref: src/wall.c
wall_bbl, src/wall.c:901 moving distributions).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ludwig_tpu_torch.lattice import CS2, LatticeModel, lb_model


@lru_cache(maxsize=16)
def _reverse_index(nvel: int, device: str) -> torch.Tensor:
    """The reversed-velocity index on `device`, made once: a step copies
    nothing from the host."""
    return torch.as_tensor(lb_model(nvel).reverse, device=device)


@lru_cache(maxsize=16)
def _wall_corr(nvel: int, wall_u: tuple, rho0: float, dtype,
               device: str) -> torch.Tensor:
    """The moving-wall terms 2 w_p rho0 (c_p . u_w) / cs2, (nvel, 1, 1, 1)
    on `device`."""
    model = lb_model(nvel)
    cdotu = np.asarray(model.cv, np.float64) @ np.asarray(wall_u, np.float64)
    corr = (2.0 * rho0 / CS2) * model.wv * cdotu
    return torch.as_tensor(corr, dtype=dtype,
                           device=device).reshape(-1, 1, 1, 1)


def _roll3(x: torch.Tensor, shift, first_axis: int) -> torch.Tensor:
    """Roll the three spatial axes by an integer (sx, sy, sz) shift."""
    shift = tuple(int(s) for s in shift)
    if not any(shift):
        return x
    dims = tuple(first_axis + i for i in range(3) if shift[i] != 0)
    shifts = tuple(s for s in shift if s != 0)
    return torch.roll(x, shifts, dims)


def stream(f: torch.Tensor, model: LatticeModel) -> torch.Tensor:
    """Pull-streaming: f'_p(r) = f_p(r - c_p), fully periodic."""
    return torch.stack([_roll3(f[p], model.cv[p], 0)
                        for p in range(model.nvel)])


def solid_neighbour_masks(model: LatticeModel,
                          solid: torch.Tensor) -> torch.Tensor:
    """For each velocity p, mask of sites whose pull-source is solid.

    solid: (NX, NY, NZ) bool, True at solid (wall/porous/colloid) sites.
    Returns (nvel, NX, NY, NZ) bool.
    """
    return torch.stack([_roll3(solid, model.cv[p], 0)
                        for p in range(model.nvel)])


def stream_bounce_back(f_post: torch.Tensor,
                       model: LatticeModel,
                       solid: Optional[torch.Tensor] = None,
                       wall_u=None,
                       rho0: float = 1.0) -> torch.Tensor:
    """Stream with half-way bounce-back at solid sites.

    Args:
      f_post: (nvel, NX, NY, NZ) post-collision distributions.
      solid:  (NX, NY, NZ) bool solid mask, or None for fully periodic.
      wall_u: (3,) uniform wall velocity (moving plane walls), or None.

    Returns:
      Streamed distributions; solid sites keep their pre-stream values
      (the reference never propagates meaningfully into solid sites).
    """
    f_new = stream(f_post, model)
    if solid is None:
        return f_new

    from_solid = solid_neighbour_masks(model, solid)
    f_bb = f_post[_reverse_index(model.nvel, str(f_post.device))]
    if wall_u is not None and any(float(v) != 0.0 for v in np.asarray(wall_u)):
        # replaced incoming f_p = f*_{p_bar} - 2 w_{p_bar} rho (c_{p_bar}.u_w)/cs2
        #                       = f*_{p_bar} + 2 w_p rho (c_p.u_w)/cs2
        f_bb = f_bb + _wall_corr(model.nvel,
                                 tuple(float(v) for v in np.asarray(wall_u)),
                                 float(rho0), f_post.dtype,
                                 str(f_post.device))
    f_new = torch.where(from_solid, f_bb, f_new)
    return torch.where(solid[None], f_post, f_new)


def wall_momentum_transfer(f_post: torch.Tensor, model: LatticeModel,
                           solid: torch.Tensor) -> torch.Tensor:
    """Net momentum given to the walls this step (for conservation stats).

    Each bounced link p at fluid site r transfers 2 f*_p(r) c_p to the
    solid (ref: src/wall.c:1279-1299 momentum accounting).
    """
    from ludwig_tpu_torch.ops.collide import unrolled_matvec

    from_solid = solid_neighbour_masks(model, solid)
    live = torch.logical_and(from_solid, torch.logical_not(solid)[None])
    # link p at r pulls from solid: the outgoing f*_rev(p) hits the wall
    f_out = f_post[_reverse_index(model.nvel, str(f_post.device))]
    contrib = torch.where(live, f_out, torch.zeros((), dtype=f_post.dtype,
                                                   device=f_post.device))
    sums = [torch.sum(contrib[p]) for p in range(model.nvel)]
    return -2.0 * torch.stack(unrolled_matvec(
        model.cv.T.astype(np.float64), sums))


def wall_solid_mask(shape, walls, dtype=bool):
    """Plane-wall solid mask: one solid plane at each face of a walled axis.

    The reference keeps walls in the halo region outside an L-site fluid
    domain (ref: src/wall.c); here the wall occupies the outermost lattice
    plane of the stored array.
    """
    m = np.zeros(shape, dtype=dtype)
    for ax, w in enumerate(walls):
        if w:
            lo = [slice(None)] * len(shape)
            lo[ax] = 0
            hi = [slice(None)] * len(shape)
            hi[ax] = shape[ax] - 1
            m[tuple(lo)] = True
            m[tuple(hi)] = True
    return m
