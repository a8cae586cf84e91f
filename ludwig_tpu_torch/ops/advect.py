"""Advective face fluxes for order-parameter transport, orders 1 and 2.

PyTorch port of ludwig_tpu/ops/advect.py (ref: src/advection.c:53-61,
advection_le_1st_kernel :526, advection_2nd_kernel :694); orders 3-5 are
not ported yet.  On a uniform periodic lattice the west flux of cell i
equals the east flux of cell i-1, so one face-flux tensor per axis is
materialised:

  flux[ax](i) = flux through the face between site i and site i+1 (ax).

The divergence at site i is then  sum_ax flux[ax](i) - flux[ax](i-1).
"""

from __future__ import annotations

import torch

from ludwig_tpu_torch.ops.stencil import roll3

_AX = ((1, 0, 0), (0, 1, 0), (0, 0, 1))


def _up(phi, ax):
    """Value at site i+1 along ax (periodic)."""
    return roll3(phi, tuple(-s for s in _AX[ax]), first_axis=phi.dim() - 3)


def _down(phi, ax):
    return roll3(phi, _AX[ax], first_axis=phi.dim() - 3)


def face_velocity(u: torch.Tensor, ax: int) -> torch.Tensor:
    """u_face = 0.5 (u_ax(i) + u_ax(i+1))."""
    return 0.5 * (u[ax] + _up(u[ax], ax))


def advective_fluxes(u: torch.Tensor, phi: torch.Tensor,
                     order: int = 1) -> list:
    """[flux_x, flux_y, flux_z] face fluxes of phi carried by u.

    order 1: first-order upwind (ref: advection_le_1st_kernel)
    order 2: centred            (ref: advection_2nd_kernel)
    """
    fluxes = []
    for ax in range(3):
        uf = face_velocity(u, ax)
        if order == 1:
            up_phi = torch.where(uf > 0.0, phi, _up(phi, ax))
            fluxes.append(uf * up_phi)
        elif order == 2:
            fluxes.append(uf * 0.5 * (phi + _up(phi, ax)))
        else:
            raise NotImplementedError(
                f"advection order {order} is not ported yet (have 1, 2)")
    return fluxes


def flux_divergence(fluxes) -> torch.Tensor:
    """div F at site i: sum_ax F(i) - F(i-1)."""
    div = None
    for ax in range(3):
        d = fluxes[ax] - _down(fluxes[ax], ax)
        div = d if div is None else div + d
    return div
