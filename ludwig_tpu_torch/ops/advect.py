"""Advective face fluxes for order-parameter transport, orders 1-5.

PyTorch port of ludwig_tpu/ops/advect.py (ref: src/advection.c:53-61,
advection_le_1st_kernel :526, advection_2nd_kernel :694,
advection_le_3rd_kernel_v :965, the 4th- and 5th-order kernels
:1321-1390) and of its no-flux condition at solid faces (ref:
src/advection_bcs.c).  On a uniform periodic lattice the west flux of cell i
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
    order 3: third-order upwind-biased with coefficients
             (-0.213933, 0.927865, 0.286067)  (ref: advection_le_3rd_*)
    order 4: centred 4-point (-1/16, 9/16, 9/16, -1/16)
    order 5: 5-point upwind-biased (ref: advection.c:1321-1390)
    """
    fluxes = []
    for ax in range(3):
        uf = face_velocity(u, ax)
        if order == 1:
            up_phi = torch.where(uf > 0.0, phi, _up(phi, ax))
            fluxes.append(uf * up_phi)
        elif order == 2:
            fluxes.append(uf * 0.5 * (phi + _up(phi, ax)))
        elif order == 3:
            a1, a2, a3 = -0.213933, 0.927865, 0.286067
            phi_m1 = _down(phi, ax)
            phi_p1 = _up(phi, ax)
            phi_p2 = _up(phi_p1, ax)
            pos = a1 * phi_m1 + a2 * phi + a3 * phi_p1
            neg = a1 * phi_p2 + a2 * phi_p1 + a3 * phi
            fluxes.append(uf * torch.where(uf > 0.0, pos, neg))
        elif order == 4:
            a1, a2 = 1.0 / 16.0, 9.0 / 16.0
            phi_m1 = _down(phi, ax)
            phi_p1 = _up(phi, ax)
            phi_p2 = _up(phi_p1, ax)
            fluxes.append(uf * (-a1 * phi_m1 + a2 * phi + a2 * phi_p1
                                - a1 * phi_p2))
        elif order == 5:
            a1, a2, a3, a4, a5 = (0.055453, -0.305147, 0.916054,
                                  0.361520, -0.027880)
            phi_m2 = _down(_down(phi, ax), ax)
            phi_m1 = _down(phi, ax)
            phi_p1 = _up(phi, ax)
            phi_p2 = _up(phi_p1, ax)
            phi_p3 = _up(phi_p2, ax)
            pos = (a1 * phi_m2 + a2 * phi_m1 + a3 * phi + a4 * phi_p1
                   + a5 * phi_p2)
            neg = (a1 * phi_p3 + a2 * phi_p2 + a3 * phi_p1 + a4 * phi
                   + a5 * phi_m1)
            fluxes.append(uf * torch.where(uf >= 0.0, pos, neg))
        else:
            raise ValueError(f"advection order {order} not implemented")
    return fluxes


def flux_divergence(fluxes) -> torch.Tensor:
    """div F at site i: sum_ax F(i) - F(i-1)."""
    div = None
    for ax in range(3):
        d = fluxes[ax] - _down(fluxes[ax], ax)
        div = d if div is None else div + d
    return div


def blocked_faces(solid: torch.Tensor) -> tuple:
    """Per axis, the faces (i, i+1) with a solid site on either side."""
    return tuple(torch.logical_or(solid, _up(solid, ax)) for ax in range(3))


def no_flux_at_solid(fluxes, solid) -> list:
    """Mask face fluxes where either side of the face is solid (ref:
    src/advection_bcs.c advection_bcs_no_normal_flux).  solid: the (X, Y,
    Z) bool mask, or its blocked_faces made once beforehand."""
    blocked = (solid if isinstance(solid, (tuple, list))
               else blocked_faces(solid))
    zero = torch.zeros((), dtype=fluxes[0].dtype, device=fluxes[0].device)
    return [torch.where(blocked[ax], zero, fluxes[ax]) for ax in range(3)]
