"""Cahn-Hilliard finite-difference solver for the binary order parameter.

PyTorch port of ludwig_tpu/dynamics/cahn_hilliard.py (ref:
src/phi_cahn_hilliard.c: phi_ch_flux_mu1 :295 two-point diffusive flux,
phi_ch_ufs_kernel :1017 forward-Euler divergence update), in flux form
for exact conservation:

  flux(face) = advective (order-n upwind) + diffusive -M (mu_j - mu_i)
  phi'       = phi - div(flux)

Fluxes normal to solid faces and halo walls are masked (ref:
src/advection_bcs.c), and an optional fluctuating flux supports the
symmetric_noise free energy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ludwig_tpu_torch.ops.advect import (_down, _up, advective_fluxes,
                                         flux_divergence, no_flux_at_solid)
from ludwig_tpu_torch.ops.walls import no_flux_at_walls


@dataclasses.dataclass(frozen=True)
class CahnHilliardParams:
    mobility: float
    advection_order: int = 1


def cahn_hilliard_update(phi: torch.Tensor, mu: torch.Tensor,
                         u: Optional[torch.Tensor],
                         params: CahnHilliardParams,
                         solid=None, random_flux: Optional[list] = None,
                         wallspec=None, noise_stencil: bool = False,
                         gradmu_ex=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """One forward-Euler CH step; returns the updated phi.

    phi, mu: (X, Y, Z); u: (3, X, Y, Z) fluid velocity, or None for
    diffusion only (`hydrodynamics off`).  solid: (X, Y, Z) bool mask
    (or its advect.blocked_faces) - no flux through solid faces;
    random_flux: optional [fx, fy, fz] fluctuating face fluxes; wallspec:
    halo plane walls, no flux through their faces.  noise_stencil: with
    flux noise the reference switches the diffusive flux to the expanded
    Sumesh et al. form
      fe(i -> i+1) = -0.25 M (mu(i+2) + mu(i+1) - mu(i) - mu(i-1))
    whose Nyquist damping vanishes (ref: phi_ch_dif_flux_kernel).
    gradmu_ex: the external chemical-potential gradient, a constant flux
    -M grad_mu (ref: phi_ch_flux_mu_ext_kernel).
    """
    if u is not None:
        fluxes = advective_fluxes(u, phi, params.advection_order)
    else:
        fluxes = [torch.zeros_like(phi) for _ in range(3)]
    m = params.mobility
    if noise_stencil:
        fluxes = [fluxes[ax] - 0.25 * m * (_up(_up(mu, ax), ax)
                                           + _up(mu, ax) - mu
                                           - _down(mu, ax))
                  for ax in range(3)]
    else:
        fluxes = [fluxes[ax] - m * (_up(mu, ax) - mu) for ax in range(3)]
    if any(g != 0.0 for g in gradmu_ex):
        fluxes = [fluxes[ax] - m * gradmu_ex[ax] for ax in range(3)]
    if random_flux is not None:
        fluxes = [fluxes[ax] + random_flux[ax] for ax in range(3)]
    if solid is not None:
        fluxes = no_flux_at_solid(fluxes, solid)
    if wallspec is not None:
        fluxes = no_flux_at_walls(fluxes, wallspec)
    return phi - flux_divergence(fluxes)
