"""Cahn-Hilliard finite-difference solver for the binary order parameter.

PyTorch port of ludwig_tpu/dynamics/cahn_hilliard.py (ref:
src/phi_cahn_hilliard.c: phi_ch_flux_mu1 :295 two-point diffusive flux,
phi_ch_ufs_kernel :1017 forward-Euler divergence update), in flux form
for exact conservation:

  flux(face) = advective (order-n upwind) + diffusive -M (mu_j - mu_i)
  phi'       = phi - div(flux)

Periodic fluid only: the noise, solid, wall and external-gradient terms
of the JAX package are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ludwig_tpu_torch.ops.advect import (_up, advective_fluxes,
                                         flux_divergence)


@dataclasses.dataclass(frozen=True)
class CahnHilliardParams:
    mobility: float
    advection_order: int = 1


def cahn_hilliard_update(phi: torch.Tensor, mu: torch.Tensor,
                         u: Optional[torch.Tensor],
                         params: CahnHilliardParams) -> torch.Tensor:
    """One forward-Euler CH step; returns the updated phi.

    phi, mu: (X, Y, Z); u: (3, X, Y, Z) fluid velocity, or None for
    diffusion only (`hydrodynamics off`).
    """
    if u is not None:
        fluxes = advective_fluxes(u, phi, params.advection_order)
    else:
        fluxes = [torch.zeros_like(phi) for _ in range(3)]
    m = params.mobility
    fluxes = [fluxes[ax] - m * (_up(mu, ax) - mu) for ax in range(3)]
    return phi - flux_divergence(fluxes)
