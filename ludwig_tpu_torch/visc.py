"""Composition-dependent viscosity models.

PyTorch port of ludwig_tpu/visc.py (ref: src/visc.h,
src/visc_arrhenius.c:211-216):

  eta(phi) = eta_minus^{(1 - phi/phistar)/2} eta_plus^{(1 + phi/phistar)/2}

The per-site eta feeds the collision's local relaxation times
(collide(..., eta_local=...), ref: collision.c:393-400).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ViscArrhenius:
    eta_minus: float
    eta_plus: float
    phistar: float = 1.0

    def eta(self, phi: torch.Tensor) -> torch.Tensor:
        p = phi / self.phistar
        return (self.eta_minus ** (0.5 * (1.0 - p))
                * self.eta_plus ** (0.5 * (1.0 + p)))
