"""Surfactant free energy (van der Sman / van der Graaf).

PyTorch port of ludwig_tpu/fe/surfactant.py (ref: src/surfactant.c:
fe_surf_fed/mu/str).  Two order parameters: composition phi and
surfactant concentration psi in (0, 1).  The JAX package's operation
order is kept (x^2 is x x, phi^3 phi (phi phi), phi^4 (phi phi)(phi
phi), as XLA's integer power computes them).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class SurfactantFE:
    a: float
    b: float
    kappa: float
    kt: float
    epsilon: float
    beta: float
    w: float

    @property
    def xi0(self) -> float:
        return math.sqrt(-2.0 * self.kappa / self.a)

    @property
    def sigma0(self) -> float:
        """Clean-interface tension (ref: fe_surf_sigma)."""
        return math.sqrt(-8.0 * self.kappa * self.a ** 3 / (9.0 * self.b ** 2))

    # fields: phi, psi, grad_phi, grad_psi, delsq_phi, delsq_psi

    def fed(self, fields):
        phi, psi = fields["phi"], fields["psi"]
        gphi = fields["grad_phi"]
        g2 = gphi[0] * gphi[0] + gphi[1] * gphi[1] + gphi[2] * gphi[2]
        phi2 = phi * phi
        f = (0.5 * self.a * phi * phi + 0.25 * self.b * (phi2 * phi2)
             + 0.5 * self.kappa * g2)
        f = f + self.kt * (psi * torch.log(psi)
                           + (1.0 - psi) * torch.log(1.0 - psi))
        f = f - 0.5 * self.epsilon * psi * g2
        f = f - 0.5 * self.beta * psi * psi * g2
        f = f + 0.5 * self.w * psi * phi * phi
        return f

    def mu(self, fields):
        """(mu_phi, mu_psi)."""
        phi, psi = fields["phi"], fields["psi"]
        gphi, gpsi = fields["grad_phi"], fields["grad_psi"]
        d2phi = fields["delsq_phi"]
        gdot = gphi[0] * gpsi[0] + gphi[1] * gpsi[1] + gphi[2] * gpsi[2]
        g2 = gphi[0] * gphi[0] + gphi[1] * gphi[1] + gphi[2] * gphi[2]

        mu_phi = (self.a * phi + self.b * (phi * (phi * phi))
                  - self.kappa * d2phi
                  + self.w * phi * psi
                  + self.epsilon * (psi * d2phi + gdot)
                  + self.beta * psi * (psi * d2phi + 2.0 * gdot))
        mu_psi = (self.kt * (torch.log(psi) - torch.log(1.0 - psi))
                  + 0.5 * self.w * phi * phi
                  - 0.5 * self.epsilon * g2
                  - self.beta * psi * g2)
        return mu_phi, mu_psi

    def stress(self, fields):
        phi, psi = fields["phi"], fields["psi"]
        gphi, gpsi = fields["grad_phi"], fields["grad_psi"]
        d2phi = fields["delsq_phi"]
        gdot = gphi[0] * gpsi[0] + gphi[1] * gpsi[1] + gphi[2] * gpsi[2]
        g2 = gphi[0] * gphi[0] + gphi[1] * gphi[1] + gphi[2] * gphi[2]
        phi2 = phi * phi

        p0 = (0.5 * self.a * phi * phi + 0.75 * self.b * (phi2 * phi2)
              - self.kappa * (phi * d2phi - 0.5 * g2)
              - self.kt * torch.log(1.0 - psi)
              + self.w * psi * phi * phi
              + self.epsilon * phi * (gdot + psi * d2phi)
              + self.beta * psi * (2.0 * phi * gdot + phi * psi * d2phi
                                   - 0.5 * psi * g2))
        coef = self.kappa - self.epsilon * psi - self.beta * psi * psi
        eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
        return (eye[:, :, None, None, None] * p0[None, None]
                + coef[None, None] * gphi[:, None] * gphi[None, :])
