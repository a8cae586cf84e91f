"""Brazovskii free energy (lamellar / micellar phases).

PyTorch port of ludwig_tpu/fe/brazovskii.py (ref: src/brazovskii.c:
fe_brazovskii_fed/mu/str):

  f  = A/2 phi^2 + B/4 phi^4 + kappa/2 (grad phi)^2 + C/2 (del^2 phi)^2
  mu = A phi + B phi^3 - kappa del^2 phi + C del^4 phi
  s  = p0 delta_ab + kappa d_a phi d_b phi
       - C (d_a phi d_b del^2 phi + d_b phi d_a del^2 phi)

The fields carry grad_delsq_phi and delsq_delsq_phi besides the
symmetric ones (binary.fe_fields with fourth_order; the reference sets
ngrad = 4 for this free energy).  Every expression keeps the JAX
package's operation order; phi^4 is (phi phi)(phi phi) and phi^3 is
phi (phi phi), as XLA's integer power computes them.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class BrazovskiiFE:
    a: float
    b: float
    kappa: float
    c: float

    @property
    def amplitude(self) -> float:
        """A0 of the lamellar phase (ref: fe_brazovskii_amplitude)."""
        return math.sqrt(4.0 * (1.0 + self.kappa * self.kappa /
                                (4.0 * self.b * self.c)) / 3.0)

    @property
    def wavelength(self) -> float:
        """2 pi / k0 with k0^2 = -kappa/2C (kappa < 0)."""
        return 2.0 * math.pi / math.sqrt(-self.kappa / (2.0 * self.c))

    # fields: phi, grad_phi, delsq_phi, grad_delsq_phi, delsq_delsq_phi

    def fed(self, fields):
        phi = fields["phi"]
        g = fields["grad_phi"]
        d2 = fields["delsq_phi"]
        g2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
        phi2 = phi * phi
        return (0.5 * self.a * phi * phi + 0.25 * self.b * (phi2 * phi2)
                + 0.5 * self.kappa * g2 + 0.5 * self.c * d2 * d2)

    def mu(self, fields):
        phi = fields["phi"]
        return (self.a * phi + self.b * (phi * (phi * phi))
                - self.kappa * fields["delsq_phi"]
                + self.c * fields["delsq_delsq_phi"])

    def stress(self, fields):
        """(3, 3, X, Y, Z) thermodynamic stress."""
        phi = fields["phi"]
        g = fields["grad_phi"]
        d2 = fields["delsq_phi"]
        d4 = fields["delsq_delsq_phi"]
        gd2 = fields["grad_delsq_phi"]
        g2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
        gdotgd2 = g[0] * gd2[0] + g[1] * gd2[1] + g[2] * gd2[2]
        phi2 = phi * phi
        p0 = (0.5 * self.a * phi * phi + 0.75 * self.b * (phi2 * phi2)
              - self.kappa * phi * d2 + 0.5 * self.kappa * g2
              + self.c * phi * d4 + 0.5 * self.c * d2 * d2
              + self.c * gdotgd2)
        eye = torch.eye(3, dtype=phi.dtype, device=phi.device).reshape(
            (3, 3) + (1,) * phi.dim())
        return (eye * p0[None, None]
                + self.kappa * g[:, None] * g[None, :]
                - self.c * (g[:, None] * gd2[None, :]
                            + g[None, :] * gd2[:, None]))
