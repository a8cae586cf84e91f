"""Symmetric phi^4 free energy for binary fluids.

PyTorch port of ludwig_tpu/fe/symmetric.py (ref: src/symmetric.c:278-360):

  f(phi) = A/2 phi^2 + B/4 phi^4 + kappa/2 (grad phi)^2
  mu     = A phi + B phi^3 - kappa del^2 phi
  P_ab   = [A/2 phi^2 + 3B/4 phi^4 - kappa phi del^2 phi
            - kappa/2 (grad phi)^2] delta_ab + kappa (d_a phi)(d_b phi)

A < 0, B > 0 gives two phases at phi* = +-sqrt(-A/B) with interface
width xi = sqrt(-2 kappa / A) and surface tension
sigma = 4 kappa phi*^2 / (3 xi).

Every expression keeps the JAX package's operation order (phi^4 is
(phi phi)(phi phi), as XLA's integer power squares), so float64 results
agree with it to the last bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class SymmetricFE:
    a: float
    b: float
    kappa: float

    # -- analytic properties (ref: symmetric.c fe_symm_interfacial_*) ------

    @property
    def phi_star(self) -> float:
        return math.sqrt(-self.a / self.b)

    @property
    def xi0(self) -> float:
        return math.sqrt(-2.0 * self.kappa / self.a)

    @property
    def sigma(self) -> float:
        return 4.0 * self.kappa * self.phi_star ** 2 / (3.0 * self.xi0)

    # -- fields contract ---------------------------------------------------
    # fields: {"phi": (X,Y,Z), "grad_phi": (3,X,Y,Z), "delsq_phi": (X,Y,Z)}

    def fed(self, fields):
        phi = fields["phi"]
        g = fields["grad_phi"]
        g2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
        return ((0.5 * self.a + 0.25 * self.b * phi * phi) * phi * phi
                + 0.5 * self.kappa * g2)

    def mu(self, fields):
        phi = fields["phi"]
        return (self.a * phi + self.b * phi * phi * phi
                - self.kappa * fields["delsq_phi"])

    def stress(self, fields):
        """(3, 3, X, Y, Z) thermodynamic stress."""
        phi = fields["phi"]
        g = fields["grad_phi"]
        d2 = fields["delsq_phi"]
        g2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
        phi2 = phi * phi
        p0 = (0.5 * self.a * phi * phi + 0.75 * self.b * (phi2 * phi2)
              - self.kappa * phi * d2 - 0.5 * self.kappa * g2)
        eye = torch.eye(3, dtype=phi.dtype, device=phi.device).reshape(
            (3, 3) + (1,) * phi.dim())
        return eye * p0[None, None] + self.kappa * g[:, None] * g[None, :]
