"""Ternary (three-phase) free energy, Semprebon et al.

PyTorch port of ludwig_tpu/fe/ternary.py (ref: src/fe_ternary.c:
fe_ternary_fed/mu/str).  Order parameters (phi, psi) with rho == 1:
component densities are
  c1 = (rho + phi - psi)/2, c2 = (rho - phi - psi)/2, c3 = psi.
The JAX package's operation order is kept (x^2 is x x).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TernaryFE:
    alpha: float
    kappa1: float
    kappa2: float
    kappa3: float
    # Solid wetting parameters; only h1, h2 are independent, h3 from
    # h1/k1 + h2/k2 + h3/k3 = 0 (ref: fe_ternary_rt.c:63-77)
    h1: float = 0.0
    h2: float = 0.0
    h3: float = 0.0

    # fields: phi, psi, grad_phi, grad_psi, delsq_phi, delsq_psi

    def fed(self, fields):
        phi, psi = fields["phi"], fields["psi"]
        gphi, gpsi = fields["grad_phi"], fields["grad_psi"]
        a2 = self.alpha * self.alpha
        rho = 1.0

        def sq(x):
            return x * x

        dsum1 = sum(sq(gphi[a] - gpsi[a]) for a in range(3))
        s1 = rho + phi - psi
        s2 = 2.0 + psi - rho - phi
        fe1 = (0.03125 * self.kappa1 * s1 * s1 * s2 * s2
               + 0.125 * a2 * self.kappa1 * dsum1)

        dsum2 = sum(sq(-gphi[a] - gpsi[a]) for a in range(3))
        s1 = rho - phi - psi
        s2 = 2.0 + psi - rho + phi
        fe2 = (0.03125 * self.kappa2 * s1 * s1 * s2 * s2
               + 0.125 * a2 * self.kappa2 * dsum2)

        g2psi = sum(sq(gpsi[a]) for a in range(3))
        fe3 = 0.5 * self.kappa3 * psi * psi * sq(1.0 - psi)
        fe4 = 0.5 * a2 * self.kappa3 * g2psi
        return fe1 + fe2 + fe3 + fe4

    def mu(self, fields):
        """(mu_phi, mu_psi)  (ref: fe_ternary_mu, rho terms dropped as
        rho == 1 and delsq_rho == 0)."""
        phi, psi = fields["phi"], fields["psi"]
        d2phi, d2psi = fields["delsq_phi"], fields["delsq_psi"]
        k1, k2, k3 = self.kappa1, self.kappa2, self.kappa3
        a2 = self.alpha * self.alpha
        krr = 0.25 * a2 * (k1 + k2)
        kfp = 0.25 * a2 * (k2 - k1)
        kpp = 0.25 * a2 * (k1 + k2 + 4.0 * k3)
        rho = 1.0

        t1 = (rho + phi - psi) * (rho + phi - psi - 2.0) * (rho + phi - psi - 1.0)
        t2 = (rho - phi - psi) * (rho - phi - psi - 2.0) * (rho - phi - psi - 1.0)

        mu_phi = (0.125 * k1 * t1 - 0.125 * k2 * t2
                  - kfp * d2psi - krr * d2phi)
        mu_psi = (-0.125 * k1 * t1 - 0.125 * k2 * t2
                  + k3 * psi * (psi - 1.0) * (2.0 * psi - 1.0)
                  - kfp * d2phi - kpp * d2psi)
        return mu_phi, mu_psi

    def stress(self, fields):
        phi, psi = fields["phi"], fields["psi"]
        gphi, gpsi = fields["grad_phi"], fields["grad_psi"]
        d2phi, d2psi = fields["delsq_phi"], fields["delsq_psi"]
        k1, k2, k3 = self.kappa1, self.kappa2, self.kappa3
        a2 = self.alpha * self.alpha
        krr = 0.25 * a2 * (k1 + k2)
        kff = krr
        kpp = 0.25 * a2 * (k1 + k2 + 4.0 * k3)
        krf = 0.25 * a2 * (k1 - k2)
        kfp = -krf
        rho, rho2 = 1.0, 1.0
        phi2, psi2 = phi * phi, psi * psi

        p1 = (k1 + k2) * (
            0.09375 * (rho2 * rho2 + phi2 * phi2)
            + 0.5625 * (rho2 * phi2 + rho2 * psi2 + phi2 * psi2)
            - 0.3750 * rho * psi * (rho2 + psi2)
            + 0.75 * (rho2 * psi - rho * phi2 - rho * psi2 + phi2 * psi)
            - 0.25 * rho2 * rho + 0.125 * rho2 + 0.125 * phi2
            - 0.25 * rho * psi - 1.125 * rho * phi2 * psi)
        p2 = (k1 - k2) * (
            0.375 * (rho2 * rho * phi + rho * phi2 * phi
                     - phi2 * phi * psi - phi * psi2 * psi)
            - 0.25 * phi2 * phi - 0.75 * (rho2 * phi + phi * psi2)
            + 0.25 * (rho * phi - phi * psi)
            + 1.125 * rho * phi * psi2 - 1.125 * rho2 * phi * psi
            + 1.5 * rho * phi * psi)
        p3 = 0.25 * (k1 + k2 - 8.0 * k3) * psi2 * psi
        p4 = (k1 + k2 + 16.0 * k3) * (0.09375 * psi2 + 0.125) * psi2
        p0 = p1 + p2 + p3 + p4

        dphi2 = sum(gphi[a] * gphi[a] for a in range(3))
        dpsi2 = sum(gpsi[a] * gpsi[a] for a in range(3))
        dfp = sum(gphi[a] * gpsi[a] for a in range(3))

        q2 = 0.5 * dphi2 + phi * d2phi
        q3 = 0.5 * dpsi2 + psi * d2psi
        q4 = rho * d2phi      # drho = 0, delsq_rho = 0
        q5 = rho * d2psi
        q6 = dfp + phi * d2psi + psi * d2phi

        eye = torch.eye(3, dtype=phi.dtype,
                        device=phi.device)[:, :, None, None, None]
        s = (p0[None, None] * eye
             + kff * (gphi[:, None] * gphi[None, :] - q2[None, None] * eye)
             + kpp * (gpsi[:, None] * gpsi[None, :] - q3[None, None] * eye)
             - krf * q4[None, None] * eye      # krhophi term, drho = 0
             + krr * q5[None, None] * eye      # krhopsi = -krr term
             + kfp * (gphi[:, None] * gpsi[None, :]
                      + gpsi[:, None] * gphi[None, :]
                      - q6[None, None] * eye))
        return s
