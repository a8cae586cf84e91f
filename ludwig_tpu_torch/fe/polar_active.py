"""Polar active (gel) free energy, vector order parameter P.

PyTorch port of ludwig_tpu/fe/polar_active.py (ref: src/polar_active.c:
fe_polar_fed, fe_polar_mol_field, fe_polar_stress):

  f = A/2 P^2 + B/4 (P^2)^2 + kappa1/2 (d_a P_b)^2
      + delta kappa1 / 2 (eps_abc d_b P_c)^2
  h_a = -A P_a - B P^2 P_a + kappa1 del^2 P_a
  S_ab = -[ (1/2)(P_a h_b - P_b h_a)
            - lambda ((1/2)(P_a h_b + P_b h_a) - (1/3) delta_ab P.h)
            - kappa1 d_a P_c d_b P_c
            - zeta (P_a P_b - (1/3) delta_ab P^2) ]

The JAX package's operation order is kept (x^2 is x x).
"""

from __future__ import annotations

import dataclasses

import torch

from ludwig_tpu_torch.fe.blue_phase import eps


@dataclasses.dataclass(frozen=True)
class PolarActiveFE:
    a: float
    b: float
    kappa1: float
    delta: float = 0.0
    lambda_: float = 0.0   # flow alignment
    zeta: float = 0.0      # activity

    # fields: p (3,X,Y,Z), grad_p (3,3,...) [c][a] = d_c P_a, delsq_p (3,...)

    def fed(self, fields):
        p = fields["p"]
        dp = fields["grad_p"]
        p2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2]
        dp1 = sum(dp[c][a] * dp[c][a] for c in range(3) for a in range(3))
        dp3 = 0.0
        for a in range(3):
            s = 0.0
            for b in range(3):
                for c in range(3):
                    e = eps(a, b, c)
                    if e:
                        s = s + e * dp[b][c]
            dp3 = dp3 + s * s
        return (0.5 * self.a * p2 + 0.25 * self.b * p2 * p2
                + 0.5 * self.kappa1 * dp1
                + 0.5 * self.delta * self.kappa1 * dp3)

    def molecular_field(self, fields):
        """[h_x, h_y, h_z] (assumes delta = 0, as the reference does)."""
        p = fields["p"]
        dsq = fields["delsq_p"]
        p2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2]
        return [(-self.a * p[a] - self.b * p2 * p[a]
                 + self.kappa1 * dsq[a]) for a in range(3)]

    def stress(self, fields, h=None):
        p = fields["p"]
        dp = fields["grad_p"]
        if h is None:
            h = self.molecular_field(fields)
        p2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2]
        pdoth = p[0] * h[0] + p[1] * h[1] + p[2] * h[2]
        r3 = 1.0 / 3.0
        lam = self.lambda_

        rows = []
        for a in range(3):
            row = []
            for b in range(3):
                s = sum(dp[a][c] * dp[b][c] for c in range(3))
                val = (0.5 * (p[a] * h[b] - p[b] * h[a])
                       - lam * (0.5 * (p[a] * h[b] + p[b] * h[a])
                                - (r3 * pdoth if a == b else 0.0))
                       - self.kappa1 * s
                       - self.zeta * (p[a] * p[b]
                                      - (r3 * p2 if a == b else 0.0)))
                row.append(-val)
            rows.append(torch.stack(row))
        return torch.stack(rows)
