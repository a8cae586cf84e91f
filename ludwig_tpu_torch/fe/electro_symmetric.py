"""Electro-symmetric free energy: binary fluid + electrolyte coupling.

PyTorch port of the free energy of ludwig_tpu/fe/electro_symmetric.py
(ref: src/fe_electro_symmetric.c: epsilon(r) = epsilonbar (1 - gamma
phi), gamma = (e1-e2)/(e1+e2) :314-330, mu_ion_solv = 1/2 deltamu_k
(1 + phi) :298-307, phi-potential terms mu += 1/2 sum_k rho_k deltamu_k
+ 1/2 gamma epsilonbar E^2 :267-281), in the JAX package's term order.
The variable-permittivity SOR of the step is electro_symm.py's
poisson_sor_var_eps_ref (the JAX module's own red/black variant without
a convergence test is not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ludwig_tpu_torch.electro import ElectroConfig, fe_electro_fed
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.ops.stencil import grad_7pt


@dataclasses.dataclass(frozen=True)
class ElectroSymmetricFE:
    symm: SymmetricFE
    electro: ElectroConfig
    epsilon1: float               # permittivity in phase phi = +1
    epsilon2: float               # permittivity in phase phi = -1
    deltamu: Tuple[float, ...] = (0.0, 0.0)   # solvation contrast / species

    @property
    def epsilonbar(self) -> float:
        return 0.5 * (self.epsilon1 + self.epsilon2)

    @property
    def gamma(self) -> float:
        return (self.epsilon1 - self.epsilon2) / (self.epsilon1
                                                  + self.epsilon2)

    def var_epsilon(self, phi):
        """epsilon(r) (ref: fe_es_var_epsilon)."""
        return self.epsilonbar * (1.0 - self.gamma * phi)

    def mu_solv(self, phi):
        """Per-species solvation potentials (already /e as the NP fluxes
        expect reduced potentials when e = 1)."""
        return [0.5 * dk * (1.0 + phi) for dk in self.deltamu]

    def mu_phi(self, fields, rho, psi):
        """Binary chemical potential with the electro coupling terms, E
        from the 7-point gradient of psi (ref: psi_force.c:126)."""
        kt = 1.0 / self.electro.beta
        e = -grad_7pt(psi) * (kt / self.electro.e)
        e2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
        return self.mu_phi_coupled(fields, rho, e2)

    def mu_phi_coupled(self, fields, rho, e2):
        """mu_phi = mu_mix + mu_solv + mu_el with a precomputed E^2
        (physical units; ref: fe_electro_symmetric.c fe_es_mu_phi)."""
        mu = self.symm.mu(fields)
        for k, dk in enumerate(self.deltamu):
            if dk:
                mu = mu + 0.5 * rho[k] * dk
        return mu + 0.5 * self.gamma * self.epsilonbar * e2

    def stress_coupled(self, fields, rho, e, e2):
        """Full coupled stress S = S_symm + S_elec + S_couple (ref:
        fe_electro_symmetric.c fe_es_stress_ex):

          S_elec_ab   = -eps(phi) (E_a E_b - d_ab E^2/2)
          S_couple_ab = d_ab (1/2) phi [eps_bar gamma E^2
                                        + sum_k rho_k deltamu_k]
        """
        phi = fields["phi"]
        s = self.symm.stress(fields)
        epsloc = self.var_epsilon(phi)
        s_couple = 0.5 * phi * self.epsilonbar * self.gamma * e2
        for k, dk in enumerate(self.deltamu):
            if dk:
                s_couple = s_couple + 0.5 * phi * rho[k] * dk
        rows = []
        for a in range(3):
            row = []
            for b in range(3):
                v = s[a, b] - epsloc * (e[a] * e[b]
                                        - (0.5 * e2 if a == b else 0.0))
                if a == b:
                    v = v + s_couple
                row.append(v)
            rows.append(torch.stack(row))
        return torch.stack(rows)

    def fed_coupled(self, fields, rho, psi):
        """fed = f_electro + f_symm + sum_k rho_k mu_solv_k (ref:
        fe_electro_symmetric.c fe_es_fed)."""
        fed = fe_electro_fed(rho, self.electro, psi)
        fed = fed + self.symm.fed(fields)
        ms = self.mu_solv(fields["phi"])
        for k in range(len(self.deltamu)):
            fed = fed + rho[k] * ms[k]
        return fed
