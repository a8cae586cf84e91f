"""Electrokinetics: reduced potential psi, charge species, the FFT
Poisson solver and the electrolyte free energy.

PyTorch port of the part of ludwig_tpu/electro.py that the
`free_energy fe_electro` step runs (ref: src/psi.c, src/fe_electro.c).
psi is the REDUCED potential (beta e psi_phys) and the discrete Poisson
equation is

  epsilon del2_7pt psi = - (e beta) rho_elec,   rho_elec = e sum_k z_k n_k.

The SOR solver and the Nernst-Planck update of the step live in
electro_sim.py (reference route) and ops/fused_electro.py (the kernels);
`poisson_sor`, `nernst_planck_update`, `electric_field` and
`electro_force` of the JAX module are not on that path and are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ElectroConfig:
    valency: Tuple[int, ...] = (1, -1)
    diffusivity: Tuple[float, ...] = (0.01, 0.01)
    e: float = 1.0               # unit charge
    beta: float = 1.0            # 1 / kT
    epsilon: float = 100.0       # permittivity
    solver: str = "fft"
    rel_tol: float = 1e-8
    abs_tol: float = 1e-15
    max_its: int = 2000
    multisteps: int = 1          # NP sub-cycles per LB step (ref:
                                 # ludwig.c:629-667 high-diffusivity path)

    @property
    def nk(self) -> int:
        return len(self.valency)


def rho_elec(rho: torch.Tensor, cfg: ElectroConfig) -> torch.Tensor:
    """sum_k (e z_k) n_k, accumulated per species as the reference does
    (ref: psi.c psi_rho_elec)."""
    out = 0.0
    for k, z in enumerate(cfg.valency):
        out = out + (cfg.e * float(z)) * rho[k]
    return out


@functools.lru_cache(maxsize=8)
def _laplacian_eigenvalues(shape, dtype: torch.dtype,
                           device: str) -> torch.Tensor:
    """4 sum_a sin^2(k_a/2) on the lattice's Fourier grid, summed in
    float64 (the zero mode set to 1), cast to `dtype`: made once per
    shape, as a copy from the host at every solve would wait for the
    device."""
    k2 = 0.0
    for ax, n in enumerate(shape):
        k = 2.0 * np.pi * np.fft.fftfreq(n)
        sh = [1, 1, 1]
        sh[ax] = n
        k2 = k2 + torch.as_tensor(4.0 * np.sin(k / 2.0) ** 2,
                                  device=device).reshape(sh)
    return torch.where(k2 == 0.0, 1.0, k2).to(dtype)


def poisson_fft(rho_el: torch.Tensor, cfg: ElectroConfig) -> torch.Tensor:
    """Exact solve of  epsilon del2_7pt psi = -(e beta) rho_el  with the
    discrete 7-point eigenvalues -4 sum_a sin^2(k_a/2); zero mode -> 0."""
    rhs = (cfg.e * cfg.beta / cfg.epsilon) * rho_el
    rhat = torch.fft.fftn(rhs)
    psi_hat = rhat / _laplacian_eigenvalues(tuple(rho_el.shape),
                                            rho_el.dtype, str(rho_el.device))
    psi_hat[0, 0, 0] = 0.0
    return torch.real(torch.fft.ifftn(psi_hat)).to(rho_el.dtype)


DBL_EPSILON = 2.220446049250313e-16


def fe_electro_fed(rho: torch.Tensor, cfg: ElectroConfig,
                   psi=None) -> torch.Tensor:
    """Electrolyte free energy density, the reference form
    sum_k n_k [(ln(n_k + DBL_EPSILON) - 1) + 0.5 z_k psi]
    (ref: fe_electro.c fe_electro_fed; no kT factor, psi reduced)."""
    out = 0.0
    for k in range(cfg.nk):
        nk_ = rho[k]
        term = torch.log(nk_ + DBL_EPSILON) - 1.0
        if psi is not None:
            term = term + 0.5 * float(cfg.valency[k]) * psi
        out = out + nk_ * term
    return out
