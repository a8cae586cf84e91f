"""Ewald sums for dipolar colloid suspensions.

PyTorch port of ludwig_tpu/ewald.py (ref: src/ewald.c:
ewald_real_space_sum :503, ewald_fourier_space_sum :638,
ewald_self_energy :450; kappa = 5/(2 rc), nk = ceil(kappa^2 rc Lx/pi),
kmax = (2 pi nk / Lx)^2).  Dipoles are mu s_n with |s_n| = 1.  The
real-space part is an all-pairs (N, N) sum with the minimum image; the
Fourier part evaluates every retained wavevector for all particles at
once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ludwig_tpu_torch.colloids import _ftensor


def ewald_params(mu: float, rc: float, size):
    kappa = 5.0 / (2.0 * rc)
    nk = int(np.ceil(kappa * kappa * rc * size[0] / np.pi))
    kmax = (2.0 * np.pi * nk / size[0]) ** 2
    return kappa, nk, kmax


def self_energy(mu: float, rc: float, n: int) -> float:
    """The constant self-interaction term (ref: ewald_self_energy)."""
    kappa = 5.0 / (2.0 * rc)
    return -n * (2.0 / 3.0) * mu * mu * kappa ** 3 / np.sqrt(np.pi)


def real_space(R, S, mu, rc, size):
    """(energy, F (N, 3), T (N, 3)): the erfc-screened dipole pairs."""
    N = R.shape[0]
    kappa = 5.0 / (2.0 * rc)
    rpi = 1.0 / np.sqrt(np.pi)
    L = _ftensor(size, R)
    r12 = R[:, None, :] - R[None, :, :]            # R_i - R_j
    r12 = r12 - L * torch.round(r12 / L)
    r2 = torch.sum(r12 * r12, dim=-1)
    iu = ~torch.eye(N, dtype=torch.bool, device=R.device)
    r = torch.sqrt(torch.where(iu, r2, torch.ones_like(r2)))
    pm = (iu & (r < rc)).to(R.dtype)
    rr = 1.0 / r
    b1 = mu * mu * torch.special.erfc(kappa * r) * rr ** 3
    b2 = (mu * mu * (2.0 * kappa * rpi)
          * torch.exp(-kappa * kappa * r * r) * rr * rr)
    b = b1 + b2
    c = 3.0 * b1 * rr * rr + (2.0 * kappa * kappa + 3.0 * rr * rr) * b2
    d = 5.0 * c / (r * r) + 4.0 * kappa ** 4 * b2
    udotu = torch.einsum("ia,ja->ij", S, S)
    u1dotr = torch.einsum("ia,ija->ij", S, r12)    # s_i . r12
    u2dotr = torch.einsum("ja,ija->ij", S, r12)    # s_j . r12
    energy = 0.5 * torch.sum(pm * (udotu * b - u1dotr * u2dotr * c))
    f = ((udotu * c - u1dotr * u2dotr * d)[..., None] * r12
         + c[..., None] * (u2dotr[..., None] * S[:, None, :]
                           + u1dotr[..., None] * S[None, :, :]))
    F = torch.sum(pm[..., None] * f, dim=1)
    g = b[..., None] * S[None, :, :] - (c * u2dotr)[..., None] * r12
    g = torch.sum(pm[..., None] * g, dim=1)
    return energy, F, -torch.linalg.cross(S, g)


@functools.lru_cache(maxsize=8)
def _wavevectors(rc: float, size):
    """(k (K, 3), weight (K,)): the retained wavevectors of the kz >= 0
    half-space, those of kz > 0 counted twice."""
    _, nk, kmax = ewald_params(1.0, rc, size)
    fk = 2.0 * np.pi / np.array(size, np.float64)
    ks, wt = [], []
    for kz in range(0, nk + 1):
        for ky in range(-nk, nk + 1):
            for kx in range(-nk, nk + 1):
                k = (fk[0] * kx, fk[1] * ky, fk[2] * kz)
                ksq = k[0] ** 2 + k[1] ** 2 + k[2] ** 2
                if ksq <= 0.0 or ksq > kmax:
                    continue
                ks.append(k)
                wt.append(2.0 if kz > 0 else 1.0)
    return np.array(ks), np.array(wt)


def fourier_space(R, S, mu, rc, size):
    """(energy, F (N, 3), T (N, 3)): the reciprocal sum (ref:
    ewald_fourier_space_sum; kz >= 0 half-space with doubling)."""
    kappa = 5.0 / (2.0 * rc)
    L = np.array(size, np.float64)
    b0 = (4.0 * np.pi / (L[0] * L[1] * L[2])) * mu * mu
    r4k = 1.0 / (4.0 * kappa * kappa)
    ks, wt = _wavevectors(float(rc), tuple(size))
    k, wt = _ftensor(ks, R), _ftensor(wt, R)
    ksq = torch.sum(k * k, dim=1)
    b = b0 * torch.exp(-r4k * ksq) / ksq * wt                     # (K,)
    kr = torch.einsum("ka,na->kn", k, R)
    udotk = torch.einsum("ka,na->kn", k, S)
    sin_kr, cos_kr = torch.sin(kr), torch.cos(kr)
    sinx = torch.sum(udotk * sin_kr, dim=1)
    cosx = torch.sum(udotk * cos_kr, dim=1)
    energy = 0.5 * torch.sum(b * (sinx * sinx + cosx * cosx))
    fampl = b[:, None] * (cosx[:, None] * sin_kr
                          - sinx[:, None] * cos_kr) * udotk
    F = torch.einsum("kn,ka->na", fampl, k)
    gampl = b[:, None] * (cosx[:, None] * cos_kr + sinx[:, None] * sin_kr)
    g = torch.einsum("kn,ka->na", gampl, k)
    return energy, F, -torch.linalg.cross(S, g)


def ewald_sum(R, S, mu, rc, size):
    """(F, T): the real and Fourier dipolar interactions together."""
    _, Fr, Tr = real_space(R, S, mu, rc, size)
    _, Fk, Tk = fourier_space(R, S, mu, rc, size)
    return Fr + Fk, Tr + Tk
