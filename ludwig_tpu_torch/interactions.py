"""Colloid-colloid interactions: pair potentials, lubrication, bonds.

PyTorch port of ludwig_tpu/interactions.py, the reference interaction layer
(ref: src/interaction.c:182 interact_compute, src/pair_ss_cut.c:176-245,
src/pair_lj_cut.c, src/pair_yukawa.c, src/lubrication.c:246-315,
src/bond_fene.c, src/angle_cosine.c).  All pairs are evaluated as dense
(N, N) tensors with periodic minimum-image separations, in place of the
reference's cell lists.  Each function returns the (N, 3) forces on the
particles (the soft spheres also the total potential).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ludwig_tpu_torch.colloids import _ftensor, _on_device


def pair_separations(R: torch.Tensor, box) -> torch.Tensor:
    """r12[i, j] = R_j - R_i with minimum image; (N, N, 3)."""
    L = _ftensor(box, R)
    d = R[None, :, :] - R[:, None, :]
    return d - L * torch.round(d / L)


def _over(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x as one division: torch evaluates a Python number over a
    tensor as c * (1 / x), which rounds twice."""
    return torch.full_like(x, c) / x


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of 3, added in order as XLA does."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[
        ..., 2]


def _pairs(R: torch.Tensor, box):
    """(r12, r with 1 on the diagonal, off-diagonal mask)."""
    n = R.shape[0]
    mask = ~torch.eye(n, dtype=torch.bool, device=R.device)
    r12 = pair_separations(R, box)
    r = torch.sqrt(_dot3(r12, r12))
    return r12, torch.where(mask, r, torch.ones_like(r)), mask


def _pair_force(act, fmod, r12, r):
    """sum_j where(act, -fmod r12 / r) (ref: pc1->force -= f r12 / r)."""
    fvec = torch.where(act[..., None], -fmod[..., None] * r12 / r[..., None],
                       torch.zeros((), dtype=r.dtype, device=r.device))
    return torch.sum(fvec, dim=1)


def _tensor(a, like: torch.Tensor) -> torch.Tensor:
    """a in like's dtype on its device: a tensor as it is, host values
    copied once (_ftensor)."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype=like.dtype, device=like.device)
    return _ftensor(a, like)


def soft_sphere_forces(R, ah, box, epsilon: float, sigma: float, nu: float,
                       hc: float):
    """Cut-and-shifted soft spheres (ref: pair_ss_cut.c:195-245):
    V(h) = eps (sigma/h)^nu - V(hc) - (h - hc) V'(hc), h = r - ah_i - ah_j.
    Returns (forces (N, 3), total potential)."""
    r12, r, mask = _pairs(R, box)
    ah = _tensor(ah, R)
    h = torch.clamp(r - ah[:, None] - ah[None, :], min=1e-12)
    vcut = epsilon * (sigma / hc) ** nu
    dvcut = -epsilon * nu / sigma * (sigma / hc) ** (nu + 1.0)
    act = mask & (h < hc)
    v = epsilon * _over(sigma, h) ** nu - vcut - (h - hc) * dvcut
    fmod = -(-epsilon * nu / sigma * _over(sigma, h) ** (nu + 1.0) - dvcut)
    vtotal = 0.5 * torch.sum(torch.where(act, v, torch.zeros_like(v)))
    return _pair_force(act, fmod, r12, r), vtotal


def soft_sphere_ij_forces(R, ah, box, eps_pp, sig_pp, nu_pp, hc_pp):
    """Per-pair-type cut-and-shifted soft spheres (ref: pair_ss_cut_ij.c);
    *_pp are (N, N) parameter matrices built from the type table."""
    r12, r, mask = _pairs(R, box)
    ah = _tensor(ah, R)
    h = torch.clamp(r - ah[:, None] - ah[None, :], min=1e-12)
    eps, sig, nu, hc = (_tensor(x, R) for x in (eps_pp, sig_pp, nu_pp,
                                                hc_pp))
    vcut = eps * (sig / hc) ** nu
    dvcut = -eps * nu / sig * (sig / hc) ** (nu + 1.0)
    act = mask & (h < hc) & (eps > 0.0)
    fmod = -(-eps * nu / sig * (sig / h) ** (nu + 1.0) - dvcut)
    v = eps * (sig / h) ** nu - vcut - (h - hc) * dvcut
    vtotal = 0.5 * torch.sum(torch.where(act, v, torch.zeros_like(v)))
    return _pair_force(act, fmod, r12, r), vtotal


def yukawa_forces(R, box, epsilon: float, kappa: float, rc: float):
    """V = eps exp(-kappa r)/r, cut and force-shifted so that V and dV/dr
    vanish at rc (ref: pair_yukawa.c:207-215)."""
    r12, r, mask = _pairs(R, box)
    act = mask & (r < rc)
    fmod = epsilon * torch.exp(-kappa * r) * (1.0 / r) * (1.0 / r + kappa)
    dvcut = -epsilon * math.exp(-kappa * rc) * (1.0 / rc) * (1.0 / rc + kappa)
    return _pair_force(act, fmod + dvcut, r12, r)


def lj_cut_forces(R, box, epsilon: float, sigma: float, rc: float):
    """Lennard-Jones, cut and force-shifted (ref: pair_lj_cut.c)."""
    r12, r, mask = _pairs(R, box)
    act = mask & (r <= rc)
    rs = _over(sigma, r) ** 6
    rsc = (sigma / rc) ** 6
    dvcut = -24.0 * (1.0 / rc) * epsilon * (2.0 * rsc * rsc - rsc)
    f = -(-24.0 * (1.0 / r) * epsilon * (2.0 * rs * rs - rs) - dvcut)
    return _pair_force(act, f, r12, r)


def _lubrication_pairs(R, V, ah, box, rch):
    r12, r, mask = _pairs(R, box)
    ah = _tensor(ah, R)
    a1, a2 = ah[:, None], ah[None, :]
    h = r - a1 - a2
    act = mask & (h < rch) & (h > 1e-12)
    rhat = r12 / r[..., None]
    du = V[:, None, :] - V[None, :, :]
    rdotdu = _dot3(rhat, du)
    return a1, a2, torch.clamp(h, min=1e-6), act, rhat, du, rdotdu


def lubrication_normal(R, V, ah, box, eta: float, rch: float):
    """Normal lubrication between near-contact spheres (ref:
    lubrication.c:263-290): F = -6 pi eta (a1 a2)^2/(a1+a2)^2 (1/h -
    1/rch) (rhat.du) rhat."""
    a1, a2, hsafe, act, rhat, _du, rdotdu = _lubrication_pairs(R, V, ah,
                                                               box, rch)
    fmod = -6.0 * np.pi * eta * (a1 * a1 * a2 * a2) * (
        1.0 / hsafe - 1.0 / rch) / ((a1 + a1) * (a2 + a2))
    fvec = torch.where(act[..., None], (fmod * rdotdu)[..., None] * rhat,
                       torch.zeros((), dtype=R.dtype, device=R.device))
    return torch.sum(fvec, dim=1)


def lubrication_tangential(R, V, ah, box, eta: float, rch: float):
    """Tangential lubrication (ref: lubrication.c:293-315)."""
    a1, a2, hsafe, act, rhat, du, rdotdu = _lubrication_pairs(R, V, ah, box,
                                                              rch)
    asum = a1 + a2
    fmod = -(24.0 / 15.0) * np.pi * eta * a1 * a2 * (
        2.0 * a1 * a1 + a1 * a2 + 2.0 * a2 * a2) * (
        torch.log(0.5 * asum / hsafe) - np.log(1.0)
        - torch.log(0.5 * asum / rch)) / (asum * asum * asum)
    fvec = torch.where(act[..., None],
                       fmod[..., None] * (du - rdotdu[..., None] * rhat),
                       torch.zeros((), dtype=R.dtype, device=R.device))
    return torch.sum(fvec, dim=1)


def fene_bond_forces(R, box, bonds: np.ndarray, kappa: float, r0: float):
    """FENE bonds: F = -k r / (1 - (r/r0)^2) (ref: bond_fene.c); bonds
    (nb, 2) particle index pairs."""
    out = torch.zeros_like(R)
    if len(bonds) == 0:
        return out
    L = _ftensor(box, R)
    i = _on_device(np.asarray(bonds)[:, 0], R.device)
    j = _on_device(np.asarray(bonds)[:, 1], R.device)
    d = R[j] - R[i]
    d = d - L * torch.round(d / L)
    r2 = _dot3(d, d)
    # r2 / r0^2 as the JAX package's compiled step has it: XLA turns a
    # division by a constant into a product by its reciprocal
    fb = _over(kappa, 1.0 - r2 * (1.0 / (r0 * r0)))[:, None] * d   # i to j
    return out.index_add(0, i, fb).index_add(0, j, -fb)


def angle_cosine_forces(R, box, angles: np.ndarray, kappa: float):
    """Cosine angle potential V = kappa (1 + cos theta) (ref:
    angle_cosine.c); angles (na, 3): i - centre j - k."""
    out = torch.zeros_like(R)
    if len(angles) == 0:
        return out
    L = _ftensor(box, R)
    i, j, k = (_on_device(np.asarray(angles)[:, c], R.device)
               for c in range(3))
    r_ij = R[i] - R[j]
    r_kj = R[k] - R[j]
    r_ij = r_ij - L * torch.round(r_ij / L)
    r_kj = r_kj - L * torch.round(r_kj / L)
    rij = torch.sqrt(_dot3(r_ij, r_ij))
    rkj = torch.sqrt(_dot3(r_kj, r_kj))
    cosq = _dot3(r_ij, r_kj) / (rij * rkj)
    fi = (-_over(kappa, rij * rkj)[:, None] * r_kj
          + (kappa * cosq / (rij * rij))[:, None] * r_ij)
    fk = (-_over(kappa, rij * rkj)[:, None] * r_ij
          + (kappa * cosq / (rkj * rkj))[:, None] * r_kj)
    return out.index_add(0, i, fi).index_add(0, k, fk).index_add(
        0, j, -(fi + fk))
