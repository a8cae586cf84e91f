"""Momentum coupling: thermodynamic force on the fluid.

PyTorch port of ludwig_tpu/ops/force.py (ref: src/phi_force.c:274-470
stress-divergence method, src/phi_force_colloid.c pth_force_map_kernel,
src/phi_grad_mu.c phi-grad-mu method).  The stress is interpolated to cell
faces and the force is its (conservative) divergence, so global momentum
is conserved to round-off:

  F_a(i) = -[Fx_a(i+1/2) - Fx_a(i-1/2) + ...],
  Fx_a(i+1/2) = 1/2 (P_xa(i) + P_xa(i+1))
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ludwig_tpu_torch.ops.stencil import roll3


def _up(x, ax):
    s = [0, 0, 0]
    s[ax] = -1
    return roll3(x, s, first_axis=x.dim() - 3)


def _down(x, ax):
    s = [0, 0, 0]
    s[ax] = 1
    return roll3(x, s, first_axis=x.dim() - 3)


def stress_divergence_force(pth: torch.Tensor) -> torch.Tensor:
    """Force (3, X, Y, Z) from stress tensor pth (3, 3, X, Y, Z)."""
    comps = []
    for a in range(3):
        acc = None
        for ax in range(3):
            # flux of a-momentum through the ax-face: P[a][ax]
            # (ref: phi_force.c:384 fluxw[ia] = 0.5(pth1[ia][X]+pth0[ia][X]))
            face = 0.5 * (pth[a, ax] + _up(pth[a, ax], ax))
            d = face - _down(face, ax)
            acc = d if acc is None else acc + d
        comps.append(-acc)
    return torch.stack(comps)


def correct_momentum(force: torch.Tensor) -> torch.Tensor:
    """The force (3, X, Y, Z) less its mean over the lattice, so that it
    adds no net momentum (ref: hydro_correct_momentum)."""
    return force - torch.mean(force, dim=(1, 2, 3), keepdim=True)


def grad_mu_force(phi: torch.Tensor, grad_mu: torch.Tensor) -> torch.Tensor:
    """F = -phi grad(mu)  (ref: src/phi_grad_mu.c fd method)."""
    return -phi[None] * grad_mu


@lru_cache(maxsize=64)
def _edge_plane(shape, ax: int, side: int, device: str) -> torch.Tensor:
    """Bool mask on `device`: the first (side=-1) or last (side=+1) plane
    along ax (a step off that side crosses a halo wall); made once per
    shape and device."""
    m = np.zeros(shape, bool)
    sl = [slice(None)] * 3
    sl[ax] = shape[ax] - 1 if side > 0 else 0
    m[tuple(sl)] = True
    return torch.as_tensor(m, device=device)


def stress_divergence_force_map(pth: torch.Tensor, fluid: torch.Tensor,
                                wallspec=None) -> torch.Tensor:
    """Map-aware stress-divergence force (3, X, Y, Z).

    At a fluid-fluid face the flux is the centred average; at a
    fluid-solid face it is the one-sided fluid value (ref:
    phi_force_colloid.c pth_force_map_kernel).  With halo plane walls
    (wallspec) the edge faces along walled axes are one-sided too (ref:
    pth_force_wall_kernel).  The force at solid sites is irrelevant
    downstream (the collision masks them)."""
    fl = fluid.to(pth.dtype)
    shape = tuple(pth.shape[2:])
    comps = []
    for a in range(3):
        acc = None
        for ax in range(3):
            p = pth[a, ax]
            up_f = _up(fl, ax)
            dn_f = _down(fl, ax)
            if wallspec is not None and wallspec.walls[ax]:
                hi = [slice(None)] * 3
                hi[ax] = shape[ax] - 1
                lo = [slice(None)] * 3
                lo[ax] = 0
                up_f = up_f.clone()
                dn_f = dn_f.clone()
                up_f[tuple(hi)] = 0.0
                dn_f[tuple(lo)] = 0.0
            face_up = torch.where(up_f > 0.0, 0.5 * (p + _up(p, ax)), p)
            face_dn = torch.where(dn_f > 0.0, 0.5 * (p + _down(p, ax)), p)
            d = face_up - face_dn
            acc = d if acc is None else acc + d
        comps.append(-acc)
    return torch.stack(comps)


def phi_grad_mu_force(phis, mus, walls=(False, False, False),
                      solid=None) -> torch.Tensor:
    """F_a(i) = -sum_n phi_n(i) * 0.5*(mu_n(i+a) - mu_n(i-a)).

    The centred phi-grad-mu force (ref: src/phi_grad_mu.c
    phi_grad_mu_fluid_kernel).  phis/mus are sequences of (X, Y, Z)
    fields.  Across a boundary - a stored solid site, or a walled face
    of the halo-wall scheme - the neighbour's mu is replaced by the
    central value, i.e. zero normal chemical-potential gradient (ref:
    phi_grad_mu_solid_kernel)."""
    shape = tuple(phis[0].shape)
    dev = str(phis[0].device)
    comps = []
    for a in range(3):
        acc = 0.0
        for phi, mu in zip(phis, mus):
            mup = _up(mu, a)
            mum = _down(mu, a)
            if solid is not None:
                mup = torch.where(_up(solid, a), mu, mup)
                mum = torch.where(_down(solid, a), mu, mum)
            if walls[a]:
                mup = torch.where(_edge_plane(shape, a, +1, dev), mu, mup)
                mum = torch.where(_edge_plane(shape, a, -1, dev), mu, mum)
            acc = acc + (-phi) * 0.5 * (mup - mum)
        comps.append(acc)
    return torch.stack(comps)
