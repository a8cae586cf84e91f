"""Momentum coupling: thermodynamic force on the fluid.

PyTorch port of the stress-divergence method of ludwig_tpu/ops/force.py
(ref: src/phi_force.c:274-470).  The stress is interpolated to cell
faces and the force is its (conservative) divergence, so global momentum
is conserved to round-off:

  F_a(i) = -[Fx_a(i+1/2) - Fx_a(i-1/2) + ...],
  Fx_a(i+1/2) = 1/2 (P_xa(i) + P_xa(i+1))
"""

from __future__ import annotations

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
