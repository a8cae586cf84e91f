"""Leslie-Ericksen dynamics for the polar order parameter P.

PyTorch port of ludwig_tpu/dynamics/leslie_ericksen.py (ref:
src/leslie_ericksen.c: leslie_update_kernel :154-225, self-advection
:282):

  dP_a/dt + div((u + swim P) P_a) =
      lambda D_ab P_b - Omega'_ab P_b + Gamma h_a

where the Leslie convention w_ab = d_a u_b is the transpose of the
hydro gradient tensor, giving the extra minus sign on Omega.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ludwig_tpu_torch.dynamics.beris_edwards import velocity_gradient_tensor
from ludwig_tpu_torch.ops.advect import advective_fluxes


@dataclasses.dataclass(frozen=True)
class LeslieEricksenParams:
    gamma: float           # rotational mobility Gamma
    lambda_: float = 0.0   # flow alignment
    swim: float = 0.0      # self-advection speed
    advection_order: int = 1


def leslie_ericksen_update(p: torch.Tensor, h, u: Optional[torch.Tensor],
                           params: LeslieEricksenParams) -> torch.Tensor:
    """One forward-Euler step; p (3, X, Y, Z), h a list of 3 tensors; u
    None for `hydrodynamics off`.

    The reference updates p[ia] IN PLACE inside the component loop, so
    the lambda D.P - Omega.P terms of the y and z components see the
    already-updated earlier components (ref: leslie_update_kernel);
    fluxes and the molecular field are computed from the OLD field.  The
    JAX package reproduces that order, and so does this port."""
    if u is None:
        return p + torch.stack([params.gamma * h[a] for a in range(3)])

    ueff = u + params.swim * p if params.swim else u
    # velocity_gradient_tensor returns w[a][b] = d_b u_a; Leslie uses the
    # transpose convention, hence omega gets a minus
    w = velocity_gradient_tensor(u)
    d = [[0.5 * (w[a][b] + w[b][a]) for b in range(3)] for a in range(3)]
    om = [[-0.5 * (w[a][b] - w[b][a]) for b in range(3)]
          for a in range(3)]
    pl = [p[0], p[1], p[2]]
    for a in range(3):
        s = 0.0
        for b in range(3):
            s = s + (params.lambda_ * d[a][b] * pl[b]
                     - om[a][b] * pl[b])
        fx, fy, fz = advective_fluxes(ueff, p[a], params.advection_order)
        pl[a] = p[a] + (- fx + torch.roll(fx, 1, 0)
                        - fy + torch.roll(fy, 1, 1)
                        - fz + torch.roll(fz, 1, 2)
                        + s + params.gamma * h[a])
    return torch.stack(pl)
