"""Beris-Edwards Q-tensor dynamics.

PyTorch port of ludwig_tpu/dynamics/beris_edwards.py (ref:
src/blue_phase_beris_edwards.c:304-470 beris_edw_update_host):

  dQ/dt + div(u Q) = Gamma H + S(W, Q) (+ noise)

  S = (xi D + Omega)(Q + I/3) + (Q + I/3)(xi D - Omega)
      - 2 xi (Q + I/3) Tr(Q W)

with W_ab = d_b u_a (central differences, trace removed,
ref: src/hydro.c hydro_u_gradient_tensor), D/Omega its symmetric and
antisymmetric parts, and the advective term in conservative face-flux
form (same upwind schemes as the scalar order parameter).  Halo walls
(the wall velocity in the gradient tensor, no flux through the wall
faces), solid sites (no flux through their faces, no update there) and
`hydrodynamics off` (u None: relaxation only) and the fluctuating noise
term (lc_noise, noise.qab_noise5) follow the JAX module.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ludwig_tpu_torch.fe.blue_phase import q5_to_q33
from ludwig_tpu_torch.ops.advect import advective_fluxes, flux_divergence
from ludwig_tpu_torch.ops.stencil import roll3


@dataclasses.dataclass(frozen=True)
class BerisEdwardsParams:
    gamma: float              # rotational mobility (input key lc_Gamma)
    xi: float                 # flow-alignment (shared with the FE)
    advection_order: int = 1


def remove_trace(w):
    """w[a][b] with a third of its trace taken off the diagonal.  The
    third is an IEEE quotient on every device, as the kernels take it: a
    CUDA tensor divided by a Python scalar is multiplied by the scalar's
    reciprocal instead, which can round differently."""
    s = w[0][0] + w[1][1] + w[2][2]
    tr = s / (s.new_full((), 3.0) if isinstance(s, torch.Tensor) else 3.0)
    return [[w[a][b] - tr if a == b else w[a][b] for b in range(3)]
            for a in range(3)]


def velocity_gradient_tensor(u: torch.Tensor, wallspec=None):
    """w[a][b] = d_b u_a, central differences, traceless
    (ref: hydro.c hydro_u_gradient_tensor).  With walls the off-edge
    neighbour velocity is the wall velocity."""
    def d(comp, ax):
        s_up = [0, 0, 0]
        s_up[ax] = -1
        s_dn = [0, 0, 0]
        s_dn[ax] = 1
        return 0.5 * (roll3(u[comp], tuple(s_up)) -
                      roll3(u[comp], tuple(s_dn)))

    w = [[d(a, b) for b in range(3)] for a in range(3)]
    if wallspec is not None and wallspec.any:
        from ludwig_tpu_torch.ops.walls import wall_velocity_gradient_fix
        w = wall_velocity_gradient_fix(w, u, wallspec)
    return remove_trace(w)


def corotation(q33, w, xi):
    """S(W, Q) as a 3x3 list of values from the traceless velocity
    gradient tensor w[a][b]; plain arithmetic, so it serves whole tensors
    and the symbols of the CUDA kernel's code generator alike."""
    r3 = 1.0 / 3.0

    trace_qw = sum(q33[a][b] * w[b][a] for a in range(3) for b in range(3))
    d = [[0.5 * (w[a][b] + w[b][a]) for b in range(3)] for a in range(3)]
    om = [[0.5 * (w[a][b] - w[b][a]) for b in range(3)] for a in range(3)]

    s = [[None] * 3 for _ in range(3)]
    for a in range(3):
        for b in range(3):
            val = -2.0 * xi * (q33[a][b] + (r3 if a == b else 0.0)) * trace_qw
            for c in range(3):
                val = val + (xi * d[a][c] + om[a][c]) * (
                    q33[c][b] + (r3 if c == b else 0.0))
                val = val + (q33[a][c] + (r3 if a == c else 0.0)) * (
                    xi * d[c][b] - om[c][b])
            s[a][b] = val
    return s


def corotation_term(q33, u: torch.Tensor, xi: float, wallspec=None):
    """S(W, Q) as a 3x3 list of tensors."""
    return corotation(q33, velocity_gradient_tensor(u, wallspec), xi)


def beris_edwards_update(q5: torch.Tensor, h33, u: Optional[torch.Tensor],
                         params: BerisEdwardsParams,
                         fluid_mask: Optional[torch.Tensor] = None,
                         noise5: Optional[torch.Tensor] = None,
                         wallspec=None,
                         solid=None) -> torch.Tensor:
    """One forward-Euler BE step; returns updated q5 (5, X, Y, Z).

    h33 is the molecular field as a 3x3 list (from the free energy).  u
    None is `hydrodynamics off`: no corotation, no advection.  With
    halo walls (wallspec) the wall faces carry no flux and the gradient
    tensor takes the walls' velocity; `solid` (the (X, Y, Z) mask, or its
    advect.blocked_faces) blocks the faces of solid sites; sites outside
    fluid_mask keep their Q.  noise5 (5, X, Y, Z), the fluctuating term
    of noise.qab_noise5, joins the right-hand side.
    """
    g = params.gamma
    rhs5 = [g * h33[0][0], g * h33[0][1], g * h33[0][2],
            g * h33[1][1], g * h33[1][2]]

    if u is not None:
        q33 = q5_to_q33(q5)
        s = corotation_term(q33, u, params.xi, wallspec)
        s5 = [s[0][0], s[0][1], s[0][2], s[1][1], s[1][2]]
        rhs5 = [r + si for r, si in zip(rhs5, s5)]
        walled = wallspec is not None and wallspec.any
        if walled:
            from ludwig_tpu_torch.ops.walls import no_flux_at_walls
        if solid is not None:
            from ludwig_tpu_torch.ops.advect import (blocked_faces,
                                                     no_flux_at_solid)
            if isinstance(solid, torch.Tensor):
                solid = blocked_faces(solid)
        # conservative advection of each component
        for n in range(5):
            fluxes = advective_fluxes(u, q5[n], params.advection_order)
            if walled:
                fluxes = no_flux_at_walls(fluxes, wallspec)
            if solid is not None:
                fluxes = no_flux_at_solid(fluxes, solid)
            rhs5[n] = rhs5[n] - flux_divergence(fluxes)

    if noise5 is not None:
        rhs5 = [r + noise5[n] for n, r in enumerate(rhs5)]

    dq = torch.stack(rhs5)
    if fluid_mask is not None:
        dq = torch.where(fluid_mask[None], dq,
                         torch.zeros((), dtype=dq.dtype, device=dq.device))
    return q5 + dq
