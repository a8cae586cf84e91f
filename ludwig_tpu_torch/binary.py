"""Binary-fluid simulation: symmetric free energy + Cahn-Hilliard + LB.

PyTorch port of the periodic, stress-divergence, hydrodynamics-on branch
of ludwig_tpu/binary.py (ref: src/ludwig.c:551-860 time step: gradients
-> force -> order-parameter dynamics -> collide -> stream).  The state is
the tuple (f, phi, u); a step runs eagerly on the state's device.  This
is the unfused step (the CLI's `tpu_fused off` route) and the reference
the fused step of ops/fused_binary.py is tested against.

The velocity used by the CH advection is the force-shifted velocity from
the previous collision, exactly as the reference stores hydro->u during
collide and uses it in the following step's advection.
"""

from __future__ import annotations

import dataclasses

import torch

from ludwig_tpu_torch.dynamics.cahn_hilliard import (CahnHilliardParams,
                                                     cahn_hilliard_update)
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.lb import LBConfig, initial_rest
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.force import stress_divergence_force
from ludwig_tpu_torch.ops.stencil import gradient_ops
from ludwig_tpu_torch.ops.stream import stream


GRADIENT = "3d_7pt_fluid"      # the stencil of the ported binary slice
ORDERS = (1, 2)                # the ported advection orders


@dataclasses.dataclass(frozen=True)
class BinaryConfig:
    """Static configuration for a symmetric binary-fluid run: periodic,
    7-point gradients, stress-divergence force, hydrodynamics on.  The
    JAX package's other stencils, advection orders 3-5, diffusion-only
    runs, viscosity model, wetting, grad-mu force and external
    chemical-potential gradient are not ported yet."""

    lb: LBConfig
    fe: SymmetricFE
    mobility: float = 1.0
    advection_order: int = 1

    def __post_init__(self):
        if self.advection_order not in ORDERS:
            raise NotImplementedError(
                f"advection order {self.advection_order} is not ported "
                f"yet (have {ORDERS})")


def fe_fields(phi, gradient: str = GRADIENT):
    """Order parameter + gradients dict shared by mu/stress/stats."""
    grad, delsq = gradient_ops(gradient)
    return {"phi": phi, "grad_phi": grad(phi), "delsq_phi": delsq(phi)}


def make_binary_step(cfg: BinaryConfig):
    """Step: ((f, phi, u), t=0) -> ((f', phi', u'), rho).

    Per reference time step (ludwig.c:551-860): gradients of phi, the
    stress-divergence force, the CH update of phi advected by the
    previous step's u, then collide with the force and stream."""
    params = cfg.lb.collision_params()
    model = cfg.lb.model
    ch = CahnHilliardParams(mobility=cfg.mobility,
                            advection_order=cfg.advection_order)

    def step(state, t=0):
        del t
        f, phi, u = state
        fields = fe_fields(phi)
        mu = cfg.fe.mu(fields)
        force = stress_divergence_force(cfg.fe.stress(fields)).to(f.dtype)
        phi = cahn_hilliard_update(phi, mu, u, ch)
        f, rho, u_new = collide(f, params, force=force)
        return (stream(f, model), phi, u_new), rho

    return step


def initial_binary(cfg: BinaryConfig, phi0):
    """(f at rest, phi0, u = 0) on the configuration's device."""
    lb = cfg.lb
    f = initial_rest(lb)
    phi = torch.as_tensor(phi0, dtype=lb.tdtype, device=lb.device)
    u = torch.zeros((3,) + tuple(lb.size), dtype=lb.tdtype, device=lb.device)
    return (f, phi.contiguous(), u)
