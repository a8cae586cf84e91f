"""Liquid-crystal droplet simulation: coupled (phi, Q) + LB.

PyTorch port of the periodic, stress-divergence branch of
ludwig_tpu/lc_droplet_sim.py (ref: src/ludwig.c:693-742: body force +
momentum correction, then the divergence of the qh stress; phi via
Cahn-Hilliard, Q via Beris-Edwards, both with the coupled free energy).
The state is the tuple (f, phi, q5, u); a step runs eagerly on the
state's device.  This is the unfused step (the CLI's `tpu_fused off`
route) and the reference the fused step of ops/fused_droplet.py is held
to.

Solids and walls, `fe_force_method relaxation_antisymmetric`, Lees-Edwards
shear (`make_droplet_le_step`), the other gradient stencils and advection
orders 3 and up are not ported yet (ROADMAP, slice 5).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ludwig_tpu_torch.dynamics.beris_edwards import (BerisEdwardsParams,
                                                     beris_edwards_update)
from ludwig_tpu_torch.dynamics.cahn_hilliard import (CahnHilliardParams,
                                                     cahn_hilliard_update)
from ludwig_tpu_torch.fe.lc_droplet import LCDropletFE
from ludwig_tpu_torch.lb import LBConfig, initial_rest
from ludwig_tpu_torch.lc import stack33
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.force import stress_divergence_force
from ludwig_tpu_torch.ops.stencil import dab_7pt, gradient_ops
from ludwig_tpu_torch.ops.stream import stream

GRADIENT = "3d_7pt_fluid"      # the stencil of the ported droplet slice
ORDERS = (1, 2)                # the ported advection orders
FORCE_METHOD = "stress_divergence"


@dataclasses.dataclass(frozen=True)
class LCDropletConfig:
    """Static configuration of a droplet run: periodic, no solid, 7-point
    gradients, stress-divergence force.  Anything else raises, naming
    the field."""

    lb: LBConfig
    fe: LCDropletFE
    mobility: float = 0.05        # phi mobility
    gamma: float = 0.5            # Q rotational mobility (lc_Gamma)
    advection_order: int = 1
    gradient: str = GRADIENT
    force_method: str = FORCE_METHOD

    def __post_init__(self):
        if self.advection_order not in ORDERS:
            raise NotImplementedError(
                f"advection_order {self.advection_order} is not ported "
                f"yet (have {ORDERS}), see ROADMAP")
        if self.gradient != GRADIENT:
            raise NotImplementedError(
                f"gradient '{self.gradient}' is not ported yet (have "
                f"'{GRADIENT}'), see ROADMAP")
        if self.force_method != FORCE_METHOD:
            raise NotImplementedError(
                f"force_method '{self.force_method}' is not ported yet "
                f"(have '{FORCE_METHOD}'), see ROADMAP")


def droplet_fields(phi, q5, gradient: str = GRADIENT):
    """phi, Q and their gradients, the dict the free energy's methods
    take."""
    grad, delsq = gradient_ops(gradient)
    return {"phi": phi, "grad_phi": grad(phi), "delsq_phi": delsq(phi),
            "dab_phi": dab_7pt(phi),
            "q": q5, "grad_q": grad(q5), "delsq_q": delsq(q5)}


def make_droplet_step(cfg: LCDropletConfig):
    """Step: ((f, phi, q5, u), t=0) -> ((f', phi', q5', u'), rho)."""
    params = cfg.lb.collision_params()
    model = cfg.lb.model
    ch = CahnHilliardParams(mobility=cfg.mobility,
                            advection_order=cfg.advection_order)
    be = BerisEdwardsParams(gamma=cfg.gamma, xi=cfg.fe.lc.xi,
                            advection_order=cfg.advection_order)

    def step(state, t=0):
        del t
        f, phi, q5, u = state
        fields = droplet_fields(phi, q5, cfg.gradient)
        mu = cfg.fe.mu(fields)
        h = cfg.fe.molecular_field(fields)
        # corrected body force + divergence of the qh stress
        force = cfg.fe.body_force(fields, mu, h)
        force = force + stress_divergence_force(
            stack33(cfg.fe.stress_qh(fields, h)))
        force = force.to(f.dtype)

        phi = cahn_hilliard_update(phi, mu, u, ch)
        # the reference updates phi first; the Beris-Edwards molecular
        # field then sees gamma(phi_new) with the (stale) gradients of the
        # pre-update fields (ref: ludwig.c order phi_cahn_hilliard ->
        # beris_edw_update; field_grad recomputed only next step)
        fields_be = dict(fields)
        fields_be["phi"] = phi
        q5 = beris_edwards_update(q5, cfg.fe.molecular_field(fields_be), u,
                                  be)
        f, rho, u_new = collide(f, params, force=force)
        return (stream(f, model), phi, q5, u_new), rho

    return step


def make_droplet_nstep(cfg: LCDropletConfig):
    """nstep(state, n, t0=0): n chained steps."""
    step = make_droplet_step(cfg)

    def nstep(state, n, t0=0):
        for t in range(t0, t0 + n):
            state, _rho = step(state, t)
        return state

    return nstep


def initial_droplet(cfg: LCDropletConfig, phi0: np.ndarray, q0: np.ndarray):
    """(f at rest, phi, q5, u = 0) on the configuration's device."""
    lb = cfg.lb
    f = initial_rest(lb)
    phi = torch.as_tensor(phi0, dtype=lb.tdtype, device=lb.device)
    q5 = torch.as_tensor(q0, dtype=lb.tdtype, device=lb.device)
    u = torch.zeros((3,) + tuple(lb.size), dtype=lb.tdtype, device=lb.device)
    return (f, phi.contiguous(), q5.contiguous(), u)
