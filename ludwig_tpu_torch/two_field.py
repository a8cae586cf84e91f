"""Two-order-parameter simulations: surfactant and ternary fluids.

PyTorch port of ludwig_tpu/two_field.py (ref: src/cahn_hilliard.c
ch_solver :174 - the (phi, psi) solver used by the surfactant and
ternary free energies, with per-field mobilities; force coupling via the
free energy's stress divergence or phi grad mu, as in ludwig.c).  The
state is (f, phi, psi, u[, gwall]), the JAX package's order; a step runs
eagerly on the state's device and makes no host copy (the ternary
phi-grad-mu force's momentum correction is a whole-lattice sum that
stays on the device).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ludwig_tpu_torch.dynamics.cahn_hilliard import (CahnHilliardParams,
                                                     cahn_hilliard_update)
from ludwig_tpu_torch.fe.ternary import TernaryFE
from ludwig_tpu_torch.lb import LBConfig, initial_rest
from ludwig_tpu_torch.ops.advect import blocked_faces
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.force import (_edge_plane, phi_grad_mu_force,
                                        stress_divergence_force)
from ludwig_tpu_torch.ops.stencil import gradient_ops
from ludwig_tpu_torch.ops.stream import stream, stream_bounce_back
from ludwig_tpu_torch.ops.walls import (stress_divergence_force_walls,
                                        wall_bounce_back)

FORCE_METHODS = ("stress_divergence", "phi_gradmu")


@dataclasses.dataclass(frozen=True)
class TwoFieldConfig:
    lb: LBConfig
    fe: object                       # SurfactantFE or TernaryFE
    mobilities: Tuple[float, float] = (1.0, 1.0)
    advection_order: int = 1
    gradient: str = "3d_7pt_fluid"
    hydrodynamics: bool = True
    # ternary defaults to phi_gradmu (ref: ludwig.c fe ternary block
    # 'Default method for ternary free energy: phi_gradmu'); the
    # surfactant keeps the global default stress_divergence
    force_method: str = "stress_divergence"

    def __post_init__(self):
        if self.force_method not in FORCE_METHODS:
            raise NotImplementedError(
                f"fe_force_method '{self.force_method}' of the two-field "
                f"fluids is not ported (have {FORCE_METHODS}), see ROADMAP")


def two_fields(phi, psi, gradient: str, solid_ops=None):
    """Field + gradient dict.  solid_ops: ((grad, delsq) for phi, (grad,
    delsq) for psi), wetting-aware stencil pairs (ops/solid_stencil.py
    ternary_solid_ops) overriding the named fluid stencil (ref:
    gradient_*_ternary_solid.c)."""
    if solid_ops is not None:
        (gp, dp), (gs, ds) = solid_ops
    else:
        gp, dp = gradient_ops(gradient)
        gs, ds = gp, dp
    return {"phi": phi, "psi": psi,
            "grad_phi": gp(phi), "grad_psi": gs(psi),
            "delsq_phi": dp(phi), "delsq_psi": ds(psi)}


def make_two_field_step(cfg: TwoFieldConfig, solid=None, wallspec=None,
                        solid_ops=None):
    """Step: ((f, phi, psi, u[, gwall]), t=0) -> (state', rho).

    With wallspec (halo plane walls, ref: wall.c) the CH fluxes vanish
    at walled faces, the LB gets half-way bounce-back there, and the
    state carries the gwall momentum accumulator.  solid: in-lattice
    solid sites (porous media, or walls kept as solid planes)."""
    params = cfg.lb.collision_params()
    model = cfg.lb.model
    ch0 = CahnHilliardParams(mobility=cfg.mobilities[0],
                             advection_order=cfg.advection_order)
    ch1 = CahnHilliardParams(mobility=cfg.mobilities[1],
                             advection_order=cfg.advection_order)
    fluid = None if solid is None else torch.logical_not(solid)
    blocked = None if solid is None else blocked_faces(solid)
    walls = wallspec.walls if wallspec is not None else (False,) * 3
    ternary = isinstance(cfg.fe, TernaryFE)
    rv = 1.0 / float(np.prod(cfg.lb.size))

    def _force(f, fields, phi, psi):
        if cfg.force_method == "phi_gradmu":
            mu_phi, mu_psi = cfg.fe.mu(fields)
            force = phi_grad_mu_force((phi, psi), (mu_phi, mu_psi),
                                      walls=walls, solid=solid).to(f.dtype)
            if ternary:
                # the ternary gradmu force takes the global momentum
                # correction: subtract the net force per site (ref:
                # ludwig.c:723-727, hydro.c hydro_correct_momentum)
                fnet = -torch.sum(force, dim=(1, 2, 3)) * rv
                force = force + fnet[:, None, None, None]
            return force, None
        if wallspec is not None:
            force, fwall = stress_divergence_force_walls(
                cfg.fe.stress(fields), wallspec)
            return force.to(f.dtype), fwall
        return stress_divergence_force(cfg.fe.stress(fields)).to(f.dtype), \
            None

    def step(state, t=0):
        f, phi, psi, u = state[0], state[1], state[2], state[3]
        fields = two_fields(phi, psi, cfg.gradient, solid_ops=solid_ops)
        mu_phi, mu_psi = cfg.fe.mu(fields)

        if not cfg.hydrodynamics:
            phi = cahn_hilliard_update(phi, mu_phi, None, ch0, solid=blocked,
                                       wallspec=wallspec)
            psi = cahn_hilliard_update(psi, mu_psi, None, ch1, solid=blocked,
                                       wallspec=wallspec)
            return (f, phi, psi, u) + tuple(state[4:]), torch.ones_like(phi)

        force, fwall = _force(f, fields, phi, psi)
        phi = cahn_hilliard_update(phi, mu_phi, u, ch0, solid=blocked,
                                   wallspec=wallspec)
        psi = cahn_hilliard_update(psi, mu_psi, u, ch1, solid=blocked,
                                   wallspec=wallspec)
        f_post, rho, u_new = collide(f, params, force=force,
                                     fluid_mask=fluid)
        if wallspec is not None:
            f = stream(f_post, model)
            f, _, gw = wall_bounce_back(f, f_post, model, wallspec,
                                        rho0=cfg.lb.rho0)
            gwall = state[4] + gw.to(state[4].dtype)
            if fwall is not None:
                gwall = gwall + fwall.to(gwall.dtype)
            return (f, phi, psi, u_new, gwall), rho
        f = stream_bounce_back(f_post, model, solid=solid, rho0=cfg.lb.rho0)
        return (f, phi, psi, u_new), rho

    return step


def ternary_surface_fe(phi, psi, fe: TernaryFE, walls):
    """The ternary fluid's surface free energy beside halo walls, (rho,
    phi, psi) terms counted per fluid-site link into a wall of the first
    two axes (ref: fe_ternary_stats.c fe_ternary_surf_kernel, 2-D; the
    [rho/phi/psi] row); totals on the device."""
    dev = str(phi.device)
    nb = torch.zeros(phi.shape, dtype=phi.dtype, device=phi.device)
    for ax in range(2):
        if walls[ax]:
            nb = (nb + _edge_plane(tuple(phi.shape), ax, +1, dev)
                  + _edge_plane(tuple(phi.shape), ax, -1, dev))
    return (torch.sum(nb) * 0.5 * (-fe.h1 - fe.h2),
            torch.sum(phi * nb) * 0.5 * (-fe.h1 + fe.h2),
            torch.sum(psi * nb) * 0.5 * (fe.h1 + fe.h2 - 2.0 * fe.h3))


def initial_two_field(cfg: TwoFieldConfig, phi0, psi0, walls: bool = False):
    """(f at rest, phi0, psi0, u = 0[, gwall = 0]) on the configuration's
    device."""
    lb = cfg.lb
    phi, psi = (torch.as_tensor(np.asarray(a), dtype=lb.tdtype,
                                device=lb.device).contiguous()
                for a in (phi0, psi0))
    u = torch.zeros((3,) + tuple(lb.size), dtype=lb.tdtype, device=lb.device)
    state = (initial_rest(lb), phi, psi, u)
    if walls:
        state = state + (torch.zeros((3,), dtype=lb.tdtype,
                                     device=lb.device),)
    return state
