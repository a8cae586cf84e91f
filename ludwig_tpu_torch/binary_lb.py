"""Binary fluid via two LB distributions (symmetric_lb).

PyTorch port of the colloid-free part of ludwig_tpu/binary_lb.py (ref:
src/collision.c: lb_collision_mrt2_site :714-1015, rtau2 = 2/(1 + 2M)
:1973; Swift et al. equilibrium stress for f, order parameter carried by
the second distribution g):

  f: MRT collision with the symmetric-FE stress in the equilibrium
     second moment (the 'relaxation' force-coupling method)
  g: phi = sum g, jphi = sum c g; relax jphi toward phi u at rtau2;
     reproject with sphi = phi u u + mu I; phi rides the rest
     distribution (g_p = w_p (3 jphi.c + 4.5 sphi:Q) + phi delta_p0)

The state is (f, g, u[, gwall][, nstate][, grad, delsq]), the JAX
package's order; a step runs eagerly on the state's device.  The
colloid step of the JAX module (make_binary_lb_colloid_step) is not
ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ludwig_tpu_torch import noise_kiss
from ludwig_tpu_torch.binary import fe_fields
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.lattice import CS2, LatticeModel
from ludwig_tpu_torch.lb import LBConfig, _noise_terms, initial_rest, kiss_on
from ludwig_tpu_torch.ops.collide import collide, unrolled_matvec
from ludwig_tpu_torch.ops.le_ref import le_gradient
from ludwig_tpu_torch.ops.lees_edwards import apply_lb_le
from ludwig_tpu_torch.ops.solid_stencil import solid27_scalar_ops
from ludwig_tpu_torch.ops.stream import stream
from ludwig_tpu_torch.ops.walls import wall_bounce_back
from ludwig_tpu_torch.stats import momentum_total


@dataclasses.dataclass(frozen=True)
class BinaryLBConfig:
    lb: LBConfig
    fe: SymmetricFE
    mobility: float = 0.15
    gradient: str = "3d_7pt_fluid"

    @property
    def rtau2(self) -> float:
        return 2.0 / (1.0 + 2.0 * self.mobility)


def g_moments(g: torch.Tensor, model: LatticeModel):
    """(phi, jphi) from the order-parameter distribution."""
    gl = [g[p] for p in range(model.nvel)]
    phi = sum(gl)
    jphi = unrolled_matvec(model.cv.T.astype(np.float64), gl)
    return phi, jphi


def g_collide(g: torch.Tensor, phi, u, mu, cfg: BinaryLBConfig):
    """Order-parameter distribution collision (ref: collision.c:955-1015),
    in the JAX package's term order."""
    model = cfg.lb.model
    rtau2 = cfg.rtau2
    _, jphi = g_moments(g, model)
    jphi = [jphi[a] - rtau2 * (jphi[a] - phi * u[a]) for a in range(3)]
    # sphi = phi u u + mu I
    rows = []
    for p in range(model.nvel):
        c = model.cv[p]
        w = float(model.wv[p])
        jdotc = sum(float(c[a]) * jphi[a] for a in range(3) if c[a])
        sdotq = 0.0
        for a in range(3):
            for b in range(3):
                q = float(c[a] * c[b]) - (CS2 if a == b else 0.0)
                if q == 0.0:
                    continue
                sphi_ab = phi * u[a] * u[b] + (mu if a == b else 0.0)
                sdotq = sdotq + sphi_ab * q
        gp = w * (3.0 * jdotc + 4.5 * sdotq)
        if p == 0:
            gp = gp + phi
        rows.append(gp)
    return torch.stack(rows)


def binary_lb_solid_ops(cfg: BinaryLBConfig, wallspec=None):
    """The wetting-free 27-point solid stencil beside halo walls where the
    configuration names a *_solid gradient, else None (shared by the step
    and the statistics; its masks are made here, once)."""
    if wallspec is None or not any(wallspec.walls) or \
            not cfg.gradient.endswith("_solid"):
        return None
    return solid27_scalar_ops(cfg.lb.size, fluid=None, walls=wallspec.walls,
                              rkappa=1.0 / cfg.fe.kappa, c=0.0, h=0.0,
                              device=cfg.lb.device)


def make_binary_lb_step(cfg: BinaryLBConfig, wallspec=None, le=None):
    """Step for (f, g): ((f, g, u[, gwall][, nstate][, grad, delsq]), t=0)
    -> (state', (rho, phi)).

    With fluctuations on, the f-collision takes the same stress and ghost
    noise as the single-fluid MRT (ref: lb_collision_mrt2_site noise
    branch) from the per-site KISS state riding after u (or gwall).  With
    halo plane walls (wallspec) both distributions get half-way
    bounce-back (ref: wall.c wall_bbl_kernel ndist > 1 branch) and the
    state carries the accumulated wall momentum.  With Lees-Edwards
    planes (`le`) the gradients take the LE-aware stencil and BOTH
    distributions are reprojected and displaced at the planes after
    collision (ref: model_le.c le_reproject n-loop over ndist); the state
    then carries (grad, delsq) of the step's pre-update phi at its tail,
    for the statistics."""
    params = cfg.lb.collision_params()
    model = cfg.lb.model
    kiss_rho = kiss_on(cfg.lb)
    has_walls = wallspec is not None and any(wallspec.walls)
    solid_ops = binary_lb_solid_ops(cfg, wallspec)

    def step(state, t=0):
        if le is not None:
            state = state[:-2]
        f, g = state[0], state[1]
        phi, _ = g_moments(g, model)
        if le is not None:
            grad_le, delsq_le = le_gradient(phi, le, t, cfg.gradient)
            fields = {"phi": phi, "grad_phi": grad_le,
                      "delsq_phi": delsq_le}
        else:
            fields = fe_fields(phi, cfg.gradient, solid_ops=solid_ops)
        mu = cfg.fe.mu(fields)
        sth = cfg.fe.stress(fields)

        if kiss_rho:
            shat, ghat, nstate = _noise_terms(cfg.lb, params, t,
                                              nstate=state[-1])
        else:
            shat, ghat = _noise_terms(cfg.lb, params, t)

        # f-collision with the thermodynamic stress in the equilibrium
        # (the FE_FORCE_METHOD_RELAXATION path)
        f, rho, u = collide(f, params, seq_extra=sth, shat=shat, ghat=ghat)
        g = g_collide(g, phi, u, mu, cfg)

        if le is not None:
            f = apply_lb_le(f, model, le, t)
            g = apply_lb_le(g, model, le, t)

        out = ()
        if has_walls:
            f_post, g_post = f, g
            f = stream(f, model)
            g = stream(g, model)
            g_pre = momentum_total(f, model)
            f, g, _ = wall_bounce_back(f, f_post, model, wallspec,
                                       rho0=cfg.lb.rho0, g_post=g_post,
                                       g_new=g)
            out = (state[3] + (g_pre - momentum_total(f, model)),)
        else:
            f = stream(f, model)
            g = stream(g, model)
        out = (f, g, u) + out
        if kiss_rho:
            out = out + (nstate,)
        if le is not None:
            out = out + (grad_le, delsq_le)
        return out, (rho, phi)

    return step


def initial_binary_lb(cfg: BinaryLBConfig, phi0, walls: bool = False):
    """(f at rest, g carrying phi in the rest distribution, u = 0[,
    gwall = 0][, nstate]) on the configuration's device; the KISS state
    is default-seeded like the reference's noise object."""
    lb = cfg.lb
    phi = torch.as_tensor(np.asarray(phi0), dtype=lb.tdtype, device=lb.device)
    g = torch.zeros((lb.model.nvel,) + tuple(lb.size), dtype=lb.tdtype,
                    device=lb.device)
    g[0] = phi
    u = torch.zeros((3,) + tuple(lb.size), dtype=lb.tdtype, device=lb.device)
    state = (initial_rest(lb), g, u)
    if walls:
        state = state + (torch.zeros((3,), dtype=lb.tdtype,
                                     device=lb.device),)
    if kiss_on(lb):
        state = state + (noise_kiss.kiss_init(0, lb.size, device=lb.device),)
    return state
