"""Liquid-crystal droplet simulation: coupled (phi, Q) + LB.

PyTorch port of ludwig_tpu/lc_droplet_sim.py (ref: src/ludwig.c:693-742:
body force + momentum correction, then the divergence of the qh stress;
phi via Cahn-Hilliard, Q via Beris-Edwards, both with the coupled free
energy).  The state is the tuple (f, phi, q5, u); a step runs eagerly on
the state's device.  This is the unfused step (the CLI's `tpu_fused off`
route, and the route of every option the fused gate refuses) and the
reference the fused step of ops/fused_droplet.py is held to.

The step takes in-lattice solids (walls kept as solid planes, porous
media: no update, collision or flux at solid sites, bounce-back on their
links), every fluid stencil of ops/stencil.GRADIENTS (dab stays 7-point),
advection orders 1-5, and `fe_force_method relaxation_antisymmetric`
(only the antisymmetric stress is divergence-forced; the collision relaxes
the symmetric one).  As in the JAX package, the gradients see no solid.

Under Lees-Edwards shear, make_droplet_le_step is the whole sheared step
and make_droplet_le_column_fix the column work around the fused kernel
(ops/fused_droplet.make_fused_droplet_le_step), both over all planes at
once (ops/le_ref.py).  The sheared step takes the 7- and 27-point
stencils (the others take the 7-point form, as the JAX package's
le_gradient does) and orders 1-5, and always forces the whole qh stress.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ludwig_tpu_torch.dynamics.beris_edwards import (BerisEdwardsParams,
                                                     beris_edwards_update)
from ludwig_tpu_torch.dynamics.cahn_hilliard import (CahnHilliardParams,
                                                     cahn_hilliard_update)
from ludwig_tpu_torch.binary_le import le_cahn_hilliard
from ludwig_tpu_torch.fe.blue_phase import dq_tensor, q5_to_q33
from ludwig_tpu_torch.fe.lc_droplet import LCDropletFE
from ludwig_tpu_torch.lb import LBConfig, initial_rest
from ludwig_tpu_torch.lc import (_h5, _s5_corotation, col_advection, col_w,
                                 le_beris_edwards, stack33)
from ludwig_tpu_torch.ops.advect import blocked_faces
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.force import stress_divergence_force
from ludwig_tpu_torch.ops.le_ref import (LEContext, col_grad7, dab_from_cols,
                                         face_slab, le_buffer_dab,
                                         le_buffer_fields, le_dab_7pt,
                                         le_force_cols, le_gradient,
                                         le_stress_force, replace_col,
                                         sample_linear, slab_neighbours)
from ludwig_tpu_torch.ops.lees_edwards import apply_lb_le
from ludwig_tpu_torch.ops.stencil import GRADIENTS, dab_7pt, gradient_ops
from ludwig_tpu_torch.ops.stream import stream, stream_bounce_back

GRADIENT = "3d_7pt_fluid"      # the stencil of the fused kernels
ORDERS = (1, 2, 3, 4, 5)       # the advection orders
FORCE_METHOD = "stress_divergence"
# the force methods the droplet's step runs as written (the JAX package
# runs the other recognised ones as stress_divergence)
FORCE_METHODS = (FORCE_METHOD, "relaxation_antisymmetric")


@dataclasses.dataclass(frozen=True)
class LCDropletConfig:
    """Static configuration of a droplet run.  A stencil or an order the
    JAX package does not have raises ValueError, a force method it runs as
    stress_divergence NotImplementedError, naming the field."""

    lb: LBConfig
    fe: LCDropletFE
    mobility: float = 0.05        # phi mobility
    gamma: float = 0.5            # Q rotational mobility (lc_Gamma)
    advection_order: int = 1
    gradient: str = GRADIENT
    force_method: str = FORCE_METHOD

    def __post_init__(self):
        if self.advection_order not in ORDERS:
            raise ValueError(
                f"advection_order {self.advection_order} (have {ORDERS})")
        if self.gradient not in GRADIENTS:
            raise ValueError(f"gradient '{self.gradient}' (have {GRADIENTS})")
        if self.force_method not in FORCE_METHODS:
            raise NotImplementedError(
                f"force_method '{self.force_method}' is run as "
                f"'{FORCE_METHOD}' by the JAX package's droplet step (have "
                f"{FORCE_METHODS})")


def droplet_fields(phi, q5, gradient: str = GRADIENT):
    """phi, Q and their gradients by the named stencil, dab by the 7-point
    one: the dict the free energy's methods take."""
    grad, delsq = gradient_ops(gradient)
    return {"phi": phi, "grad_phi": grad(phi), "delsq_phi": delsq(phi),
            "dab_phi": dab_7pt(phi),
            "q": q5, "grad_q": grad(q5), "delsq_q": delsq(q5)}


def make_droplet_step(cfg: LCDropletConfig, solid=None):
    """Step: ((f, phi, q5, u), t=0) -> ((f', phi', q5', u'), rho)
    (ludwig_tpu lc_droplet_sim.py:49-110).  `solid`: the (X, Y, Z) bool
    mask of in-lattice solids, or None."""
    params = cfg.lb.collision_params()
    model = cfg.lb.model
    ch = CahnHilliardParams(mobility=cfg.mobility,
                            advection_order=cfg.advection_order)
    be = BerisEdwardsParams(gamma=cfg.gamma, xi=cfg.fe.lc.xi,
                            advection_order=cfg.advection_order)
    fluid = None if solid is None else ~solid
    faces = None if solid is None else blocked_faces(solid)
    relax_anti = cfg.force_method == "relaxation_antisymmetric"

    def step(state, t=0):
        del t
        f, phi, q5, u = state
        fields = droplet_fields(phi, q5, cfg.gradient)
        mu = cfg.fe.mu(fields)
        h = cfg.fe.molecular_field(fields)
        # corrected body force + divergence of the qh stress; with
        # relaxation_antisymmetric of its antisymmetric part only, the
        # symmetric part relaxing in the collision (ref: phi_force.c:101,
        # collision.c:413)
        stress = (cfg.fe.stress_anti(fields, h) if relax_anti
                  else cfg.fe.stress_qh(fields, h))
        force = cfg.fe.body_force(fields, mu, h)
        force = force + stress_divergence_force(stack33(stress))
        force = force.to(f.dtype)

        phi = cahn_hilliard_update(phi, mu, u, ch, solid=faces)
        # the reference updates phi first; the Beris-Edwards molecular
        # field then sees gamma(phi_new) with the (stale) gradients of the
        # pre-update fields (ref: ludwig.c order phi_cahn_hilliard ->
        # beris_edw_update; field_grad recomputed only next step)
        fields_be = dict(fields)
        fields_be["phi"] = phi
        q5 = beris_edwards_update(q5, cfg.fe.molecular_field(fields_be), u,
                                  be, fluid_mask=fluid)
        seq_extra = None
        if relax_anti:
            # the collision's symmetric stress: the updated phi and Q with
            # the pre-update gradients (ref: collision.c:417)
            fields_c = dict(fields)
            fields_c["phi"] = phi
            fields_c["q"] = q5
            seq_extra = stack33(cfg.fe.stress_symm(fields_c))
        f, rho, u_new = collide(f, params, force=force, fluid_mask=fluid,
                                seq_extra=seq_extra)
        f = stream_bounce_back(f, model, solid=solid, rho0=cfg.lb.rho0)
        return (f, phi, q5, u_new), rho

    return step


def make_droplet_nstep(cfg: LCDropletConfig, solid=None):
    """nstep(state, n, t0=0): n chained steps."""
    step = make_droplet_step(cfg, solid)

    def nstep(state, n, t0=0):
        for t in range(t0, t0 + n):
            state, _rho = step(state, t)
        return state

    return nstep


def _flds(phi, gp, dp, dab, q5, gq, dq):
    return {"phi": phi, "grad_phi": gp, "delsq_phi": dp, "dab_phi": dab,
            "q": q5, "grad_q": gq, "delsq_q": dq}


def _buffer_flds(phi, q5, ctx: LEContext, up: bool, gradient=GRADIENT):
    """The droplet's fields at the buffer column above (up) or below each
    plane: the displaced columns with gradients (by `gradient`) and dab
    through the buffer chains."""
    pb, gp, dp = le_buffer_fields(phi, ctx, up, gradient)
    qb, gq, dq = le_buffer_fields(q5, ctx, up, gradient)
    return _flds(pb, gp, dp, le_buffer_dab(phi, ctx, up), qb, gq, dq)


def make_droplet_le_step(cfg: LCDropletConfig, le):
    """Sheared droplet step: ((f, phi, q5, u), t=0) -> (state', rho) (ref:
    ludwig.c:693-742 with lees_edw planes): the droplet body force with
    plain stencils (lc_droplet.c:826) and the momentum correction, the
    flux-route force of the droplet stress (phi_force.c:91 'Must use the
    flux method for LE planes'), phi by Cahn-Hilliard with LE advection
    and the plane flux averaging, Q by Beris-Edwards with LE advection
    and LE velocity gradients, the LB reproject + displace.  The state
    carries no gradients, as the JAX package's CLI route runs it.  The
    gradients take cfg.gradient as ops/le_ref.le_gradient does (the
    27-point stencil, else the 7-point one); the whole qh stress is
    forced, so relaxation_antisymmetric, which the JAX package's sheared
    step runs as stress_divergence, raises."""
    if cfg.force_method != FORCE_METHOD:
        raise NotImplementedError(
            f"fe_force_method '{cfg.force_method}' beside Lees-Edwards planes "
            f"(the JAX package's sheared droplet runs '{FORCE_METHOD}')")
    params = cfg.lb.collision_params()
    model = cfg.lb.model
    fe = cfg.fe
    gradient = cfg.gradient

    def step(state, t=0):
        f, phi, q5, u = state
        ctx = LEContext(le, t, phi)
        grad_p, delsq_p = le_gradient(phi, le, t, gradient)
        grad_q, delsq_q = le_gradient(q5, le, t, gradient)
        fields = _flds(phi, grad_p, delsq_p, le_dab_7pt(phi, le, t), q5,
                       grad_q, delsq_q)
        mu = fe.mu(fields)
        h = fe.molecular_field(fields)
        # the body force (plain stencils, less its mean), then the
        # droplet stress's two-sided plane fluxes
        force = fe.body_force(fields, mu, h)
        pth = stack33(fe.stress_qh(fields, h))
        fb1 = _buffer_flds(phi, q5, ctx, True, gradient)
        fd0 = _buffer_flds(phi, q5, ctx, False, gradient)
        phi_new = le_cahn_hilliard(phi, mu, u, ctx, cfg.mobility,
                                   cfg.advection_order, fe.mu(fb1),
                                   fe.mu(fd0))
        area = float(phi.shape[1] * phi.shape[2])
        force = (force + le_stress_force(
            pth, stack33(fe.stress_qh(fb1)), stack33(fe.stress_qh(fd0)),
            ctx, area)).to(f.dtype)
        # gamma(phi') with the stale gradients (ref: ludwig.c order)
        fields_be = dict(fields)
        fields_be["phi"] = phi_new
        q5_new = le_beris_edwards(q5, fe.molecular_field(fields_be), u, ctx,
                                  cfg.gamma, fe.lc.xi, cfg.advection_order)
        f, rho, u_new = collide(f, params, force=force)
        f = stream(apply_lb_le(f, model, le, t), model)
        return (f, phi_new, q5_new, u_new), rho

    return step


def make_droplet_le_column_fix(cfg: LCDropletConfig, le):
    """Column corrections turning the PLAIN-periodic fused droplet outputs
    into the Lees-Edwards ones.

    The LE-corrected chemical potential at {c, c+1} feeds the CH diffusive
    flux of the faces (c-1, c) and (c+1, c+2), so phi', q5' (through
    gamma(phi')) and the force all differ at {c-1 .. c+2} of each plane;
    the plane face also takes the frame-displaced advection and the flux
    averaging (ref: phi_ch_le_fix_fluxes, phi_force_flux_fix_local,
    lc_droplet.c body force with plain stencils).  All planes at once.

    Returns fix(phi, q5, u, t) -> (idx, phi_cols, q_cols, force_cols):
    idx (4 P,) the columns c-1 .. c+2 of every plane (offset outer),
    phi_cols (4 P, Y, Z), q_cols (5, 4 P, Y, Z), force_cols (3, 4 P, Y,
    Z).  phi, q5 and u are the step's INPUTS."""
    if cfg.advection_order != 1:
        raise ValueError("fused droplet LE fix needs order-1 advection")
    if le.nx < 8 * le.nplanes:
        raise ValueError("fused droplet LE fix needs plane separation >= 8")
    fe = cfg.fe
    M = cfg.mobility

    def fix(phi, q5, u, t):
        ctx = LEContext(le, t, phi)
        P = le.nplanes
        yz = tuple(phi.shape[1:])
        area = float(yz[0] * yz[1])
        sp = ctx.slab(phi, -3, 4)           # phi at c-3 .. c+4
        sq = ctx.slab(q5, -3, 4)            # Q at c-3 .. c+4
        su = ctx.slab(u, -2, 3)             # u at c-2 .. c+3
        pb1 = ctx.col_field(phi, 1, True)
        pd0 = ctx.col_field(phi, 0, False)
        qb1 = ctx.col_field(q5, 1, True)
        qd0 = ctx.col_field(q5, 0, False)
        bufs = (_buffer_flds(phi, q5, ctx, True),
                _buffer_flds(phi, q5, ctx, False))

        # the fields at c-2 .. c+3: LE-corrected x neighbours at c and
        # c+1, plain elsewhere
        p6, q6 = sp[1:7], sq[:, 1:7]
        pm1 = slab_neighbours(sp, 0, 6, {3: pd0})
        pp1 = slab_neighbours(sp, 2, 6, {2: pb1})
        gp, dp = col_grad7(pm1, p6, pp1)
        gq, dq = col_grad7(slab_neighbours(sq, 0, 6, {3: qd0}), q6,
                           slab_neighbours(sq, 2, 6, {2: qb1}))
        f6 = _flds(p6, gp, dp, dab_from_cols(pm1, p6, pp1), q6, gq, dq)
        # with the buffer columns above and below each plane as columns
        # 6 and 7: one evaluation of the free energy's terms (a PyTorch
        # kernel each) for all eight
        f8 = {k: torch.cat([v] + [b[k].unsqueeze(-4) for b in bufs], dim=-4)
              for k, v in f6.items()}
        mu8 = fe.mu(f8)
        h8 = fe.molecular_field(f8)
        pth8 = stack33(fe.stress_qh(f8, h8))
        mu6, mu_b1, mu_d0 = mu8[:6], mu8[6], mu8[7]
        h6 = [[v[:6] for v in row] for row in h8]
        pth6 = pth8[:, :, :6]

        # Cahn-Hilliard: faces c-2 .. c+2, the plane face from both
        # frames with the averaging fix, the divergence at c-1 .. c+2
        ub1 = ctx.col_u(u, 1, True)
        ud0 = ctx.col_u(u, 0, False)
        uf5 = face_slab(su[0], 0, 5)
        faces = (uf5 * torch.where(uf5 > 0.0, sp[1:6], sp[2:7])
                 - M * (mu6[1:6] - mu6[0:5]))
        uu = 0.5 * (su[0, 2] + ub1[0])
        fe_c = (uu * torch.where(uu > 0.0, sp[3], pb1)
                - M * (mu_b1 - mu6[2]))
        uu = 0.5 * (ud0[0] + su[0, 3])
        fw_c = (uu * torch.where(uu > 0.0, pd0, sp[4])
                - M * (mu6[3] - mu_d0))
        fe_fix = 0.5 * (fe_c + sample_linear(fw_c, ctx.dy_field))
        fw_fix = 0.5 * (fw_c + sample_linear(fe_c, -ctx.dy_field))
        east = replace_col(faces[1:5], 1, fe_fix)
        west = replace_col(faces[0:4], 2, fw_fix)
        p4, m4, u4 = sp[2:6], mu6[1:5], su[:, 1:5]
        ufy = 0.5 * (u4[1] + torch.roll(u4[1], -1, -2))
        fy = (ufy * torch.where(ufy > 0.0, p4, torch.roll(p4, -1, -2))
              - M * (torch.roll(m4, -1, -2) - m4))
        ufz = 0.5 * (u4[2] + torch.roll(u4[2], -1, -1))
        fz = (ufz * torch.where(ufz > 0.0, p4, torch.roll(p4, -1, -1))
              - M * (torch.roll(m4, -1, -1) - m4))
        pcols = p4 - (east - west + fy - torch.roll(fy, 1, -2)
                      + fz - torch.roll(fz, 1, -1))

        # the force: the body part with plain mu stencils (ref:
        # lc_droplet.c:826 kernel_coords_index), then the two-sided stress
        # fluxes
        dq4 = dq_tensor(gq[:, :, 1:5])
        gmu = [0.5 * (mu6[2:6] - mu6[0:4]),
               0.5 * (torch.roll(m4, -1, -2) - torch.roll(m4, 1, -2)),
               0.5 * (torch.roll(m4, -1, -1) - torch.roll(m4, 1, -1))]
        body = []
        for a in range(3):
            v = -p4 * gmu[a]
            for b in range(3):
                for cc in range(3):
                    v = v - h6[b][cc][1:5] * dq4[a][b][cc]
            body.append(v)
        force = torch.stack(body) + le_force_cols(pth6, pth8[:, :, 6],
                                                  pth8[:, :, 7], area)

        # Beris-Edwards at c-1 .. c+2 with gamma(phi') and the stale
        # gradients (ref: ludwig.c order)
        q4 = sq[:, 2:6]
        w = col_w(slab_neighbours(su, 0, 4, {2: ud0}), u4,
                  slab_neighbours(su, 2, 4, {1: ub1}))
        div = col_advection(
            q4, slab_neighbours(sq, 1, 4, {2: qd0}),
            slab_neighbours(sq, 3, 4, {1: qb1}), u4[0],
            slab_neighbours(su[0], 0, 4, {2: ud0[0]}),
            slab_neighbours(su[0], 2, 4, {1: ub1[0]}), u4[1], u4[2])
        fbe = {k: v[..., 1:5, :, :, :] for k, v in f6.items()}
        fbe["phi"] = pcols
        hbe = _h5(fe.molecular_field(fbe))
        s5 = _s5_corotation(q5_to_q33(q4), w, fe.lc.xi)
        qcols = q4 + (torch.stack([cfg.gamma * hbe[n] + s5[n]
                                   for n in range(5)]) - div)
        return (ctx.index(-1, 0, 1, 2), pcols.reshape(4 * P, *yz),
                qcols.reshape(5, 4 * P, *yz), force.reshape(3, 4 * P, *yz))

    return fix


def initial_droplet(cfg: LCDropletConfig, phi0: np.ndarray, q0: np.ndarray):
    """(f at rest, phi, q5, u = 0) on the configuration's device."""
    lb = cfg.lb
    f = initial_rest(lb)
    phi = torch.as_tensor(phi0, dtype=lb.tdtype, device=lb.device)
    q5 = torch.as_tensor(q0, dtype=lb.tdtype, device=lb.device)
    u = torch.zeros((3,) + tuple(lb.size), dtype=lb.tdtype, device=lb.device)
    return (f, phi.contiguous(), q5.contiguous(), u)
