"""Liquid-crystal (Q-tensor) simulation: blue phase + Beris-Edwards + LB.

PyTorch port of the periodic, hydrodynamics-on branch of ludwig_tpu/lc.py
(ref: src/ludwig.c q-tensor branch: field_grad(q) -> force via stress
divergence (+ active stress) -> beris_edwards -> collide -> stream), the
reference's headline benchmark configuration.  The state is the tuple
(f, q5, u); a step runs eagerly on the state's device.  This is the
unfused step (the CLI's `tpu_fused off` route) and the reference the
fused step of ops/fused_lc.py is tested against.

Under Lees-Edwards shear, make_lc_le_step is the whole sheared step and
make_lc_le_column_fix the column work around the fused kernels
(ops/fused_lc.make_fused_lc_le_step), both over all planes at once
(ops/le_ref.py).  Walls, anchoring gradients, the dynamic redshift, the
noise term, the electric field, `hydrodynamics off` and LC colloids are
not ported yet (ROADMAP, slice 4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ludwig_tpu_torch.dynamics.beris_edwards import (BerisEdwardsParams,
                                                     beris_edwards_update,
                                                     corotation, remove_trace)
from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE, q5_to_q33, q33_to_q5
from ludwig_tpu_torch.lb import LBConfig, initial_rest
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.force import stress_divergence_force
from ludwig_tpu_torch.ops.le_ref import (LEContext, col_grad7,
                                         le_advective_fluxes,
                                         le_buffer_fields,
                                         le_flux_divergence, le_force_cols,
                                         le_gradient, le_stress_force,
                                         slab_neighbours)
from ludwig_tpu_torch.ops.lees_edwards import apply_lb_le
from ludwig_tpu_torch.ops.stencil import gradient_ops
from ludwig_tpu_torch.ops.stream import stream

GRADIENT = "3d_7pt_fluid"      # the stencil of the ported LC slice
ORDERS = (1, 2)                # the ported advection orders


@dataclasses.dataclass(frozen=True)
class LCConfig:
    """Static configuration of a blue-phase run: periodic, 7-point
    gradients, hydrodynamics on.  The JAX package's walls, anchoring,
    redshift update, noise and `hydrodynamics off` are not ported yet
    (ROADMAP, slice 4)."""

    lb: LBConfig
    fe: BluePhaseFE
    gamma: float = 0.1            # rotational mobility (lc_Gamma)
    advection_order: int = 1

    def __post_init__(self):
        if self.advection_order not in ORDERS:
            raise NotImplementedError(
                f"advection order {self.advection_order} is not ported "
                f"yet (have {ORDERS}), see ROADMAP")


def lc_fields(q5, gradient: str = GRADIENT):
    """Q and its gradients, the dict the free energy's methods take.  The
    LC slice takes the 7-point stencil only."""
    if gradient != GRADIENT:
        raise NotImplementedError(
            f"gradient '{gradient}' of the liquid crystal is not ported yet "
            f"(have '{GRADIENT}'), see ROADMAP")
    g, d = gradient_ops(gradient)
    return {"q": q5, "grad_q": g(q5), "delsq_q": d(q5)}


def stack33(rows) -> torch.Tensor:
    """A 3x3 list of tensors as one (3, 3, ...) tensor."""
    return torch.stack([torch.stack(row) for row in rows])


def _lc_force(cfg: LCConfig, fields, h, dtype):
    pth = stack33(cfg.fe.stress(fields, h=h))
    sa = cfg.fe.active_stress(fields)
    if sa is not None:
        pth = pth + stack33(sa)
    return stress_divergence_force(pth).to(dtype)


def _s5_corotation(q33, w, xi):
    """Corotation source S(W,Q) in 5-component form, from the velocity
    gradient tensor w[a][b] (ref: blue_phase_beris_edwards.c S(W,Q)
    construction)."""
    return q33_to_q5(corotation(q33, remove_trace(w), xi))


def make_lc_step(cfg: LCConfig, keep_grads: bool = False):
    """Step: ((f, q5, u[, grad_q, delsq_q]), t=0) -> ((f', q5', u'[,
    grad_q, delsq_q]), rho).  keep_grads carries the gradients of the
    step's pre-update Q at the tail of the state, as the JAX package's
    unfused route does (its LCConfig.keep_grads), for the statistics and
    the checkpoint."""
    params = cfg.lb.collision_params()
    model = cfg.lb.model
    be = BerisEdwardsParams(gamma=cfg.gamma, xi=cfg.fe.xi,
                            advection_order=cfg.advection_order)

    def step(state, t=0):
        del t
        f, q5, u = state[:3]
        fields = lc_fields(q5)
        h = cfg.fe.molecular_field(fields)
        force = _lc_force(cfg, fields, h, f.dtype)
        q5 = beris_edwards_update(q5, h, u, be)
        f, rho, u_new = collide(f, params, force=force)
        out = (stream(f, model), q5, u_new)
        if keep_grads:
            out = out + (fields["grad_q"], fields["delsq_q"])
        return out, rho

    return step


def _h_pth(fe: BluePhaseFE, q5, grad, delsq):
    """(h 3x3 list, stress (3, 3, ...) with the active part)."""
    flds = {"q": q5, "grad_q": grad, "delsq_q": delsq}
    h = fe.molecular_field(flds)
    pth = stack33(fe.stress(flds, h=h))
    sa = fe.active_stress(flds)
    if sa is not None:
        pth = pth + stack33(sa)
    return h, pth


def _h5(h):
    return [h[0][0], h[0][1], h[0][2], h[1][1], h[1][2]]


def le_beris_edwards(q5, h, u, ctx: LEContext, gamma: float, xi: float,
                     order: int):
    """q5' of the Beris-Edwards update with LE advection (the plane's
    west flux kept apart, no averaging fix) and the LE velocity gradient
    at the plane columns (ref: beris_edw_update with lees_edw planes).
    Shared by the LC and droplet steps."""
    fe_x, fw, fy, fz = le_advective_fluxes(q5, u, ctx, order)
    div = le_flux_divergence(fe_x, fw, fy, fz, ctx)
    w = [[0.5 * (torch.roll(u[a], -1, b) - torch.roll(u[a], 1, b))
          for b in range(3)] for a in range(3)]
    ub1 = ctx.col_u(u, 1, True)
    ud0 = ctx.col_u(u, 0, False)
    for a in range(3):
        w[a][0] = ctx.put(w[a][0], 0, 0, 0.5 * (ub1[a] - ctx.col(u[a], -1)))
        w[a][0] = ctx.put(w[a][0], 0, 1, 0.5 * (ctx.col(u[a], 2) - ud0[a]))
    s5 = _s5_corotation(q5_to_q33(q5), w, xi)
    h5 = _h5(h)
    rhs = torch.stack([gamma * h5[n] + s5[n] for n in range(5)]) - div
    return q5 + rhs


def make_lc_le_step(cfg: LCConfig, le, keep_grads: bool = False):
    """Sheared LC step: ((f, q5, u[, grad_q, delsq_q]), t=0) -> (state',
    rho) (ref: the q-tensor branch of ludwig.c with lees_edw planes:
    LE-aware gradients, two-sided stress fluxes with the mean fix, Q
    advection with separate plane west fluxes, the LE velocity gradient
    tensor, LB reproject + displace).  keep_grads carries the LE-aware
    gradients of the pre-update Q at the tail of the state."""
    params = cfg.lb.collision_params()
    model = cfg.lb.model

    def step(state, t=0):
        f, q5, u = state[:3]
        ctx = LEContext(le, t, q5)
        grad, delsq = le_gradient(q5, le, t)
        h, pth = _h_pth(cfg.fe, q5, grad, delsq)
        _h, pth_b1 = _h_pth(cfg.fe, *le_buffer_fields(q5, ctx, True))
        _h, pth_d0 = _h_pth(cfg.fe, *le_buffer_fields(q5, ctx, False))
        area = float(q5.shape[2] * q5.shape[3])
        force = le_stress_force(pth, pth_b1, pth_d0, ctx, area).to(f.dtype)
        q5_new = le_beris_edwards(q5, h, u, ctx, cfg.gamma, cfg.fe.xi,
                                  cfg.advection_order)
        f, rho, u_new = collide(f, params, force=force)
        f = stream(apply_lb_le(f, model, le, t), model)
        out = (f, q5_new, u_new)
        if keep_grads:
            out = out + (grad, delsq)
        return out, rho

    return step


def _upw(a, b, uf):
    return uf * torch.where(uf > 0.0, a, b)


def col_w(um1x, u0, up1x):
    """w[a][b] = d_b u_a at columns u0 (3, ..., Y, Z), the x derivative
    from the given (possibly LE-sampled) neighbour columns."""
    return [[0.5 * (up1x[a] - um1x[a]),
             0.5 * (torch.roll(u0[a], -1, -2) - torch.roll(u0[a], 1, -2)),
             0.5 * (torch.roll(u0[a], -1, -1) - torch.roll(u0[a], 1, -1))]
            for a in range(3)]


def col_advection(qc, lo_nb, hi_nb, u0x, lo_u, hi_u, uy, uz):
    """Order-1 upwind flux divergence of columns qc (..., K, P, Y, Z):
    x faces from the given west and east neighbour columns and face
    velocity partners, y and z faces within the columns."""
    fe_hi = _upw(qc, hi_nb, 0.5 * (u0x + hi_u))
    fe_lo = _upw(lo_nb, qc, 0.5 * (lo_u + u0x))
    ufy = 0.5 * (uy + torch.roll(uy, -1, -2))
    fy = _upw(qc, torch.roll(qc, -1, -2), ufy)
    ufz = 0.5 * (uz + torch.roll(uz, -1, -1))
    fz = _upw(qc, torch.roll(qc, -1, -1), ufz)
    return (fe_hi - fe_lo + fy - torch.roll(fy, 1, -2)
            + fz - torch.roll(fz, 1, -1))


def make_lc_le_column_fix(cfg: LCConfig, le):
    """Column corrections turning the PLAIN-periodic fused LC outputs
    into the Lees-Edwards ones.

    The fused kernels treat x as plain periodic; under shear only the
    plane-adjacent columns differ: q5' at {c, c+1} and the force at
    {c-1 .. c+2} of each plane (order-1 advection, 7-point gradients).
    This recomputes exactly those columns with make_lc_le_step's formulas
    (ref: gradient_3d_7pt_fluid _le, advection.c LE kernels,
    phi_force_flux + fix, the beris_edwards LE velocity gradients), all
    planes at once.

    Returns fix(q5, u, t) -> ((qidx, q_cols), (fidx, force_cols)): qidx
    (2 P,) the columns c, c+1 of every plane (offset outer), q_cols (5,
    2 P, Y, Z); fidx (4 P,) the columns c-1 .. c+2, force_cols (3, 4 P,
    Y, Z).  q5 and u are the step's INPUTS."""
    if cfg.advection_order != 1:
        raise ValueError("fused LE fix needs order-1 advection")
    if le.nx < 6 * le.nplanes:
        # the per-plane column slabs (c-3 .. c+4) must not overlap the
        # next plane's fix set
        raise ValueError("fused LE fix needs plane separation >= 6")
    fe = cfg.fe

    def fix(q5, u, t):
        ctx = LEContext(le, t, q5)
        P = le.nplanes
        yz = tuple(q5.shape[2:])
        area = float(yz[0] * yz[1])
        sq = ctx.slab(q5, -3, 4)            # Q at c-3 .. c+4
        su = ctx.slab(u, -1, 2)             # u at c-1 .. c+2
        pb1 = ctx.col_field(q5, 1, True)
        pd0 = ctx.col_field(q5, 0, False)
        # the molecular field and the stress at c-2 .. c+3: LE-aware x
        # neighbours at c and c+1, plain elsewhere
        q6 = sq[:, 1:7]
        g6, d6 = col_grad7(slab_neighbours(sq, 0, 6, {3: pd0}), q6,
                           slab_neighbours(sq, 2, 6, {2: pb1}))
        # with the buffer columns above and below each plane as columns
        # 6 and 7: one evaluation of the free energy's terms (a PyTorch
        # kernel each) for all eight
        bufs = (le_buffer_fields(q5, ctx, True),
                le_buffer_fields(q5, ctx, False))
        h8, pth8 = _h_pth(fe, *(
            torch.cat([x] + [b[k].unsqueeze(-4) for b in bufs], dim=-4)
            for k, x in enumerate((q6, g6, d6))))
        force = le_force_cols(pth8[:, :, :6], pth8[:, :, 6], pth8[:, :, 7],
                              area)

        # Beris-Edwards at c, c+1
        ub1 = ctx.col_u(u, 1, True)
        ud0 = ctx.col_u(u, 0, False)
        qc = q6[:, 2:4]
        u0 = su[:, 1:3]
        w = col_w(slab_neighbours(su, 0, 2, {1: ud0}), u0,
                  slab_neighbours(su, 2, 2, {0: ub1}))
        s5 = _s5_corotation(q5_to_q33(qc), w, fe.xi)
        div = col_advection(
            qc, slab_neighbours(sq, 2, 2, {1: pd0}),
            slab_neighbours(sq, 4, 2, {0: pb1}), u0[0],
            slab_neighbours(su[0], 0, 2, {1: ud0[0]}),
            slab_neighbours(su[0], 2, 2, {0: ub1[0]}), u0[1], u0[2])
        h5 = [v[2:4] for v in _h5(h8)]
        rhs = torch.stack([cfg.gamma * h5[n] + s5[n] for n in range(5)]) \
            - div
        qcols = qc + rhs
        return ((ctx.index(0, 1), qcols.reshape(5, 2 * P, *yz)),
                (ctx.index(-1, 0, 1, 2), force.reshape(3, 4 * P, *yz)))

    return fix


def make_lc_nstep(cfg: LCConfig):
    """nstep(state, n, t0=0): n chained steps."""
    step = make_lc_step(cfg)

    def nstep(state, n, t0=0):
        for t in range(t0, t0 + n):
            state, _rho = step(state, t)
        return state

    return nstep


def initial_lc(cfg: LCConfig, q0_field: np.ndarray, keep_grads: bool = False):
    """(f at rest, q5, u = 0[, grad_q, delsq_q]) on the configuration's
    device; keep_grads adds Q's gradients, as make_lc_step(keep_grads)
    carries them."""
    lb = cfg.lb
    f = initial_rest(lb)
    q5 = torch.as_tensor(q0_field, dtype=lb.tdtype,
                         device=lb.device).contiguous()
    u = torch.zeros((3,) + tuple(lb.size), dtype=lb.tdtype, device=lb.device)
    if keep_grads:
        fields = lc_fields(q5)
        return (f, q5, u, fields["grad_q"], fields["delsq_q"])
    return (f, q5, u)


def total_free_energy(cfg: LCConfig, q5) -> float:
    return float(torch.sum(cfg.fe.fed(lc_fields(q5))))
