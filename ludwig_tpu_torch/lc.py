"""Liquid-crystal (Q-tensor) simulation: blue phase + Beris-Edwards + LB.

PyTorch port of ludwig_tpu/lc.py (ref: src/ludwig.c q-tensor branch:
field_grad(q) -> redshift -> force via stress divergence (+ active
stress) -> beris_edwards -> collide -> stream), the reference's headline
benchmark configuration.  A step runs eagerly on the state's device.
make_lc_step is the unfused step (the CLI's `tpu_fused off` route, and
every input the JAX package's fused gate refuses) and the reference the
fused step of ops/fused_lc.py is tested against.  Its state is the JAX
package's: (f, q5, u[, gwall][, redshift][, grad_q, delsq_q]).

The unfused step takes every option of the JAX module: halo walls with
their momentum account (gwall) and the anchoring gradients
(ops/lc_anchor.py, `3d_7pt_solid` and `s7_anchoring`), in-lattice porous
solids, the dynamic redshift carried in the state, the electric field
(fe/blue_phase.py), `hydrodynamics off`, the other gradient stencils,
advection orders 1-5 and the fluctuating Q noise (lc_noise: noise_kt,
five threefry deviates a site, noise.qab_noise5).  As in the JAX package
the sheared and colloid steps, and the fused kernels' gate, leave the Q
noise out.

Under Lees-Edwards shear, make_lc_le_step is the whole sheared step and
make_lc_le_column_fix the column work around the fused kernels
(ops/fused_lc.make_fused_lc_le_step), both over all planes at once
(ops/le_ref.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ludwig_tpu_torch.dynamics.beris_edwards import (BerisEdwardsParams,
                                                     beris_edwards_update,
                                                     corotation, remove_trace)
from ludwig_tpu_torch.fe.blue_phase import (BluePhaseFE, q5_to_q33,
                                            q33_to_q5, redshift_compute)
from ludwig_tpu_torch.lb import LBConfig, initial_rest
from ludwig_tpu_torch.noise import qab_noise5
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.force import stress_divergence_force
from ludwig_tpu_torch.ops.lc_anchor import AnchoringParams, anchoring_gradient
from ludwig_tpu_torch.ops.le_ref import (LEContext, col_grad7,
                                         le_advective_fluxes,
                                         le_buffer_fields,
                                         le_flux_divergence, le_force_cols,
                                         le_gradient, le_stress_force,
                                         slab_neighbours)
from ludwig_tpu_torch.ops.lees_edwards import apply_lb_le
from ludwig_tpu_torch.ops.stencil import gradient_ops
from ludwig_tpu_torch.ops.stream import stream, stream_bounce_back
from ludwig_tpu_torch.ops.walls import (WallSpec,
                                        stress_divergence_force_walls,
                                        wall_bounce_back)

GRADIENT = "3d_7pt_fluid"      # the stencil of the fused kernels
ORDERS = (1, 2, 3, 4, 5)       # the advection orders (ops/advect.py)
SOLID_GRADIENTS = ("3d_7pt_solid", "s7_anchoring")


@dataclasses.dataclass(frozen=True)
class LCConfig:
    """Static configuration of a blue-phase run (ludwig_tpu lc.py:40):
    the stencil, the advection order, hydrodynamics on or off, halo walls
    and the anchoring of the solid stencils, the dynamic redshift, and
    keep_grads, which carries the gradients of the step's pre-update Q
    at the tail of the state, and the fluctuating Q noise (noise_kt > 0,
    lc_noise + temperature) drawn from the threefry stream under
    noise_seed."""

    lb: LBConfig
    fe: BluePhaseFE
    gamma: float = 0.1            # rotational mobility (lc_Gamma)
    advection_order: int = 1
    gradient: str = GRADIENT
    hydrodynamics: bool = True
    wallspec: Optional[WallSpec] = None
    anchoring: Optional[AnchoringParams] = None
    # dynamic redshift recompute each step (ref: blue_phase.c:1443
    # fe_lc_redshift_compute, input key lc_redshift_update)
    redshift_update: bool = False
    # fluctuating Q dynamics (ref: blue_phase_beris_edwards.c noise
    # branch; input keys lc_noise + temperature); 0 = off
    noise_kt: float = 0.0
    noise_seed: int = 8361235
    keep_grads: bool = False

    def __post_init__(self):
        if self.advection_order not in ORDERS:
            raise ValueError(
                f"advection order {self.advection_order} (have {ORDERS})")
        if self.gradient in SOLID_GRADIENTS and self.anchoring is None:
            raise ValueError(f"gradient '{self.gradient}' needs anchoring")

    @property
    def has_walls(self) -> bool:
        return self.wallspec is not None and self.wallspec.any

    @property
    def walls(self):
        return self.wallspec.walls if self.has_walls else (False,) * 3


def lc_fields(q5, gradient: str = GRADIENT, anchoring=None,
              walls=(False,) * 3, status=None, pid=None, R=None, phi=None):
    """Q and its gradients, the dict the free energy's methods take: the
    anchoring gradients of ops/lc_anchor.py for the solid stencils (with
    halo walls, a status map, colloid normals from pid and R and the phi
    scaling), else the named fluid stencil."""
    if gradient in SOLID_GRADIENTS:
        if status is None:
            status = torch.zeros(q5.shape[1:], dtype=torch.int32,
                                 device=q5.device)
        grad, delsq = anchoring_gradient(q5, anchoring, status, walls=walls,
                                         pid=pid, R=R, phi=phi)
    else:
        g, d = gradient_ops(gradient)
        grad, delsq = g(q5), d(q5)
    return {"q": q5, "grad_q": grad, "delsq_q": delsq}


def stack33(rows) -> torch.Tensor:
    """A 3x3 list of tensors as one (3, 3, ...) tensor."""
    return torch.stack([torch.stack(row) for row in rows])


def lc_stress(fe: BluePhaseFE, fields, h) -> torch.Tensor:
    """The thermodynamic stress (3, 3, ...) with the active part."""
    pth = stack33(fe.stress(fields, h=h))
    sa = fe.active_stress(fields)
    if sa is not None:
        pth = pth + stack33(sa)
    return pth


def _lc_force(cfg: LCConfig, fields, h, dtype):
    """(force, fwall): the stress-divergence force, one-sided at halo
    walls, and the momentum the walls take (None without walls)."""
    pth = lc_stress(cfg.fe, fields, h)
    if cfg.has_walls:
        force, fwall = stress_divergence_force_walls(pth, cfg.wallspec)
        return force.to(dtype), fwall
    return stress_divergence_force(pth).to(dtype), None


def _s5_corotation(q33, w, xi):
    """Corotation source S(W,Q) in 5-component form, from the velocity
    gradient tensor w[a][b] (ref: blue_phase_beris_edwards.c S(W,Q)
    construction)."""
    return q33_to_q5(corotation(q33, remove_trace(w), xi))


def make_lc_step(cfg: LCConfig, solid=None):
    """Step: ((f, q5, u[, gwall][, redshift][, grad_q, delsq_q]), t=0) ->
    (state', rho) (ludwig_tpu lc.py:122).  cfg.keep_grads carries the
    gradients of the step's pre-update Q at the tail, as the JAX
    package's unfused route does, for the statistics and the checkpoint.
    With walls the state carries gwall, the momentum given to the walls
    (the stress' one-sided fluxes and the bounce-back transfer); with the
    redshift update the redshift (a 0-d tensor, recomputed on the device
    each step).  `solid` (porous media): no
    update, collision or flux at solid sites, bounce-back on their links.
    As in the JAX package, the anchoring gradient is evaluated with no
    status map, so porous solids do not anchor Q (its lc.py:148)."""
    params = cfg.lb.collision_params()
    model = cfg.lb.model
    be = BerisEdwardsParams(gamma=cfg.gamma, xi=cfg.fe.xi,
                            advection_order=cfg.advection_order)
    fluid = None if solid is None else ~solid
    walls3 = cfg.walls
    if cfg.has_walls:
        from ludwig_tpu_torch.stats import momentum_total

    def step(state, t=0):
        f, q5, u = state[:3]
        k = 3
        gwall = rs = None
        if cfg.has_walls:
            gwall = state[k]
            k += 1
        if cfg.redshift_update:
            rs = state[k]
        fields = lc_fields(q5, cfg.gradient, anchoring=cfg.anchoring,
                           walls=walls3)
        fe = cfg.fe
        if cfg.redshift_update:
            rs = redshift_compute(cfg.fe, fields, rs)
            fe = dataclasses.replace(cfg.fe, redshift=rs)
        h = fe.molecular_field(fields)
        noise5 = None
        if cfg.noise_kt > 0.0:
            noise5 = qab_noise5(cfg.noise_seed, t, cfg.lb.size,
                                cfg.noise_kt, cfg.gamma, dtype=q5.dtype,
                                device=q5.device)
        if cfg.hydrodynamics:
            force, fwall = _lc_force(dataclasses.replace(cfg, fe=fe), fields,
                                     h, f.dtype)
            q5 = beris_edwards_update(q5, h, u, be, fluid_mask=fluid,
                                      noise5=noise5, wallspec=cfg.wallspec)
            f, rho, u_new = collide(f, params, force=force,
                                    fluid_mask=fluid)
            if cfg.has_walls:
                f_new = stream(f, model)
                g_pre = momentum_total(f_new, model)
                f_new, _, _ = wall_bounce_back(f_new, f, model, cfg.wallspec,
                                               rho0=cfg.lb.rho0)
                # the walls gain exactly what the fluid lost in the
                # bounce-back (the reference's kahan fnet is the true
                # per-link sum, identical to this difference)
                gbb = g_pre - momentum_total(f_new, model)
                gwall = gwall + fwall + gbb
                f = f_new
            elif solid is not None:
                f = stream_bounce_back(f, model, solid=solid,
                                       rho0=cfg.lb.rho0)
            else:
                f = stream(f, model)
        else:
            q5 = beris_edwards_update(q5, h, None, be, fluid_mask=fluid,
                                      noise5=noise5)
            rho = torch.ones_like(q5[0])
            u_new = u
        out = (f, q5, u_new)
        if cfg.has_walls:
            out = out + (gwall,)
        if cfg.redshift_update:
            out = out + (rs,)
        if cfg.keep_grads:
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


def initial_lc(cfg: LCConfig, q0_field: np.ndarray):
    """(f at rest, q5, u = 0[, gwall = 0][, redshift][, grad_q, delsq_q])
    on the configuration's device (ludwig_tpu lc.py:466); cfg.keep_grads
    adds Q's gradients, as make_lc_step carries them."""
    lb = cfg.lb
    f = initial_rest(lb)
    q5 = torch.as_tensor(q0_field, dtype=lb.tdtype,
                         device=lb.device).contiguous()
    u = torch.zeros((3,) + tuple(lb.size), dtype=lb.tdtype, device=lb.device)
    state = (f, q5, u)
    if cfg.has_walls:
        state = state + (torch.zeros((3,), dtype=lb.tdtype,
                                     device=lb.device),)
    if cfg.redshift_update:
        state = state + (torch.full((), float(cfg.fe.redshift),
                                    dtype=lb.tdtype, device=lb.device),)
    if cfg.keep_grads:
        fields = lc_fields(q5, cfg.gradient, anchoring=cfg.anchoring,
                           walls=cfg.walls)
        state = state + (fields["grad_q"], fields["delsq_q"])
    return state


def total_free_energy(cfg: LCConfig, q5) -> float:
    return float(torch.sum(cfg.fe.fed(lc_fields(
        q5, cfg.gradient, anchoring=cfg.anchoring, walls=cfg.walls))))


def lc_surface_fe(cfg: LCConfig, q5):
    """(f_s1, f_s2): the anchoring surface free energies summed over the
    lower and upper wall faces (ref: fe_lc_stats.c fe_lc_wallx/y/z), 0-d
    tensors."""
    anch = cfg.anchoring
    fs1 = fs2 = torch.zeros((), dtype=q5.dtype, device=q5.device)
    for ax in range(3):
        if not cfg.walls[ax]:
            continue
        # the reference RESETS fs[0]/fs[1] inside each of fe_lc_wallx/y/z,
        # so with walls in several directions only the last direction's
        # surface term survives (ref: fe_lc_stats.c fe_lc_wall{x,y,z}:
        # fs[0]=fs[1]=0.0 at entry)
        fs1 = fs2 = torch.zeros((), dtype=q5.dtype, device=q5.device)
        for side in (0, 1):
            qs5 = q5.select(1 + ax, 0 if side == 0 else q5.shape[1 + ax] - 1)
            dn = [0.0, 0.0, 0.0]
            dn[ax] = 1.0 if side == 0 else -1.0
            fes = cfg.fe.surface_fs(q5_to_q33(qs5), dn, anch.wall,
                                    anch.wall_w1, anch.wall_w2,
                                    nfix=anch.wall_nfix)
            if side == 0:
                fs1 = fs1 + torch.sum(fes)
            else:
                fs2 = fs2 + torch.sum(fes)
    return fs1, fs2
