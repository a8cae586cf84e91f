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
package's order; a step runs eagerly on the state's device.  With
resolved colloids (make_binary_lb_colloid_step) it is (f, R, V, W, dr,
Rmap, M, g, u, dphi, grad, delsq[, gwall]), dphi the particles' order
parameter deficit.
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


def make_binary_lb_colloid_step(cfg: BinaryLBConfig, params,
                                rebuild_freq: int = 1, force_fn=None,
                                phi_ref: float = 0.0, wetting=(0.0, 0.0),
                                wallspec=None):
    """step(state, t=0, rebuild=None) -> (state', (rho, u)): symmetric_lb
    with resolved colloids (ludwig_tpu binary_lb.py:197; ref: ludwig.c:
    543-560 colloid update then phi_lb_to_field, the free-energy coupling
    inside the mrt2 collision; build.c:796-832, :1022-1160; bbl.c:683-691).
    Move the particles by dr; on rebuild steps remove/replace f (the
    image-free sums with the walls' fallback beside halo walls, the
    segment sums without) and g with the deficit bookkeeping; refresh the
    interior f; phi from g, the 27-point gradients with the uniform
    wetting (C, H) at the particles (and the walls); collide f with the
    thermodynamic stress in the equilibrium and g on the fluid sites; the
    bounce-back of f with the implicit velocity update (the reference
    order beside walls, the segment sums without, as the JAX step takes
    them) and of g with the deficit spread; stream both (with halo walls,
    their bounce-back beside the colloid map).  Every map is the window
    window arithmetic's (build_map_fast's), as in the JAX step."""
    from ludwig_tpu_torch.colloids import (_ftensor, bbl_step, build_map,
                                           position_update, refresh_inside,
                                           remove_replace, solid_body_u)
    from ludwig_tpu_torch.colloids_fast import (bbl_step_seg, g_bbl_fast,
                                                g_remove_replace_fast,
                                                remove_replace_fast)
    lb = cfg.lb
    model = lb.model
    cparams = lb.collision_params()
    size = tuple(lb.size)
    has_walls = wallspec is not None and any(wallspec.walls)
    walls = tuple(wallspec.walls) if has_walls else (False,) * 3
    gravity_on = any(v != 0.0 for v in params.gravity)
    if not has_walls and params.any_active:
        # the JAX step's periodic bounce-back (bbl_step_fast) has no
        # squirmer slip; the port's segment sums would add it
        raise NotImplementedError(
            "active (squirmer) particles in a periodic symmetric_lb run "
            "are not ported (the JAX package drops their slip), see ROADMAP")
    cache = {}

    def bmap(Rm):
        if cache.get("R") is not Rm:
            cache["R"], cache["map"] = Rm, build_map(Rm, params, size,
                                                     "window")
        return cache["map"]

    def _step(state, rebuild: bool):
        f, R, V, W, dr, Rmap, Msw, g, _u, dphi = state[:10]
        gwall = state[12] if has_walls else None
        dt = f.dtype
        zero = torch.zeros((), dtype=dt, device=f.device)
        fxm = params.fixedr_mask(R.dtype, R.device)
        R = position_update(R, dr if fxm is None else fxm * dr, size)
        deltam = f0c = t0c = None
        if rebuild:
            pid_old, inside_old = bmap(Rmap)
            Rmap = R
            pid, inside = bmap(R)
            if has_walls:
                f, deltam, f0c, t0c = remove_replace(
                    f, R, inside_old, pid_old, inside, pid, model, params,
                    size, rho0=lb.rho0, V=V, W=W, walls=walls)
            else:
                f, deltam, f0c, t0c = remove_replace_fast(
                    f, R, inside_old, pid_old, inside, pid, model, params,
                    size, rho0=lb.rho0)
            g, dd = g_remove_replace_fast(g, inside_old, inside, pid_old,
                                          pid, model, params.n,
                                          phi0=phi_ref, walls=walls)
            dphi = dphi + dd
        else:
            pid, inside = bmap(Rmap)
        fluid = ~inside
        # interior sites track the solid-body velocity (bbl pass0)
        f = refresh_inside(f, model, inside,
                           solid_body_u(R, V, W, pid, inside, size))
        # phi from g; solid-aware gradients with the colloid wetting
        phi, _ = g_moments(g, model)
        grad, delsq = solid27_scalar_ops(
            size, fluid=fluid, rkappa=1.0 / cfg.fe.kappa, c=wetting[0],
            h=wetting[1], walls=walls).both(phi)
        fields = {"phi": phi, "grad_phi": grad, "delsq_phi": delsq}
        mu = cfg.fe.mu(fields)
        sth = cfg.fe.stress(fields)
        grav = _ftensor(params.gravity, f)
        force = None
        if gravity_on:
            # fluid gravity compensation (ref: interaction.c
            # colloids_update_forces_fluid_gravity)
            nfluid = torch.sum(fluid.to(dt))
            fb = (-grav) * (1.0 / nfluid) * float(params.n)
            force = torch.where(fluid[None], fb[:, None, None, None], zero)
        f, rho, u_new = collide(f, cparams, seq_extra=sth, force=force,
                                fluid_mask=fluid)
        g = torch.where(fluid[None], g_collide(g, phi, u_new, mu, cfg), g)
        ext = grav[None].expand(params.n, 3)
        if force_fn is not None:
            ext = ext + force_fn(R, V).to(dt)
        Vold = V
        if has_walls:
            f, V, W, Msw, gwbb = bbl_step(
                f, Rmap, V, W, model, params, size, pid, inside,
                ext_force=ext, rho0=lb.rho0, deltam=deltam, f0_corr=f0c,
                t0_corr=t0c, M=Msw, walls=walls)
            gwall = gwall + gwbb
        else:
            f, V, W, Msw, _ = bbl_step_seg(
                f, Rmap, V, W, model, params, size, pid, inside,
                ext_force=ext, rho0=lb.rho0, deltam=deltam, f0_corr=f0c,
                t0_corr=t0c, M=Msw)
        # g's bounce-back with the post-collision phi and the NEW
        # velocities (ref: bbl.c pass2, lb_0th_moment at site i)
        phi_post, _ = g_moments(g, model)
        g, dphi = g_bbl_fast(g, phi_post, Rmap, V, W, model, params, size,
                             dphi, walls=walls, pid_inside=(pid, inside))
        dr = 0.5 * (Vold + V)
        f_post, g_post = f, g
        f = stream(f, model)
        g = stream(g, model)
        out = (f, R, V, W, dr, Rmap, Msw, g, u_new, dphi, grad, delsq)
        if has_walls:
            f, g, gwb = wall_bounce_back(f, f_post, model, wallspec,
                                         rho0=lb.rho0, g_post=g_post,
                                         g_new=g, fluid=fluid)
            out = (f,) + out[1:7] + (g,) + out[8:] + (gwall + gwb.to(dt),)
        return out, (rho, u_new)

    def step(state, t=0, rebuild=None):
        return _step(tuple(state), int(t) % rebuild_freq == 0
                     if rebuild is None else bool(rebuild))

    return step


def initial_binary_lb_colloid(cfg: BinaryLBConfig, params, phi0, R0,
                              V0=None, W0=None, dr0=None,
                              walls: bool = False) -> tuple:
    """(f at rest, R, V, W, dr, Rmap = R, M, g carrying phi in its rest
    distribution, u = 0, dphi = 0, grad = 0, delsq = 0[, gwall = 0]) on
    the configuration's device (ludwig_tpu binary_lb.py:341)."""
    lb = cfg.lb
    nc = params.n
    dev, tdt = lb.device, lb.tdtype
    size = tuple(lb.size)

    def t(a):
        return torch.as_tensor(np.array(a, np.float64).reshape(-1, 3),
                               dtype=tdt, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=tdt, device=dev)

    g = zeros((lb.model.nvel,) + size)
    g[0] = torch.as_tensor(np.asarray(phi0), dtype=tdt, device=dev)
    R = t(R0)
    mm = (np.array(params.m, np.float64) if params.m
          else np.tile([1.0, 0.0, 0.0], (nc, 1)))
    out = (initial_rest(lb), R,
           t(V0) if V0 is not None else zeros((nc, 3)),
           t(W0) if W0 is not None else zeros((nc, 3)),
           t(dr0) if dr0 is not None else zeros((nc, 3)),
           R.clone(), t(mm), g, zeros((3,) + size), zeros((nc,)),
           zeros((3,) + size), zeros(size))
    if walls:
        out = out + (zeros((3,)),)
    return out
