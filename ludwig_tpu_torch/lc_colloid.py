"""Liquid crystal (Q-tensor) with resolved colloids.

PyTorch port of ludwig_tpu/lc_colloid.py (ref: src/ludwig.c ncolloid > 0
branch: colloids_update -> anchoring gradients with the colloid map
(gradient_3d_7pt_solid.c / gradient_s7_anchoring.c) -> pth_force_colloid
(map-aware stress divergence + particle reaction force,
src/phi_force_colloid.c) -> beris_edw_update with fix_swd velocity and
no-normal-flux advection (src/blue_phase_beris_edwards.c:257-285) ->
collide (fluid) -> BBL -> propagation.  Surface free-energy statistics
follow src/fe_lc_stats.c fe_lc_colloid / blue_phase_fs).

The state is the JAX package's tuple (f, R, V, W, dr, Rmap, M, q5, u,
grad_q, delsq_q[, gwall]).  The particles run on the colloid core of
colloids.py: its map, the image-free remove/replace and the
bounce-back in the reference's link order (bbl_step, the route the JAX
module takes for every N).  A step reads nothing back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ludwig_tpu_torch.binary_colloid import colloid_fe_force
from ludwig_tpu_torch.colloids import (ColloidParams, _ftensor, _min_image,
                                       bbl_step, build_map, position_update,
                                       refresh_inside, remove_replace,
                                       site_coords, solid_body_u)
from ludwig_tpu_torch.dynamics.beris_edwards import (BerisEdwardsParams,
                                                     beris_edwards_update)
from ludwig_tpu_torch.fe.blue_phase import q5_to_q33
from ludwig_tpu_torch.lb import initial_rest
from ludwig_tpu_torch.lc import LCConfig, lc_stress
from ludwig_tpu_torch.ops.advect import blocked_faces
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.force import stress_divergence_force_map
from ludwig_tpu_torch.ops.lc_anchor import MAP_COLLOID, anchoring_gradient
from ludwig_tpu_torch.ops.stencil import roll3
from ludwig_tpu_torch.ops.stream import stream


def lc_colloid_fields(q5, anchoring, pid, inside, R,
                      walls=(False, False, False)):
    """Anchoring-aware gradients with the colloid status map (and halo
    plane walls)."""
    status = inside.to(torch.int32) * MAP_COLLOID
    grad, delsq = anchoring_gradient(q5, anchoring, status, pid=pid, R=R,
                                     walls=walls)
    return {"q": q5, "grad_q": grad, "delsq_q": delsq}


def q_replace_newly_fluid(q5, inside_old, inside_new, model):
    """Q at sites that have just become fluid: the wv-weighted average
    over the neighbours that were fluid before the position update (ref:
    build.c build_replace_order_parameter, FD branch)."""
    newly = inside_old & ~inside_new
    was_fluid = (~inside_old).to(q5.dtype)
    num = torch.zeros_like(q5)
    den = torch.zeros_like(q5[0])
    for p in range(1, model.nvel):
        sh = tuple(-int(v) for v in model.cv[p])   # value at i + c_p
        wf = roll3(was_fluid, sh)
        qn = roll3(q5, sh, first_axis=1)
        w = float(model.wv[p])
        num = num + w * wf[None] * qn
        den = den + w * wf
    one = torch.ones((), dtype=q5.dtype, device=q5.device)
    repl = num / torch.where(den > 0.0, den, one)[None]
    use = newly & (den > 0.0)
    return torch.where(use[None], repl, q5)


def lc_colloid_surface_fe(fe, anchoring, q5, pid, inside, R, size):
    """(f_s, area), 0-d tensors: the anchoring surface free energy and the
    discrete area over fluid sites with a +-1 colloid neighbour, the
    outward normal taken from the colloid centre (ref: fe_lc_stats.c
    fe_lc_colloid, colloids.c colloids_q_boundary_normal)."""
    fluid = ~inside
    qs = q5_to_q33(q5)
    coords = site_coords(size, q5.dtype, q5.device)
    L = _ftensor([float(s) for s in size], q5).reshape(3, 1, 1, 1)
    fs = torch.zeros((), dtype=q5.dtype, device=q5.device)
    area = torch.zeros((), dtype=q5.dtype, device=q5.device)
    one = torch.ones((), dtype=q5.dtype, device=q5.device)
    for ax in range(3):
        for sgn in (+1, -1):
            sh = [0, 0, 0]
            sh[ax] = -sgn
            nb_in = roll3(inside, tuple(sh))        # colloid at i+sgn*e_ax
            pid_n = roll3(pid, tuple(sh))
            m = fluid & nb_in
            # the true outward normal: from the colloid centre to the site
            own = torch.clamp(pid_n.to(torch.int64), 0, R.shape[0] - 1)
            d = _min_image(coords - torch.movedim(R[own], -1, 0), L)
            rd = torch.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
            dn = d / torch.where(rd > 0.0, rd, one)[None]
            fes = fe.surface_fs(qs, dn, anchoring.coll, anchoring.coll_w1,
                                anchoring.coll_w2)
            md = m.to(q5.dtype)
            fs = fs + torch.sum(md * fes)
            area = area + torch.sum(md)
    return fs, area


def make_lc_colloid_step(lcfg: LCConfig, params: ColloidParams,
                         rebuild_freq: int = 1, force_fn=None):
    """step(state, t=0, rebuild=None) -> (state', (rho, u)) for the state
    (f, R, V, W, dr, Rmap, M, q5, u, grad_q, delsq_q[, gwall])
    (ludwig_tpu lc_colloid.py:99): move the particles by dr; on rebuild
    steps (t % rebuild_freq == 0) rebuild the map from the new positions,
    remove/replace the fluid and give the newly fluid sites Q; refresh the
    interior distributions; the anchoring gradients with the colloid map;
    without hydrodynamics the relaxational Q update alone; else the
    map-aware stress force and the particles' reaction force (the walls'
    account where there are halo walls), the fluid gravity, the
    Beris-Edwards update with the solid-body velocity inside and no flux
    through the solid, collide on the fluid, the bounce-back with the
    implicit velocity update (gravity, the reaction force and force_fn(R,
    V) as the external force), stream (with halo walls, the walls'
    bounce-back beside the colloid map).  The grad_q, delsq_q leaves are
    the step's gradients of the pre-update Q, for the statistics."""
    cfg = lcfg.lb
    model = cfg.model
    cparams = cfg.collision_params()
    size = tuple(cfg.size)
    be = BerisEdwardsParams(gamma=lcfg.gamma, xi=lcfg.fe.xi,
                            advection_order=lcfg.advection_order)
    has_walls = lcfg.has_walls
    walls3 = lcfg.walls
    wallspec = lcfg.wallspec if has_walls else None
    gravity_on = any(v != 0.0 for v in params.gravity)
    if has_walls:
        from ludwig_tpu_torch.ops.walls import wall_bounce_back
    # the map is a pure function of Rmap: kept between the steps that
    # share an Rmap tensor
    cache = {}

    def bmap(Rm):
        if cache.get("R") is not Rm:
            cache["R"], cache["map"] = Rm, build_map(Rm, params, size)
        return cache["map"]

    def _step(state, rebuild: bool):
        f, R, V, W, dr, Rmap, Msw, q5, u = state[:9]
        gwall = state[11] if has_walls else None
        dt = f.dtype
        fxm = params.fixedr_mask(R.dtype, R.device)
        R = position_update(R, dr if fxm is None else fxm * dr, size)
        deltam = f0c = t0c = None
        if rebuild:
            pid_old, inside_old = bmap(Rmap)
            Rmap = R
            pid, inside = bmap(R)
            # the image-free sums, as the JAX step takes them (it passes
            # no walls to the remove/replace)
            f, deltam, f0c, t0c = remove_replace(
                f, R, inside_old, pid_old, inside, pid, model, params, size,
                rho0=cfg.rho0)
            q5 = q_replace_newly_fluid(q5, inside_old, inside, model)
        else:
            pid, inside = bmap(Rmap)
        fluid = ~inside
        # interior sites track the solid-body velocity (bbl pass0 /
        # beris_edw_fix_swd)
        ub = solid_body_u(R, V, W, pid, inside, size)
        f = refresh_inside(f, model, inside, ub)

        # anchoring gradients with the colloid map
        fields = lc_colloid_fields(q5, lcfg.anchoring, pid, inside, Rmap,
                                   walls=walls3)
        h = lcfg.fe.molecular_field(fields)

        def out(f, V, W, dr, Msw, q5, u, gwall):
            return ((f, R, V, W, dr, Rmap, Msw, q5, u, fields["grad_q"],
                     fields["delsq_q"]) + ((gwall,) if has_walls else ()))

        if not lcfg.hydrodynamics:
            # relaxational dynamics only (ref: beris_edw_update with
            # hydro == NULL; no force, no collision, no BBL)
            q5 = beris_edwards_update(q5, h, None, be, fluid_mask=fluid)
            return (out(f, V, W, dr, Msw, q5, u, gwall),
                    (torch.sum(f, dim=0), u))
        pth = lc_stress(lcfg.fe, fields, h)
        force = stress_divergence_force_map(pth, fluid,
                                            wallspec=wallspec).to(dt)
        fe_part = colloid_fe_force(pth, pid, inside, model, params.n,
                                   walls=walls3, R=Rmap, a0=max(params.a0))
        if has_walls:
            # the walls absorb what the stress injects into fluid and
            # particles (ref: pth_force_wall_kernel -> wall fnet)
            zero = torch.zeros((), dtype=dt, device=f.device)
            finj = torch.sum(torch.where(fluid[None], force, zero),
                             dim=(1, 2, 3))
            gwall = gwall - (finj + torch.sum(fe_part, dim=0))
        grav = _ftensor(params.gravity, f)
        if gravity_on:
            # fluid gravity compensation (ref: interaction.c
            # colloids_update_forces_fluid_gravity)
            nfluid = torch.sum(fluid.to(dt))
            fb = (-grav) * (1.0 / nfluid) * float(params.n)
            force = force + torch.where(fluid[None], fb[:, None, None, None],
                                        torch.zeros((), dtype=dt,
                                                    device=f.device))
        # the BE update with the solid-body velocity inside the particles
        # (beris_edw_fix_swd) and no flux through the solid surface
        u_fix = torch.where(fluid[None], u, ub)
        q5 = beris_edwards_update(q5, h, u_fix, be, fluid_mask=fluid,
                                  solid=blocked_faces(inside),
                                  wallspec=wallspec)
        f, rho, u_new = collide(f, cparams, force=force, fluid_mask=fluid)
        ext = grav[None].expand(params.n, 3) + fe_part
        if force_fn is not None:
            ext = ext + force_fn(R, V).to(dt)
        Vold = V
        f, V, W, Msw, gwbb = bbl_step(f, Rmap, V, W, model, params, size,
                                      pid, inside, ext_force=ext,
                                      rho0=cfg.rho0, deltam=deltam,
                                      f0_corr=f0c, t0_corr=t0c, M=Msw,
                                      walls=walls3)
        dr = 0.5 * (Vold + V)
        f_post = f
        f = stream(f, model)
        if has_walls:
            # the walled link account with the colloid map: covered wall
            # sites do not bounce (the halo's w rho0 streams in); their
            # anomaly rides in gwbb (ref: wall.c wall_bbl_kernel)
            f, _, gwb2 = wall_bounce_back(f, f_post, model, wallspec,
                                          rho0=cfg.rho0, fluid=fluid)
            gwall = (gwall + gwbb) + gwb2.to(dt)
        return out(f, V, W, dr, Msw, q5, u_new, gwall), (rho, u_new)

    def step(state, t=0, rebuild=None):
        return _step(tuple(state), int(t) % rebuild_freq == 0
                     if rebuild is None else bool(rebuild))

    return step


def initial_lc_colloid(lcfg: LCConfig, params: ColloidParams, q0_field,
                       R0, V0=None) -> tuple:
    """(f at rest, R, V, W = 0, dr = 0, Rmap = R, M, q5, u = 0, grad_q,
    delsq_q[, gwall = 0]) on the configuration's device (ludwig_tpu
    lc_colloid.py:241): M the input swimming directions (x by default),
    the gradients those of the map of R."""
    cfg = lcfg.lb
    nc = params.n
    dev, tdt = cfg.device, cfg.tdtype

    def t(a):
        return torch.as_tensor(np.array(a, np.float64).reshape(-1, 3),
                               dtype=tdt, device=dev)

    f = initial_rest(cfg)
    R = t(R0)
    V = t(V0) if V0 is not None else torch.zeros((nc, 3), dtype=tdt,
                                                 device=dev)
    mm = (np.array(params.m, np.float64) if params.m
          else np.tile([1.0, 0.0, 0.0], (nc, 1)))
    q5 = torch.as_tensor(q0_field, dtype=tdt, device=dev).contiguous()
    pid, inside = build_map(R, params, cfg.size)
    fields = lc_colloid_fields(q5, lcfg.anchoring, pid, inside, R,
                               walls=lcfg.walls)
    zeros = torch.zeros((nc, 3), dtype=tdt, device=dev)
    out = (f, R, V, zeros, zeros.clone(), R.clone(), t(mm), q5,
           torch.zeros((3,) + tuple(cfg.size), dtype=tdt, device=dev),
           fields["grad_q"], fields["delsq_q"])
    if lcfg.has_walls:
        out = out + (torch.zeros((3,), dtype=tdt, device=dev),)
    return out
