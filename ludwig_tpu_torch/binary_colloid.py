"""Binary fluid (finite-difference Cahn-Hilliard) with resolved colloids.

PyTorch port of ludwig_tpu/binary_colloid.py (ref: src/ludwig.c ncolloid >
0 branch of the force calculation; src/phi_force_colloid.c
pth_force_colloid - map-aware stress divergence with one-sided fluxes at
solid faces plus the particle reaction force; src/advection_bcs.c no-flux
at solid faces for the CH update; src/gradient_3d_27pt_solid.c wetting
gradients around particles).

Per step: colloid update (move + rebuild) -> solid-aware phi gradients ->
pth stress -> map force on fluid + FE reaction force on particles -> CH
update (no flux into solid) -> collide (fluid only) -> BBL (implicit
velocity update, gravity + FE force as external force) -> propagate.

The routes are the JAX step's: n > 4 passive particles take the
segment sums of colloids_fast.py (the window map, remove_replace_fast,
phi_remove_replace_conserve_fast, colloid_fe_force_fast and the
segment-sum bounce-back, all periodic as there); otherwise the
per-particle functions of this module and colloids.py (the image-free
remove/replace with the walls' fallback, the reference-order BBL).  The
per-particle sums of this module run in site order (colloids.
site_order_sums), the same on every device.  The state is the JAX package's tuple (f, R, V, W, dr, Rmap, M,
phi, u, grad_phi, delsq_phi[, gwall]); a step reads nothing back to the
host.
"""

from __future__ import annotations

import numpy as np
import torch

from ludwig_tpu_torch.colloids import (ColloidParams, _ftensor, _on_device,
                                       bbl_step, build_map, face_links,
                                       particle_site_sums, position_update,
                                       refresh_inside, remove_replace,
                                       site_order_sums, solid_body_u)
from ludwig_tpu_torch.colloids_fast import _nowall_keep
from ludwig_tpu_torch.dynamics.cahn_hilliard import (CahnHilliardParams,
                                                     cahn_hilliard_update)
from ludwig_tpu_torch.lattice import LatticeModel
from ludwig_tpu_torch.lb import initial_rest
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.force import _edge_plane, stress_divergence_force_map
from ludwig_tpu_torch.ops.solid_stencil import solid27_scalar_ops
from ludwig_tpu_torch.ops.stencil import roll3
from ludwig_tpu_torch.ops.stream import stream


def colloid_fe_force(pth: torch.Tensor, pid: torch.Tensor,
                     inside: torch.Tensor, model: LatticeModel, n_part: int,
                     walls=(False, False, False), R=None,
                     a0=0.0) -> torch.Tensor:
    """(N, 3) reaction force on each particle from the thermodynamic
    stress pth (3, 3, X, Y, Z): for every FLUID link with |c| == 1,
    force += c_id * pth(i)[:, id] evaluated at the outside (fluid) site.

    With plane walls, a link whose outside end wraps a walled axis has its
    outside site in the wall halo (MAP_BOUNDARY): no such link exists in
    the reference's map, so it is left out.  Each (direction, component)
    sum of a particle runs over the lattice in site order, as the JAX
    package's jnp.sum, from the particle's window where R (the map's
    positions) and a0 are given (colloids.site_order_sums), and the
    directions are added in the JAX package's order; the sums run in
    float64 whatever the stress' dtype, as the reference's do.  No
    atomics, nothing read back."""
    fluid = ~inside
    shape = tuple(inside.shape)
    dev, f64 = pth.device, torch.float64
    links = []
    for q in range(1, model.nvel):
        c = model.cv[q]
        if int(np.sum(np.abs(c))) != 1:
            continue
        ax = int(np.argmax(np.abs(c)))
        sgn = float(c[ax])
        # link: outside site i with i + c inside particle n
        sh = tuple(-int(v) for v in c)
        m = fluid & roll3(inside, sh)
        if walls[ax]:
            m = m & ~_edge_plane(shape, ax, 1 if sgn > 0 else -1, str(dev))
        own = torch.where(m, roll3(pid, sh).to(torch.int64), -1)
        links.append((ax, sgn, own.reshape(-1)))
    p2 = pth.reshape(3, 3, -1).to(f64)
    zero = torch.zeros((), dtype=f64, device=dev)

    def terms(nidx, flat):
        nn = nidx[:, None]
        rows = []
        for ax, _sgn, own in links:
            msk = own[flat] == nn
            rows += [torch.where(msk, p2[a, ax][flat], zero)
                     for a in range(3)]
        return torch.stack(rows, dim=1)

    like = torch.zeros((), dtype=f64, device=dev)
    s = site_order_sums(n_part if R is None else R, a0, shape,
                        3 * len(links), terms, like=like)
    out = torch.zeros((n_part, 3), dtype=f64, device=dev)
    for d, (_ax, sgn, _own) in enumerate(links):
        out = out + sgn * s[:, 3 * d:3 * d + 3]
    return out.to(pth.dtype)


def phi_remove_replace_conserve(phi, inside_old, inside_new, pid_old,
                                pid_new, model: LatticeModel, n_part: int,
                                phi0: float = 0.0, conserve: bool = True,
                                walls=(False, False, False)):
    """Order-parameter bookkeeping over a change of discrete shape
    (ludwig_tpu binary_colloid.py:81; ref: build.c
    build_remove_order_parameter / _replace_order_parameter FD branch /
    build_conservation_phi).

    Newly solid sites: deltaphi += (phi - phi0).  Newly fluid sites: phi
    <- the wv-weighted average over the neighbours fluid before (not
    across a wall), deltaphi -= (phi_new - phi0).  The accumulated
    deltaphi is then put back in equal shares onto every |c| = 1 fluid
    link site of the new map; without `conserve` (pre-v0.12 logs) it is
    not.  Each particle's sum runs over the lattice in site order."""
    dt = phi.dtype
    size = tuple(phi.shape)
    newly_solid = ~inside_old & inside_new
    newly_fluid = inside_old & ~inside_new
    was_fluid = (~inside_old).to(dt)
    one = torch.ones((), dtype=dt, device=phi.device)
    zero = torch.zeros((), dtype=dt, device=phi.device)

    def masked_sums(mask, pid, x):
        return particle_site_sums([(mask, pid)], [x], n_part, phi)[:, 0]

    dphi = 0.0 + masked_sums(newly_solid, pid_new, phi - phi0)
    num = torch.zeros_like(phi)
    den = torch.zeros_like(phi)
    for p in range(1, model.nvel):
        sh = tuple(-int(v) for v in model.cv[p])
        wf = roll3(was_fluid, sh)
        if any(walls):
            wf = wf * _on_device(_nowall_keep(size, model.cv[p], walls),
                                 phi.device).to(dt)
        w = float(model.wv[p])
        num = num + w * wf * roll3(phi, sh)
        den = den + w * wf
    avg = num / torch.where(den > 0.0, den, one)
    phi = torch.where(newly_fluid & (den > 0.0), avg, phi)
    dphi = dphi - masked_sums(newly_fluid, pid_old, phi - phi0)
    if not conserve:
        return phi
    # the put-back on the |c| = 1 fluid links of the NEW map
    masks = face_links(inside_new, pid_new)
    for n in range(n_part):
        mlist = [m & (p == n) for m, p in masks]
        saf = 0
        for m in mlist:
            saf = saf + torch.sum(m.to(dt))
        share = torch.where(saf > 0.0,
                            dphi[n] / torch.where(saf > 0.0, saf, one), zero)
        for m in mlist:
            phi = phi + torch.where(m, share, zero)
    return phi


def make_binary_colloid_step(bcfg, params: ColloidParams,
                             rebuild_freq: int = 1, force_fn=None,
                             phi_ref: float = 0.0, wallspec=None,
                             conserve_phi: bool = True):
    """step(state, t=0, rebuild=None) -> (state', (rho, u)) for the state
    (f, R, V, W, dr, Rmap, M, phi, u, grad_phi, delsq_phi[, gwall])
    (ludwig_tpu binary_colloid.py:157): move the particles by dr; on
    rebuild steps (t % rebuild_freq == 0) rebuild the map, remove/replace
    the fluid and the order parameter (conserve_phi: the put-back of
    build_conservation_phi); refresh the interior distributions; the
    27-point gradients with the uniform wetting (C, H) of bcfg.wetting at
    the particles (and halo walls); the map-aware stress force, the
    particles' reaction force (the walls' account where there are halo
    walls), the CH update with no flux into the solid, the fluid gravity,
    collide on the fluid, the bounce-back with the implicit velocity
    update (gravity, the reaction force and force_fn(R, V) as the external
    force), stream (with halo walls, the walls' bounce-back beside the
    colloid map).  grad_phi, delsq_phi are the step's gradients of the
    pre-update phi, which the statistics read."""
    cfg = bcfg.lb
    model = cfg.model
    cparams = cfg.collision_params()
    size = tuple(cfg.size)
    ch = CahnHilliardParams(mobility=bcfg.mobility,
                            advection_order=bcfg.advection_order)
    fast = params.n > 4 and not params.any_active
    has_walls = wallspec is not None and any(wallspec.walls)
    walls = tuple(wallspec.walls) if has_walls else (False,) * 3
    gravity_on = any(v != 0.0 for v in params.gravity)
    if fast:
        from ludwig_tpu_torch.colloids_fast import (
            bbl_step_seg, colloid_fe_force_fast,
            phi_remove_replace_conserve_fast, remove_replace_fast)
    if has_walls:
        from ludwig_tpu_torch.ops.walls import wall_bounce_back
    # the map is a pure function of Rmap: kept between the steps that
    # share an Rmap tensor
    cache = {}
    arith = "window" if fast else "min_image"

    def bmap(Rm):
        if cache.get("R") is not Rm:
            cache["R"], cache["map"] = Rm, build_map(Rm, params, size, arith)
        return cache["map"]

    def _step(state, rebuild: bool):
        f, R, V, W, dr, Rmap, Msw, phi, u = state[:9]
        gwall = state[11] if has_walls else None
        dt = f.dtype
        zero = torch.zeros((), dtype=dt, device=f.device)
        fxm = params.fixedr_mask(R.dtype, R.device)
        R = position_update(R, dr if fxm is None else fxm * dr, size)
        deltam = f0c = t0c = None
        if rebuild:
            pid_old, inside_old = bmap(Rmap)
            Rmap = R
            pid, inside = bmap(R)
            if fast:
                f, deltam, f0c, t0c = remove_replace_fast(
                    f, R, inside_old, pid_old, inside, pid, model, params,
                    size, rho0=cfg.rho0)
                phi = phi_remove_replace_conserve_fast(
                    phi, inside_old, inside, pid_old, pid, model, params.n,
                    phi0=phi_ref, conserve=conserve_phi)
            else:
                f, deltam, f0c, t0c = remove_replace(
                    f, R, inside_old, pid_old, inside, pid, model, params,
                    size, rho0=cfg.rho0, V=V, W=W, walls=walls)
                phi = phi_remove_replace_conserve(
                    phi, inside_old, inside, pid_old, pid, model, params.n,
                    phi0=phi_ref, conserve=conserve_phi, walls=walls)
        else:
            pid, inside = bmap(Rmap)
        fluid = ~inside
        # interior sites track the solid-body velocity (bbl pass0)
        f = refresh_inside(f, model, inside,
                           solid_body_u(R, V, W, pid, inside, size))

        # solid-aware gradients with the (uniform) colloid wetting
        grad, delsq = solid27_scalar_ops(
            size, fluid=fluid, rkappa=1.0 / bcfg.fe.kappa,
            c=bcfg.wetting[0], h=bcfg.wetting[1], walls=walls).both(phi)
        fields = {"phi": phi, "grad_phi": grad, "delsq_phi": delsq}
        mu = bcfg.fe.mu(fields)
        pth = bcfg.fe.stress(fields)
        force = stress_divergence_force_map(pth, fluid,
                                            wallspec=wallspec).to(dt)
        if fast:
            fe_part = colloid_fe_force_fast(pth, pid, inside, model,
                                            params.n)
        else:
            fe_part = colloid_fe_force(pth, pid, inside, model, params.n,
                                       walls=walls, R=Rmap,
                                       a0=max(params.a0))
        if has_walls:
            # what fluid and particles gain, the walls lose (ref:
            # pth_force_wall_kernel -> wall->fnet)
            fsum = torch.sum(torch.where(fluid[None], force, zero),
                             dim=(1, 2, 3))
            gwall = gwall - (fsum.to(gwall.dtype)
                             + torch.sum(fe_part, dim=0))
        phi = cahn_hilliard_update(phi, mu, u, ch, solid=inside,
                                   wallspec=wallspec)
        grav = _ftensor(params.gravity, f)
        if gravity_on:
            # fluid gravity compensation (ref: interaction.c
            # colloids_update_forces_fluid_gravity)
            nfluid = torch.sum(fluid.to(dt))
            fb = (-grav) * (1.0 / nfluid) * float(params.n)
            force = force + torch.where(fluid[None], fb[:, None, None, None],
                                        zero)
        f, rho, u_new = collide(f, cparams, force=force, fluid_mask=fluid)
        ext = grav[None].expand(params.n, 3) + fe_part
        if force_fn is not None:
            ext = ext + force_fn(R, V).to(dt)
        Vold = V
        if fast:
            # the JAX fast route's bounce-back is periodic (no wall links)
            f, V, W, Msw, gwbb = bbl_step_seg(
                f, Rmap, V, W, model, params, size, pid, inside,
                ext_force=ext, rho0=cfg.rho0, deltam=deltam, f0_corr=f0c,
                t0_corr=t0c, M=Msw)
        else:
            f, V, W, Msw, gwbb = bbl_step(
                f, Rmap, V, W, model, params, size, pid, inside,
                ext_force=ext, rho0=cfg.rho0, deltam=deltam, f0_corr=f0c,
                t0_corr=t0c, M=Msw, walls=walls)
        dr = 0.5 * (Vold + V)
        f_post = f
        f = stream(f, model)
        out = (f, R, V, W, dr, Rmap, Msw, phi, u_new, grad, delsq)
        if has_walls:
            f, _, gwb = wall_bounce_back(f, f_post, model, wallspec,
                                         rho0=cfg.rho0, fluid=fluid)
            gwall = (gwall + gwbb) + gwb.to(dt)
            out = (f,) + out[1:] + (gwall,)
        return out, (rho, u_new)

    def step(state, t=0, rebuild=None):
        return _step(tuple(state), int(t) % rebuild_freq == 0
                     if rebuild is None else bool(rebuild))

    return step


def initial_binary_colloid(bcfg, params: ColloidParams, phi0, R0, V0=None,
                           W0=None, dr0=None, walls: bool = False) -> tuple:
    """(f at rest, R, V, W, dr, Rmap = R, M, phi, u = 0, grad_phi = 0,
    delsq_phi = 0[, gwall = 0]) on the configuration's device (ludwig_tpu
    binary_colloid.py:317): M the input swimming directions (x by
    default); V, W, dr zero unless given."""
    cfg = bcfg.lb
    nc = params.n
    dev, tdt = cfg.device, cfg.tdtype
    size = tuple(cfg.size)

    def t(a):
        return torch.as_tensor(np.array(a, np.float64).reshape(-1, 3),
                               dtype=tdt, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=tdt, device=dev)

    R = t(R0)
    mm = (np.array(params.m, np.float64) if params.m
          else np.tile([1.0, 0.0, 0.0], (nc, 1)))
    out = (initial_rest(cfg), R,
           t(V0) if V0 is not None else zeros((nc, 3)),
           t(W0) if W0 is not None else zeros((nc, 3)),
           t(dr0) if dr0 is not None else zeros((nc, 3)),
           R.clone(), t(mm),
           torch.as_tensor(np.asarray(phi0), dtype=tdt, device=dev),
           zeros((3,) + size), zeros((3,) + size), zeros(size))
    if walls:
        out = out + (zeros((3,)),)
    return out
