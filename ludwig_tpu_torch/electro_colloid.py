"""Electrokinetics with resolved colloids.

PyTorch port of ludwig_tpu/electro_colloid.py (ref: src/psi_colloid.c
psi_colloid_rho_set / remove / replace / zetapotential; src/build.c
build_conservation_psi charge conservation on shape change;
src/psi_force.c psi_force_gradmu_e colloid/fluid force split with
momentum correction; src/ludwig.c psi branch of the loop).

Per step: colloid update (move + rebuild + charge remove/replace +
conservation put-back) -> colloid charge density set -> Poisson solve ->
force (colloid reaction + fluid force) -> Nernst-Planck sub-cycles (fluid
only) -> psi zero-mean -> collide -> BBL -> propagation.  The JAX step's
route: the reference SOR (electro_sim.poisson_sor_ref, which reads its
residual back every 5 iterations), the face Nernst-Planck update, the
image-free remove/replace and the reference-order bounce-back of
colloids.py.  The per-particle sums run in site order over the lattice
(colloids.particle_site_sums), the charge put-back's link-by-link
decrements as one chain (no count read back).  The state is the JAX
package's (f, R, V, W, dr, Rmap, M, psi, rho, u, deltaq).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ludwig_tpu_torch.colloids import (ColloidParams, _ftensor, bbl_step,
                                       build_map, chain_sums, face_links,
                                       particle_site_sums, position_update,
                                       refresh_inside, remove_replace,
                                       solid_body_u)
from ludwig_tpu_torch.electro import rho_elec
from ludwig_tpu_torch.electro_sim import (ElectroSimConfig,
                                          make_psi_neighbours, np_step,
                                          poisson_sor_ref, site_sum)
from ludwig_tpu_torch.lb import initial_rest
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.stencil import roll3
from ludwig_tpu_torch.ops.stream import stream


def colloid_charge_remove_replace(rho, inside_old, inside_new, pid_old,
                                  pid_new, deltaq, nk: int):
    """Charge bookkeeping over a change of discrete shape (ludwig_tpu
    electro_colloid.py:35; ref: psi_colloid.c psi_colloid_remove_charge /
    _replace_charge): the charge of newly solid sites goes to the
    particle; a newly fluid site takes the 6-point average over its
    neighbours that were fluid, which the particle's account pays.
    Returns (rho, the deltaq increment (N, nk))."""
    newly_solid = ~inside_old & inside_new
    newly_fluid = inside_old & ~inside_new
    was_fluid = (~inside_old).to(rho.dtype)
    n_part = deltaq.shape[0]
    removed = particle_site_sums([(newly_solid, pid_new)] * nk,
                             [rho[k] for k in range(nk)], n_part, rho)
    num = torch.zeros_like(rho)
    den = torch.zeros_like(rho[0])
    for ax in range(3):
        for sgn in (+1, -1):
            sh = [0, 0, 0]
            sh[ax] = -sgn
            wf = roll3(was_fluid, tuple(sh))
            den = den + wf
            num = num + wf[None] * roll3(rho, tuple(sh), first_axis=1)
    one = torch.ones((), dtype=rho.dtype, device=rho.device)
    avg = num / torch.where(den > 0.0, den, one)[None]
    # the newly fluid site belonged to the OLD map's owner
    paid = particle_site_sums([(newly_fluid, pid_old)] * nk,
                          [avg[k] for k in range(nk)], n_part, rho)
    dq = (torch.zeros_like(deltaq) + removed) + (-paid)
    return torch.where(newly_fluid[None], avg, rho), dq


def charge_conservation_putback(rho, fluid, inside, pid, dq, nk: int,
                                nvel_faces: int = 6, a0max=None):
    """The particles' accumulated charge put back onto their boundary
    fluid sites (ludwig_tpu electro_colloid.py:79; ref: build.c
    build_conservation_psi): each |c| = 1 fluid link site receives dq/saf
    unless that would make its density negative, the links taken face by
    face; what was not put back stays in deltaq, decremented link by link
    as the reference does (build.c:1563-1568) - one chain of the accepted
    links' shares on the device, no count read back, as long as the
    links a particle of radius a0max can have (every link of the whole
    lattice when a0max is None)."""
    del nvel_faces                 # the six faces, as the JAX function
    dt, dev = rho.dtype, rho.device
    n_part = dq.shape[0]
    faces = face_links(inside, pid)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    nsite = inside.numel()
    if a0max is not None:
        nsite = min(nsite, (2 * int(math.ceil(a0max)) + 3) ** 3)
    bound = 6 * nsite
    rho = rho.clone()
    for n in range(n_part):
        mlist = [m & (p == n) for m, p in faces]
        saf = 0
        for m in mlist:
            saf = saf + torch.sum(m.to(dt))
        safe = torch.where(saf > 0.0, saf, one)
        for k in range(nk):
            share = torch.where(saf > 0.0, dq[n, k] / safe, zero)
            nacc = torch.zeros((), dtype=torch.int64, device=dev)
            rk = rho[k]
            for m in mlist:
                cand = rk + share
                accept = m & (cand >= 0.0)
                rk = torch.where(accept, cand, rk)
                nacc = nacc + torch.sum(accept.to(torch.int64))
            rho[k] = rk
            dq = dq.clone()
            dq[n, k] = _decrement(dq[n, k], share, nacc, bound)
    return rho, dq


def _decrement(x, share, nacc, bound: int):
    """x - share - share - ... (nacc <= bound times, in order) on the
    device: one chain of bound slots, those past nacc exact zeros, and x
    itself where nacc is 0 (a zero added could flip the sign of a zero)."""
    idx = torch.arange(bound, device=x.device)
    seq = torch.where(idx < nacc, -share, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    left = chain_sums(seq.reshape(1, bound, 1), x.reshape(1, 1))[0, 0]
    return torch.where(nacc > 0, left, x)


def colloid_rho_set(rho, inside, pid, q_coll, deltaq, nk: int):
    """Each particle's total charge spread over its current discrete
    volume (ludwig_tpu electro_colloid.py:115; ref: psi_colloid.c
    psi_colloid_rho_set): max(0, q + deltaq) / volume at its sites."""
    n_part = deltaq.shape[0]
    dt = rho.dtype
    one = torch.ones((), dtype=dt, device=rho.device)
    ids = torch.arange(n_part, device=rho.device)
    own = (pid[None] == ids[:, None, None, None]) & inside[None]
    vol = torch.sum(own.to(dt), dim=(1, 2, 3))                # exact counts
    volsafe = torch.where(vol > 0.0, vol, one)
    val = torch.clamp(q_coll[:, :nk] + deltaq, min=0.0) / volsafe[:, None]
    owner = torch.clamp(pid.to(torch.int64), 0, n_part - 1)
    return torch.where(inside[None], torch.movedim(val[owner], -1, 0), rho)


def _e_field(psi, cfg: ElectroSimConfig, psi_up, psi_dn):
    ek = cfg.ek
    kt = 1.0 / ek.beta
    return [-0.5 * (psi_up(psi, ax) - psi_dn(psi, ax)) * (kt / ek.e)
            for ax in range(3)]


def _colloid_forces(force, inside, pid, n_part: int):
    """(N, 3): the force at each particle's sites, summed in site order."""
    own = [(inside, pid)] * 3
    return particle_site_sums(own, [force[a] for a in range(3)], n_part, force)


def gradmu_force_colloid(psi, rho, cfg: ElectroSimConfig, psi_up, psi_dn,
                         fluid, inside, pid, n_part: int):
    """(fluid force field, per-particle force) for the grad-mu method with
    particles (ludwig_tpu electro_colloid.py:129; ref: psi_force.c
    psi_force_gradmu_e): every site contributes rho_elec E, the colloid
    sites' to their particle; the sum over ALL sites divided by the fluid
    count is taken from the fluid sites only."""
    re = rho_elec(rho, cfg.ek)
    force = torch.stack([re * e for e in _e_field(psi, cfg, psi_up,
                                                  psi_dn)])
    fsum = torch.sum(force, dim=(1, 2, 3))
    nfluid = torch.sum(fluid.to(force.dtype))
    corr = fsum / nfluid
    fcoll = _colloid_forces(force, inside, pid, n_part)
    zero = torch.zeros((), dtype=force.dtype, device=force.device)
    return (torch.where(fluid[None], force - corr[:, None, None, None],
                        zero), fcoll)


def divstress_force_colloid(psi, rho, cfg: ElectroSimConfig, psi_up,
                            psi_dn, fluid, inside, pid, n_part: int):
    """(fluid force field, per-particle force) for the stress-divergence
    method (ludwig_tpu electro_colloid.py:155; ref: psi_force.c
    psi_force_divstress): the Maxwell stress S_ab = -eps (E_a E_b - d_ab
    E^2 / 2) without the ideal-gas term (the v0.2.19-era behaviour of
    serial-elec-ep1), no momentum correction; the colloid sites' force
    goes to their particle."""
    del rho
    eps = cfg.ek.epsilon
    e = _e_field(psi, cfg, psi_up, psi_dn)
    e2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
    force = []
    for a in range(3):
        acc = 0.0
        for b in range(3):
            s_ab = -eps * (e[a] * e[b] - (0.5 * e2 if a == b else 0.0))
            acc = acc + 0.5 * (torch.roll(s_ab, -1, b)
                               - torch.roll(s_ab, 1, b))
        force.append(-acc)
    force = torch.stack(force)
    fcoll = _colloid_forces(force, inside, pid, n_part)
    zero = torch.zeros((), dtype=force.dtype, device=force.device)
    return torch.where(fluid[None], force, zero), fcoll


def zeta_potential(psi, fluid, inside):
    """The mean of the link-midpoint potential over the colloid surface
    (ludwig_tpu electro_colloid.py:191; ref: psi_colloid.c
    psi_colloid_zetapotential; one colloid)."""
    tot = torch.zeros((), dtype=psi.dtype, device=psi.device)
    cnt = torch.zeros((), dtype=psi.dtype, device=psi.device)
    for ax in range(3):
        for sgn in (+1, -1):
            sh = [0, 0, 0]
            sh[ax] = -sgn
            m = (fluid & roll3(inside, tuple(sh))).to(psi.dtype)
            tot = tot + torch.sum(m * 0.5 * (psi + roll3(psi, tuple(sh))))
            cnt = cnt + torch.sum(m)
    one = torch.ones((), dtype=psi.dtype, device=psi.device)
    return torch.where(cnt > 0.0, tot / torch.where(cnt > 0.0, cnt, one),
                       torch.zeros_like(tot))


def make_electro_colloid_step(cfg: ElectroSimConfig, params: ColloidParams,
                              q_coll, rebuild_freq: int = 1, force_fn=None,
                              force_method: str = "phi_gradmu_correction"):
    """step(state, t=0, rebuild=None) -> (state', (rho_lb, u, (n, rnorm,
    which))) for (f, R, V, W, dr, Rmap, M, psi, rho, u, deltaq)
    (ludwig_tpu electro_colloid.py:208): q_coll (N, 2) the input charges
    (colloid_*_q0 / q1), a tensor on the state's device; the last item
    is the SOR report.  The map is build_map's min-image one."""
    lb = cfg.lb
    model = lb.model
    cparams = lb.collision_params()
    size = tuple(lb.size)
    nk = cfg.ek.nk
    psi_up, psi_dn = make_psi_neighbours(size, cfg.e0, lb.tdtype, lb.device)
    gravity_on = any(v != 0.0 for v in params.gravity)
    m_sub = cfg.ek.multisteps
    dt_np = 1.0 / m_sub
    n_sites = float(np.prod(size))
    cache = {}

    def bmap(Rm):
        if cache.get("R") is not Rm:
            cache["R"], cache["map"] = Rm, build_map(Rm, params, size)
        return cache["map"]

    def _step(state, rebuild: bool):
        f, R, V, W, dr, Rmap, Msw, psi, rho, u, deltaq = state
        dt = f.dtype
        zero = torch.zeros((), dtype=dt, device=f.device)
        fxm = params.fixedr_mask(R.dtype, R.device)
        R = position_update(R, dr if fxm is None else fxm * dr, size)
        deltam = f0c = t0c = None
        if rebuild:
            pid_old, inside_old = bmap(Rmap)
            Rmap = R
            pid, inside = bmap(R)
            f, deltam, f0c, t0c = remove_replace(
                f, R, inside_old, pid_old, inside, pid, model, params, size,
                rho0=lb.rho0)
            rho, dq = colloid_charge_remove_replace(
                rho, inside_old, inside, pid_old, pid, deltaq, nk)
            rho, deltaq = charge_conservation_putback(
                rho, ~inside, inside, pid, dq + deltaq, nk,
                a0max=max(params.a0))
        else:
            pid, inside = bmap(Rmap)
        fluid = ~inside
        # interior sites track the solid-body velocity
        f = refresh_inside(f, model, inside,
                           solid_body_u(R, V, W, pid, inside, size))
        rho = colloid_rho_set(rho, inside, pid, q_coll, deltaq, nk)
        psi, *sor = poisson_sor_ref(psi, rho_elec(rho, cfg.ek), cfg.ek,
                                    psi_up, psi_dn, return_iters=True)
        if force_method == "stress_divergence":
            force, fcoll = divstress_force_colloid(
                psi, rho, cfg, psi_up, psi_dn, fluid, inside, pid, params.n)
        else:
            force, fcoll = gradmu_force_colloid(
                psi, rho, cfg, psi_up, psi_dn, fluid, inside, pid, params.n)
        for _ in range(m_sub):
            rho = np_step(rho, psi, u if cfg.hydrodynamics else None, fluid,
                          cfg, psi_up, psi_dn, dt_np)
        # (ref: psi.c psi_zero_mean)
        psi = psi - site_sum(psi) / n_sites
        fb_force = force.to(dt)
        grav = _ftensor(params.gravity, f)
        if gravity_on:
            # fluid gravity compensation (ref: interaction.c)
            nfluid = torch.sum(fluid.to(dt))
            fb = (-grav) * (1.0 / nfluid) * float(params.n)
            fb_force = fb_force + torch.where(
                fluid[None], fb[:, None, None, None], zero)
        f, rho_lb, u_new = collide(f, cparams, force=fb_force,
                                   fluid_mask=fluid)
        ext = grav[None].expand(params.n, 3) + fcoll
        if force_fn is not None:
            ext = ext + force_fn(R, V).to(dt)
        Vold = V
        f, V, W, Msw, _ = bbl_step(f, Rmap, V, W, model, params, size, pid,
                                   inside, ext_force=ext, rho0=lb.rho0,
                                   deltam=deltam, f0_corr=f0c, t0_corr=t0c,
                                   M=Msw)
        dr = 0.5 * (Vold + V)
        f = stream(f, model)
        return ((f, R, V, W, dr, Rmap, Msw, psi, rho, u_new, deltaq),
                (rho_lb, u_new, tuple(sor)))

    def step(state, t=0, rebuild=None):
        return _step(tuple(state), int(t) % rebuild_freq == 0
                     if rebuild is None else bool(rebuild))

    return step


def initial_electro_colloid(cfg: ElectroSimConfig, params: ColloidParams,
                            psi0, rho0, R0, V0=None) -> tuple:
    """(f at rest, R, V, W = 0, dr = 0, Rmap = R, M, psi, rho, u = 0,
    deltaq = 0 (N, nk)) on the configuration's device (ludwig_tpu
    electro_colloid.py:318)."""
    lb = cfg.lb
    nc = params.n
    dev, tdt = lb.device, lb.tdtype

    def t(a):
        return torch.as_tensor(np.array(a, np.float64).reshape(-1, 3),
                               dtype=tdt, device=dev)

    R = t(R0)
    zeros = torch.zeros((nc, 3), dtype=tdt, device=dev)
    mm = (np.array(params.m, np.float64) if params.m
          else np.tile([1.0, 0.0, 0.0], (nc, 1)))
    return (initial_rest(lb), R,
            t(V0) if V0 is not None else zeros.clone(), zeros.clone(),
            zeros.clone(), R.clone(), t(mm),
            torch.as_tensor(np.asarray(psi0), dtype=tdt, device=dev),
            torch.as_tensor(np.asarray(rho0), dtype=tdt, device=dev),
            torch.zeros((3,) + tuple(lb.size), dtype=tdt, device=dev),
            torch.zeros((nc, cfg.ek.nk), dtype=tdt, device=dev))
