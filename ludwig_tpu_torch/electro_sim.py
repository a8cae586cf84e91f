"""Electrokinetics orchestration: the full `fe_electro` time step.

PyTorch port of ludwig_tpu/electro_sim.py (ref: src/ludwig.c:609-677).
Per LB step:

  1. Poisson solve for the reduced potential psi (SOR or FFT);
  2. body force on the fluid via grad-mu with the momentum correction
     (ref: src/psi_force.c:76-183 psi_force_gradmu_e);
  3. Nernst-Planck charge transport, sub-cycled ``multisteps`` times with
     dt = 1/multisteps (ref: src/nernst_planck.c:339-560);
  4. psi_zero_mean (ref: src/psi.c psi_zero_mean);
  5. LB collide (+force) and propagate with bounce-back at boundary
     sites (the Gouy-Chapman walls are in-lattice solid sites).

Two routes, chosen as the JAX package chooses them but on semantic
conditions only: in float32 the SOR solve, the Nernst-Planck sub-step
with the grad-mu force and the LB update run through
ops/fused_electro.sor_solve_fused, ops/fused_electro.np_gradmu_fused and
ops/fused.fused_force_step(solid=) (CUDA kernels on a GPU, their plain
twins on the CPU); float64 is the reference route below, op for op the
JAX package's jnp route (the golden tier).

Initial conditions mirror src/psi_init.c (gouy_chapman, liquid_junction,
uniform) and src/psi.c:880 psi_electroneutral; they are built in host
numpy like the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ludwig_tpu_torch.electro import ElectroConfig, poisson_fft, rho_elec
from ludwig_tpu_torch.lattice import lb_model
from ludwig_tpu_torch.lb import DTYPES, LBConfig
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.fused import fused_force_step
from ludwig_tpu_torch.ops.fused_electro import (kernel_supported,
                                                np_gradmu_fused, red_mask,
                                                sor_solve_fused)
from ludwig_tpu_torch.ops.stream import (stream_bounce_back,
                                         wall_momentum_transfer)


@dataclasses.dataclass(frozen=True)
class ElectroSimConfig:
    lb: LBConfig
    ek: ElectroConfig
    e0: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # external field
    hydrodynamics: bool = True
    # NP link stencil: 7 (faces only), 19 or 27 incl. diagonal links
    # (ref: psi_rt.c:264 electrokinetics_solver_stencil)
    stencil: int = 7


# -- neighbour fetches with the external-field potential jump ---------------

def _jump_arrays(shape, e0, dtype, device):
    """Per-axis wrap-plane corrections for the reduced potential.

    The reference extends psi across periodic boundaries with a jump
    -e0_a * N_a (ref: src/psi.c:664-795 psi_halo_psijump), which makes
    the stored psi behave as a linear-in-x potential plus a periodic
    part.  Returns (up_corr, dn_corr) lists; None where e0_a == 0.
    """
    ups, dns = [], []
    for ax in range(3):
        if float(e0[ax]) == 0.0:
            ups.append(None)
            dns.append(None)
            continue
        n = shape[ax]
        up = np.zeros(shape)
        dn = np.zeros(shape)
        sl = [slice(None)] * 3
        sl[ax] = n - 1
        up[tuple(sl)] = -float(e0[ax]) * n
        sl[ax] = 0
        dn[tuple(sl)] = +float(e0[ax]) * n
        ups.append(torch.as_tensor(up, dtype=dtype, device=device))
        dns.append(torch.as_tensor(dn, dtype=dtype, device=device))
    return ups, dns


def make_psi_neighbours(shape, e0, dtype, device):
    """(up, dn) neighbour-fetch functions for psi honouring the e0 jump;
    `dtype` a torch dtype or its name."""
    dtype = DTYPES.get(dtype, dtype)
    ups, dns = _jump_arrays(shape, e0, dtype, device)

    def up(p, ax):
        q = torch.roll(p, -1, ax)
        return q if ups[ax] is None else q + ups[ax]

    def dn(p, ax):
        q = torch.roll(p, 1, ax)
        return q if dns[ax] is None else q + dns[ax]

    return up, dn


# -- reference-exact SOR solver ----------------------------------------------

def poisson_sor_ref(psi0: torch.Tensor, rho_el: torch.Tensor,
                    cfg: ElectroConfig, psi_up, psi_dn,
                    return_iters: bool = False):
    """Red/black SOR with Chebyshev acceleration, matching the reference
    iteration step for step (ref: src/psi_sor.c:132-300
    psi_solver_sor_solve):

      residual = eps * del2_7pt(psi) + e * beta * rho_el
      psi     += omega * residual / (6 * eps)

    with omega(0) = 1, omega after the first half-sweep 1/(1-r^2/2) and
    thereafter 1/(1 - r^2 omega / 4) (a float64 recurrence on the host);
    spectral radius estimate r = 1 - (pi/max(Lx,Lz))^2 / 2; convergence
    checked every 5 whole iterations against sqrt-sum-squared residuals,
    rnorm0 being the norm of the right-hand side.  Each half-sweep
    evaluates the residual from the whole pre-sweep field, so odd
    periodic extents (same-colour neighbours across the wrap) behave as
    in the JAX package.

    In float32 a check that shows no progress over the previous one
    (rnorm1 >= 0.995 prev) also stops the loop: the reference's f64
    tolerances sit below the f32 residual floor.  The decision needs the
    residual on the host, so the loop synchronises with the device once
    per check (every 5 iterations).

    With `return_iters` also returns the printed iteration index, the
    final residual norm and which criterion held (0 absolute, 1
    relative), as tensors (ref: psi_sor.c:263-292)."""
    if cfg.max_its < 1:
        raise ValueError(f"max_its must be >= 1, got {cfg.max_its}")
    shape = psi0.shape
    eps = cfg.epsilon
    rhs = (cfg.e * cfg.beta) * rho_el
    red = red_mask(shape, psi0.device)
    black = torch.logical_not(red)
    zero = torch.zeros((), dtype=psi0.dtype, device=psi0.device)
    radius = 1.0 - 0.5 * (np.pi / max(shape[0], shape[2])) ** 2
    rnorm0 = torch.sqrt(torch.sum(rhs * rhs))
    f32 = psi0.dtype == torch.float32

    def neigh_sum(p):
        s = 0.0
        for ax in range(3):
            s = s + psi_up(p, ax) + psi_dn(p, ax)
        return s

    def half_sweep(p, mask, omega):
        res = eps * (neigh_sum(p) - 6.0 * p) + rhs
        p = torch.where(mask, p + omega * res / (6.0 * eps), p)
        return p, torch.sum(torch.where(mask, res * res, zero))

    p, omega, prev, n = psi0, 1.0, None, 0
    while True:
        p, s_red = half_sweep(p, red, omega)
        omega = (1.0 / (1.0 - 0.5 * radius * radius) if n == 0
                 else 1.0 / (1.0 - 0.25 * radius * radius * omega))
        p, s_blk = half_sweep(p, black, omega)
        omega = 1.0 / (1.0 - 0.25 * radius * radius * omega)
        rnorm1 = torch.sqrt(s_red + s_blk)
        stop = False
        if n % 5 == 0:
            conv = torch.logical_or(rnorm1 < cfg.abs_tol,
                                    rnorm1 < cfg.rel_tol * rnorm0)
            if f32 and n > 0:
                conv = torch.logical_or(conv, rnorm1 >= 0.995 * prev)
            prev = rnorm1
            stop = bool(conv)
        if stop or n == cfg.max_its - 1:
            break
        n += 1
    if not return_iters:
        return p
    dev = psi0.device
    which = torch.where(rnorm1 < cfg.abs_tol, 0, 1).to(torch.int32)
    return (p, torch.full((), n, dtype=torch.int32, device=dev), rnorm1,
            which)


# -- grad-mu force with momentum correction ----------------------------------

def gradmu_force(psi, rho, cfg: ElectroSimConfig, psi_up, psi_dn,
                 n_sites: float):
    """F = rho_elec E - <F> (ref: psi_force_gradmu_e).  The mean is taken
    over all non-colloid sites (boundary sites included), and the
    corrected force applied there too; only fluid sites feel it in the
    collision."""
    ek = cfg.ek
    kt = 1.0 / ek.beta
    re = rho_elec(rho, ek)
    force = []
    for ax in range(3):
        e_ax = -0.5 * (psi_up(psi, ax) - psi_dn(psi, ax)) * (kt / ek.e)
        force.append(re * e_ax)
    force = torch.stack(force)
    fsum = torch.sum(force, dim=(1, 2, 3)) / n_sites
    return force - fsum[:, None, None, None]


# -- Nernst-Planck (reference d3q7 link fluxes, face formulation) ------------

def np_step(rho, psi, u, fluid, cfg: ElectroSimConfig, psi_up, psi_dn,
            dt: float, mu_ex=None):
    """One NP sub-step, dt = 1/multisteps (ref: nernst_planck.c:349-520,
    np_advective_fluxes, np_no_flux_boundary, nernst_planck_update_d3qx).

    Fluxes live on the +axis faces: F_a(i) is the flux from site i to
    i+1 along axis a.  Both link directions of the reference collapse
    onto these faces by antisymmetry; the divergence is the face-flux
    difference.  A face is active only when both ends are fluid.

    mu_ex: optional per-species excess (solvation) chemical potential
    fields in kT units, added to the reduced link potential as mu =
    mu_ex/e + z psi (ref: nernst_planck_fluxes_d3qx with
    fe->func->mu_solv; fe_electro_symmetric's fe_es_mu_ion_solv)."""
    ek = cfg.ek
    zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
    face_mask = [torch.logical_and(fluid, torch.roll(fluid, -1, ax))
                 for ax in range(3)]
    new = []
    for k in range(ek.nk):
        z = float(ek.valency[k])
        d = float(ek.diffusivity[k])
        nk_ = rho[k]
        mu = z * psi
        if mu_ex is not None:
            mu = mu + mu_ex[k] / ek.e
        div = 0.0
        for ax in range(3):
            mu1 = z * psi_up(psi, ax)
            if mu_ex is not None:
                mu1 = mu1 + torch.roll(mu_ex[k], -1, ax) / ek.e
            dmu = mu1 - mu
            b0 = torch.exp(-dmu)
            b1 = torch.exp(dmu)
            n1 = torch.roll(nk_, -1, ax)
            flx = -d * 0.5 * (1.0 + b0) * (n1 * b1 - nk_)
            if u is not None and cfg.hydrodynamics:
                ua = 0.5 * (u[ax] + torch.roll(u[ax], -1, ax))
                flx = flx + ua * 0.5 * (nk_ + n1)
            flx = torch.where(face_mask[ax], flx, zero)
            div = div + flx - torch.roll(flx, 1, ax)
        new.append(torch.where(fluid, nk_ - dt * div, nk_))
    return torch.stack(new)


def np_step_d3qx(rho, psi, u, fluid, cfg: ElectroSimConfig, psi_up,
                 psi_dn, dt: float, npoints: int = 19):
    """One NP sub-step on a D3Q19/D3Q27 link stencil (ref:
    nernst_planck.c:349-520 nernst_planck_driver_d3qx, stencil.h:43
    LB_RCS_TABLE; selected by the electrokinetics_solver_stencil key).

    np_step's face formulation extended to the diagonal links: for each
    positive half-link direction c the flux from site i to i + c carries
    the linkwise-Boltzmann diffusive term scaled by 1/|c| plus the
    centred advective term 0.5 ((u0 + u1) . c) 0.5 (rho0 + rho1).  A link
    is active only when both ends are fluid; psi neighbour fetches
    compose the per-axis psi_up/psi_dn so e0 wrap jumps apply per
    crossed boundary plane."""
    ek = cfg.ek
    model = lb_model(npoints)
    zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
    # positive half set: first nonzero component positive
    half = []
    for p in range(1, model.nvel):
        c = tuple(int(v) for v in model.cv[p])
        if next(v for v in c if v != 0) > 0:
            half.append(c)

    def fetch_psi(p, c):
        q = p
        for ax in range(3):
            if c[ax] > 0:
                q = psi_up(q, ax)
            elif c[ax] < 0:
                q = psi_dn(q, ax)
        return q

    def roll_c(x, c):
        return torch.roll(x, tuple(-v for v in c), (0, 1, 2))

    psi_n = {c: fetch_psi(psi, c) for c in half}
    fl_n = {c: roll_c(fluid, c) for c in half}
    new = []
    for k in range(ek.nk):
        z = float(ek.valency[k])
        d = float(ek.diffusivity[k])
        nk_ = rho[k]
        mu0 = z * psi
        div = 0.0
        for c in half:
            rcs = (float(sum(v * v for v in c))) ** -0.5
            dmu = z * psi_n[c] - mu0
            b0 = torch.exp(-dmu)
            b1 = torch.exp(dmu)
            n1 = roll_c(nk_, c)
            flx = (-d * 0.5 * (1.0 + b0) * (n1 * b1 - nk_)) * rcs
            if u is not None and cfg.hydrodynamics:
                uc = 0.0
                for ax in range(3):
                    if c[ax]:
                        uc = uc + (u[ax] + roll_c(u[ax], c)) * float(c[ax])
                flx = flx + (0.5 * uc) * (0.5 * (nk_ + n1))
            flx = torch.where(torch.logical_and(fluid, fl_n[c]), flx, zero)
            div = div + flx - torch.roll(flx, tuple(c), (0, 1, 2))
        new.append(torch.where(fluid, nk_ - dt * div, nk_))
    return torch.stack(new)


# -- initial conditions (ref: src/psi_init.c), host numpy -------------------

def init_uniform(size, rho_el, nk=2, dtype=np.float64):
    psi = np.zeros(size, dtype)
    rho = np.full((nk,) + tuple(size), rho_el, dtype)
    return psi, rho


def init_gouy_chapman(size, rho_el, sigma, dtype=np.float64):
    """Walls at x=1 and x=Lx (1-based), wall charge sigma on species 0,
    counter-charge on species 1 (ref: psi_init.c:80-152).
    Returns (psi, rho, boundary_mask)."""
    nx = size[0]
    psi = np.zeros(size, dtype)
    rho_i = sigma * 2.0 * size[1] * size[2] / (
        size[1] * size[2] * (nx - 2.0))
    rho = np.empty((2,) + tuple(size), dtype)
    rho[0] = rho_el
    rho[1] = rho_el + rho_i
    rho[0, 0] = sigma
    rho[1, 0] = 0.0
    rho[0, nx - 1] = sigma
    rho[1, nx - 1] = 0.0
    boundary = np.zeros(size, bool)
    boundary[0] = True
    boundary[nx - 1] = True
    return psi, rho, boundary


def init_liquid_junction(size, rho_el, delta_el, dtype=np.float64):
    """Left half rho_el + delta/2, right half rho_el - delta/2 in both
    species (ref: psi_init.c:169-210)."""
    nx = size[0]
    psi = np.zeros(size, dtype)
    prof = np.where(np.arange(1, nx + 1) <= nx // 2,
                    rho_el + 0.5 * delta_el, rho_el - 0.5 * delta_el)
    rho = np.broadcast_to(prof[None, :, None, None],
                          (2,) + tuple(size)).astype(dtype).copy()
    return psi, rho


def electroneutral(rho, valency, solid: Optional[np.ndarray]):
    """Add countercharge on fluid sites of one species so the net charge
    vanishes (ref: src/psi.c:880 psi_electroneutral)."""
    rho = np.array(rho, copy=True)
    fluid = np.ones(rho.shape[1:], bool) if solid is None \
        else np.logical_not(solid)
    vf = float(fluid.sum())
    qtot = sum(float(valency[k]) * rho[k].sum() for k in range(len(rho)))
    rhoi = abs(qtot) / vf
    nc = -1
    if qtot * valency[0] >= 0:
        nc = 1
    if qtot * valency[1] >= 0:
        nc = 0
    rho[nc] = np.where(fluid, rho[nc] + rhoi, rho[nc])
    return rho


def site_sum(x: torch.Tensor) -> torch.Tensor:
    """Global sum for in-step physics: a site-order running sum in
    float64 (the golden-log contract of the JAX package's stats.seq_sum;
    on the CPU torch's cumsum is that sequential loop), a plain
    reduction in float32."""
    if x.dtype == torch.float64:
        return torch.cumsum(x.reshape(-1), 0)[-1]
    return torch.sum(x)


def initial_electro(cfg: ElectroSimConfig, f, psi0, rho0):
    """(f, psi, rho, u, gwall) on the configuration's device: f as given,
    psi and rho from host arrays, u and the wall momentum zero."""
    lb = cfg.lb
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=lb.tdtype,  # noqa
                                  device=lb.device).contiguous()
    return (f, t(psi0), t(rho0),
            torch.zeros((3,) + tuple(lb.size), dtype=lb.tdtype,
                        device=lb.device),
            torch.zeros(3, dtype=lb.tdtype, device=lb.device))


# -- the full step ------------------------------------------------------------

def make_electro_step(cfg: ElectroSimConfig,
                      solid: Optional[torch.Tensor] = None,
                      return_rho_lb: bool = True):
    """step((f, psi, rho, u, gwall), t=0) ->
    ((f, psi, rho, u, gwall), (rho_lb, (n, rnorm, which))).

    gwall accumulates the momentum transferred to boundary sites by the
    bounce-back (the [walls] row of the statistics); (n, rnorm, which) is
    the SOR report (zeros on the FFT route).  rho_lb is the collision-time
    density, or None with return_rho_lb=False, which saves the float32
    route a pass over f that the statistics (taken from f) do not need.
    The step returns new tensors and never writes its inputs."""
    lb = cfg.lb
    params = lb.collision_params()
    model = lb.model
    size = tuple(lb.size)
    dtype, device = lb.tdtype, lb.device
    psi_up, psi_dn = make_psi_neighbours(size, cfg.e0, dtype, device)
    fluid = None if solid is None else torch.logical_not(solid)
    fl = (torch.ones(size, dtype=torch.bool, device=device) if fluid is None
          else fluid)
    n_sites = float(np.prod(size))   # all non-colloid sites
    m = cfg.ek.multisteps
    dt = 1.0 / m
    f32 = lb.dtype == "float32"
    # the kernel route: float32 only, on the conditions the kernels'
    # semantics need (ops/fused_electro.py); float64 is the golden tier
    on_kernels = f32 and kernel_supported(cfg.e0)
    use_fsor = on_kernels and cfg.ek.solver != "fft"
    use_fnp = on_kernels and cfg.stencil not in (19, 27)
    # the force kernel takes the three-dimensional sets (the JAX route
    # collides a Z = 1 lattice unfused: its fused gate needs Z % 128 == 0)
    use_flb = f32 and cfg.hydrodynamics and model.ndim == 3

    def step(state, t=0):
        del t
        f, psi, rho, u, gwall = state
        u_np = u if cfg.hydrodynamics else None

        # 1. Poisson solve
        if cfg.ek.solver == "fft":
            psi = poisson_fft(rho_elec(rho, cfg.ek) / cfg.ek.e, cfg.ek)
            sor = (torch.zeros((), dtype=torch.int32, device=device),
                   torch.zeros((), dtype=dtype, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))
        elif use_fsor:
            psi, *sor = sor_solve_fused(psi, rho_elec(rho, cfg.ek), cfg.ek,
                                        zero_mean=True)
        else:
            psi, *sor = poisson_sor_ref(psi, rho_elec(rho, cfg.ek), cfg.ek,
                                        psi_up, psi_dn, return_iters=True)

        # 2. grad-mu force (once per LB step), 3. NP sub-cycles
        if use_fnp:
            rho, force, fsum = np_gradmu_fused(psi, rho, u_np, fl, cfg, dt)
            force = force - (fsum / n_sites)[:, None, None, None]
            for _ in range(m - 1):
                rho = np_gradmu_fused(psi, rho, u_np, fl, cfg, dt)[0]
        else:
            force = gradmu_force(psi, rho, cfg, psi_up, psi_dn, n_sites)
            for _ in range(m):
                if cfg.stencil in (19, 27):
                    rho = np_step_d3qx(rho, psi, u_np, fl, cfg, psi_up,
                                       psi_dn, dt, npoints=cfg.stencil)
                else:
                    rho = np_step(rho, psi, u_np, fl, cfg, psi_up, psi_dn,
                                  dt)

        # 4. zero-mean potential; the SOR kernel folds it into the solve
        if cfg.ek.solver == "fft" or not use_fsor:
            psi = psi - site_sum(psi) / n_sites

        # 5. LB update
        if use_flb:
            # collision-time density (the reference routes get it free)
            rho_lb = torch.sum(f, dim=0) if return_rho_lb else None
            if solid is not None:
                f, u, gw = fused_force_step(f, force, model, params,
                                            solid=solid)
                gwall = gwall + gw
            else:
                f, u = fused_force_step(f, force, model, params)
        elif cfg.hydrodynamics:
            f, rho_lb, u = collide(f, params, force=force, fluid_mask=fluid)
            if solid is not None:
                gwall = gwall + wall_momentum_transfer(f, model, solid)
            f = stream_bounce_back(f, model, solid=solid, rho0=lb.rho0)
        else:
            rho_lb = torch.ones(size, dtype=dtype, device=device)
        if not return_rho_lb:
            rho_lb = None

        return (f, psi, rho, u, gwall), (rho_lb, tuple(sor))

    return step
