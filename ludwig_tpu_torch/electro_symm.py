"""Coupled binary-fluid + electrokinetics (fe_electro_symmetric) step.

PyTorch port of ludwig_tpu/electro_symm.py (ref: src/ludwig.c:609-677
electrokinetic section followed by the phi_cahn_hilliard order-parameter
update, with the coupled free energy of src/fe_electro_symmetric.c).
Per LB step:

  1. phi gradients (fd_gradient_calculation stencil)
  2. Poisson solve for the reduced potential: the uniform SOR
     (electro_sim.poisson_sor_ref) when the dielectric contrast
     vanishes, else the heterogeneous (variable-epsilon) SOR below (ref:
     src/psi_sor.c:346 psi_solver_sor_var_epsilon_solve)
  3. body force = -div(coupled stress) on the d3q7 stencil (ref:
     src/psi_force.c psi_force_divstress), or the mean-corrected
     phi grad mu force of phi_gradmu_correction
  4. Nernst-Planck charge transport with the solvation chemical
     potential in the linkwise factors (ref: src/nernst_planck.c:405)
  5. psi_zero_mean
  6. Cahn-Hilliard update of phi with mu = mu_mix + mu_solv + mu_el
     (ref: src/fe_electro_symmetric.c fe_es_mu_phi)
  7. LB collide (+force) and propagate.

As in the JAX package, this family runs its reference route in every
dtype (not the float32 kernels of fe_electro), eagerly on the state's
device.  The SOR solvers read their convergence test back to the host
every 5 iterations; a step makes no other host synchronisation.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ludwig_tpu_torch.binary import fe_fields
from ludwig_tpu_torch.dynamics.cahn_hilliard import (CahnHilliardParams,
                                                     cahn_hilliard_update)
from ludwig_tpu_torch.electro import ElectroConfig, rho_elec
from ludwig_tpu_torch.electro_sim import (ElectroSimConfig,
                                          make_psi_neighbours, np_step,
                                          poisson_sor_ref, site_sum)
from ludwig_tpu_torch.fe.electro_symmetric import ElectroSymmetricFE
from ludwig_tpu_torch.lb import LBConfig
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.fused_electro import red_mask
from ludwig_tpu_torch.ops.stream import stream

FORCE_METHODS = ("stress_divergence", "phi_gradmu_correction")


@dataclasses.dataclass(frozen=True)
class ElectroSymmConfig:
    lb: LBConfig
    ek: ElectroConfig
    fe: ElectroSymmetricFE
    mobility: float = 0.05
    advection_order: int = 1
    gradient: str = "3d_7pt_fluid"
    e0: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    hydrodynamics: bool = True
    force_method: str = "stress_divergence"   # or phi_gradmu_correction

    def __post_init__(self):
        if self.force_method not in FORCE_METHODS:
            raise NotImplementedError(
                f"fe_force_method '{self.force_method}' of "
                f"fe_electro_symmetric is not ported (have {FORCE_METHODS})"
                ", see ROADMAP")


def poisson_sor_var_eps_ref(psi0, rho_el, eps, cfg: ElectroConfig,
                            psi_up, psi_dn, eps_up, eps_dn,
                            return_iters: bool = False):
    """Heterogeneous-permittivity SOR, matching the reference iteration
    (ref: src/psi_sor.c:346-520 psi_solver_sor_var_epsilon_solve):

      depsi = eps(i) lap7(psi)
            + sum_ax 0.25 [eps(i+ax) - eps(i-ax)] [psi(i+ax) - psi(i-ax)]
      residual = depsi + e beta rho_el
      psi     += omega residual / (6 eps(i))

    omega starts at 1.0 and is updated once per full red/black iteration
    via omega = 1/(1 - r^2 omega / 4) (a float64 recurrence on the host);
    r = 1 - (pi/max(Lx,Lz))^2 / 2; rnorm0 is the L2 norm of the right
    hand side.  The reference tests convergence after every iteration
    (ncheck = 1); here the test is made on the device every iteration
    and freezes psi at the first iteration that passes, and the host
    reads it back every 5 iterations to leave the loop, so the result
    and the iteration count are the reference's.

    With `return_iters` also returns the printed (0-based) iteration
    index, the final residual norm and which criterion held (0 absolute,
    1 relative), as tensors."""
    if cfg.max_its < 1:
        raise ValueError(f"max_its must be >= 1, got {cfg.max_its}")
    shape = psi0.shape
    dev = psi0.device
    rhs = (cfg.e * cfg.beta) * rho_el
    # pass 0 touches 1-based-odd (ic+jc+kc) sites = 0-based-even
    red = red_mask(shape, dev)
    black = torch.logical_not(red)
    zero = torch.zeros((), dtype=psi0.dtype, device=dev)
    radius = 1.0 - 0.5 * (np.pi / max(shape[0], shape[2])) ** 2
    rnorm0 = torch.sqrt(torch.sum(rhs * rhs))

    def depsi(p):
        acc = 0.0
        lap = -6.0 * p
        for ax in range(3):
            pu, pd = psi_up(p, ax), psi_dn(p, ax)
            lap = lap + pu + pd
            acc = acc + 0.25 * (eps_up[ax] - eps_dn[ax]) * (pu - pd)
        return eps * lap + acc

    def half_sweep(p, mask, omega):
        res = depsi(p) + rhs
        p = torch.where(mask, p + omega * res / (6.0 * eps), p)
        return p, torch.sum(torch.where(mask, res * res, zero))

    p, omega = psi0, 1.0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    nrun = torch.zeros((), dtype=torch.int64, device=dev)
    rn = torch.full((), float("inf"), dtype=psi0.dtype, device=dev)
    for n in range(cfg.max_its):
        p1, s0 = half_sweep(p, red, omega)
        p1, s1 = half_sweep(p1, black, omega)
        omega = 1.0 / (1.0 - 0.25 * radius * radius * omega)
        rnorm1 = torch.sqrt(s0 + s1)
        p = torch.where(done, p, p1)
        rn = torch.where(done, rn, rnorm1)
        nrun = nrun + torch.logical_not(done).to(torch.int64)
        done = done | (rnorm1 < cfg.abs_tol) | (rnorm1 < cfg.rel_tol * rnorm0)
        if n % 5 == 4 and bool(done):
            break
    if not return_iters:
        return p
    which = torch.where(rn < cfg.abs_tol, 0, 1).to(torch.int32)
    return p, (nrun - 1).to(torch.int32), rn, which


def divstress_7pt(pth):
    """force = -div(pth) on the d3q7 stencil (central differences; ref:
    src/psi_force.c psi_force_divstress with stencil_d3q7 wgradients
    = 1/2)."""
    comps = []
    for a in range(3):
        acc = 0.0
        for ax in range(3):
            pax = pth[a, ax]
            acc = acc + 0.5 * (torch.roll(pax, -1, ax)
                               - torch.roll(pax, 1, ax))
        comps.append(-acc)
    return torch.stack(comps)


def es_efield(psi, cfg: ElectroSymmConfig, psi_up, psi_dn):
    """Physical total electric field E_a = -(kT/e) grad_a psi with the
    external-field potential jump folded into the wrap planes (ref:
    src/psi_gradients.c psi_electric_field + psi_halo_psijump)."""
    scale = (1.0 / cfg.ek.beta) / cfg.ek.e
    return torch.stack([-0.5 * (psi_up(psi, ax) - psi_dn(psi, ax)) * scale
                        for ax in range(3)])


def make_electro_symm_step(cfg: ElectroSymmConfig):
    """Step: ((f, phi, psi, rho_k, u), t=0) -> (state', (rho_lb, sor)),
    sor = (iteration index, residual norm, criterion) of the solve."""
    lb = cfg.lb
    params = lb.collision_params()
    model = lb.model
    size = tuple(lb.size)
    fe, ek = cfg.fe, cfg.ek
    psi_up, psi_dn = make_psi_neighbours(size, cfg.e0, lb.tdtype, lb.device)
    ch = CahnHilliardParams(mobility=cfg.mobility,
                            advection_order=cfg.advection_order)
    ek_sim = ElectroSimConfig(lb=lb, ek=ek, e0=cfg.e0,
                              hydrodynamics=cfg.hydrodynamics)
    contrast = fe.gamma != 0.0
    dt = 1.0 / ek.multisteps
    fl = torch.ones(size, dtype=torch.bool, device=lb.device)
    n_sites = float(np.prod(size))

    def step(state, t=0):
        f, phi, psi, rhok, u = state
        u_h = u if cfg.hydrodynamics else None
        fields = fe_fields(phi, cfg.gradient)

        # 1. Poisson solve (uniform when the contrast vanishes)
        rel = rho_elec(rhok, ek)
        if contrast:
            eps = fe.var_epsilon(phi)
            eps_up = [torch.roll(eps, -1, ax) for ax in range(3)]
            eps_dn = [torch.roll(eps, 1, ax) for ax in range(3)]
            psi, *sor = poisson_sor_var_eps_ref(
                psi, rel, eps, ek, psi_up, psi_dn, eps_up, eps_dn,
                return_iters=True)
        else:
            psi, *sor = poisson_sor_ref(psi, rel, ek, psi_up, psi_dn,
                                        return_iters=True)

        # 2. force, with rho at multistep 0
        e = es_efield(psi, cfg, psi_up, psi_dn)
        e2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
        if cfg.force_method == "phi_gradmu_correction":
            # F_a = -phi d_a mu_phi - sum_k rho_k d_a mu_solv_k
            #       + rho_el E_a, mean-corrected over all fluid sites
            # (ref: psi_force.c psi_force_gradmu_es)
            mu = fe.mu_phi_coupled(fields, rhok, e2)
            ms = fe.mu_solv(phi)
            comps = []
            for a in range(3):
                fa = -phi * 0.5 * (torch.roll(mu, -1, a)
                                   - torch.roll(mu, 1, a))
                for k in range(ek.nk):
                    fa = fa - rhok[k] * 0.5 * (torch.roll(ms[k], -1, a)
                                               - torch.roll(ms[k], 1, a))
                comps.append(fa + rel * e[a])
            force = torch.stack(comps)
            fmean = torch.mean(force, dim=(1, 2, 3))
            force = (force - fmean[:, None, None, None]).to(f.dtype)
        else:
            force = divstress_7pt(fe.stress_coupled(fields, rhok, e, e2)) \
                .to(f.dtype)

        # 3. Nernst-Planck sub-cycles with the solvation potential
        mu_ex = fe.mu_solv(phi)
        for _ in range(ek.multisteps):
            rhok = np_step(rhok, psi, u_h, fl, ek_sim, psi_up, psi_dn, dt,
                           mu_ex=mu_ex)

        # 4. zero-mean potential (site-order sum in float64)
        psi = psi - site_sum(psi) / n_sites

        # 5. Cahn-Hilliard with the coupled chemical potential
        phi = cahn_hilliard_update(phi, fe.mu_phi_coupled(fields, rhok, e2),
                                   u_h, ch)

        # 6. LB update
        if cfg.hydrodynamics:
            f, rho_lb, u = collide(f, params, force=force)
            f = stream(f, model)
        else:
            rho_lb = torch.ones(size, dtype=lb.tdtype, device=lb.device)
        return (f, phi, psi, rhok, u), (rho_lb, tuple(sor))

    return step


def initial_electro_symm(cfg: ElectroSymmConfig, f, phi0, psi0, rho0):
    """(f, phi, psi, rho_k, u = 0) on the configuration's device: f as
    given, phi, psi and rho_k from host arrays."""
    lb = cfg.lb

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=lb.tdtype,
                               device=lb.device).contiguous()

    return (f, t(phi0), t(psi0), t(rho0),
            torch.zeros((3,) + tuple(lb.size), dtype=lb.tdtype,
                        device=lb.device))
