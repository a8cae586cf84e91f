"""Binary-fluid simulation: symmetric free energy + Cahn-Hilliard + LB.

PyTorch port of ludwig_tpu/binary.py (ref: src/ludwig.c:551-860 time
step: gradients -> force -> order-parameter dynamics -> collide ->
stream).  The state is the tuple (f, phi, u[, gwall][, nstate_phi][,
nstate_rho]), the JAX package's order; a step runs eagerly on the
state's device.  make_binary_step is the unfused step (the CLI's route
for periodic runs under `tpu_fused off`, and for every run with halo
walls, porous media, noise, another stencil, advection order 3-5, the
phi-grad-mu force, an external chemical-potential gradient, a viscosity
model or `hydrodynamics off`), and the reference the fused step of
ops/fused_binary.py is tested against; make_binary_open_step the open
x boundary beside halo walls.

The velocity used by the CH advection is the force-shifted velocity from
the previous collision, exactly as the reference stores hydro->u during
collide and uses it in the following step's advection.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ludwig_tpu_torch import noise as noise_mod
from ludwig_tpu_torch import noise_kiss
from ludwig_tpu_torch.dynamics.cahn_hilliard import (CahnHilliardParams,
                                                     cahn_hilliard_update)
from ludwig_tpu_torch.fe.brazovskii import BrazovskiiFE
from ludwig_tpu_torch.lb import LBConfig, _noise_terms, initial_rest
from ludwig_tpu_torch.ops.advect import (_up, advective_fluxes,
                                         blocked_faces, flux_divergence)
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.force import (phi_grad_mu_force,
                                        stress_divergence_force)
from ludwig_tpu_torch.ops.open_bc import apply_open_bc
from ludwig_tpu_torch.ops.stencil import GRADIENTS, gradient_ops
from ludwig_tpu_torch.ops.stream import stream, stream_bounce_back
from ludwig_tpu_torch.ops.walls import (no_flux_at_walls,
                                        stress_divergence_force_walls,
                                        wall_bounce_back)
from ludwig_tpu_torch.stats import momentum_total


GRADIENT = "3d_7pt_fluid"      # the default 3-D stencil (and the fused one)
ORDERS = (1, 2, 3, 4, 5)       # the advection orders
FORCE_METHODS = ("stress_divergence", "phi_gradmu")
SOLID_GRADIENTS = ("3d_7pt_solid", "3d_27pt_solid")


@dataclasses.dataclass(frozen=True)
class BinaryConfig:
    """Static configuration for a symmetric (or Brazovskii) binary-fluid
    run (the JAX package's fields).  fe: fe.symmetric.SymmetricFE or
    fe.brazovskii.BrazovskiiFE, whose fields add the fourth-order
    gradients (fourth_order).  wetting: (C, H) for the solid stencils, floats
    or (X, Y, Z) tensors of per-site map data; visc_model e.g.
    visc.ViscArrhenius; gradmu_ex the external chemical-potential
    gradient (ref: physics grad_mu key): F = -phi grad_mu on the fluid,
    -M grad_mu on the CH flux."""

    lb: LBConfig
    fe: object
    mobility: float = 1.0
    advection_order: int = 1
    gradient: str = GRADIENT
    hydrodynamics: bool = True
    visc_model: object = None
    wetting: Tuple = (0.0, 0.0)
    force_method: str = "stress_divergence"
    gradmu_ex: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def __post_init__(self):
        if self.advection_order not in ORDERS:
            raise ValueError(f"advection order {self.advection_order} not "
                             f"implemented (have {ORDERS})")
        if self.gradient not in GRADIENTS + SOLID_GRADIENTS:
            raise ValueError(f"unknown gradient stencil '{self.gradient}'")
        if self.force_method not in FORCE_METHODS:
            raise NotImplementedError(
                f"fe_force_method '{self.force_method}' of the binary fluid "
                f"is not ported (have {FORCE_METHODS}), see ROADMAP")

    @property
    def fourth_order(self) -> bool:
        return isinstance(self.fe, BrazovskiiFE)


def fe_fields(phi, gradient: str = GRADIENT, fourth_order: bool = False,
              solid_ops=None):
    """Order parameter + gradients dict shared by mu/stress/stats.

    fourth_order adds grad(del^2 phi) and del^4 phi, a second pass of the
    same stencils over delsq (Brazovskii; the reference's ngrad = 4 path,
    ref: field_grad.h:24-34).  solid_ops overrides the stencils with
    wetting-aware ones (binary_solid_ops; one pass for both where it has
    ``both``)."""
    if solid_ops is not None and hasattr(solid_ops, "both"):
        both = solid_ops.both
    else:
        # the symmetric / Brazovskii phi is created WITH the LE object
        # (ludwig.c:1185,1268) -> the LE-parameterised tomita delsq
        grad, delsq = solid_ops if solid_ops is not None \
            else gradient_ops(gradient, le_field=True)

        def both(x):
            return grad(x), delsq(x)
    g, d2 = both(phi)
    out = {"phi": phi, "grad_phi": g, "delsq_phi": d2}
    if fourth_order:
        out["grad_delsq_phi"], out["delsq_delsq_phi"] = both(d2)
    return out


def binary_solid_ops(cfg: BinaryConfig, solid=None, wallspec=None):
    """Wetting-aware (grad, delsq) stencil pair for a *_solid gradient
    selection, or None for fluid stencils (shared by the step and the
    statistics).  The masks are made here, once, on the device of the
    solid mask (the configuration's device for walls alone)."""
    fluid = None if solid is None else torch.logical_not(solid)
    if cfg.gradient == "3d_27pt_solid" and (solid is not None
                                            or wallspec is not None):
        from ludwig_tpu_torch.ops.solid_stencil import solid27_scalar_ops
        return solid27_scalar_ops(
            cfg.lb.size, fluid=fluid,
            walls=wallspec.walls if wallspec is not None else (False,) * 3,
            rkappa=1.0 / cfg.fe.kappa, c=cfg.wetting[0], h=cfg.wetting[1],
            device=cfg.lb.device)
    if solid is not None and cfg.gradient.endswith("_solid"):
        from ludwig_tpu_torch.ops.stencil import solid_gradient_ops
        return solid_gradient_ops(solid, cfg.fe.kappa, cfg.wetting[0],
                                  cfg.wetting[1])
    return None


def _kiss(cfg: BinaryConfig):
    """(kiss_phi, kiss_rho): which KISS streams ride the state."""
    nz = cfg.lb.noise
    if nz is None or not nz.kiss:
        return False, False
    return bool(nz.phi), bool(nz.rho)


def make_binary_step(cfg: BinaryConfig, solid=None, wallspec=None,
                     solid_ops=None):
    """Step: ((f, phi, u[, gwall][, nstate_phi][, nstate_rho]), t=0) ->
    (state', rho).

    Order per reference time step (ludwig.c:551-860): gradients of phi,
    the thermodynamic force, the CH update of phi (advected by the
    previous step's u), then collide with the force and stream with
    bounce-back at solid sites.

    With wallspec (halo plane walls, ref: wall.c) all stored sites stay
    fluid, the stress-divergence force takes one-sided wall fluxes, CH
    fluxes vanish at the walls and streaming is followed by half-way
    bounce-back at the wall planes; gwall (state[3]) accumulates the
    walls' momentum for the [walls] statistics row.  The reference keeps
    two independent per-site KISS generators (ref: ludwig.c:243,1215):
    noise_phi for the CH flux noise, on a one-site-extended ring, and
    noise_rho for the LB fluctuations; they ride at the end of the state.
    solid_ops: binary_solid_ops(cfg, solid, wallspec) made beforehand, to
    share its masks with the statistics (made here when not given).
    """
    params = cfg.lb.collision_params()
    model = cfg.lb.model
    ch = CahnHilliardParams(mobility=cfg.mobility,
                            advection_order=cfg.advection_order)
    fluid = None if solid is None else torch.logical_not(solid)
    blocked = None if solid is None else blocked_faces(solid)
    wall_u = (cfg.lb.wall_u if any(v != 0.0 for v in cfg.lb.wall_u)
              else None)
    nz = cfg.lb.noise
    if solid_ops is None:
        solid_ops = binary_solid_ops(cfg, solid=solid, wallspec=wallspec)
    kiss_phi, kiss_rho = _kiss(cfg)
    gradmu = any(g != 0.0 for g in cfg.gradmu_ex)
    lbcfg = cfg.lb

    def step(state, t=0):
        f, phi, u = state[0], state[1], state[2]
        fields = fe_fields(phi, cfg.gradient, cfg.fourth_order,
                           solid_ops=solid_ops)
        mu = cfg.fe.mu(fields)

        nstate_rho = state[-1] if kiss_rho else None
        nstate_phi = state[-2 if kiss_rho else -1] if kiss_phi else None
        rflux = None
        if kiss_phi:
            nstate_phi, r3 = noise_kiss.reap(nstate_phi, 3, lbcfg.tdtype)
            rflux = noise_mod.ch_flux_from_deviates(r3, nz.kt, cfg.mobility)
        elif nz is not None and nz.phi:
            rflux = noise_mod.ch_random_flux(
                nz.seed, t, lbcfg.size, nz.kt, cfg.mobility,
                dtype=lbcfg.tdtype, device=lbcfg.device)

        def lb_noise():
            if not kiss_rho:
                return _noise_terms(lbcfg, params, t) + (nstate_rho,)
            return _noise_terms(lbcfg, params, t, nstate=nstate_rho)

        def pack(*core):
            out = core
            if kiss_phi:
                out = out + (nstate_phi,)
            if kiss_rho:
                out = out + (nstate_rho,)
            return out

        if cfg.hydrodynamics:
            if wallspec is not None:
                gwall = state[3]
                force, fwall = stress_divergence_force_walls(
                    cfg.fe.stress(fields), wallspec)
                force = force.to(f.dtype)
                phi = cahn_hilliard_update(phi, mu, u, ch,
                                           random_flux=rflux,
                                           wallspec=wallspec)
                shat, ghat, nstate_rho = lb_noise()
                eta_loc = (cfg.visc_model.eta(phi)
                           if cfg.visc_model is not None else None)
                f_post, rho, u_new = collide(f, params, force=force,
                                             shat=shat, ghat=ghat,
                                             eta_local=eta_loc)
                f = stream(f_post, model)
                f, _, gw = wall_bounce_back(f, f_post, model, wallspec,
                                            rho0=lbcfg.rho0)
                gwall = gwall + gw.to(gwall.dtype) + fwall.to(gwall.dtype)
                return pack(f, phi, u_new, gwall), rho
            if cfg.force_method == "phi_gradmu":
                force = phi_grad_mu_force((phi,), (mu,), solid=solid)
            else:
                force = stress_divergence_force(cfg.fe.stress(fields))
            if gradmu:
                # F = -phi grad_mu (ref: phi_grad_mu_external_kernel)
                gm = [float(g) for g in cfg.gradmu_ex]
                force = force - torch.stack([phi * g for g in gm])
            force = force.to(f.dtype)
            phi = cahn_hilliard_update(phi, mu, u, ch, solid=blocked,
                                       random_flux=rflux,
                                       noise_stencil=rflux is not None,
                                       gradmu_ex=cfg.gradmu_ex)
            shat, ghat, nstate_rho = lb_noise()
            eta_loc = (cfg.visc_model.eta(phi)
                       if cfg.visc_model is not None else None)
            f, rho, u_new = collide(f, params, force=force,
                                    fluid_mask=fluid, shat=shat, ghat=ghat,
                                    eta_local=eta_loc)
            f = stream_bounce_back(f, model, solid=solid, wall_u=wall_u,
                                   rho0=lbcfg.rho0)
        else:
            phi = cahn_hilliard_update(phi, mu, None, ch, solid=blocked,
                                       random_flux=rflux,
                                       noise_stencil=rflux is not None)
            rho = torch.ones_like(phi)
            u_new = torch.zeros_like(u)
        return pack(f, phi, u_new), rho

    return step


def open_x_ext(phi, wallspec, phib, nh=2):
    """Extended phi with the reference's open-x halo semantics.

    The serial host halo swap is always periodic (halo_swap.c:475 tests
    mpicartsz == 1, not the periodicity flags), so every halo, the wall
    directions included, first receives the periodic wrap.  The phi BCs
    then overwrite the x halos: the inflow (low-x) region uniformly phib
    incl. transverse halos (ref: phi_bc_inflow_fixed.c:108-120), the
    outflow (high-x) region copies the last domain plane (ref:
    phi_bc_outflow_free.c:110-121)."""
    p = torch.cat([phi[-nh:], phi, phi[:nh]], dim=0)
    for ax in (1, 2):
        if wallspec is not None and wallspec.walls[ax]:
            n = p.shape[ax]
            p = torch.cat([p.narrow(ax, n - 1, 1), p, p.narrow(ax, 0, 1)],
                          dim=ax)
    p[:nh] = phib
    p[-nh:] = p[-nh - 1]
    return p


def _transverse(x, wallspec):
    """x with the transverse halos of open_x_ext dropped, keeping its x
    extent (callers slice x themselves)."""
    ty = 1 if (wallspec is not None and wallspec.walls[1]) else 0
    tz = 1 if (wallspec is not None and wallspec.walls[2]) else 0
    return x[..., slice(ty, -ty or None), slice(tz, -tz or None)]


class OpenXScalarOps:
    """(grad, delsq) stencils honouring the open-x / wall halo values
    (interior sites only; the statistics' fed integral)."""

    def __init__(self, cfg: BinaryConfig, wallspec, phib: float):
        self.g_op, self.d_op = gradient_ops(cfg.gradient, le_field=True)
        self.wallspec, self.phib = wallspec, phib

    def _slice(self, x):
        return _transverse(x[..., 2:-2, :, :], self.wallspec)

    def grad(self, phi):
        return self._slice(self.g_op(open_x_ext(phi, self.wallspec,
                                                self.phib)))

    def delsq(self, phi):
        return self._slice(self.d_op(open_x_ext(phi, self.wallspec,
                                                self.phib)))

    def __iter__(self):
        return iter((self.grad, self.delsq))


def open_x_scalar_ops(cfg: BinaryConfig, wallspec, phib):
    return OpenXScalarOps(cfg, wallspec, phib)


def make_binary_open_step(cfg: BinaryConfig, wallspec, obc, phib: float):
    """Binary fluid with an open (inflow/outflow) x boundary and halo
    plane walls in the transverse directions (ref: serial-open-phi:
    lb_bc_inflow/outflow_rhou + phi_bc_inflow_fixed/outflow_free).

    State (f, phi, u, gwall) -> (state', rho).  Per step: BC-aware phi
    gradients / mu / stress on an extended-x array, stress-divergence
    force (one-sided at walls, halo-stress faces at the open ends), CH
    update with open-x face fluxes (halo u = 0), collide, stream, wall
    bounce-back, then the rhou open BC on the distributions."""
    params = cfg.lb.collision_params()
    model = cfg.lb.model
    m = cfg.mobility
    g_op, d_op = gradient_ops(cfg.gradient, le_field=True)

    def tsl(x):
        # drop transverse halos, keep ONE x halo plane each side
        return _transverse(x[..., 1:-1, :, :], wallspec)

    def step(state, t=0):
        f, phi, u, gwall = state
        pext = open_x_ext(phi, wallspec, phib)
        fields1 = {"phi": tsl(pext), "grad_phi": tsl(g_op(pext)),
                   "delsq_phi": tsl(d_op(pext))}
        mu1 = cfg.fe.mu(fields1)          # (X+2, Y, Z) incl. x halos
        pth1 = cfg.fe.stress(fields1)     # (3, 3, X+2, Y, Z)

        # force = -div(pth): halo faces in x, one-sided at wall planes
        shape = phi.shape
        comps, fwall = [], []
        for a in range(3):
            pax = pth1[a, 0]
            face_e = 0.5 * (pax[1:-1] + pax[2:])      # east faces
            face_w0 = 0.5 * (pax[0] + pax[1])         # west face, site 0
            acc = face_e - torch.cat([face_w0[None], face_e[:-1]], dim=0)
            fw = [0.0, 0.0, 0.0]
            for ax in (1, 2):
                pax = pth1[a, ax][1:-1]
                face = 0.5 * (pax + torch.roll(pax, -1, ax))
                if wallspec.walls[ax]:
                    hi = [slice(None)] * 3
                    hi[ax] = shape[ax] - 1
                    lo = [slice(None)] * 3
                    lo[ax] = 0
                    hi, lo = tuple(hi), tuple(lo)
                    face[hi] = pax[hi]
                    d = face - torch.roll(face, 1, ax)
                    d[lo] = face[lo] - pax[lo]
                    # the wall takes the NEGATIVE of the fluid's net
                    # wall-face force (ref: pth_force_wall_kernel)
                    fw[ax] = torch.sum(pax[hi]) - torch.sum(pax[lo])
                else:
                    d = face - torch.roll(face, 1, ax)
                acc = acc + d
            comps.append(-acc)
            fwall.append(sum(fw[ax] for ax in (1, 2)))
        force = torch.stack(comps).to(f.dtype)
        fwall = torch.stack([v.to(f.dtype) if torch.is_tensor(v)
                             else torch.full((), float(v), dtype=f.dtype,
                                             device=f.device)
                             for v in fwall])

        # Cahn-Hilliard with open-x faces (halo u = 0)
        mu = mu1[1:-1]
        fluxes = advective_fluxes(u, phi, cfg.advection_order)
        fluxes = [fluxes[ax] - m * (_up(mu, ax) - mu) for ax in range(3)]
        # phi_cahn_hilliard swaps the u halos periodically first (ref:
        # phi_cahn_hilliard.c:225, halo_swap.c:846), so both end faces
        # share u_face = 0.5 (u(1) + u(N)); only the upwind phi differs
        # (phib at the west face, the copied edge plane at the east)
        uf = 0.5 * (u[0, 0] + u[0, -1])
        fx = fluxes[0].clone()
        fx[-1] = uf * phi[-1] - m * (mu1[-1] - mu[-1])
        fluxes[0] = fx
        fw0 = (uf * torch.where(uf > 0.0, torch.full_like(phi[0], phib),
                                phi[0]) - m * (mu[0] - mu1[0]))
        fluxes = no_flux_at_walls(fluxes, wallspec)
        div = flux_divergence(fluxes)
        div[0] = div[0] + (fluxes[0][-1] - fw0)
        phi = phi - div

        f_post, rho, u_new = collide(f, params, force=force)
        f_new = stream(f_post, model)
        g_pre = momentum_total(f_new, model)
        f_new, _, _ = wall_bounce_back(f_new, f_post, model, wallspec,
                                       rho0=cfg.lb.rho0)
        gwall = (gwall + (g_pre - momentum_total(f_new, model))
                 .to(gwall.dtype) + fwall)
        # the impose uses the collision-time hydro (rho = pre-collide
        # sum, u incl. the half-force correction; ref: lb_collide stores
        # hydro rho/u, the impose reads them)
        f_new = apply_open_bc(f_new, f_post, model, obc, axis=0,
                              edge_hydro=(rho[0], u_new[:, -1]))
        return (f_new, phi, u_new, gwall), rho

    return step


def initial_binary(cfg: BinaryConfig, phi0, walls: bool = False):
    """(f at rest, phi0, u = 0[, gwall][, nstate_phi][, nstate_rho]) on
    the configuration's device.  gwall (zeros) rides with halo walls;
    the KISS noise states ride at the end when fluctuations are on, both
    default-seeded like the reference's two noise objects
    (noise_init(obj, 0); ref: ludwig.c:243,1215), the phi stream on the
    one-site-extended ring."""
    lb = cfg.lb
    f = initial_rest(lb)
    phi = torch.as_tensor(phi0, dtype=lb.tdtype, device=lb.device)
    u = torch.zeros((3,) + tuple(lb.size), dtype=lb.tdtype, device=lb.device)
    state = (f, phi.contiguous(), u)
    if walls:
        state = state + (torch.zeros((3,), dtype=lb.tdtype,
                                     device=lb.device),)
    kiss_phi, kiss_rho = _kiss(cfg)
    if kiss_phi:
        state = state + (noise_kiss.kiss_init(0, lb.size, extended=True,
                                              device=lb.device),)
    if kiss_rho:
        state = state + (noise_kiss.kiss_init(0, lb.size,
                                              device=lb.device),)
    return state
