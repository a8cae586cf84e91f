"""Sheared binary fluid: symmetric free energy + Cahn-Hilliard under
Lees-Edwards planes.

PyTorch port of the symmetric branch of ludwig_tpu/binary_le.py (ref:
src/field.c:490-596 4-point Lagrange buffer columns,
src/gradient_3d_7pt_fluid.c grad_3d_7pt_fluid_le, src/advection.c LE
kernels, src/phi_cahn_hilliard.c phi_ch_flux_mu1 and
phi_ch_le_fix_fluxes (plane-face flux averaging), src/phi_force.c
phi_force_flux + phi_force_flux_fix_local, src/model_le.c reproject +
displace for the distributions).

Two forms, both written over all planes at once (ops/le_ref.py):

  make_binary_le_step        the whole sheared step in torch (the CLI's
                             `tpu_fused off` route and the reference the
                             fused step is held to);
  make_binary_le_column_fix  the O(planes Y Z) column work that turns the
                             plain-periodic outputs of the fused kernels
                             (ops/fused_binary.py) into the sheared ones.

The 7- and 27-point gradients and advection orders 1-5 run on the
unfused step, with the LB's KISS fluctuations where they are on (the
state then carries the per-site KISS state after u), and so does the
Brazovskii free energy, whose chemical potential and stress read the
fourth-order LE fields (le_ref.le_fields_2d5pt_d4, or _27pt_d4 for the
27-point stencil, as the JAX step chooses).
"""

from __future__ import annotations

import dataclasses

import torch

from ludwig_tpu_torch.binary import BinaryConfig
from ludwig_tpu_torch.lb import _noise_terms, kiss_on
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.le_ref import (ADV_STENCIL, LEContext, col_grad7,
                                         face_slab, le_buffer_fields,
                                         le_face_u, le_fields_27pt_d4,
                                         le_fields_2d5pt_d4, le_force_cols,
                                         le_gradient, le_stress_force,
                                         replace_col, sample_linear,
                                         slab_neighbours, upwind_face)
from ludwig_tpu_torch.ops.lees_edwards import (LeesEdwardsConfig,
                                               apply_lb_le)
from ludwig_tpu_torch.ops.stream import stream

@dataclasses.dataclass(frozen=True)
class BinaryLEConfig:
    binary: BinaryConfig
    le: LeesEdwardsConfig


def _check(cfg: BinaryLEConfig):
    if cfg.binary.fourth_order:
        raise ValueError("the fused LE column fix takes the symmetric free "
                         "energy only (the sheared Brazovskii fluid runs "
                         "make_binary_le_step)")


def le_cahn_hilliard(phi, mu, u, ctx: LEContext, mobility: float,
                     order: int, mu_b1, mu_d0):
    """phi' of the Cahn-Hilliard update with LE advection and the
    plane-face flux averaging (ref: phi_ch_flux_mu1 +
    phi_ch_le_fix_fluxes); mu_b1, mu_d0 (P, Y, Z) the chemical potential
    at the buffer columns above and below each plane.  Shared by the
    binary and droplet steps."""
    sten = ADV_STENCIL[order]
    M = mobility

    def xs(x, d):
        return torch.roll(x, -d, 0)

    def col_stack(d, lo):
        return {k: ctx.col_field(phi, d + k, lo) for k in sten}

    ufx = 0.5 * (u[0] + xs(u[0], 1))
    fe_x = (upwind_face({d: xs(phi, d) for d in sten}, ufx, order)
            - M * (xs(mu, 1) - mu))
    span = max(sten)
    # lower-frame faces x -> x+1 for x in [c-span+1, c]
    for d in range(-span + 1, 1):
        mu0 = ctx.col(mu, d)
        mu1 = mu_b1 if d == 0 else ctx.col(mu, d + 1)
        fe_x = ctx.put(fe_x, 0, d, upwind_face(
            col_stack(d, True), le_face_u(u, ctx, d, True), order)
            - M * (mu1 - mu0))
    # upper-frame faces x -> x+1 for x in [c+1, c+span-1] (the face at
    # x = c is the plane face, handled as fw below)
    for d in range(1, span):
        fe_x = ctx.put(fe_x, 0, d, upwind_face(
            col_stack(d, False), le_face_u(u, ctx, d, False), order)
            - M * (ctx.col(mu, d + 1) - ctx.col(mu, d)))
    # the plane face from the upper side (fw of column c+1), then the
    # average fix (ref: phi_ch_le_fix_fluxes)
    fw = (upwind_face(col_stack(0, False), le_face_u(u, ctx, 0, False),
                      order) - M * (ctx.col(mu, 1) - mu_d0))
    fe_c = ctx.col(fe_x, 0)
    fe_fix = 0.5 * (fe_c + sample_linear(fw, ctx.dy_field))
    fw_fix = 0.5 * (fw + sample_linear(fe_c, -ctx.dy_field))
    fe_x = ctx.put(fe_x, 0, 0, fe_fix)

    ufy = 0.5 * (u[1] + torch.roll(u[1], -1, 1))
    ufz = 0.5 * (u[2] + torch.roll(u[2], -1, 2))
    fy = (upwind_face({d: torch.roll(phi, -d, 1) for d in sten}, ufy, order)
          - M * (torch.roll(mu, -1, 1) - mu))
    fz = (upwind_face({d: torch.roll(phi, -d, 2) for d in sten}, ufz, order)
          - M * (torch.roll(mu, -1, 2) - mu))
    dfy = fy - torch.roll(fy, 1, 1)
    dfz = fz - torch.roll(fz, 1, 2)
    div = (fe_x - torch.roll(fe_x, 1, 0) + fy - torch.roll(fy, 1, 1)
           + fz - torch.roll(fz, 1, 2))
    div = ctx.put(div, 0, 1, ctx.col(fe_x, 1) - fw_fix + ctx.col(dfy, 1)
                  + ctx.col(dfz, 1))
    return phi - div


def make_binary_le_step(cfg: BinaryLEConfig, keep_grads: bool = False):
    """Sheared binary step: ((f, phi, u[, nstate][, grad, delsq]), t=0) ->
    (state', rho).  nstate, the per-site KISS state, rides with the LB's
    isothermal fluctuations (the f-collision then takes the KISS stress
    and ghost noise, ref: collision.c noise branch); keep_grads carries
    the LE-aware gradients of the step's pre-update phi at the tail of
    the state, for the statistics and the checkpoint (the reference's
    stale-gradient convention).  The Brazovskii free energy's chemical
    potential and stress take the fourth-order LE fields (its buffer
    columns carry them too)."""
    bcfg = cfg.binary
    params = bcfg.lb.collision_params()
    model = bcfg.lb.model
    le = cfg.le
    fe = bcfg.fe
    gradient = bcfg.gradient
    kiss_rho = kiss_on(bcfg.lb)
    braz = bcfg.fourth_order
    d4_fields = (le_fields_27pt_d4 if gradient == "3d_27pt_fluid"
                 else le_fields_2d5pt_d4)

    def mu_of(phi0, grad0, delsq0, gd2=None, d4=None):
        return fe.mu({"phi": phi0, "delsq_phi": delsq0,
                      "delsq_delsq_phi": d4})

    def pth_of(phi0, grad0, delsq0, gd2=None, d4=None):
        return fe.stress({"phi": phi0, "grad_phi": grad0,
                          "delsq_phi": delsq0, "grad_delsq_phi": gd2,
                          "delsq_delsq_phi": d4})

    def step(state, t=0):
        f, phi, u = state[:3]
        ctx = LEContext(le, t, phi)
        if braz:
            grad, delsq, gd2, d4, bufs = d4_fields(phi, le, t)
            own = (phi, grad, delsq, gd2, d4)
            b1, d0 = bufs["b1"], bufs["d0"]
        else:
            grad, delsq = le_gradient(phi, le, t, gradient)
            own = (phi, grad, delsq)
            # the buffer-frame columns: looking up from the lower frame
            # (above each plane), looking down from the upper one
            b1 = le_buffer_fields(phi, ctx, True, gradient)
            d0 = le_buffer_fields(phi, ctx, False, gradient)

        phi_new = le_cahn_hilliard(phi, mu_of(*own), u, ctx, bcfg.mobility,
                                   bcfg.advection_order, mu_of(*b1),
                                   mu_of(*d0))
        area = float(phi.shape[1] * phi.shape[2])
        force = le_stress_force(pth_of(*own), pth_of(*b1), pth_of(*d0), ctx,
                                area).to(f.dtype)

        if kiss_rho:
            shat, ghat, nstate = _noise_terms(bcfg.lb, params, t,
                                              nstate=state[3])
        else:
            shat = ghat = None
        f, rho, u_new = collide(f, params, force=force, shat=shat,
                                ghat=ghat)
        f = stream(apply_lb_le(f, model, le, t), model)
        out = (f, phi_new, u_new)
        if kiss_rho:
            out = out + (nstate,)
        if keep_grads:
            out = out + (grad, delsq)
        return out, rho

    return step


def make_binary_le_column_fix(cfg: BinaryLEConfig):
    """Column corrections turning the PLAIN-periodic fused binary outputs
    into the Lees-Edwards ones.

    The fused kernels treat x as plain periodic; under shear only the
    plane-adjacent columns differ.  The CH flux carries -M grad(mu) and
    mu is LE-aware at {c, c+1}, so phi' and the force differ at {c-1, c,
    c+1, c+2} of each plane (order 1-2 advection, 7-point gradients).
    This recomputes exactly those columns with make_binary_le_step's
    formulas (ref: phi_ch_flux_mu1 + phi_ch_le_fix_fluxes, phi_force_flux
    + fix_local, gradient_3d_7pt_fluid _le), all planes at once.

    Returns fix(phi, u, t) -> ((idx, phi_cols), (idx, force_cols)): idx
    (4 P,) the columns c-1 .. c+2 of every plane (offset outer), phi_cols
    (4 P, Y, Z), force_cols (3, 4 P, Y, Z).  phi and u are the step's
    INPUTS."""
    _check(cfg)
    bcfg = cfg.binary
    le = cfg.le
    fe = bcfg.fe
    M = bcfg.mobility
    order = bcfg.advection_order
    if order not in (1, 2):
        raise ValueError("fused LE fix needs order 1-2 advection")
    if bcfg.gradient != "3d_7pt_fluid" or bcfg.lb.noise is not None:
        raise ValueError("fused LE fix needs 7-point gradients and no "
                         "fluctuations")
    if le.nx < 6 * le.nplanes:
        raise ValueError("fused LE fix needs plane separation >= 6")

    def upw(cols, uf):
        return upwind_face(cols, uf, order)

    def fix(phi, u, t):
        ctx = LEContext(le, t, phi)
        P = le.nplanes
        area = float(phi.shape[1] * phi.shape[2])
        sp = ctx.slab(phi, -3, 4)           # phi at c-3 .. c+4
        su = ctx.slab(u, -2, 3)             # u at c-2 .. c+3
        pb1, grad_b1, dsq_b1 = le_buffer_fields(phi, ctx, True)
        pd0, grad_d0, dsq_d0 = le_buffer_fields(phi, ctx, False)
        mu_b1 = fe.mu({"phi": pb1, "delsq_phi": dsq_b1})
        pth_b1 = fe.stress({"phi": pb1, "grad_phi": grad_b1,
                            "delsq_phi": dsq_b1})
        mu_d0 = fe.mu({"phi": pd0, "delsq_phi": dsq_d0})
        pth_d0 = fe.stress({"phi": pd0, "grad_phi": grad_d0,
                            "delsq_phi": dsq_d0})
        u_b1 = ctx.col_u(u, 1, True)
        u_d0 = ctx.col_u(u, 0, False)

        # mu and the stress at c-2 .. c+3: LE-aware x neighbours at c
        # (its x+1 is pb1) and c+1 (its x-1 is pd0), plain elsewhere
        p6 = sp[1:7]
        g6, d6 = col_grad7(slab_neighbours(sp, 0, 6, {3: pd0}), p6,
                           slab_neighbours(sp, 2, 6, {2: pb1}))
        mu6 = fe.mu({"phi": p6, "delsq_phi": d6})
        pth6 = fe.stress({"phi": p6, "grad_phi": g6, "delsq_phi": d6})

        # CH x-faces c-2 .. c+2 (plain), then the plane face from both
        # frames with the averaging fix
        uf5 = face_slab(su[0], 0, 5)
        faces = (upw({0: sp[1:6], 1: sp[2:7]}, uf5)
                 - M * (mu6[1:6] - mu6[0:5]))
        fe_c = (upw({0: sp[3], 1: pb1}, 0.5 * (su[0, 2] + u_b1[0]))
                - M * (mu_b1 - mu6[2]))
        fw = (upw({0: pd0, 1: sp[4]}, 0.5 * (u_d0[0] + su[0, 3]))
              - M * (mu6[3] - mu_d0))
        fe_fix = 0.5 * (fe_c + sample_linear(fw, ctx.dy_field))
        fw_fix = 0.5 * (fw + sample_linear(fe_c, -ctx.dy_field))
        east = replace_col(faces[1:5], 1, fe_fix)      # faces c-1 .. c+2
        west = replace_col(faces[0:4], 2, fw_fix)      # faces c-2 .. c+1

        # y/z fluxes at the four fix columns c-1 .. c+2
        p4, m4 = sp[2:6], mu6[1:5]
        uy = 0.5 * (su[1, 1:5] + torch.roll(su[1, 1:5], -1, -2))
        uz = 0.5 * (su[2, 1:5] + torch.roll(su[2, 1:5], -1, -1))
        fy = (upw({0: p4, 1: torch.roll(p4, -1, -2)}, uy)
              - M * (torch.roll(m4, -1, -2) - m4))
        fz = (upw({0: p4, 1: torch.roll(p4, -1, -1)}, uz)
              - M * (torch.roll(m4, -1, -1) - m4))
        yzd = fy - torch.roll(fy, 1, -2) + fz - torch.roll(fz, 1, -1)
        pcols = p4 - (east - west + yzd)

        # the force at c-1 .. c+2 (ref: phi_force_flux)
        force = le_force_cols(pth6, pth_b1, pth_d0, area)
        idx = ctx.index(-1, 0, 1, 2)
        return ((idx, pcols.reshape(4 * P, *phi.shape[1:])),
                (idx, force.reshape(3, 4 * P, *phi.shape[1:])))

    return fix
