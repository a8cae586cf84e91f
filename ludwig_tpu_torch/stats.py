"""Lattice statistics and their reference log formats.

PyTorch port of the plain-reduction part of ludwig_tpu/stats.py: the
observables the fused production path of the JAX package reports
(ludwig.py _make_fast_stats_fn: rho, momentum and velocity, [phi] and
[fed] for the binary fluid, [Qxx]..[Qyz] and [fe] for the liquid
crystal, all three but [fe] for the LC droplet) and those of an
electrokinetic run (rho, momentum and velocity over the fluid sites,
[psi], [rho] per species, [elc]), computed with ordinary tensor
reductions on the device.  The
reference-ordered compensated scans of the golden-parity path
(_compensated_stats, *_ref) are not ported yet; values agree with them
to roundoff.
"""

from __future__ import annotations

import numpy as np
import torch

from ludwig_tpu_torch.lattice import LatticeModel


def field_stats(x: torch.Tensor, fluid_mask=None):
    """(total, mean, var, min, max) of a scalar field, over the sites of
    `fluid_mask` where one is given (var = E[x^2] - E[x]^2 as in the
    reference's stats_distribution.c:62-115)."""
    if fluid_mask is None:
        m = torch.mean(x)
        return (torch.sum(x), m, torch.mean(x * x) - m * m, torch.min(x),
                torch.max(x))
    xm = torch.where(fluid_mask, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))
    n = torch.sum(fluid_mask.to(x.dtype))
    total = torch.sum(xm)
    m = total / n
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    return (total, m, torch.sum(xm * x) / n - m * m,
            torch.min(torch.where(fluid_mask, x, inf)),
            torch.max(torch.where(fluid_mask, x, -inf)))


def total_min_max(x: torch.Tensor):
    """(total, min, max) of a field: the [psi], [rho] and [elc] lines of
    an electrokinetic run (ref: psi_stats.c)."""
    return torch.sum(x), torch.min(x), torch.max(x)


def momentum_total_plain(f: torch.Tensor, model: LatticeModel,
                         fluid_mask=None):
    """(3,) total momentum: a p-order fold of f_p c_pa per site, then a
    plain (uncompensated) sum over the sites (the sites of `fluid_mask`
    where one is given)."""
    cv = np.asarray(model.cv, np.float64)
    comps = []
    for a in range(3):
        acc = None
        for p in range(model.nvel):
            cpa = float(cv[p][a])
            if cpa == 0.0:
                continue
            t = cpa * f[p]
            acc = t if acc is None else acc + t
        if acc is None:   # 2-D models: no z links
            comps.append(torch.zeros((), dtype=f.dtype, device=f.device))
            continue
        if fluid_mask is not None:
            acc = torch.where(fluid_mask, acc, torch.zeros(
                (), dtype=f.dtype, device=f.device))
        comps.append(torch.sum(acc))
    return torch.stack(comps)


def velocity_minmax(u: torch.Tensor, fluid_mask=None):
    """Per-component (min, max) of a (3, X, Y, Z) velocity field; solid
    sites count as u = 0 where `fluid_mask` is given."""
    if fluid_mask is not None:
        u = torch.where(fluid_mask[None], u, torch.zeros(
            (), dtype=u.dtype, device=u.device))
    # the reference seeds the max accumulator with FLT_MIN (not
    # -FLT_MAX), so an all-non-positive component reports +1.1754944e-38
    # (ref: stats_velocity.c:76)
    flt_min = float(np.finfo(np.float32).tiny)
    umin = torch.amin(u, dim=(1, 2, 3))
    umax = torch.clamp(torch.amax(u, dim=(1, 2, 3)), min=flt_min)
    return umin, umax


# -- formatting (exact reference formats) ---------------------------------

def format_rho_block(total, mean, var, rmin, rmax) -> str:
    # ref: stats_distribution.c:112-114
    return ("\nScalars - total mean variance min max\n"
            f"[rho] {float(total):14.2f} {float(mean):14.11f} "
            f"{float(var):14.7e} {float(rmin):14.11f} {float(rmax):14.11f}\n")


def format_phi_line(name, total, mean, var, fmin, fmax) -> str:
    # ref: phi_stats.c:336 (note the glued '%14.7e%14.7e' pairs)
    return (f"[{name}] {float(total):14.7e} {float(mean):14.7e}"
            f"{float(var):14.7e} {float(fmin):14.7e}{float(fmax):14.7e}\n")


def format_fed_block(tstep, fed_mean, fed_fluid) -> str:
    # ref: stats_free_energy.c:130-132
    return ("\nFree energy density - timestep total fluid\n"
            f"[fed] {int(tstep):14d} {float(fed_mean):17.10e} "
            f"{float(fed_fluid):17.10e}\n")


def format_fe_lc_block(tstep, ftot, vol, fbulk, fgrad, redshift) -> str:
    # ref: fe_lc_stats.c fe_lc_stats_info, the branch without walls or
    # colloids
    ftot, vol = float(ftot), float(vol)
    return ("\nFree energies - timestep f v f/v f_bulk/v f_grad/v redshift\n"
            f"[fe] {int(tstep):14d} {ftot:17.10e} {vol:17.10e} "
            f"{ftot / vol:17.10e} {float(fbulk) / vol:17.10e} "
            f"{float(fgrad) / vol:17.10e} {float(redshift):17.10e}\n")


def format_momentum_block(gtotal, gfluid, gwall=None) -> str:
    # ref: ludwig.c:1079-1087
    s = ("\nMomentum - x y z\n"
         f"[total   ] {float(gtotal[0]):14.7e} {float(gtotal[1]):14.7e} "
         f"{float(gtotal[2]):14.7e}\n"
         f"[fluid   ] {float(gfluid[0]):14.7e} {float(gfluid[1]):14.7e} "
         f"{float(gfluid[2]):14.7e}\n")
    if gwall is not None:
        s += (f"[walls   ] {float(gwall[0]):14.7e} {float(gwall[1]):14.7e} "
              f"{float(gwall[2]):14.7e}\n")
    return s


def format_velocity_block(umin, umax) -> str:
    # ref: stats_velocity.c:116-118
    return ("\nVelocity - x y z\n"
            f"[minimum ] {float(umin[0]):14.7e} {float(umin[1]):14.7e} "
            f"{float(umin[2]):14.7e}\n"
            f"[maximum ] {float(umax[0]):14.7e} {float(umax[1]):14.7e} "
            f"{float(umax[2]):14.7e}\n")
