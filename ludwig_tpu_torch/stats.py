"""Lattice statistics and their reference log formats.

PyTorch port of ludwig_tpu/stats.py: the plain reductions of the fused
production path of the JAX package (ludwig.py _make_fast_stats_fn: rho,
momentum and velocity, [phi] and [fed] for the binary fluid,
[Qxx]..[Qyz] and [fe] for the liquid crystal, all three but [fe] for the
LC droplet, computed with ordinary tensor reductions on the device), and
the reference-ordered statistics of its other routes (ludwig.py
_make_stats_fn): the shifted two-pass _compensated_stats and the
site-order scans seq_sum, field_stats_ref (Klein, Kahan or naive),
rho_stats_ref and momentum_total_ref, whose printed digits depend on the
exact order of their additions.  A scan runs as the hand-written CUDA
kernels of csrc/stats_ref.cu (one thread a chain) on a GPU and as a loop
over scalars of the field's dtype on the CPU (each numpy float32 or
Python float operation rounds as the kernel's does): both bitwise the
JAX package's lax.scan.  Min, max and the totals around them stay plain
torch reductions, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ludwig_tpu_torch.lattice import LatticeModel
from ludwig_tpu_torch.ops import _cuda

# scan modes of csrc/stats_ref.cu stats_scan_kernel
SEQ, RHO, PLAIN, KLEIN, KAHAN = range(5)
KLEIN_MODES = {"klein": KLEIN, True: KLEIN, "kahan": KAHAN, False: PLAIN}


def _scalars(a: np.ndarray):
    """The values of a 1-D float array as scalars that round like its
    dtype, and the dtype's zero: Python floats for float64 (IEEE
    double), numpy float32 scalars for float32."""
    if a.dtype == np.float64:
        return a.tolist(), 0.0
    return list(a), np.float32(0.0)


def _scan_twin(flat: torch.Tensor, keep, mode: int):
    """(total, second sum) of scan `mode` over the CPU tensor flat, in
    site order, as csrc/stats_ref.cu's stats_scan_kernel and the JAX
    package's scan bodies compute them."""
    a = flat.detach().numpy()
    if mode == SEQ:
        # np.add.accumulate adds in order, in the array's dtype
        if keep is not None:
            a = np.where(keep.numpy(), a, a.dtype.type(0.0))
        acc = np.add.accumulate(np.concatenate([np.zeros(1, a.dtype), a]))
        return acc[-1], a.dtype.type(0.0)
    xs, zero = _scalars(a)
    ks = [True] * len(xs) if keep is None else keep.numpy().tolist()
    one = type(zero)(1.0)
    s = cs = ccs = sq = zero
    for x, k in zip(xs, ks):
        v = x if keep is None else (one if k else zero) * x      # w * x
        if mode == RHO:
            s = s + v
            sq = sq + v * x
        elif mode == PLAIN:
            s = s + v
            sq = sq + v * v
        elif mode == KLEIN:
            t = s + v
            cc1 = (s - t) + v if abs(s) >= abs(v) else (v - t) + s
            s = t
            t2 = cs + cc1
            cc2 = (cs - t2) + cc1 if abs(cs) >= abs(cc1) else (cc1 - t2) + cs
            cs = t2
            ccs = ccs + cc2
            sq = sq + v * v
        else:   # KAHAN, masked sites skipped
            y = v + cs
            t = s + y
            cs2 = y - (t - s)
            if k:
                s, cs = t, cs2
            sq = sq + v * v
    return ((s + cs) + ccs if mode == KLEIN else s), sq


def _keep(fluid_mask, n: int):
    if fluid_mask is None:
        return None
    keep = fluid_mask.reshape(-1)
    if keep.dtype != torch.bool or keep.numel() != n:
        raise ValueError("fluid_mask must be a bool mask of the field's "
                         "sites")
    return keep.contiguous()


def _scan(x: torch.Tensor, fluid_mask, mode: int, name: str):
    """(total, second sum) as 0-d tensors of x's dtype on x's device: the
    kernel for a CUDA tensor, the twin for a CPU one."""
    flat = x.reshape(-1).contiguous()
    keep = _keep(fluid_mask, flat.numel())
    if flat.device.type == "cuda":
        out = _cuda.stats_scan(flat, keep, mode, name)
        return out[0], out[1]
    if flat.device.type != "cpu":
        raise ValueError(f"no {name} for device {flat.device}")
    tot, sq = _scan_twin(flat, keep, mode)
    return (torch.tensor(tot, dtype=x.dtype), torch.tensor(sq, dtype=x.dtype))


def _count(x: torch.Tensor, fluid_mask):
    """The number of (fluid) sites as a 0-d tensor of x's dtype."""
    if fluid_mask is None:
        return torch.tensor(float(x.numel()), dtype=x.dtype, device=x.device)
    return torch.sum(fluid_mask.to(x.dtype))


def _min_max(x: torch.Tensor, fluid_mask):
    if fluid_mask is None:
        return torch.min(x), torch.max(x)
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    return (torch.min(torch.where(fluid_mask, x, inf)),
            torch.max(torch.where(fluid_mask, x, -inf)))


def _compensated_stats(x: torch.Tensor, fluid_mask=None):
    """(total, mean, var, min, max) via the shifted two-pass algorithm:
    a provisional mean, then sums of (x - mean0) and (x - mean0)^2 (ref:
    util_sum.h:22-42 compensated reductions).  The sums are torch
    reductions: the totals agree with the JAX package's to an ulp or
    two, not bitwise."""
    n = _count(x, fluid_mask)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if fluid_mask is None:
        mean0 = torch.mean(x)
        d = x - mean0
    else:
        mean0 = torch.sum(torch.where(fluid_mask, x, zero)) / n
        d = torch.where(fluid_mask, x - mean0, zero)
    corr = torch.sum(d)
    sq = torch.sum(d * d)
    xmin, xmax = _min_max(x, fluid_mask)
    total = mean0 * n + corr
    c = corr / n
    return total, total / n, torch.abs(sq / n - c * c), xmin, xmax


def seq_sum(x: torch.Tensor, fluid_mask=None):
    """Sequential (site-order) sum, reproducing the reference's running
    accumulation bitwise (masked sites add an exact 0.0)."""
    return _scan(x, fluid_mask, SEQ, "seq_sum")[0]


def field_stats_ref(x: torch.Tensor, fluid_mask=None, klein="klein"):
    """(total, mean, var, min, max) with the reference's accumulation:
    a site-order Klein doubly-compensated sum for the total (ref:
    util_sum.c klein_add_double) and a naive site-order sum for the
    second moment; var = E[x^2] - E[x]^2.  klein="kahan" compensates
    once and really skips masked sites (ref: cahn_hilliard_stats.c);
    klein=False gives plain site-order sums for both (ref:
    phi_stats.c:346)."""
    if klein not in KLEIN_MODES:
        raise ValueError(f"klein must be 'klein', 'kahan' or False, got "
                         f"{klein!r}")
    total, sq = _scan(x, fluid_mask, KLEIN_MODES[klein], "field_stats_ref")
    n = _count(x, fluid_mask)
    mean = total / n
    return (total, mean, sq / n - mean * mean) + _min_max(x, fluid_mask)


def _rank_blocks(x: torch.Tensor, blocks):
    """(nranks, sites of a rank) view of a lattice field (X, Y, Z) in
    the order an MPI run of decomposition `blocks` = (gx, gy, gz) visits
    it: cart-rank (row-major) order, then each rank's local site
    order."""
    gx, gy, gz = blocks
    X, Y, Z = x.shape
    r6 = x.reshape(gx, X // gx, gy, Y // gy, gz, Z // gz)
    return r6.permute(0, 2, 4, 1, 3, 5).reshape(gx * gy * gz, -1)


def _blocked(blocks) -> bool:
    return blocks is not None and tuple(blocks) != (1, 1, 1)


def _rank_scans(x: torch.Tensor, fluid_mask, mode: int, name: str, blocks):
    """_scan's (total, second sum) in the order of a decomposed run:
    each rank's partial sums over its own sites, then the partials added
    in cart-rank order from zero (the MPI_Reduce of the reference's
    parallel run; ludwig_tpu/stats.py rho_stats_ref, blocks)."""
    xs = _rank_blocks(x, blocks)
    ms = None if fluid_mask is None else _rank_blocks(fluid_mask, blocks)
    total = sq = torch.zeros((), dtype=x.dtype, device=x.device)
    for r in range(xs.shape[0]):
        t, q = _scan(xs[r], None if ms is None else ms[r], mode, name)
        total, sq = total + t, sq + q
    return total, sq


def rho_stats_ref(f: torch.Tensor, model: LatticeModel, fluid_mask=None,
                  blocks=None):
    """Reference-exact density stats: rho summed over the velocities in
    order, then sequential site-order naive sums and var = E[rho^2] -
    E[rho]^2 (ref: stats_distribution.c:62-115).  The variance suffers
    catastrophic cancellation (rho ~ 1), so its last digits are set by
    the exact summation ORDER.  `blocks`: the MPI decomposition (gx, gy,
    gz) of the run whose log is reproduced, whose ranks sum their own
    sites and combine in rank order (_rank_scans)."""
    rho = f[0]
    for p in range(1, model.nvel):
        rho = rho + f[p]
    if _blocked(blocks):
        total, sumsq = _rank_scans(rho, fluid_mask, RHO, "rho_stats_ref",
                                   blocks)
    else:
        total, sumsq = _scan(rho, fluid_mask, RHO, "rho_stats_ref")
    n = _count(rho, fluid_mask)
    mean = total / n
    return (total, mean, sumsq / n - mean * mean) + _min_max(rho,
                                                              fluid_mask)


def _momentum_twin(f: torch.Tensor, model: LatticeModel, keep):
    """momentum_total_ref on the CPU: the terms f_p c_pa, p = 1..nvel-1,
    site-major and p-minor, each a Kahan update of its component's
    chain; masked sites skipped."""
    nvel = model.nvel
    cv = np.asarray(model.cv, np.float64)[1:]
    a = f.detach().numpy()
    fsite = a[1:].reshape(nvel - 1, -1).T                  # (nsite, nvel-1)
    terms = fsite[:, :, None] * cv.astype(a.dtype)[None]   # (nsite, nv-1, 3)
    if keep is not None:
        terms = terms[keep.numpy()]
    out = []
    for comp in range(3):
        vals, zero = _scalars(terms[..., comp].reshape(-1))
        s = cs = zero
        for v in vals:
            y = v + cs
            t = s + y
            cs = y - (t - s)
            s = t
        out.append(s)
    return torch.tensor(out, dtype=f.dtype)


def momentum_total_ref(f: torch.Tensor, model: LatticeModel,
                       fluid_mask=None):
    """(3,) total momentum, reproducing the reference accumulation
    bitwise: per site a sequential p-order fold of f_p c_pa, each term a
    site-order Kahan compensated update (ref: stats_distribution.c
    distribution_gm_kernel, util_sum.c kahan_add_double); solid sites
    are skipped, not added as 0."""
    keep = _keep(fluid_mask, f[0].numel())
    if f.device.type == "cuda":
        return _cuda.momentum_total_ref(f.contiguous(), keep, model)
    if f.device.type != "cpu":
        raise ValueError(f"no momentum_total_ref for device {f.device}")
    return _momentum_twin(f, model, keep)


def _two_sum(a, b):
    """Knuth branch-free exact addition: a + b = s + err."""
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def momentum_total(f: torch.Tensor, model: LatticeModel, fluid_mask=None):
    """(3,) total momentum with a compensated per-site fold over the
    velocities (Neumaier: the fold's sum and its error terms), then a
    lattice sum of each - the JAX package's stats.momentum_total, which
    its wall step differences for the walls' momentum."""
    comps = []
    for a in range(3):
        s = c = None
        for p in range(model.nvel):
            cpa = float(model.cv[p][a])
            if cpa == 0.0:
                continue
            t = cpa * f[p]
            if s is None:
                s, c = t, torch.zeros_like(t)
            else:
                s, e = _two_sum(s, t)
                c = c + e
        if s is None:   # 2-D models: no z links
            comps.append(torch.zeros((), dtype=f.dtype, device=f.device))
            continue
        if fluid_mask is not None:
            s = torch.where(fluid_mask, s, 0.0)
            c = torch.where(fluid_mask, c, 0.0)
        comps.append(torch.sum(s) + torch.sum(c))
    return torch.stack(comps)


def field_stats(x: torch.Tensor):
    """(total, mean, var, min, max) of a scalar field with plain
    reductions, as the JAX package's fused route reports them (var =
    E[x^2] - E[x]^2 as in the reference's stats_distribution.c:62-115)."""
    m = torch.mean(x)
    return (torch.sum(x), m, torch.mean(x * x) - m * m, torch.min(x),
            torch.max(x))


def momentum_total_plain(f: torch.Tensor, model: LatticeModel):
    """(3,) total momentum: a p-order fold of f_p c_pa per site, then a
    plain (uncompensated) sum over the sites."""
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
        comps.append(torch.zeros((), dtype=f.dtype, device=f.device)
                     if acc is None else torch.sum(acc))  # 2-D: no z links
    return torch.stack(comps)


def momentum_total_seq(f: torch.Tensor, model: LatticeModel,
                       fluid_mask=None, blocks=None):
    """(3,) total momentum by a plain (uncompensated) site-order sum of
    each site's p-order fold of f_p c_pa, masked sites adding 0: the
    pre-v0.12 reference accumulation (stats_distribution.c before its
    Kahan rewrite), which the logs of older vintages carry in their
    near-zero totals (ludwig_tpu/stats.py momentum_total_plain).
    `blocks` as rho_stats_ref's."""
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
        if acc is None:       # 2-D models: no z links
            acc = torch.zeros_like(f[0])
        if fluid_mask is not None:
            acc = torch.where(fluid_mask, acc, 0.0)
        if _blocked(blocks):
            comps.append(_rank_scans(acc, None, SEQ, "seq_sum", blocks)[0])
        else:
            comps.append(_scan(acc, None, SEQ, "seq_sum")[0])
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


def format_momentum_block(gtotal, gfluid, gwall=None, gcolloid=None) -> str:
    # ref: ludwig.c:1079-1087; stats_colloid.c for the [colloids] row
    s = ("\nMomentum - x y z\n"
         f"[total   ] {float(gtotal[0]):14.7e} {float(gtotal[1]):14.7e} "
         f"{float(gtotal[2]):14.7e}\n"
         f"[fluid   ] {float(gfluid[0]):14.7e} {float(gfluid[1]):14.7e} "
         f"{float(gfluid[2]):14.7e}\n")
    if gcolloid is not None:
        s += (f"[colloids] {float(gcolloid[0]):14.7e} "
              f"{float(gcolloid[1]):14.7e} {float(gcolloid[2]):14.7e}\n")
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
