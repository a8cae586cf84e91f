"""Fused collide + stream: one collision and one pull stream per pass.

PyTorch port of ludwig_tpu/ops/fused.py.  The TPU kernels
``_fused_kernel`` (with and without its in-kernel fluctuations,
FusedNoise; D2Q9, D3Q15, D3Q19, D3Q27), ``_fusedn_kernel`` and
``_fused_force_kernel`` (with and without its solid variant; the
three-dimensional sets) become the hand-written CUDA kernels of
``csrc/fused_lb.cu``; their plain PyTorch twins live here.
Every public function takes the twin for a tensor on the CPU, launches
the kernel for a tensor on a CUDA device, and raises on anything else.
make_fused_wall_step and make_fused_le_step wrap the single-step kernel
with the O(surface) post-passes of halo walls and Lees-Edwards planes
(ops/walls.py, ops/lees_edwards.py), plain PyTorch as in the JAX
package, where they are XLA.

The state is the unpadded ``(nvel, X, Y, Z)`` array, C-contiguous with z
fastest.  Periodicity comes from index arithmetic (``torch.roll`` in the
twins, wrapped indices in the kernels), so there are no pads.

The collision arithmetic is the JAX package's: mode transforms unrolled
with the model's constants (zeros skipped, +/-1 folded) and factorised
over +/-c velocity pairs - every mode has definite parity under
c -> -c, so the forward transform acts on even/odd half-sums and the back
transform shares one even and one odd accumulation per pair
(f'_q = E + O, f'_-q = E - O).  The same Python functions below build
the twins' tensor expressions and, traced with symbols, the kernels'
C++ code (ops/_cuda.py), so twin and kernel evaluate one expression tree.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ludwig_tpu_torch.lattice import LatticeModel, lb_model
from ludwig_tpu_torch.ops import _cuda
from ludwig_tpu_torch.ops.collide import CollisionParams, _triu_pairs
from ludwig_tpu_torch.ops.lees_edwards import make_le_post
from ludwig_tpu_torch.ops.stream import _roll3
from ludwig_tpu_torch.ops.walls import wall_bounce_back_fused, wall_fix_plan

NSTEPS_MAX = 8   # deepest temporal blocking fusedn_step accepts


@lru_cache(maxsize=None)
def _eo_tables_nvel(nvel: int):
    model = lb_model(nvel)
    n = model.nvel
    cv, ma = model.cv, model.ma
    idx = {tuple(int(c) for c in cv[q]): q for q in range(n)}
    anti = tuple(idx[tuple(-int(c) for c in cv[q])] for q in range(n))
    par = []
    for m in range(n):
        even = all(float(ma[m, anti[q]]) == float(ma[m, q])
                   for q in range(n))
        odd = all(float(ma[m, anti[q]]) == -float(ma[m, q])
                  for q in range(n))
        if even == odd:
            raise ValueError(f"mode {m} has no definite c-parity")
        par.append(1 if even else -1)
    mi = model.mi
    for q in range(n):
        for m in range(n):
            if float(mi[anti[q], m]) != par[m] * float(mi[q, m]):
                raise ValueError("mi rows are not +/-c symmetric")
    return anti, tuple(par)


def _eo_tables(model: LatticeModel):
    """(anti, par): antipode index per velocity, +/-1 parity per mode.

    Every mode row of `ma` is a polynomial of definite parity in c
    (ma[m, anti[q]] == par[m] * ma[m, q]), hence mi[anti[q], m] ==
    par[m] * mi[q, m] (verified exactly at table-build time)."""
    return _eo_tables_nvel(model.nvel)


def _eo_matvec(model: LatticeModel, fl):
    """modes = ma @ fl, factorised over +/-c pairs: even modes act on
    e_q = f_q + f_{-q}, odd modes on o_q = f_q - f_{-q}.  Unrolled
    (zeros skipped, +/-1 folded) with ~half the multiply-add terms of a
    plain unrolled product."""
    anti, par = _eo_tables(model)
    n = model.nvel
    ma = model.ma
    e, o = {}, {}
    for q in range(n):
        if anti[q] > q:
            e[q] = fl[q] + fl[anti[q]]
            o[q] = fl[q] - fl[anti[q]]
    out = []
    for m in range(n):
        acc = None
        for q in range(n):
            qb = anti[q]
            if qb < q:
                continue
            coef = float(ma[m, q])
            if coef == 0.0:
                continue
            src = fl[q] if qb == q else (e[q] if par[m] > 0 else o[q])
            term = src if coef == 1.0 else (
                -src if coef == -1.0 else coef * src)
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def _assemble_eo(model: LatticeModel, modes, emit):
    """Back transform f'_q = sum_m mi[q, m] modes[m] for ALL velocities,
    factorised over +/-c pairs: one even-mode sum E and one odd-mode
    sum O per pair, then emit(E + O, q) and emit(E - O, -q)."""
    anti, par = _eo_tables(model)
    mi = model.mi
    for q in range(model.nvel):
        qb = anti[q]
        if qb < q:
            continue
        E = O = None
        for m in range(model.nvel):
            coef = float(mi[q, m])
            if coef == 0.0 or isinstance(modes[m], float):
                continue
            term = modes[m] if coef == 1.0 else (
                -modes[m] if coef == -1.0 else coef * modes[m])
            if par[m] > 0:
                E = term if E is None else E + term
            else:
                O = term if O is None else O + term
        if qb == q:
            emit(E, q)  # rest velocity: odd-mode coefficients are 0
        else:
            emit(E + O, q)
            emit(E - O, qb)


def _assemble_eo_deltas(model: LatticeModel, fl, deltas, emit):
    """Back transform in increment form: f'_q = f_q + sum_m mi[q, m]
    delta_m, factorised over +/-c pairs like _assemble_eo.  Constant
    (python float) nonzero deltas - the global body force - are folded
    as scalars."""
    anti, par = _eo_tables(model)
    mi = model.mi
    for q in range(model.nvel):
        qb = anti[q]
        if qb < q:
            continue
        E = O = None
        for m in range(model.nvel):
            coef = float(mi[q, m])
            if coef == 0.0 or (isinstance(deltas[m], float)
                               and deltas[m] == 0.0):
                continue
            term = deltas[m] if coef == 1.0 else (
                -deltas[m] if coef == -1.0 else coef * deltas[m])
            if par[m] > 0:
                E = term if E is None else E + term
            else:
                O = term if O is None else O + term
        if qb == q:
            emit(fl[q] if E is None else fl[q] + E, q)
        else:
            hi = fl[q] if E is None and O is None else (
                fl[q] + (E if O is None else (O if E is None else E + O)))
            lo = fl[qb] if E is None and O is None else (
                fl[qb] + ((E if O is None else (-O if E is None
                                                else E - O))))
            emit(hi, q)
            emit(lo, qb)


def _relax_modes(model: LatticeModel, fl, rt, rtb, ftot, has_f, gcoef,
                 delta: bool, noise_sg=None):
    """Post-collision modes (delta=False) or mode increments
    delta_m = m'_m - m_m (delta=True), plus u.

    The algebra of ludwig_tpu's _collide_modes / _collide_mode_deltas.
    rt, rtb are the shear and bulk rates, ftot the per-axis force (a
    float, a tensor or a symbol), has_f which axes carry one, gcoef the
    per-ghost factor applied to m_g (1 - rtau_g, or -rtau_g in the
    increment form); a float 0.0 factor projects the ghost out
    structurally.  In the increment form the conserved modes have delta
    exactly zero (density) or the bare force (momentum), which keeps the
    conserved content of f out of the back-transform rounding
    (ACCURACY.md f32 conservation study).

    `noise_sg` is an optional (shat_by_pair, ghat_list) from _noise_sg:
    isothermal fluctuations inside the collision (ref: collision.c:53),
    at the JAX package's places - shat after the force term, ghat added
    to m_g * coef or standing alone where coef is a structural 0."""
    ndim = model.ndim
    m = _eo_matvec(model, fl)
    rho = m[0]
    rrho = 1.0 / rho
    u = [rrho * (m[1 + a] + 0.5 * ftot[a]) for a in range(ndim)]

    pairs = _triu_pairs(ndim)
    s = {p: m[1 + ndim + i] for i, p in enumerate(pairs)}
    seq = {p: rho * u[p[0]] * u[p[1]] for p in pairs}
    tr_s = sum(s[(a, a)] for a in range(ndim))
    tr_seq = sum(seq[(a, a)] for a in range(ndim))
    rdim = 1.0 / ndim

    shat, ghat = noise_sg if noise_sg is not None else (None, None)
    if delta:
        out = [0.0] + [ftot[a] if has_f[a] else 0.0 for a in range(ndim)]
    else:
        tr_post = tr_s - rtb * (tr_s - tr_seq)
        out = [rho] + [m[1 + a] + ftot[a] if has_f[a] else m[1 + a]
                       for a in range(ndim)]
    for (a, b) in pairs:
        dev = s[(a, b)] - (tr_s * rdim if a == b else 0.0)
        dev_eq = seq[(a, b)] - (tr_seq * rdim if a == b else 0.0)
        if delta:
            v = -rt * (dev - dev_eq)
            if a == b:
                v = v - rdim * rtb * (tr_s - tr_seq)
        else:
            v = dev - rt * (dev - dev_eq)
            if a == b:
                v = v + rdim * tr_post
        if has_f[a] or has_f[b]:
            v = v + (2.0 - rt) * (u[a] * ftot[b] + ftot[a] * u[b])
        if shat is not None:
            v = v + shat[(a, b)]
        out.append(v)
    for gi, (g, coef) in enumerate(zip(range(model.nhydro, model.nvel),
                                       gcoef)):
        structural_zero = isinstance(coef, float) and coef == 0.0
        val = None if structural_zero else m[g] * coef
        if ghat is not None and ghat[gi] is not None:
            val = ghat[gi] if val is None else val + ghat[gi]
        out.append(0.0 if val is None else val)
    return out, u


def _ghost_coefs(model: LatticeModel, params: CollisionParams, delta: bool):
    """Per-ghost factors on m_g: 1 - rtau_g (absolute form), -rtau_g
    (increment form)."""
    rtau_g = params.rtau_ghost
    return [(-float(rtau_g[g]) if delta else 1.0 - float(rtau_g[g]))
            for g in range(model.nhydro, model.nvel)]


def _collide_modes(model: LatticeModel, params: CollisionParams, fl,
                   force=None, noise_sg=None):
    """Post-collision modes from a list of per-velocity tensors; `force`
    an optional [fx, fy, fz] per-site body force, `noise_sg` optional
    fluctuation terms (_noise_sg).  Returns (modes, u)."""
    return _collide(model, params, fl, force, delta=False,
                    noise_sg=noise_sg)


def _collide_mode_deltas(model: LatticeModel, params: CollisionParams, fl,
                         force=None, noise_sg=None):
    """Post-collision mode INCREMENTS delta_m = m'_m - m_m, plus u."""
    return _collide(model, params, fl, force, delta=True, noise_sg=noise_sg)


def _collide(model, params, fl, force, delta, noise_sg=None):
    ndim = model.ndim
    fg = [float(v) for v in params.force_global[:ndim]]
    if force is None:
        ftot = fg
        has_f = [bool(v) for v in fg]
    else:
        ftot = [force[a] + fg[a] if fg[a] else force[a]
                for a in range(ndim)]
        has_f = [True] * ndim
    return _relax_modes(model, fl, params.rtau_shear, params.rtau_bulk,
                        ftot, has_f, _ghost_coefs(model, params, delta),
                        delta, noise_sg)


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """Tiling of the n-step kernel, which marches along x.

    BY x BZ is the y-z tile a block owns (its windows carry n halo
    sites in y and z), BX the x segment it marches (n planes more at each
    end).  The single-step kernel runs one thread per site and needs no
    tile.  ops/_cuda.py nstep_layout may narrow BY, then BZ, so that one
    block's rings fit the card's shared memory.  The default had the
    least n=2 plus n=3 time at 256^3 f32 on an H100 (chip_smoke.py
    phase 6)."""
    BX: int = 128
    BY: int = 16
    BZ: int = 64


def _check_state(f: torch.Tensor, model: LatticeModel):
    if f.dim() != 4 or f.shape[0] != model.nvel:
        raise ValueError(f"state must be (nvel={model.nvel}, X, Y, Z), "
                         f"got {tuple(f.shape)}")
    if f.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"state must be float32 or float64, got {f.dtype}")
    if not f.is_contiguous():
        raise ValueError("state must be C-contiguous (z fastest)")


def _fused_step_plain(f: torch.Tensor, model: LatticeModel,
                      params: CollisionParams, delta: bool, noise=None,
                      t=0) -> torch.Tensor:
    """Twin of the single-step kernel: collide every site (with the
    counter-hash fluctuations of `noise`, a FusedNoise, at step t), then
    pull-stream each assembled velocity with torch.roll."""
    fl = [f[q] for q in range(model.nvel)]
    noise_sg = None
    if noise is not None:
        coords = _site_coords(f.shape[1:], f.device)
        noise_sg = _noise_modes(model, noise, *coords, t, f.dtype)
    out = [None] * model.nvel
    cvs = [tuple(int(c) for c in model.cv[q]) for q in range(model.nvel)]

    def emit(acc, q):
        shift = cvs[q]
        dims = tuple(d for d in range(3) if shift[d])
        out[q] = (torch.roll(acc, tuple(shift[d] for d in dims), dims)
                  if dims else acc)

    if delta:
        modes, _u = _collide_mode_deltas(model, params, fl,
                                         noise_sg=noise_sg)
        _assemble_eo_deltas(model, fl, modes, emit)
    else:
        modes, _u = _collide_modes(model, params, fl, noise_sg=noise_sg)
        _assemble_eo(model, modes, emit)
    return torch.stack(out)


def _fusedn_step_plain(f: torch.Tensor, model: LatticeModel,
                       params: CollisionParams, nsteps: int,
                       plan: FusedPlan, delta: bool) -> torch.Tensor:
    """Twin of the n-step kernel, tiled as the kernel tiles on an H100
    (ops/_cuda.py nstep_layout): per x segment and y-z tile, gather a
    window widened by n sites (periodic indices), run n collide+stream
    steps on windows that shrink by one site per side per step, and
    write the tile.  The
    kernel's march visits the same sites at each level, plane by plane.
    Equal to n single steps bitwise on any tiling."""
    nvel, X, Y, Z = f.shape
    H = nsteps
    plan = _cuda.nstep_layout(nvel, nsteps, plan, f.element_size()).plan
    BX, BY, BZ = plan.BX, plan.BY, plan.BZ
    cvs = [tuple(int(c) for c in model.cv[q]) for q in range(nvel)]
    collide_fn = _collide_mode_deltas if delta else _collide_modes
    out = torch.empty_like(f)

    def wrapped(start, count, period):
        return torch.remainder(torch.arange(start, start + count,
                                            device=f.device), period)

    for x0 in range(0, X, BX):
        ix = wrapped(x0 - H, BX + 2 * H, X)
        for y0 in range(0, Y, BY):
            iy = wrapped(y0 - H, BY + 2 * H, Y)
            for z0 in range(0, Z, BZ):
                iz = wrapped(z0 - H, BZ + 2 * H, Z)
                win = f[:, ix][:, :, iy][:, :, :, iz]
                fl = [win[q] for q in range(nvel)]
                for s in range(H):
                    halo = H - 1 - s     # halo of this step's output
                    shape = (BX + 2 * halo, BY + 2 * halo, BZ + 2 * halo)
                    nxt = [None] * nvel

                    def emit(acc, q, shape=shape, nxt=nxt):
                        cx, cy, cz = cvs[q]
                        nxt[q] = acc[1 - cx:1 - cx + shape[0],
                                     1 - cy:1 - cy + shape[1],
                                     1 - cz:1 - cz + shape[2]]

                    modes, _u = collide_fn(model, params, fl)
                    if delta:
                        _assemble_eo_deltas(model, fl, modes, emit)
                    else:
                        _assemble_eo(model, modes, emit)
                    fl = nxt
                nx, ny, nz = min(BX, X - x0), min(BY, Y - y0), min(BZ, Z - z0)
                out[:, x0:x0 + nx, y0:y0 + ny, z0:z0 + nz] = torch.stack(
                    fl)[:, :nx, :ny, :nz]
    return out


def fused_step(f: torch.Tensor, model: LatticeModel,
               params: CollisionParams, plan: FusedPlan = FusedPlan(),
               noise=None, t=0, delta: bool = True) -> torch.Tensor:
    """One fused collide+stream step; returns the new state.

    `delta` (default True on this production path) selects the
    conservation-hardened increment-form back transform.  `plan` is
    accepted for signature parity with fusedn_step; the single-step
    kernel has no tile.  `noise` is an optional FusedNoise: isothermal
    fluctuations drawn inside the collision from the counter hash of
    each site's global coordinates and the step counter `t` (an int32,
    as the TPU kernel's step scalar)."""
    del plan
    _check_state(f, model)
    if noise is not None:
        if not isinstance(noise, FusedNoise):
            raise TypeError(f"noise must be a FusedNoise, got "
                            f"{type(noise).__name__}")
        t = _check_step(t)
    if f.device.type == "cpu":
        return _fused_step_plain(f, model, params, delta, noise, t)
    if f.device.type == "cuda":
        if noise is not None:
            return _cuda.fused_step_noise(f, model, params, delta, noise, t)
        return _cuda.fused_step(f, model, params, delta)
    raise ValueError(f"no fused_step for device {f.device}")


def fusedn_step(f: torch.Tensor, model: LatticeModel,
                params: CollisionParams, nsteps: int,
                plan: FusedPlan = FusedPlan(),
                delta: bool = False) -> torch.Tensor:
    """n fused collide+stream steps in one pass (temporal blocking);
    equal to n fused_step calls with the same `delta`.  On a CUDA device
    the velocity set is three-dimensional: the JAX package's
    _fusedn_kernel needs Z % 128 == 0 on hardware, which no D2Q9 lattice
    (Z = 1) meets, and no entry point of it runs D2Q9 n-step; the CPU
    twin takes any set."""
    if not 1 <= nsteps <= NSTEPS_MAX:
        raise ValueError(f"nsteps must be in [1, {NSTEPS_MAX}] "
                         f"(got {nsteps})")
    if min(plan.BX, plan.BY, plan.BZ) < 1:
        raise ValueError(f"bad tile {plan}")
    _check_state(f, model)
    if f.device.type == "cpu":
        return _fusedn_step_plain(f, model, params, nsteps, plan, delta)
    if f.device.type == "cuda":
        if model.ndim != 3:
            raise NotImplementedError(
                "fusedn_step on a CUDA device takes D3Q15/19/27 only: the "
                "JAX package's _fusedn_kernel does not run D2Q9 on its "
                "hardware")
        return _cuda.fusedn_step(f, model, params, nsteps, plan, delta)
    raise ValueError(f"no fusedn_step for device {f.device}")


def _check_force(force: torch.Tensor, f: torch.Tensor):
    if tuple(force.shape) != (3,) + tuple(f.shape[1:]):
        raise ValueError(f"force must be (3, X, Y, Z) = "
                         f"{(3,) + tuple(f.shape[1:])}, got "
                         f"{tuple(force.shape)}")
    if force.dtype != f.dtype or force.device != f.device:
        raise TypeError("force must have the state's dtype and device")
    if not force.is_contiguous():
        raise ValueError("force must be C-contiguous (z fastest)")


def _fused_force_step_plain(f: torch.Tensor, force: torch.Tensor,
                            model: LatticeModel, params: CollisionParams,
                            solid=None):
    """Twin of the force-coupled kernel: collide every site with its own
    Guo force in the increment form, pull-stream each assembled velocity
    with torch.roll, and return the collision-time velocity u.

    With a bool `solid` mask, the TPU kernel's solid variant: a link whose
    pull source is solid takes the receiver's own post-collision antipode
    value, solid sites keep their pre-collision values, and gw = -2 sum
    over live links of c_q times that value (the momentum handed to the
    walls) comes back third, its per-site terms added in the order the
    velocities are assembled."""
    fl = [f[q] for q in range(model.nvel)]
    out = [None] * model.nvel
    cvs = [tuple(int(c) for c in model.cv[q]) for q in range(model.nvel)]
    post, order = [None] * model.nvel, []

    def emit(acc, q):
        if solid is None:
            out[q] = _roll3(acc, cvs[q], 0)
        else:
            post[q] = acc
            order.append(q)

    modes, u = _collide_mode_deltas(model, params, fl,
                                    force=[force[a] for a in range(3)])
    _assemble_eo_deltas(model, fl, modes, emit)
    if solid is None:
        return torch.stack(out), torch.stack(u)
    anti, _par = _eo_tables(model)
    fluid = torch.logical_not(solid)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    wacc = [zero] * 3
    for q in order:
        ss = _roll3(solid, cvs[q], 0)       # the pull source is solid
        bb = post[anti[q]]
        out[q] = torch.where(solid, fl[q],
                             torch.where(ss, bb, _roll3(post[q], cvs[q], 0)))
        if any(cvs[q]):
            lv = torch.where(torch.logical_and(ss, fluid), bb, zero)
            for a, c in enumerate(cvs[q]):
                if c:
                    wacc[a] = wacc[a] + lv if c > 0 else wacc[a] - lv
    gw = torch.stack([-2.0 * torch.sum(w) for w in wacc])
    return torch.stack(out), torch.stack(u), gw


def fused_force_step(f: torch.Tensor, force: torch.Tensor,
                     model: LatticeModel, params: CollisionParams,
                     solid=None):
    """(f', u): one fused collide+stream with a per-site body force
    (3, X, Y, Z), in the increment form.  u (3, X, Y, Z) is the
    collision-time hydrodynamic velocity (m_1 + F/2)/rho, taken before
    streaming: the next order-parameter update's advection input.

    `solid` is an optional bool mask (X, Y, Z) of in-lattice solid sites:
    streaming then applies half-way bounce-back, solid sites keep their
    pre-collision values (collide(fluid_mask) + ops.stream.
    stream_bounce_back), and the call returns (f', u, gw) with gw (3,)
    the momentum the links handed to the walls (ops.stream.
    wall_momentum_transfer).  u is computed at solid sites too; only its
    fluid sites mean anything.

    The velocity set is three-dimensional: the JAX package's
    _fused_force_kernel stores three velocity components and stops on
    D2Q9, so D2Q9 raises here on every device."""
    _check_state(f, model)
    if model.ndim != 3:
        raise NotImplementedError(
            "fused_force_step takes D3Q15/19/27 only: the JAX package's "
            "_fused_force_kernel does not run D2Q9")
    _check_force(force, f)
    if solid is not None:
        if (tuple(solid.shape) != tuple(f.shape[1:])
                or solid.dtype != torch.bool or solid.device != f.device
                or not solid.is_contiguous()):
            raise ValueError(f"solid must be a contiguous bool mask "
                             f"{tuple(f.shape[1:])} on {f.device}")
    if f.device.type == "cpu":
        return _fused_force_step_plain(f, force, model, params, solid)
    if f.device.type == "cuda":
        if solid is not None:
            return _cuda.fused_force_step_solid(f, force, solid, model,
                                                params)
        return _cuda.fused_force_step(f, force, model, params)
    raise ValueError(f"no fused_force_step for device {f.device}")


def make_fused_nstep(model: LatticeModel, params: CollisionParams,
                     plan: FusedPlan = FusedPlan(), noise=None,
                     delta: bool = True):
    """n-step loop of fused_step: nstep(f, n, t0=0) -> f."""

    def nstep(f, n, t0=0):
        for k in range(n):
            f = fused_step(f, model, params, plan, noise=noise, t=t0 + k,
                           delta=delta)
        return f

    return nstep


def make_fused_wall_step(cfg, spec, plan: FusedPlan = FusedPlan()):
    """Fused collide+stream with halo plane walls: step((f, gwall), t=0)
    -> (f', gwall').

    fused_step (the kernel) streams fully periodically; the contaminated
    boundary-plane populations are then overwritten with half-way
    bounce-back (incl. moving walls) - O(surface) work around the
    unmodified O(volume) kernel (ref: wall.c:860-980 wall_bbl_kernel;
    step order ludwig.c collide -> halo -> wall -> propagation).  The
    post-collision populations the walls reflect are those the kernel's
    periodic stream wrapped across the lattice, gathered from its output
    (ops/walls.wall_bounce_back_fused): the JAX package collides the
    boundary planes a second time for them, which in eager PyTorch is
    some 650 launches an axis.  gwall accumulates the momentum
    transferred to the walls for the [walls] statistics row (ref: wall.c
    fnet, wall_momentum), in gwall's dtype.  t is not read."""
    model = cfg.model
    params = cfg.collision_params()
    fixes = {}

    def step(state, t=0):
        f, gwall = state
        f = fused_step(f, model, params, plan)
        fix = fixes.get(f.device)
        if fix is None:
            fix = fixes[f.device] = wall_fix_plan(model, spec, cfg.size,
                                                  cfg.rho0, f.device)
        f, gw = wall_bounce_back_fused(f, model, spec, rho0=cfg.rho0,
                                       plan=fix)
        return (f, gwall + gw.to(gwall.dtype))

    return step


def make_fused_le_step(cfg, le, plan: FusedPlan = FusedPlan()):
    """Fused collide+stream with Lees-Edwards sliding boundaries:
    step((f,), t=0) -> (f',).

    The LE reprojection + y-displacement runs as a column post-pass
    conjugated through streaming (ops/lees_edwards.apply_le_fused) -
    exactly the reference's collide -> LE -> propagate order
    (ref: model_le.c:57, ludwig.c:811) at O(surface) cost; t is the
    step counter of the slide."""
    model = cfg.model
    params = cfg.collision_params()
    post = make_le_post(model, le)

    def step(state, t=0):
        return (post(fused_step(state[0], model, params, plan), t),)

    return step


def make_fusedn_nstep(model: LatticeModel, params: CollisionParams,
                      nsteps: int, plan: FusedPlan = FusedPlan(),
                      delta: bool = False):
    """n-step loop of fusedn_step: nstep(f, n) -> f, n a multiple of
    `nsteps`."""

    def nstep(f, n):
        if n % nsteps:
            raise ValueError(f"fusedn nstep needs n % {nsteps} == 0")
        for _ in range(n // nsteps):
            f = fusedn_step(f, model, params, nsteps, plan, delta=delta)
        return f

    return nstep


# -- in-kernel fluctuating LB (ref: collision.c:53 lb_collision_
# fluctuations inside the collision kernel; variances collision.c:
# 108-120) -------------------------------------------------------------

_RT_A = float(np.sqrt(2.0 + np.sqrt(2.0)))
_RT_B = float(np.sqrt(2.0 - np.sqrt(2.0)))
_M32 = 0xFFFFFFFF
# the hash's int32 multipliers as unsigned words (the JAX package's
# np.int32 constants; ludwig_tpu/ops/fused.py:1436-1474)
_HX, _HY, _HZ = 73856093, 19349663, 83492791
_HT = -1640531527 & _M32          # 0x9e3779b9
_HM = 40503
_MURMUR = (-2048144789 & _M32, -1028477387 & _M32)   # 0x85ebca6b, 0xc2b2ae35


@dataclasses.dataclass(frozen=True)
class FusedNoise:
    """Static fluctuation parameters of the fused kernel.

    The production stream is a counter-based per-GLOBAL-site hash
    (murmur3-style finalizer over (x, y, z, step, mode, seed)) mapped
    onto the reference's 8-value discrete unit-variance distribution
    (ref: noise.c:70 table) - deterministic and decomposition
    independent by construction, like the reference's site-seeded state
    (ref: noise.c:190-196).  The bitwise KISS99 stream is the unfused
    route's (lb.make_step)."""
    seed: int
    v_eta: float
    v_bulk: float
    v_ghost: tuple       # per-mode ghost amplitudes (len nvel)


def _check_step(t) -> int:
    t = int(t)
    if not -2 ** 31 <= t < 2 ** 31:
        raise ValueError(f"step counter {t} does not fit the kernel's int32")
    return t


def _mul32(a, c: int):
    """a * c mod 2^32 for int64 tensors a of 32-bit words and a 32-bit
    constant c, with every intermediate below 2^49 (int64 overflow is
    not promised to wrap)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_u32(h):
    """murmur3 finalizer on 32-bit words (logical shifts, wrap-around
    products)."""
    h = h ^ (h >> 16)
    h = _mul32(h, _MURMUR[0])
    h = h ^ (h >> 13)
    h = _mul32(h, _MURMUR[1])
    return h ^ (h >> 16)


def _deviate_from_bits(bits, dtype):
    """Map 3 uniform bits onto the 8-value discrete distribution
    {-A, -B, 0 x4, +B, +A} (zero mean, unit variance, correct 4th
    moment; ref: noise.c discrete table)."""
    table = torch.tensor([-_RT_A, -_RT_B, 0.0, 0.0, 0.0, 0.0, _RT_B, _RT_A],
                         dtype=dtype, device=bits.device)
    return table[bits & 7]


def _window_deviates(gx, gy, gz, step, seed, n, dtype):
    """n unit-variance deviate tensors keyed on GLOBAL site coordinates
    (int64 tensors that broadcast) and the step counter: the JAX
    package's int32 hash, bit for bit, on 32-bit words."""
    base = (_mul32(gx, _HX) ^ _mul32(gy, _HY) ^ _mul32(gz, _HZ))
    base = base ^ _mul32(torch.as_tensor(step & _M32, dtype=torch.int64,
                                         device=base.device), _HT)
    base = base ^ (seed & 0x7FFFFFFF)
    return [_deviate_from_bits(_hash_u32(base ^ (m * _HM)), dtype)
            for m in range(n)]


def _noise_sg(model: LatticeModel, r, eta2, eta, bulk, ghost_amps):
    """(shat_by_pair, ghat_list) from 6 + nghost unit-variance deviates
    r (ref: collision.c:1818-1906, noise.stress_from_deviates): eta2 is
    v_eta * sqrt(2) and eta v_eta, both folded in double before they
    meet r, bulk v_bulk; ghost_amps[i] the amplitude of ghost i, or None
    where it is 0.  Tensors in the twin, symbols in the kernel's
    generated code (ops/_cuda.py)."""
    ndim = model.ndim
    s = [[None] * 3 for _ in range(3)]
    s[0][0], s[0][1], s[0][2] = r[0], r[1], r[2]
    s[1][1], s[1][2], s[2][2] = r[3], r[4], r[5]
    s[1][0], s[2][0], s[2][1] = s[0][1], s[0][2], s[1][2]
    tr = (1.0 / ndim) * (s[0][0] + s[1][1] + (ndim - 2.0) * s[2][2])
    shat = {}
    for (a, b) in _triu_pairs(ndim):
        v = s[a][b] - (tr if a == b else 0.0)
        v = v * (eta2 if a == b else eta)
        if a == b:
            v = v + tr * bulk
        shat[(a, b)] = v
    ghat = [None if amp is None else amp * r[6 + i]
            for i, amp in enumerate(ghost_amps)]
    return shat, ghat


def noise_amplitudes(model: LatticeModel, noise: FusedNoise):
    """(eta2, eta, bulk, ghost_amps) of _noise_sg as Python floats, a
    ghost amplitude None where it is 0."""
    amps = [float(noise.v_ghost[g]) for g in range(model.nhydro, model.nvel)]
    return (noise.v_eta * float(np.sqrt(2.0)), noise.v_eta, noise.v_bulk,
            [a if a != 0.0 else None for a in amps])


def _noise_modes(model: LatticeModel, noise: FusedNoise, gx, gy, gz, step,
                 dtype):
    """(shat_by_pair, ghat_list) at the sites of coordinates (gx, gy,
    gz) and step `step`."""
    nghost = model.nvel - model.nhydro
    r = _window_deviates(gx, gy, gz, step, noise.seed, 6 + nghost, dtype)
    return _noise_sg(model, r, *noise_amplitudes(model, noise))


def _site_coords(size, device):
    """Broadcasting int64 global coordinates (x, y, z) of a lattice."""
    X, Y, Z = size
    kw = dict(dtype=torch.int64, device=device)
    return (torch.arange(X, **kw)[:, None, None],
            torch.arange(Y, **kw)[None, :, None],
            torch.arange(Z, **kw)[None, None, :])


def fused_noise_fields(model: LatticeModel, noise: FusedNoise, size, step,
                       dtype, device="cuda"):
    """Twin of the in-kernel noise as fields: (shat (3, 3, X, Y, Z), ghat
    (nvel, X, Y, Z)) of the same counter stream, for feeding
    ops.collide.collide."""
    X, Y, Z = size
    shp, ghl = _noise_modes(model, noise, *_site_coords(size, device),
                            _check_step(step), dtype)
    shat = torch.stack([torch.stack([
        torch.broadcast_to(shp[tuple(sorted((a, b)))], (X, Y, Z))
        for b in range(3)]) for a in range(3)])
    zero = torch.zeros((X, Y, Z), dtype=dtype, device=device)
    rows = [zero] * model.nhydro + [
        zero if g is None else torch.broadcast_to(g, (X, Y, Z)) for g in ghl]
    return shat, torch.stack(rows)
