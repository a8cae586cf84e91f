"""Suspension-scale colloid BBL: the segment-sum route.

PyTorch port of ludwig_tpu/colloids_fast.py: remove_replace_fast (:287),
the bounce-back of bbl_step_mxu (:964-1280, squirmer slip and
colloid-wall virtual links included; it also stands for the plain
segment-sum bbl_step_fast, :102, which the binary and symmetric_lb
colloid steps take), and the helpers of the other families' colloid
steps: colloid_fe_force_fast (:261), phi_remove_replace_conserve_fast
(:354), _nowall_keep (:410), g_bbl_fast (:424), g_remove_replace_fast
(:504).  Every per-particle link sum is a segment sum of
per-site columns into the particles' bins (scatter_add_), so a step costs
O(nvel) lattice passes and a fixed number of launches whatever N; on the
TPU the same sums are a one-hot matmul (seg_cols_mxu), since its scatters
serialise.  The columns are formed at the inside end j of each link, so
that one segmentation (the owner of j) serves every velocity, and zeta is
assembled from raw moments:

    sum m (w6_a - B_a)(w6_b - B_b) = S2_ab - B_a S1_b - B_b S1_a + B_a B_b S0

with B = (cbar, r x cbar) constant within a particle.  Values agree with
the reference-order route to rounding (tests/test_torch_colloids.py).
The float64 route for n > 4 (bbl_step_exact, remove_replace_seeds_fast)
is colloids.py's reference-order route, which is bitwise the JAX
package's exact one; build_map_fast (:36) is colloids.build_map with
arith="window", solid_body_u (:84) colloids.solid_body_u.
"""

from __future__ import annotations

import numpy as np
import torch

from ludwig_tpu_torch.colloids import (RCS2, ColloidParams, _active_arrays,
                                       _ftensor, _lengths, _min_image,
                                       _on_device,
                                       _squirm, _walled_faces, face_links,
                                       link_tables,
                                       rotate_vector, site_coords, solve6)
from ludwig_tpu_torch.lattice import LatticeModel
from ludwig_tpu_torch.ops.collide import unrolled_matvec
from ludwig_tpu_torch.ops.stencil import roll3

# bins that take the sites belonging to no particle: spread so that the
# GPU's atomic additions of their zeros do not queue on one address
SPARE_BINS = 256


def _bins(mask: torch.Tensor, pid: torch.Tensor, n: int) -> torch.Tensor:
    """The segment of each site: its particle where mask, else one of the
    spare bins n, n + 1, ..."""
    flat = mask.reshape(-1)
    spare = n + torch.remainder(torch.arange(flat.numel(),
                                             device=flat.device), SPARE_BINS)
    return torch.where(flat, pid.reshape(-1).to(torch.int64), spare)


def segment_sums(cols: torch.Tensor, ids: torch.Tensor, n: int):
    """(C, n) sums over the sites of the columns cols (C, S) by segment
    ids (S,), or (C, S) one row for each column (values >= n are
    dropped): one scatter_add_."""
    out = torch.zeros((cols.shape[0], n + SPARE_BINS), dtype=cols.dtype,
                      device=cols.device)
    if ids.dim() == 1:
        ids = ids[None].expand(cols.shape[0], -1)
    out.scatter_add_(1, ids, cols)
    return out[:, :n]


def remove_replace_fast(f, R, inside_old, pid_old, inside_new, pid_new,
                        model: LatticeModel, params: ColloidParams, size,
                        rho0: float = 1.0):
    """Segment-sum remove/replace (ludwig_tpu colloids_fast.py:287; ref:
    build.c build_remove_fluid, build_replace_fluid).  Returns (f with the
    uncovered sites replaced, deltam (N,), f0c (N, 3), t0c (N, 3))."""
    N = params.n
    dt = f.dtype
    covered = inside_new & ~inside_old
    uncovered = inside_old & ~inside_new
    # the replacement average divided by the weight sum, as the JAX
    # function has it (the per-particle route multiplies by its reciprocal)
    fluid_old = ~inside_old
    wsum = 0.0
    newf = torch.zeros_like(f)
    for p in range(1, model.nvel):
        shift = tuple(-int(v) for v in model.cv[p])
        w = float(model.wv[p])
        m = roll3(fluid_old, shift).to(dt)
        wsum = wsum + w * m
        newf = newf + (w * m[None]) * roll3(f, shift, first_axis=1)
    newf = newf / torch.clamp(wsum, min=1e-30)[None]
    cvt = model.cv.T.astype(np.float64)
    rho_f = sum(f[q] for q in range(model.nvel))
    g_f = unrolled_matvec(cvt, [f[q] for q in range(model.nvel)])
    rho_n = sum(newf[q] for q in range(model.nvel))
    g_n = unrolled_matvec(cvt, [newf[q] for q in range(model.nvel)])
    coords = site_coords(size, dt, f.device)
    Lb = _lengths(size, f, 3)

    def seg7(mask, pid, rho_s, g_s):
        own = torch.clamp(pid.to(torch.int64), 0, N - 1)
        d = _min_image(coords - torch.movedim(R[own], -1, 0), Lb)
        w8 = mask.to(dt)
        cols = [w8 * (rho_s - rho0)] + [w8 * g_s[a] for a in range(3)]
        cols += [w8 * (d[1] * g_s[2] - d[2] * g_s[1]),
                 w8 * (d[2] * g_s[0] - d[0] * g_s[2]),
                 w8 * (d[0] * g_s[1] - d[1] * g_s[0])]
        return segment_sums(torch.stack(cols).reshape(7, -1),
                            _bins(mask, pid, N), N)

    rc = seg7(covered, pid_new, rho_f, g_f)
    ru = seg7(uncovered, pid_old, rho_n, g_n)
    return (torch.where(uncovered[None], newf, f), -rc[0] + ru[0],
            (rc[1:4] - ru[1:4]).T, (rc[4:7] - ru[4:7]).T)


def bbl_step_seg(f, R, V, W, model: LatticeModel, params: ColloidParams,
                 size, pid, inside, ext_force=None, ext_torque=None,
                 rho0: float = 1.0, deltam=None, f0_corr=None, t0_corr=None,
                 M=None, walls=(False, False, False), wall_drag=None):
    """The bounce-back of bbl_step_mxu (ludwig_tpu colloids_fast.py:964) as
    segment sums: (pid, inside) the map of R, deltam / f0_corr / t0_corr
    the consolidated remove/replace terms of a rebuild step.  Returns
    (f after the BBL, V, W, M rotated, the walls' momentum (3,))."""
    N = params.n
    nvel = model.nvel
    Q = nvel - 1
    dev, dt = f.device, f.dtype
    S = int(np.prod(size))
    zero = torch.zeros((), dtype=dt, device=dev)
    plus, minus = link_tables(tuple(size), nvel, str(dev))
    cq_np = np.asarray(model.cv[1:], np.float64)
    wq_np = np.asarray(model.wv[1:], np.float64)
    cq = _ftensor(cq_np, f)                                       # (Q, 3)
    wq = _ftensor(wq_np, f)
    # an index list would be copied to the card at every use
    rev = _on_device(np.asarray(model.reverse[1:], np.int64), dev)

    ins = inside.reshape(-1)
    pidf = pid.reshape(-1)
    fluid = ~ins
    own = torch.clamp(pidf.to(torch.int64), 0, N - 1)
    coords = site_coords(size, dt, dev).reshape(3, S)
    d = _min_image(coords - R[own].T, _lengths(size, f, 1))       # (3, S)

    cross = [_walled_faces(model, size, walls, q) for q in range(1, nvel)]
    has_walls = any(c is not None for c in cross)
    fl_ok = fluid[None].expand(Q, S)
    if has_walls:
        crossm = _on_device(np.stack([
            (c if c is not None else np.zeros(tuple(size), bool)).reshape(-1)
            for c in cross]), dev)
        fl_ok = fl_ok & ~crossm
    # links at their inside end j, fluid end j - c_q
    mjb = ins[None] & torch.gather(fl_ok, 1, minus)
    mj = mjb.to(dt)
    rbj = [d[a][None] - 0.5 * cq[:, a, None] for a in range(3)]   # (Q, S)
    c2 = [cq[:, a, None] for a in range(3)]
    rbxc = [rbj[1] * c2[2] - rbj[2] * c2[1],
            rbj[2] * c2[0] - rbj[0] * c2[2],
            rbj[0] * c2[1] - rbj[1] * c2[0]]
    f1 = f.reshape(nvel, S)
    fqr = torch.gather(f1[1:], 1, minus)                 # f_q(j - c_q)
    frev = f1[rev]                                       # f_rev(q)(j)
    mcc = (ins[None] & ins[minus] & (pidf[minus] != pidf[None])).to(dt)
    dmcc = fqr + frev
    gw = torch.zeros((3,), dtype=dt, device=dev)
    if has_walls:
        # colloid-wall links: virtual transfers with dm = w rho0 + f(j, ji)
        # folded into the solid-solid columns (ref: build.c:547, bbl.c
        # pass1 'else'; wall.c MAP_COLLOID branch for the wall's account)
        mw = (ins[None] & torch.gather(crossm, 1, minus)).to(dt)
        dmw = wq[:, None] * rho0 + frev
        mcc = mcc + mw
        dmcc = torch.where(mw > 0.0, dmw, dmcc)
        gw = -(cq * torch.sum(mw * (dmw - 2.0 * wq[:, None]), dim=1)[:, None]
               ).sum(dim=0)
    cols = [mj] + [mj * rbxc[a] for a in range(3)] + [mj * fqr]
    cols += [mj * fqr * rbxc[a] for a in range(3)]
    cols += [mj * rbxc[ia] * rbxc[ib] for ia in range(3) for ib in range(ia, 3)]
    cols += [mcc * dmcc] + [mcc * dmcc * rbxc[a] for a in range(3)]
    any_active = params.any_active
    if any_active:
        _act, b1, b2 = _active_arrays(params, f)
        if M is None:
            m_np = np.asarray(params.m, np.float64)
            M = _ftensor(m_np / np.linalg.norm(m_np, axis=1, keepdims=True), f)
        mvj = [M[own, a][None] for a in range(3)]
        tans, pleg, rmod = _squirm(rbj, mvj, b1[own][None], b2[own][None])
        delta = (2.0 * RCS2 * rho0) * wq[:, None]
        dma = 0.0
        for a in range(3):
            dma = dma + ((-delta) * pleg * rmod * tans[a] * c2[a])
        dma = dma * mj
        cols += [dma] + [dma * rbxc[a] for a in range(3)]
    NC = len(cols)
    red = segment_sums(torch.stack(cols).reshape(NC * Q, S),
                       _bins(ins, pidf, N), N).reshape(NC, Q, N)
    S0, Sr, Sf, Sfr, Srr = red[0], red[1:4], red[4], red[5:8], red[8:14]
    Scc, Sccr = red[14], red[15:18]

    # pass A totals
    sumw = torch.clamp(torch.einsum("q,qn->n", wq, S0), min=1e-30)
    rsumw = 1.0 / sumw
    cbar = torch.einsum("q,qa,qn->an", wq, cq, S0)
    rxcbar = torch.einsum("q,aqn->an", wq, Sr)
    cbarn = cbar * rsumw[None]
    rxcbarn = rxcbar * rsumw[None]
    dmn = deltam * rsumw if deltam is not None else torch.zeros(
        (N,), dtype=dt, device=dev)
    # pass B: f0 and t0 from raw moments (dm = 2 f_q - w dmn), the
    # solid-solid and wall links, the slip
    sdm = 2.0 * Sf - wq[:, None] * dmn[None] * S0
    f0 = torch.einsum("qa,qn->na", cq, sdm + Scc)
    t0 = (2.0 * Sfr - wq[None, :, None] * dmn[None, None] * Sr
          + Sccr).sum(dim=1).T
    fe = torch.zeros((N, 3), dtype=dt, device=dev) if ext_force is None \
        else ext_force
    te = torch.zeros((N, 3), dtype=dt, device=dev) if ext_torque is None \
        else ext_torque
    if f0_corr is not None:
        fe = fe + f0_corr
    if t0_corr is not None:
        te = te + t0_corr
    if any_active:
        Sdma, Sdmar = red[18], red[19:22]
        f0 = f0 + torch.einsum("qa,qn->na", cq, Sdma)
        t0 = t0 + Sdmar.sum(dim=1).T
        sump = torch.sum(Sdma, dim=0) * rsumw
        fe = fe - (sump[None] * cbar).T
        te = te - (sump[None] * rxcbar).T
    # zeta from raw moments, w6 = (c, r x c), B = (cbarn, rxcbarn):
    # S2_ab - B_a S1_b - B_b S1_a + B_a B_b S0, all (a, b) at once
    dq = (2.0 * RCS2 * rho0) * wq
    sym = _on_device(np.array([[0, 1, 2], [1, 3, 4], [2, 4, 5]]), dev)
    s2 = torch.empty((6, 6, N), dtype=dt, device=dev)
    s2[:3, :3] = torch.einsum("q,qa,qb,qn->abn", dq, cq, cq, S0)
    s2[:3, 3:] = torch.einsum("q,qa,bqn->abn", dq, cq, Sr)
    s2[3:, :3] = s2[:3, 3:].transpose(0, 1)
    s2[3:, 3:] = torch.einsum("q,abqn->abn", dq, Srr[sym])
    s1 = torch.cat([torch.einsum("q,qa,qn->an", dq, cq, S0),
                    torch.einsum("q,aqn->an", dq, Sr)])           # (6, N)
    B = torch.cat([cbarn, rxcbarn])                               # (6, N)
    zeta = (s2 - B[:, None] * s1[None] - B[None] * s1[:, None]
            + B[:, None] * B[None] * (dq @ S0)).permute(2, 0, 1)
    # the moment from a^5, as bbl_step_mxu has it (the reference-order
    # route rounds the mass first, ColloidParams.masses)
    mass = _ftensor([(4.0 / 3.0) * np.pi * params.rho0 * a ** 3
                     for a in params.a0], f)
    moment = _ftensor([(2.0 / 5.0) * (4.0 / 3.0) * np.pi * params.rho0
                       * a ** 5 for a in params.a0], f)
    diag = torch.cat([mass[:, None].expand(N, 3),
                      moment[:, None].expand(N, 3)], dim=1)
    if wall_drag is not None:
        diag = diag - torch.cat([wall_drag, torch.zeros_like(wall_drag)],
                                dim=1)
    A = zeta + torch.diag_embed(diag)
    b = torch.cat([mass[:, None] * V + f0 + fe,
                   moment[:, None] * W + t0 + te], dim=1)
    x = solve6(A, b)
    Vn, Wn = x[:, :3], x[:, 3:]
    Mn = rotate_vector(M, Wn) if M is not None else None

    # pass 2 at the inside sites, with the owner's gathers shared
    dms = (2.0 * RCS2 * rho0) * ((Vn * cbarn.T).sum(dim=1)
                                 + (Wn * rxcbarn.T).sum(dim=1))
    Vj = [Vn[own, a][None] for a in range(3)]
    Wj = [Wn[own, a][None] for a in range(3)]
    wxrb = [Wj[1] * rbj[2] - Wj[2] * rbj[1],
            Wj[2] * rbj[0] - Wj[0] * rbj[2],
            Wj[0] * rbj[1] - Wj[1] * rbj[0]]
    vdotc = sum((Vj[a] + wxrb[a]) * c2[a] for a in range(3))
    df = (rho0 * 2.0 * RCS2) * wq[:, None] * vdotc + wq[:, None] * (
        dmn[own] - dms[own])[None]
    val = fqr - df
    fout = f.clone().reshape(nvel, S)
    if any_active:
        # the slip on the outgoing distribution (ref: pass1 fdist +=
        # dm_a) and pass 2's mass term (ref: pass2 df += wv sump)
        val = val - wq[:, None] * sump[own][None] + dma
        fout[1:] = fout[1:] + torch.gather(dma, 1, plus)
    fout[rev] = torch.where(mjb, val, fout[rev])
    return fout.reshape(f.shape), Vn, Wn, Mn, gw


# -- the N > 4 helpers of the other families' colloid steps ----------------------

def colloid_fe_force_fast(pth, pid, inside, model: LatticeModel,
                          n_part: int):
    """Segment-sum binary_colloid.colloid_fe_force (ludwig_tpu
    colloids_fast.py:261): (N, 3) reaction force from the stress pth at
    the |c| = 1 fluid links, in pth's dtype.  The link of fluid site i
    toward particle site j = i + c is counted at j, so that one
    segmentation (the owner of j) serves the six directions; their sums
    are added in the JAX package's direction order.  No wall exclusion,
    as there."""
    dev, dt = pth.device, pth.dtype
    S = inside.numel()
    Q = model.nvel - 1
    minus = link_tables(tuple(inside.shape), model.nvel, str(dev))[1]
    ins = inside.reshape(-1)
    fluid = ~ins
    dirs = [(k, int(np.argmax(np.abs(model.cv[k + 1]))),
             float(model.cv[k + 1][int(np.argmax(np.abs(model.cv[k + 1])))]))
            for k in range(Q) if int(np.sum(np.abs(model.cv[k + 1]))) == 1]
    p2 = pth.reshape(3, 3, S)
    zero = torch.zeros((), dtype=dt, device=dev)
    cols = []
    for k, ax, _sgn in dirs:
        i = minus[k]                       # the fluid end j - c
        m = ins & fluid[i]
        cols += [torch.where(m, p2[a, ax][i], zero) for a in range(3)]
    red = segment_sums(torch.stack(cols), _bins(ins, pid, n_part), n_part)
    out = torch.zeros((3, n_part), dtype=dt, device=dev)
    for d, (_k, _ax, sgn) in enumerate(dirs):
        out = out + sgn * red[3 * d:3 * d + 3]
    return out.T


def phi_remove_replace_conserve_fast(phi, inside_old, inside_new, pid_old,
                                     pid_new, model: LatticeModel,
                                     n_part: int, phi0: float = 0.0,
                                     conserve: bool = True):
    """Segment-sum binary_colloid.phi_remove_replace_conserve (ludwig_tpu
    colloids_fast.py:354): the removed and interpolated order parameter
    summed per particle, put back in equal shares on the |c| = 1 fluid
    link sites of the new map (none of it without `conserve`).  No
    walls, as there."""
    dt = phi.dtype
    newly_solid = ~inside_old & inside_new
    newly_fluid = inside_old & ~inside_new
    was_fluid = (~inside_old).to(dt)
    one = torch.ones((), dtype=dt, device=phi.device)
    zero = torch.zeros((), dtype=dt, device=phi.device)
    dphi = segment_sums((newly_solid.to(dt) * (phi - phi0)).reshape(1, -1),
                        _bins(newly_solid, pid_new, n_part), n_part)[0]
    num = torch.zeros_like(phi)
    den = torch.zeros_like(phi)
    for p in range(1, model.nvel):
        sh = tuple(-int(v) for v in model.cv[p])
        wf = roll3(was_fluid, sh)
        w = float(model.wv[p])
        num = num + w * wf * roll3(phi, sh)
        den = den + w * wf
    avg = num / torch.where(den > 0.0, den, one)
    phi = torch.where(newly_fluid & (den > 0.0), avg, phi)
    dphi = dphi - segment_sums(
        (newly_fluid.to(dt) * (phi - phi0)).reshape(1, -1),
        _bins(newly_fluid, pid_old, n_part), n_part)[0]
    if not conserve:
        return phi
    masks = [(m, _bins(m, p, n_part)) for m, p in face_links(inside_new,
                                                              pid_new)]
    saf = torch.zeros((n_part,), dtype=dt, device=phi.device)
    for m, ids in masks:
        saf = saf + segment_sums(m.to(dt).reshape(1, -1), ids, n_part)[0]
    share = torch.where(saf > 0.0, dphi / torch.where(saf > 0.0, saf, one),
                        zero)
    share_pad = torch.cat([share, torch.zeros((SPARE_BINS,), dtype=dt,
                                              device=phi.device)])
    for m, ids in masks:
        phi = phi + torch.where(m, share_pad[ids].reshape(phi.shape), zero)
    return phi


def _nowall_keep(size, c, walls) -> np.ndarray:
    """Static mask: False at the sites whose neighbour along c lies across
    a wall plane (the roll wraps, but no such link exists in the
    reference's map; ludwig_tpu colloids_fast.py:410)."""
    keep = np.ones(tuple(size), bool)
    for ax in range(3):
        cax = int(c[ax])
        if walls[ax] and cax != 0:
            sel = [slice(None)] * 3
            sel[ax] = size[ax] - 1 if cax > 0 else 0
            keep[tuple(sel)] = False
    return keep


def _keep_all(model: LatticeModel, size, walls, device):
    """(Q, S) bool: _nowall_keep of every velocity q >= 1, made once."""
    return _on_device(np.stack([
        _nowall_keep(size, model.cv[q], walls).reshape(-1)
        for q in range(1, model.nvel)]), device)


def g_bbl_fast(g, phi, R, Vn, Wn, model: LatticeModel,
               params: ColloidParams, size, deltaphi, sumw=None,
               walls=(False, False, False), pid_inside=None):
    """The order parameter's bounce-back on links (ndist == 2; ludwig_tpu
    colloids_fast.py:424; ref: bbl.c pass2 ndist > 1 branch): per fluid
    link dg = phi(i) (2 rcs2 w (V + W x rb).c); the particle's deficit
    takes dg and the bounced value gives back the stored deficit spread
    over the link weights.  (pid, inside) the map of R (built with the
    window arithmetic when not given).  Returns (g', the fresh deficit
    (N,), which the statistics add to the phi total)."""
    N = params.n
    nvel = model.nvel
    Q = nvel - 1
    dev, dt = g.device, g.dtype
    S = int(np.prod(size))
    if pid_inside is None:
        from ludwig_tpu_torch.colloids import build_map
        pid_inside = build_map(R, params, size, "window")
    pid, inside = pid_inside
    plus, minus = link_tables(tuple(size), nvel, str(dev))
    ins = inside.reshape(-1)
    pidf = pid.reshape(-1)
    m = (~ins)[None] & ins[plus]                                  # (Q, S)
    if any(walls):
        m = m & _keep_all(model, size, walls, dev)
    pid_n = pidf[plus].to(torch.int64)
    ids = torch.where(m, pid_n, N + torch.remainder(
        torch.arange(S, device=dev), SPARE_BINS)[None])
    wq = _ftensor(np.asarray(model.wv[1:], np.float64), g)
    cq_np = np.asarray(model.cv[1:], np.float64)
    if sumw is None:
        cnt = segment_sums(m.to(dt), ids, N)                      # (Q, N)
        sumw = torch.zeros((N,), dtype=dt, device=dev)
        for k in range(Q):
            sumw = sumw + wq[k] * cnt[k]
    dgtm1 = deltaphi / torch.clamp(sumw, min=1e-30)
    pad = torch.zeros((1,), dtype=dt, device=dev)
    dgtm1_p = torch.cat([dgtm1, pad])
    Vp = torch.cat([Vn, pad.expand(1, 3)])
    Wp = torch.cat([Wn, pad.expand(1, 3)])
    own = torch.clamp(pid_n, 0, N - 1)
    ownp = torch.where(m, pid_n, N)
    coords = site_coords(size, dt, dev).reshape(3, 1, S)
    d = _min_image(coords - torch.movedim(R[own], -1, 0),
                   _lengths(size, g, 2))
    rb = [d[a] + _ftensor(0.5 * cq_np[:, a], g)[:, None] for a in range(3)]
    Vo = torch.movedim(Vp[ownp], -1, 0)
    Wo = torch.movedim(Wp[ownp], -1, 0)
    wxrb = [Wo[1] * rb[2] - Wo[2] * rb[1],
            Wo[2] * rb[0] - Wo[0] * rb[2],
            Wo[0] * rb[1] - Wo[1] * rb[0]]
    vdotc = 0.0
    for a in range(3):
        vdotc = vdotc + (Vo[a] + wxrb[a]) * _ftensor(cq_np[:, a], g)[:, None]
    vdotc = _ftensor(6.0 * np.asarray(model.wv[1:], np.float64), g)[:, None] \
        * vdotc
    dg = phi.reshape(1, S) * vdotc
    zero = torch.zeros((), dtype=dt, device=dev)
    new_deficit = segment_sums(torch.where(m, dg, zero), ids, N).sum(dim=0)
    g1 = g.reshape(nvel, S)
    val = torch.where(m, g1[1:] - (dg - wq[:, None] * dgtm1_p[ownp]), zero)
    rev = _on_device(np.asarray(model.reverse[1:], np.int64), dev)
    gout = g1.clone()
    gout[rev] = torch.where(torch.gather(m, 1, minus),
                            torch.gather(val, 1, minus), g1[rev])
    return gout.reshape(g.shape), new_deficit


def g_remove_replace_fast(g, inside_old, inside_new, pid_old, pid_new,
                          model: LatticeModel, n_part: int,
                          phi0: float = 0.0, walls=(False, False, False)):
    """The order-parameter distribution over a change of shape (ndist ==
    2; ludwig_tpu colloids_fast.py:504; ref: build.c
    build_remove_order_parameter / build_replace_order_parameter): g at a
    newly fluid site becomes the wv-weighted average of its neighbours
    that were fluid (a neighbour across a wall is none), and stays as it
    is where there is none; the particle's deficit takes the removed and
    gives the created order parameter.  Returns (g', ddeficit (N,))."""
    dt = g.dtype
    size = tuple(inside_old.shape)
    newly_solid = ~inside_old & inside_new
    newly_fluid = inside_old & ~inside_new
    was_fluid = (~inside_old).to(dt)
    phi_g = sum(g[p] for p in range(model.nvel))
    dd = segment_sums((newly_solid.to(dt) * (phi_g - phi0)).reshape(1, -1),
                      _bins(newly_solid, pid_new, n_part), n_part)[0]
    wsum = 0.0
    newg = torch.zeros_like(g)
    for p in range(1, model.nvel):
        sh = tuple(-int(v) for v in model.cv[p])
        w = float(model.wv[p])
        mw = roll3(was_fluid, sh)
        if any(walls):
            mw = mw * _on_device(_nowall_keep(size, model.cv[p], walls),
                                 g.device).to(dt)
        wsum = wsum + w * mw
        newg = newg + w * mw[None] * roll3(g, sh, first_axis=1)
    newg = newg / torch.clamp(wsum, min=1e-30)[None]
    g = torch.where((newly_fluid & (wsum > 0.0))[None], newg, g)
    phi_new = sum(g[p] for p in range(model.nvel))
    dd = dd - segment_sums(
        (newly_fluid.to(dt) * (phi_new - phi0)).reshape(1, -1),
        _bins(newly_fluid, pid_old, n_part), n_part)[0]
    return g, dd
