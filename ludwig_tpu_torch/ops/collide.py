"""LB collision in moment space (M10 / BGK / TRT relaxation schemes).

PyTorch port of ludwig_tpu/ops/collide.py (ref: src/collision.c:
lb_collision_mrt1_site, 259-600; relaxation times 1287-1540).  The whole
lattice collides at once, one element-wise tensor op at a time.

The (nvel x nvel) mode transforms are unrolled in Python with the matrix
entries as constants - zeros skipped, +/-1 folded to add/sub - in exactly
the order of the JAX package, so that float64 results agree with it to
the last bits.

Algorithm (identical algebra to the reference):

  m           = ma @ f
  rho, j      = m[0], m[1:1+ndim]
  u           = (j + F/2) / rho
  s           = stress modes;  seq = rho u u (+ FE symmetric stress)
  deviatoric and trace parts relaxed with rtau_shear / rtau_bulk
  s          += (2 - rtau) (u F + F u)           [body-force correction]
  m'[mom]     = j + F                             [full force on momentum]
  ghosts      relaxed toward zero at per-mode rtau_ghost
  f'          = mi @ m'    (+ fluctuations via shat/ghat hooks)
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from ludwig_tpu_torch.lattice import CS2, LatticeModel


class RelaxationScheme(enum.Enum):
    M10 = "m10"
    BGK = "bgk"
    TRT = "trt"


def rtau_shear(eta, rho0):
    """Inverse shear relaxation time (ref: src/collision.c:1287-1300)."""
    return 1.0 / (0.5 + eta / (rho0 * CS2))


def ghost_relaxation(model: LatticeModel, scheme: RelaxationScheme,
                     eta: float, eta_bulk: float, rho0: float) -> np.ndarray:
    """Per-mode inverse relaxation times, rtau[m] for every mode m.

    Hydrodynamic rows are placeholders (handled separately); ghost rows
    follow ref: src/collision.c:1383-1443.
    """
    nvel = model.nvel
    rt_s = rtau_shear(eta, rho0)
    rtau = np.zeros(nvel)
    if scheme is RelaxationScheme.M10:
        rtau[model.nhydro:] = 1.0
    elif scheme is RelaxationScheme.BGK:
        rtau[model.nhydro:] = rt_s
    else:  # TRT
        tau = eta / (rho0 * CS2)
        rt_g = min(0.5 + 2.0 * tau / (tau + 3.0 / 8.0), 2.0)
        if nvel == 15:
            rtau[10], rtau[14] = rt_s, rt_s
            rtau[11:14] = rt_g
        elif nvel == 19:
            rtau[[10, 14, 18]] = rt_s
            rtau[[11, 12, 13, 15, 16, 17]] = rt_g
        else:
            raise ValueError(f"TRT not defined for nvel={nvel} (ref asserts)")
    return rtau


@dataclasses.dataclass(frozen=True)
class CollisionParams:
    """Static collision parameters."""

    model: LatticeModel
    eta_shear: float
    eta_bulk: float
    rho0: float = 1.0
    scheme: RelaxationScheme = RelaxationScheme.M10
    ghost_modes_on: bool = True
    force_global: tuple = (0.0, 0.0, 0.0)

    @property
    def rtau_shear(self) -> float:
        return rtau_shear(self.eta_shear, self.rho0)

    @property
    def rtau_bulk(self) -> float:
        # BGK uses the shear viscosity for the trace too
        # (ref: src/collision.c:1326-1331).
        eta = (self.eta_shear if self.scheme is RelaxationScheme.BGK
               else self.eta_bulk)
        return rtau_shear(eta, self.rho0)

    @property
    def rtau_ghost(self) -> np.ndarray:
        rtau = ghost_relaxation(self.model, self.scheme, self.eta_shear,
                                self.eta_bulk, self.rho0)
        if not self.ghost_modes_on:
            # Ghost modes "off" = fully projected out each step
            # (ref: collision_rt.c ghost_modes switch).
            rtau[self.model.nhydro:] = 1.0
        return rtau


def _triu_pairs(ndim):
    return [(a, b) for a in range(ndim) for b in range(a, ndim)]


def unrolled_matvec(mat: np.ndarray, vecs, out_zero=None):
    """rows of (mat @ vecs) with the matrix unrolled into Python.

    mat is a small numpy matrix of constants; vecs a list of tensors.
    Zero entries are skipped and +/-1 become add/sub, so the result is a
    chain of element-wise adds, exact in the tensor dtype.
    """
    m_rows, n_cols = mat.shape
    outs = []
    for r in range(m_rows):
        acc = None
        for c in range(n_cols):
            coef = float(mat[r, c])
            if coef == 0.0:
                continue
            if isinstance(vecs[c], float) and vecs[c] == 0.0:
                continue  # structurally-zero input (e.g. projected ghost)
            if coef == 1.0:
                term = vecs[c]
            elif coef == -1.0:
                term = None  # handled below to prefer subtraction
            else:
                term = coef * vecs[c]
            if coef == -1.0:
                acc = (-vecs[c]) if acc is None else acc - vecs[c]
            else:
                acc = term if acc is None else acc + term
        if acc is None:
            acc = out_zero if out_zero is not None else torch.zeros_like(
                vecs[0])
        outs.append(acc)
    return outs


def collide(f: torch.Tensor,
            params: CollisionParams,
            force: Optional[torch.Tensor] = None,
            fluid_mask: Optional[torch.Tensor] = None,
            seq_extra: Optional[torch.Tensor] = None,
            shat: Optional[torch.Tensor] = None,
            ghat: Optional[torch.Tensor] = None,
            eta_local: Optional[torch.Tensor] = None):
    """One collision over the whole lattice.

    Args:
      f:          (nvel, *spatial) distributions.
      force:      (ndim, *spatial) local body-force density, or None.
      fluid_mask: (*spatial) bool, True at fluid sites; solid sites pass
                  through unchanged (ref: includeSite masking).
      seq_extra:  (ndim, ndim, *spatial) symmetric FE stress added to the
                  equilibrium stress (fe->use_stress_relaxation path).
      shat:       (ndim, ndim, *spatial) fluctuating stress (noise).
      ghat:       (nvel, *spatial) ghost-mode noise.
      eta_local:  (*spatial) per-site shear viscosity (viscosity model);
                  bulk scales as (eta_bulk/eta_shear) * eta_local.

    Returns:
      (f_post, rho, u): post-collision distributions and hydro fields.
    """
    model = params.model
    ndim = model.ndim
    dtype = f.dtype

    fl = [f[p] for p in range(model.nvel)]
    m = unrolled_matvec(model.ma, fl)

    rho = m[0]
    j = m[1:1 + ndim]

    fg = [float(v) for v in params.force_global[:ndim]]
    if force is None:
        # scalars filled on the device: a host copy would wait on it
        force = [torch.full((), fg[a], dtype=dtype, device=f.device)
                 for a in range(ndim)]
    else:
        force = [force[a] + fg[a] if fg[a] else force[a] for a in range(ndim)]

    rrho = 1.0 / rho
    u = [rrho * (j[a] + 0.5 * force[a]) for a in range(ndim)]

    # Relaxation rates (scalar, or per-site under a viscosity model).
    if eta_local is None:
        rtau = torch.full((), params.rtau_shear, dtype=dtype, device=f.device)
        rtau_b = torch.full((), params.rtau_bulk, dtype=dtype,
                            device=f.device)
    else:
        ratio = params.eta_bulk / params.eta_shear
        rtau = rtau_shear(eta_local, params.rho0).to(dtype)
        eb = (eta_local if params.scheme is RelaxationScheme.BGK
              else ratio * eta_local)
        rtau_b = rtau_shear(eb, params.rho0).to(dtype)

    pairs = _triu_pairs(ndim)
    s = {p: m[1 + ndim + i] for i, p in enumerate(pairs)}
    seq = {}
    for (a, b) in pairs:
        seq[(a, b)] = rho * u[a] * u[b]
        if seq_extra is not None:
            seq[(a, b)] = seq[(a, b)] + seq_extra[a, b]

    tr_s = sum(s[(a, a)] for a in range(ndim))
    tr_seq = sum(seq[(a, a)] for a in range(ndim))
    rdim = 1.0 / ndim

    # Deviatoric relax + bulk relax of the trace + Guo-style force term
    # (ref: src/collision.c:444-474).
    tr_post = tr_s - rtau_b * (tr_s - tr_seq)
    s_post = {}
    for (a, b) in pairs:
        dev = s[(a, b)] - (tr_s * rdim if a == b else 0.0)
        dev_eq = seq[(a, b)] - (tr_seq * rdim if a == b else 0.0)
        val = dev - rtau * (dev - dev_eq)
        if a == b:
            val = val + rdim * tr_post
        val = val + (2.0 - rtau) * (u[a] * force[b] + force[a] * u[b])
        if shat is not None:
            val = val + shat[a, b]
        s_post[(a, b)] = val

    rtau_g = params.rtau_ghost
    out_modes = [rho]
    for a in range(ndim):
        out_modes.append(m[1 + a] + force[a])
    for p in pairs:
        out_modes.append(s_post[p])
    for g in range(model.nhydro, model.nvel):
        coef = 1.0 - float(rtau_g[g])
        mg = m[g] * coef if coef != 0.0 else None
        if ghat is not None:
            mg = ghat[g] if mg is None else mg + ghat[g]
        out_modes.append(mg if mg is not None else 0.0)

    f_post = torch.stack(unrolled_matvec(model.mi, out_modes))

    u = torch.stack(u)
    if fluid_mask is not None:
        f_post = torch.where(fluid_mask[None], f_post, f)
        u = torch.where(fluid_mask[None], u, torch.zeros((), dtype=dtype,
                                                         device=f.device))

    if ndim == 2:  # pad u to 3 components for uniform downstream handling
        u = torch.cat([u, torch.zeros_like(u[:1])])
    return f_post, rho, u


def equilibrium(model: LatticeModel, rho: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """Second-order projected equilibrium via the mode basis.

    m_eq = (rho, rho u, rho u_a u_b, ghosts = 0);  f_eq = mi @ m_eq.
    Identical to the reference's polynomial equilibrium for these bases.
    """
    ndim = model.ndim
    modes = [rho] + [rho * u[a] for a in range(ndim)]
    for (a, b) in _triu_pairs(ndim):
        modes.append(rho * u[a] * u[b])
    return torch.stack(unrolled_matvec(model.mi[:, :model.nhydro], modes))
