"""Fluctuations: the noise configuration, its variances, the
fluctuating stress and ghost terms and the Cahn-Hilliard random fluxes
built from unit-variance deviates.

PyTorch port of the KISS-stream part of ludwig_tpu/noise.py (ref:
src/collision.c:1754-1816 variances, :1818-1906 stress/ghost
construction; src/phi_cahn_hilliard.c:510 var = sqrt(2 kT M)).  The deviates come from the per-site KISS99 stream
(noise_kiss.py) or, inside the fused kernel, from the counter hash of
ops/fused.py; the JAX package's stateless threefry stream
(discrete_deviates, fluctuating_stress, ghost_noise, qab_noise5) is not
ported.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ludwig_tpu_torch.lattice import CS2, LatticeModel


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    kt: float
    seed: int = 8361235
    rho: bool = False     # isothermal fluctuations (LB)
    phi: bool = False     # CH flux noise
    # the reference-exact per-site KISS99 stream (noise_kiss.py), carried
    # as a state array through the step
    kiss: bool = True

    def __post_init__(self):
        if not self.kiss:
            raise NotImplementedError(
                "NoiseConfig(kiss=False) selects the JAX package's "
                "stateless threefry stream, which is not ported; use the "
                "KISS stream (kiss=True), see ROADMAP")


def var_eta(tau: float, kt: float) -> float:
    """Shear-stress noise amplitude (ref: lb_fluctuations_var_eta)."""
    kt = kt / CS2
    return math.sqrt(kt) * math.sqrt(1.0 / 9.0) * math.sqrt(
        (2.0 * tau - 1.0) / (tau * tau))


def var_bulk(tau: float, kt: float) -> float:
    kt = kt / CS2
    return math.sqrt(kt) * math.sqrt(2.0 / 9.0) * math.sqrt(
        (2.0 * tau - 1.0) / (tau * tau))


def var_ghost(model: LatticeModel, rtau_ghost: np.ndarray,
              kt: float) -> np.ndarray:
    """Per-mode ghost noise amplitudes (ref: lb_fluctuations_var_ghost);
    rna[m] = 1/na[m]."""
    kt = kt / CS2
    out = np.zeros(model.nvel)
    rna = 1.0 / model.na
    for m in range(model.nhydro, model.nvel):
        tau = 1.0 / rtau_ghost[m]
        out[m] = math.sqrt(kt * rna[m]) * math.sqrt(
            (2.0 * tau - 1.0) / (tau * tau))
    return out


def stress_from_deviates(r, v_eta: float, v_bulk: float, ndim: int = 3):
    """shat (3, 3, ...) from 6 unit-variance deviates (ref:
    lb_collision_fluctuations)."""
    s = [[None] * 3 for _ in range(3)]
    s[0][0], s[0][1], s[0][2] = r[0], r[1], r[2]
    s[1][1], s[1][2], s[2][2] = r[3], r[4], r[5]
    s[1][0], s[2][0], s[2][1] = s[0][1], s[0][2], s[1][2]

    tr = (1.0 / ndim) * (s[0][0] + s[1][1] + (ndim - 2.0) * s[2][2])
    sq2 = math.sqrt(2.0)
    out = [[None] * 3 for _ in range(3)]
    for a in range(3):
        for b in range(3):
            v = s[a][b] - (tr if a == b else 0.0)
            v = v * (v_eta * sq2 if a == b else v_eta)
            if a == b:
                v = v + tr * v_bulk
            out[a][b] = v
    return torch.stack([torch.stack(row) for row in out])


def ghost_from_deviates(r, model: LatticeModel, v_ghost: np.ndarray):
    """ghat (nvel, ...) from (nvel - nhydro) unit-variance deviates."""
    zero = torch.zeros(r.shape[1:], dtype=r.dtype, device=r.device)
    rows = [zero] * model.nhydro
    for i, m in enumerate(range(model.nhydro, model.nvel)):
        rows.append(float(v_ghost[m]) * r[i])
    return torch.stack(rows)


def ch_flux_from_deviates(r_ext, kt: float, mobility: float):
    """Face random fluxes [fe_x, fe_y, fe_z] (east faces) from 3
    deviates on the EXTENDED (1-halo) lattice: mid-point average of
    site-centred var*r (ref: phi_ch_random_flux mid-point accumulate)."""
    var = math.sqrt(2.0 * kt * mobility)
    out = []
    for ax in range(3):
        r = var * r_ext[ax]
        int_sl = [slice(1, -1)] * 3
        up_sl = [slice(1, -1)] * 3
        up_sl[ax] = slice(2, None)
        out.append(0.5 * (r[tuple(int_sl)] + r[tuple(up_sl)]))
    return out
