"""Fluctuations: the noise configuration, its variances, the
fluctuating stress and ghost terms and the Cahn-Hilliard random fluxes
built from unit-variance deviates.

PyTorch port of ludwig_tpu/noise.py (ref: src/collision.c:1754-1816
variances, :1818-1906 stress/ghost construction;
src/phi_cahn_hilliard.c:510 var = sqrt(2 kT M)).  The deviates come from
the per-site KISS99 stream (noise_kiss.py), inside the fused kernel from
the counter hash of ops/fused.py, or from the stateless counter-based
stream of the JAX package: threefry2x32 keyed on (seed, timestep),
reproduced here bit for bit (discrete_deviates and the functions built on
it: fluctuating_stress, ghost_noise, ch_random_flux, qab_noise5).

The threefry stream is that of `jax.random` with
`jax_threefry_partitionable` on (its default since JAX 0.5):
`key(seed)` is the pair (seed >> 32, seed & 0xffffffff);
`fold_in(key, step)` hashes the count pair (0, step) under the key;
`randint(key, shape, 0, 8)` splits the key in two (the counts (0, 0) and
(0, 1), the second half kept), hashes the row-major index n of each
element as the pair (n >> 32, n & 0xffffffff) and XORs the two output
words.  For a span of 8 only the low 3 bits of that word survive (the
high word's multiplier 2^32 mod 8 is 0), so the high word is never
drawn.  The words are 32-bit values held in int64 and masked after each
sum and shift left, which gives the same bits on the CPU and the card
(torch's uint32 lacks most operations).
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
    # as a state array through the step; False = the stateless threefry
    # stream (the same variances, another realisation)
    kiss: bool = True


M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1: int, k2: int, x1: torch.Tensor):
    """The threefry2x32 hash (20 rounds) of the count pairs (0, x1) under
    the key (k1, k2), as jax._src.prng._threefry2x32_lowering computes
    it: x1 an int64 tensor of 32-bit words, overwritten; returns the two
    output words.  Every count this module hashes has a high word of 0
    (fold_in's (0, step), the split's (0, 1), the draws' row-major
    indices below 2^32).  In place, a pass over two buffers an
    operation."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = torch.full_like(x1, ks[0])
    x1.add_(ks[1]).bitwise_and_(M32)
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(M32)
            torch.bitwise_right_shift(x1, 32 - r, out=tmp)
            x1.bitwise_left_shift_(r).bitwise_and_(M32)
            x1.bitwise_or_(tmp).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(M32)
    return x0, x1


def _key_hash(k1: int, k2: int, count: int):
    """The key pair hashed from the count (0, count), on the host."""
    x0, x1 = threefry2x32(k1, k2, torch.tensor([count], dtype=torch.int64))
    return int(x0), int(x1)


def threefry_key(seed: int, step: int):
    """fold_in(key(seed), step) as a pair of Python ints."""
    seed = int(seed)
    return _key_hash((seed >> 32) & M32, seed & M32, int(step) & M32)


def threefry_randint8(seed: int, step: int, shape, device="cuda"):
    """jax.random.randint(fold_in(key(seed), step), shape, 0, 8, int32)
    as an int64 tensor on `device`."""
    key = _key_hash(*threefry_key(seed, step), 1)     # split(key)[1]
    n = int(np.prod(shape))
    if n >= 1 << 32:
        raise ValueError(f"a draw of {n} deviates exceeds 2^32 counts")
    x0, x1 = threefry2x32(*key, torch.arange(n, dtype=torch.int64,
                                             device=device))
    return x0.bitwise_xor_(x1).bitwise_and_(7).reshape(tuple(shape))


def discrete_deviates(seed: int, step, n: int, shape,
                      dtype=torch.float32, device="cuda"):
    """(n, *shape) unit-variance discrete deviates for this timestep,
    bitwise the JAX package's (its noise.py:53)."""
    from ludwig_tpu_torch.noise_kiss import _table
    idx = threefry_randint8(seed, step, (n,) + tuple(shape), device)
    return _table(dtype, str(torch.device(device)))[idx]


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


def fluctuating_stress(seed: int, step, shape, v_eta: float, v_bulk: float,
                       ndim: int = 3, dtype=torch.float32, device="cuda"):
    """shat (3, 3, *shape) from the threefry stream (ref:
    lb_fluctuations_stress)."""
    r = discrete_deviates(seed, step, 6, shape, dtype, device)
    return stress_from_deviates(r, v_eta, v_bulk, ndim)


def ghost_noise(seed: int, step, shape, model: LatticeModel,
                v_ghost: np.ndarray, dtype=torch.float32, device="cuda"):
    """ghat (nvel, *shape): the noise on each ghost mode, in mode order,
    from the threefry stream (ref: lb_fluctuations_ghosts)."""
    r = discrete_deviates(seed, step, model.nvel - model.nhydro, shape,
                          dtype, device)
    return ghost_from_deviates(r, model, v_ghost)


def ch_random_flux(seed: int, step, shape, kt: float, mobility: float,
                   dtype=torch.float32, device="cuda"):
    """[fx, fy, fz] fluctuating site fluxes, var = sqrt(2 kT M), from the
    threefry stream under the sub-seed seed + 104729 (ref:
    phi_ch_random_flux)."""
    var = math.sqrt(2.0 * kt * mobility)
    r = discrete_deviates(seed + 104729, step, 3, shape, dtype, device)
    return [var * r[0], var * r[1], var * r[2]]


def qab_noise5(seed: int, step, size, kt: float, gamma: float,
               dtype=torch.float64, device="cuda"):
    """The fluctuating Q-tensor noise in the 5-component form (ref:
    blue_phase_beris_edwards.c:403-417 with beris_edw_tmatrix): five
    unit-variance threefry deviates a site, scaled by sqrt(2 kT Gamma)
    and projected through the traceless symmetric basis T^d_ab."""
    var = math.sqrt(2.0 * kt * gamma)
    c = discrete_deviates(seed, step, 5, size, dtype, device) * var
    s32 = math.sqrt(1.5) / 3.0
    s12 = math.sqrt(0.5)
    s2h = math.sqrt(2.0) / 2.0
    return torch.stack([
        -s32 * c[0] + s12 * c[1],   # chi_xx
        s2h * c[2],                 # chi_xy
        s2h * c[3],                 # chi_xz
        -s32 * c[0] - s12 * c[1],   # chi_yy
        s2h * c[4],                 # chi_yz
    ])
