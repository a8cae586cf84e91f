"""Liquid-crystal Q-tensor initial conditions (numpy only, on the host).

Copied from ludwig_tpu/fe/lc_init.py: the reference initialisations (ref:
src/blue_phase_init.c: blue_phase_O8M_init :59 (BPI),
blue_phase_O2_init (BPII), blue_phase_twist_init :763 (cholesteric),
blue_phase_nematic_init, blue_phase_random_q_init), selected by the
input key lc_q_initialisation.  The caller moves the field to the device.
`lc_init_random_rectangle` draws from the per-site KISS stream of
noise_kiss.py, stepped on the CPU.
"""

from __future__ import annotations

import numpy as np

SQRT2 = np.sqrt(2.0)


def _coords(size):
    """1-based global coordinates, as in the reference (x = offset+ic)."""
    x = np.arange(1, size[0] + 1, dtype=np.float64)
    y = np.arange(1, size[1] + 1, dtype=np.float64)
    z = np.arange(1, size[2] + 1, dtype=np.float64)
    return np.meshgrid(x, y, z, indexing="ij")


def q_uniaxial(amplitude, n):
    """Q_ab = (A/2)(3 n_a n_b - delta_ab) -> 5 comps, n possibly fields."""
    nx, ny, nz = n
    q5 = np.stack([
        0.5 * amplitude * (3.0 * nx * nx - 1.0),
        0.5 * amplitude * (3.0 * nx * ny),
        0.5 * amplitude * (3.0 * nx * nz),
        0.5 * amplitude * (3.0 * ny * ny - 1.0),
        0.5 * amplitude * (3.0 * ny * nz),
    ])
    return q5


def _m_rot(dim, alpha):
    """Single-axis rotation matrix (ref: blue_phase_M_rot)."""
    c, s = np.cos(alpha), np.sin(alpha)
    if dim == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if dim == 1:
        return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _euler_rotate(size, X, Y, Z, euler_deg):
    """Coordinates rotated about the box centre by ZXZ Euler angles in
    degrees, with the reference's sign convention (ref:
    blue_phase_O8M_init:84-93, rotation_create(Z, X, Z), angles
    negated)."""
    if euler_deg is None or not any(euler_deg):
        return X, Y, Z
    th = [-np.pi * a / 180.0 for a in euler_deg]
    M = _m_rot(2, th[2]) @ _m_rot(0, th[1]) @ _m_rot(2, th[0])
    cx, cy, cz = (0.5 * size[0], 0.5 * size[1], 0.5 * size[2])
    r = np.stack([X - cx, Y - cy, Z - cz])
    rr = np.einsum("ab,b...->a...", M, r)
    return rr[0] + cx, rr[1] + cy, rr[2] + cz


def lc_init_o8m(size, q0, amplitude0, euler=None):
    """BPI high-chirality O8M structure (ref: blue_phase_O8M_init),
    optionally Euler-rotated about the box centre."""
    X, Y, Z = _coords(size)
    X, Y, Z = _euler_rotate(size, X, Y, Z, euler)
    cx, cy, cz = (np.cos(SQRT2 * q0 * X), np.cos(SQRT2 * q0 * Y),
                  np.cos(SQRT2 * q0 * Z))
    sx, sy, sz = (np.sin(SQRT2 * q0 * X), np.sin(SQRT2 * q0 * Y),
                  np.sin(SQRT2 * q0 * Z))
    a = amplitude0
    qxx = a * (-2.0 * cy * sz + sx * cz + cx * sy)
    qxy = a * (SQRT2 * cy * cz + SQRT2 * sx * sz - sx * cy)
    qxz = a * (SQRT2 * cx * cy + SQRT2 * sz * sy - cx * sz)
    qyy = a * (-2.0 * sx * cz + sy * cx + cy * sz)
    qyz = a * (SQRT2 * cz * cx + SQRT2 * sy * sx - sy * cz)
    return np.stack([qxx, qxy, qxz, qyy, qyz])


def lc_init_o2(size, q0, amplitude0, euler=None):
    """BPII O2 structure (ref: blue_phase_O2_init), optionally
    Euler-rotated about the box centre."""
    X, Y, Z = _coords(size)
    X, Y, Z = _euler_rotate(size, X, Y, Z, euler)
    a = amplitude0
    qxx = a * (np.cos(2.0 * q0 * Z) - np.cos(2.0 * q0 * Y))
    qxy = a * np.sin(2.0 * q0 * Z)
    qxz = a * np.sin(2.0 * q0 * Y)
    qyy = a * (np.cos(2.0 * q0 * X) - np.cos(2.0 * q0 * Z))
    qyz = a * np.sin(2.0 * q0 * X)
    return np.stack([qxx, qxy, qxz, qyy, qyz])


def lc_init_twist(size, q0, amplitude0, axis=0):
    """Cholesteric helix with the given helical axis
    (ref: blue_phase_twist_init)."""
    X, Y, Z = _coords(size)
    c = [X, Y, Z][axis]
    zero = np.zeros(size)
    if axis == 0:
        n = (zero, np.cos(q0 * c), np.sin(q0 * c))
    elif axis == 1:
        n = (np.cos(q0 * c), zero, -np.sin(q0 * c))
    else:
        n = (np.cos(q0 * c), np.sin(q0 * c), zero)
    return q_uniaxial(amplitude0, n)


def lc_init_random_rectangle(size, q5_base, rmin, rmax, seed=13):
    """Superpose a rectangle of random uniaxial Q (fixed a0 = 0.01) on
    an existing field, drawn from the site-seeded KISS stream with the
    DEFAULT_SEED (ref: blue_phase_random_q_rectangle; two
    noise_uniform_double_reap per site, uniform = kiss/UINT_MAX).  rmin,
    rmax: the 1-based corners, inclusive."""
    from ludwig_tpu_torch.noise_kiss import _uniform, kiss_init

    st = kiss_init(seed, tuple(size), device="cpu")
    st, u1 = _uniform(st)
    st, u2 = _uniform(st)
    ruint = 1.0 / 4294967295.0
    ran1 = u1.numpy().astype(np.float64) * ruint
    ran2 = u2.numpy().astype(np.float64) * ruint
    phase1 = 2.0 * np.pi * (0.5 - ran1)
    phase2 = np.arccos(2.0 * ran2 - 1.0)
    n = (np.cos(phase1) * np.sin(phase2),
         np.sin(phase1) * np.sin(phase2),
         np.cos(phase2))
    qr = q_uniaxial(0.01, n)
    X, Y, Z = _coords(size)
    mask = ((X >= rmin[0]) & (X <= rmax[0]) & (Y >= rmin[1])
            & (Y <= rmax[1]) & (Z >= rmin[2]) & (Z <= rmax[2]))
    return np.where(mask[None], qr, q5_base)


def lc_init_nematic(size, amplitude0, director=(1.0, 0.0, 0.0)):
    n = np.asarray(director, np.float64)
    n = n / np.linalg.norm(n)
    ones = np.ones(size)
    return q_uniaxial(amplitude0, (n[0] * ones, n[1] * ones, n[2] * ones))


def lc_init_random(size, amplitude0, seed=13):
    """Random uniform director field, reference RNG stream
    (ref: blue_phase_random_q_init, DEFAULT_SEED=13)."""
    from ludwig_tpu_torch.ref_rng import random_director_q5
    return random_director_q5(size, amplitude0, two_d=False, seed=seed)


def lc_init_random_xy(size, amplitude0, seed=13):
    """Random in-plane director field (ref: blue_phase_random_q_2d)."""
    from ludwig_tpu_torch.ref_rng import random_director_q5
    return random_director_q5(size, amplitude0, two_d=True, seed=seed)


def lc_init_active_nematic_q2d(size, amplitude0, axis=0):
    """Quasi-2d active nematic: uniform director along the strip axis
    with a central kinked strip (ref: lc_active_nematic_init_q2d)."""
    nx, ny, nz = size
    ang = np.pi / 180.0 * 10.0
    if axis == 0:
        nhat = (1.0, 0.0, 0.0)
        nk1 = (np.sin(ang), np.cos(ang), 0.0)
        nk2 = (-np.sin(ang), np.cos(ang), 0.0)
    else:
        nhat = (0.0, 1.0, 0.0)
        nk1 = (np.cos(ang), np.sin(ang), 0.0)
        nk2 = (np.cos(ang), -np.sin(ang), 0.0)
    ones = np.ones(size)
    q5 = q_uniaxial(amplitude0, tuple(c * ones for c in nhat))
    qk1 = q_uniaxial(amplitude0, nk1)
    qk2 = q_uniaxial(amplitude0, nk2)
    ix = np.arange(1, nx + 1)[:, None, None] + 0 * ones
    iy = np.arange(1, ny + 1)[None, :, None] + 0 * ones
    if axis == 0:
        strip = np.logical_or(iy == ny // 2, iy == (ny - 1) // 2)
        lower = ix <= nx // 2
    else:
        strip = np.logical_or(ix == nx // 2, ix == (nx - 1) // 2)
        lower = iy <= ny // 2
    for n in range(5):
        q5[n] = np.where(strip & lower, qk1[n], q5[n])
        q5[n] = np.where(strip & ~lower, qk2[n], q5[n])
    return q5
