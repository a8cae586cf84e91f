"""The reference's per-site initial-condition RNG, vectorised (numpy only).

Copied from ludwig_tpu/ref_rng.py (kiss_advance, RefNoise, spinodal_ref,
random_director_q5, and RanSerial, the scalar serial stream that places
`colloid_init input_random` particles;
ref: src/noise.c:136-233 noise_init, noise_uniform,
noise_uniform_double_reap): a 4-word KISS-style generator (LCG +
xorshift + two 16-bit MWC) seeded per site from the global coordinates,
so the stream is decomposition independent.  The whole lattice advances
in one vectorised uint64 pass on the host - each site's stream is
independent, so 'reap site-by-site in loop order' equals 'reap
everywhere at once'.  The fields it makes are moved to the device by
the caller.

Negative or zero master seeds fall back to the default 13, as in the
reference (noise.c:143-151).
"""

from __future__ import annotations

import numpy as np

_M32 = np.uint64(0xFFFFFFFF)
UINT_MAX = 4294967295.0


def _u(x):
    return x & _M32


def kiss_advance(state):
    """One generator step for an array of states.

    state: (4, ...) uint64 arrays (values < 2^32).
    Returns (state, draw) with draw uint64 (< 2^32).
    """
    s0, s1, s2, s3 = state
    s0 = _u(np.uint64(69069) * s0 + np.uint64(1234567))
    b = _u(s1 ^ _u(s1 << np.uint64(17)))
    b = _u(b ^ (b >> np.uint64(13)))
    s1 = _u(b ^ _u(b << np.uint64(5)))
    s2 = _u(np.uint64(36969) * (s2 & np.uint64(0xFFFF))
            + (s2 >> np.uint64(16)))
    s3 = _u(np.uint64(18000) * (s3 & np.uint64(0xFFFF))
            + (s3 >> np.uint64(16)))
    b = _u(_u(s2 << np.uint64(16)) + s3)
    draw = _u(s1 + (s0 ^ b))
    return np.stack([s0, s1, s2, s3]), draw


class RefNoise:
    """Per-site streams over an (X, Y, Z) lattice (1-based global
    coordinates feed the seeds; serial, no offset)."""

    def __init__(self, size, master_seed: int = 13):
        seed = master_seed if master_seed > 0 else 13
        nx, ny, nz = size
        ig = np.arange(1, nx + 1, dtype=np.uint64)[:, None, None]
        jg = np.arange(1, ny + 1, dtype=np.uint64)[None, :, None]
        kg = np.arange(1, nz + 1, dtype=np.uint64)[None, None, :]
        zeros = np.zeros((nx, ny, nz), np.uint64)
        state = np.stack([
            zeros + np.uint64(seed) + ig,
            zeros + np.uint64(12953) + jg,
            zeros + np.uint64(712357) + kg,
            zeros + np.uint64(22383979),
        ])
        # warm-up: the four draws become the working state (noise.c:201)
        new = []
        for _ in range(4):
            state, draw = kiss_advance(state)
            new.append(draw)
        self.state = np.stack(new)

    def reap_uniform(self) -> np.ndarray:
        """One double in [0, 1) per site: (1/UINT_MAX) * draw."""
        self.state, draw = kiss_advance(self.state)
        return (1.0 / UINT_MAX) * draw.astype(np.float64)


def spinodal_ref(size, seed, phi0, amp=0.1):
    """phi = phi0 + amp (r - 1/2) (ref: field_phi_init_spinodal)."""
    rng = RefNoise(size, seed)
    return phi0 + amp * (rng.reap_uniform() - 0.5)


def patches_ref(size, seed, patch=1, volminus1=0.5):
    """Patchwise +/-1: each patch takes -1 where the uniform of its first
    site is below volminus1 (ref: field_phi_init_spinodal_patches)."""
    rng = RefNoise(size, seed)
    r = rng.reap_uniform()
    nx, ny, nz = size
    phi = np.ones(size)
    for ic in range(0, nx, patch):
        for jc in range(0, ny, patch):
            for kc in range(0, nz, patch):
                val = -1.0 if r[ic, jc, kc] < volminus1 else 1.0
                phi[ic:ic + patch, jc:jc + patch, kc:kc + patch] = val
    return phi


def random_director_q5(size, amplitude, two_d=False, seed=13):
    """Random uniaxial Q (ref: blue_phase_random_q_init / _q_2d;
    fixed DEFAULT_SEED=13).  Returns (5, X, Y, Z)."""
    rng = RefNoise(size, seed)
    ran1 = rng.reap_uniform()
    if two_d:
        phase1 = 2.0 * np.pi * (0.5 - ran1)
        n = np.stack([np.cos(phase1), np.sin(phase1),
                      np.zeros_like(phase1)])
    else:
        ran2 = rng.reap_uniform()
        phase1 = 2.0 * np.pi * (0.5 - ran1)
        phase2 = np.arccos(2.0 * ran2 - 1.0)
        n = np.stack([np.cos(phase1) * np.sin(phase2),
                      np.sin(phase1) * np.sin(phase2),
                      np.cos(phase2)])
    a = amplitude
    return np.stack([0.5 * a * (3.0 * n[0] * n[0] - 1.0),
                     0.5 * a * 3.0 * n[0] * n[1],
                     0.5 * a * 3.0 * n[0] * n[2],
                     0.5 * a * (3.0 * n[1] * n[1] - 1.0),
                     0.5 * a * 3.0 * n[1] * n[2]])


class RanSerial:
    """The reference's scalar serial RNG (ref: src/ran.c:35-41 constants,
    ran_init_seed:83-96 state, ran_lecuyer:190-214).

    A 5-word lagged L'Ecuyer-style generator.  Note ran.c:206 computes
    ``p1 = a1*(s0 - h*q1) - h*s0`` (the last term uses the STATE, not
    the remainder constant r1); the quirk is reproduced since the
    regression initial conditions depend on the exact stream.
    """

    _M = 2147483647
    _A1, _Q1 = 107374182, 20
    _A5, _Q5, _R5 = 104480, 20554, 1727
    _RMOD = 4.656612873077393e-10

    def __init__(self, seed: int = 7361237):
        self.s = [int(seed), 1, 0, 3, 4]
        self.ispare = 0
        self.rspare = 0.0

    @staticmethod
    def _i32(x: int) -> int:
        """Two's-complement wrap to C int (the reference relies on it)."""
        x &= 0xFFFFFFFF
        return x - 0x100000000 if x & 0x80000000 else x

    @classmethod
    def _cdiv(cls, a: int, b: int) -> int:
        q = abs(a) // abs(b)
        return -q if (a < 0) != (b < 0) else q

    def uniform(self) -> float:
        i32, cdiv = self._i32, self._cdiv
        s = self.s
        h = cdiv(s[4], self._Q5)
        p5 = i32(i32(self._A5 * i32(s[4] - i32(h * self._Q5)))
                 - i32(h * self._R5))
        s[4], s[3], s[2], s[1] = s[3], s[2], s[1], s[0]
        h = cdiv(s[0], self._Q1)
        p1 = i32(i32(self._A1 * i32(s[0] - i32(h * self._Q1)))
                 - i32(h * s[0]))
        if p1 < 0:
            p1 += self._M
        if p5 > 0:
            p5 -= self._M
        s[0] = i32(p1 + p5)
        if s[0] < 0:
            s[0] += self._M
        return self._RMOD * s[0]

    def gaussian(self) -> float:
        """Polar Box-Muller with a spare (ref: ran.c ran_gaussian)."""
        if self.ispare:
            self.ispare = 0
            return self.rspare
        while True:
            r1 = 2.0 * self.uniform() - 1.0
            r2 = 2.0 * self.uniform() - 1.0
            rsq = r1 * r1 + r2 * r2
            if 0.0 < rsq < 1.0:
                break
        f = np.sqrt(-2.0 * np.log(rsq) / rsq)
        self.rspare = f * r1
        self.ispare = 1
        return f * r2
