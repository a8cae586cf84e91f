"""Lattice Boltzmann velocity-set models (D2Q9, D3Q15, D3Q19, D3Q27).

Copied from ludwig_tpu/lattice.py (numpy only, so the port needs no JAX).
Model layer of the reference (ref: src/lb_model.c,
src/lb_d2q9.c, src/lb_d3q15.c, src/lb_d3q19.c, src/lb_d3q27.c).

Everything here is generated programmatically from first principles:

* velocity set ``cv``: the rest velocity first, then the remaining
  velocities in descending lexicographic order.  This ordering has the
  property ``cv[nvel - p] == -cv[p]`` for ``p >= 1``, which the dynamics
  (bounce-back, reduced halos) rely on.
* weights ``wv``: the standard Gauss-Hermite quadrature weights for each
  model (cs^2 = 1/3).
* mode matrix ``ma``: rows are the moment polynomials evaluated at each
  velocity - density, momentum, stress (upper triangle), then the
  model-specific ghost modes (Hermite-tensor combinations, cf. Coreixas
  et al. PRE 96 033306 (2017)).  Row ordering matches the reference so
  that TRT ghost-relaxation assignments and fluctuation variances carry
  over (ref: src/lb_d3q19.c:105-155, src/lb_d2q9.c:133-167,
  src/lb_d3q15.c:144-180, src/lb_d3q27.c:150-195).
* normalisers ``na`` and the inverse map ``mi[p][m] = wv[p]*na[m]*ma[m][p]``
  (ref: src/model.c:385), so that ``mi @ ma == I`` by the weighted
  orthogonality of the mode polynomials.

All tables are plain numpy float64.  They are the single source of the
mode transforms: the torch twins read them directly, and the CUDA kernels
get them as code generated from them at build time (ops/_cuda.py).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

CS2 = 1.0 / 3.0
RCS2 = 3.0

_SUPPORTED = (9, 15, 19, 27)


def _velocity_set(nvel: int) -> np.ndarray:
    """Velocity table: rest velocity + descending lexicographic order."""
    if nvel == 9:
        cands = [(x, y, 0) for x in (1, 0, -1) for y in (1, 0, -1)]
    else:
        cands = [(x, y, z) for x in (1, 0, -1) for y in (1, 0, -1)
                 for z in (1, 0, -1)]
    if nvel == 15:  # speeds c^2 in {0, 1, 3}
        cands = [c for c in cands if sum(ci * ci for ci in c) in (0, 1, 3)]
    if nvel == 19:  # speeds c^2 in {0, 1, 2}
        cands = [c for c in cands if sum(ci * ci for ci in c) in (0, 1, 2)]
    moving = sorted([c for c in cands if any(c)], reverse=True)
    cv = np.array([(0, 0, 0)] + moving, dtype=np.int64)
    assert cv.shape == (nvel, 3)
    return cv


def _weights(cv: np.ndarray) -> np.ndarray:
    """Quadrature weights by squared speed, per model."""
    nvel = cv.shape[0]
    c2 = (cv * cv).sum(axis=1)
    table = {
        9: {0: 16.0 / 36.0, 1: 4.0 / 36.0, 2: 1.0 / 36.0},
        15: {0: 16.0 / 72.0, 1: 8.0 / 72.0, 3: 1.0 / 72.0},
        19: {0: 12.0 / 36.0, 1: 2.0 / 36.0, 2: 1.0 / 36.0},
        27: {0: 8.0 / 27.0, 1: 2.0 / 27.0, 2: 1.0 / 54.0, 3: 1.0 / 216.0},
    }[nvel]
    return np.array([table[int(s)] for s in c2], dtype=np.float64)


def _mode_matrix(cv: np.ndarray) -> np.ndarray:
    """Rows of ma: [rho, j_a, S_ab upper triangle, ghost modes]."""
    nvel = cv.shape[0]
    ndim = 2 if nvel == 9 else 3
    cx, cy, cz = (cv[:, 0].astype(np.float64), cv[:, 1].astype(np.float64),
                  cv[:, 2].astype(np.float64))
    one = np.ones(nvel)
    sxx, syy, szz = cx * cx - CS2, cy * cy - CS2, cz * cz - CS2

    if ndim == 2:
        rows = [one, cx, cy, sxx, cx * cy, syy]
        # Ghost ordering 6,7,8 holds the historical labelling that keeps
        # fluctuation results identical (ref: src/lb_d2q9.c:156-163).
        rows += [9.0 * sxx * syy, 6.0 * syy * cx, 6.0 * sxx * cy]
        return np.stack(rows)

    hydro = [one, cx, cy, cz, sxx, cx * cy, cx * cz, syy, cy * cz, szz]
    if nvel == 15:
        ghost = [
            cx * cy * cz,
            3.0 * szz * cx,
            3.0 * sxx * cy,
            3.0 * syy * cz,
            9.0 * sxx * syy - 3.0 * szz,
        ]
    elif nvel == 19:
        c2 = cx * cx + cy * cy + cz * cz
        chi1 = (2.0 * c2 - 3.0) * (3.0 * cz * cz - c2)
        chi2 = (2.0 * c2 - 3.0) * (cy * cy - cx * cx)
        chi3 = 3.0 * c2 * c2 - 6.0 * c2 + 1.0
        ghost = [chi1, chi1 * cx, chi1 * cy, chi1 * cz,
                 chi2, chi2 * cx, chi2 * cy, chi2 * cz, chi3]
    else:  # 27
        ghost = [
            3.0 * sxx * cy, 3.0 * sxx * cz, 3.0 * syy * cz,
            3.0 * syy * cx, 3.0 * szz * cx, 3.0 * szz * cy,
            cx * cy * cz,
            9.0 * sxx * syy, 9.0 * syy * szz, 9.0 * szz * sxx,
            9.0 * sxx * cy * cz, 9.0 * syy * cz * cx, 9.0 * szz * cx * cy,
            9.0 * sxx * syy * cz, 9.0 * syy * szz * cx, 9.0 * szz * sxx * cy,
            27.0 * sxx * syy * szz,
        ]
    return np.stack(hydro + ghost)


@dataclasses.dataclass(frozen=True)
class LatticeModel:
    """Immutable velocity-set description (static, hashable by nvel)."""

    nvel: int
    ndim: int
    cv: np.ndarray        # (nvel, 3) int
    wv: np.ndarray        # (nvel,)
    na: np.ndarray        # (nvel,) normalisers
    ma: np.ndarray        # (nvel, nvel) modes  <- distributions
    mi: np.ndarray        # (nvel, nvel) distributions <- modes
    cs2: float = CS2

    @property
    def nhydro(self) -> int:
        return 1 + self.ndim + self.ndim * (self.ndim + 1) // 2

    @property
    def reverse(self) -> np.ndarray:
        """Index of the opposite velocity: reverse[p] = q with cv[q]=-cv[p]."""
        return np.array([0] + list(range(self.nvel - 1, 0, -1)))

    def __hash__(self):
        return hash(self.nvel)

    def __eq__(self, other):
        return isinstance(other, LatticeModel) and other.nvel == self.nvel


@lru_cache(maxsize=None)
def lb_model(nvel: int) -> LatticeModel:
    """Factory: model tables for nvel in {9, 15, 19, 27}."""
    if nvel not in _SUPPORTED:
        raise ValueError(f"no LB model with nvel={nvel}; want {_SUPPORTED}")
    cv = _velocity_set(nvel)
    wv = _weights(cv)
    ma = _mode_matrix(cv)
    # na and mi computed in exact rational arithmetic, then rounded once:
    # the reference's projector constants are hand-simplified fractions
    # (e.g. collision.c:1991-2010 w0=12/36, wa=6/72, ...) and a float
    # product chain differs from them by ~1 ulp, which shows up as a
    # coherent per-site momentum bias ~1e-11 across a 64^3 lattice.
    from fractions import Fraction as Fr
    third = Fr(1, 3)
    cvf = [[Fr(int(cv[p][a])) for a in range(3)] for p in range(nvel)]
    maf = [[None] * nvel for _ in range(nvel)]
    for m in range(nvel):
        for p in range(nvel):
            x = ma[m][p]
            # reconstruct the exact rational: every ma entry is a small
            # multiple of 1/3 (integers and c^2 - 1/3 products)
            maf[m][p] = Fr(round(float(x) * 9)) / 9
    wvf = {9: {0: Fr(16, 36), 1: Fr(4, 36), 2: Fr(1, 36)},
           15: {0: Fr(16, 72), 1: Fr(8, 72), 3: Fr(1, 72)},
           19: {0: Fr(12, 36), 1: Fr(2, 36), 2: Fr(1, 36)},
           27: {0: Fr(8, 27), 1: Fr(2, 27), 2: Fr(1, 54),
                3: Fr(1, 216)}}[nvel]
    c2 = (cv * cv).sum(axis=1)
    wvl = [wvf[int(s)] for s in c2]
    naf = [1 / sum(wvl[p] * maf[m][p] * maf[m][p] for p in range(nvel))
           for m in range(nvel)]
    na = np.array([float(x) for x in naf])
    mi = np.array([[float(wvl[p] * naf[m] * maf[m][p])
                    for m in range(nvel)] for p in range(nvel)])
    assert np.allclose(mi, np.einsum("p,m,mp->pm", wv, na, ma),
                       atol=1e-14)
    ma2 = np.array([[float(maf[m][p]) for p in range(nvel)]
                    for m in range(nvel)])
    assert np.allclose(ma2, ma, atol=1e-14)
    ma = ma2
    model = LatticeModel(nvel=nvel, ndim=2 if nvel == 9 else 3,
                         cv=cv, wv=wv, na=na, ma=ma, mi=mi)
    # Consistency: mi is the true inverse; opposite velocities pair up.
    assert np.allclose(mi @ ma, np.eye(nvel), atol=1e-12)
    assert (cv[model.reverse] == -cv).all()
    return model


def model_from_name(name: str) -> LatticeModel:
    """'d3q19' -> model (ref input key lb_model / compile-time -D_D3Q19_)."""
    return lb_model(int(name.strip().lower().split("q")[-1]))
