"""Landau-de Gennes liquid-crystal free energy (blue phase / cholesteric).

PyTorch port of ludwig_tpu/fe/blue_phase.py (ref: src/blue_phase.c:
fe_lc_compute_fed :309, fe_lc_compute_h :~700, fe_lc_compute_stress
:~790, fe_lc_compute_stress_active, fe_lc_amplitude_compute :1376):

  f = A0/2 (1 - gamma/3) Q^2 - A0 gamma/3 Q^3 + A0 gamma/4 (Q^2)^2
    + kappa0/2 (d_b Q_ab)^2 + kappa1/2 (eps_acd d_c Q_db + 2 q0 Q_ab)^2
    - epsilon E_a Q_ab E_b

with redshifted elastic constants (q0 -> q0/r, kappa -> kappa r^2).

The Q tensor is carried as 5 components (XX, XY, XZ, YY, YZ) like the
reference.  Every method is plain Python arithmetic on "values": whole
tensors ((5, X, Y, Z) fields, or lists of them) in the twins and the
unfused step, symbols in ops/_cuda.py, which traces the same text into
the CUDA kernel's per-site code.  The order of the terms is the JAX
package's, so float64 results agree with it to the last bits.  The
electric-field terms sit behind a static test of the parameters, so with
no field the traced kernel text is that of the field-free energy.
`redshift_compute` (the dynamic redshift) and `surface_fs` (the anchoring
surface energy of the statistics) work on tensors only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

# component order (ref: QXX..QYZ)
XX, XY, XZ, YY, YZ = range(5)

_EPS = {}  # Levi-Civita nonzeros
for (i, j, k, s) in [(0, 1, 2, 1), (1, 2, 0, 1), (2, 0, 1, 1),
                     (0, 2, 1, -1), (2, 1, 0, -1), (1, 0, 2, -1)]:
    _EPS[(i, j, k)] = s


def eps(i, j, k):
    return _EPS.get((i, j, k), 0)


def q5_to_q33(q5):
    """5 components -> symmetric traceless 3x3 list of values."""
    qxx, qxy, qxz, qyy, qyz = (q5[i] for i in range(5))
    qzz = -qxx - qyy
    return [[qxx, qxy, qxz], [qxy, qyy, qyz], [qxz, qyz, qzz]]


def q33_to_q5(q33):
    """3x3 list -> list of the 5 independent components."""
    return [q33[0][0], q33[0][1], q33[0][2], q33[1][1], q33[1][2]]


def dq_tensor(grad_q5):
    """grad_q5[c][n] (3 x 5 values) -> dq[c][a][b] = d_c Q_ab."""
    return [q5_to_q33([grad_q5[c][i] for i in range(5)]) for c in range(3)]


@dataclasses.dataclass(frozen=True)
class BluePhaseFE:
    """Parameters (ref: fe_lc_param_t; input keys lc_a0, lc_gamma, lc_q0,
    lc_kappa0, lc_kappa1, lc_xi, lc_init_redshift, lc_active_zeta0/1,
    lc_dielectric_anisotropy / (12 pi) as epsilon, electric_e0).  The
    redshift may be a 0-d tensor: the dynamic redshift carried in a
    step's state."""

    a0: float
    gamma: float
    q0: float
    kappa0: float
    kappa1: float
    xi: float = 0.0          # flow-alignment
    redshift: float = 1.0
    zeta0: float = 0.0       # active stress (isotropic)
    zeta1: float = 0.0       # active stress ~ Q
    epsilon: float = 0.0     # dielectric anisotropy (includes 1/12pi)
    e0: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def has_efield(self) -> bool:
        """The static test the electric-field terms sit behind."""
        return bool(any(self.e0) and self.epsilon)

    def efield_fed(self, q):
        """E_a Q_ab E_b of a 3x3 Q (the fed's electric term is -epsilon
        times it)."""
        return sum(self.e0[a] * q[a][b] * self.e0[b]
                   for a in range(3) for b in range(3))

    @property
    def amplitude0(self) -> float:
        """Equilibrium nematic amplitude (ref: fe_lc_amplitude_compute)."""
        return (2.0 / 3.0) * (0.25 + 0.75 * math.sqrt(
            1.0 - 8.0 / (3.0 * self.gamma)))

    @property
    def _rr(self):
        """(q0_redshifted, kappa0_r, kappa1_r)."""
        r = self.redshift
        return (self.q0 / r, self.kappa0 * r * r, self.kappa1 * r * r)

    # fields: {"q": 5 values, "grad_q": 3 x 5 values, "delsq_q": 5 values}
    # (tensors (5, ...), (3, 5, ...), (5, ...) or nested lists)

    def _bulk(self, q):
        r3 = 1.0 / 3.0
        q2 = sum(q[a][b] * q[a][b] for a in range(3) for b in range(3))
        q3 = sum(q[a][b] * q[b][c] * q[a][c]
                 for a in range(3) for b in range(3) for c in range(3))
        return (0.5 * self.a0 * (1.0 - r3 * self.gamma) * q2
                - r3 * self.a0 * self.gamma * q3
                + 0.25 * self.a0 * self.gamma * q2 * q2)

    def _grad_sums(self, q, dq, q0):
        """((d_b Q_ab)^2, (eps_acd d_c Q_db + 2 q0 Q_ab)^2)."""
        dq0 = 0.0
        for a in range(3):
            s = sum(dq[b][a][b] for b in range(3))
            dq0 = dq0 + s * s

        dq1 = 0.0
        for a in range(3):
            for b in range(3):
                s = 0.0
                for c in range(3):
                    for d in range(3):
                        e = eps(a, c, d)
                        if e:
                            s = s + e * dq[c][b][d]
                s = s + 2.0 * q0 * q[a][b]
                dq1 = dq1 + s * s
        return dq0, dq1

    def fed(self, fields):
        """Free energy density (ref: fe_lc_compute_fed)."""
        q = q5_to_q33(fields["q"])
        dq = dq_tensor(fields["grad_q"])
        q0, k0, k1 = self._rr
        dq0, dq1 = self._grad_sums(q, dq, q0)
        out = self._bulk(q) + 0.5 * k0 * dq0 + 0.5 * k1 * dq1
        if self.has_efield:
            out = out - self.epsilon * self.efield_fed(q)
        return out

    def fed_bulk_grad(self, fields):
        """(bulk, gradient) free energy densities for the LC statistics
        split (ref: fe_lc_stats.c blue_phase_fbg)."""
        q = q5_to_q33(fields["q"])
        dq = dq_tensor(fields["grad_q"])
        q0, k0, k1 = self._rr
        dq0, dq1 = self._grad_sums(q, dq, q0)
        return self._bulk(q), 0.5 * k0 * dq0 + 0.5 * k1 * dq1

    def surface_fs(self, qs, nhat, anchor: str, w1: float, w2: float,
                   nfix=(0.0, 1.0, 0.0)):
        """Anchoring surface free energy density at one boundary face,
        f_s = w1/2 (Q-Q0)^2 + w2/2 sum_ab (Qt_ab^2 - S0^2)^2
        (ref: fe_lc_stats.c blue_phase_fs, colloids_q_boundary).

        qs: 3x3 list of tensors; nhat: the outward normal (3 floats or
        tensors)."""
        amp = self.amplitude0
        s0 = 1.5 * amp
        nh = nfix if anchor == "fixed" else nhat
        if anchor in ("normal", "fixed"):
            q0b = [[0.5 * amp * (3.0 * nh[a] * nh[b] - float(a == b))
                    for b in range(3)] for a in range(3)]
        elif anchor == "planar":
            qt = [[qs[a][b] + (0.5 * amp if a == b else 0.0)
                   for b in range(3)] for a in range(3)]
            q0b = [[sum((float(a == g) - nhat[a] * nhat[g]) * qt[g][h]
                        * (float(h == b) - nhat[h] * nhat[b])
                        for g in range(3) for h in range(3))
                    - (0.5 * amp if a == b else 0.0)
                    for b in range(3)] for a in range(3)]
        else:
            q0b = [[0.0 * qs[0][0] for _ in range(3)] for _ in range(3)]
        f1 = sum((qs[a][b] - q0b[a][b]) ** 2
                 for a in range(3) for b in range(3))
        f2 = 0.0
        for a in range(3):
            for b in range(3):
                qt = qs[a][b] + (0.5 * amp if a == b else 0.0)
                f2 = f2 + (qt * qt - s0 * s0) ** 2
        return 0.5 * w1 * f1 + 0.5 * w2 * f2

    def molecular_field(self, fields):
        """h[a][b] 3x3 list of values (ref: fe_lc_compute_h)."""
        q = q5_to_q33(fields["q"])
        dq = dq_tensor(fields["grad_q"])
        dsq = q5_to_q33(fields["delsq_q"])
        q0, k0, k1 = self._rr
        a0, gamma = self.a0, self.gamma
        r3 = 1.0 / 3.0

        q2 = sum(q[a][b] * q[a][b] for a in range(3) for b in range(3))

        h = [[None] * 3 for _ in range(3)]
        for a in range(3):
            for b in range(3):
                s = sum(q[a][c] * q[b][c] for c in range(3))
                val = (-a0 * (1.0 - r3 * gamma) * q[a][b]
                       + a0 * gamma * (s - (r3 * q2 if a == b else 0.0))
                       - a0 * gamma * q2 * q[a][b])
                h[a][b] = val

        # gradient terms
        eq = 0.0
        for b in range(3):
            for c in range(3):
                for a in range(3):
                    e = eps(b, c, a)
                    if e:
                        eq = eq + e * dq[b][c][a]

        for a in range(3):
            for b in range(3):
                s = 0.0
                for c in range(3):
                    for d in range(3):
                        e1 = eps(a, c, d)
                        if e1:
                            s = s + e1 * dq[c][b][d]
                        e2 = eps(b, c, d)
                        if e2:
                            s = s + e2 * dq[c][a][d]
                val = (h[a][b] + k0 * dsq[a][b] - 2.0 * k1 * q0 * s
                       - 4.0 * k1 * q0 * q0 * q[a][b])
                if a == b:
                    val = val + 4.0 * r3 * k1 * q0 * eq
                h[a][b] = val

        if self.has_efield:
            e2t = sum(v * v for v in self.e0)
            for a in range(3):
                for b in range(3):
                    h[a][b] = h[a][b] + self.epsilon * (
                        self.e0[a] * self.e0[b]
                        - (r3 * e2t if a == b else 0.0))
        return h

    def stress(self, fields, h=None):
        """Full (symmetric + antisymmetric) thermodynamic stress as a 3x3
        list of values (ref: fe_lc_compute_stress); it is not symmetric."""
        q = q5_to_q33(fields["q"])
        dq = dq_tensor(fields["grad_q"])
        if h is None:
            h = self.molecular_field(fields)
        q0, k0, k1 = self._rr
        xi = self.xi
        r3 = 1.0 / 3.0

        p0 = -self.fed(fields)
        qh = sum(q[a][b] * h[a][b] for a in range(3) for b in range(3))

        sth = [[None] * 3 for _ in range(3)]
        for a in range(3):
            for b in range(3):
                val = 2.0 * xi * (q[a][b] + (r3 if a == b else 0.0)) * qh
                if a == b:
                    val = val - p0
                for c in range(3):
                    val = val - xi * h[a][c] * (q[b][c]
                                                + (r3 if b == c else 0.0))
                    val = val - xi * (q[a][c]
                                      + (r3 if a == c else 0.0)) * h[b][c]
                # gradient term
                for c in range(3):
                    for d in range(3):
                        val = val - k0 * dq[a][b][c] * dq[d][c][d] \
                            - k1 * dq[a][c][d] * dq[b][c][d] \
                            + k1 * dq[a][c][d] * dq[c][b][d]
                        for ee in range(3):
                            ev = eps(b, c, ee)
                            if ev:
                                val = val - 2.0 * k1 * q0 * ev \
                                    * dq[a][c][d] * q[d][ee]
                # antisymmetric part
                for c in range(3):
                    val = val + q[a][c] * h[b][c] - h[a][c] * q[b][c]
                sth[a][b] = -val
        return sth

    def field_and_stress_factored(self, fields):
        """(molecular_field, stress) in factored form: the sums the two
        share (Q.Q, the divergence d_b Q_ab, eps_acd d_c Q_bd, h.Q) are
        formed once, symmetric ones on one triangle, and eps_bca d_b Q_ca,
        which vanishes for a symmetric Q, is left out.  Equal to the
        methods above up to rounding; they keep the JAX package's term
        order and serve the twins and the kernel, this form gives the
        operation count of the kernel's bound (ops/_cuda.site_ops)."""
        q = q5_to_q33(fields["q"])
        dq = dq_tensor(fields["grad_q"])
        dsq = q5_to_q33(fields["delsq_q"])
        q0, k0, k1 = self._rr
        a0, gamma, xi = self.a0, self.gamma, self.xi
        r3 = 1.0 / 3.0
        tri = [(a, b) for a in range(3) for b in range(a, 3)]

        def mirror(vals):
            """3x3 from the six values of `tri`."""
            m = [[None] * 3 for _ in range(3)]
            for (a, b), v in zip(tri, vals):
                m[a][b] = m[b][a] = v
            return m

        def contract(x, y):
            """x_ab y_ab for symmetric x and y."""
            return (sum(x[a][a] * y[a][a] for a in range(3))
                    + 2.0 * sum(x[a][b] * y[a][b] for a, b in tri if a != b))

        qq = mirror([sum(q[a][c] * q[b][c] for c in range(3))
                     for a, b in tri])
        q2 = qq[0][0] + qq[1][1] + qq[2][2]
        q3 = contract(qq, q)
        div = [sum(dq[b][a][b] for b in range(3)) for a in range(3)]
        # curl[a][b] = eps_acd d_c Q_bd, (c, d) the cyclic pair after a
        curl = [[dq[(a + 1) % 3][b][(a + 2) % 3]
                 - dq[(a + 2) % 3][b][(a + 1) % 3] for b in range(3)]
                for a in range(3)]
        dq0 = sum(d * d for d in div)
        dq1 = 0.0
        for a in range(3):
            for b in range(3):
                s = curl[a][b] + 2.0 * q0 * q[a][b]
                dq1 = dq1 + s * s
        fed = (0.5 * a0 * (1.0 - r3 * gamma) * q2 - r3 * a0 * gamma * q3
               + 0.25 * a0 * gamma * q2 * q2
               + 0.5 * k0 * dq0 + 0.5 * k1 * dq1)

        aq2 = a0 * gamma * q2
        lin = -a0 * (1.0 - r3 * gamma) - 4.0 * k1 * q0 * q0
        h = mirror([lin * q[a][b] + a0 * gamma * qq[a][b] - aq2 * q[a][b]
                    + k0 * dsq[a][b]
                    - 2.0 * k1 * q0 * (curl[a][b] + curl[b][a])
                    for a, b in tri])
        for a in range(3):
            h[a][a] = h[a][a] - r3 * aq2

        qh = contract(q, h)
        hq = [[sum(h[a][c] * q[b][c] for c in range(3)) for b in range(3)]
              for a in range(3)]
        sym = mirror([xi * (hq[a][b] + hq[b][a] + 2.0 * r3 * h[a][b])
                      for a, b in tri])
        gg = mirror([sum(dq[a][c][c] * dq[b][c][c] for c in range(3))
                     + 2.0 * sum(dq[a][c][d] * dq[b][c][d]
                                 for c, d in tri if c != d)
                     for a, b in tri])
        # dqq[a][c][e] = d_a Q_cd Q_de, read for c != e only
        dqq = [[[sum(dq[a][c][d] * q[d][e] for d in range(3))
                 if c != e else None for e in range(3)] for c in range(3)]
               for a in range(3)]

        sth = [[None] * 3 for _ in range(3)]
        for a in range(3):
            for b in range(3):
                c, e = (b + 1) % 3, (b + 2) % 3
                fab = sum(dq[a][c_][d] * dq[c_][b][d]
                          for c_ in range(3) for d in range(3))
                val = (2.0 * xi * (q[a][b] + (r3 if a == b else 0.0)) * qh
                       - sym[a][b]
                       - k0 * sum(dq[a][b][c_] * div[c_] for c_ in range(3))
                       + k1 * (fab - gg[a][b])
                       - 2.0 * k1 * q0 * (dqq[a][c][e] - dqq[a][e][c])
                       + (hq[b][a] - hq[a][b]))
                if a == b:
                    val = val + fed
                sth[a][b] = -val
        return h, sth

    def active_stress(self, fields):
        """Active contribution as a 3x3 list of values, or None when both
        zetas are zero (ref: fe_lc_compute_stress_active, documented
        branch), already sign-flipped for the divergence."""
        if self.zeta0 == 0.0 and self.zeta1 == 0.0:
            return None
        q = q5_to_q33(fields["q"])
        rows = []
        for a in range(3):
            row = []
            for b in range(3):
                val = -self.zeta0 if a == b else 0.0
                row.append(val + self.zeta1 * q[a][b])
            rows.append(row)
        return rows


def redshift_compute(fe: BluePhaseFE, fields, redshift_old: torch.Tensor):
    """The redshift that minimises the gradient free energy of the current
    Q (ref: blue_phase.c:1443 fe_lc_redshift_compute, input key
    lc_redshift_update), with kappa(r) = kappa r^2 and q0(r) = q0 / r and
    the UNREDSHIFTED parameters:

      r_new = -egrad_linear / (2 egrad_square)

    egrad_linear = sum_sites 2 q0 kappa1 sum_ab Q_ab e_agd d_g Q_db
    egrad_square = sum_sites (kappa1 |dQ|^2 - kappa1 dQ:dQ^T
                              + kappa0 (div Q)^2) / 2

    It keeps redshift_old (a 0-d tensor) where the square term vanishes
    or |r_new| < 1e-11.  Two whole-lattice sums on the device, in float64
    whatever Q's dtype, as the reference sums them (a float32 sum's
    rounding depends on the device's order); nothing is read back to the
    host."""
    q = q5_to_q33(fields["q"])
    dq = dq_tensor(fields["grad_q"])  # dq[c][a][b] = d_c Q_ab

    dq0 = 0.0
    for a in range(3):
        s = sum(dq[b][a][b] for b in range(3))
        dq0 = dq0 + s * s
    dq1 = 0.0
    dq2 = 0.0
    dq3 = 0.0
    for a in range(3):
        for b in range(3):
            for g in range(3):
                dq1 = dq1 + dq[g][a][b] * dq[g][a][b]
                dq2 = dq2 + dq[a][b][g] * dq[b][a][g]
            s = 0.0
            for g in range(3):
                for d in range(3):
                    e = eps(a, g, d)
                    if e:
                        s = s + e * dq[g][d][b]
            dq3 = dq3 + q[a][b] * s
    f64 = torch.float64
    e0 = torch.sum(2.0 * fe.q0 * fe.kappa1 * dq3, dtype=f64)
    e1 = torch.sum(0.5 * (fe.kappa1 * dq1 - fe.kappa1 * dq2
                          + fe.kappa0 * dq0), dtype=f64)
    nonzero = e1 != 0.0
    rnew = torch.where(nonzero, -0.5 * e0 / torch.where(nonzero, e1, 1.0),
                       redshift_old.to(f64)).to(redshift_old.dtype)
    return torch.where(torch.abs(rnew) < 1e-11, redshift_old, rnew)
