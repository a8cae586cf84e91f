"""Liquid-crystal droplet free energy: coupled (phi, Q).

PyTorch port of ludwig_tpu/fe/lc_droplet.py (ref: src/lc_droplet.c: fed
:fe_lc_droplet_fed, gamma(phi) = gamma0 + delta (1 + phi), mu
:fe_lc_droplet_mu, molecular field + anchoring
:fe_lc_droplet_mol_field/anchoring_h, body force :820-905):

  f = f_symm(phi) + f_LC(Q; gamma(phi)) + W d_a phi Q_ab d_b phi

Like fe/blue_phase.py, every method but `body_force` is plain Python
arithmetic on "values" (whole tensors in the twins and the unfused step,
symbols in ops/_cuda.py, which traces the same text into the droplet
kernel), in the JAX package's term order, so float64 results agree with
it to the last bits.  A square is written x * x where the JAX text has
x ** 2 (XLA's integer power is that product).  `stress_symm` and
`stress_anti` split the qh stress for `fe_force_method
relaxation_antisymmetric`: the collision relaxes the symmetric part, the
antisymmetric one is divergence-forced.
"""

from __future__ import annotations

import dataclasses

import torch

from ludwig_tpu_torch.fe.blue_phase import (BluePhaseFE, dq_tensor, eps,
                                            q5_to_q33)
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.ops.force import correct_momentum
from ludwig_tpu_torch.ops.stencil import grad_7pt


@dataclasses.dataclass(frozen=True)
class LCDropletFE:
    symm: SymmetricFE
    lc: BluePhaseFE            # its gamma is overridden by gamma(phi)
    gamma0: float
    delta: float
    w: float                   # anchoring coupling
    zeta0: float = 0.0         # active stress (in the active phase)
    zeta1: float = 0.0

    def gamma(self, phi):
        return self.gamma0 + self.delta * (1.0 + phi)

    # fields: phi, grad_phi (3), delsq_phi, dab_phi (3x3), q (5),
    #         grad_q (3 x 5), delsq_q (5): tensors or nested lists

    def fed(self, fields):
        phi = fields["phi"]
        dphi = fields["grad_phi"]
        q = q5_to_q33(fields["q"])
        f_s = self.symm.fed(fields)
        f_lc = _lc_fed_gamma(self.lc, self.gamma(phi), fields)
        anch = 0.0
        for a in range(3):
            for b in range(3):
                anch = anch + q[a][b] * dphi[a] * dphi[b]
        return f_s + f_lc + self.w * anch

    def mu(self, fields):
        """Chemical potential for the CH update (ref: fe_lc_droplet_mu)."""
        q = q5_to_q33(fields["q"])
        dq = dq_tensor(fields["grad_q"])
        dphi = fields["grad_phi"]
        dab = fields["dab_phi"]
        mu = self.symm.mu(fields)
        q2 = sum(q[a][b] * q[a][b] for a in range(3) for b in range(3))
        q3 = sum(q[a][b] * q[b][c] * q[a][c]
                 for a in range(3) for b in range(3) for c in range(3))
        wmu = 0.0
        for a in range(3):
            for b in range(3):
                wmu = wmu + dphi[a] * dq[b][a][b] + q[a][b] * dab[a][b]
        a0 = self.lc.a0
        r3 = 1.0 / 3.0
        return (mu - 0.5 * r3 * a0 * self.delta * q2
                - r3 * a0 * self.delta * q3
                + 0.25 * a0 * self.delta * q2 * q2
                - 2.0 * self.w * wmu)

    def molecular_field(self, fields):
        """h (3x3 list) with gamma(phi) plus the anchoring part
        (ref: fe_lc_droplet_mol_field, anchoring_h)."""
        h = _lc_h_gamma(self.lc, self.gamma(fields["phi"]), fields)
        dphi = fields["grad_phi"]
        dphi2 = dphi[0] * dphi[0] + dphi[1] * dphi[1] + dphi[2] * dphi[2]
        r3 = 1.0 / 3.0
        for a in range(3):
            for b in range(3):
                h[a][b] = h[a][b] - self.w * (
                    dphi[a] * dphi[b] - (r3 * dphi2 if a == b else 0.0))
        return h

    def stress_qh(self, fields, h=None):
        """-(symmetric xi terms + antisymmetric qh terms + active) as a
        3x3 list; the isotropic p0 is handled by the body force (ref:
        fe_lc_droplet_str_symm/str_anti)."""
        phi = fields["phi"]
        q = q5_to_q33(fields["q"])
        if h is None:
            h = self.molecular_field(fields)
        xi = self.lc.xi
        r3 = 1.0 / 3.0
        qh = sum(q[a][b] * h[a][b] for a in range(3) for b in range(3))
        fphi = 0.5 * (1.0 + phi)
        rows = []
        for a in range(3):
            row = []
            for b in range(3):
                v = 2.0 * xi * (q[a][b] + (r3 if a == b else 0.0)) * qh
                for c in range(3):
                    v = v - xi * h[a][c] * (q[b][c] + (r3 if b == c else 0.0))
                    v = v - xi * (q[a][c] + (r3 if a == c else 0.0)) * h[b][c]
                    v = v + q[a][c] * h[b][c] - h[a][c] * q[b][c]
                # active stress gated by phase (ref: active_stress); a
                # traced parameter is always true, so the kernel adds the
                # term, an exact zero when both zetas are
                if self.zeta0 or self.zeta1:
                    v = v + fphi * (-(r3 * self.zeta0 if a == b else 0.0)
                                    - self.zeta1 * q[a][b])
                row.append(-v)
            rows.append(row)
        return rows

    def stress_symm(self, fields, h=None):
        """Symmetric part of the qh stress with the active term, a 3x3
        list (ref: lc_droplet.c fe_lc_droplet_str_symm)."""
        phi = fields["phi"]
        q = q5_to_q33(fields["q"])
        if h is None:
            h = self.molecular_field(fields)
        xi = self.lc.xi
        r3 = 1.0 / 3.0
        qh = sum(q[a][b] * h[a][b] for a in range(3) for b in range(3))
        fphi = 0.5 * (1.0 + phi)
        rows = []
        for a in range(3):
            row = []
            for b in range(3):
                v = 2.0 * xi * (q[a][b] + (r3 if a == b else 0.0)) * qh
                for c in range(3):
                    v = v - xi * h[a][c] * (q[b][c] + (r3 if b == c else 0.0))
                    v = v - xi * (q[a][c] + (r3 if a == c else 0.0)) * h[b][c]
                if self.zeta0 or self.zeta1:
                    v = v + fphi * (-(r3 * self.zeta0 if a == b else 0.0)
                                    - self.zeta1 * q[a][b])
                row.append(-v)
            rows.append(row)
        return rows

    def stress_anti(self, fields, h=None):
        """Antisymmetric qh stress -(q_ac h_bc - h_ac q_bc), a 3x3 list
        (ref: lc_droplet.c fe_lc_droplet_str_anti)."""
        q = q5_to_q33(fields["q"])
        if h is None:
            h = self.molecular_field(fields)
        rows = []
        for a in range(3):
            row = []
            for b in range(3):
                v = sum(q[a][c] * h[b][c] - h[a][c] * q[b][c]
                        for c in range(3))
                row.append(-v)
            rows.append(row)
        return rows

    def body_force(self, fields, mu, h) -> torch.Tensor:
        """F_a = -phi d_a mu - h_bc d_a Q_bc (ref: bf_kernel :820-905),
        (3, X, Y, Z), less its mean over the lattice (the momentum
        correction)."""
        phi = fields["phi"]
        dq = dq_tensor(fields["grad_q"])
        gmu = grad_7pt(mu)
        comps = []
        for a in range(3):
            v = -phi * gmu[a]
            for b in range(3):
                for c in range(3):
                    v = v - h[b][c] * dq[a][b][c]
            comps.append(v)
        return correct_momentum(torch.stack(comps))


def _lc_fed_gamma(lc: BluePhaseFE, gamma, fields):
    """Blue-phase fed with a (possibly spatially varying) gamma."""
    q = q5_to_q33(fields["q"])
    dq = dq_tensor(fields["grad_q"])
    q0, k0, k1 = lc._rr
    q2 = sum(q[a][b] * q[a][b] for a in range(3) for b in range(3))
    q3 = sum(q[a][b] * q[b][c] * q[a][c]
             for a in range(3) for b in range(3) for c in range(3))
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
    r3 = 1.0 / 3.0
    return (0.5 * lc.a0 * (1.0 - r3 * gamma) * q2
            - r3 * lc.a0 * gamma * q3
            + 0.25 * lc.a0 * gamma * q2 * q2
            + 0.5 * k0 * dq0 + 0.5 * k1 * dq1)


def _lc_h_gamma(lc: BluePhaseFE, gamma, fields):
    """Blue-phase molecular field (3x3 list) with a spatially varying
    gamma (BluePhaseFE.molecular_field with gamma a value)."""
    q = q5_to_q33(fields["q"])
    dq = dq_tensor(fields["grad_q"])
    dsq = q5_to_q33(fields["delsq_q"])
    q0, k0, k1 = lc._rr
    a0 = lc.a0
    r3 = 1.0 / 3.0
    q2 = sum(q[a][b] * q[a][b] for a in range(3) for b in range(3))
    h = [[None] * 3 for _ in range(3)]
    for a in range(3):
        for b in range(3):
            s = sum(q[a][c] * q[b][c] for c in range(3))
            h[a][b] = (-a0 * (1.0 - r3 * gamma) * q[a][b]
                       + a0 * gamma * (s - (r3 * q2 if a == b else 0.0))
                       - a0 * gamma * q2 * q[a][b])
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
            v = (h[a][b] + k0 * dsq[a][b] - 2.0 * k1 * q0 * s
                 - 4.0 * k1 * q0 * q0 * q[a][b])
            if a == b:
                v = v + 4.0 * r3 * k1 * q0 * eq
            h[a][b] = v
    return h
