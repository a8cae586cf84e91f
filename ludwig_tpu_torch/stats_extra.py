"""Shear observables: the mean-stress xz section.

PyTorch port of RheologyAccumulator of ludwig_tpu/stats_extra.py (ref:
stats_rheology.c:54-55 NSTAT2, :332-425
stats_rheology_stress_profile_accumulate, stats_rheology_stress_section),
switched on by the input keys freq_shear_measurement and
freq_shear_output.  The accumulator lives on the state's device in
float64 (the JAX package copies f to the host and sums in numpy float64);
a measurement reduces over y there, and only the (X, Z) section crosses
to the host, when a file is written.
"""

from __future__ import annotations

import numpy as np
import torch

TRIU = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


class RheologyAccumulator:
    """22 data items per (x, z) point, accumulated over y and time: 6
    components each of the measured second moment minus rho u u (the
    viscous stress up to a factor applied at output), the thermodynamic
    stress and rho u u; then the 3 velocity components; slot 21 is the
    reference's zero placeholder for the isotropic chemical stress."""

    def __init__(self, size, device="cuda"):
        self.size = tuple(size)
        self.stat = torch.zeros((self.size[0], self.size[2], 22),
                                dtype=torch.float64, device=device)
        self.count = 0

    def accumulate(self, f: torch.Tensor, model, pth=None):
        """Add one measurement of f (nvel, X, Y, Z) and, for a free energy
        with one, its thermodynamic stress pth (3, 3, X, Y, Z).  The sums
        over the velocities and over y run in order, one term after the
        other, as the JAX package's numpy sums take them."""
        f = f.to(torch.float64)
        cv = np.asarray(model.cv)

        def moment(weights):
            acc = None
            for p, w in enumerate(weights):
                if w:
                    term = f[p] if w == 1 else w * f[p]
                    acc = term if acc is None else acc + term
            return torch.zeros_like(f[0]) if acc is None else acc

        rho = moment(np.ones(len(cv)))
        mom = [moment(cv[:, a]) for a in range(3)]
        v = [m / rho for m in mom]
        cols = [moment(cv[:, a] * cv[:, b]) - v[a] * mom[b]
                for a, b in TRIU]
        if pth is None:
            cols += [torch.zeros_like(rho)] * 6
        else:
            pth = pth.to(torch.float64)
            cols += [pth[a, b] for a, b in TRIU]
        cols += [v[a] * mom[b] for a, b in TRIU]
        cols += v
        site = torch.stack(cols, dim=-1)               # (X, Y, Z, 21)
        acc = site[:, 0]
        for y in range(1, site.shape[1]):
            acc = acc + site[:, y]
        self.stat[:, :, :21] += acc
        self.count += 1

    def zero(self):
        self.stat.zero_()
        self.count = 0

    def write_section(self, path: str, eta: float):
        """str-%8.8d.dat: z runs fastest, 22 columns ' %15.8e' (ref:
        stats_rheology_stress_section; the viscous factor is -rcs2 eta /
        tau = -3 eta 2 / (1 + 6 eta))."""
        viscous = -3.0 * eta * 2.0 / (1.0 + 6.0 * eta)
        ravg = (1.0 / (self.size[1] * self.count)) if self.count else 0.0
        dat = self.stat.cpu().numpy() * ravg
        dat[:, :, :6] *= viscous
        with open(path, "w") as fh:
            for i in range(self.size[0]):
                for k in range(self.size[2]):
                    fh.write("".join(f" {x:15.8e}" for x in dat[i, k]))
                    fh.write("\n")
