"""Solid-aware order-parameter gradients (wetting boundary conditions).

PyTorch port of ``solid27_scalar_ops`` of ludwig_tpu/ops/solid_stencil.py:
the 27-point predictor-corrector stencil of Desplat et al. with the
wetting condition gradt = -(C phi_b + H)/kappa on links into solid (ref:
src/gradient_3d_27pt_solid.c:286-307).  Each of the 26 neighbour
fetches is a roll, solidness a boolean mask per direction, and the
per-direction link values reduce with the reference's normalisers, in
the JAX module's order.  Walls live in the halo (no stored solid sites):
a crossing of a walled face is flagged through edge masks.

The masks, the per-axis link counts and the per-site wetting data seen
from each neighbour are made once, on the device, when the stencil is
built; a call makes no host copy.  The ternary variants of the JAX
module wait for the ternary free energy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ludwig_tpu_torch.ops.stencil import roll3

# The reference link set, in bs_cv order (gradient_3d_27pt_solid.c:58)
BS_CV = [(dx, dy, dz)
         for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
         if not (dx == 0 and dy == 0 and dz == 0)]


def _wall_cross_mask(size, cv, walls) -> Optional[np.ndarray]:
    """True where stepping by cv crosses a walled face (into the halo)."""
    m = None
    for ax in range(3):
        if not walls[ax] or cv[ax] == 0:
            continue
        idx = np.zeros(size, bool)
        sl = [slice(None)] * 3
        sl[ax] = size[ax] - 1 if cv[ax] > 0 else 0
        idx[tuple(sl)] = True
        m = idx if m is None else (m | idx)
    return m


def _link_masks(size, fluid, walls, dirs, device):
    """Per-direction boolean tensor on `device`: the neighbour is a FLUID
    site (fluid: (X, Y, Z) bool tensor or None)."""
    masks = []
    for cv in dirs:
        cv3 = tuple(cv) + (0,) * (3 - len(cv))
        if fluid is not None:
            nb = roll3(fluid, tuple(-v for v in cv3)).to(device)
        else:
            nb = torch.ones(size, dtype=torch.bool, device=device)
        wc = _wall_cross_mask(size, cv3, walls)
        if wc is not None:
            nb = nb & torch.as_tensor(~wc, device=device)
        masks.append(nb)
    return masks


class Solid27Ops:
    """(grad, delsq) with the 27-point wetting boundary condition; unpacks
    as that pair, and ``both(phi)`` gives the two from one pass over the
    26 links (site values at solid sites are irrelevant downstream but
    stay finite)."""

    def __init__(self, size, fluid=None,
                 walls: Tuple[bool, bool, bool] = (False,) * 3,
                 rkappa: float = 0.0, c=0.0, h=0.0, device=None):
        if device is None:
            device = fluid.device if fluid is not None else "cpu"
        size = tuple(int(n) for n in size)
        self.masks = _link_masks(size, fluid, walls, BS_CV, device)
        # link counts per axis (small integers: exact in any dtype)
        self.cnt = []
        for a in range(3):
            cnt = torch.zeros(size, dtype=torch.float64, device=device)
            for p, cv in enumerate(BS_CV):
                if cv[a]:
                    cnt = cnt + self.masks[p].to(torch.float64)
            self.cnt.append(cnt)
        self._cnt = {}
        self.rkappa = rkappa
        self.scalar = (isinstance(c, (int, float))
                       and isinstance(h, (int, float)))
        if self.scalar:
            self.cb = [c] * 26
            self.hb = [h] * 26
        else:
            # the wetting data of the SOLID neighbour across each link
            self.cb = [c if isinstance(c, (int, float))
                       else roll3(torch.as_tensor(c, device=device),
                                  tuple(-v for v in cv)) for cv in BS_CV]
            self.hb = [h if isinstance(h, (int, float))
                       else roll3(torch.as_tensor(h, device=device),
                                  tuple(-v for v in cv)) for cv in BS_CV]

    def _counts(self, dtype):
        """Per axis (count > 0, the count where it is and 1 elsewhere) in
        the field's dtype, made once."""
        if dtype not in self._cnt:
            self._cnt[dtype] = [
                (c > 0.0, torch.where(c > 0.0, c, torch.ones_like(c))
                 .to(dtype)) for c in self.cnt]
        return self._cnt[dtype]

    def _gradt(self, phi):
        masks = self.masks
        zero = torch.zeros((), dtype=phi.dtype, device=phi.device)
        nbs = [roll3(phi, tuple(-v for v in cv)) for cv in BS_CV]
        dphi = [torch.where(masks[p], nbs[p] - phi, zero)
                for p in range(26)]
        gradn = []
        for a in range(3):
            num = 0.0
            for p, cv in enumerate(BS_CV):
                if cv[a]:
                    num = num + float(cv[a]) * dphi[p]
            pos, cnt = self._counts(phi.dtype)[a]
            gradn.append(torch.where(pos, num / cnt, zero))
        out = []
        for p, cv in enumerate(BS_CV):
            phi_b = phi + 0.5 * sum(float(cv[a]) * gradn[a]
                                    for a in range(3) if cv[a])
            bc = -(self.cb[p] * phi_b + self.hb[p]) * self.rkappa
            out.append(torch.where(masks[p], dphi[p], bc))
        return out

    @staticmethod
    def _grad(gt):
        r18 = 1.0 / 18.0
        comps = []
        for a in range(3):
            acc = 0.0
            for p, cv in enumerate(BS_CV):
                if cv[a]:
                    acc = acc + gt[p] * float(cv[a])
            comps.append(r18 * acc)
        return torch.stack(comps)

    @staticmethod
    def _delsq(gt):
        acc = 0.0
        for p in range(26):
            acc = acc + gt[p]
        return (1.0 / 9.0) * acc

    def grad(self, phi):
        return self._grad(self._gradt(phi))

    def delsq(self, phi):
        return self._delsq(self._gradt(phi))

    def both(self, phi):
        gt = self._gradt(phi)
        return self._grad(gt), self._delsq(gt)

    def __iter__(self):
        return iter((self.grad, self.delsq))


def solid27_scalar_ops(size, fluid=None,
                       walls: Tuple[bool, bool, bool] = (False,) * 3,
                       rkappa: float = 0.0, c=0.0, h=0.0, device=None):
    """(grad, delsq) with the 27-point wetting boundary condition.

    fluid: (X, Y, Z) bool tensor (True = fluid), or None when only walls
    bound the domain.  c, h: wetting parameters - scalars, or (X, Y, Z)
    tensors holding per-site map data at the SOLID sites (ref: map
    wetting data; looked up at the neighbour).  rkappa = 1/kappa of the
    symmetric free energy.  device: where the masks live (fluid's
    device by default, else the CPU)."""
    return Solid27Ops(size, fluid, walls, rkappa, c, h, device)
