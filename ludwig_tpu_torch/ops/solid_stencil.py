"""Solid-aware order-parameter gradients (wetting boundary conditions).

PyTorch port of ludwig_tpu/ops/solid_stencil.py:

* ``solid27_scalar_ops`` - the 27-point predictor-corrector stencil of
  Desplat et al. with the wetting condition gradt = -(C phi_b + H)/kappa
  on links into solid (ref: src/gradient_3d_27pt_solid.c:286-307);
* ``ternary_solid_ops`` - the Semprebon ternary wetting variants with a
  constant prescribed gradient per component: 2-D 9-point D2Q9-weighted
  (ref: src/gradient_2d_ternary_solid.c:210-240) and 3-D 27-point
  count-normalised (ref: src/gradient_3d_ternary_solid.c:230-300).

Each of the 26 (or 8) neighbour
fetches is a roll, solidness a boolean mask per direction, and the
per-direction link values reduce with the reference's normalisers, in
the JAX module's order.  Walls live in the halo (no stored solid sites):
a crossing of a walled face is flagged through edge masks.

The masks, the per-axis link counts and the per-site wetting data seen
from each neighbour are made once, on the device, when the stencil is
built; a call makes no host copy.
"""

from __future__ import annotations

import functools

from typing import Optional, Tuple

import numpy as np
import torch

from ludwig_tpu_torch.ops.stencil import roll3

# The reference link set, in bs_cv order (gradient_3d_27pt_solid.c:58)
BS_CV = [(dx, dy, dz)
         for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
         if not (dx == 0 and dy == 0 and dz == 0)]

# 2-D 9-point set + D2Q9 weights (gradient_2d_ternary_solid.c:44-53)
BS_CV_2D = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
            (1, -1), (1, 0), (1, 1)]
W_2D = [1.0 / 36.0, 4.0 / 36.0, 1.0 / 36.0, 4.0 / 36.0, 4.0 / 36.0,
        1.0 / 36.0, 4.0 / 36.0, 1.0 / 36.0]


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
        keep = _wall_keep(tuple(size), cv3, tuple(walls), str(device))
        if keep is not None:
            nb = nb & keep
        masks.append(nb)
    return masks


@functools.lru_cache(maxsize=256)
def _wall_keep(size, cv3, walls, device) -> Optional[torch.Tensor]:
    """~_wall_cross_mask on `device`, made once (the colloid steps build
    their stencil every step, and a copy from the host would make the
    host wait for the card)."""
    wc = _wall_cross_mask(size, cv3, walls)
    return None if wc is None else torch.as_tensor(~wc, device=device)


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


class TernarySolidOps:
    """(grad, delsq) for one ternary component with the constant wetting
    gradient hrk on links into solid; unpacks as that pair, and
    ``both(phi)`` gives the two from one pass over the links.

    2-D: D2Q9-weighted sums, gradn = sum 3 w cv dphi, delsq = sum 6 w
    dphi (ref: gradient_2d_ternary_solid.c:214-236).  3-D: the
    count-normalised 27-point sums of solid27 with dphi = hrk at solid
    links (ref: gradient_3d_ternary_solid.c:236-300)."""

    def __init__(self, size, hrk: float, fluid=None,
                 walls: Tuple[bool, bool, bool] = (False,) * 3,
                 two_d: bool = False, device=None):
        if device is None:
            device = fluid.device if fluid is not None else "cpu"
        size = tuple(int(n) for n in size)
        self.two_d = two_d
        self.dirs = BS_CV_2D if two_d else BS_CV
        self.masks = _link_masks(size, fluid, walls, self.dirs, device)
        self.hrk = float(hrk)

    def _vals(self, phi):
        hrk = torch.full((), self.hrk, dtype=phi.dtype, device=phi.device)
        out = []
        for p, cv in enumerate(self.dirs):
            cv3 = tuple(cv) + (0,) * (3 - len(cv))
            nb = roll3(phi, tuple(-v for v in cv3))
            out.append(torch.where(self.masks[p], nb - phi, hrk))
        return out

    def _grad(self, v, phi):
        if self.two_d:
            gx = 0.0
            gy = 0.0
            for p, cv in enumerate(BS_CV_2D):
                if cv[0]:
                    gx = gx + 3.0 * W_2D[p] * float(cv[0]) * v[p]
                if cv[1]:
                    gy = gy + 3.0 * W_2D[p] * float(cv[1]) * v[p]
            return torch.stack([gx, gy, torch.zeros_like(phi)])
        comps = []
        for a in range(3):
            acc = 0.0
            for p, cv in enumerate(BS_CV):
                if cv[a]:
                    acc = acc + v[p] * float(cv[a])
            comps.append((1.0 / 18.0) * acc)
        return torch.stack(comps)

    def _delsq(self, v):
        acc = 0.0
        if self.two_d:
            for p in range(8):
                acc = acc + 6.0 * W_2D[p] * v[p]
            return acc
        for p in range(26):
            acc = acc + v[p]
        return (1.0 / 9.0) * acc

    def grad(self, phi):
        return self._grad(self._vals(phi), phi)

    def delsq(self, phi):
        return self._delsq(self._vals(phi))

    def both(self, phi):
        v = self._vals(phi)
        return self._grad(v, phi), self._delsq(v)

    def __iter__(self):
        return iter((self.grad, self.delsq))


def ternary_solid_ops(size, hrk: float, fluid=None,
                      walls: Tuple[bool, bool, bool] = (False,) * 3,
                      two_d: bool = False, device=None) -> TernarySolidOps:
    """(grad, delsq) for one ternary component with constant wetting
    gradient hrk at solid links (TernarySolidOps); fluid: (X, Y, Z) bool
    tensor (True = fluid) or None; device: where the masks live (fluid's
    device by default, else the CPU)."""
    return TernarySolidOps(size, hrk, fluid, walls, two_d, device)
