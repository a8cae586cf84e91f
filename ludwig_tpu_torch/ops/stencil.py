"""Finite-difference gradient stencils for order-parameter fields.

PyTorch port of ludwig_tpu/ops/stencil.py (ref: src/field_grad.c:305,
src/gradient_3d_7pt_fluid.c, gradient_3d_27pt_fluid.c,
gradient_2d_5pt_fluid.c, gradient_d3q27.c, gradient_2d_tomita_fluid.c,
the 7-point solid stencil of gradient_3d_27pt_solid.c's wetting rule).
Fields are (..., X, Y, Z) tensors; stencil shifts are ``torch.roll``
(periodic).  ``gradient_ops`` selects a stencil by the reference's
``fd_gradient_calculation`` input string.  Every stencil sums its terms
in the JAX module's order, so float64 results agree to the last places.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ludwig_tpu_torch.lattice import lb_model


def roll3(x: torch.Tensor, shift, first_axis: int = 0) -> torch.Tensor:
    """Roll the three trailing-spatial axes by integer (sx, sy, sz)."""
    shift = tuple(int(s) for s in shift)
    if not any(shift):
        return x
    dims = tuple(first_axis + i for i in range(3) if shift[i] != 0)
    shifts = tuple(s for s in shift if s != 0)
    return torch.roll(x, shifts, dims)


def _shift(phi, sx, sy, sz):
    # spatial axes are the last three
    return roll3(phi, (sx, sy, sz), first_axis=phi.dim() - 3)


def grad_7pt(phi: torch.Tensor) -> torch.Tensor:
    """Central-difference gradient, 7-point (ref: gradient_3d_7pt_fluid.c).

    phi: (..., X, Y, Z) -> (3, ..., X, Y, Z).  roll(+1) brings the (i-1)
    value to site i.
    """
    gx = 0.5 * (_shift(phi, -1, 0, 0) - _shift(phi, 1, 0, 0))
    gy = 0.5 * (_shift(phi, 0, -1, 0) - _shift(phi, 0, 1, 0))
    gz = 0.5 * (_shift(phi, 0, 0, -1) - _shift(phi, 0, 0, 1))
    return torch.stack([gx, gy, gz])


def delsq_7pt(phi: torch.Tensor) -> torch.Tensor:
    """7-point Laplacian: sum of 6 neighbours - 6 phi."""
    return (_shift(phi, 1, 0, 0) + _shift(phi, -1, 0, 0)
            + _shift(phi, 0, 1, 0) + _shift(phi, 0, -1, 0)
            + _shift(phi, 0, 0, 1) + _shift(phi, 0, 0, -1)
            - 6.0 * phi)


def grad_2d_5pt(phi: torch.Tensor) -> torch.Tensor:
    gx = 0.5 * (_shift(phi, -1, 0, 0) - _shift(phi, 1, 0, 0))
    gy = 0.5 * (_shift(phi, 0, -1, 0) - _shift(phi, 0, 1, 0))
    return torch.stack([gx, gy, torch.zeros_like(phi)])


def delsq_2d_5pt(phi: torch.Tensor) -> torch.Tensor:
    return (_shift(phi, 1, 0, 0) + _shift(phi, -1, 0, 0)
            + _shift(phi, 0, 1, 0) + _shift(phi, 0, -1, 0)
            - 4.0 * phi)


def grad27_terms(v, phi0):
    """Reference-exact 27-point gradient + Laplacian given a neighbour
    fetch v(dx, dy, dz); the term order matches the reference expression
    chains (ref: gradient_3d_27pt_fluid.c grad/del2 stencils)."""
    r9 = 1.0 / 9.0
    gx = (+ v(1, -1, -1) - v(-1, -1, -1) + v(1, -1, 0) - v(-1, -1, 0)
          + v(1, -1, 1) - v(-1, -1, 1) + v(1, 0, -1) - v(-1, 0, -1)
          + v(1, 0, 0) - v(-1, 0, 0) + v(1, 0, 1) - v(-1, 0, 1)
          + v(1, 1, -1) - v(-1, 1, -1) + v(1, 1, 0) - v(-1, 1, 0)
          + v(1, 1, 1) - v(-1, 1, 1))
    gy = (+ v(-1, 1, -1) - v(-1, -1, -1) + v(-1, 1, 0) - v(-1, -1, 0)
          + v(-1, 1, 1) - v(-1, -1, 1) + v(0, 1, -1) - v(0, -1, -1)
          + v(0, 1, 0) - v(0, -1, 0) + v(0, 1, 1) - v(0, -1, 1)
          + v(1, 1, -1) - v(1, -1, -1) + v(1, 1, 0) - v(1, -1, 0)
          + v(1, 1, 1) - v(1, -1, 1))
    gz = (+ v(-1, -1, 1) - v(-1, -1, -1) + v(-1, 0, 1) - v(-1, 0, -1)
          + v(-1, 1, 1) - v(-1, 1, -1) + v(0, -1, 1) - v(0, -1, -1)
          + v(0, 0, 1) - v(0, 0, -1) + v(0, 1, 1) - v(0, 1, -1)
          + v(1, -1, 1) - v(1, -1, -1) + v(1, 0, 1) - v(1, 0, -1)
          + v(1, 1, 1) - v(1, 1, -1))
    d2 = (+ v(-1, -1, -1) + v(-1, -1, 0) + v(-1, -1, 1)
          + v(-1, 0, -1) + v(-1, 0, 0) + v(-1, 0, 1)
          + v(-1, 1, -1) + v(-1, 1, 0) + v(-1, 1, 1)
          + v(0, -1, -1) + v(0, -1, 0) + v(0, -1, 1)
          + v(0, 0, -1) + v(0, 0, 1)
          + v(0, 1, -1) + v(0, 1, 0) + v(0, 1, 1)
          + v(1, -1, -1) + v(1, -1, 0) + v(1, -1, 1)
          + v(1, 0, -1) + v(1, 0, 0) + v(1, 0, 1)
          + v(1, 1, -1) + v(1, 1, 0) + v(1, 1, 1)
          - 26.0 * phi0)
    return 0.5 * r9 * gx, 0.5 * r9 * gy, 0.5 * r9 * gz, r9 * d2


def _fetch27(phi):
    """v(dx, dy, dz): the value at the site + (dx, dy, dz), each shift
    made once."""
    cache = {}

    def v(dx, dy, dz):
        key = (dx, dy, dz)
        if key not in cache:
            cache[key] = _shift(phi, -dx, -dy, -dz)
        return cache[key]
    return v


def grad_27pt(phi: torch.Tensor) -> torch.Tensor:
    """27-point isotropic gradient (ref: gradient_3d_27pt_fluid.c)."""
    gx, gy, gz, _ = grad27_terms(_fetch27(phi), phi)
    return torch.stack([gx, gy, gz])


def delsq_27pt(phi: torch.Tensor) -> torch.Tensor:
    """27-point isotropic Laplacian (ref: gradient_3d_27pt_fluid.c)."""
    return grad27_terms(_fetch27(phi), phi)[3]


def dab_7pt(phi: torch.Tensor):
    """Second-derivative tensor d_a d_b phi as a 3x3 list of tensors:
    central second differences on the diagonal, cross differences of the
    12 edge neighbours off it (ref: field_grad_scalar_dab).  The list is
    symmetric: [b][a] is the same tensor as [a][b]."""
    def sh(*s):
        return _shift(phi, *s)

    rows = [[None] * 3 for _ in range(3)]
    offs = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
    for a in range(3):
        oa = offs[a]
        rows[a][a] = sh(*[-v for v in oa]) - 2.0 * phi + sh(*oa)
        for b in range(a + 1, 3):
            ob = offs[b]
            pp = sh(*[-(oa[i] + ob[i]) for i in range(3)])
            pm = sh(*[-(oa[i] - ob[i]) for i in range(3)])
            mp = sh(*[(oa[i] - ob[i]) for i in range(3)])
            mm = sh(*[(oa[i] + ob[i]) for i in range(3)])
            rows[a][b] = 0.25 * (pp - pm - mp + mm)
            rows[b][a] = rows[a][b]
    return rows


def _d3q27_terms(phi):
    """Weighted D3Q27 neighbour differences (ref: gradient_d3q27.c:112-124:
    grad_a = sum_p 3 w_p (phi(r+c_p) - phi) c_pa,
    delsq  = sum_p 6 w_p (phi(r+c_p) - phi))."""
    model = lb_model(27)
    gx = gy = gz = d2 = 0.0
    for p in range(1, 27):
        c = model.cv[p]
        w = float(model.wv[p])
        dphi = _shift(phi, *(-int(v) for v in c)) - phi
        if c[0]:
            gx = gx + 3.0 * w * float(c[0]) * dphi
        if c[1]:
            gy = gy + 3.0 * w * float(c[1]) * dphi
        if c[2]:
            gz = gz + 3.0 * w * float(c[2]) * dphi
        d2 = d2 + 6.0 * w * dphi
    return gx, gy, gz, d2


def grad_d3q27(phi):
    gx, gy, gz, _ = _d3q27_terms(phi)
    return torch.stack([gx, gy, gz])


def delsq_d3q27(phi):
    return _d3q27_terms(phi)[3]


def _tomita_terms(phi, epsilon=0.25, epsilon1=0.25):
    """2-D Tomita stencil.

    The reference has two parameterisations, picked by whether the
    field was created with a Lees-Edwards object (always true for the
    symmetric phi, ludwig.c:1185):
      le==NULL -> grad_cs_kernel, GRAD_EPSILON = DEL2_EPSILON = 0.25
                  (ref: gradient_2d_tomita_fluid.c:58-66,109)
      le!=NULL -> grad_2d_tomita_fluid_operator, grad epsilon1_ = 0.25
                  but delsq epsilon_ = 0.5 (same file :53-54,283-333)."""
    rf = 1.0 / (1.0 + 2.0 * epsilon)
    rf1 = 1.0 / (1.0 + 2.0 * epsilon1)

    def at(dx, dy):
        # value at (x+dx, y+dy)
        return _shift(phi, -dx, -dy, 0)

    delsq = rf * (at(1, 0) + at(-1, 0) + at(0, 1) + at(0, -1)
                  + epsilon * (at(1, 1) + at(1, -1) + at(-1, 1)
                               + at(-1, -1))
                  - 4.0 * (1.0 + epsilon) * phi)
    gx = 0.5 * rf1 * ((at(1, 0) - at(-1, 0))
                      + epsilon1 * ((at(1, 1) - at(-1, 1))
                                    + (at(1, -1) - at(-1, -1))))
    gy = 0.5 * rf1 * ((at(0, 1) - at(0, -1))
                      + epsilon1 * ((at(1, 1) - at(1, -1))
                                    + (at(-1, 1) - at(-1, -1))))
    return gx, gy, delsq


def grad_tomita(phi):
    gx, gy, _ = _tomita_terms(phi)
    return torch.stack([gx, gy, torch.zeros_like(phi)])


def delsq_tomita(phi):
    return _tomita_terms(phi)[2]


def delsq_tomita_le(phi):
    # the LE-object parameterisation (epsilon_ = 0.5 for delsq only)
    return _tomita_terms(phi, epsilon=0.5)[2]


_GRAD: Dict[str, Callable] = {
    "3d_7pt_fluid": grad_7pt,
    "3d_27pt_fluid": grad_27pt,
    "2d_5pt_fluid": grad_2d_5pt,
    "dm3q27": grad_d3q27,
    "2d_tomita_fluid": grad_tomita,
}
_DELSQ: Dict[str, Callable] = {
    "3d_7pt_fluid": delsq_7pt,
    "3d_27pt_fluid": delsq_27pt,
    "2d_5pt_fluid": delsq_2d_5pt,
    "dm3q27": delsq_d3q27,
    "2d_tomita_fluid": delsq_tomita,
}
GRADIENTS = tuple(_GRAD)


def gradient_ops(name: str, le_field: bool = False):
    """(grad, delsq) pair by reference input key fd_gradient_calculation.

    le_field selects the reference's LE-object code path where the two
    differ: for 2d_tomita the delsq switches to the epsilon = 0.5
    parameterisation (see _tomita_terms)."""
    if name not in _GRAD:
        raise ValueError(f"unknown gradient stencil '{name}'; "
                         f"have {sorted(_GRAD)}")
    if le_field and name == "2d_tomita_fluid":
        return _GRAD[name], delsq_tomita_le
    return _GRAD[name], _DELSQ[name]


_OFFS = ((1, 0, 0), (0, 1, 0), (0, 0, 1))


class SolidGradientOps:
    """Solid-aware 7-point (grad, delsq) with the wetting boundary
    condition (ref: gradient_3d_27pt_solid.c:286 gradt = -(C phi_b +
    H)/kappa for links into solid; the 7-point variant of the same
    rule).  Unpacks as the pair (grad, delsq); ``both(phi)`` gives the
    two from one pass.

    c = h = 0 gives neutral wetting (zero normal gradient, 90-degree
    contact angle).  c, h are scalars, or (X, Y, Z) tensors carrying
    per-site map wetting data at the SOLID sites (looked up at the
    neighbour).  The shifted solid masks and wetting data are made once
    here, on the mask's device."""

    def __init__(self, solid: torch.Tensor, kappa: float, c=0.0, h=0.0):
        self.rk = 1.0 / kappa
        self.per_site = not (isinstance(c, (int, float))
                             and isinstance(h, (int, float)))
        self.c, self.h = c, h
        self.s_up = [roll3(solid, tuple(-v for v in o)) for o in _OFFS]
        self.s_dn = [roll3(solid, o) for o in _OFFS]
        if self.per_site:
            c, h = torch.as_tensor(c), torch.as_tensor(h)
            self.ch_up = [(roll3(c, tuple(-v for v in o)),
                           roll3(h, tuple(-v for v in o))) for o in _OFFS]
            self.ch_dn = [(roll3(c, o), roll3(h, o)) for o in _OFFS]

    def _dirs(self, phi):
        ups, dns = [], []
        for i, o in enumerate(_OFFS):
            nb_up = _shift(phi, *[-v for v in o])
            nb_dn = _shift(phi, *o)
            if self.per_site:
                cu, hu = self.ch_up[i]
                cd, hd = self.ch_dn[i]
                bc_up = -(cu * phi + hu) * self.rk
                bc_dn = -(cd * phi + hd) * self.rk
            else:
                bc_up = bc_dn = -(self.c * phi + self.h) * self.rk
            ups.append(torch.where(self.s_up[i], bc_up, nb_up - phi))
            dns.append(torch.where(self.s_dn[i], bc_dn, nb_dn - phi))
        return ups, dns

    @staticmethod
    def _grad(ups, dns):
        return torch.stack([0.5 * (u - d) for u, d in zip(ups, dns)])

    @staticmethod
    def _delsq(ups, dns):
        return sum(u + d for u, d in zip(ups, dns))

    def grad(self, phi):
        return self._grad(*self._dirs(phi))

    def delsq(self, phi):
        return self._delsq(*self._dirs(phi))

    def both(self, phi):
        ups, dns = self._dirs(phi)
        return self._grad(ups, dns), self._delsq(ups, dns)

    def __iter__(self):
        return iter((self.grad, self.delsq))


def solid_gradient_ops(solid, kappa: float, c=0.0, h=0.0):
    """The solid-aware 7-point stencil pair (SolidGradientOps)."""
    return SolidGradientOps(solid, kappa, c, h)
