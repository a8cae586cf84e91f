"""Finite-difference gradient stencils for order-parameter fields.

PyTorch port of the 3d_7pt_fluid part of ludwig_tpu/ops/stencil.py (ref:
src/gradient_3d_7pt_fluid.c) and of its d_a d_b stencil ``dab_7pt``.
Fields are (..., X, Y, Z) tensors; stencil
shifts are ``torch.roll`` (periodic).  ``gradient_ops`` selects a stencil
by the reference's ``fd_gradient_calculation`` input string; the other
stencils of the JAX package are not ported yet.
"""

from __future__ import annotations

import torch

_GRADIENTS = ("3d_7pt_fluid",)


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


def gradient_ops(name: str):
    """(grad, delsq) pair by reference input key fd_gradient_calculation."""
    if name not in _GRADIENTS:
        raise NotImplementedError(
            f"gradient stencil '{name}' is not ported yet (have "
            f"{list(_GRADIENTS)}), see ROADMAP")
    return grad_7pt, delsq_7pt
