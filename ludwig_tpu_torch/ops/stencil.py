"""Finite-difference gradient stencils for order-parameter fields.

PyTorch port of the 3d_7pt_fluid part of ludwig_tpu/ops/stencil.py (ref:
src/gradient_3d_7pt_fluid.c).  Fields are (..., X, Y, Z) tensors; stencil
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


def gradient_ops(name: str):
    """(grad, delsq) pair by reference input key fd_gradient_calculation."""
    if name not in _GRADIENTS:
        raise NotImplementedError(
            f"gradient stencil '{name}' is not ported yet (have "
            f"{list(_GRADIENTS)}), see ROADMAP")
    return grad_7pt, delsq_7pt
