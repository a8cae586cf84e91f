"""Polar active gel simulation: vector order parameter P + LB.

PyTorch port of ludwig_tpu/polar.py (ref: src/ludwig.c polar branch:
field_grad(p) -> stress-divergence force -> leslie_ericksen_update ->
collide -> stream; initialisation src/polar_active_rt.c:156 aster).  The
state is (f, p, u), the JAX package's order; a step runs eagerly on the
state's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ludwig_tpu_torch.dynamics.leslie_ericksen import (LeslieEricksenParams,
                                                       leslie_ericksen_update)
from ludwig_tpu_torch.fe.polar_active import PolarActiveFE
from ludwig_tpu_torch.lb import LBConfig, initial_rest
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.force import stress_divergence_force
from ludwig_tpu_torch.ops.stencil import gradient_ops
from ludwig_tpu_torch.ops.stream import stream_bounce_back


@dataclasses.dataclass(frozen=True)
class PolarConfig:
    lb: LBConfig
    fe: PolarActiveFE
    gamma: float = 0.3            # rotational mobility (leslie_ericksen_gamma)
    swim: float = 0.0
    advection_order: int = 1
    gradient: str = "3d_7pt_fluid"
    hydrodynamics: bool = True


def polar_fields(p, gradient: str):
    grad, delsq = gradient_ops(gradient)
    return {"p": p, "grad_p": grad(p), "delsq_p": delsq(p)}


def make_polar_step(cfg: PolarConfig, solid=None):
    """Step: ((f, p, u), t=0) -> (state', rho); solid: in-lattice solid
    sites (walls kept as solid planes, porous media)."""
    params = cfg.lb.collision_params()
    model = cfg.lb.model
    le = LeslieEricksenParams(gamma=cfg.gamma, lambda_=cfg.fe.lambda_,
                              swim=cfg.swim,
                              advection_order=cfg.advection_order)
    fluid = None if solid is None else torch.logical_not(solid)

    def step(state, t=0):
        f, p, u = state
        fields = polar_fields(p, cfg.gradient)
        h = cfg.fe.molecular_field(fields)
        if not cfg.hydrodynamics:
            p = leslie_ericksen_update(p, h, None, le)
            return (f, p, u), torch.ones_like(p[0])
        force = stress_divergence_force(cfg.fe.stress(fields, h=h)).to(f.dtype)
        p = leslie_ericksen_update(p, h, u, le)
        f, rho, u_new = collide(f, params, force=force, fluid_mask=fluid)
        f = stream_bounce_back(f, model, solid=solid, rho0=cfg.lb.rho0)
        return (f, p, u_new), rho

    return step


def initial_polar(cfg: PolarConfig, p0):
    """(f at rest, p0, u = 0) on the configuration's device."""
    lb = cfg.lb
    p = torch.as_tensor(np.asarray(p0), dtype=lb.tdtype,
                        device=lb.device).contiguous()
    u = torch.zeros((3,) + tuple(lb.size), dtype=lb.tdtype, device=lb.device)
    return (initial_rest(lb), p, u)


def polar_init_aster(size) -> np.ndarray:
    """Aster: P = -(r - r0)/|r - r0| with 0-based coordinates and the
    centre at 0.5 L (ref: polar_active_rt.c:156-200), on the host."""
    x = np.arange(size[0], dtype=np.float64)
    y = np.arange(size[1], dtype=np.float64)
    z = np.arange(size[2], dtype=np.float64)
    x0, y0, z0 = 0.5 * size[0], 0.5 * size[1], 0.5 * size[2]
    if size[2] == 1:
        z0 = 0.0
    X, Y, Z = np.meshgrid(x - x0, y - y0, z - z0, indexing="ij")
    r = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    return np.where(r > 1e-7, -np.stack([X, Y, Z]) / np.maximum(r, 1e-30),
                    np.stack([np.zeros_like(r), np.ones_like(r),
                              np.zeros_like(r)]))
