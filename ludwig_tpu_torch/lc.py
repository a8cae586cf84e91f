"""Liquid-crystal (Q-tensor) simulation: blue phase + Beris-Edwards + LB.

PyTorch port of the periodic, hydrodynamics-on branch of ludwig_tpu/lc.py
(ref: src/ludwig.c q-tensor branch: field_grad(q) -> force via stress
divergence (+ active stress) -> beris_edwards -> collide -> stream), the
reference's headline benchmark configuration.  The state is the tuple
(f, q5, u); a step runs eagerly on the state's device.  This is the
unfused step (the CLI's `tpu_fused off` route) and the reference the
fused step of ops/fused_lc.py is tested against.

Walls, anchoring gradients, the dynamic redshift, the noise term, the
electric field, Lees-Edwards shear, `hydrodynamics off` and LC colloids
are not ported yet (ROADMAP, slice 4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ludwig_tpu_torch.dynamics.beris_edwards import (BerisEdwardsParams,
                                                     beris_edwards_update,
                                                     corotation, remove_trace)
from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE, q33_to_q5
from ludwig_tpu_torch.lb import LBConfig, initial_rest
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.force import stress_divergence_force
from ludwig_tpu_torch.ops.stencil import gradient_ops
from ludwig_tpu_torch.ops.stream import stream

GRADIENT = "3d_7pt_fluid"      # the stencil of the ported LC slice
ORDERS = (1, 2)                # the ported advection orders


@dataclasses.dataclass(frozen=True)
class LCConfig:
    """Static configuration of a blue-phase run: periodic, 7-point
    gradients, hydrodynamics on.  The JAX package's walls, anchoring,
    redshift update, noise and `hydrodynamics off` are not ported yet
    (ROADMAP, slice 4)."""

    lb: LBConfig
    fe: BluePhaseFE
    gamma: float = 0.1            # rotational mobility (lc_Gamma)
    advection_order: int = 1

    def __post_init__(self):
        if self.advection_order not in ORDERS:
            raise NotImplementedError(
                f"advection order {self.advection_order} is not ported "
                f"yet (have {ORDERS}), see ROADMAP")


def lc_fields(q5, gradient: str = GRADIENT):
    """Q and its gradients, the dict the free energy's methods take."""
    g, d = gradient_ops(gradient)
    return {"q": q5, "grad_q": g(q5), "delsq_q": d(q5)}


def stack33(rows) -> torch.Tensor:
    """A 3x3 list of tensors as one (3, 3, ...) tensor."""
    return torch.stack([torch.stack(row) for row in rows])


def _lc_force(cfg: LCConfig, fields, h, dtype):
    pth = stack33(cfg.fe.stress(fields, h=h))
    sa = cfg.fe.active_stress(fields)
    if sa is not None:
        pth = pth + stack33(sa)
    return stress_divergence_force(pth).to(dtype)


def _s5_corotation(q33, w, xi):
    """Corotation source S(W,Q) in 5-component form, from the velocity
    gradient tensor w[a][b] (ref: blue_phase_beris_edwards.c S(W,Q)
    construction)."""
    return q33_to_q5(corotation(q33, remove_trace(w), xi))


def make_lc_step(cfg: LCConfig):
    """Step: ((f, q5, u), t=0) -> ((f', q5', u'), rho)."""
    params = cfg.lb.collision_params()
    model = cfg.lb.model
    be = BerisEdwardsParams(gamma=cfg.gamma, xi=cfg.fe.xi,
                            advection_order=cfg.advection_order)

    def step(state, t=0):
        del t
        f, q5, u = state
        fields = lc_fields(q5)
        h = cfg.fe.molecular_field(fields)
        force = _lc_force(cfg, fields, h, f.dtype)
        q5 = beris_edwards_update(q5, h, u, be)
        f, rho, u_new = collide(f, params, force=force)
        return (stream(f, model), q5, u_new), rho

    return step


def make_lc_nstep(cfg: LCConfig):
    """nstep(state, n, t0=0): n chained steps."""
    step = make_lc_step(cfg)

    def nstep(state, n, t0=0):
        for t in range(t0, t0 + n):
            state, _rho = step(state, t)
        return state

    return nstep


def initial_lc(cfg: LCConfig, q0_field: np.ndarray):
    """(f at rest, q5, u = 0) on the configuration's device."""
    lb = cfg.lb
    f = initial_rest(lb)
    q5 = torch.as_tensor(q0_field, dtype=lb.tdtype, device=lb.device)
    u = torch.zeros((3,) + tuple(lb.size), dtype=lb.tdtype, device=lb.device)
    return (f, q5.contiguous(), u)


def total_free_energy(cfg: LCConfig, q5) -> float:
    return float(torch.sum(cfg.fe.fed(lc_fields(q5))))
