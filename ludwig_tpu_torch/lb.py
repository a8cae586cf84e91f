"""Single-fluid lattice Boltzmann: configuration, state, step, initialisation.

PyTorch port of ludwig_tpu/lb.py for the plain-fluid path (ref:
src/model.c, src/ludwig.c:530-970).  The state is one distribution tensor
f (nvel, NX, NY, NZ) on an explicit device; a step is collide ->
[Lees-Edwards] -> stream(+bounce-back) [-> open boundary], run eagerly.
With isothermal fluctuations (``LBConfig.noise``) the per-site KISS99
state rides beside f and a step maps (f, nstate) to (f', nstate'); with
NoiseConfig(kiss=False), and in the n-step loop, the stateless threefry
stream draws the noise and no state rides.
Halo plane walls (make_wall_step) carry the walls' momentum beside f.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ludwig_tpu_torch import noise as noise_mod
from ludwig_tpu_torch import noise_kiss
from ludwig_tpu_torch.lattice import LatticeModel, lb_model
from ludwig_tpu_torch.ops.collide import (CollisionParams, RelaxationScheme,
                                          collide, equilibrium,
                                          unrolled_matvec)
from ludwig_tpu_torch.ops.lees_edwards import apply_lb_le
from ludwig_tpu_torch.ops.open_bc import apply_open_bc, apply_open_bc_x
from ludwig_tpu_torch.ops.stream import (stream, stream_bounce_back,
                                         wall_solid_mask)
from ludwig_tpu_torch.ops.walls import (wall_bounce_back,
                                        wall_bounce_back_slip)
from ludwig_tpu_torch.stats import momentum_total

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class LBConfig:
    """Static configuration for a plain-fluid run."""

    size: Tuple[int, int, int]
    nvel: int = 19
    eta_shear: float = 1.0 / 6.0
    eta_bulk: Optional[float] = None
    rho0: float = 1.0
    scheme: RelaxationScheme = RelaxationScheme.M10
    ghost_modes_on: bool = True
    force_global: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    walls: Tuple[bool, bool, bool] = (False, False, False)
    wall_u: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    dtype: str = "float32"
    noise: Optional[object] = None   # noise.NoiseConfig (fluctuations)
    device: str = "cuda"      # the GPU unless the caller asks for the CPU

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, "
                             f"got {self.dtype!r}")
        if self.noise is not None and not isinstance(self.noise,
                                                     noise_mod.NoiseConfig):
            raise TypeError(f"noise must be a noise.NoiseConfig, got "
                            f"{type(self.noise).__name__}")

    @property
    def model(self) -> LatticeModel:
        return lb_model(self.nvel)

    @property
    def tdtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def collision_params(self) -> CollisionParams:
        eta_b = self.eta_bulk if self.eta_bulk is not None else self.eta_shear
        return CollisionParams(
            model=self.model, eta_shear=self.eta_shear, eta_bulk=eta_b,
            rho0=self.rho0, scheme=self.scheme,
            ghost_modes_on=self.ghost_modes_on,
            force_global=self.force_global)


def initial_rest(cfg: LBConfig) -> torch.Tensor:
    """Fluid uniformly at rest: f = wv * rho0 (ref: model.c lb_init_rest_f).
    Built on the device, one broadcast of the weights."""
    model = cfg.model
    w = torch.as_tensor(np.asarray(model.wv, np.float64) * cfg.rho0,
                        dtype=cfg.tdtype, device=cfg.device)
    return w.reshape(-1, 1, 1, 1).expand(
        (model.nvel,) + tuple(cfg.size)).contiguous()


def initial_from_hydro(cfg: LBConfig, rho, u) -> torch.Tensor:
    """Equilibrium distributions from prescribed (rho, u) fields."""
    rho = torch.as_tensor(rho, dtype=cfg.tdtype, device=cfg.device)
    u = torch.as_tensor(u, dtype=cfg.tdtype, device=cfg.device)
    return equilibrium(cfg.model, rho, u).contiguous()


def solid_mask(cfg: LBConfig, porous: Optional[np.ndarray] = None):
    """Combined solid mask from in-lattice plane walls and an optional
    porous map (bool, True at solid sites), or None without either."""
    if not any(cfg.walls) and porous is None:
        return None
    m = wall_solid_mask(cfg.size, cfg.walls)
    if porous is not None:
        m = np.logical_or(m, porous)
    return torch.as_tensor(m, device=cfg.device)


def _noise_terms(cfg: LBConfig, params, t, nstate=None, fluid=None):
    """(shat, ghat[, nstate']) fluctuation terms for timestep t.

    With nstate (a per-site KISS state array, interior-shaped), draws
    the reference-exact stream and returns the advanced state as a
    third element.  fluid: bool mask - the reference reaps only at
    MAP_FLUID sites (ref: collision.c noise branch), so the state at
    solid sites does not advance and their deviates are zero.  Without
    a state the terms come from the stateless threefry stream keyed on
    (seed, t), the ghosts' under seed + 7919, as in the JAX package."""
    nz = cfg.noise
    if nz is None or not nz.rho:
        return (None, None) if nstate is None else (None, None, nstate)
    ve = noise_mod.var_eta(1.0 / params.rtau_shear, nz.kt)
    vb = noise_mod.var_bulk(1.0 / params.rtau_bulk, nz.kt)
    if nstate is None:
        shat = noise_mod.fluctuating_stress(
            nz.seed, t, cfg.size, ve, vb, ndim=cfg.model.ndim,
            dtype=cfg.tdtype, device=cfg.device)
        ghat = None
        if cfg.ghost_modes_on:
            vg = noise_mod.var_ghost(cfg.model, params.rtau_ghost, nz.kt)
            ghat = noise_mod.ghost_noise(nz.seed + 7919, t, cfg.size,
                                         cfg.model, vg, dtype=cfg.tdtype,
                                         device=cfg.device)
        return shat, ghat
    zero = torch.zeros((), dtype=cfg.tdtype, device=nstate.device)

    def reap(st, n):
        st2, r = noise_kiss.reap(st, n, cfg.tdtype)
        if fluid is not None:
            st2 = torch.where(fluid[None], st2, st)
            r = torch.where(fluid[None], r, zero)
        return st2, r

    nstate, r6 = reap(nstate, 6)
    shat = noise_mod.stress_from_deviates(r6, ve, vb, cfg.model.ndim)
    ghat = None
    if cfg.ghost_modes_on:
        vg = noise_mod.var_ghost(cfg.model, params.rtau_ghost, nz.kt)
        nstate, rg = reap(nstate, cfg.model.nvel - cfg.model.nhydro)
        ghat = noise_mod.ghost_from_deviates(rg, cfg.model, vg)
    return shat, ghat, nstate


def kiss_on(cfg: LBConfig) -> bool:
    """Whether a step carries the per-site KISS state beside f."""
    return cfg.noise is not None and cfg.noise.kiss and cfg.noise.rho


def make_step(cfg: LBConfig, solid=None, force_field=None, le=None,
              open_bc=None):
    """Single-fluid step: step(state, t=0, force=force_field) ->
    (state', rho, u).  The state is f, or (f, nstate) when the KISS
    fluctuation stream is on (kiss_on); t is the timestep counter, read
    by the Lees-Edwards displacement.  le is a LeesEdwardsConfig or None
    (order per ref ludwig.c: collide -> LE -> propagation); open_bc an
    OpenBCConfig of inflow/outflow along x, or None."""
    params = cfg.collision_params()
    model = cfg.model
    fluid = None if solid is None else torch.logical_not(solid)
    wall_u = cfg.wall_u if any(v != 0.0 for v in cfg.wall_u) else None
    kiss_rho = kiss_on(cfg)

    def step(state, t=0, force=force_field):
        if kiss_rho:
            f = state[0]
            shat, ghat, nstate = _noise_terms(cfg, params, t,
                                              nstate=state[1], fluid=fluid)
        else:
            f = state
            shat, ghat = _noise_terms(cfg, params, t)
        f_post, rho, u = collide(f, params, force=force, fluid_mask=fluid,
                                 shat=shat, ghat=ghat)
        if le is not None:
            f_post = apply_lb_le(f_post, model, le, t)
        f_new = stream_bounce_back(f_post, model, solid=solid,
                                   wall_u=wall_u, rho0=cfg.rho0)
        if open_bc is not None:
            f_new = apply_open_bc_x(f_new, f_post, model, open_bc)
        if kiss_rho:
            return (f_new, nstate), rho, u
        return f_new, rho, u

    return step


def make_wall_step(cfg: LBConfig, wallspec, force_field=None,
                   open_bc=None, open_axis=0):
    """Single-fluid step with halo plane walls (ref: wall.c wall_bbl):
    step((f, gwall[, nstate]), t=0, force=force_field) -> ((f', gwall'[,
    nstate']), rho, u).  gwall accumulates the bounce-back momentum
    transfer for the [walls] statistics row, as the difference of the
    compensated momentum totals before and after the wall fix; nstate
    rides when the KISS fluctuation stream is on."""
    params = cfg.collision_params()
    model = cfg.model
    kiss_rho = kiss_on(cfg)

    def step(state, t=0, force=force_field):
        f, gwall = state[0], state[1]
        if kiss_rho:
            shat, ghat, nstate = _noise_terms(cfg, params, t,
                                              nstate=state[-1])
        else:
            shat, ghat = _noise_terms(cfg, params, t)
        f_post, rho, u = collide(f, params, force=force,
                                 shat=shat, ghat=ghat)
        f_new = stream(f_post, model)
        g_pre = momentum_total(f_new, model)
        if wallspec.slip_active:
            f_new = wall_bounce_back_slip(f_new, f_post, model, wallspec,
                                          rho0=cfg.rho0)
        else:
            f_new, _, _ = wall_bounce_back(f_new, f_post, model, wallspec,
                                           rho0=cfg.rho0)
        gwall = gwall + (g_pre - momentum_total(f_new, model))
        if open_bc is not None:
            # the impose uses THIS step's collide hydro: the update at
            # the top of the reference loop is overwritten by a second
            # update after collision (ref: ludwig.c:599 vs :824)
            f_new = apply_open_bc(f_new, f_post, model, open_bc,
                                  axis=open_axis)
        out = (f_new, gwall)
        if kiss_rho:
            out = out + (nstate,)
        return out, rho, u

    return step


def make_nstep(cfg: LBConfig, solid=None, force_field=None, le=None,
               open_bc=None):
    """n steps in a loop: nstep(f, n, t0=0) -> f.  With fluctuations the
    steps draw the stateless threefry stream whatever cfg.noise.kiss
    says, as the JAX package's n-step scan does: no KISS state rides."""
    if kiss_on(cfg):
        cfg = dataclasses.replace(
            cfg, noise=dataclasses.replace(cfg.noise, kiss=False))
    step = make_step(cfg, solid=solid, force_field=force_field, le=le,
                     open_bc=open_bc)

    def nstep(f, n, t0=0):
        for k in range(n):
            f, _, _ = step(f, t0 + k)
        return f

    return nstep


def hydro_fields(f: torch.Tensor, model: LatticeModel):
    """(rho, momentum-density g) straight from distributions."""
    fl = [f[p] for p in range(model.nvel)]
    rho = sum(fl)
    g = torch.stack(unrolled_matvec(model.cv.T.astype(np.float64), fl))
    return rho, g
