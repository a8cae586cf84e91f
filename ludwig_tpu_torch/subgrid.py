"""Subgrid (unresolved) particles: Peskin delta-function coupling.

PyTorch port of ludwig_tpu/subgrid.py (ref: src/subgrid.c:84 force
spreading, :215 interpolation, d_peskin; the method of Nash et al.).
Particle forces are spread onto the nearby nodes with the 4-point Peskin
kernel, the fluid velocity is interpolated back with the same kernel, and
particles move with it plus the local drag correction (1/ah - 1/al)/(6 pi
eta) times their force.  With isothermal fluctuations the fluid draws
the LB noise (the per-site KISS stream, or the threefry one) and each
particle takes a Langevin kick from its own serial LCG stream (ref:
subgrid.c:259-287; util.c util_ranlcg_reap_gaussian): the Marsaglia polar
pair with its rejection, a 3-sigma rejection per component.  The kicks
depend only on the particles' LCG states, never on the fields, so they
are drawn on the host, bitwise the JAX package's int64 arithmetic, and
the step reads nothing back from the device for them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ludwig_tpu_torch.colloids import (_ftensor, _lengths, _min_image,
                                       site_coords)
from ludwig_tpu_torch.lb import _noise_terms, kiss_on
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.stream import stream

RANLCG_A = 1389796
RANLCG_M = 2147483647


def d_peskin(r: torch.Tensor) -> torch.Tensor:
    """The 4-point Peskin interpolation kernel (ref: subgrid.c d_peskin)."""
    rmod = torch.abs(r)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    inner = 0.125 * (3.0 - 2.0 * rmod + torch.sqrt(torch.clamp(
        1.0 + 4.0 * rmod - 4.0 * rmod * rmod, min=0.0)))
    outer = 0.125 * (5.0 - 2.0 * rmod - torch.sqrt(torch.clamp(
        -7.0 + 12.0 * rmod - 4.0 * rmod * rmod, min=0.0)))
    return torch.where(rmod <= 1.0, inner,
                       torch.where(rmod <= 2.0, outer, zero))


def _weights(R: torch.Tensor, size) -> torch.Tensor:
    """(N, X, Y, Z) Peskin weights around each particle."""
    coords = site_coords(size, R.dtype, R.device)
    d = _min_image(coords[None] - R[:, :, None, None, None],
                   _lengths(size, R, 3)[None])
    return d_peskin(d[:, 0]) * d_peskin(d[:, 1]) * d_peskin(d[:, 2])


def spread_forces(F: torch.Tensor, R: torch.Tensor, size) -> torch.Tensor:
    """Particle forces to a fluid force density (3, X, Y, Z) (ref:
    subgrid_force_from_particles)."""
    return torch.einsum("na,nxyz->axyz", F, _weights(R, size))


def interpolate_velocity(u: torch.Tensor, R: torch.Tensor, size):
    """The fluid velocity at the particles (N, 3) (ref:
    subgrid_interpolation)."""
    return torch.einsum("nxyz,axyz->na", _weights(R, size), u)


def subgrid_update(R, F, u, size, ah, al, eta: float):
    """(positions moved by v, v = u(R) + drag F) with the local drag
    correction (1/ah - 1/al) / (6 pi eta) (ref: subgrid.c:257)."""
    us = interpolate_velocity(u, R, size)
    ah, al = _ftensor(ah, R), _ftensor(al, R)
    drag = (1.0 / ah - 1.0 / al) / (6.0 * np.pi * eta)
    v = us + drag[:, None] * F
    return torch.remainder(R + v, _lengths(size, R)), v


def _lcg_uniform(s: int):
    """One LCG draw (ref: util.c util_ranlcg_reap_uniform)."""
    s = (RANLCG_A * s) % RANLCG_M
    return s, float(s) * (1.0 / RANLCG_M)


def _reap_gaussian(s: int):
    """The Marsaglia polar pair with its rejection (ref:
    util_ranlcg_reap_gaussian)."""
    while True:
        s, u0 = _lcg_uniform(s)
        s, u1 = _lcg_uniform(s)
        z0 = 2.0 * u0 - 1.0
        z1 = 2.0 * u1 - 1.0
        rsq = z0 * z0 + z1 * z1
        if 0.0 < rsq < 1.0:
            break
    f = math.sqrt(-2.0 * math.log(rsq) / rsq)
    return s, f * z0, f * z1


def _frand_component(s: int, amp: float):
    """One random-force component with the 3-sigma rejection (ref:
    subgrid.c:259-281): the pair's first deviate if it lies within 3,
    else its second, else a new pair."""
    while True:
        s, g0, g1 = _reap_gaussian(s)
        if abs(g0) < 3.0:
            return s, amp * g0
        if abs(g1) < 3.0:
            return s, amp * g1


def langevin_kicks(rngs, kt: float, drag):
    """(rngs', kicks (N, 3) float64): each particle's random velocity
    sqrt(2 kT drag_n) g, three components from its LCG state rngs[n]
    (host integers below 2^31)."""
    new, kicks = [], []
    for s, d in zip((int(r) for r in rngs), drag):
        amp = math.sqrt(2.0 * kt * float(d))
        row = []
        for _ in range(3):
            s, v = _frand_component(s, amp)
            row.append(v)
        new.append(s)
        kicks.append(row)
    return new, np.array(kicks, np.float64).reshape(-1, 3)


def _to_device(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The host tensor x on like's device.  To a card it goes from pinned
    memory without blocking: a copy from pageable memory makes the host
    wait for the card's queue.  The pinned block is not reused before the
    copy ends (the caching host allocator records the copy's stream)."""
    if like.device.type == "cpu":
        return x
    return x.pin_memory().to(like.device, non_blocking=True)


def make_subgrid_step(cfg, params, al, force_fn=None):
    """step((f, R, V[, nstate][, rngs]), t=0, rebuild=None) -> (state',
    (rho, u)): the deferred move (colloids.c:1028, dr = v of the last
    update), the particle forces spread onto the fluid (ludwig.c:2149),
    the collision with them (and the uniform gravity compensation, and the
    LB noise with fluctuations on: the KISS state nstate where it rides),
    v = u(R) + drag F (subgrid.c subgrid_update), the propagation.  No
    map and no BBL.

    With fluctuations on the particles take the Langevin kick: rngs, the
    particles' LCG states, ride last as a CPU int64 tensor, and the kicks
    are drawn on the host and copied to V's device without blocking."""
    model = cfg.model
    cparams = cfg.collision_params()
    size = tuple(cfg.size)
    nsites = float(np.prod(size))
    ah = np.array(params.ah if params.ah else params.a0, np.float64)
    al = np.array(al, np.float64)
    gravity_on = any(v != 0.0 for v in params.gravity)
    kiss_rho = kiss_on(cfg)
    noise_on = cfg.noise is not None and cfg.noise.rho
    drag = (1.0 / ah - 1.0 / al) / (6.0 * np.pi * cfg.eta_shear)

    def step(state, t=0, rebuild=None):
        del rebuild             # no rebuild: subgrid particles have no map
        f, R, V = state[0], state[1], state[2]
        if kiss_rho:
            shat, ghat, nstate = _noise_terms(cfg, cparams, t,
                                              nstate=state[3])
        else:
            shat, ghat = _noise_terms(cfg, cparams, t)
        R = torch.remainder(R + V, _lengths(size, R))
        grav = _ftensor(params.gravity, R)
        F = grav[None].expand(params.n, 3)
        if force_fn is not None:
            F = F + force_fn(R, V).to(F.dtype)
        force = spread_forces(F.to(f.dtype), R.to(f.dtype), size)
        if gravity_on:
            fb = (-grav) * (1.0 / nsites) * float(params.n)
            force = force + fb[:, None, None, None].to(f.dtype)
        f, rho, u = collide(f, cparams, force=force, shat=shat, ghat=ghat)
        _, V = subgrid_update(R, F, u, size, ah, al, cfg.eta_shear)
        out = (stream(f, model), R)
        if noise_on:
            # the particles' Langevin kick (ref: subgrid.c:259-287)
            rngs, kicks = langevin_kicks(state[-1].tolist(), cfg.noise.kt,
                                         drag)
            V = V + _to_device(torch.as_tensor(kicks, dtype=V.dtype), V)
            out = out + (V,) + ((nstate,) if kiss_rho else ())
            return out + (torch.tensor(rngs, dtype=torch.int64),), (rho, u)
        return out + (V,) + ((nstate,) if kiss_rho else ()), (rho, u)

    return step
