"""Subgrid (unresolved) particles: Peskin delta-function coupling.

PyTorch port of ludwig_tpu/subgrid.py (ref: src/subgrid.c:84 force
spreading, :215 interpolation, d_peskin; the method of Nash et al.).
Particle forces are spread onto the nearby nodes with the 4-point Peskin
kernel, the fluid velocity is interpolated back with the same kernel, and
particles move with it plus the local drag correction (1/ah - 1/al)/(6 pi
eta) times their force.  The particles' Langevin kick (the serial LCG
stream of subgrid.c:259-287) belongs to colloids with isothermal
fluctuations, which are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ludwig_tpu_torch.colloids import (_ftensor, _lengths, _min_image,
                                       site_coords)
from ludwig_tpu_torch.ops.collide import collide
from ludwig_tpu_torch.ops.stream import stream


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


def make_subgrid_step(cfg, params, al, force_fn=None):
    """step((f, R, V), t=0, rebuild=None) -> ((f', R', V'), (rho, u)):
    the deferred move (colloids.c:1028, dr = v of the last update), the
    particle forces spread onto the fluid (ludwig.c:2149), the collision
    with them (and the uniform gravity compensation), v = u(R) + drag F
    (subgrid.c subgrid_update), the propagation.  No map and no BBL."""
    if cfg.noise is not None:
        raise NotImplementedError(
            "subgrid particles with isothermal fluctuations are not ported "
            "yet, see ROADMAP")
    model = cfg.model
    cparams = cfg.collision_params()
    size = tuple(cfg.size)
    nsites = float(np.prod(size))
    ah = np.array(params.ah if params.ah else params.a0, np.float64)
    al = np.array(al, np.float64)
    gravity_on = any(v != 0.0 for v in params.gravity)

    def step(state, t=0, rebuild=None):
        del t, rebuild          # no rebuild: subgrid particles have no map
        f, R, V = state[0], state[1], state[2]
        R = torch.remainder(R + V, _lengths(size, R))
        grav = _ftensor(params.gravity, R)
        F = grav[None].expand(params.n, 3)
        if force_fn is not None:
            F = F + force_fn(R, V).to(F.dtype)
        force = spread_forces(F.to(f.dtype), R.to(f.dtype), size)
        if gravity_on:
            fb = (-grav) * (1.0 / nsites) * float(params.n)
            force = force + fb[:, None, None, None].to(f.dtype)
        f, rho, u = collide(f, cparams, force=force)
        _, V = subgrid_update(R, F, u, size, ah, al, cfg.eta_shear)
        return (stream(f, model), R, V), (rho, u)

    return step
