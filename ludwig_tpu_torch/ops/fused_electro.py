"""Fused electrokinetics: the SOR Poisson solve and the Nernst-Planck
sub-step with the grad-mu force.

PyTorch port of ludwig_tpu/ops/fused_electro.py.  The TPU kernels
``_sor_kernel`` and ``_np_kernel`` become the hand-written CUDA kernels of
``csrc/electro.cu``; their plain PyTorch twins live here and follow the
Pallas kernels' term order (not the jnp route's, which electro_sim.py
keeps).  Every public function takes the twin for tensors on the CPU,
launches the kernel for tensors on a CUDA device, and raises on anything
else; a build or launch failure raises too.

The JAX package gates these kernels on TPU layout (Z % 128, Y % 8, a VMEM
budget, X % BX); the port keeps only the semantic conditions: no external
field (its wrap-plane potential jumps are the reference route's), no
excess chemical potential, the d3q7 stencil.  Scalar constants take the
input's dtype (the Pallas NP kernel hard-codes float32 ones).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ludwig_tpu_torch.ops import _cuda


def _check_field(x: torch.Tensor, name: str, shape, dtype):
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be C-contiguous (z fastest)")


def _check_psi(psi: torch.Tensor):
    if psi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fields must be float32 or float64, got "
                        f"{psi.dtype}")
    if psi.dim() != 3 or not psi.is_contiguous():
        raise ValueError(f"psi must be a C-contiguous (X, Y, Z) field, got "
                         f"shape {tuple(psi.shape)}")


def _dispatch(x: torch.Tensor, plain, kernel):
    if x.device.type == "cpu":
        return plain()
    if x.device.type == "cuda":
        return kernel()
    raise ValueError(f"no electrokinetic kernel for device {x.device}")


# -- SOR ---------------------------------------------------------------------

def kernel_supported(e0=(0.0, 0.0, 0.0)) -> bool:
    """Both kernels take the periodic problem without an external field
    (its wrap-plane potential jumps are the reference route's); the NP
    kernel takes the ideal electrolyte (no excess chemical potential in
    the port).  The caller checks the solver and the stencil."""
    return not any(float(v) for v in e0)


def _omega_table(X: int, Z: int, max_its: int) -> np.ndarray:
    """(min(max_its, 1024), 2) Chebyshev omegas for the red and the black
    half-sweep of each iteration, the reference recurrence in float64:
    omega(0) = 1, after the first half-sweep 1/(1 - r^2/2), thereafter
    1/(1 - r^2 omega/4), r = 1 - (pi/max(X, Z))^2/2.  omega reaches its
    fixed point well inside 1024 iterations, so the table stops there and
    later iterations take its last row (ludwig_tpu/ops/fused_electro.py
    sor_solve_fused)."""
    radius = 1.0 - 0.5 * (np.pi / max(X, Z)) ** 2
    r2 = radius * radius
    om = 1.0
    seq = np.empty((min(int(max_its), 1024), 2), np.float64)
    for n in range(len(seq)):
        seq[n, 0] = om
        om = (1.0 / (1.0 - 0.5 * r2) if n == 0
              else 1.0 / (1.0 - 0.25 * r2 * om))
        seq[n, 1] = om
        om = 1.0 / (1.0 - 0.25 * r2 * om)
    return seq


@functools.lru_cache(maxsize=16)
def _omega_table_on(X: int, Z: int, max_its: int, dtype: torch.dtype,
                    device: str) -> torch.Tensor:
    """_omega_table cast to `dtype` on `device`, made once: a copy from
    the host at every solve would wait for the device."""
    return torch.as_tensor(_omega_table(X, Z, max_its), dtype=dtype,
                           device=device)


def red_mask(shape, device) -> torch.Tensor:
    """The red sites of the red/black sweep: (i + j + k) even, made on
    the device."""
    i, j, k = (torch.arange(n, device=device) for n in shape)
    return (i[:, None, None] + j[None, :, None] + k) % 2 == 0


def _sor_half_plain(p, rhs, mask, omega, eps, denom):
    """One two-buffer half-sweep: the residual eps (x- + x+ + y- + y+ +
    z- + z+ - 6 p) + rhs from the whole pre-sweep field, periodic, in the
    Pallas kernel's order, and p + omega res / denom on the sites of
    `mask`; returns (p', the sum of res^2 over them)."""
    nb = torch.roll(p, 1, 0) + torch.roll(p, -1, 0)
    nb = nb + torch.roll(p, 1, 1) + torch.roll(p, -1, 1)
    nb = nb + torch.roll(p, 1, 2) + torch.roll(p, -1, 2)
    res = eps * (nb - 6.0 * p) + rhs
    pn = torch.where(mask, p + omega * res / denom, p)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    return pn, torch.sum(torch.where(mask, res * res, zero))


def _sor_solve_plain(psi, rhs, om_tab, eps, rel_tol, abs_tol, max_its,
                     zero_mean):
    """Twin of the SOR kernel, in the Pallas kernel's order: two-buffer
    half-sweeps (_sor_half_plain) on the red sites, then the black,
    sums of res^2 in the field's dtype, a check every 5 iterations (the
    float32 stall guard from the second check on), the zero-mean shift.
    The loop reads the residual on the host at each check."""
    X, Y, Z = psi.shape
    red = red_mask(psi.shape, psi.device)
    masks = (red, torch.logical_not(red))
    rnorm0 = torch.sqrt(torch.sum(rhs * rhs))
    denom = torch.tensor(6.0 * eps, dtype=psi.dtype, device=psi.device)
    stall = psi.dtype == torch.float32

    p, prev, n = psi, None, 0
    while True:
        nt = min(n, om_tab.shape[0] - 1)
        p, s_red = _sor_half_plain(p, rhs, masks[0], om_tab[nt, 0], eps,
                                   denom)
        p, s_blk = _sor_half_plain(p, rhs, masks[1], om_tab[nt, 1], eps,
                                   denom)
        rnorm1 = torch.sqrt(s_red + s_blk)
        if n % 5 == 0:
            conv = torch.logical_or(rnorm1 < abs_tol,
                                    rnorm1 < rel_tol * rnorm0)
            if stall and n > 0:
                conv = torch.logical_or(conv, rnorm1 >= 0.995 * prev)
            prev = rnorm1
            if bool(conv):
                break
        if n == max_its - 1:
            break
        n += 1
    if zero_mean:
        p = p - torch.sum(p) / torch.tensor(float(X * Y * Z),
                                            dtype=psi.dtype,
                                            device=psi.device)
    which = torch.where(rnorm1 < abs_tol, 0, 1).to(torch.int32)
    return (p, torch.tensor(n, dtype=torch.int32, device=psi.device),
            rnorm1, which)


def sor_solve_fused(psi: torch.Tensor, rho_el: torch.Tensor, cfg,
                    zero_mean: bool = True):
    """SOR solve of  eps del2_7pt psi = -(e beta) rho_el  from `psi`:
    (psi', n, rnorm, which).  n is the iteration the loop stopped at
    (max_its - 1 if it never stopped), rnorm and which (0 absolute, 1
    relative tolerance) come from that iteration; n, rnorm and which are
    0-dim tensors on psi's device, read without a synchronisation only
    when the caller asks.  The convergence semantics are
    electro_sim.poisson_sor_ref's, with the float32 stall guard; with
    `zero_mean` the solve also shifts psi to zero mean.  `cfg` is an
    electro.ElectroConfig."""
    rhs, om_tab, args = _sor_operands(psi, rho_el, cfg, zero_mean)
    # the kernel's route (ops/_cuda.py sor_layout) raises beyond int32
    return _dispatch(psi, lambda: _sor_solve_plain(psi, rhs, om_tab, *args),
                     lambda: _cuda.sor_solve(psi, rhs, om_tab, *args))


def _sor_solve_route(psi: torch.Tensor, rho_el: torch.Tensor, cfg,
                     route: str, zero_mean: bool = True):
    """sor_solve_fused on the kernel's route `route` (ops/_cuda.py
    SOR_ROUTES), which raises where the route cannot run; psi on a CUDA
    device."""
    rhs, om_tab, args = _sor_operands(psi, rho_el, cfg, zero_mean)
    return _cuda.sor_solve(psi, rhs, om_tab, *args, route=route)


def _sor_operands(psi, rho_el, cfg, zero_mean):
    """Check the solve's inputs; (rhs, omega table, the scalar args)."""
    _check_psi(psi)
    if rho_el.shape != psi.shape or rho_el.device != psi.device:
        raise ValueError("rho_el must be psi's shape, on psi's device")
    if int(cfg.max_its) < 1:
        raise ValueError(f"max_its must be >= 1, got {cfg.max_its}")
    X, _Y, Z = psi.shape
    rhs = ((cfg.e * cfg.beta) * rho_el).to(psi.dtype).contiguous()
    om_tab = _omega_table_on(X, Z, int(cfg.max_its), psi.dtype,
                             str(psi.device))
    return rhs, om_tab, (float(cfg.epsilon), float(cfg.rel_tol),
                         float(cfg.abs_tol), int(cfg.max_its),
                         bool(zero_mean))


# -- Nernst-Planck + grad-mu -------------------------------------------------

def _face_flux(psi0, psi1, n0, n1, u0, u1, m01, z, c):
    """The flux from site 0 to site 1 through their face, in the Pallas
    kernel's order: c (1 + 1/b) (n1 b - n0), b = exp(z (psi1 - psi0)),
    plus 0.5 (u0 + u1) 0.5 (n0 + n1) where u0 is not None, times the
    face mask m01 = m0 m1."""
    b1 = torch.exp(z * (psi1 - psi0))
    flx = c * (1.0 + 1.0 / b1) * (n1 * b1 - n0)
    if u0 is not None:
        ua = 0.5 * (u0 + u1)
        flx = flx + ua * 0.5 * (n0 + n1)
    return flx * m01


def _np_plain(psi, rho, u, fluid, ez, z, c, kt_e, dt):
    """Twin of the NP + grad-mu kernel, in the Pallas kernel's order.
    ez, z, c are per-species e z_k, z_k and -0.5 D_k; u None without
    hydrodynamics."""
    def up(x, ax):
        return torch.roll(x, -1, ax)

    def dn(x, ax):
        return torch.roll(x, 1, ax)

    re = 0.0
    for k in range(len(z)):
        re = re + ez[k] * rho[k]
    force = torch.stack([re * (-0.5 * (up(psi, ax) - dn(psi, ax)) * kt_e)
                         for ax in range(3)])
    fsum = torch.sum(force, dim=(1, 2, 3))

    flt = fluid.to(psi.dtype)
    fm = [flt * up(flt, ax) for ax in range(3)]
    out = []
    for k in range(len(z)):
        n0 = rho[k]
        div = 0.0
        for ax in range(3):
            u0, u1 = (None, None) if u is None else (u[ax], up(u[ax], ax))
            flx = _face_flux(psi, up(psi, ax), n0, up(n0, ax), u0, u1,
                             fm[ax], z[k], c[k])
            d = flx - dn(flx, ax)
            div = d if ax == 0 else div + d
        out.append(torch.where(fluid, n0 - dt * div, n0))
    return torch.stack(out), force, fsum


def np_gradmu_fused(psi: torch.Tensor, rho: torch.Tensor, u, fluid,
                    cfg, dt: float):
    """(rho', force_raw, fsum): one Nernst-Planck d3q7 sub-step of every
    species, the raw grad-mu force rho_el E and its global sum (the caller
    subtracts fsum / nsites: the reference's psi_force_gradmu mean
    correction).

    Face fluxes F = -D (1 + 1/b)/2 (n_1 b - n_0), b = exp(z (psi_1 -
    psi_0)), plus 0.5 (u_0 + u_1) 0.5 (n_0 + n_1) with hydrodynamics, on
    faces with both ends fluid; rho' = n - dt div F at fluid sites.
    `u` is (3, X, Y, Z) or None (no advection: also when
    cfg.hydrodynamics is off), `fluid` the bool fluid mask, `cfg` an
    electro_sim.ElectroSimConfig."""
    ek = cfg.ek
    _check_psi(psi)
    size = tuple(psi.shape)
    nk = ek.nk
    _check_field(rho, "rho", (nk,) + size, psi.dtype)
    _check_field(fluid, "fluid", size, torch.bool)
    hydro = u is not None and cfg.hydrodynamics
    if hydro:
        _check_field(u, "u", (3,) + size, psi.dtype)
    for x in (rho, fluid) + ((u,) if hydro else ()):
        if x.device != psi.device:
            raise ValueError("all fields must be on psi's device")
    ez = [float(ek.e * v) for v in ek.valency]
    z = [float(v) for v in ek.valency]
    c = [-float(d) * 0.5 for d in ek.diffusivity]
    kt_e = 1.0 / (float(ek.beta) * float(ek.e))

    def kernel():
        # the layout (ops/_cuda.py np_layout) refuses nk beyond
        # NP_MAX_SPECIES
        nsite = int(np.prod(size))
        if max(nk, 3) * nsite > _cuda.INT32_MAX:
            raise ValueError(
                f"np_gradmu kernel indexes with int32: max(nk, 3) * X*Y*Z = "
                f"{max(nk, 3) * nsite} exceeds {_cuda.INT32_MAX}")
        return _cuda.np_gradmu(psi, rho, u if hydro else None, fluid, ez, z,
                               c, kt_e, float(dt))

    return _dispatch(
        psi, lambda: _np_plain(psi, rho, u if hydro else None, fluid, ez, z,
                               c, kt_e, float(dt)), kernel)
