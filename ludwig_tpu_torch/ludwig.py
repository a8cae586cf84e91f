"""Top-level orchestration: run a plain-fluid simulation from a
reference-format input file.

PyTorch port of the plain single-fluid slice of ludwig_tpu/ludwig.py
(ref: src/ludwig.c:443 ludwig_run, src/main.c:30-46).  It parses the
same key-value input, builds the `free_energy none` system without walls,
Lees-Edwards planes, porous media or noise, runs the time loop on an
explicit device and writes the statistics blocks in the reference's
formats.  `tpu_fused on` (or `interpret`) selects ops.fused.fused_step,
the hand-written CUDA kernel on a GPU and its twin on the CPU.

Every input key outside the slice raises NotImplementedError naming the
key, unless it is set to its inactive default (`free_energy none`,
`periodicity 1_1_1`, `colloid_init no_colloids`, ...).  The input header
of the reference log (fulllog.InitLog in the JAX package) is not ported
yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from ludwig_tpu_torch import stats
from ludwig_tpu_torch.lb import (LBConfig, hydro_fields, initial_from_hydro,
                                 initial_rest, make_step)
from ludwig_tpu_torch.ops.collide import RelaxationScheme
from ludwig_tpu_torch.ops.fused import fused_step
from ludwig_tpu_torch.runtime import RunTime


def _off(v: str) -> bool:
    return v.lower() in ("off", "no", "0", "false")


def _zeros(v: str) -> bool:
    return all(float(x) == 0.0 for x in v.split("_"))


# keys this slice reads
SLICE_KEYS = frozenset((
    "size", "viscosity", "viscosity_bulk", "fluid_rho0", "force",
    "lb_nvel", "ghost_modes", "lb_ghost_modes", "lb_relaxation_scheme",
    "dtype", "distribution_initialisation", "distribution_poiseuille_umax",
    "2d_kelvin_helmholtz_u0", "2d_kelvin_helmholtz_delta",
    "2d_kelvin_helmholtz_kappa", "distribution_uniform_u0",
    "distribution_uniform_u", "N_cycles", "freq_statistics", "tpu_fused",
    "hydrodynamics"))

# keys of features outside the slice, accepted while they leave it off
INACTIVE = {
    "free_energy": lambda v: v == "none",
    "colloid_init": lambda v: v == "no_colloids",
    "periodicity": lambda v: v == "1_1_1",
    "boundary_walls": _zeros,
    "temperature": _zeros,
    "isothermal_fluctuations": _off,
    "lb_fluctuations": _off,
    "N_LE_plane": _zeros,
    "N_start": _zeros,
    "lb_bc_open": _off,
    "tpu_shard": _off,
    "config_at_end": _off,
    "freq_config": _zeros,
    "freq_phi": _zeros,
    "freq_vel": _zeros,
    "freq_psi": _zeros,
    "freq_measure": _zeros,
    "freq_shear_measurement": _zeros,
    "freq_shear_output": _zeros,
    "colloid_io_freq": _zeros,
}


def _check_keys(rt: RunTime):
    """Raise on any key the slice cannot honour."""
    for key in rt.unused_keys():
        if key in SLICE_KEYS:
            continue
        check = INACTIVE.get(key)
        value = rt.string(key)
        if check is None or not check(value):
            raise NotImplementedError(
                f"input key '{key}' (value '{value}') is not ported yet, "
                "see ROADMAP")


@dataclasses.dataclass
class System:
    """A configured simulation: state + step + reporting."""

    rt: RunTime
    lb_cfg: LBConfig
    state: tuple                 # (f,)
    step_fn: object
    fused_mode: Optional[str] = None   # 'plain': fused collide+stream
    hydro_on: bool = True


def _relaxation(rt: RunTime) -> RelaxationScheme:
    name = rt.string("lb_relaxation_scheme", "m10").lower()
    schemes = {"m10": RelaxationScheme.M10, "bgk": RelaxationScheme.BGK,
               "trt": RelaxationScheme.TRT}
    if name not in schemes:
        raise ValueError(f"lb_relaxation_scheme '{name}' not recognised")
    return schemes[name]


def _distribution_init(rt: RunTime, lb_cfg: LBConfig):
    """distribution_initialisation modes (ref: src/distribution_rt.c:
    lb_init_poiseuille, 2d Kelvin-Helmholtz :303-330, 2d shear wave).
    Site coordinates are x = i + 0.5 (ref lmin = 0.5)."""
    mode = rt.string("distribution_initialisation", "rest")
    size = lb_cfg.size
    if mode == "rest":
        return initial_rest(lb_cfg)

    x, y, z = (np.arange(n) + 0.5 for n in size)
    rho = np.full(size, lb_cfg.rho0)
    u = np.zeros((3,) + size)

    if mode == "1d_poiseuille":
        umax = rt.double_vector("distribution_poiseuille_umax",
                                (0.0, 0.0, 0.0))
        L = np.array(size, float)
        u[0] += (umax[0] * x * (L[0] - x) * 4.0 / L[0] ** 2)[:, None, None]
        u[1] += (umax[1] * y * (L[1] - y) * 4.0 / L[1] ** 2)[None, :, None]
        u[2] += (umax[2] * z * (L[2] - z) * 4.0 / L[2] ** 2)[None, None, :]
    elif mode == "2d_kelvin_helmholtz":
        u0 = rt.double_required("2d_kelvin_helmholtz_u0")
        delta = rt.double_required("2d_kelvin_helmholtz_delta")
        kappa = rt.double_required("2d_kelvin_helmholtz_kappa")
        xs = x / size[0]
        ys = y / size[1]
        ux = np.where(ys > 0.5, u0 * np.tanh(kappa * (0.75 - ys)),
                      u0 * np.tanh(kappa * (ys - 0.25)))
        u[0] += ux[None, :, None]
        u[1] += (u0 * delta * np.sin(2.0 * np.pi * (xs + 0.25)))[:, None,
                                                                 None]
    elif mode == "2d_shear_wave":
        u0 = rt.double("distribution_uniform_u0", 0.04)
        kappa = 2.0 * np.pi
        u[0] += (u0 * np.sin(kappa * y / size[1]))[None, :, None]
    elif mode == "3d_uniform_u":
        u0 = rt.double_vector("distribution_uniform_u", (0.0, 0.0, 0.0))
        for a in range(3):
            u[a] += u0[a]
    else:
        raise ValueError(f"distribution_initialisation '{mode}'"
                         " not implemented")
    return initial_from_hydro(lb_cfg, rho, u)


def build_system(rt: RunTime, device="cpu") -> System:
    """The plain-fluid system of an input on `device`."""
    _check_keys(rt)
    size = tuple(rt.int_vector("size", (64, 64, 64)))
    eta = rt.double("viscosity", 1.0 / 6.0)
    eta_b = rt.double("viscosity_bulk", eta)
    rho0 = rt.double("fluid_rho0", 1.0)
    force = tuple(rt.double_vector("force", (0.0, 0.0, 0.0)))
    # old key "ghost_modes", new preferred "lb_ghost_modes"
    # (ref: collision_rt.c:87-92)
    ghosts = rt.switch("ghost_modes", rt.switch("lb_ghost_modes", True))
    dtype = rt.string("dtype", "float64")
    nvel = rt.int("lb_nvel", 9 if size[2] == 1 else 19)

    lb_cfg = LBConfig(size=size, nvel=nvel, eta_shear=eta, eta_bulk=eta_b,
                      rho0=rho0, scheme=_relaxation(rt),
                      ghost_modes_on=ghosts, force_global=force,
                      dtype=dtype, device=str(device))
    f = _distribution_init(rt, lb_cfg)
    fused_req = rt.string("tpu_fused", "off")
    if fused_req not in ("on", "interpret", "off"):
        raise ValueError(f"tpu_fused '{fused_req}' not recognised")
    if fused_req != "off":
        # production path: the fused collide+stream (kernel on a GPU,
        # twin on the CPU; 'interpret' is the JAX package's CPU spelling)
        model = lb_cfg.model
        params = lb_cfg.collision_params()

        def step(f, t=0):
            return fused_step(f, model, params, t=t)

        return System(rt=rt, lb_cfg=lb_cfg, state=(f,), step_fn=step,
                      fused_mode="plain")
    return System(rt=rt, lb_cfg=lb_cfg, state=(f,),
                  step_fn=make_step(lb_cfg))


def _make_fast_stats_fn(sys_: System):
    """Plain-reduction statistics, as the fused path of the JAX package
    reports them: compute(f, u) -> {rho, g, umm}."""
    model = sys_.lb_cfg.model

    def compute(f, u):
        rho, _g = hydro_fields(f, model)
        return {"rho": stats.field_stats(rho),
                "g": stats.momentum_total_plain(f, model),
                "umm": stats.velocity_minmax(u)}

    return compute


def _fused_u(sys_: System, f: torch.Tensor) -> torch.Tensor:
    """The reference's hydro u is the collision-time force-shifted
    velocity (g_pre + F/2)/rho; after the kick the stored momentum is
    g_pre + F, so subtract F/2."""
    rho, g = hydro_fields(f, sys_.lb_cfg.model)
    fg = torch.as_tensor(np.asarray(sys_.lb_cfg.force_global[:3]),
                         dtype=g.dtype, device=g.device)
    return (g - 0.5 * fg[:, None, None, None]) / rho


def report_statistics(sys_: System, tstep: int, u, stats_fn,
                      with_velocity=True, out=sys.stdout, in_loop=True):
    """One statistics block set in the reference formats.  The
    'Completed cycle' trailer only appears inside the time loop (ref:
    ludwig.c:961)."""
    res = stats_fn(sys_.state[0], u)
    out.write(stats.format_rho_block(*res["rho"]))
    g = res["g"]
    out.write(stats.format_momentum_block(g, g))
    if with_velocity:
        out.write(stats.format_velocity_block(*res["umm"]))
    if in_loop:
        out.write(f"\nCompleted cycle {tstep}\n")
    out.flush()


def run_text(text: str, out=sys.stdout, device="cpu") -> System:
    """Run a simulation from input-file text on `device`; returns the
    final System."""
    rt = RunTime(text)
    t0 = time.time()
    sys_ = build_system(rt, device)
    sys_.hydro_on = rt.switch("hydrodynamics", True)
    size = sys_.lb_cfg.size
    ncycles = rt.int("N_cycles", 0)
    freq = rt.int("freq_statistics", max(ncycles, 1))
    stats_fn = _make_fast_stats_fn(sys_)

    out.write("\nInitial conditions.\n")
    u = torch.zeros((3,) + size, dtype=sys_.lb_cfg.tdtype,
                    device=sys_.lb_cfg.device)
    report_statistics(sys_, 0, u, stats_fn, with_velocity=False,
                      out=out, in_loop=False)
    out.write("\nStarting time step loop.\n")
    t_init = time.time() - t0
    sect = {"step": [0.0, float("inf"), 0.0, 0],
            "stats": [0.0, float("inf"), 0.0, 0]}

    def _acc(key, dt_):
        s = sect[key]
        s[0] += dt_
        s[1] = min(s[1], dt_)
        s[2] = max(s[2], dt_)
        s[3] += 1

    f = sys_.state[0]
    for t in range(1, ncycles + 1):
        ts0 = time.time()
        if sys_.fused_mode == "plain":
            f = sys_.step_fn(f, t)
            u = None      # derived from f at statistics steps
        else:
            f, _rho, u = sys_.step_fn(f, t)
        sys_.state = (f,)
        _acc("step", time.time() - ts0)
        if t % freq == 0:
            ts0 = time.time()
            if u is None:
                u = _fused_u(sys_, f)
            report_statistics(sys_, t, u, stats_fn, out=out,
                              with_velocity=sys_.hydro_on)
            _acc("stats", time.time() - ts0)

    # timer table (ref: TIMER_statistics table shape); host clocks, the
    # device work of a step lands in the next section that synchronises
    total = time.time() - t0
    per_step = (total - t_init) / max(ncycles, 1)
    out.write("\nTimer statistics\n")
    out.write("             Section:       tmin       tmax      total\n")
    out.write(f"               Total: {total:10.3f} {total:10.3f} "
              f"{total:10.3f} {total:10.6f} (1 call)\n")
    out.write(f"      Initialisation: {t_init:10.3f} {t_init:10.3f} "
              f"{t_init:10.3f} {t_init:10.6f} (1 call)\n")
    out.write(f"      Time step loop: {per_step:10.3f} {per_step:10.3f} "
              f"{total - t_init:10.3f} {per_step:10.6f} "
              f"({max(ncycles, 1)} calls)\n")
    for key, label in (("step", "Step dispatch"), ("stats", "Statistics")):
        tot, tmin, tmax, ncall = sect[key]
        if ncall:
            out.write(f"{label:>20s}: {tmin:10.3f} {tmax:10.3f} "
                      f"{tot:10.3f} {tot / ncall:10.6f} ({ncall} calls)\n")
    out.write("Ludwig finished normally.\n")
    out.flush()
    return sys_


def run(path: str = "input", out=sys.stdout, device="cpu") -> System:
    with open(path) as fh:
        return run_text(fh.read(), out=out, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m ludwig_tpu_torch",
        description="Run a plain-fluid lattice Boltzmann input file.")
    ap.add_argument("input", nargs="?", default="input",
                    help="input file (default: ./input)")
    ap.add_argument("--device", default="cpu",
                    help="torch device, e.g. cpu or cuda (default: cpu)")
    args = ap.parse_args(argv)
    run(args.input, device=args.device)
