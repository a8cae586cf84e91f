"""Top-level orchestration: run a simulation from a reference-format
input file.

PyTorch port of ludwig_tpu/ludwig.py (ref:
src/ludwig.c:443 ludwig_run, src/main.c:30-46): the plain single fluid
(`free_energy none`, with isothermal fluctuations, halo or in-lattice
plane walls - moving or with slip -, the open boundary, Lees-Edwards
planes and porous media, or with resolved or subgrid colloids:
colloids.py, colloids_fast.py, subgrid.py), the symmetric binary fluid (`free_energy
symmetric` and `symmetric_noise`: every route of the JAX package's
binary branch - halo walls and the open boundary, porous media with
wetting, its stencils, advection orders, force methods, viscosity
model, noise and Lees-Edwards planes; binary.py, binary_le.py and the
fused step; `symmetric` with resolved colloids, binary_colloid.py), the blue-phase liquid crystal
(`free_energy lc_blue_phase`: every route of the JAX package's branch -
halo walls with the anchoring stencils, porous solids, resolved
colloids, the dynamic redshift, the electric field, `hydrodynamics off`,
advection orders 1-5, the random rectangle, the Q noise (`lc_noise 1`,
the unfused step) and Lees-Edwards planes; lc.py, lc_colloid.py and the
fused step), the
liquid-crystal droplet (`free_energy lc_droplet`, on the
stress-divergence, hydrodynamics-on route the JAX package's fused path
accepts, periodic or with Lees-Edwards planes: lc_droplet.py and its
fused step), and
electrokinetics (`free_energy fe_electro`: Gouy-Chapman walls, liquid
junction or a uniform electrolyte; charged resolved colloids,
electro_colloid.py), and the other free energies, unfused: `brazovskii`
(binary.py with the fourth-order fields, binary_le.py), `surfactant` and
`ternary` (two_field.py), `symmetric_lb` with or without resolved
colloids (binary_lb.py), `polar_active` (polar.py) and
`fe_electro_symmetric` (electro_symm.py).  It parses the same
key-value input, builds the system, runs the time loop on a device (the
GPU unless the caller asks for the CPU), writes the statistics blocks in
the reference's formats and the same checkpoint and field files
(io_directory, freq_config, config_at_end, N_start, freq_phi, freq_vel,
freq_psi), the colloids' config.cds (colloid_io_freq) and shear
observables (freq_shear_measurement, freq_shear_output).
`tpu_fused on` (or `interpret`) selects the fused steps:
ops.fused.fused_step for the plain fluid (with fluctuations, its
FusedNoise counter-hash stream where the JAX package takes its fused
kernel; elsewhere - `tpu_fused off`, float64 under `on`, a lattice with
no fused-kernel plan - the reference-exact per-site KISS stream through
lb.make_step, as the JAX package does), with halo walls or Lees-Edwards
planes ops.fused.make_fused_wall_step / make_fused_le_step (the same
kernel and an O(surface) post-pass),
ops.fused_binary.make_fused_binary_step, ops.fused_lc.make_fused_lc_step
and ops.fused_droplet.make_fused_droplet_step (two kernels each, K1 and
K2) for the binary fluid, the liquid crystal and the droplet; the
hand-written CUDA kernels on a GPU and their twins on the CPU.  The
electrokinetic step picks its route by dtype, as the JAX package's
does: float32 runs the SOR, Nernst-Planck and solid LB kernels,
float64 the reference route (electro_sim.py).

The statistics follow the JAX package's rule (reference_statistics):
its reference-ordered scans wherever its build_system would take the
unfused route, its plain reductions on its fused routes.

The log is the JAX package's whole reference log: the input header
(fulllog.InitLog), the statistics, the timer table (with
`tpu_timer_detail`, each phase of the step launched alone), the unused
keys and "Ludwig finished normally.".  The harness's hint keys (a
leading `_`, utils/golden.py) select the formats of older log vintages
where the JAX package reads them.  `freq_measure` writes the colloids'
output and, with `calibration_sigma`, the binary fluid's surface-tension
calibration of a drop (stats_extra.SigmaCalibration);
`stats_vel_print_vol_flux yes` adds the [vol flux] row.

The fluctuation keys (`temperature`, `isothermal_fluctuations` /
`lb_fluctuations`, `random_seed`) build the LB noise of every family, as
the JAX package's do (_noise_config): the plain fluid (its fused or KISS
steps, the colloids' KISS stream at the fluid sites, the subgrid
particles' Langevin kicks from their LCG words), the binary fluid,
Brazovskii and symmetric_lb draw it; the other families' steps, and the
colloid steps of the binary, symmetric_lb, electrolyte and LC families,
draw none, as in the JAX package, and print the kT statistics.
`lc_noise 1` with `temperature` draws the Q noise of the liquid
crystal's unfused step (lc.LCConfig.noise_kt); `lc_noise on`, on which
the JAX package's log header fails, raises.

An input key the JAX package honours and the port cannot, here, raises
NotImplementedError naming the key, unless it is set to its inactive
default (`boundary_walls 0_0_0` for the families without walls,
`colloid_init no_colloids` for those without a colloid route, ...;
JAX_KEYS, _check_keys).  Any other key
runs: the log's tail reports it if nothing read it, as the JAX
package's does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ludwig_tpu_torch import stats
from ludwig_tpu_torch.binary import (GRADIENT, BinaryConfig,
                                     OpenXScalarOps, binary_solid_ops, fe_fields,
                                     initial_binary, make_binary_open_step,
                                     make_binary_step, open_x_scalar_ops)
from ludwig_tpu_torch.binary_le import BinaryLEConfig, make_binary_le_step
from ludwig_tpu_torch.binary_lb import (BinaryLBConfig, binary_lb_solid_ops,
                                        g_moments, initial_binary_lb,
                                        initial_binary_lb_colloid,
                                        make_binary_lb_colloid_step,
                                        make_binary_lb_step)
from ludwig_tpu_torch import (binary_colloid, electro_colloid, electro_sim,
                              interactions, lc, lc_colloid, lc_droplet)
from ludwig_tpu_torch.colloids import (ColloidParams, ColloidState, TYPES,
                                       build_map, make_colloid_step,
                                       total_colloid_momentum)
from ludwig_tpu_torch.ewald import ewald_sum
from ludwig_tpu_torch.io.colloid_io import (default_state, read_colloid_file,
                                            write_colloid_file)
from ludwig_tpu_torch.electro import ElectroConfig, fe_electro_fed, rho_elec
from ludwig_tpu_torch.electro_symm import (ElectroSymmConfig,
                                           initial_electro_symm,
                                           make_electro_symm_step)
from ludwig_tpu_torch.fe import lc_init
from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE
from ludwig_tpu_torch.fe.brazovskii import BrazovskiiFE
from ludwig_tpu_torch.fe.electro_symmetric import ElectroSymmetricFE
from ludwig_tpu_torch.fe.lc_droplet import LCDropletFE
from ludwig_tpu_torch.fe.polar_active import PolarActiveFE
from ludwig_tpu_torch.fe.surfactant import SurfactantFE
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.fe.ternary import TernaryFE
from ludwig_tpu_torch.io import read_state, write_sharded, write_state
from ludwig_tpu_torch.io.map_file import GEOMETRIES, read_map
from ludwig_tpu_torch.io.ref_format import write_ref_field
from ludwig_tpu_torch.lb import (LBConfig, hydro_fields, initial_from_hydro,
                                 initial_rest, kiss_on, make_step,
                                 make_wall_step, solid_mask)
from ludwig_tpu_torch.noise import NoiseConfig, var_bulk, var_eta, var_ghost
from ludwig_tpu_torch.noise_kiss import kiss_init
from ludwig_tpu_torch.polar import (PolarConfig, initial_polar,
                                    make_polar_step, polar_fields,
                                    polar_init_aster)
from ludwig_tpu_torch.ops.collide import RelaxationScheme
from ludwig_tpu_torch.ops.fused import (FusedNoise, fused_step,
                                        make_fused_le_step,
                                        make_fused_wall_step)
from ludwig_tpu_torch.ops.fused_binary import (binary_phi_force_step,
                                               fused_binary_ok,
                                               initial_fused_binary,
                                               make_fused_binary_le_step,
                                               make_fused_binary_step)
from ludwig_tpu_torch.ops.fused_droplet import (droplet_phi_q_force_step,
                                                fused_droplet_ok,
                                                initial_fused_droplet,
                                                make_fused_droplet_le_step,
                                                make_fused_droplet_step)
from ludwig_tpu_torch.ops.fused_lc import (initial_fused_lc,
                                           make_fused_lc_le_step,
                                           make_fused_lc_step)
from ludwig_tpu_torch.ops.lc_anchor import AnchoringParams
from ludwig_tpu_torch.ops.le_ref import le_fields_2d5pt_d4, le_gradient
from ludwig_tpu_torch.ops.lees_edwards import (LeesEdwardsConfig,
                                               le_init_shear_profile)
from ludwig_tpu_torch.ops.open_bc import OpenBCConfig
from ludwig_tpu_torch.ops.solid_stencil import (solid27_scalar_ops,
                                                ternary_solid_ops)
from ludwig_tpu_torch.ops.stencil import delsq_7pt, grad_7pt
from ludwig_tpu_torch.ops.walls import WallSpec
from ludwig_tpu_torch.ref_rng import RanSerial, patches_ref, spinodal_ref
from ludwig_tpu_torch.runtime import RunTime
from ludwig_tpu_torch.fulllog import InitLog
from ludwig_tpu_torch.stats_extra import (AhydroCalibration, SigmaCalibration,
                                          RheologyAccumulator,
                                          interact_stats_lines)
from ludwig_tpu_torch.subgrid import make_subgrid_step
from ludwig_tpu_torch.two_field import (TwoFieldConfig, initial_two_field,
                                        make_two_field_step,
                                        ternary_surface_fe, two_fields)
from ludwig_tpu_torch.visc import ViscArrhenius


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
    "hydrodynamics",
    # checkpoints and field files (the periodicity is recorded in the
    # field files' metadata), the shear observables (str-%08d.dat)
    "periodicity", "io_directory", "N_start", "config_at_end",
    "freq_config", "freq_phi", "freq_vel", "freq_shear_measurement",
    "freq_shear_output",
    # the measurements (the binary families' surface-tension calibration,
    # the colloids' output), the volume flux line, the timer probes; the
    # decomposition hint is a no-op on one device, as in the JAX package
    # without tpu_shard
    "freq_measure", "calibration_sigma", "stats_vel_print_vol_flux",
    "tpu_timer_detail", "grid",
    # the fluctuations, which every family reads as the JAX package does
    # (its ludwig.py:603-617): the LB noise where its step draws it, the
    # kT statistics wherever it is on; the Q noise (lc_noise) is the
    # liquid crystal's and ignored elsewhere
    "temperature", "isothermal_fluctuations", "lb_fluctuations",
    "random_seed", "lc_noise"))

# Lees-Edwards planes of the binary, LC and droplet families (the plain
# fluid reads N_LE_plane and LE_plane_vel with its boundaries)
LE_KEYS = frozenset(("N_LE_plane", "LE_plane_vel", "LE_init_profile"))

# keys the binary fluid reads (free_energy symmetric and symmetric_noise):
# its stencils, advection orders, force methods and grad_mu, the
# viscosity model, halo walls and the open boundary beside them, porous
# media with their wetting data, the fluctuations of phi, and
# Lees-Edwards planes
BINARY_KEYS = frozenset((
    "A", "B", "K", "symmetric_a", "symmetric_b", "symmetric_kappa",
    "mobility", "fd_advection_scheme_order", "fd_gradient_calculation",
    "fe_force_method", "grad_mu", "phi_initialisation", "phi0",
    "random_seed", "noise", "phi_init_drop_radius",
    "phi_init_drop_amplitude", "phi_init_drop_centred",
    "phi_init_block_dimension", "phi_init_patch_size", "phi_init_patch_vol",
    "LE_oscillation_period", "viscosity_model",
    "viscosity_arrhenius_eta_minus", "viscosity_arrhenius_eta_plus",
    "viscosity_arrhenius_phistar", "boundary_walls", "lb_bc_open",
    "lb_bc_inflow_rhou_u0", "lb_bc_outflow_rhou_rho0",
    "phi_bc_inflow_fixed_phib", "porous_media_file", "porous_media_ndata",
    "porous_media_type", "porous_media_format", "porous_media_init",
    "porous_media_acell", "fd_phi_fluctuations")) | LE_KEYS

# keys the liquid crystal reads (free_energy lc_blue_phase only): the
# free energy with its electric field, the dynamic redshift, the anchoring
# of the solid stencils in both styles, the Q initialisations and the
# random rectangle; halo walls, porous media (SOLID_KEYS), Lees-Edwards
# planes and resolved colloids (COLLOID_KEYS and COLLOID_PREFIXES, defined
# below, join them in FREE_ENERGIES).
LC_KEYS = frozenset((
    "lc_a0", "lc_gamma", "lc_q0", "lc_kappa0", "lc_kappa1", "lc_xi",
    "lc_Gamma", "lc_init_redshift", "lc_activity", "lc_active_zeta0",
    "lc_active_zeta", "lc_active_zeta1", "lc_q_initialisation",
    "lc_q_init_amplitude", "lc_q_init_euler_angles", "lc_init_nematic",
    "lc_q_init_rectangle_min", "lc_q_init_rectangle_max",
    "fd_advection_scheme_order", "fd_gradient_calculation",
    "lc_dielectric_anisotropy", "electric_e0", "lc_redshift_update",
    "lc_anchoring_method", "lc_wall_anchoring", "lc_coll_anchoring",
    "lc_anchoring_strength", "lc_anchoring_strength_2",
    "lc_anchoring_strength_colloid", "lc_anchoring_strength_wall",
    "lc_wall_anchoring_w1", "lc_wall_anchoring_w2", "lc_coll_anchoring_w1",
    "lc_coll_anchoring_w2", "lc_wall_fixed_orientation")) | LE_KEYS

# keys the droplet slice reads (free_energy lc_droplet only)
DROPLET_KEYS = frozenset((
    "A", "B", "K", "symmetric_a", "symmetric_b", "symmetric_kappa",
    "phi_initialisation", "phi0", "random_seed", "noise",
    "phi_init_drop_radius", "phi_init_drop_amplitude",
    "phi_init_drop_centred", "phi_init_block_dimension", "mobility",
    "lc_a0", "lc_gamma", "lc_q0", "lc_kappa0", "lc_kappa1", "lc_xi",
    "lc_Gamma", "lc_init_redshift", "lc_q_initialisation",
    "lc_q_init_amplitude", "lc_init_nematic", "lc_droplet_gamma",
    "lc_droplet_delta", "lc_droplet_W", "fd_advection_scheme_order",
    "fd_gradient_calculation", "fe_force_method")) | LE_KEYS

# keys the electrokinetic slice reads (free_energy fe_electro only);
# temperature (SLICE_KEYS) is the electrolyte's kT here and, with
# isothermal_fluctuations, the kT of the statistics (the step draws no LB
# noise, as in the JAX package)
ELECTRO_KEYS = frozenset((
    "electrokinetics_z0", "electrokinetics_z1",
    "electrokinetics_d0", "electrokinetics_d1", "electrokinetics_eunit",
    "electrokinetics_epsilon", "electrokinetics_solver_type",
    "electrokinetics_rel_tol", "electrokinetics_abs_tol",
    "electrokinetics_maxits", "electrokinetics_multisteps",
    "electrokinetics_solver_stencil", "electric_e0",
    "electrokinetics_init", "electrokinetics_init_rho_el",
    "electrokinetics_init_sigma", "electrokinetics_init_delta_el",
    "freq_psi_resid", "freq_psi"))

# keys the plain fluid reads for its boundaries (free_energy none only;
# the other families refuse walls, Lees-Edwards planes and porous media
# while they are on): halo or in-lattice plane walls, moving or with
# slip, the open boundary beside halo walls, Lees-Edwards planes, and
# porous media from a map file, a .npy mask or a geometry
BOUNDARY_KEYS = frozenset((
    "boundary_walls", "boundary_speed_bottom", "boundary_speed_top",
    "boundary_walls_slip_fraction_bot", "boundary_walls_slip_fraction_top",
    "boundary_walls_slip_active", "lb_bc_open", "lb_bc_inflow_rhou_u0",
    "lb_bc_outflow_rhou_rho0", "N_LE_plane", "LE_plane_vel",
    "porous_media_file", "porous_media_ndata", "porous_media_type",
    "porous_media_format", "porous_media_init", "porous_media_acell"))

# keys the colloid routes read (the plain fluid's resolved or subgrid
# colloids, and the resolved ones of the binary fluid, symmetric_lb, the
# electrolyte and the liquid crystal): placement, the particles' keys colloid_one_* ... three_*
# (COLLOID_PREFIXES), interactions, walls around the suspension, the
# dipolar Ewald sum and the colloid I/O
COLLOID_KEYS = frozenset((
    "colloid_init", "colloid_rebuild_freq", "colloid_random_no",
    "colloid_random_dh", "colloid_random_a0", "colloid_random_ah",
    "colloid_random_type", "colloid_file_stub", "colloid_gravity",
    "random_seed", "angle_cosine_on", "angle_cosine_k", "bond_fene_on",
    "bond_fene_k", "bond_fene_r0", "pair_ss_cut_ij", "pair_ss_cut_ij_ntypes",
    "pair_ss_cut_ij_epsilon", "pair_ss_cut_ij_sigma", "pair_ss_cut_ij_nu",
    "pair_ss_cut_ij_hc", "soft_sphere_on", "soft_sphere_epsilon",
    "soft_sphere_sigma", "soft_sphere_nu", "soft_sphere_cutoff",
    "lennard_jones_on", "lj_epsilon", "lj_sigma", "lj_cutoff", "yukawa_on",
    "yukawa_epsilon", "yukawa_kappa", "yukawa_cutoff",
    "driving_force_magnitude", "lubrication_on",
    "lubrication_normal_cutoff", "lubrication_tangential_cutoff",
    "boundary_lubrication_rcnormal", "boundary_lubrication_dhnormal",
    "wall_ss_cut_on", "wall_ss_cut_epsilon", "wall_ss_cut_sigma",
    "wall_ss_cut_nu", "wall_ss_cut_hc", "ewald_sum", "ewald_mu", "ewald_rc",
    "magnetic_b0", "colloid_io_freq", "calibration"))
COLLOID_PREFIXES = ("colloid_one_", "colloid_two_", "colloid_three_")

# the phi initialisations (_phi_init) and the in-lattice solids (walls
# kept as solid planes, porous media) the other families read
PHI_INIT_KEYS = frozenset((
    "phi_initialisation", "phi0", "random_seed", "noise",
    "phi_init_drop_radius", "phi_init_drop_amplitude",
    "phi_init_drop_centred", "phi_init_block_dimension",
    "phi_init_patch_size", "phi_init_patch_vol", "phi_init_width"))
SOLID_KEYS = frozenset((
    "boundary_walls", "porous_media_file", "porous_media_ndata",
    "porous_media_type", "porous_media_format", "porous_media_init",
    "porous_media_acell"))

# free_energy brazovskii: the binary fluid's unfused step with in-lattice
# solids, or sheared by Lees-Edwards planes
BRAZOVSKII_KEYS = frozenset((
    "A", "B", "K", "C", "mobility", "fd_advection_scheme_order",
    "fd_gradient_calculation", "LE_oscillation_period")) | PHI_INIT_KEYS \
    | SOLID_KEYS | LE_KEYS

# free_energy surfactant and ternary (two_field.py): in-lattice solids, or
# halo walls with the ternary wetting stencils
TWO_FIELD_KEYS = frozenset((
    "mobility", "fd_advection_scheme_order", "fd_gradient_calculation",
    "fe_force_method", "psi_initialisation", "psi_initialisation_psi0")) \
    | PHI_INIT_KEYS | SOLID_KEYS
SURFACTANT_KEYS = TWO_FIELD_KEYS | frozenset((
    "surf_A", "surf_B", "surf_kappa", "surf_kT", "surf_epsilon", "surf_beta",
    "surf_W", "surf_mobility_phi", "surf_mobility_psi", "surf_psi0"))
TERNARY_KEYS = TWO_FIELD_KEYS | frozenset((
    "ternary_alpha", "ternary_kappa1", "ternary_kappa2", "ternary_kappa3",
    "ternary_h1", "ternary_h2", "ternary_mobility_phi",
    "ternary_mobility_psi", "ternary_psi0", "ternary_initialisation",
    "2d_double_emulsion_xf1", "2d_double_emulsion_xf2",
    "2d_double_emulsion_xf3", "2d_double_emulsion_yf1",
    "2d_double_emulsion_yf2", "ternary_2d_tee_xf1",
    "tarnary_2d_tee_yf1"))   # (sic: the key the JAX package reads)

# free_energy symmetric_lb (binary_lb.py): halo walls and Lees-Edwards
# planes
SYMMETRIC_LB_KEYS = frozenset((
    "A", "B", "K", "symmetric_a", "symmetric_b", "symmetric_kappa",
    "mobility", "fd_gradient_calculation", "boundary_walls",
    "LE_oscillation_period")) | PHI_INIT_KEYS | LE_KEYS

# free_energy polar_active (polar.py): the aster, in-lattice solids
POLAR_KEYS = frozenset((
    "polar_active_a", "polar_active_b", "polar_active_k", "polar_active_dk",
    "polar_active_lambda", "polar_active_zeta", "leslie_ericksen_gamma",
    "leslie_ericksen_swim", "fd_advection_scheme_order",
    "fd_gradient_calculation", "polar_active_initialisation")) | SOLID_KEYS

# free_energy fe_electro_symmetric (electro_symm.py): the electrolyte's
# keys, the symmetric free energy's and the coupling's
ELECTRO_SYMM_KEYS = ELECTRO_KEYS | PHI_INIT_KEYS | frozenset((
    "A", "B", "K", "symmetric_a", "symmetric_b", "symmetric_kappa",
    "mobility", "fd_advection_scheme_order", "fd_gradient_calculation",
    "fe_force_method", "electrokinetics_epsilon1", "electrokinetics_epsilon2",
    "electrosymmetric_delta_mu0", "electrosymmetric_delta_mu1"))

# free energy -> the keys it reads beside SLICE_KEYS
FREE_ENERGIES = {"none": BOUNDARY_KEYS | COLLOID_KEYS,
                 "symmetric": BINARY_KEYS | COLLOID_KEYS,
                 "symmetric_noise": BINARY_KEYS,
                 "lc_blue_phase": LC_KEYS | SOLID_KEYS | COLLOID_KEYS,
                 "lc_droplet": DROPLET_KEYS | SOLID_KEYS,
                 "fe_electro": ELECTRO_KEYS | SOLID_KEYS | COLLOID_KEYS
                 | frozenset((
                     "fe_force_method",)),
                 "brazovskii": BRAZOVSKII_KEYS,
                 "surfactant": SURFACTANT_KEYS, "ternary": TERNARY_KEYS,
                 "symmetric_lb": SYMMETRIC_LB_KEYS | COLLOID_KEYS,
                 "polar_active": POLAR_KEYS,
                 "fe_electro_symmetric": ELECTRO_SYMM_KEYS}

# the families with resolved colloids (their keys, COLLOID_PREFIXES too)
COLLOID_FAMILIES = ("none", "lc_blue_phase", "symmetric", "symmetric_lb",
                    "fe_electro")


# keys of features outside the slices, accepted while they leave them off
def _no_colloids(v: str) -> bool:
    """colloid_init values that place no particles (ludwig_tpu ludwig.py:
    342: only input_* and from_file do)."""
    return not (v.startswith("input_") or v == "from_file")


INACTIVE = {
    "viscosity_model": lambda v: v == "newtonian",
    # colloids of the families without a colloid route
    "colloid_init": _no_colloids,
    "boundary_walls": _zeros,
    "lc_redshift_update": _off,
    "electric_e0": _zeros,
    "N_LE_plane": _zeros,
    "lb_bc_open": _off,
    "tpu_shard": _off,
    "freq_psi": _zeros,
    "colloid_io_freq": _zeros,
}

# every input key the JAX package's modules read (its rt.* calls outside
# fulllog.py, whose reads only print the input header), beside the
# particles' keys (COLLOID_PREFIXES) and the I/O grids (<name>_io_grid):
# a key among them that the port does not honour for the input's free
# energy is refused by name; any other key runs, and the log's tail
# reports it if nothing read it, as the JAX package's does
JAX_KEYS = (SLICE_KEYS | frozenset().union(*FREE_ENERGIES.values())
            | frozenset(INACTIVE)
            | frozenset(("free_energy", "default_io_grid")))


def _jax_reads(key: str) -> bool:
    return (key in JAX_KEYS or key.startswith(COLLOID_PREFIXES)
            or key.endswith("_io_grid"))


def _not_ported(key: str, value):
    return NotImplementedError(
        f"input key '{key}' (value '{value}') is not ported yet, see ROADMAP")


def _check_keys(rt: RunTime):
    """Raise on any key the JAX package honours and the port cannot, here
    for this free energy (its inactive values apart); accept the rest.
    The values are peeked at: which keys the run reads, and so which the
    log reports as unused, is the code's business."""
    fe_name = rt.string("free_energy", "none")
    if fe_name not in FREE_ENERGIES:
        raise _not_ported("free_energy", fe_name)
    for key in rt.unused_keys():
        if key in SLICE_KEYS or key in FREE_ENERGIES[fe_name]:
            continue
        if (fe_name in COLLOID_FAMILIES
                and key.startswith(COLLOID_PREFIXES)):
            continue
        if not _jax_reads(key) or key.endswith("_io_grid"):
            continue
        check = INACTIVE.get(key)
        value = rt.peek(key)
        if check is None or not check(value):
            raise _not_ported(key, value)


@dataclasses.dataclass
class System:
    """A configured simulation: state + step + reporting."""

    rt: RunTime
    lb_cfg: LBConfig
    # (f,) or, with the KISS noise stream, (f, nstate); halo walls (f,
    # gwall[, nstate]); binary (f, phi, u[, gwall][, nstate_phi][,
    # nstate_rho]) or, sheared, (f, phi, u[, nstate][, grad, delsq]); LC
    # (f, q5, u[, gwall][, redshift][, grad, delsq]) or, with colloids,
    # (f, R, V, W, dr, Rmap, M, q5, u, grad, delsq[, gwall]); droplet (f,
    # phi, q5, u); electrokinetics (f, psi, rho, u, gwall)
    state: tuple
    step_fn: object
    # 'plain': fused collide+stream; 'wall', 'le': the same with the wall
    # fix or the Lees-Edwards column post-pass; 'binary', 'lc',
    # 'droplet': their two kernels
    fused_mode: Optional[str] = None
    hydro_on: bool = True
    binary_cfg: Optional[BinaryConfig] = None
    lc_cfg: Optional[lc.LCConfig] = None
    droplet_cfg: Optional[lc_droplet.LCDropletConfig] = None
    electro_cfg: Optional[electro_sim.ElectroSimConfig] = None
    solid: Optional[torch.Tensor] = None     # in-lattice solid sites
    wallspec: Optional[WallSpec] = None      # plain-fluid halo walls
    le_cfg: Optional[LeesEdwardsConfig] = None   # Lees-Edwards planes
    # the state ends with the gradients (grad, delsq) of the step's
    # pre-update order parameter (_keeps_grads)
    keep_grads: bool = False
    # resolved or subgrid colloids: (f, R, V, W, dr, Rmap, M) as a
    # ColloidState, or the subgrid (f, R, V)
    colloid_params: Optional[ColloidParams] = None
    subgrid: bool = False
    # the electrolyte's particles: their input charges (N, 2) on the
    # device; the state (f, R, V, W, dr, Rmap, M, psi, rho, u, deltaq)
    colloid_charge: Optional[torch.Tensor] = None
    # a fused route where the JAX package's route keeps the gradients:
    # (field, t) -> (grad, delsq) of the pre-update field of step t, the
    # checkpoint's state03 / state04 (_grad_leaves)
    grad_leaves: Optional[object] = None
    # the binary fluid's (grad, delsq) stencils for its statistics where
    # they are not the configuration's fluid ones: the wetting-aware
    # solid stencils the step shares, or the open boundary's; the two
    # ternary wetting stencils of a two-field run
    fe_ops: Optional[object] = None
    n_start: int = 0                         # the step a restart reads
    vol_flux: bool = False                   # stats_vel_print_vol_flux
    # the other free energies: surfactant and ternary (f, phi, psi, u[,
    # gwall]); symmetric_lb (f, g, u[, gwall][, nstate][, grad, delsq]);
    # the polar gel (f, p, u); fe_electro_symmetric (f, phi, psi, rho_k,
    # u) beside its electro_cfg
    two_field_cfg: Optional[TwoFieldConfig] = None
    lb2_cfg: Optional[BinaryLBConfig] = None
    polar_cfg: Optional[PolarConfig] = None
    es_cfg: Optional[ElectroSymmConfig] = None

    @property
    def fluid_mask(self) -> Optional[torch.Tensor]:
        return None if self.solid is None else torch.logical_not(self.solid)

    # the families, as the JAX package's System names them (its
    # ludwig.py:81-112); the input header (fulllog.py) reads them
    @property
    def is_binary(self) -> bool:
        return self.binary_cfg is not None

    @property
    def is_lc(self) -> bool:
        return self.lc_cfg is not None

    @property
    def is_two_field(self) -> bool:
        return self.two_field_cfg is not None

    @property
    def is_droplet(self) -> bool:
        return self.droplet_cfg is not None

    @property
    def is_polar(self) -> bool:
        return self.polar_cfg is not None

    @property
    def is_binary_lb(self) -> bool:
        return self.lb2_cfg is not None

    @property
    def is_electro(self) -> bool:
        return self.electro_cfg is not None

    @property
    def is_colloid(self) -> bool:
        return self.colloid_params is not None

    @property
    def n_fields(self) -> int:
        """The order-parameter leaves after f: phi (binary), Q (liquid
        crystal), phi and Q (droplet), phi and psi (two-field), g
        (symmetric_lb), P (polar); u follows them, then the kept
        gradients."""
        if self.droplet_cfg is not None or self.two_field_cfg is not None:
            return 2
        return int(self.binary_cfg is not None or self.lc_cfg is not None
                   or self.lb2_cfg is not None or self.polar_cfg is not None)

    @property
    def has_kiss(self) -> bool:
        """The plain unfused step carries the per-site KISS state:
        (f, nstate)."""
        return self.fused_mode is None and kiss_on(self.lb_cfg)


def _device(device) -> str:
    """The device an entry point runs on; a CUDA device that is not there
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{device}' asked for, but no CUDA device is visible; "
            "pass device='cpu' (--device cpu) to run the plain twins on "
            "the CPU")
    return str(dev)


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


def _symm_fe(rt: RunTime) -> SymmetricFE:
    """Symmetric FE parameters; both the legacy A/B/K spellings and the
    preferred symmetric_a/b/kappa names are accepted (ref:
    symmetric_rt.c:45-86)."""
    if rt.has_key("symmetric_a"):
        return SymmetricFE(a=rt.double_required("symmetric_a"),
                           b=rt.double_required("symmetric_b"),
                           kappa=rt.double_required("symmetric_kappa"))
    return SymmetricFE(a=rt.double_required("A"),
                       b=rt.double_required("B"),
                       kappa=rt.double_required("K"))


def _phi_init(rt: RunTime, size, fe=None) -> np.ndarray:
    """phi initialisation modes, on the host (ref: src/phi_rt.c /
    field_phi_init.c).  fe gives the interface width xi0 of the drop and
    block modes; without one (the Brazovskii and ternary free energies)
    the phi_init_width key does."""
    if fe is None:
        fe = argparse.Namespace(xi0=rt.double("phi_init_width", 1.0))
    mode = rt.string("phi_initialisation", "spinodal")
    phi0 = rt.double("phi0", 0.0)
    seed = rt.int("random_seed", 13)
    if mode == "spinodal":
        return spinodal_ref(size, seed, phi0, amp=rt.double("noise", 0.1))
    if mode == "patches":
        return patches_ref(size, seed,
                           patch=rt.int("phi_init_patch_size", 1),
                           volminus1=rt.double("phi_init_patch_vol", 0.5))
    if mode == "uniform":
        return np.full(size, phi0)
    if mode == "drop":
        # centre at 0.5 L in 1-based site coordinates (ref:
        # field_phi_init.c:60-75, is_centred = 0 default)
        radius = rt.double("phi_init_drop_radius", 0.25 * size[0])
        amp = rt.double("phi_init_drop_amplitude", 1.0)
        centred = 0.5 if rt.switch("phi_init_drop_centred") else 0.0
        x = np.arange(1, size[0] + 1) - centred - 0.5 * size[0]
        y = np.arange(1, size[1] + 1) - centred - 0.5 * size[1]
        z = np.arange(1, size[2] + 1) - centred - 0.5 * size[2]
        r = np.sqrt(x[:, None, None] ** 2 + y[None, :, None] ** 2
                    + z[None, None, :] ** 2)
        return amp * np.tanh((r - radius) / fe.xi0)
    if mode == "block":
        # slab with interfaces at z = L/4 and 3L/4
        # (ref: field_phi_init.c field_phi_init_block)
        z = np.arange(1, size[2] + 1, dtype=np.float64)
        lz = float(size[2])
        prof = np.where(z > 0.5 * lz, np.tanh((z - 0.75 * lz) / fe.xi0),
                        -np.tanh((z - 0.25 * lz) / fe.xi0))
        return np.broadcast_to(prof[None, None, :], size).copy()
    if mode in ("block_X", "block_Y", "block_Z"):
        # central block of given width along one axis (ref:
        # field_phi_init.c field_phi_init_block_X/Y/Z; coordinate is
        # the plain 1-based global index, no 0.5 offset)
        axis = {"block_X": 0, "block_Y": 1, "block_Z": 2}[mode]
        width = rt.double("phi_init_block_dimension", 10.0)
        ln = float(size[axis])
        x = np.arange(1, size[axis] + 1, dtype=np.float64)
        x1 = 0.5 * (ln - width)
        x2 = 0.5 * (ln + width)
        prof = np.where(x > 0.5 * ln, np.tanh((x - x2) / fe.xi0),
                        -np.tanh((x - x1) / fe.xi0))
        shape = [1, 1, 1]
        shape[axis] = size[axis]
        return np.broadcast_to(prof.reshape(shape), size).copy()
    raise _not_ported("phi_initialisation", mode)


_FORCE_METHODS = ("no_force", "stress_divergence", "phi_gradmu",
                  "phi_gradmu_correction", "relaxation_symmetric",
                  "relaxation_antisymmetric")


def _binary_config(rt: RunTime, lb_cfg: LBConfig,
                   wetting=(0.0, 0.0)) -> BinaryConfig:
    """The `free_energy symmetric` / `symmetric_noise` configuration
    (ludwig_tpu ludwig.py:884-904): the stencil, advection order, force
    method, external chemical-potential gradient, viscosity model and
    wetting (the porous map's per-site (C, H)).  The force methods other
    than stress_divergence and phi_gradmu (the JAX package runs them as
    stress_divergence) raise naming fe_force_method, as does a viscosity
    model other than arrhenius."""
    size = lb_cfg.size
    method = rt.string("fe_force_method", "stress_divergence")
    if method not in _FORCE_METHODS:
        raise ValueError(f"fe_force_method '{method}' not recognised")
    if method not in ("stress_divergence", "phi_gradmu"):
        raise _not_ported("fe_force_method", method)
    visc = rt.string("viscosity_model", "newtonian")
    visc_model = None
    if visc == "arrhenius":
        # ref: visc_rt.c, visc_arrhenius.c
        visc_model = ViscArrhenius(
            eta_minus=rt.double_required("viscosity_arrhenius_eta_minus"),
            eta_plus=rt.double_required("viscosity_arrhenius_eta_plus"),
            phistar=rt.double("viscosity_arrhenius_phistar", 1.0))
    elif visc != "newtonian":
        raise _not_ported("viscosity_model", visc)
    return BinaryConfig(
        lb=lb_cfg, fe=_symm_fe(rt), mobility=rt.double("mobility", 1.0),
        advection_order=rt.int("fd_advection_scheme_order", 1),
        gradient=rt.string("fd_gradient_calculation",
                           GRADIENT if size[2] > 1 else "2d_5pt_fluid"),
        hydrodynamics=rt.switch("hydrodynamics", True),
        force_method=method,
        gradmu_ex=tuple(rt.double_vector("grad_mu", (0.0, 0.0, 0.0))),
        visc_model=visc_model, wetting=wetting)


def _blue_phase_fe(rt: RunTime, active: bool,
                   efield: bool = False) -> BluePhaseFE:
    """The blue-phase free energy's parameters (ref: blue_phase_rt.c), the
    active stress's zetas only where `active`, the electric field where
    `efield` (the liquid crystal's, not the droplet's): the raw
    anisotropy over 12 pi, as the free energy carries it (ref:
    blue_phase.c:252; ludwig_tpu ludwig.py:1193-1197)."""
    if efield:
        return dataclasses.replace(
            _blue_phase_fe(rt, active),
            epsilon=rt.double("lc_dielectric_anisotropy", 0.0)
            / (12.0 * np.pi),
            e0=tuple(rt.double_vector("electric_e0", (0.0, 0.0, 0.0))))
    return BluePhaseFE(
        a0=rt.double_required("lc_a0"),
        gamma=rt.double_required("lc_gamma"),
        q0=rt.double_required("lc_q0"),
        kappa0=rt.double_required("lc_kappa0"),
        kappa1=rt.double_required("lc_kappa1"),
        xi=rt.double("lc_xi", 0.0),
        redshift=rt.double("lc_init_redshift", 1.0),
        zeta0=rt.double("lc_active_zeta0", 0.0) if active else 0.0,
        zeta1=(rt.double("lc_active_zeta", 0.0) or
               rt.double("lc_active_zeta1", 0.0)) if active else 0.0)


def _lc_anchoring_params(rt: RunTime, fe: BluePhaseFE) -> AnchoringParams:
    """The anchoring keys in both styles, 'two' (the older one) and 's7'
    (ludwig_tpu ludwig.py:294-330; ref: src/blue_phase_rt.c:192-380)."""
    method = rt.string("lc_anchoring_method", "s7")
    nfix = rt.double_vector("lc_wall_fixed_orientation", (0.0, 1.0, 0.0))
    nrm = np.sqrt(sum(c * c for c in nfix)) or 1.0
    nfix = tuple(c / nrm for c in nfix)
    if method == "two":
        coll = rt.string("lc_coll_anchoring", "none")
        wall = rt.string("lc_wall_anchoring", coll)
        w1 = rt.double("lc_anchoring_strength", 0.0)
        w2 = rt.double("lc_anchoring_strength_2", 0.0)
        w1_wall, w2_wall = w1, (w2 if wall == "planar" else 0.0)
        w1_coll, w2_coll = w1, w2
        if coll in ("normal", "fixed"):
            w2_coll = 0.0
        wc = rt.double("lc_anchoring_strength_colloid", None)
        if wc is not None:
            w1_coll = wc
            w2_coll = wc if coll == "planar" else 0.0
        ww = rt.double("lc_anchoring_strength_wall", None)
        if ww is not None:
            w1_wall = ww
            w2_wall = ww if wall == "planar" else 0.0
    else:
        wall = rt.string("lc_wall_anchoring", "none")
        coll = rt.string("lc_coll_anchoring", "none")
        w1_wall = rt.double("lc_wall_anchoring_w1", 0.0)
        w2_wall = rt.double("lc_wall_anchoring_w2", 0.0)
        w1_coll = rt.double("lc_coll_anchoring_w1", 0.0)
        w2_coll = rt.double("lc_coll_anchoring_w2", 0.0)
    return AnchoringParams(
        kappa0=fe.kappa0, kappa1=fe.kappa1, q0=fe.q0,
        amplitude=fe.amplitude0,
        wall=wall, wall_w1=w1_wall, wall_w2=w2_wall, wall_nfix=nfix,
        coll=coll, coll_w1=w1_coll, coll_w2=w2_coll,
        method="s7" if method == "s7" else "two")


def _lc_config(rt: RunTime, lb_cfg: LBConfig):
    """(LCConfig, lb_cfg) of a `free_energy lc_blue_phase` input
    (ludwig_tpu ludwig.py:1180-1219): the free energy with its electric
    field, the stencil (the solid ones with the anchoring keys), the
    advection order, hydrodynamics, the dynamic redshift, the Q noise
    (lc_noise 1 with temperature; a value that is not an integer, which
    the JAX package's log header fails on, raises) (keep_grads is
    set where the unfused route is built); halo walls become the
    configuration's WallSpec and leave every stored site fluid."""
    fe = _blue_phase_fe(rt, active=rt.switch("lc_activity", False),
                        efield=True)
    gradient = rt.string("fd_gradient_calculation", lc.GRADIENT)
    wallspec = None
    if any(lb_cfg.walls):
        # LC walls live in the halo: all sites stay fluid
        wallspec = WallSpec(walls=lb_cfg.walls)
        lb_cfg = dataclasses.replace(lb_cfg, walls=(False,) * 3)
    anchoring = (_lc_anchoring_params(rt, fe)
                 if gradient in lc.SOLID_GRADIENTS else None)
    if wallspec is not None and anchoring is None:
        # the walls' surface terms of the statistics read the anchoring:
        # the JAX package's run fails here
        raise _not_ported("boundary_walls", rt.string("boundary_walls")
                          + f" with fd_gradient_calculation {gradient} (the "
                          "walls need 3d_7pt_solid or s7_anchoring)")
    order = rt.int("fd_advection_scheme_order", 1)
    if order not in lc.ORDERS:
        raise ValueError(f"fd_advection_scheme_order {order}")
    noise = rt.string("lc_noise")
    if noise is not None:
        try:
            int(noise)
        except ValueError:
            # the log header reads it as an integer (ref: the C reference
            # reads lc_noise as one): the JAX package's run fails here
            raise _not_ported("lc_noise", noise + " (write lc_noise 0|1)")
    return lc.LCConfig(
        lb=lb_cfg, fe=fe, gamma=rt.double("lc_Gamma", 0.1),
        advection_order=order, gradient=gradient,
        hydrodynamics=rt.switch("hydrodynamics", True), wallspec=wallspec,
        anchoring=anchoring,
        redshift_update=rt.switch("lc_redshift_update", False),
        noise_kt=(rt.double("temperature", 0.0)
                  if rt.switch("lc_noise", False) else 0.0),
        noise_seed=rt.int("random_seed", 8361235)), lb_cfg


def _lc_fused_ok(lcfg: lc.LCConfig, solid) -> bool:
    """The JAX package's fused LC gate (ludwig.py:1321-1326; the sheared
    one, :1267-1275, adds the plane spacing): no solid, no walls, order-1
    advection, the 7-point fluid stencil, no redshift update, no noise,
    hydrodynamics on, no electric field (e0 zero, whatever epsilon)."""
    return (solid is None and lcfg.wallspec is None
            and lcfg.advection_order == 1 and lcfg.gradient == lc.GRADIENT
            and not lcfg.redshift_update and lcfg.noise_kt == 0.0
            and lcfg.hydrodynamics and not any(lcfg.fe.e0))


def _q_init(rt: RunTime, size, fe: BluePhaseFE) -> np.ndarray:
    """lc_q_initialisation modes, on the host (ref: blue_phase_rt.c /
    fe/lc_init.py), then the random rectangle where both its corners
    (lc_q_init_rectangle_min/max) are given."""
    q5 = _q_init_mode(rt, size, fe)
    rect_min = rt.int_vector("lc_q_init_rectangle_min", None)
    rect_max = rt.int_vector("lc_q_init_rectangle_max", None)
    if rect_min is not None and rect_max is not None:
        q5 = lc_init.lc_init_random_rectangle(size, q5, rect_min, rect_max)
    return q5


def _q_init_mode(rt: RunTime, size, fe: BluePhaseFE) -> np.ndarray:
    mode = rt.string("lc_q_initialisation", "nematic")
    amp = rt.double("lc_q_init_amplitude", fe.amplitude0)
    euler = tuple(rt.double_vector("lc_q_init_euler_angles",
                                   (0.0, 0.0, 0.0)))
    if mode == "o8m":
        return lc_init.lc_init_o8m(size, fe.q0, amp, euler=euler)
    if mode == "o2":
        return lc_init.lc_init_o2(size, fe.q0, amp, euler=euler)
    twist_axis = {"twist": 2, "cholesteric_z": 2, "cholesteric_x": 0,
                  "cholesteric_y": 1}
    if mode in twist_axis:
        return lc_init.lc_init_twist(size, fe.q0, amp, axis=twist_axis[mode])
    if mode == "nematic":
        director = tuple(rt.double_vector("lc_init_nematic",
                                          (1.0, 0.0, 0.0)))
        return lc_init.lc_init_nematic(size, amp, director)
    if mode == "random":
        return lc_init.lc_init_random(size, amp)      # DEFAULT_SEED
    if mode == "random_xy":
        return lc_init.lc_init_random_xy(size, amp)
    if mode in ("active_nematic_q2d_x", "active_nematic_q2d_y"):
        return lc_init.lc_init_active_nematic_q2d(
            size, amp, axis=0 if mode.endswith("x") else 1)
    raise ValueError(f"lc_q_initialisation '{mode}' not implemented")


def _droplet_config(rt: RunTime,
                    lb_cfg: LBConfig) -> lc_droplet.LCDropletConfig:
    """The `free_energy lc_droplet` configuration (ref: the lc_droplet
    branch of ludwig_tpu build_system, ludwig.py:1055-1080): every fluid
    stencil, advection orders 1-5 (LCDropletConfig raises ValueError on
    others, as the JAX package's step does), the stress-divergence force
    or relaxation_antisymmetric.  The other recognised force methods, which
    the JAX package's droplet step runs as stress_divergence, and
    `hydrodynamics off`, which its step ignores while its log drops the
    velocity, raise naming their keys."""
    fe = LCDropletFE(symm=_symm_fe(rt), lc=_blue_phase_fe(rt, active=False),
                     gamma0=rt.double_required("lc_droplet_gamma"),
                     delta=rt.double_required("lc_droplet_delta"),
                     w=rt.double("lc_droplet_W", 0.0))
    gradient = rt.string("fd_gradient_calculation", lc_droplet.GRADIENT)
    order = rt.int("fd_advection_scheme_order", 1)
    method = rt.string("fe_force_method", lc_droplet.FORCE_METHOD)
    if method not in _FORCE_METHODS:
        raise ValueError(f"fe_force_method '{method}' not recognised")
    if method not in lc_droplet.FORCE_METHODS:
        raise _not_ported("fe_force_method", method)
    if not rt.switch("hydrodynamics", True):
        raise _not_ported("hydrodynamics", rt.string("hydrodynamics"))
    return lc_droplet.LCDropletConfig(
        lb=lb_cfg, fe=fe, mobility=rt.double("mobility", 0.05),
        gamma=rt.double("lc_Gamma", 0.5), advection_order=order,
        gradient=gradient, force_method=method)


def _droplet_system(rt: RunTime, lb_cfg: LBConfig) -> System:
    """The lc_droplet branch of ludwig_tpu build_system (ludwig.py:
    1055-1178), gate for gate: the solid is the walls as solid planes
    and the porous media; Lees-Edwards planes beside them raise
    ValueError, as there; the fused K1 + mean + K2 route where `tpu_fused`
    asks and there is no solid, wall or LB noise and fused_droplet_ok
    holds, else the unfused step with the solid."""
    size = lb_cfg.size
    dcfg = _droplet_config(rt, lb_cfg)
    phi0 = _phi_init(rt, size, dcfg.fe.symm)
    q0 = _droplet_q_init(rt, size, dcfg.fe.lc)
    porous = _porous(rt, size)
    le = _le_config(rt, size)
    if le is not None:
        if porous is not None or any(lb_cfg.walls):
            key = ("boundary_walls" if any(lb_cfg.walls) else
                   "porous_media_file" if rt.has_key("porous_media_file")
                   else "porous_media_init")
            raise ValueError(f"{key} ({rt.string(key)}): lc_droplet + "
                             "Lees-Edwards does not compose with "
                             "walls/porous media")
        return _droplet_le_system(rt, lb_cfg, dcfg, le, phi0, q0)
    solid = solid_mask(lb_cfg, porous)
    if (_fused_request(rt) and solid is None and lb_cfg.noise is None
            and fused_droplet_ok(dcfg)):
        return System(rt=rt, lb_cfg=lb_cfg,
                      state=initial_fused_droplet(dcfg, phi0, q0),
                      step_fn=make_fused_droplet_step(dcfg),
                      fused_mode="droplet", droplet_cfg=dcfg)
    return System(rt=rt, lb_cfg=lb_cfg,
                  state=lc_droplet.initial_droplet(dcfg, phi0, q0),
                  step_fn=lc_droplet.make_droplet_step(dcfg, solid=solid),
                  droplet_cfg=dcfg, solid=solid)


def _droplet_q_init(rt: RunTime, size, fe: BluePhaseFE) -> np.ndarray:
    """The droplet's own lc_q_initialisation modes (ref: ludwig_tpu
    ludwig.py:1081-1098): twist/cholesteric, o8m, o2, random, nematic,
    with no Euler angles."""
    amp = rt.double("lc_q_init_amplitude", fe.amplitude0)
    mode = rt.string("lc_q_initialisation", "nematic")
    if mode.startswith("cholesteric") or mode == "twist":
        axis = {"x": 0, "y": 1, "z": 2}[mode[-1]] if mode[-1] in "xyz" \
            else 2
        return lc_init.lc_init_twist(size, fe.q0, amp, axis=axis)
    if mode == "o8m":
        return lc_init.lc_init_o8m(size, fe.q0, amp)
    if mode == "o2":
        return lc_init.lc_init_o2(size, fe.q0, amp)
    if mode == "random":
        return lc_init.lc_init_random(size, amp)
    if mode == "nematic":
        return lc_init.lc_init_nematic(
            size, amp, tuple(rt.double_vector("lc_init_nematic",
                                              (1.0, 0.0, 0.0))))
    raise ValueError(f"lc_q_initialisation '{mode}' for droplet")


def _electrolyte(rt: RunTime, lb_cfg: LBConfig,
                 solid: Optional[torch.Tensor] = None):
    """(ElectroSimConfig, psi0, rho_k, solid) of an electrokinetic input
    (ludwig_tpu ludwig.py:1348-1386): the electrolyte's parameters, the
    initial psi and charge densities, the solid (the in-lattice `solid`,
    walls and porous media, joined with the Gouy-Chapman walls; None
    without either) and the counter-charge that makes its fluid
    neutral."""
    size = lb_cfg.size
    kt = rt.double("temperature", 1.0 / 3.0e4)
    ek = ElectroConfig(
        valency=(rt.int("electrokinetics_z0", 1),
                 rt.int("electrokinetics_z1", -1)),
        diffusivity=(rt.double("electrokinetics_d0", 0.01),
                     rt.double("electrokinetics_d1", 0.01)),
        e=rt.double("electrokinetics_eunit", 1.0),
        beta=1.0 / kt,
        epsilon=rt.double("electrokinetics_epsilon", 3.3e3),
        solver=rt.string("electrokinetics_solver_type", "sor"),
        rel_tol=rt.double("electrokinetics_rel_tol", 1e-8),
        abs_tol=rt.double("electrokinetics_abs_tol", 1e-15),
        max_its=rt.int("electrokinetics_maxits", 10000),
        multisteps=rt.int("electrokinetics_multisteps", 1))
    mode = rt.string("electrokinetics_init", "uniform")
    rho_el = rt.double("electrokinetics_init_rho_el", 0.0)
    boundary = None
    if mode == "gouy_chapman":
        sigma = rt.double("electrokinetics_init_sigma", 0.0)
        psi0, rho_k, boundary = electro_sim.init_gouy_chapman(size, rho_el,
                                                              sigma)
    elif mode == "liquid_junction":
        delta_el = rt.double("electrokinetics_init_delta_el", 0.0)
        psi0, rho_k = electro_sim.init_liquid_junction(size, rho_el,
                                                       delta_el)
    elif mode == "uniform":
        psi0, rho_k = electro_sim.init_uniform(size, rho_el)
    else:
        raise ValueError(f"electrokinetics_init '{mode}'")
    if boundary is not None:
        boundary = torch.as_tensor(boundary, device=lb_cfg.device)
        solid = (boundary if solid is None
                 else torch.logical_or(solid, boundary))
    rho_k = electro_sim.electroneutral(
        rho_k, ek.valency, None if solid is None else solid.cpu().numpy())
    ecfg = electro_sim.ElectroSimConfig(
        lb=lb_cfg, ek=ek,
        e0=tuple(rt.double_vector("electric_e0", (0.0, 0.0, 0.0))),
        hydrodynamics=rt.switch("hydrodynamics", True),
        stencil=rt.int("electrokinetics_solver_stencil", 7))
    return ecfg, psi0, rho_k, solid


def _electro_system(rt: RunTime, lb_cfg: LBConfig) -> System:
    """The `free_energy fe_electro` system without colloids (ref: the
    fe_electro branch of ludwig_tpu build_system, ludwig.py:1348-1465):
    the electrolyte and make_electro_step over the solid, the walls as
    solid planes and the porous media joined with the Gouy-Chapman
    walls."""
    ecfg, psi0, rho_k, solid = _electrolyte(
        rt, lb_cfg, solid_mask(lb_cfg, _porous(rt, lb_cfg.size)))
    state = electro_sim.initial_electro(ecfg, _distribution_init(rt, lb_cfg),
                                        psi0, rho_k)
    return System(rt=rt, lb_cfg=lb_cfg, state=state,
                  step_fn=electro_sim.make_electro_step(
                      ecfg, solid=solid, return_rho_lb=False),
                  hydro_on=ecfg.hydrodynamics, electro_cfg=ecfg, solid=solid)


def _electro_symm_system(rt: RunTime, lb_cfg: LBConfig) -> System:
    """The fe_electro_symmetric branch of ludwig_tpu build_system
    (ludwig.py:1424-1456): the electrolyte, its permittivity the mean of
    epsilon1 and epsilon2, the coupled free energy, phi from
    phi_initialisation, and make_electro_symm_step.  As there, the step
    keeps no solid: the Gouy-Chapman walls only set the initial charge."""
    ecfg, psi0, rho_k, _solid = _electrolyte(rt, lb_cfg)
    ek = ecfg.ek
    eps1 = rt.double("electrokinetics_epsilon1", ek.epsilon)
    eps2 = rt.double("electrokinetics_epsilon2", ek.epsilon)
    ek = dataclasses.replace(ek, epsilon=0.5 * (eps1 + eps2))
    fe = ElectroSymmetricFE(
        symm=_symm_fe(rt), electro=ek, epsilon1=eps1, epsilon2=eps2,
        deltamu=(rt.double("electrosymmetric_delta_mu0", 0.0),
                 rt.double("electrosymmetric_delta_mu1", 0.0)))
    method = rt.string("fe_force_method", "stress_divergence")
    if method not in _FORCE_METHODS:
        raise ValueError(f"fe_force_method '{method}' not recognised")
    escfg = ElectroSymmConfig(
        lb=lb_cfg, ek=ek, fe=fe, mobility=rt.double("mobility", 1.0),
        advection_order=rt.int("fd_advection_scheme_order", 1),
        gradient=rt.string("fd_gradient_calculation", GRADIENT),
        e0=ecfg.e0, hydrodynamics=ecfg.hydrodynamics, force_method=method)
    state = initial_electro_symm(escfg, _distribution_init(rt, lb_cfg),
                                 _phi_init(rt, lb_cfg.size, fe.symm), psi0,
                                 rho_k)
    return System(rt=rt, lb_cfg=lb_cfg, state=state,
                  step_fn=make_electro_symm_step(escfg),
                  hydro_on=escfg.hydrodynamics,
                  electro_cfg=dataclasses.replace(ecfg, ek=ek), es_cfg=escfg)


def _noise_config(rt: RunTime, fe_name: str) -> Optional[NoiseConfig]:
    """The fluctuations of every family (ref: temperature +
    isothermal_fluctuations keys; ludwig_tpu ludwig.py:603-617): with
    temperature > 0, the LB's isothermal fluctuations and, under
    symmetric_noise with fd_phi_fluctuations on, the CH flux noise; None
    when neither is on.  Both draw the per-site KISS streams where a
    family's step draws; the others run noiseless and print the kT
    statistics, as the JAX package's do."""
    kt = rt.double("temperature", 0.0)
    if kt <= 0.0:
        return None
    nz = NoiseConfig(
        kt=kt, seed=rt.int("random_seed", 8361235),
        rho=rt.switch("isothermal_fluctuations",
                      rt.switch("lb_fluctuations", False)),
        phi=(fe_name == "symmetric_noise"
             and rt.int("fd_phi_fluctuations", 0) != 0))
    return nz if (nz.rho or nz.phi) else None


def _has_fused_plan(size) -> bool:
    """The JAX package's fused-kernel plan predicate (ludwig_tpu
    ludwig.py:38-46 _fused_plan is not None): BX = 1 divides every X and
    BY in (32, 24, 16, 8) divides Y exactly when 8 does.  The port's
    kernels need no plan; the JAX package without one takes its unfused
    route and prints its reference statistics, and so does the port."""
    return size[1] % 8 == 0


def _jax_fused_plain(rt: RunTime, lb_cfg: LBConfig) -> bool:
    """Whether the JAX package steps a plain-fluid input through its fused
    kernel (ludwig_tpu ludwig.py:1719-1733; the wall and Lees-Edwards
    gates at :1673-1674 and :1711-1712 ask the same): tpu_fused on or
    interpret, a _fused_plan, and float32 or interpret mode."""
    fused_req = rt.string("tpu_fused", "off")
    return (fused_req != "off" and _has_fused_plan(lb_cfg.size)
            and (fused_req == "interpret" or lb_cfg.dtype == "float32"))


def reference_statistics(sys_: System) -> bool:
    """Whether the JAX package prints reference-ordered statistics for
    this input: wherever its build_system leaves fused_mode None
    (ludwig_tpu ludwig.py:2784-2785).  That is every route the port runs
    unfused (tpu_fused off, LC order-2 advection, fe_electro) and the
    fused routes the JAX package's gates refuse: a lattice with no
    _fused_plan, or `tpu_fused on` (not interpret) in float64 - and, for
    the two-kernel binary, LC and droplet steps, with z not a multiple
    of 128 (ludwig_tpu ludwig.py:1008-1011, 1160-1163, 1329-1332,
    1709-1712, 1730-1733).  The port's noiseless step routes do not
    follow these gates, only their statistics do; a fluctuating plain
    input's step follows the plain gate too (build_system).  The fused
    wall and Lees-Edwards steps follow the plain gate, and porous or
    masked runs are unfused in both packages."""
    if sys_.fused_mode is None:
        return True
    if sys_.fused_mode in ("plain", "wall", "le"):
        return not _jax_fused_plain(sys_.rt, sys_.lb_cfg)
    return not _jax_fused_two_kernel(sys_.rt, sys_.lb_cfg)


def _jax_fused_two_kernel(rt: RunTime, lb_cfg: LBConfig) -> bool:
    """Whether the JAX package takes its two-kernel fused route (binary,
    LC, droplet; periodic or sheared) where the port takes its own: a
    _fused_plan, and `tpu_fused interpret` or z a multiple of 128 in
    float32 (ludwig_tpu ludwig.py:958-970, 1008-1011, 1160-1163,
    1290-1293, 1329-1332)."""
    size = lb_cfg.size
    if not _has_fused_plan(size):
        return False
    if rt.string("tpu_fused", "off") == "interpret":
        return True
    return size[2] % 128 == 0 and lb_cfg.dtype == "float32"


def _fused_request(rt: RunTime) -> bool:
    fused_req = rt.string("tpu_fused", "off")
    if fused_req not in ("on", "interpret", "off"):
        raise ValueError(f"tpu_fused '{fused_req}' not recognised")
    # 'interpret' is the JAX package's CPU spelling of 'on'
    return fused_req != "off"


def _le_config(rt: RunTime, size,
               oscillation: bool = False) -> Optional[LeesEdwardsConfig]:
    """The Lees-Edwards planes of an input, or None (ludwig_tpu
    ludwig.py:941-995, 1099-1151, 1220-1305, 1640-1767): N_LE_plane planes
    sliding at LE_plane_vel, oscillating with LE_oscillation_period where
    the family reads it (the binary fluid)."""
    nplanes = rt.int("N_LE_plane", 0)
    if nplanes <= 0:
        return None
    period = rt.double("LE_oscillation_period", 0.0) if oscillation else 0.0
    return LeesEdwardsConfig(nplanes=nplanes,
                             uy=rt.double_required("LE_plane_vel"),
                             nx=size[0],
                             omega=2.0 * np.pi / period if period else 0.0)


def _le_f0(rt: RunTime, lb_cfg: LBConfig, le: LeesEdwardsConfig):
    """f at rest, or with LE_init_profile the steady sawtooth profile."""
    if rt.switch("LE_init_profile", False):
        return le_init_shear_profile(lb_cfg, le)
    return initial_rest(lb_cfg)


def _keeps_grads(fe_name: str, le: Optional[LeesEdwardsConfig]) -> bool:
    """Whether the JAX package's unfused route for this family carries the
    gradients of the step's pre-update order parameter, (grad, delsq)
    after u (keep_grads: the LC route, ludwig_tpu ludwig.py:1215, and the
    sheared binary and LC routes, :992, :1302; not the sheared droplet,
    :1148), so that each package restarts from the other's checkpoint.
    The port's unfused routes carry them in their state; its fused routes
    add them to the checkpoint where the JAX package's route for the
    input is unfused (_grad_leaves)."""
    return fe_name == "lc_blue_phase" or (fe_name == "symmetric"
                                          and le is not None)


def _grad_leaves(rt: RunTime, lb_cfg: LBConfig, fe_name: str,
                 le: Optional[LeesEdwardsConfig], gradient=GRADIENT):
    """For a fused route: None where the JAX package's route for the input
    is fused too (its checkpoint has no gradient leaves), else (field, t)
    -> (grad, delsq) of the field before step t, the bits the JAX
    package's unfused route holds as state03 / state04 after that step:
    the LE-aware gradients on a sheared run, the 7-point ones otherwise.
    The run loop takes them before the fused step of a checkpoint step."""
    if not _keeps_grads(fe_name, le) or _jax_fused_two_kernel(rt, lb_cfg):
        return None
    if le is not None:
        return lambda field, t: le_gradient(field, le, t, gradient)
    return lambda field, t: (grad_7pt(field), delsq_7pt(field))


def _tensors(lb_cfg: LBConfig, *arrays):
    return tuple(torch.as_tensor(a, dtype=lb_cfg.tdtype,
                                 device=lb_cfg.device).contiguous()
                 for a in arrays)


def _binary_system(rt: RunTime, lb_cfg: LBConfig, fe_name: str) -> System:
    """The symmetric and symmetric_noise branch of ludwig_tpu
    build_system (ludwig.py:884-1026), gate for gate: halo walls without
    porous media (with the open x boundary where lb_bc_open asks), then
    Lees-Edwards planes (symmetric only; porous media beside them are
    not read, as there), then the two fused kernels where `tpu_fused`
    asks and the JAX package's fused gate admits the configuration
    (fused_binary_ok; its plan and dtype conditions set only which
    statistics print), else the unfused step with porous media, wetting,
    noise and the other options.  The fluid starts at rest (only the open
    boundary reads distribution_initialisation)."""
    size = lb_cfg.size
    porous, pm_wetting = _porous_map(rt, size)
    wetting = (0.0, 0.0)
    if pm_wetting is not None:
        wetting = _tensors(lb_cfg, *pm_wetting)
    bcfg = _binary_config(rt, lb_cfg, wetting)
    walls = lb_cfg.walls
    if bcfg.gradient == "3d_27pt_solid" and porous is None and not any(
            walls):
        # no solid sites anywhere: the solid stencil reduces to the fluid
        # 27-point one (ref: gradient_3d_27pt_solid.c:5-7)
        bcfg = dataclasses.replace(bcfg, gradient="3d_27pt_fluid")
    phi0 = _phi_init(rt, size, bcfg.fe)
    if any(walls) and porous is None:
        # halo plane walls: every stored site stays fluid
        ws = WallSpec(walls=walls)
        lb_cfg = dataclasses.replace(lb_cfg, walls=(False,) * 3)
        bcfg = dataclasses.replace(bcfg, lb=lb_cfg)
        if rt.switch("lb_bc_open", False):
            # open x boundary + transverse walls (ref: serial-open-phi)
            obc = OpenBCConfig(
                u0=tuple(rt.double_vector("lb_bc_inflow_rhou_u0",
                                          (0.0, 0.0, 0.0))),
                rho0=rt.double("lb_bc_outflow_rhou_rho0", 1.0))
            phib = rt.double("phi_bc_inflow_fixed_phib", 0.0)
            phi, = _tensors(lb_cfg, phi0)
            zeros = torch.zeros((3,) + size, dtype=lb_cfg.tdtype,
                                device=lb_cfg.device)
            gwall = torch.zeros((3,), dtype=lb_cfg.tdtype,
                                device=lb_cfg.device)
            return System(rt=rt, lb_cfg=lb_cfg,
                          state=(_distribution_init(rt, lb_cfg), phi, zeros,
                                 gwall),
                          step_fn=make_binary_open_step(bcfg, ws, obc, phib),
                          binary_cfg=bcfg, wallspec=ws,
                          fe_ops=open_x_scalar_ops(bcfg, ws, phib))
        ops = binary_solid_ops(bcfg, wallspec=ws)
        return System(rt=rt, lb_cfg=lb_cfg,
                      state=initial_binary(bcfg, phi0, walls=True),
                      step_fn=make_binary_step(bcfg, wallspec=ws,
                                               solid_ops=ops),
                      binary_cfg=bcfg, wallspec=ws, fe_ops=ops)
    if rt.switch("lb_bc_open", False):
        # the JAX package imposes the open boundary beside halo walls only
        # (beside porous media it reads the key and ignores it)
        raise _not_ported("lb_bc_open", rt.string("lb_bc_open") +
                          " without halo walls or beside porous media")
    le = (_le_config(rt, size, oscillation=True) if fe_name == "symmetric"
          else None)
    if le is not None:
        return _binary_le_system(rt, lb_cfg, bcfg, le, phi0)
    solid = solid_mask(lb_cfg, porous)
    if (_fused_request(rt) and fe_name == "symmetric" and solid is None
            and fused_binary_ok(bcfg)):
        # production path: the two fused kernels (K1, K2)
        return System(rt=rt, lb_cfg=lb_cfg,
                      state=initial_fused_binary(bcfg, phi0),
                      step_fn=make_fused_binary_step(bcfg),
                      fused_mode="binary", binary_cfg=bcfg)
    ops = binary_solid_ops(bcfg, solid=solid)
    return System(rt=rt, lb_cfg=lb_cfg, state=initial_binary(bcfg, phi0),
                  step_fn=make_binary_step(bcfg, solid=solid, solid_ops=ops),
                  binary_cfg=bcfg, solid=solid, fe_ops=ops)


def _binary_le_system(rt, lb_cfg, bcfg, le, phi0) -> System:
    """The sheared binary fluid (ludwig_tpu ludwig.py:941-995): the fused
    K1 + column fix + K2 + LE post-pass where `tpu_fused` asks, the JAX
    package's fused gate admits the configuration and the planes are 6
    columns apart, else the unfused step carrying the KISS state of the
    LB's fluctuations, where they are on, and the LE gradients (the JAX
    package's builder leaves the KISS state out, and its step then
    fails)."""
    lecfg = BinaryLEConfig(binary=bcfg, le=le)
    f = _le_f0(rt, lb_cfg, le)
    phi, = _tensors(lb_cfg, phi0)
    u = torch.zeros((3,) + lb_cfg.size, dtype=lb_cfg.tdtype,
                    device=lb_cfg.device)
    if (_fused_request(rt) and fused_binary_ok(bcfg)
            and lb_cfg.size[0] >= 6 * le.nplanes):
        return System(rt=rt, lb_cfg=lb_cfg, state=(f, phi, u),
                      step_fn=make_fused_binary_le_step(lecfg),
                      fused_mode="binary", binary_cfg=bcfg, le_cfg=le,
                      grad_leaves=_grad_leaves(rt, lb_cfg, "symmetric", le,
                                               bcfg.gradient))
    keep = _keeps_grads("symmetric", le)
    state = (f, phi, u)
    if kiss_on(lb_cfg):
        state = state + (kiss_init(0, lb_cfg.size, device=lb_cfg.device),)
    return System(rt=rt, lb_cfg=lb_cfg,
                  state=state + (le_gradient(phi, le, 0, bcfg.gradient)
                                 if keep else ()),
                  step_fn=make_binary_le_step(lecfg, keep_grads=keep),
                  binary_cfg=bcfg, le_cfg=le, keep_grads=keep)


def _lc_le_system(rt, lb_cfg, lcfg, le, q0, solid) -> System:
    """The sheared blue phase (ludwig_tpu ludwig.py:1255-1305): the fused
    K1 + column fix + K2 + LE post-pass where `tpu_fused` asks, the JAX
    package's fused gate admits the configuration and the planes are 6
    columns apart, else the unfused step carrying the LE gradients.  As
    there, the sheared step has no solid (porous media are not read), is
    the same with hydrodynamics off (only the velocity output goes) and
    takes the electric field and orders 1-5.  Halo walls, the solid
    stencils and the redshift update beside planes, on which the JAX
    package's run fails, raise naming their keys, and so does a stencil
    other than the 7-point one."""
    for bad, key in ((lcfg.has_walls, "boundary_walls"),
                     (lcfg.gradient != lc.GRADIENT,
                      "fd_gradient_calculation"),
                     (lcfg.redshift_update, "lc_redshift_update")):
        if bad:
            raise _not_ported(key, rt.string(key) + " beside Lees-Edwards "
                              "planes")
    f = _le_f0(rt, lb_cfg, le)
    q5, = _tensors(lb_cfg, q0)
    u = torch.zeros((3,) + lb_cfg.size, dtype=lb_cfg.tdtype,
                    device=lb_cfg.device)
    if (_fused_request(rt) and _lc_fused_ok(lcfg, solid)
            and lb_cfg.size[0] >= 6 * le.nplanes):
        return System(rt=rt, lb_cfg=lb_cfg, state=(f, q5, u),
                      step_fn=make_fused_lc_le_step(lcfg, le),
                      fused_mode="lc", lc_cfg=lcfg, le_cfg=le,
                      grad_leaves=_grad_leaves(rt, lb_cfg, "lc_blue_phase",
                                               le))
    keep = _keeps_grads("lc_blue_phase", le)
    return System(rt=rt, lb_cfg=lb_cfg,
                  state=(f, q5, u) + (le_gradient(q5, le, 0) if keep
                                      else ()),
                  step_fn=lc.make_lc_le_step(lcfg, le, keep_grads=keep),
                  lc_cfg=lcfg, le_cfg=le, keep_grads=keep)


def _droplet_le_system(rt, lb_cfg, dcfg, le, phi0, q0) -> System:
    """The sheared LC droplet (ludwig_tpu ludwig.py:1099-1151; walls and
    porous media beside planes are refused with their keys): the fused
    K1 + column fix + mean subtraction + K2 + LE post-pass where
    `tpu_fused` asks, the advection is order 1, the stencil 7-point, the
    force stress_divergence, the planes are 8 columns apart and the LB's
    fluctuations are off (the JAX package's gate; the droplet's steps
    draw no LB noise), else the unfused step, which takes the stencil
    and the order.  relaxation_antisymmetric, which the JAX package's
    sheared step runs as stress_divergence, raises naming its key
    (lc_droplet.make_droplet_le_step)."""
    f = _le_f0(rt, lb_cfg, le)
    phi, q5 = _tensors(lb_cfg, phi0, q0)
    u = torch.zeros((3,) + lb_cfg.size, dtype=lb_cfg.tdtype,
                    device=lb_cfg.device)
    if (_fused_request(rt) and dcfg.advection_order == 1
            and fused_droplet_ok(dcfg) and lb_cfg.noise is None
            and lb_cfg.size[0] >= 8 * le.nplanes):
        return System(rt=rt, lb_cfg=lb_cfg, state=(f, phi, q5, u),
                      step_fn=make_fused_droplet_le_step(dcfg, le),
                      fused_mode="droplet", droplet_cfg=dcfg, le_cfg=le)
    return System(rt=rt, lb_cfg=lb_cfg, state=(f, phi, q5, u),
                  step_fn=lc_droplet.make_droplet_le_step(dcfg, le),
                  droplet_cfg=dcfg, le_cfg=le)


def _brazovskii_system(rt: RunTime, lb_cfg: LBConfig) -> System:
    """The brazovskii branch of ludwig_tpu build_system (ludwig.py:
    679-727): the binary fluid's unfused step with the fourth-order
    fields and in-lattice solids (walls kept as solid planes, porous
    media), or, with Lees-Edwards planes, the sheared step carrying the
    LE gradients (the JAX package starts them from the 5-point
    fourth-order form for every stencil); both draw the LB's KISS stream
    with isothermal fluctuations on."""
    size = lb_cfg.size
    fe = BrazovskiiFE(a=rt.double_required("A"), b=rt.double_required("B"),
                      kappa=rt.double_required("K"),
                      c=rt.double_required("C"))
    bcfg = BinaryConfig(
        lb=lb_cfg, fe=fe, mobility=rt.double("mobility", 1.0),
        advection_order=rt.int("fd_advection_scheme_order", 1),
        gradient=rt.string("fd_gradient_calculation", GRADIENT),
        hydrodynamics=rt.switch("hydrodynamics", True))
    phi0 = _phi_init(rt, size)
    le = _le_config(rt, size, oscillation=True)
    if le is not None:
        phi, = _tensors(lb_cfg, phi0)
        u = torch.zeros((3,) + size, dtype=lb_cfg.tdtype,
                        device=lb_cfg.device)
        grads = le_fields_2d5pt_d4(phi, le, 0)[:2]
        # the LB's KISS state after u where the fluctuations are on (the
        # sheared step draws it; ludwig_tpu ludwig.py:716-718)
        kiss = ((kiss_init(0, size, device=lb_cfg.device),)
                if kiss_on(lb_cfg) else ())
        return System(rt=rt, lb_cfg=lb_cfg,
                      state=(_le_f0(rt, lb_cfg, le), phi, u) + kiss + grads,
                      step_fn=make_binary_le_step(
                          BinaryLEConfig(binary=bcfg, le=le),
                          keep_grads=True),
                      binary_cfg=bcfg, le_cfg=le, keep_grads=True)
    solid = solid_mask(lb_cfg, _porous(rt, size))
    ops = binary_solid_ops(bcfg, solid=solid)
    return System(rt=rt, lb_cfg=lb_cfg, state=initial_binary(bcfg, phi0),
                  step_fn=make_binary_step(bcfg, solid=solid, solid_ops=ops),
                  binary_cfg=bcfg, solid=solid, fe_ops=ops)


def _ternary_init(rt: RunTime, size):
    """(phi0, psi0) of a ternary_initialisation (ref:
    src/fe_ternary_rt.c:102-160, src/field_ternary_init.c; components
    c1 = (phi +1, psi 0), c2 = (-1, 0), c3 = (0, 1)), or None; on the
    host, as ludwig_tpu ludwig.py:261-291 makes them."""
    mode = rt.string("ternary_initialisation", "")
    nx, ny = size[0], size[1]
    x = np.arange(1, nx + 1, dtype=np.float64)[:, None, None] + np.zeros(size)
    y = np.arange(1, ny + 1, dtype=np.float64)[None, :, None] + np.zeros(size)
    if mode == "2d_double_emulsion":
        x1 = rt.double("2d_double_emulsion_xf1", 0.2) * nx
        x2 = rt.double("2d_double_emulsion_xf2", 0.5) * nx
        x3 = rt.double("2d_double_emulsion_xf3", 0.8) * nx
        y1 = rt.double("2d_double_emulsion_yf1", 0.3) * ny
        y2 = rt.double("2d_double_emulsion_yf2", 0.7) * ny
        iny = (y1 < y) & (y < y2)
        c1 = (x1 < x) & (x < x2) & iny
        c2 = (x2 <= x) & (x < x3) & iny
        return (np.where(c1, 1.0, np.where(c2, -1.0, 0.0)),
                np.where(c1 | c2, 0.0, 1.0))
    if mode == "2d_tee":
        x1 = rt.double("ternary_2d_tee_xf1", 0.50) * nx
        y1 = rt.double("tarnary_2d_tee_yf1", 0.33) * ny   # (sic)
        c3 = y < y1
        c1 = ~c3 & (x < x1)
        return (np.where(c3, 0.0, np.where(c1, 1.0, -1.0)),
                np.where(c3, 1.0, 0.0))
    return None


def _two_field_system(rt: RunTime, lb_cfg: LBConfig, fe_name: str) -> System:
    """The surfactant and ternary branch of ludwig_tpu build_system
    (ludwig.py:729-829): the free energy and its two mobilities, the
    initial (phi, psi), and make_two_field_step with in-lattice solids
    or, under a *ternary_solid stencil, the ternary wetting stencils
    beside halo walls or porous media (hrka from (h1, h2, h3))."""
    size = lb_cfg.size
    m0 = rt.double("mobility", 1.0)
    if fe_name == "surfactant":
        fe = SurfactantFE(a=rt.double_required("surf_A"),
                          b=rt.double_required("surf_B"),
                          kappa=rt.double_required("surf_kappa"),
                          kt=rt.double_required("surf_kT"),
                          epsilon=rt.double_required("surf_epsilon"),
                          beta=rt.double("surf_beta", 0.0),
                          w=rt.double("surf_W", 0.0))
        mob = (rt.double("surf_mobility_phi", m0),
               rt.double("surf_mobility_psi", m0))
        psi0_mean = rt.double("surf_psi0", 0.01)
    else:
        h1, h2 = rt.double("ternary_h1", 0.0), rt.double("ternary_h2", 0.0)
        k1, k2 = (rt.double_required("ternary_kappa1"),
                  rt.double_required("ternary_kappa2"))
        k3 = rt.double_required("ternary_kappa3")
        fe = TernaryFE(alpha=rt.double_required("ternary_alpha"),
                       kappa1=k1, kappa2=k2, kappa3=k3, h1=h1, h2=h2,
                       h3=-k3 * (h1 / k1 + h2 / k2))
        mob = (rt.double("ternary_mobility_phi", m0),
               rt.double("ternary_mobility_psi", m0))
        psi0_mean = rt.double("ternary_psi0", 0.0)
    method = rt.string("fe_force_method", "phi_gradmu" if fe_name == "ternary"
                       else "stress_divergence")
    if method not in _FORCE_METHODS:
        raise ValueError(f"fe_force_method '{method}' not recognised")
    tcfg = TwoFieldConfig(
        lb=lb_cfg, fe=fe, mobilities=mob,
        advection_order=rt.int("fd_advection_scheme_order", 1),
        gradient=rt.string("fd_gradient_calculation", GRADIENT),
        hydrodynamics=rt.switch("hydrodynamics", True), force_method=method)
    tinit = _ternary_init(rt, size) if fe_name == "ternary" else None
    if tinit is not None:
        phi0, psi0 = tinit
    else:
        phi0 = _phi_init(rt, size, fe if fe_name == "surfactant" else None)
        if rt.string("psi_initialisation", "") == "uniform":
            # (ref: field_psi_init_rt.c:46-57)
            psi0_mean = rt.double_required("psi_initialisation_psi0")
        psi0 = np.full(size, psi0_mean)
    porous = _porous(rt, size)
    solid = solid_mask(lb_cfg, porous)
    ws, ops = None, None
    if tcfg.gradient.endswith("ternary_solid"):
        # Semprebon wetting gradients hrka (Eq. 24-26; ref:
        # gradient_2d_ternary_solid.c:104-106)
        a2 = fe.alpha * fe.alpha
        hrka = ((-fe.h1 / fe.kappa1 + fe.h2 / fe.kappa2) / a2,
                (-fe.h3 / fe.kappa3) / a2)
        two_d = tcfg.gradient.startswith("2d")
        if any(lb_cfg.walls) and porous is None:
            # halo walls: no stored solid sites
            ws = WallSpec(walls=lb_cfg.walls)
            lb_cfg = dataclasses.replace(lb_cfg, walls=(False,) * 3)
            tcfg = dataclasses.replace(tcfg, lb=lb_cfg)
            solid = None
        fluid = None if solid is None else torch.logical_not(solid)
        # with no solid anywhere they reduce to the fluid stencil of the
        # same shape (ref: serial-tern-st2.inp)
        wet = solid is not None or ws is not None
        ops = tuple(ternary_solid_ops(
            size, hrka[n] if wet else 0.0, fluid=fluid,
            walls=ws.walls if ws is not None else (False,) * 3,
            two_d=two_d, device=lb_cfg.device) for n in range(2))
    return System(rt=rt, lb_cfg=lb_cfg,
                  state=initial_two_field(tcfg, phi0, psi0,
                                          walls=ws is not None),
                  step_fn=make_two_field_step(tcfg, solid=solid, wallspec=ws,
                                              solid_ops=ops),
                  two_field_cfg=tcfg, solid=solid, wallspec=ws, fe_ops=ops)


def _binary_lb_system(rt: RunTime, lb_cfg: LBConfig) -> System:
    """The symmetric_lb branch of ludwig_tpu build_system without
    colloids (ludwig.py:831-880): 27-point gradients by default (the
    solid 27-point stencil reduces to the fluid one without walls, and
    is kept beside halo walls), halo walls, Lees-Edwards planes and the
    LB's KISS fluctuations."""
    size = lb_cfg.size
    gradient = rt.string("fd_gradient_calculation", "3d_27pt_fluid")
    walls = lb_cfg.walls
    if gradient == "3d_27pt_solid" and not any(walls):
        # no solid sites: the fluid 27-point stencil (ref:
        # gradient_3d_27pt_solid.c:5-7)
        gradient = "3d_27pt_fluid"
    ws = None
    if any(walls):
        ws = WallSpec(walls=walls)
        lb_cfg = dataclasses.replace(lb_cfg, walls=(False,) * 3)
    l2cfg = BinaryLBConfig(lb=lb_cfg, fe=_symm_fe(rt),
                           mobility=rt.double("mobility", 0.15),
                           gradient=gradient)
    phi0 = _phi_init(rt, size, l2cfg.fe)
    state = initial_binary_lb(l2cfg, phi0, walls=ws is not None)
    le = _le_config(rt, size, oscillation=True)
    if le is not None:
        if rt.switch("LE_init_profile", False):
            state = (le_init_shear_profile(lb_cfg, le),) + state[1:]
        phi, = _tensors(lb_cfg, phi0)
        state = state + le_gradient(phi, le, 0, gradient)
    return System(rt=rt, lb_cfg=lb_cfg, state=state,
                  step_fn=make_binary_lb_step(l2cfg, wallspec=ws, le=le),
                  lb2_cfg=l2cfg, wallspec=ws, le_cfg=le,
                  keep_grads=le is not None,
                  fe_ops=binary_lb_solid_ops(l2cfg, ws))


def _polar_system(rt: RunTime, lb_cfg: LBConfig) -> System:
    """The polar_active branch of ludwig_tpu build_system (ludwig.py:
    1028-1053): the aster (the JAX package takes no other
    initialisation) and make_polar_step with in-lattice solids."""
    size = lb_cfg.size
    fe = PolarActiveFE(a=rt.double_required("polar_active_a"),
                       b=rt.double_required("polar_active_b"),
                       kappa1=rt.double_required("polar_active_k"),
                       delta=rt.double("polar_active_dk", 0.0),
                       lambda_=rt.double("polar_active_lambda", 0.0),
                       zeta=rt.double("polar_active_zeta", 0.0))
    pcfg = PolarConfig(
        lb=lb_cfg, fe=fe, gamma=rt.double("leslie_ericksen_gamma", 0.3),
        swim=rt.double("leslie_ericksen_swim", 0.0),
        advection_order=rt.int("fd_advection_scheme_order", 1),
        gradient=rt.string("fd_gradient_calculation", GRADIENT),
        hydrodynamics=rt.switch("hydrodynamics", True))
    mode = rt.string("polar_active_initialisation", "aster")
    if mode != "aster":
        raise ValueError(f"polar init '{mode}' not implemented")
    solid = solid_mask(lb_cfg, _porous(rt, size))
    return System(rt=rt, lb_cfg=lb_cfg,
                  state=initial_polar(pcfg, polar_init_aster(size)),
                  step_fn=make_polar_step(pcfg, solid=solid),
                  polar_cfg=pcfg, solid=solid)


def build_system(rt: RunTime, device="cuda") -> System:
    """The system of an input on `device` (the GPU unless the caller
    asks for the CPU)."""
    _check_keys(rt)
    device = _device(device)
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
    fe_name = rt.string("free_energy", "none")
    # the other families accept boundary_walls 0_0_0 only (INACTIVE)
    walls = tuple(bool(w) for w in rt.int_vector("boundary_walls",
                                                 (0, 0, 0)))

    lb_cfg = LBConfig(size=size, nvel=nvel, eta_shear=eta, eta_bulk=eta_b,
                      rho0=rho0, scheme=_relaxation(rt),
                      ghost_modes_on=ghosts, force_global=force,
                      walls=walls, dtype=dtype, device=device,
                      noise=_noise_config(rt, fe_name))
    if fe_name in ("symmetric", "symmetric_lb", "fe_electro"):
        # resolved colloids of these families (ludwig_tpu ludwig.py:
        # 1392-1423, 1465-1558): the colloid route takes the input
        col = _parse_colloids(rt, size, rho0, eta, lb_cfg)
        if col is not None:
            return _family_colloid_system(rt, lb_cfg, fe_name, col)
    if fe_name in ("symmetric", "symmetric_noise"):
        return _binary_system(rt, lb_cfg, fe_name)
    if fe_name == "lc_blue_phase":
        return _lc_system(rt, lb_cfg)
    if fe_name == "lc_droplet":
        return _droplet_system(rt, lb_cfg)
    if fe_name == "fe_electro":
        return _electro_system(rt, lb_cfg)
    if fe_name == "fe_electro_symmetric":
        return _electro_symm_system(rt, lb_cfg)
    if fe_name == "brazovskii":
        return _brazovskii_system(rt, lb_cfg)
    if fe_name in ("surfactant", "ternary"):
        return _two_field_system(rt, lb_cfg, fe_name)
    if fe_name == "symmetric_lb":
        return _binary_lb_system(rt, lb_cfg)
    if fe_name == "polar_active":
        return _polar_system(rt, lb_cfg)
    colloids = _parse_colloids(rt, size, rho0, eta, lb_cfg)
    if colloids is not None:
        return _colloid_system(rt, lb_cfg, colloids)
    return _plain_system(rt, lb_cfg)


def _lc_system(rt: RunTime, lb_cfg: LBConfig) -> System:
    """The lc_blue_phase branch of ludwig_tpu build_system (ludwig.py:
    1180-1346), gate for gate: Lees-Edwards planes (_lc_le_system), then
    resolved colloids (_lc_colloid_system), then the two fused kernels
    (K1, K2) where `tpu_fused` asks and the JAX package's fused gate
    admits the configuration (_lc_fused_ok; its plan and dtype conditions
    set only which statistics print), else the unfused step with halo
    walls, porous solids, the redshift and the rest.  As there, halo
    walls drop porous media, and the state of the unfused step keeps the
    gradients of the step's pre-update Q."""
    size = lb_cfg.size
    porous = _porous(rt, size)
    lcfg, lb_cfg = _lc_config(rt, lb_cfg)
    q0 = _q_init(rt, size, lcfg.fe)
    solid = None if lcfg.has_walls else solid_mask(lb_cfg, porous)
    le = _le_config(rt, size)
    if le is not None:
        return _lc_le_system(rt, lb_cfg, lcfg, le, q0, solid)
    col = _parse_colloids(rt, size, lb_cfg.rho0, lb_cfg.eta_shear, lb_cfg)
    if col is not None:
        return _lc_colloid_system(rt, lb_cfg, lcfg, q0, col)
    if _fused_request(rt) and _lc_fused_ok(lcfg, solid):
        return System(rt=rt, lb_cfg=lb_cfg,
                      state=initial_fused_lc(lcfg, q0),
                      step_fn=make_fused_lc_step(lcfg),
                      fused_mode="lc", lc_cfg=lcfg,
                      grad_leaves=_grad_leaves(rt, lb_cfg,
                                               "lc_blue_phase", None))
    lcfg = dataclasses.replace(lcfg, keep_grads=True)
    return System(rt=rt, lb_cfg=lb_cfg, state=lc.initial_lc(lcfg, q0),
                  step_fn=lc.make_lc_step(lcfg, solid=solid), lc_cfg=lcfg,
                  keep_grads=True, solid=solid)


def _lc_colloid_system(rt: RunTime, lb_cfg: LBConfig, lcfg: lc.LCConfig,
                       q0, col: dict) -> System:
    """The liquid crystal with resolved colloids (ludwig_tpu ludwig.py:
    1306-1320): lc_colloid.make_lc_colloid_step with the pair, bond and
    other particle forces of force_fn (the JAX LC route reads the wall
    forces, the wall lubrication and the torques and applies none of
    them, and neither does the port).  The particles need the anchoring
    stencils; subgrid particles are not ported here."""
    cp = col["params"]
    if cp.types and any(tp == "subgrid" for tp in cp.types):
        raise _not_ported("colloid_init", rt.string("colloid_init")
                          + " with subgrid particles in the liquid crystal")
    if lcfg.anchoring is None:
        raise _not_ported("fd_gradient_calculation", lcfg.gradient
                          + " beside colloids (the colloid map needs "
                          "3d_7pt_solid or s7_anchoring)")
    state = lc_colloid.initial_lc_colloid(lcfg, cp, q0, col["R"], col["V"])
    step = lc_colloid.make_lc_colloid_step(
        lcfg, cp, rebuild_freq=rt.int("colloid_rebuild_freq", 1),
        force_fn=col["force_fn"])
    return System(rt=rt, lb_cfg=lb_cfg, state=state, step_fn=step,
                  lc_cfg=lcfg, colloid_params=cp)


def _family_colloid_system(rt: RunTime, lb_cfg: LBConfig, fe_name: str,
                           col: dict) -> System:
    """Resolved colloids in the binary fluid (`free_energy symmetric`),
    symmetric_lb and the electrolyte (`fe_electro`), gate for gate with
    ludwig_tpu ludwig.py:1392-1423 and :1465-1558: the 27-point solid
    stencil with the particles' uniform wetting colloid_one_c / _h by
    default, halo walls around the binary suspensions, the put-back of
    the removed phi from the v0.12 logs on (_log_vintage); the
    electrolyte's particles carry their charges colloid_*_q0 / q1, set
    on their volume before the counter-charge makes the fluid neutral
    (ref: ludwig.c:420-424), and take the Maxwell stress by default
    (fe_force_method).  The pair, bond and driving forces of force_fn
    apply; the wall forces, the wall lubrication and the torques are read
    and not applied, as in the JAX package."""
    cp = col["params"]
    if cp.types and any(tp == "subgrid" for tp in cp.types):
        raise _not_ported("colloid_init", rt.string("colloid_init")
                          + f" with subgrid particles in free_energy "
                          f"{fe_name}")
    size = lb_cfg.size
    rebuild = rt.int("colloid_rebuild_freq", 1)
    wet = (rt.double("colloid_one_c", 0.0), rt.double("colloid_one_h", 0.0))
    ws = None
    if fe_name != "fe_electro" and any(lb_cfg.walls):
        ws = WallSpec(walls=lb_cfg.walls)
        lb_cfg = dataclasses.replace(lb_cfg, walls=(False,) * 3)
    if fe_name == "symmetric":
        fe = _symm_fe(rt)
        bcfg = BinaryConfig(
            lb=lb_cfg, fe=fe, mobility=rt.double("mobility", 1.0),
            advection_order=rt.int("fd_advection_scheme_order", 1),
            gradient=rt.string("fd_gradient_calculation", "3d_27pt_solid"),
            wetting=wet)
        state = binary_colloid.initial_binary_colloid(
            bcfg, cp, _phi_init(rt, size, fe), col["R"], col["V"],
            W0=col["W"], dr0=col["dr"], walls=ws is not None)
        step = binary_colloid.make_binary_colloid_step(
            bcfg, cp, rebuild_freq=rebuild, force_fn=col["force_fn"],
            phi_ref=rt.double("phi0", 0.0), wallspec=ws,
            conserve_phi=rt.int("_log_vintage", 9999) >= 12)
        return System(rt=rt, lb_cfg=lb_cfg, state=state, step_fn=step,
                      binary_cfg=bcfg, colloid_params=cp, wallspec=ws)
    if fe_name == "symmetric_lb":
        fe = _symm_fe(rt)
        l2cfg = BinaryLBConfig(
            lb=lb_cfg, fe=fe, mobility=rt.double("mobility", 0.15),
            gradient=rt.string("fd_gradient_calculation", "3d_27pt_solid"))
        state = initial_binary_lb_colloid(
            l2cfg, cp, _phi_init(rt, size, fe), col["R"], col["V"],
            W0=col["W"], dr0=col["dr"], walls=ws is not None)
        step = make_binary_lb_colloid_step(
            l2cfg, cp, rebuild_freq=rebuild, force_fn=col["force_fn"],
            phi_ref=rt.double("phi0", 0.0), wetting=wet, wallspec=ws)
        return System(rt=rt, lb_cfg=lb_cfg, state=state, step_fn=step,
                      lb2_cfg=l2cfg, colloid_params=cp, wallspec=ws)
    if any(lb_cfg.walls):
        raise _not_ported("boundary_walls", rt.string("boundary_walls")
                          + " beside charged colloids")
    ecfg, psi0, rho_k, _solid = _electrolyte(rt, lb_cfg)
    qq = torch.as_tensor(np.array(col["q"], np.float64).reshape(-1, 2),
                         dtype=lb_cfg.tdtype, device=lb_cfg.device)
    R0 = torch.as_tensor(np.array(col["R"], np.float64).reshape(-1, 3),
                         dtype=lb_cfg.tdtype, device=lb_cfg.device)
    pid, inside = build_map(R0, cp, size)
    zeros = torch.zeros((cp.n, ecfg.ek.nk), dtype=lb_cfg.tdtype,
                        device=lb_cfg.device)
    rho_j = electro_colloid.colloid_rho_set(
        torch.as_tensor(rho_k, dtype=lb_cfg.tdtype, device=lb_cfg.device),
        inside, pid, qq, zeros, ecfg.ek.nk)
    rho_k = electro_sim.electroneutral(rho_j.cpu().numpy(),
                                       ecfg.ek.valency,
                                       inside.cpu().numpy())
    method = rt.string("fe_force_method", "stress_divergence")
    if method not in _FORCE_METHODS:
        raise ValueError(f"fe_force_method '{method}' not recognised")
    state = electro_colloid.initial_electro_colloid(ecfg, cp, psi0, rho_k,
                                                    col["R"], col["V"])
    step = electro_colloid.make_electro_colloid_step(
        ecfg, cp, qq, rebuild_freq=rebuild, force_fn=col["force_fn"],
        force_method=method)
    return System(rt=rt, lb_cfg=lb_cfg, state=state, step_fn=step,
                  electro_cfg=ecfg, colloid_params=cp, colloid_charge=qq,
                  hydro_on=ecfg.hydrodynamics)


def _porous(rt: RunTime, size) -> Optional[np.ndarray]:
    """The porous-media solid mask of an input, or None (_porous_map)."""
    return _porous_map(rt, size)[0]


def _porous_map(rt: RunTime, size):
    """(solid mask, wetting) of an input's porous media (ludwig_tpu
    ludwig.py:624-666), or (None, None): `porous_media_file` names a .npy
    mask, or is the reference's switch for the map file
    ("capillary.001-001" by default; ref: map_rt.c:100-176) with
    porous_media_ndata / porous_media_type and porous_media_format;
    `porous_media_init` makes a geometry of io/map_file.GEOMETRIES (ref:
    map_rt.c:252-295).  wetting is the map's per-site (C, H), numpy
    arrays, where it carries them (ndata 2: C and H; ndata 1: H, C = 0),
    else None; the binary fluid's solid stencils read it."""
    pm_file = rt.string("porous_media_file")
    if pm_file:
        if pm_file.endswith(".npy") or os.path.exists(pm_file + ".npy"):
            return np.load(pm_file if pm_file.endswith(".npy")
                           else pm_file + ".npy").astype(bool), None
        ndata = rt.int("porous_media_ndata", -1)
        if ndata < 0:
            ndata = {"status_only": 0, "status_with_h": 1,
                     "status_with_sigma": 1, "status_with_c_h": 2}.get(
                rt.string("porous_media_type", "status_only"), 0)
        fmt = rt.string("porous_media_format", "BINARY")
        stub = pm_file if os.path.exists(pm_file) else (
            pm_file + ".001-001" if os.path.exists(pm_file + ".001-001")
            else "capillary.001-001")
        status, data = read_map(stub, size, ndata,
                                binary=not fmt.startswith("ASCII"))
        wetting = None
        if ndata == 2:
            wetting = (data[0], data[1])
        elif ndata == 1:
            wetting = (np.zeros(size), data[0])
        return status != 0, wetting
    gname = rt.string("porous_media_init")
    if gname:
        if gname not in GEOMETRIES:
            raise ValueError(f"porous_media_init not recognised {gname}")
        acell = (rt.int_required("porous_media_acell")
                 if gname.endswith("cubic") else 0)
        return GEOMETRIES[gname](size, acell) != 0, None
    return None, None


def _wall_system(rt: RunTime, lb_cfg: LBConfig, walls) -> System:
    """Halo plane walls, every stored site fluid (ludwig_tpu ludwig.py:
    1648-1701): the fused wall step where `tpu_fused` asks for it and
    there is no slip, no noise and no open boundary (the JAX package's
    gate, without its plan and dtype conditions: the port's kernel takes
    every lattice and dtype); else make_wall_step, with the KISS state
    where fluctuations are on and the open boundary along the first
    unwalled axis."""
    ub = rt.double("boundary_speed_bottom", 0.0)
    ut = rt.double("boundary_speed_top", 0.0)
    sb = tuple(rt.double_vector("boundary_walls_slip_fraction_bot",
                                (0.0, 0.0, 0.0)))
    st_ = tuple(rt.double_vector("boundary_walls_slip_fraction_top",
                                 (0.0, 0.0, 0.0)))
    slip_on = (rt.switch("boundary_walls_slip_active", False)
               or any(sb) or any(st_))
    ws = WallSpec(walls=walls, ubot=(ub, 0.0, 0.0), utop=(ut, 0.0, 0.0),
                  slip_bot=sb, slip_top=st_, slip_active=slip_on)
    lb_cfg = dataclasses.replace(lb_cfg, walls=(False,) * 3)
    f = _distribution_init(rt, lb_cfg)
    gwall = torch.zeros((3,), dtype=lb_cfg.tdtype, device=lb_cfg.device)
    open_on = rt.switch("lb_bc_open", False)
    if (_fused_request(rt) and not slip_on and lb_cfg.noise is None
            and not open_on):
        return System(rt=rt, lb_cfg=lb_cfg, state=(f, gwall),
                      step_fn=make_fused_wall_step(lb_cfg, ws),
                      fused_mode="wall", wallspec=ws)
    obc, oax = None, 0
    if open_on:
        obc = OpenBCConfig(
            u0=tuple(rt.double_vector("lb_bc_inflow_rhou_u0",
                                      (0.0, 0.0, 0.0))),
            rho0=rt.double("lb_bc_outflow_rhou_rho0", 1.0))
        oax = next((a for a in range(3) if not walls[a]), 0)
    state = (f, gwall)
    if kiss_on(lb_cfg):
        state = state + (kiss_init(0, lb_cfg.size, device=lb_cfg.device),)
    return System(rt=rt, lb_cfg=lb_cfg, state=state,
                  step_fn=make_wall_step(lb_cfg, ws, open_bc=obc,
                                         open_axis=oax),
                  wallspec=ws)


def _plain_system(rt: RunTime, lb_cfg: LBConfig) -> System:
    """The `free_energy none` branch of ludwig_tpu build_system
    (ludwig.py:1640-1767), gate for gate: halo walls without porous
    media or Lees-Edwards planes (_wall_system); otherwise in-lattice
    solid planes and porous sites, the fused Lees-Edwards step (no
    solid, no noise), the fused plain step, or the unfused make_step
    with solid sites, planes and the KISS state.  Without noise the
    port runs its kernel wherever `tpu_fused` asks for it, f64 and
    lattices without a JAX fused plan included (reference_statistics
    still prints what the JAX package's route would)."""
    size = lb_cfg.size
    nz = lb_cfg.noise
    le = _le_config(rt, size)
    porous = _porous(rt, size)
    if any(lb_cfg.walls) and le is None and porous is None:
        return _wall_system(rt, lb_cfg, lb_cfg.walls)
    if rt.switch("lb_bc_open", False):
        # the JAX package imposes the open boundary beside halo walls only
        raise _not_ported("lb_bc_open", rt.string("lb_bc_open") +
                          " without halo walls")
    f = _distribution_init(rt, lb_cfg)
    solid = solid_mask(lb_cfg, porous)
    if _fused_request(rt) and le is not None and solid is None and nz is None:
        # the sheared fast path: the kernel + the LE column post-pass
        # (ref: model_le.c:57; ludwig.c:811)
        return System(rt=rt, lb_cfg=lb_cfg, state=(f,),
                      step_fn=make_fused_le_step(lb_cfg, le),
                      fused_mode="le", le_cfg=le)
    # with isothermal fluctuations the step follows the JAX package's
    # gate, since the two routes draw different noise: FusedNoise where
    # it takes its fused kernel, the KISS stream where it does not (f64
    # under tpu_fused on, no _fused_plan).  Without noise the fused route
    # differs from the unfused one by roundoff only, and the port keeps
    # its kernel.
    if (_fused_request(rt) and le is None and solid is None
            and (nz is None or _jax_fused_plain(rt, lb_cfg))):
        # production path: the fused collide+stream (kernel on a GPU,
        # twin on the CPU); with isothermal fluctuations the kernel draws
        # the counter-hash stream of FusedNoise, keyed on random_seed
        # (ludwig_tpu ludwig.py:1719-1760)
        model = lb_cfg.model
        params = lb_cfg.collision_params()
        fnz = None
        if nz is not None:
            fnz = FusedNoise(
                seed=nz.seed,
                v_eta=var_eta(1.0 / params.rtau_shear, nz.kt),
                v_bulk=var_bulk(1.0 / params.rtau_bulk, nz.kt),
                v_ghost=tuple(var_ghost(model, params.rtau_ghost, nz.kt)))

        def step(f, t=0):
            return fused_step(f, model, params, t=t, noise=fnz)

        return System(rt=rt, lb_cfg=lb_cfg, state=(f,), step_fn=step,
                      fused_mode="plain")
    state = (f,)
    if kiss_on(lb_cfg):
        # the reference-exact KISS stream: the JAX package seeds it with
        # master seed 0 (hence 13), not random_seed (ludwig_tpu
        # ludwig.py:1762-1767)
        state = (f, kiss_init(0, size, device=lb_cfg.device))
    return System(rt=rt, lb_cfg=lb_cfg, state=state,
                  step_fn=make_step(lb_cfg, solid=solid, le=le),
                  solid=solid, le_cfg=le)


def _parse_colloids(rt: RunTime, size, rho0: float, eta: float,
                    lb_cfg: LBConfig):
    """The colloid_* keys of an input (ludwig_tpu ludwig.py:334-592; ref:
    colloids_rt.c colloids_init_rt, interaction.c interact_compute): None
    when no particles are placed, else a dict of the ColloidParams, the
    initial R, V, W, dr (0-based), the subgrid particles' al, the charges
    q (N, 2) (q0, q1), the particles' LCG seeds rngs (a configuration
    file's rng words, else 1 + index; ludwig_tpu ludwig.py:415, 577-578)
    and the force and torque callbacks (pair, bond, angle, lubrication,
    driving and dipolar terms, the magnetic torque)."""
    cinit = rt.string("colloid_init", "none")
    if _no_colloids(cinit):
        return None
    a0, ah, rr, vv, b1, b2, mm, typ, al, qq = ([] for _ in range(10))
    ss, drs, ws, fixedr, bonds, angles, itypes, rngs = (
        [] for _ in range(8))
    if cinit == "input_random":
        # serial random placement (ref: colloids_init.c:82-123, ran.c's
        # serial stream seeded by random_seed; 1-based positions there)
        nc = rt.int("colloid_random_no", 0)
        dh = rt.double("colloid_random_dh", 0.0)
        ra0 = rt.double_required("colloid_random_a0")
        rah = rt.double("colloid_random_ah", ra0)
        rng = RanSerial(rt.int("random_seed", 7361237))
        amax = rah + dh
        lex = [amax * (0.0 if p else 1.0)
               for p in rt.int_vector("periodicity", (1, 1, 1))]
        rtype = rt.string("colloid_random_type", "default")
        for _ in range(nc):
            r0 = [0.5 + lex[a] + rng.uniform() * (size[a] - 2.0 * lex[a])
                  for a in range(3)]
            rr.append([c - 1.0 for c in r0])
            a0.append(ra0)
            ah.append(rah)
            vv.append((0.0, 0.0, 0.0))
            b1.append(0.0)
            b2.append(0.0)
            mm.append((1.0, 0.0, 0.0))
            typ.append(rtype)
    elif cinit == "from_file":
        stub = rt.string("colloid_file_stub", "config.cds")
        nstart = rt.int("N_start", 0)
        if nstart > 0:
            # a restart reads the generating run's dump (ref: colloid_io.c
            # config.cds%8.8d.%3.3d-%3.3d)
            path = f"{stub}{nstart:08d}.001-001"
        else:
            path = next((c for c in (stub + ".init", stub + ".init.001-001",
                                     stub + ".001-001", stub)
                         if os.path.exists(c)), stub + ".init")
        for ni, rec in enumerate(read_colloid_file(path)):
            a0.append(rec["a0"])
            ah.append(rec["ah"])
            al.append(rec.get("al", 0.0))
            rr.append([c - 1.0 for c in rec["r"]])
            vv.append(tuple(rec["v"]))
            drs.append(tuple(rec.get("dr", (0.0, 0.0, 0.0))))
            ws.append(tuple(rec.get("w", (0.0, 0.0, 0.0))))
            b1.append(rec["b1"])
            b2.append(rec["b2"])
            mm.append(tuple(rec["m"]) if any(rec["m"]) else (1.0, 0.0, 0.0))
            typ.append({0: "default", 1: "active", 2: "subgrid"}.get(
                rec["type"], "default"))
            ss.append(tuple(rec.get("s", (0.0, 0.0, 0.0))))
            qq.append((rec.get("q0", 0.0), rec.get("q1", 0.0)))
            rngs.append(rec.get("rng", 1 + ni))
            fx = rec.get("isfixedr", 0)
            fxv = rec.get("isfixedrxyz", [fx, fx, fx])
            fixedr.append(tuple(fxv) if not (fx and not any(fxv))
                          else (1, 1, 1))
            for bi in range(rec.get("nbonds", 0)):
                other = rec["bond"][bi] - 1
                if other > ni:            # each bond once
                    bonds.append((ni, other))
    else:
        nc = {"input_one": 1, "input_two": 2, "input_three": 3}.get(cinit)
        if nc is None:
            raise ValueError(f"colloid_init '{cinit}' not recognised")
        for ni, nm in enumerate(("one", "two", "three")[:nc]):
            key = f"colloid_{nm}_"
            a0.append(rt.double_required(key + "a0"))
            ah.append(rt.double(key + "ah", a0[-1]))
            al.append(rt.double(key + "al", 0.0))
            rr.append([c - 1.0 for c in rt.double_vector(key + "r",
                                                         (0.0, 0.0, 0.0))])
            vv.append(rt.double_vector(key + "v", (0.0, 0.0, 0.0)))
            b1.append(rt.double(key + "b1", 0.0))
            b2.append(rt.double(key + "b2", 0.0))
            ss.append(tuple(rt.double_vector(key + "s", (0.0, 0.0, 0.0))))
            mv = rt.double_vector(key + "m", (1.0, 0.0, 0.0))
            nrm = np.sqrt(sum(c * c for c in mv)) or 1.0
            mm.append(tuple(c / nrm for c in mv))
            typ.append(rt.string(key + "type", "default"))
            itypes.append(rt.int(key + "interact_type", 0))
            # the charges (free_energy fe_electro)
            qq.append((rt.double(key + "q0", 0.0), rt.double(key + "q1", 0.0)))
            fx = rt.int(key + "isfixedr", 0)
            fixedr.append(tuple(rt.int_vector(key + "isfixedrxyz",
                                              (fx, fx, fx))))
            mybonds = []
            for bi in range(rt.int(key + "nbonds", 0)):
                other = rt.int(f"{key}bond{bi + 1}", 0) - 1
                mybonds.append(other)
                if other > ni:
                    bonds.append((ni, other))
            if rt.int(key + "nangles", 0) and len(mybonds) >= 2:
                # the one angle spans the two bonds (ref:
                # angle_cosine.c:161-167)
                angles.append((mybonds[0], ni, mybonds[1]))
    nc = len(rr)
    for key, on in (("porous_media_file", rt.has_key("porous_media_file")),
                    ("porous_media_init", rt.has_key("porous_media_init")),
                    ("N_LE_plane", rt.int("N_LE_plane", 0) > 0),
                    ("lb_bc_open", rt.switch("lb_bc_open", False))):
        if on:
            raise _not_ported(key, rt.string(key) + " beside colloids")
    grav = tuple(rt.double_vector("colloid_gravity", (0.0, 0.0, 0.0)))
    if rt.switch("calibration", False):
        # the hydrodynamic-radius calibration drives the particle with a
        # fixed force along the reference's literal random direction (ref:
        # stats_calibration.c:120-143)
        a_, L_ = max(ah), float(size[2])
        fh = (1.0 - 2.837 * (a_ / L_) + 4.19 * (a_ / L_) ** 3
              - 27.4 * (a_ / L_) ** 6)
        ftarget = 6.0 * np.pi * eta * a_ * (eta * 0.05 / (a_ * rho0)) / fh
        grav = (+5.02274083742018e-01 * ftarget,
                -1.05061333197473e-01 * ftarget,
                -8.58302313330149e-01 * ftarget)
    cparams = ColloidParams(
        a0=tuple(a0), ah=tuple(ah), rho0=rho0, gravity=grav,
        b1=tuple(b1), b2=tuple(b2), m=tuple(mm), types=tuple(typ),
        isfixedr=tuple(fixedr), bonds=tuple(bonds), angles=tuple(angles))
    terms = _force_terms(rt, lb_cfg, size, eta, cparams, ss, itypes)
    force_fn = torque_fn = None
    if terms:
        def force_fn(R, V):
            out = terms[0](R, V)
            for term in terms[1:]:
                out = out + term(R, V)
            return out
    if rt.int("ewald_sum", 0):
        # dipolar Ewald interactions (ref: ewald.c via interact_compute),
        # the dipoles s as read
        emu = rt.double("ewald_mu", 0.0)
        erc = rt.double("ewald_rc", float(min(size)) / 2.0)
        s0 = np.array([list(v) if any(v) else [0.0, 0.0, 0.0]
                       for v in (ss or [(0.0, 0.0, 0.0)] * nc)])
        if np.any(s0 != 0.0):
            S0 = torch.as_tensor(s0, dtype=lb_cfg.tdtype,
                                 device=lb_cfg.device)
            prev = force_fn

            def force_fn(R, V, _p=prev):
                F, _ = ewald_sum(R, S0, emu, erc, size)
                return F + (_p(R, V) if _p is not None else 0.0)

            def torque_fn(R, V):
                return ewald_sum(R, S0, emu, erc, size)[1]
    b0 = tuple(rt.double_vector("magnetic_b0", (0.0, 0.0, 0.0)))
    if any(b0):
        # the torque s x B on each dipole (ref: interaction.c:417-419)
        S0b = torch.as_tensor(np.array([list(v) for v in (
            ss or [(0.0, 0.0, 0.0)] * nc)], np.float64),
            dtype=lb_cfg.tdtype, device=lb_cfg.device)
        b0t = torch.as_tensor(np.array(b0), dtype=lb_cfg.tdtype,
                              device=lb_cfg.device)
        prev_t = torque_fn

        def torque_fn(R, V, _p=prev_t):
            tq = torch.linalg.cross(S0b, b0t[None, :].expand_as(S0b))
            return tq + (_p(R, V) if _p is not None else 0.0)

    zeros = [(0.0, 0.0, 0.0)] * nc
    # random placement reads no charges: uncharged particles
    return dict(params=cparams, R=rr, V=vv, W=ws or zeros, dr=drs or zeros,
                al=al, force_fn=force_fn, torque_fn=torque_fn,
                q=qq or [(0.0, 0.0)] * nc,
                rngs=rngs + [1 + i for i in range(len(rngs), nc)])


def _force_terms(rt: RunTime, lb_cfg: LBConfig, size, eta: float,
                 cp: ColloidParams, ss, itypes):
    """The per-particle force callbacks (R, V) -> (N, 3) of the pair,
    bond, angle, driving and lubrication keys (ludwig_tpu ludwig.py:
    491-575), in the JAX package's order.  Their constants go to the
    device here, once, so that no step copies from the host."""
    nc = cp.n

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               dtype=lb_cfg.tdtype, device=lb_cfg.device)

    ah = dev(cp.ah)
    terms = []
    if rt.int("angle_cosine_on", 0) and cp.angles:
        ak = rt.double_required("angle_cosine_k")
        aarr = np.array(cp.angles, np.int64)
        terms.append(lambda R, V: interactions.angle_cosine_forces(
            R, size, aarr, ak))
    if rt.int("bond_fene_on", 0) and cp.bonds:
        fk = rt.double_required("bond_fene_k")
        fr0 = rt.double_required("bond_fene_r0")
        barr = np.array(cp.bonds, np.int64)
        terms.append(lambda R, V: interactions.fene_bond_forces(
            R, size, barr, fk, fr0))
    if rt.switch("pair_ss_cut_ij", False) and nc > 1:
        # the soft spheres by type pair; the vector keys hold the upper
        # triangle (ref: pair_ss_cut_ij.c)
        nt = rt.int("pair_ss_cut_ij_ntypes", 1)
        tri = [(i, j) for i in range(nt) for j in range(i, nt)]

        def mat(key):
            vals = rt.double_vector(key, (0.0,) * len(tri))
            m = np.zeros((nt, nt))
            for (i, j), v in zip(tri, vals):
                m[i, j] = m[j, i] = v
            return m

        eps_m, sig_m = mat("pair_ss_cut_ij_epsilon"), mat("pair_ss_cut_ij_sigma")
        nu_m, hc_m = mat("pair_ss_cut_ij_nu"), mat("pair_ss_cut_ij_hc")
        it = np.array(itypes + [0] * (nc - len(itypes)), int)
        pp = [m[np.ix_(it, it)] for m in (eps_m, sig_m, nu_m, hc_m)]
        pp[1] = np.where(pp[1] == 0.0, 1.0, pp[1])    # finite where eps = 0
        pp[3] = np.where(pp[3] == 0.0, 1.0, pp[3])
        pp = [dev(m) for m in pp]
        terms.append(lambda R, V: interactions.soft_sphere_ij_forces(
            R, ah, size, *pp)[0])
    if rt.int("soft_sphere_on", 0) and nc > 1:
        ssp = (rt.double_required("soft_sphere_epsilon"),
               rt.double_required("soft_sphere_sigma"),
               rt.double_required("soft_sphere_nu"),
               rt.double_required("soft_sphere_cutoff"))
        terms.append(lambda R, V: interactions.soft_sphere_forces(
            R, ah, size, *ssp)[0])
    if rt.int("lennard_jones_on", 0) and nc > 1:
        ljp = (rt.double_required("lj_epsilon"),
               rt.double_required("lj_sigma"), rt.double_required("lj_cutoff"))
        terms.append(lambda R, V: interactions.lj_cut_forces(R, size, *ljp))
    if rt.int("yukawa_on", 0) and nc > 1:
        ykp = (rt.double_required("yukawa_epsilon"),
               rt.double_required("yukawa_kappa"),
               rt.double_required("yukawa_cutoff"))
        terms.append(lambda R, V: interactions.yukawa_forces(R, size, *ykp))
    f0_driven = rt.double("driving_force_magnitude", 0.0)
    if f0_driven != 0.0:
        # a constant force along each particle's s (ref: driven_colloid.c)
        s_drive = f0_driven * dev(list(ss) + [(0.0, 0.0, 0.0)]
                                  * (nc - len(ss)))
        terms.append(lambda R, V: s_drive)
    if rt.int("lubrication_on", 0) and nc > 1:
        rcn = rt.double("lubrication_normal_cutoff", 0.0)
        rct = rt.double("lubrication_tangential_cutoff", 0.0)
        if rcn > 0.0:
            terms.append(lambda R, V: interactions.lubrication_normal(
                R, V, ah, size, eta, rcn))
        if rct > 0.0:
            terms.append(lambda R, V: interactions.lubrication_tangential(
                R, V, ah, size, eta, rct))
    return terms


def _colloid_system(rt: RunTime, lb_cfg: LBConfig, col: dict) -> System:
    """The plain fluid with colloids (ludwig_tpu ludwig.py:1465-1487,
    1559-1638): subgrid particles where every particle is of that type,
    else resolved particles, with halo walls around the suspension
    (wall_ss_cut_*, boundary_lubrication_*)."""
    cp = col["params"]
    dev, tdt = lb_cfg.device, lb_cfg.tdtype

    def t(a):
        return torch.as_tensor(np.array(a, np.float64).reshape(-1, 3),
                               dtype=tdt, device=dev)

    f = _distribution_init(rt, lb_cfg)
    R0 = t(col["R"])
    nz = lb_cfg.noise
    if cp.types and all(tp == "subgrid" for tp in cp.types):
        # with fluctuations the KISS state, then the particles' LCG
        # states (a host tensor: the kicks are drawn there)
        state = (f, R0, t(col["V"]))
        if kiss_on(lb_cfg):
            state = state + (kiss_init(0, lb_cfg.size, device=dev),)
        if nz is not None and nz.rho:
            state = state + (torch.tensor(col["rngs"], dtype=torch.int64),)
        return System(rt=rt, lb_cfg=lb_cfg, state=state,
                      step_fn=make_subgrid_step(lb_cfg, cp, col["al"],
                                                force_fn=col["force_fn"]),
                      colloid_params=cp, subgrid=True)
    # from_file configurations carry the angular velocity and the deferred
    # move dr: the first update moves each particle by it; with
    # fluctuations the KISS state rides (ludwig_tpu ludwig.py:1570-1572)
    state = ColloidState(f, R0, t(col["V"]), t(col["W"]), t(col["dr"]),
                         R0.clone(), t(cp.m),
                         noise=(kiss_init(0, lb_cfg.size, device=dev)
                                if kiss_on(lb_cfg) else None))
    ws, wall_ss = None, None
    lubr_rc = lubr_dh = (0.0,) * 3
    if any(lb_cfg.walls):
        # halo plane walls around the suspension (ref: wall.c;
        # wall_ss_cut.c; wall_lubr_sphere)
        ws = WallSpec(walls=lb_cfg.walls)
        lb_cfg = dataclasses.replace(lb_cfg, walls=(False,) * 3)
        state = state._replace(gwall=torch.zeros((3,), dtype=tdt,
                                                 device=dev))
        rc = rt.double("boundary_lubrication_rcnormal", 0.0)
        dh = rt.double("boundary_lubrication_dhnormal", 0.0)
        lubr_rc, lubr_dh = (rc,) * 3, (dh,) * 3
        if rt.switch("wall_ss_cut_on", False):
            wall_ss = {k: rt.double_required(f"wall_ss_cut_{k}")
                       for k in ("epsilon", "sigma", "nu", "hc")}
    step = make_colloid_step(
        lb_cfg, cp, rebuild_freq=rt.int("colloid_rebuild_freq", 1),
        force_fn=col["force_fn"], wallspec=ws, lubr_rc=lubr_rc,
        lubr_dh=lubr_dh, wall_ss=wall_ss, torque_fn=col["torque_fn"])
    return System(rt=rt, lb_cfg=lb_cfg, state=state, step_fn=step,
                  wallspec=ws, colloid_params=cp)


def _colloid_map(sys_: System, R: torch.Tensor):
    """(pid, inside) of the particles at R, by the map builder the JAX
    package's statistics use (n > 4: build_map_fast; ludwig_tpu
    ludwig.py:1911-1917)."""
    cp = sys_.colloid_params
    return build_map(R, cp, sys_.lb_cfg.size,
                     "window" if cp.n > 4 else "min_image")


def _colloid_fluid(sys_: System, R: torch.Tensor):
    """The fluid mask of the particles at R (_colloid_map); None for
    subgrid particles."""
    if sys_.subgrid:
        return None
    return ~_colloid_map(sys_, R)[1]


def _lc_efield_adjust(fe: BluePhaseFE, q5, coswt: float):
    """The fed adjustment that scales the electric term by coswt^2 (the
    full fed carries coswt == 1; ref: blue_phase.c:387-389; ludwig_tpu
    ludwig.py:1773-1782): the initial statistics (coswt 0) leave the
    field's energy out, as the reference's uncommitted parameters do."""
    if not fe.has_efield:
        return 0.0
    return (1.0 - coswt * coswt) * fe.epsilon * fe.efield_fed(
        lc.q5_to_q33(q5))


def _kt_stats(f: torch.Tensor, model, mask) -> tuple:
    """The temperature statistics, sum g_a^2 / rho over the sites of mask
    (every site where it is None) over their count, a site of rho == 0
    counting 0 (ref: collision.c:1030-1110 lb_collision_stats_kt;
    ludwig_tpu ludwig.py:2344-2359)."""
    rho_f, g_f = hydro_fields(f, model)
    w = 1.0 if mask is None else mask.to(f.dtype)
    nfl = (torch.tensor(float(rho_f.numel()), dtype=f.dtype, device=f.device)
           if mask is None else torch.sum(w))
    rho_s = torch.where(rho_f == 0.0, 1.0, rho_f)
    return tuple(torch.sum(w * g_f[a] * g_f[a] / rho_s) / nfl
                 for a in range(3))


def _make_stats_fn(sys_: System, reference: bool):
    """compute(state, u, prev=None, tstep=0, coswt=1.0) -> {rho, g, umm}
    and, for the binary
    fluid, {phi, fed}, for the liquid crystal {q5, fe_lc}, for the
    droplet {phi, q5, fed}, for electrokinetics {psi3, rhok, elc, fed}
    and, with solid sites, {gwall}; {ktstats} with fluctuations.  rho, g
    and umm are over the fluid sites; with halo walls {gwall} too.
    `prev` is the order-parameter state before the last step: (phi,),
    (q5,) or the droplet's (phi, q5); tstep the step just taken, which
    the Lees-Edwards gradients of a sheared binary or LC run read;
    coswt the electric field's phase as the statistics see it: 0 at the
    initial statistics, 1 in the loop (_lc_efield_adjust).  The liquid
    crystal's [fe] row carries the surface terms f_s1 fs_s2 beside halo
    walls and, with colloids, f_s and the area of the particles' surface
    (fe_lc_coll).

    `reference` selects the JAX package's reference-ordered statistics
    (ludwig.py _make_stats_fn: rho_stats_ref, momentum_total_ref, the
    field scans, seq_sum totals, the masked kT sums) over the plain
    reductions of its fused path (_make_fast_stats_fn); see
    reference_statistics for which a run prints."""
    model = sys_.lb_cfg.model
    bcfg = sys_.binary_cfg
    lcfg = sys_.lc_cfg
    dcfg = sys_.droplet_cfg
    ecfg = sys_.electro_cfg
    escfg, tcfg = sys_.es_cfg, sys_.two_field_cfg
    l2cfg, pcfg = sys_.lb2_cfg, sys_.polar_cfg
    nz = sys_.lb_cfg.noise
    mask = sys_.fluid_mask

    def grads(state, prev, tstep):
        """(grad, delsq) of the order parameter before the step, with
        which the [fed] / [fe] statistics evaluate the updated field:
        those the state carries (the JAX package's unfused routes read
        its keep_grads tail), else computed from `prev` (the field
        itself at the initial statistics) - LE-aware on a sheared run,
        as the JAX package's fused route computes them."""
        if sys_.keep_grads:
            return state[-2], state[-1]
        src = state[1] if prev is None else prev[0]
        if sys_.le_cfg is not None:
            return le_gradient(src, sys_.le_cfg, tstep,
                               bcfg.gradient if bcfg is not None
                               else GRADIENT)
        if bcfg is not None:
            fl = fe_fields(src, bcfg.gradient, solid_ops=sys_.fe_ops)
            return fl["grad_phi"], fl["delsq_phi"]
        return grad_7pt(src), delsq_7pt(src)

    def family_colloid_stats(state, fl, coswt):
        """The binary fluid's, symmetric_lb's and the electrolyte's rows
        beside their particles (ludwig_tpu ludwig.py:1962-2086): [phi]
        over the fluid sites (symmetric_lb: phi of g with the particles'
        deficit added before the mean and variance), the electrolyte's
        psi, rho and elc with the particles' charge set on their volume
        first and [psi_zeta] for one particle, and the fluid's free
        energy f v (fe_colloid) with the step's kept gradients, computed
        afresh at the initial statistics (coswt 0)."""
        out = {}
        size = sys_.lb_cfg.size
        walls = (sys_.wallspec.walls if sys_.wallspec is not None
                 else (False,) * 3)
        if ecfg is not None:
            ek = ecfg.ek
            pid, inside = _colloid_map(sys_, state[1])
            psi = state[7]
            rhok = electro_colloid.colloid_rho_set(
                state[8], inside, pid, sys_.colloid_charge, state[10], ek.nk)

            def tmm(x):
                return stats.seq_sum(x), torch.min(x), torch.max(x)

            out["psi3"] = tmm(psi)
            out["rhok"] = [tmm(rhok[k]) for k in range(ek.nk)]
            out["elc"] = tmm(rho_elec(rhok, ek))
            fed = fe_electro_fed(rhok, ek, psi)
            if sys_.colloid_params.n == 1:
                out["psi_zeta"] = electro_colloid.zeta_potential(psi, fl,
                                                                 inside)
        else:
            fe = (bcfg or l2cfg).fe
            if bcfg is not None:
                phi = state[7]
                out["phi"] = stats.field_stats_ref(phi, fl, klein="kahan")
                wet = bcfg.wetting
            else:
                phi = g_moments(state[7], model)[0]
                tot, mean, var, mn, mx = stats.field_stats_ref(
                    phi, fl, klein="klein")
                tot2 = tot + torch.sum(state[9])
                mean2 = tot2 / torch.sum(fl.to(phi.dtype))
                out["phi"] = (tot2, mean2, (var + mean * mean)
                              - mean2 * mean2, mn, mx)
                wet = (0.0, 0.0)     # the initial stats' stencil: no wetting
            if coswt == 0.0:
                grad, delsq = solid27_scalar_ops(
                    size, fluid=fl, rkappa=1.0 / fe.kappa, c=wet[0],
                    h=wet[1], walls=walls).both(phi)
            else:
                grad, delsq = state[9 + int(l2cfg is not None)], \
                    state[10 + int(l2cfg is not None)]
            fed = fe.fed({"phi": phi, "grad_phi": grad, "delsq_phi": delsq})
        zero = torch.zeros((), dtype=fed.dtype, device=fed.device)
        out["fe_colloid"] = (torch.sum(torch.where(fl, fed, zero)),
                             torch.sum(fl.to(fed.dtype)))
        return out

    def compute(state, u, prev=None, tstep=0, coswt=1.0):
        f = state[0]
        if sys_.is_colloid:
            # the fluid sites of the particles' current map, the colloids'
            # momentum, their velocities before the step (the reference
            # prints them from the top of the step; ludwig_tpu
            # ludwig.py:1908-1960)
            fl = _colloid_fluid(sys_, state[1])
            V = state[2]
            # logs before v0.7 sum the momentum plainly in rank order
            # (ludwig_tpu ludwig.py:1925-1944)
            vintage = sys_.rt.int("_log_vintage", 9999)
            res = {"rho": stats.rho_stats_ref(f, model, fl),
                   "g": (stats.momentum_total_seq(f, model, fl, blocks=(
                       sys_.rt.int_vector("_mpi_grid", (1, 1, 1))))
                         if vintage < 7
                         else stats.momentum_total_ref(f, model, fl)),
                   "gc": (torch.zeros((3,), dtype=f.dtype, device=f.device)
                          if sys_.subgrid
                          else total_colloid_momentum(V, sys_.colloid_params)),
                   "umm": stats.velocity_minmax(u, fl)}
            if sys_.wallspec is not None:
                # the binary and symmetric_lb tuples carry gwall last
                res["gwall"] = (state.gwall if isinstance(state, ColloidState)
                                else state[-1])
            vstat = prev[0] if prev else V
            res["vcol"] = (torch.amin(vstat, dim=0), torch.amax(vstat, dim=0))
            if lcfg is not None:
                # LC + colloids (ludwig_tpu ludwig.py:2031-2062): Q over
                # the fluid sites, the fed with the step's gradients summed
                # in site order, the walls' surface terms or the
                # particles' (ref: fe_lc_stats.c fe_lc_colloid)
                pid, inside = _colloid_map(sys_, state[1])
                q5 = state[7]
                res["q5"] = [stats.field_stats_ref(q5[n], fl)
                             for n in range(5)]
                fields = {"q": q5, "grad_q": state[9], "delsq_q": state[10]}
                fed = lcfg.fe.fed(fields) + _lc_efield_adjust(lcfg.fe, q5,
                                                              coswt)
                ftot = stats.seq_sum(fed, fl)
                vol = torch.sum(fl.to(fed.dtype))
                if lcfg.has_walls:
                    res["fe_lc"] = (ftot, vol) + lc.lc_surface_fe(lcfg, q5)
                    res["gwall"] = state[11]
                else:
                    res["fe_lc_coll"] = (ftot, vol) + (
                        lc_colloid.lc_colloid_surface_fe(
                            lcfg.fe, lcfg.anchoring, q5, pid, inside,
                            state[5], sys_.lb_cfg.size))
            if bcfg is not None or l2cfg is not None or ecfg is not None:
                res.update(family_colloid_stats(state, fl, coswt))
            if nz is not None and nz.rho:
                # over the fluid sites of the particles' map, every site
                # beside subgrid particles (ludwig_tpu ludwig.py:2086-2106)
                res["ktstats"] = _kt_stats(f, model, fl)
            return res
        if reference and sys_.rt.int("_log_vintage", 9999) < 12:
            # logs before v0.12 (the Kahan rewrite) sum plainly, in the
            # rank order of their run (ludwig_tpu ludwig.py:2107-2116)
            blocks = tuple(sys_.rt.int_vector("_mpi_grid", (1, 1, 1)))
            res = {"rho": stats.rho_stats_ref(f, model, mask, blocks=blocks),
                   "g": stats.momentum_total_seq(f, model, mask,
                                                 blocks=blocks)}
        elif reference:
            res = {"rho": stats.rho_stats_ref(f, model, mask),
                   "g": stats.momentum_total_ref(f, model, mask)}
        else:   # the JAX package's fused routes have no solid sites
            rho, _g = hydro_fields(f, model)
            res = {"rho": stats.field_stats(rho),
                   "g": stats.momentum_total_plain(f, model)}
        res["umm"] = stats.velocity_minmax(u, mask)
        if reference and sys_.vol_flux:
            # the [vol flux] line (ludwig_tpu ludwig.py:2124-2126)
            um = u if mask is None else torch.where(mask[None], u, 0.0)
            res["uflux"] = torch.sum(um, dim=(1, 2, 3))
        if sys_.wallspec is not None:
            # halo walls: gwall rides the state, (f, gwall[, nstate]) or
            # after u: the binary fluid's and symmetric_lb's (f, phi|g, u,
            # gwall, ...), the two-field fluids' (f, phi, psi, u, gwall)
            res["gwall"] = state[1 + sys_.n_fields + int(sys_.n_fields > 0)]
        if ecfg is not None:
            # ludwig_tpu ludwig.py:2127-2161 (an electrokinetic run always
            # prints the reference statistics): site-order totals
            if escfg is not None:
                phi, psi, rhok, gwall = state[1], state[2], state[3], None
            else:
                psi, rhok, gwall = state[1], state[2], state[4]

            def tmm(x):
                return stats.seq_sum(x), torch.min(x), torch.max(x)

            res["psi3"] = tmm(psi)
            res["rhok"] = [tmm(rhok[k]) for k in range(ecfg.ek.nk)]
            res["elc"] = tmm(rho_elec(rhok, ecfg.ek))
            if escfg is not None:
                # the coupled run: [phi], and the coupled fed with the
                # gradients of the phi before the step
                res["phi"] = stats.field_stats_ref(phi)
                fields = fe_fields(phi if prev is None else prev[0],
                                   escfg.gradient)
                fields["phi"] = phi
                fed = escfg.fe.fed_coupled(fields, rhok, psi)
            else:
                fed = fe_electro_fed(rhok, ecfg.ek, psi)
            fluid = (torch.mean(fed) if mask is None
                     else torch.sum(torch.where(mask, fed, 0.0))
                     / torch.sum(mask))
            res["fed"] = (torch.mean(fed), fluid)
            if mask is not None and gwall is not None:
                res["gwall"] = gwall
        if tcfg is not None:
            # ludwig_tpu ludwig.py:2224-2261: both fields, the fed of the
            # updated fields with the pre-step gradients; the ternary
            # surface terms beside walls
            phi, psi = state[1], state[2]
            res["phi"] = stats.field_stats_ref(phi, mask)
            res["psi"] = stats.field_stats_ref(psi, mask)
            src = (phi, psi) if prev is None else prev
            fields = two_fields(src[0], src[1], tcfg.gradient,
                                solid_ops=sys_.fe_ops)
            fields["phi"], fields["psi"] = phi, psi
            fed = tcfg.fe.fed(fields)
            if mask is None:
                res["fed"] = (torch.mean(fed), torch.mean(fed))
                res["fe_sum"] = torch.sum(fed)
            else:
                fsum = torch.sum(torch.where(mask, fed, 0.0))
                res["fed"] = (torch.mean(torch.where(mask, fed, 0.0)),
                              fsum / torch.sum(mask))
                res["fe_sum"] = fsum
            if sys_.wallspec is not None and isinstance(tcfg.fe, TernaryFE):
                res["tern_surf"] = ternary_surface_fe(phi, psi, tcfg.fe,
                                                      sys_.wallspec.walls)
        if l2cfg is not None:
            # ludwig_tpu ludwig.py:2164-2192: phi of the g distribution,
            # the fed with the pre-step gradients (LE runs carry them)
            phi = g_moments(state[1], model)[0]
            res["phi"] = stats.field_stats_ref(phi, klein=False)
            if sys_.le_cfg is not None:
                fields = {"phi": phi, "grad_phi": state[-2],
                          "delsq_phi": state[-1]}
            else:
                src = phi if prev is None else g_moments(prev[0], model)[0]
                fields = fe_fields(src, l2cfg.gradient,
                                   solid_ops=sys_.fe_ops)
                fields["phi"] = phi
            fed = l2cfg.fe.fed(fields)
            res["fed"] = (torch.mean(fed), torch.mean(fed))
            if sys_.wallspec is not None:
                res["fe_sum_v"] = (stats.seq_sum(fed), float(fed.numel()))
        if pcfg is not None:
            # ludwig_tpu ludwig.py:2262-2271
            p = state[1]
            res["pvec"] = [stats.field_stats_ref(p[a], mask)
                           for a in range(3)]
            fields = polar_fields(p if prev is None else prev[0],
                                  pcfg.gradient)
            fields["p"] = p
            fed = pcfg.fe.fed(fields)
            m = (torch.mean(fed) if mask is None
                 else torch.sum(torch.where(mask, fed, 0.0)) / torch.sum(mask))
            res["fed"] = (m, m)
        if bcfg is not None:
            # [phi] of the updated phi (the reference route's shifted
            # two-pass sums); [fed] with the reference's stale-gradient
            # convention: gradients of the phi before the step, the
            # updated phi in place of phi
            phi = state[1]
            res["phi"] = (stats._compensated_stats(phi, mask) if reference
                          else stats.field_stats(phi))
            grad, delsq = grads(state, prev, tstep)
            fields = {"phi": phi, "grad_phi": grad, "delsq_phi": delsq}
            fed = bcfg.fe.fed(fields)
            if mask is None:
                m = torch.mean(fed)
                res["fed"] = (m, m)
                fsum = torch.sum(fed)
                vol = torch.full((), float(fed.numel()), dtype=fed.dtype,
                                 device=fed.device)
            else:
                fsum = torch.sum(torch.where(mask, fed, 0.0))
                vol = torch.sum(mask).to(fed.dtype)
                res["fed"] = (torch.mean(torch.where(mask, fed, 0.0)),
                              fsum / vol)
            if sys_.wallspec is not None:
                # the walls' free-energy row: the fluid sum and volume,
                # the surface terms never accumulated (ref:
                # stats_free_energy.c:103-105)
                res["fe_sum_v"] = (fsum, vol)
        if lcfg is not None:
            # the same convention for [fe]: gradients of the Q before the
            # step (the unfused route's kept ones), the updated Q in place
            # of Q; the redshift the state carries; the walls' surface
            # terms (ludwig_tpu ludwig.py:2291-2343)
            q5 = state[1]
            res["q5"] = [stats.field_stats_ref(q5[n], mask) if reference
                         else stats.field_stats(q5[n]) for n in range(5)]
            grad, delsq = grads(state, prev, tstep)
            fields = {"q": q5, "grad_q": grad, "delsq_q": delsq}
            fe = lcfg.fe
            if lcfg.redshift_update:
                res["redshift"] = state[-3 if sys_.keep_grads else -1]
                fe = dataclasses.replace(fe, redshift=res["redshift"])
            fed = fe.fed(fields) + _lc_efield_adjust(fe, q5, coswt)
            if mask is None:
                ftot = torch.sum(fed)
                vol = float(fed.numel())
            else:
                ftot = torch.sum(torch.where(mask, fed, 0.0))
                vol = torch.sum(mask).to(fed.dtype)
            if lcfg.has_walls:
                res["fe_lc"] = (ftot, vol) + lc.lc_surface_fe(lcfg, q5)
                res["gwall"] = state[3]
            else:
                bulk, grad = fe.fed_bulk_grad(fields)
                if mask is not None:
                    bulk = torch.where(mask, bulk, 0.0)
                    grad = torch.where(mask, grad, 0.0)
                res["fe_lc"] = (ftot, vol, torch.sum(bulk), torch.sum(grad))
        if dcfg is not None:
            # [phi], [Qxx]..[Qyz] of the updated fields; [fed] with the
            # gradients of the pre-step phi and Q, the updated fields in
            # their place; over the fluid sites beside a solid (ludwig_tpu
            # ludwig.py:2273-2290)
            phi, q5 = state[1], state[2]
            if reference:
                res["phi"] = stats.field_stats_ref(phi, mask)
                res["q5"] = [stats.field_stats_ref(q5[n], mask)
                             for n in range(5)]
            else:
                res["phi"] = stats.field_stats(phi)
                res["q5"] = [stats.field_stats(q5[n]) for n in range(5)]
            fields = lc_droplet.droplet_fields(
                *((phi, q5) if prev is None else prev), dcfg.gradient)
            fields["phi"] = phi
            fields["q"] = q5
            fed = dcfg.fe.fed(fields)
            if mask is None:
                m = torch.mean(fed)
                res["fed"] = (m, m)
            else:
                fm = torch.where(mask, fed, 0.0)
                res["fed"] = (torch.mean(fm), torch.sum(fm) / torch.sum(mask))
        if nz is not None and nz.rho:
            # the temperature statistics (ref: collision.c:1030-1110
            # lb_collision_stats_kt; ludwig_tpu ludwig.py:1813-1817 on the
            # fused route, :2344-2359 with the rho == 0 guard on the
            # reference one)
            if reference:
                res["ktstats"] = _kt_stats(f, model, mask)
            else:
                rho_f, g_f = hydro_fields(f, model)
                res["ktstats"] = tuple(torch.mean(g_f[a] * g_f[a] / rho_f)
                                       for a in range(3))
        return res

    return compute


def _fused_u(sys_: System, f: torch.Tensor, sign: float = -1.0):
    """The reference's hydro u is the collision-time force-shifted
    velocity (g_pre + F/2)/rho.  After the kick the stored momentum is
    g_pre + F, so for a post-step f (sign -1) subtract F/2; the fused
    wall and Lees-Edwards steps log the collision-time u of the PRE-step
    state (sign +1: ludwig_tpu ludwig.py:2970 _wall_collide_u)."""
    rho, g = hydro_fields(f, sys_.lb_cfg.model)
    fg = torch.as_tensor(np.asarray(sys_.lb_cfg.force_global[:3]),
                         dtype=g.dtype, device=g.device)
    return (g + sign * 0.5 * fg[:, None, None, None]) / rho


def report_particle_block(sys_: System, res, out=sys.stdout):
    """The "Particle statistics:" section of a colloid run: the
    interaction statistics at the current positions and the colloid
    velocities of the top of the step (ludwig_tpu ludwig.py:2375-2395; ref:
    interaction.c:207-213, printed before the step's I/O lines)."""
    vmin, vmax = (v.tolist() for v in res["vcol"])
    out.write("\nParticle statistics:\n")
    R_now = sys_.state[1].detach().cpu().numpy()
    for line in interact_stats_lines(sys_.rt, sys_.colloid_params, R_now,
                                     sys_.lb_cfg.size):
        out.write(line)
    out.write("\nColloid velocities - x y z\n")
    out.write(f"[minimum ] {vmin[0]:14.7e} {vmin[1]:14.7e} {vmin[2]:14.7e}\n")
    out.write(f"[maximum ] {vmax[0]:14.7e} {vmax[1]:14.7e} "
              f"{vmax[2]:14.7e}\n\n")


def report_statistics(sys_: System, tstep: int, u, stats_fn,
                      with_velocity=True, out=sys.stdout, in_loop=True,
                      prev=None, res=None):
    """One statistics block set in the reference formats.  The
    'Completed cycle' trailer only appears inside the time loop (ref:
    ludwig.c:961).  `res`: the statistics already computed (a colloid
    run prints its particle block from them first)."""
    if res is None:
        res = stats_fn(sys_.state, u, prev, tstep, 1.0 if in_loop else 0.0)
    out.write(stats.format_rho_block(*res["rho"]))
    if sys_.is_electro:
        # ref: ludwig_tpu ludwig.py:2410-2434
        def line(tag, tot, mn, mx):
            out.write(f"[{tag}] {float(tot):14.7e} {float(mn):14.7e} "
                      f"{float(mx):14.7e}\n")

        if "phi" in res:
            # fe_electro_symmetric: [phi] precedes the psi block (ref:
            # serial-elec-do1.log:127)
            out.write(stats.format_phi_line("phi", *res["phi"]))
        line("psi", *res["psi3"])
        for r in res["rhok"]:
            line("rho", *r)
        line("elc", *res["elc"])
        if "psi_zeta" in res and (
                in_loop or sys_.rt.int("_log_vintage", 99) >= 7):
            # one particle; in the initial block too from v0.7 on (ref:
            # ludwig_tpu ludwig.py:2422-2427)
            out.write(f"[psi_zeta] {float(res['psi_zeta']):14.7e}\n")
    # [phi] (both fields of a two-field run are labelled [phi], ref:
    # phi_stats.c:94), then [Qxx]..[Qyz] or [Px ]..[Pz ], then [fed] or
    # [fe] (ref: ludwig_tpu ludwig.py:2437-2500)
    if "phi" in res and not sys_.is_electro:
        out.write(stats.format_phi_line("phi", *res["phi"]))
    if "psi" in res:
        out.write(stats.format_phi_line("phi", *res["psi"]))
    # a log whose hint says its initial block has no free energy: the
    # binary fluid's rows (not the walls' one) and the LC's go
    # (ludwig_tpu ludwig.py:2443, 2465, 2509, 2531)
    skip_fe = not (in_loop or sys_.rt.int("_t0_fe", 1) == 1)
    # the blue phase's Q rows of some older logs are labelled [phi] (a
    # hint sniffed from the log; ludwig_tpu ludwig.py:2503-2508)
    if "q5" in res:
        names = (("phi",) * 5 if sys_.is_lc
                 and sys_.rt.string("_q_labels", "q") == "phi"
                 else ("Qxx", "Qxy", "Qxz", "Qyy", "Qyz"))
        for name, q_stats in zip(names, res["q5"]):
            out.write(stats.format_phi_line(name, *q_stats))
    if "pvec" in res:
        for name, p_stats in zip(("Px ", "Py ", "Pz "), res["pvec"]):
            out.write(stats.format_phi_line(name, *p_stats))
    if "fe_colloid" in res:
        # ncolloid > 0, no area: the walls' header beside halo walls (ref:
        # stats_free_energy.c:103-124; ludwig_tpu ludwig.py:2429-2455)
        fsum, vol = (float(v) for v in res["fe_colloid"])
        if skip_fe and not sys_.is_electro:
            pass
        elif sys_.wallspec is not None:
            out.write("\nFree energies - timestep f v f/v f_s1 fs_s2 \n")
            out.write(f"[fe] {int(tstep):14d} {fsum:17.10e} {vol:17.10e} "
                      f"{fsum / vol:17.10e} {0.0:17.10e} {0.0:17.10e}\n")
        else:
            out.write("\nFree energies - timestep f v f/v f_s a f_s/a\n")
            out.write(f"[fe] {int(tstep):14d} {fsum:17.10e} {vol:17.10e} "
                      f"{fsum / vol:17.10e} {0.0:17.10e}\n")
    elif "fe_sum_v" in res:
        # walls present (ref: ludwig_tpu ludwig.py:2455-2460;
        # stats_free_energy.c:103-105)
        fsum, vol = (float(v) for v in res["fe_sum_v"])
        out.write("\nFree energies - timestep f v f/v f_s1 fs_s2 \n")
        out.write(f"[fe] {int(tstep):14d} {fsum:17.10e} {vol:17.10e} "
                  f"{fsum / vol:17.10e} {0.0:17.10e} {0.0:17.10e}\n")
    elif "fe_sum" in res and isinstance(sys_.two_field_cfg.fe, TernaryFE):
        # ref: fe_ternary_stats.c:80-100 (ludwig_tpu ludwig.py:2470-2490)
        fl = float(res["fe_sum"])
        out.write("\nFree energies\n")
        fr = fp = fs = 0.0
        if "tern_surf" in res:
            fr, fp, fs = (float(v) for v in res["tern_surf"])
            out.write(f"[rho/phi/psi]  {int(tstep):9d} {fr:17.10e} "
                      f"{fp:17.10e} {fs:17.10e}\n")
        fes = fr + fp + fs
        out.write(f"[surf/fl/tot]  {int(tstep):9d} {fes:17.10e} "
                  f"{fl:17.10e} {fl + fes:17.10e}\n")
    elif "fed" in res and not (skip_fe and (sys_.is_binary
                                            or sys_.is_binary_lb)):
        out.write(stats.format_fed_block(tstep, *res["fed"]))
    if "fe_lc_coll" in res and not skip_fe:
        # ncolloid > 0 (ref: fe_lc_stats.c:120-140; ludwig_tpu ludwig.py:
        # 2501-2520): the particles' surface term and area
        ftot, vol, fs, area = (float(v) for v in res["fe_lc_coll"])
        out.write("\nFree energies - timestep f v f/v f_s a f_s/a\n")
        row = f"[fe] {int(tstep):14d} {ftot:17.10e} {vol:17.10e} " \
              f"{ftot / vol:17.10e} {fs:17.10e}"
        if area > 0.0:
            row += f" {area:17.10e} {fs / area:17.10e}"
        out.write(row + "\n")
    elif "fe_lc" in res and not skip_fe:
        rs = float(res.get("redshift", sys_.lc_cfg.fe.redshift))
        if sys_.rt.int("_fed_block", 0):
            # the generic density block of the earliest LC logs (a hint;
            # ludwig_tpu ludwig.py:2534-2538)
            ftot, vol = (float(v) for v in res["fe_lc"][:2])
            out.write(stats.format_fed_block(tstep, ftot / vol, ftot / vol))
        elif sys_.lc_cfg.has_walls:
            # the walls' surface terms (ludwig_tpu ludwig.py:2539-2545)
            ftot, vol, fs1, fs2 = (float(v) for v in res["fe_lc"])
            out.write("\nFree energies - timestep f v f/v f_s1 fs_s2 "
                      "redshift\n")
            out.write(f"[fe] {int(tstep):14d} {ftot:17.10e} {vol:17.10e} "
                      f"{ftot / vol:17.10e} {fs1:17.10e} {fs2:17.10e} "
                      f"{rs:17.10e}\n")
        else:
            out.write(stats.format_fe_lc_block(tstep, *res["fe_lc"], rs))
    g = res["g"]
    if "gc" in res:
        # (ref: ludwig_tpu ludwig.py:2560-2578) total = fluid + colloids
        # (+ walls)
        gc, gw = res["gc"], res.get("gwall")
        gt = [g[a] + gc[a] + (gw[a] if gw is not None else 0.0)
              for a in range(3)]
        out.write(stats.format_momentum_block(gt, g, gw, gcolloid=gc))
    elif "gwall" in res:
        gw = res["gwall"]
        out.write(stats.format_momentum_block(
            [g[a] + gw[a] for a in range(3)], g, gw))
    else:
        out.write(stats.format_momentum_block(g, g))
    if with_velocity:
        out.write(stats.format_velocity_block(*res["umm"]))
        if "uflux" in res:
            fx = res["uflux"].tolist()
            out.write(f"[vol flux] {fx[0]:14.7e} {fx[1]:14.7e} "
                      f"{fx[2]:14.7e}\n")
    if "ktstats" in res and in_loop:
        # ref: collision.c:1103-1110 lb_collision_stats_kt
        gx, gy, gz = (float(v) for v in res["ktstats"])
        ndim = 2 if sys_.lb_cfg.nvel == 9 else 3
        kt = sys_.lb_cfg.noise.kt * ndim
        out.write("\nIsothermal fluctuations\n")
        out.write(f"[eqipart.] {gx:14.7e} {gy:14.7e} {gz:14.7e}\n")
        out.write(f"[measd/kT] {gx + gy + gz:14.7e} {kt:14.7e}\n")
    if in_loop:
        out.write(f"\nCompleted cycle {tstep}\n")
    out.flush()


def _sor_report(sor, multisteps: int, out, heterogeneous: bool = False,
                nsites: Optional[int] = None):
    """The three lines of the SOR solver's report (ref: psi_sor.c:263-292
    prints the 0-based iteration index); `heterogeneous` for the
    variable-permittivity solver of fe_electro_symmetric; with `nsites`
    the residual per site of the logs up to v0.7 (ludwig_tpu ludwig.py:
    3171-3176)."""
    n, rnorm, which = (v.item() for v in sor)
    kind = "absolute" if int(which) == 0 else "relative"
    name = "SOR (heterogeneous) solver" if heterogeneous else "SOR solver"
    out.write(f"\n{name} converged to {kind} tolerance\n")
    if nsites is not None:
        out.write(f"SOR residual per site  {float(rnorm) / nsites:14.7e} "
                  f"at {int(n)} iterations\n")
    else:
        out.write(f"SOR residual {float(rnorm):14.7e} at {int(n)} "
                  "iterations\n")
    out.write(f"{multisteps} multisteps\n")


def _field_names(sys_: System, nleaves: Optional[int] = None):
    """The checkpoint's names for the state's leaves, in order: dist,
    then phi (binary), phi and psi (two-field), q (liquid crystal), vel
    (binary, two-field, liquid crystal, droplet), then state<i> (the
    symmetric_lb, polar and fe_electro_symmetric leaves after dist
    among them; ludwig_tpu ludwig.py:2888-2901 and
    :2938-2950): the kept gradients of the unfused LC and sheared
    binary and LC routes are state03 and state04, as the JAX package
    writes them."""
    names = ["dist"]
    if sys_.binary_cfg is not None:
        names.append("phi")
    if sys_.two_field_cfg is not None:
        names += ["phi", "psi"]
    if sys_.lc_cfg is not None:
        names.append("q")
    if (sys_.binary_cfg is not None or sys_.lc_cfg is not None
            or sys_.droplet_cfg is not None
            or sys_.two_field_cfg is not None):
        names.append("vel")
    return [names[i] if i < len(names) else f"state{i:02d}"
            for i in range(len(sys_.state) if nleaves is None else nleaves)]


def _state_leaves(state) -> list:
    """The leaves of a state in the JAX package's pytree order: a
    ColloidState's seven arrays, the KISS state where there is noise,
    gwall where there are walls, then the map (pid, inside) it carries
    after a step."""
    if not isinstance(state, ColloidState):
        return list(state)
    leaves = list(state[:7])
    leaves += [x for x in (state.noise, state.gwall) if x is not None]
    return leaves + list(state.pmap or ())


def _leaf_to_host(x: torch.Tensor) -> np.ndarray:
    """A state leaf as the JAX package writes it: the KISS state, whose
    32-bit words the port keeps in int64, as uint32."""
    a = x.detach().cpu().numpy()
    return a.astype(np.uint32) if x.dtype == torch.int64 else a


def write_checkpoint(sys_: System, directory: str, step: int,
                     extra=()) -> None:
    """Every leaf of the state, then the leaves `extra` (the gradients a
    fused route adds, _grad_leaves), as <name>-<step> with its JSON
    sidecar, the unpadded (nvel, X, Y, Z) layout on every route (the JAX
    package's fused routes write their padded state)."""
    leaves = _state_leaves(sys_.state) + list(extra)
    names = _field_names(sys_, len(leaves))
    write_state(directory, step, {
        name: _leaf_to_host(x) for name, x in zip(names, leaves)})


def read_checkpoint(sys_: System, directory: str, step: int) -> tuple:
    """The state written by write_checkpoint (or by the JAX package's
    unfused route) at `step`, on the state's device and in its dtypes."""
    state = _state_leaves(sys_.state)
    names = _field_names(sys_, len(state))
    data = read_state(directory, step, names)
    leaves = []
    for name, x in zip(names, state):
        a = data[name]
        if tuple(a.shape) != tuple(x.shape):
            raise ValueError(
                f"checkpoint {name}-{step:08d} has shape {a.shape}, the "
                f"state {tuple(x.shape)} (a padded fused state of the JAX "
                "package? convert.checkpoint_from_jax unpads it)")
        if x.dtype == torch.int64:
            a = a.astype(np.int64)
        leaves.append(torch.as_tensor(a, dtype=x.dtype, device=x.device))
    if isinstance(sys_.state, ColloidState):
        # the map is rebuilt from Rmap (the step's prepare)
        rest = iter(leaves[7:])
        return ColloidState(
            *leaves[:7],
            noise=next(rest) if sys_.state.noise is not None else None,
            gwall=next(rest) if sys_.state.gwall is not None else None)
    return tuple(leaves)


def write_colloid_config(sys_: System, directory: str, step: int) -> None:
    """config.cds%08d.001-001 in the reference's ASCII format (ludwig_tpu
    ludwig.py:2901-2937; ref: colloid_io.c colloid_io_write)."""
    cp = sys_.colloid_params
    R, V = (sys_.state[i].detach().cpu().numpy() for i in (1, 2))
    if sys_.subgrid:
        W = dr = np.zeros_like(R)
        M = np.asarray(cp.m, np.float64).reshape(-1, 3)
    else:
        W, dr, M = (sys_.state[i].detach().cpu().numpy() for i in (3, 4, 6))
    if sys_.colloid_charge is not None:
        qq = sys_.colloid_charge.detach().cpu().numpy()
        dq = sys_.state[10].detach().cpu().numpy()
    recs = []
    for n in range(cp.n):
        rec = default_state()
        rec["index"] = n + 1
        rec["a0"], rec["ah"] = cp.a0[n], cp.ah[n]
        rec["r"] = [float(c) + 1.0 for c in R[n]]
        rec["v"] = [float(c) for c in V[n]]
        rec["w"] = [float(c) for c in W[n]]
        rec["dr"] = [float(c) for c in dr[n]]
        rec["m"] = [float(c) for c in M[n]]
        rec["b1"], rec["b2"] = cp.b1[n], cp.b2[n]
        rec["type"] = TYPES.get(cp.types[n], 0) if cp.types else 0
        if sys_.colloid_charge is not None:
            # the electrolyte's particles (ludwig_tpu ludwig.py:2927-2932)
            rec["q0"], rec["q1"] = (float(v) for v in qq[n])
            rec["deltaq0"], rec["deltaq1"] = (float(v) for v in dq[n])
        recs.append(rec)
    os.makedirs(directory, exist_ok=True)
    write_colloid_file(os.path.join(directory,
                                    f"config.cds{step:08d}.001-001"), recs)


def _rheo_pth(sys_: System) -> Optional[torch.Tensor]:
    """The thermodynamic stress of the shear profile: the binary fluid's,
    from plain-stencil gradients of the current phi (ref:
    fe->func->stress in stats_rheology_stress_profile_accumulate;
    ludwig_tpu ludwig.py:2822-2828); None (zeros) for the other families,
    as the JAX package reports them (and for the binary fluid beside
    colloids)."""
    bcfg = sys_.binary_cfg
    if bcfg is None or sys_.is_colloid:
        return None
    ops = (binary_solid_ops(bcfg, solid=sys_.solid, wallspec=sys_.wallspec)
           if isinstance(sys_.fe_ops, OpenXScalarOps) else sys_.fe_ops)
    return bcfg.fe.stress(fe_fields(sys_.state[1], bcfg.gradient,
                                    solid_ops=ops))


def run_text(text: str, out=sys.stdout, device="cuda") -> System:
    """Run a simulation from input-file text on `device`; returns the
    final System.

    Checkpoints (freq_config, config_at_end) write the state into
    io_directory and N_start reads it back, the loop continuing at
    N_start + 1; freq_phi, freq_vel and freq_psi write reference-format
    field files (ludwig_tpu ludwig.py:2787-2967, 3176-3230)."""
    rt = RunTime(text)
    t0 = time.time()
    sys_ = build_system(rt, device)
    sys_.hydro_on = rt.switch("hydrodynamics", True)
    sys_.vol_flux = rt.string("stats_vel_print_vol_flux", "no") == "yes"
    rt.switch("tpu_shard", False)       # refused when on (INACTIVE)
    size = sys_.lb_cfg.size
    # the input header (fulllog.py), written after the set-up below has
    # read its keys and registered the calibrations' banners
    initlog = InitLog(rt, sys_, out)
    ncycles = rt.int("N_cycles", 0)
    freq = rt.int("freq_statistics", max(ncycles, 1))
    stats_fn = _make_stats_fn(sys_, reference_statistics(sys_))
    # the SOR convergence report (ludwig_tpu ludwig.py:3157-3176)
    sor_freq = (rt.int("freq_psi_resid", freq) if sys_.is_electro
                and sys_.electro_cfg.ek.solver != "fft" else 0)

    # checkpoint / restart (ref: ludwig.c:310-369, 868-916) and the
    # reference-format field files (ref: ludwig.c is_phi_output_step /
    # is_vel_output_step; io_impl_mpio.c records)
    iodir = rt.string("io_directory", ".")
    freq_config = rt.int("freq_config", 0)
    config_at_end = rt.switch("config_at_end", False)
    freq_colloid_io = rt.int("colloid_io_freq", 0)
    sys_.n_start = rt.int("N_start", 0)
    freq_phi = rt.int("freq_phi", 0)
    freq_vel = rt.int("freq_vel", 0)
    freq_psi = rt.int("freq_psi", 0) if sys_.is_electro else 0
    periodic = tuple(rt.int_vector("periodicity", (1, 1, 1)))
    le_meta = (None if sys_.le_cfg is None
               else (sys_.le_cfg.nplanes, sys_.le_cfg.uy))
    has_phi = (sys_.binary_cfg is not None or sys_.droplet_cfg is not None
               or sys_.two_field_cfg is not None or sys_.lb2_cfg is not None)
    # psi, then rho: after f, after phi, or after the particles' leaves
    psi_at = (7 if sys_.is_colloid else 2 if sys_.es_cfg is not None
              else 1)
    # the order parameter's leaf: after f, or after the particles' leaves
    op_at = 7 if sys_.is_colloid else 1
    # the shear observables (ludwig_tpu ludwig.py:2803-2830)
    freq_shear_meas = rt.int("freq_shear_measurement", 0)
    freq_shear_io = rt.int("freq_shear_output", 0)
    rheo = (RheologyAccumulator(size, sys_.lb_cfg.device)
            if freq_shear_meas or freq_shear_io else None)
    # the measurements (ludwig_tpu ludwig.py:2803, 2830-2845): the
    # colloids' output and, for the binary fluid, the surface-tension
    # calibration of a drop that replaces the initial phi
    freq_measure = rt.int("freq_measure", 0)
    sigma_cal = None
    if (rt.switch("calibration_sigma", False)
            and sys_.binary_cfg is not None and not sys_.is_colloid):
        bcfg = sys_.binary_cfg
        sigma_cal = SigmaCalibration(bcfg.fe, size, bcfg.mobility)
        phi0 = torch.as_tensor(sigma_cal.init_phi(np.float64),
                               dtype=sys_.state[1].dtype,
                               device=sys_.state[1].device)
        sys_.state = (sys_.state[0], phi0) + tuple(sys_.state[2:])
        initlog.sigma_cal = sigma_cal
    has_q = sys_.lc_cfg is not None or sys_.droplet_cfg is not None
    tend = sys_.n_start + ncycles
    cfg_style = rt.string("_cfg_end_style", "inloop")

    # the I/O grid (ref: io_info_args_rt.c:55-57, "<name>_io_grid"
    # overriding "default_io_grid"): other than 1_1_1 writes the field as
    # a subfile set (io/sharded.py), each file with its metadata
    io_grid_default = tuple(rt.int_vector("default_io_grid", (1, 1, 1)))

    def write_field(name, step, arr):
        grid = tuple(rt.int_vector(f"{name}_io_grid", io_grid_default))
        if grid != (1, 1, 1):
            write_sharded(iodir, name, step, arr, grid=grid,
                          periodic=periodic, le=le_meta)
        else:
            write_ref_field(iodir, name, step, arr, periodic=periodic,
                            le=le_meta)

    if sys_.n_start > 0:
        sys_.state = read_checkpoint(sys_, iodir, sys_.n_start)
        # diagnostic only: no reference vintage prints a restart line
        print(f"Restart from step {sys_.n_start}", file=sys.stderr)

    # the hydrodynamic-radius calibration of one particle (ludwig_tpu
    # ludwig.py:3076-3100; ref: stats_calibration.c); the header writes
    # its banner
    ahydro = None
    cp = sys_.colloid_params
    if rt.switch("calibration", False) and cp is not None and cp.n == 1:
        ahydro = AhydroCalibration(max(cp.ah), cp.a0[0], sys_.lb_cfg.eta_shear,
                                   sys_.lb_cfg.rho0, cp.rho0, size,
                                   cp.gravity)
        initlog.ahydro = ahydro
    initlog.emit()      # ends with "Initial conditions."
    u = torch.zeros((3,) + size, dtype=sys_.lb_cfg.tdtype,
                    device=sys_.lb_cfg.device)
    report_statistics(sys_, sys_.n_start, u, stats_fn, with_velocity=False,
                      out=out, in_loop=False)
    out.write("\nStarting time step loop.\n")
    t_init = time.time() - t0
    sect = {key: [0.0, float("inf"), 0.0, 0]
            for key in ("step", "stats", "cfgio", "fldio")}

    def _acc(key, dt_):
        s = sect[key]
        s[0] += dt_
        s[1] = min(s[1], dt_)
        s[2] = max(s[2], dt_)
        s[3] += 1

    for t in range(sys_.n_start + 1, tend + 1):
        ts0 = time.time()
        vel_out = bool(freq_vel) and t % freq_vel == 0
        # the steps return new tensors and never write their inputs, so
        # the pre-step order parameters of the [fed] / [fe] statistic
        # (phi, Q, or the droplet's pair) are held by reference
        prev = None
        res = None
        nfld = sys_.n_fields
        # config_at_end writes at the last step in the loop, or after
        # it in the style of a log's era (the _cfg_end_style hint;
        # ludwig_tpu ludwig.py:3180-3185, 3452-3472)
        end_config = config_at_end and t == tend
        is_config = ((freq_config and t % freq_config == 0)
                     or (end_config and cfg_style == "inloop"))
        # the pre-update field's gradients a fused route's checkpoint
        # carries where the JAX package's route keeps them
        extra = (sys_.grad_leaves(sys_.state[1], t)
                 if (is_config or end_config)
                 and sys_.grad_leaves is not None else ())
        if end_config:
            end_extra = extra
        if sys_.is_colloid:
            # the velocities before the step feed the particle block
            prev = (sys_.state[2],)
            sys_.state, aux = sys_.step_fn(sys_.state, t)
            u = aux[1]
            if sys_.is_electro:
                sor = aux[2]     # the electrolyte's SOR report
            if ahydro is not None and ahydro.wants(t):
                # the particle's velocity less the fluid sites' mean
                # (ref: stats_ahydro_measure)
                fl = _colloid_fluid(sys_, sys_.state[1])
                um = (torch.where(fl[None], u, 0.0).sum(dim=(1, 2, 3))
                      / fl.sum().to(u.dtype))
                ahydro.accumulate(sys_.state[2][0].tolist(),
                                  prev[0][0].tolist(),
                                  (sys_.state[2][0] - um).tolist())
        elif nfld:
            prev = sys_.state[1:1 + nfld]
            if sys_.fused_mode in ("binary", "lc", "droplet"):
                sys_.state = sys_.step_fn(sys_.state, t)
            else:
                sys_.state, _rho = sys_.step_fn(sys_.state, t)
            u = sys_.state[1 + nfld]    # u follows the order parameters
        elif sys_.is_electro:
            if sys_.es_cfg is not None:
                prev = sys_.state[1:2]      # the pre-step phi
            sys_.state, (_none, sor) = sys_.step_fn(sys_.state, t)
            u = sys_.state[psi_at + 2]
        elif sys_.fused_mode == "plain":
            sys_.state = (sys_.step_fn(sys_.state[0], t),)
            u = None      # derived from f at statistics steps
        elif sys_.fused_mode in ("wall", "le"):
            # the logged u is the collision-time velocity of THIS step,
            # (g + F/2)/rho of the PRE-step state, on the steps that read
            # it (ludwig_tpu ludwig.py:3386-3392)
            u = (_fused_u(sys_, sys_.state[0], +1.0)
                 if t % freq == 0 or vel_out else None)
            sys_.state = sys_.step_fn(sys_.state, t)
        elif sys_.has_kiss or sys_.wallspec is not None:
            # the KISS state or the walls' momentum rides with f
            # (ludwig_tpu ludwig.py:3395-3447)
            sys_.state, _rho, u = sys_.step_fn(sys_.state, t)
        else:
            f, _rho, u = sys_.step_fn(sys_.state[0], t)
            sys_.state = (f,)
        _acc("step", time.time() - ts0)
        if sys_.is_colloid and t % freq == 0:
            # the particle block comes first, before the I/O lines
            # (ludwig_tpu ludwig.py:3142-3156)
            ts0 = time.time()
            res = stats_fn(sys_.state, u, prev, t)
            report_particle_block(sys_, res, out=out)
            _acc("stats", time.time() - ts0)
        if sor_freq and t % sor_freq == 0:
            _sor_report(sor, sys_.electro_cfg.ek.multisteps, out,
                        heterogeneous=(sys_.es_cfg is not None
                                       and sys_.es_cfg.fe.gamma != 0.0),
                        nsites=(int(np.prod(size))
                                if rt.int("_log_vintage", 99) <= 7
                                else None))
        # configuration dumps and the output lines come BEFORE the
        # statistics block of the same step (ref: ludwig.c:866-948)
        if is_config:
            ts0 = time.time()
            out.write(f"Writing distribution output at step {t}!\n")
            write_checkpoint(sys_, iodir, t, extra)
            _acc("cfgio", time.time() - ts0)
        if sys_.is_colloid and (
                is_config or (freq_colloid_io and t % freq_colloid_io == 0)
                or (freq_measure and t % freq_measure == 0)):
            # (ludwig_tpu ludwig.py:3186-3204; ref: ludwig.c:875-884)
            ts0 = time.time()
            out.write(f"Writing colloid output at step {t}!\n")
            out.write("\ncolloid_io_write:\n")
            out.write(f"writing colloid information to "
                      f"config.cds{t:08d}.001-001 etc\n")
            write_colloid_config(sys_, iodir, t)
            _acc("cfgio", time.time() - ts0)
        if (freq_phi and t % freq_phi == 0) or is_config:
            if has_phi:
                out.write(f"Writing phi file at step {t}!\n")
            if has_q:
                out.write(f"Writing q file at step {t}!\n")
        if sys_.is_electro and ((freq_psi and t % freq_psi == 0)
                                or is_config):
            out.write(f"Writing psi file at step {t}!\n")
        if sys_.hydro_on and (vel_out or is_config):
            out.write(f"Writing rho/velocity output at step {t}!\n")
        if sigma_cal is not None and freq_measure and t % freq_measure == 0:
            # (ref: ludwig.c:920-923 stats_sigma_measure)
            radius, xifit, sig = sigma_cal.measure(
                sys_.state[1], _binary_fields(sys_, sys_.state[1]))
            out.write("\nSurface tension calibration - radius xi0 "
                      "surface tension\n")
            out.write(f"[sigma] {t:14d} {radius:14.7e} {xifit:14.7e} "
                      f"{sig:14.7e}\n")
        if freq_shear_meas and t % freq_shear_meas == 0:
            # (ref: ludwig.c:925-929, stats_rheology accumulate)
            rheo.accumulate(sys_.state[0], sys_.lb_cfg.model,
                            _rheo_pth(sys_))
        if freq_shear_io and t % freq_shear_io == 0:
            # (ref: ludwig.c:931-935, str-%8.8d.dat, then zero)
            rheo.write_section(os.path.join(iodir, f"str-{t:08d}.dat"),
                               sys_.lb_cfg.eta_shear)
            rheo.zero()
        if u is None and (t % freq == 0 or vel_out):
            u = _fused_u(sys_, sys_.state[0])
        if t % freq == 0:
            ts0 = time.time()
            report_statistics(sys_, t, u, stats_fn, out=out,
                              with_velocity=sys_.hydro_on, prev=prev,
                              res=res)
            _acc("stats", time.time() - ts0)
        if freq_phi or freq_vel or freq_psi:
            ts0 = time.time()
            if freq_phi and t % freq_phi == 0:
                # the liquid crystal writes q; the binary fluid and the
                # droplet write phi (ludwig_tpu ludwig.py:2866-2880)
                # (the JAX package writes the particles' R leaf as the
                # symmetric_lb colloids' phi, and as psi beside charged
                # particles: the port writes the fields)
                if sys_.lc_cfg is not None:
                    write_field("q", t, sys_.state[op_at])
                elif sys_.lb2_cfg is not None:
                    write_field("phi", t, g_moments(sys_.state[op_at],
                                                    sys_.lb_cfg.model)[0])
                elif has_phi:
                    write_field("phi", t, sys_.state[op_at])
            if vel_out:
                write_field("vel", t, u)
            if freq_psi and t % freq_psi == 0:
                write_field("psi", t, sys_.state[psi_at])
                write_field("rho", t, sys_.state[psi_at + 1])
            _acc("fldio", time.time() - ts0)

    if config_at_end and ncycles > 0 and cfg_style != "inloop":
        if cfg_style == "after":
            if has_phi:
                out.write(f"Writing phi file at step {tend}!\n")
            if has_q:
                out.write(f"Writing q file at step {tend}!\n")
            if sys_.is_electro:
                out.write(f"Writing psi file at step {tend}!\n")
            if sys_.hydro_on:
                out.write(f"Writing rho/velocity output at step {tend}!\n")
        write_checkpoint(sys_, iodir, tend, end_extra)

    if ahydro is not None:
        ahydro.report(out)

    # timer table (ref: TIMER_statistics table shape); host clocks, the
    # device work of a step lands in the next section that synchronises
    total = time.time() - t0
    per_step = (total - t_init) / max(ncycles, 1)
    out.write("\nTimer resolution: 1e-09 second\n")
    out.write("\nTimer statistics\n")
    out.write("             Section:       tmin       tmax      total\n")
    out.write(f"               Total: {total:10.3f} {total:10.3f} "
              f"{total:10.3f} {total:10.6f} (1 call)\n")
    out.write(f"      Initialisation: {t_init:10.3f} {t_init:10.3f} "
              f"{t_init:10.3f} {t_init:10.6f} (1 call)\n")
    out.write(f"      Time step loop: {per_step:10.3f} {per_step:10.3f} "
              f"{total - t_init:10.3f} {per_step:10.6f} "
              f"({max(ncycles, 1)} calls)\n")
    for key, label in (("step", "Step dispatch"), ("stats", "Statistics"),
                       ("cfgio", "Configuration IO"),
                       ("fldio", "Field output")):
        tot, tmin, tmax, ncall = sect[key]
        if ncall:
            out.write(f"{label:>20s}: {tmin:10.3f} {tmax:10.3f} "
                      f"{tot:10.3f} {tot / ncall:10.6f} ({ncall} calls)\n")
    if rt.switch("tpu_timer_detail", False) and ncycles > 0:
        # the phases of a step, each launched alone on the final state
        # (ludwig_tpu ludwig.py:3500-3508)
        for name, dt_ in timer_detail(sys_):
            out.write(f"{name:>20s}: {dt_:10.3f} {dt_:10.3f} "
                      f"{dt_:10.3f} {dt_:10.6f} (probe)\n")
    initlog.tail()      # the unused keys, "Ludwig finished normally."
    out.flush()
    return sys_


def _binary_fields(sys_: System, phi: torch.Tensor) -> dict:
    """phi and its gradients for the host-side free-energy measurements
    (ludwig_tpu ludwig.py:2814-2820), on the step's stencils."""
    bcfg = sys_.binary_cfg
    ops = (binary_solid_ops(bcfg, solid=sys_.solid, wallspec=sys_.wallspec)
           if isinstance(sys_.fe_ops, OpenXScalarOps) else sys_.fe_ops)
    return fe_fields(phi, bcfg.gradient, bcfg.fourth_order, ops)


def _takes_f(sys_: System) -> bool:
    """The step takes and returns f alone: the fused plain step, and the
    periodic plain fluid's unfused one ((f, rho, u))."""
    return sys_.fused_mode == "plain" or (
        sys_.fused_mode is None and not sys_.is_colloid
        and not sys_.n_fields and not sys_.is_electro and not sys_.has_kiss
        and sys_.wallspec is None)


def _probe_seconds(fn, device: torch.device, reps: int = 3) -> float:
    """The least time of reps calls of fn after a warm-up call: CUDA
    events on a GPU, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, 1e-3 * start.elapsed_time(end))
        else:
            ts0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - ts0)
    return best


def timer_detail(sys_: System, reps: int = 3) -> list:
    """[(row, seconds a call)]: the phases of the step of each route,
    each launched alone on the current state (ludwig_tpu ludwig.py:
    3513-3618, the same rows): the fused plain, wall and Lees-Edwards
    routes' kernel ("Collide+stream"), the binary and droplet K1
    ("Phi+force kernel", "Phi+Q+force kernel"), the electrolyte's SOR
    solve ("Poisson (SOR)"), the colloid map ("Colloid map build"), and
    the whole step ("Full step").  The port keeps no padded state, so the
    JAX package's "Pad refresh" row has no counterpart."""
    st = sys_.state
    dev = torch.device(sys_.lb_cfg.device)
    model = sys_.lb_cfg.model
    params = sys_.lb_cfg.collision_params()
    rows = []

    def probe(name, fn):
        rows.append((name, _probe_seconds(fn, dev, reps)))

    def full_step():
        return sys_.step_fn(st[0] if _takes_f(sys_) else st, 1)

    if sys_.fused_mode in ("plain", "wall", "le"):
        probe("Collide+stream", lambda: fused_step(st[0], model, params))
        return rows
    if sys_.fused_mode == "binary":
        bcfg = sys_.binary_cfg
        probe("Phi+force kernel", lambda: binary_phi_force_step(
            st[1], st[2], bcfg.fe, bcfg.mobility, bcfg.advection_order))
    elif sys_.fused_mode == "droplet":
        dcfg = sys_.droplet_cfg
        probe("Phi+Q+force kernel", lambda: droplet_phi_q_force_step(
            st[1], st[2], st[3], dcfg.fe, dcfg.gamma, dcfg.mobility,
            dcfg.advection_order))
    elif sys_.fused_mode is None and sys_.is_electro and not sys_.is_colloid:
        ek = sys_.electro_cfg.ek
        off = 1 if sys_.es_cfg is not None else 0
        psi, rhok = st[1 + off], st[2 + off]
        up, dn = electro_sim.make_psi_neighbours(
            sys_.lb_cfg.size, sys_.electro_cfg.e0, sys_.lb_cfg.dtype,
            sys_.lb_cfg.device)
        probe("Poisson (SOR)", lambda: electro_sim.poisson_sor_ref(
            psi, rho_elec(rhok, ek), ek, up, dn))
    elif sys_.is_colloid and not sys_.subgrid:
        probe("Colloid map build", lambda: _colloid_map(sys_, st[1]))
    probe("Full step", full_step)
    return rows


def run(path: str = "input", out=sys.stdout, device="cuda") -> System:
    with open(path) as fh:
        return run_text(fh.read(), out=out, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m ludwig_tpu_torch",
        description="Run a lattice Boltzmann input file (plain fluid, "
                    "with or without colloids, symmetric binary fluid, "
                    "blue-phase liquid crystal, liquid-crystal droplet, "
                    "electrokinetics, or the Brazovskii, surfactant, "
                    "ternary, symmetric_lb, polar active and "
                    "electro-symmetric free energies).")
    ap.add_argument("input", nargs="?", default="input",
                    help="input file (default: ./input)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the CUDA kernels, cpu "
                         "their plain twins (default: cuda)")
    args = ap.parse_args(argv)
    run(args.input, device=args.device)
