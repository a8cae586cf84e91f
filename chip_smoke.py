#!/usr/bin/env python
"""Smoke run of ludwig_tpu_torch on one NVIDIA GPU: build, check, run, time.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. the card (nvidia-smi name and power limit) and the CUDA version;
  2. build the CUDA kernels from ludwig_tpu_torch/csrc into the package's
     git-ignored build directory; print what ptxas reports of the n-step,
     SOR, binary, LC, droplet and electrokinetic (SOR and NP) kernels;
  3. each kernel against its plain PyTorch twin on the card, 3 chained
     steps, over velocity sets, relaxation schemes, both back-transform
     forms and both dtypes;
  4. the n-step kernel (the x-march) bitwise against n single-step
     launches, n in 1..8, both back-transform forms, f32 and f64, on the
     default plan and a ragged one, then at 256^3 f32 for the bench's
     rungs n = 6, 4, 3, 2; each case prints the route and tile the
     launcher took, and n = 2 and 3 at 256^3 must run in shared memory;
  5. the main path at full width: D3Q19 256^3 f32 (the flagship
     configuration of bench.py) for 40 cycles through run_text on the
     card, plus the bench's n-step loop (n=6, absolute form) through
     make_fusedn_nstep; the kernel launch counts of this phase show the
     path used the kernels;
  6. at 256^3: each kernel against its twin within TOL, and kernel, twin
     and device-copy times (ms/step and MLUPS), fusedn_step for n = 1..8
     in both forms beside fused_step, and n = 2 and 3 on each plan of
     TILE_PLANS, five passes (the default has the least median sum);
  7. the binary fluid's kernels against their twins: binary_phi_force_step
     (K1, the x-march of csrc/k1_march.cuh) at K1_SHAPES, advection
     orders 1 and 2, f32 and f64, phi' - phi to one ulp of the value and
     the force within TOL, each case's layout printed and its blocks an
     SM held to the card's occupancy count, at the ragged shape each plan
     of BINARY_K1_PLANS bitwise the default layout; fused_force_step (K2)
     over velocity sets and relaxation schemes with random force fields;
     3 chained fused binary steps through the kernels against 3 through
     the twins;
  8. the binary main path at full width: `free_energy symmetric` D3Q19
     256^3 f32, spinodal, advection order 2, `tpu_fused on`, through
     run_text on the card; K1 and K2 launched once per cycle, the [phi]
     total conserved, the [rho] totals at the site count;
  9. at 256^3 f32: K1, K2 and the whole binary step against the twins
     within TOL, and kernel, twin and bound times; K1 beside its issue
     floor and the thread-per-site kernel's time (BINARY_K1_THREAD_MS),
     its plans held bitwise to the default and timed (BINARY_K1_PLANS);
 10. the liquid crystal's kernel lc_q_force_step (K1, the x-march of
     csrc/k1_march.cuh) against its twin at K1_SHAPES (two of them
     shorter than the halo or ragged against the tile), f32 and f64, with
     and without the active stress and a redshift, each case's layout
     printed and its blocks an SM held to the card's occupancy count; at
     the ragged shape each plan of K1_PLANS bitwise the default layout;
     then 3 chained fused LC steps (K1 + K2) through the kernels against
     3 through the twins;
 11. the liquid-crystal main path at full width: `free_energy
     lc_blue_phase` D3Q19 f32 with the reference's benchmark parameters,
     `tpu_fused on`, through run_text on the card at 256^3 and at 128^3;
     K1 and K2 launched once per cycle; before that the same input at
     16x16x32 in f64 on the card against the CPU twins' log;
 12. at 128^3 and 256^3 f32: K1, K2 and the whole LC step, kernel, twin
     and bound times; K1 beside its issue floor (generated operations a
     site on its layout over the f32 issue rate without FMA) and the box
     kernel's time (the design the march replaced), the SM clock under load, and each plan of K1_PLANS held
     bitwise to the default and timed;
 13. the LC droplet's kernel droplet_phi_q_force_step (K1, the x-march)
     against its twin at K1_SHAPES, f32 and f64, advection orders 1 and
     2, anchoring W = 0 and 0.02, the increments phi' - phi and q' - q to
     one ulp of the value, layouts printed and held as in phase 10, the
     plans of K1_PLANS bitwise the default at the ragged shape; then 3
     chained fused droplet steps (K1, the mean subtraction, K2) through
     the kernels against 3 through the twins;
 14. the droplet main path at full width: `free_energy lc_droplet` D3Q19
     128^3 f32 (the reference benchmark's size) with the JAX package's
     droplet test parameters, `tpu_fused on`, through run_text on the
     card; K1 and K2 launched once per cycle, the [phi] total conserved;
     before that the same input at 16x16x32 in f64 on the card against
     the CPU twins' log;
 15. at 128^3 and 256^3 f32: K1, K2, the mean subtraction and the whole
     droplet step, kernel, twin and bound times; K1 (order 1) against its
     issue floor and the box kernel's time and its plan sweep as in
     phase 12, and
     order 2 on the default layout;
 16. the electrokinetic kernels against their twins at (16, 16, 128), an
     odd-X (15, 16, 32), 64^3 and 128^3, f32 and f64: sor_solve on the
     route it picks and on every route the shape admits (on-chip,
     in-place, two-buffer; f64 the same stop and criterion, psi within
     1e-12; f32 within 15 iterations and 2e-5), np_gradmu with and
     without advection (rho' and the force within 2 ulp, fsum within
     1e-12 / 1e-6 of sum |force|; the x-march at NP_SHAPES, 16x4x4
     included, with 1, 2 and 3 species, each layout printed and held to
     the card's occupancy count), the solid fused_force_step (f64
     bitwise, f32 within TOL, u on fluid sites); then 3 chained
     electrokinetic steps through the kernels against 3 through the
     twins;
 17. the electrokinetic main path at full width: `free_energy fe_electro`
     Gouy-Chapman D3Q19 128^3 f32 (the JAX package's perf_bench.py
     electro bench) through run_text on the card, 20 cycles; one launch
     of each kernel a cycle, each species' total conserved, [elc] ~ 0,
     the SOR iteration counts; before that a 16x8x8 f64 input (the
     reference route) on the card against the CPU's log;
 18. at 128^3 and 256^3 f32: sor_solve on each route the shape admits
     (a solve, an iteration, the count; and from solves of a random
     field held to 11 and 41 iterations, the fixed cost and the cost an
     iteration, also at 48^3 and 64^3), np_gradmu (beside the
     thread-per-site kernel's time, NP_THREAD_MS, and each plan of
     NP_PLANS held bitwise to the default and timed), the mean
     subtraction, the solid K2, the whole step and its MLUPS, the FFT
     route's solve for context; twin and bound times;
 19. the fluctuating kernel fused_step with FusedNoise against its twin,
     3 chained steps at step counters whose hash products wrap, over
     velocity sets, M10 and TRT, both back-transform forms and both
     dtypes; the reference-statistics scans (csrc/stats_ref.cu) bitwise
     against their CPU twins at 16x16x32 and 64^3, with and without a
     fluid mask;
 20. the fluctuating main path: a 16x16x32 f64 noise input on the card
     against the CPU's log under `tpu_fused interpret` (the noise kernel,
     as the JAX package runs its fused kernel in f64 only in interpret
     mode; plain statistics, held to rtol 1e-9), and under `on` and `off`
     (the KISS route both, as in the JAX package: torch on the card plus
     the statistics scans, whose lines must be identical as text); then
     D3Q19 256^3 f32 with isothermal
     fluctuations (bench.py's flagship plus the noise keys of
     tests/test_ludwig_run.py:423-435), `tpu_fused on`, 40 cycles through
     run_text: 40 launches of the noise kernel, [rho] at the site count,
     the kT block finite;
 21. at 256^3 f32: the noise kernel against the noiseless one, with its
     bound and twin; the KISS route's step; one reference-statistics
     block at 128^3 and 256^3; each scan kernel against its CPU twin's
     time at 128^3 (the electrokinetic main path's size);
 22. the plain fluid's boundaries on the card against the CPU, 3 chained
     steps from a random 16x16x64 state, f64 and f32 (TOL; the walls'
     momentum at TOL's rtol of its terms' summed size): the fused wall
     step (walls 1_0_0, 0_1_0 moving, 1_1_0), the unfused wall step with
     slip and with the open boundary, the fused and unfused Lees-Edwards
     steps with 2 and X/2 planes (f32 at t near 10^6), the porous step
     (a simple cubic crystal); fused_step launched by each fused step;
 23. the JAX package's wall, Couette, duct and Lees-Edwards inputs and a
     porous one in f64 through run_text on the card against the CPU's
     log, `tpu_fused on` and `off` (rtol 1e-9, atol 1e-11, the [walls]
     row included; fused_step once a cycle on the fused wall and LE
     routes); then a checkpoint, a restart and velocity files on the
     card: the restarted log is the straight log, the files read back;
 24. at 256^3 f32 (the main path's lattice, walls 0_1_0 moving at 0.01;
     4 Lees-Edwards planes at 0.01): fused_step, the fused wall and LE
     steps and their post-passes alone, in turns, with the post-passes'
     CUDA kernels a call (torch.profiler), and the JAX design's plane
     collide for comparison; then 40 cycles of each through run_text;
 25. the Lees-Edwards planes of the binary, blue-phase and droplet
     families on the card against the CPU, at 16x8x16 and a ragged
     18x10x12 with 2 planes, f64 and f32 (TOL), t = 7..9: each column
     fix, 3 fused sheared steps (K1, the fix, K2, the LE pass; K1 and K2
     launched 3 times each) and 3 unfused ones; the three sheared inputs
     in f64 through run_text, `tpu_fused on` and `off`, the card's
     statistics against the CPU's (rtol 1e-9, atol 1e-11); the unfused
     sheared blue phase's checkpoint (its gradient leaves state03,
     state04), a restart that prints the straight log as text, and
     str-*.dat;
 26. at 128^3 and 256^3 f32, the sheared blue phase as perf_bench.py:
     208-245 builds it (4 planes at 0.05): K1, K2, the column fix, the LE
     pass and the whole step in turns (CUDA events), the fix's and the
     step's CUDA kernels a call and their device time (torch.profiler);
     then 20 cycles through run_text of it at 128^3 and 256^3, of the
     binary cell with 4 planes at 0.01 (256^3) and of the droplet cell
     with 4 planes (128^3), K1 and K2 launched once a cycle;
 27. resolved colloids on the card against the CPU at 16^3, 4 steps of
     each route (COLLOID_ROUTES: the reference-order route in f64 and f32,
     with squirmers and walls, and the f64 exact route of 6 particles,
     whose chains run as chain_sums; the f32 segment-sum route, passive,
     squirmers, walls; COLLOID_TOL), the maps identical; the colloid inputs
     (two particles with soft spheres, random placement between walls,
     the 30 subgrid particles of config.cds.init.001-001) in f64 through
     run_text on both (rtol 1e-9, atol 1e-11, the lines equal as text
     but the floats); a colloid restart on the card that prints the
     straight log as text;
 28. the 64^3 N=1000 suspensions of perf_bench.py (passive and squirmers,
     f32, RandomState(3)): ms a step on rebuild and other steps (CUDA
     events), CUDA kernels a step and their device time (torch.profiler),
     a rebuild step and another from one state on the card against the
     CPU (COLLOID_TOL, the maps identical), a step of each kind under
     CUDA's sync debug mode "error" (no host synchronisation), also the
     CLI's step with its per-step force terms (SYNC_FORCE_KEYS), 20
     cycles of each through run_text; then chain_sums against its CPU
     twin at the f64 route's largest call;
 29. the binary fluid's boundary and option routes (BINARY_ROUTES: halo
     walls with the 27-point wetting stencil and the 7-point one, porous
     media with per-site wetting, the phi-grad-mu force with grad_mu,
     Arrhenius viscosity with order-3 advection, `hydrodynamics off`, the
     KISS phi and rho noise alone and beside walls, the open x boundary,
     Lees-Edwards planes with 27-point gradients and the LB's noise) on
     the card against the CPU, 3 chained steps from a random 16x16x32
     state in f64 and f32 (TOL; the KISS states bitwise); the inputs
     BINARY_ROUTE_INPUTS in f64 through run_text on both (rtol 1e-9, atol
     1e-11, the lines equal but the floats); a walls + noise restart on
     the card that prints the straight log as text;
 30. at full width in f32: phase 8's 256^3 spinodal binary with
     `boundary_walls 0_0_1` and the 27-point wetting stencil, a 128^3
     porous binary read from a status_with_c_h map and a 128^3
     symmetric_noise run with the LB's fluctuations, each for 20 cycles
     through run_text ([phi] total conserved, the [walls] row where walls
     exist), ms a step (CUDA events), CUDA kernels a step and their device
     time (torch.profiler), and one step under CUDA's sync debug mode
     "error"; their reference statistics launch the stats_ref scans;
 31. the other free energies' routes (MORE_FE_ROUTES: Brazovskii,
     periodic and sheared with the fourth-order LE fields, surfactant,
     ternary with phi grad mu, between walls with the 27-point ternary
     wetting stencil, two-field `hydrodynamics off`, the polar gel with
     and without hydrodynamics, symmetric_lb with 27-point gradients,
     between walls, with planes and with the LB's KISS noise, and
     fe_electro_symmetric with a contrast) on the card against the CPU,
     3 chained steps from a random 16x16x32 state in f64 and f32 (TOL;
     the electrolyte's f32 leaves at TOL's rtol of their largest
     magnitude, f32's own rounding of its SOR; the KISS states bitwise);
     one input of each family
     (MORE_FE_INPUTS) in f64 through run_text on both (rtol 1e-9, atol
     1e-11, the lines equal but the floats); a walled ternary restart on
     the card that prints the straight log as text;
 32. at full width in f32 (MORE_FE_CELLS): Brazovskii, surfactant,
     ternary and the polar gel at 128^3, symmetric_lb at 256^3 and
     fe_electro_symmetric at 64^3, each for 20 cycles (the last for 8)
     through run_text
     (its conserved totals held, summed from the state in float64: the
     mass, phi, psi, the electrolyte's species), ms a step (CUDA
     events), CUDA kernels a step and their device time
     (torch.profiler), and one step under CUDA's sync debug mode:
     "error", or for fe_electro_symmetric "warn", its host
     synchronisations counted against the SOR's read-backs (one every 5
     iterations);
 33. the blue phase's unfused routes (LC_ROUTES: halo walls on each axis
     with the s7 anchoring kinds normal, planar and fixed, the 'two'
     style, porous solids under 3d_7pt_solid, the dynamic redshift, the
     electric field, hydrodynamics off, advection orders 3-5, colloids
     periodic and beside a wall) on the card against the CPU, 3 chained
     steps from a random 16x16x32 state in f64 and f32 (TOL); one input
     of each kind (LC_INPUTS) in f64 through run_text on both (rtol 1e-9,
     atol 1e-11, every line the same but its numbers); a walled LC
     restart on the card that prints the straight log as text;
 34. at 128^3 f32 (LC_CELLS): the blue-phase benchmark between walls on z
     with s7 normal anchoring, a nematic holding 8 particles of radius
     7.25 (rebuild steps timed apart), the benchmark with the dynamic
     redshift (printed each cycle), each for 20 cycles through run_text,
     ms a step (CUDA events), CUDA kernels a step and their device time
     (torch.profiler), one step under CUDA's sync debug mode "error";
 35. the colloids of the binary fluid, symmetric_lb and the electrolyte
     and the repaired LC colloid route (FAMILY_ROUTES: two wetting
     particles between walls and five periodic ones in each binary
     family, one charged particle under both force methods, the LC
     colloids periodic and beside a wall) on the card against the CPU, 3
     chained steps from a random 16x16x32 state in f64 and f32 (TOL; the
     electrolyte's f32 leaves at TOL's rtol of their largest magnitude,
     the charge the put-back leaves at TOL's rtol of the particle's);
     each family's input (FAMILY_INPUTS) in f64 through run_text on both
     (rtol 1e-9, atol 1e-11, every line the same but its numbers);
 36. at full width in f32 (FAMILY_CELLS): 1000 particles of radius 4 at
     random in the spinodal binary fluid and in symmetric_lb at 128^3
     (rebuilt every step, the segment-sum route), one charged particle
     of radius 4 in a uniform electrolyte at 64^3 with a field on x (the
     reference SOR), each for FAMILY_CELL_CYCLES cycles through run_text,
     ms a step with rebuild steps apart (CUDA events), CUDA kernels a
     step and their device time (torch.profiler), one step under CUDA's
     sync debug mode: "error" for the binary cells, "warn" for the
     electrolyte, its host syncs counted against the SOR's read-backs;
 37. D2Q9 on the one-step kernels (fused_lb_q9): fused_step with and
     without fluctuations against the twins, 3 chained steps at 64x64x1
     and 128x96x1, M10 and BGK (TRT is not defined for D2Q9), f64 and f32
     (TOL), both back-transform forms; the n-step and force kernels
     refuse D2Q9 by name (as the JAX package's do: no fallback); then
     both kernels at 4096x4096x1 f32 against their bound and the device
     copy of the state;
 38. the full log on the card: the 256^3 main input with `tpu_timer_detail
     on` (its "Collide+stream" probe a fused_step launch), the 4096x4096x1
     f32 Kelvin-Helmholtz shear layer (KH_INPUT, D2Q9, 20 cycles, ms a
     step) and a fluctuating one at 1024x1024x1 (fused_step_noise), each
     log's input header equal as text to the port's on the CPU (built
     there, not stepped), [rho] conserved, the kernel launched once a
     cycle and four times for the probe; then one small input per family
     (LOG_INPUTS) in f64 on the card and on the CPU: the headers equal as
     text, the lines to the timer table the same with their numbers
     within rtol 1e-9 / atol 1e-11 (as phase 17 holds the electrolyte:
     its cancelling [psi] and [elc] totals to 1e-12 x sites x the largest
     value, its SOR residual not compared), every log ending with
     "Ludwig finished normally.";
 39. the threefry stream (noise.discrete_deviates) on the card bitwise the
     CPU's for 3 seeds x 2 steps at 5 x 128^3, and its time there; the
     128^3 f32 blue phase with `lc_noise 1` (the unfused route) for 20
     cycles through run_text: ms a step beside lc_noise 0, CUDA kernels a
     step and their device time, host syncs a step, Q symmetric and
     traceless; a 16^3 f64 input with `lc_noise 1` and
     `isothermal_fluctuations on`, the card's log against the CPU's as in
     phase 38;
 40. phase 28's 64^3 N=1000 suspension with the LB's KISS stream: ms a
     rebuild step and another, kernels and device time, both steps under
     the sync debug mode "error"; the repository's 30 subgrid particles
     with their Langevin kicks (host LCG words) and Brazovskii at 128^3
     with the LB noise through run_text; 16^3 colloids, the subgrid input
     and Brazovskii in f64, the card's logs against the CPU's; each run's
     kT statistics over the input temperature;
 41. the droplet between walls on z with `fe_force_method
     relaxation_antisymmetric`, the droplet in a simple-cubic porous
     medium with the 27-point stencil and order-3 advection, and the
     Gouy-Chapman electrolyte in porous media, in f64 through run_text on
     the card and on the CPU (the logs held as in phase 38); np_gradmu
     and the solid fused_force_step at f32 on porous masks (the charged
     walls with a simple-cubic map, and with 8% of the sites at random)
     at 64^3 and 128^3 against their twins by phase 16's rules; the
     droplet input on the card with `default_io_grid 2_2_1` and
     `phi_io_grid 1_1_4`: each recombined set bitwise the single file
     of the same run with one I/O group;
 42. at full width f32, 20 cycles through run_text: the 128^3 droplet
     between walls with the relaxation force, the 128^3 droplet in a
     simple-cubic porous medium (acell 16), and the 128^3 Gouy-Chapman
     electrolyte in the same medium (the three kernels launched once a
     cycle); ms a step (CUDA events), CUDA kernels a step and their
     device time (torch.profiler), host syncs a step (none for the
     droplet); sor_solve, np_gradmu and the solid K2 timed on the porous
     state beside the plain Gouy-Chapman state's, and the plain cell's
     step; a 128^3 q dump from the card as one file and as the 2_2_2
     subfile set (host clock).

Bounds: `bound_ms` is the larger of the bytes the function must move
(each input read once, each output written once) over the H100 SXM's
published 3.35 TB/s and its arithmetic over 67 TFLOP/s f32 (NVIDIA's
data sheet, dense, 700 W); `copy_bound_ms` puts the same bytes
over the device copy bandwidth measured in this run.

The kernels' JSON record comes before the card's line (ms and plain_ms
per lattice step, CUDA events; fused_step also carries phase 24's wall
and LE step and post-pass times and phase 38's cells; fused_step_q9 and
fused_step_noise_q9 are the D2Q9 library's kernels at 4096x4096x1;
fused_step_noise carries phases 39-40 as "fluctuations",
fused_force_step_solid phases 41-42 as "options"), the
last line is {"ok": true, "device": {...}}.
There is no CPU path.
"""

import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE
from ludwig_tpu_torch.fe.lc_droplet import LCDropletFE
from ludwig_tpu_torch.fe.lc_init import lc_init_o8m
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.lb import LBConfig, initial_rest
from ludwig_tpu_torch.ludwig import run_text
from ludwig_tpu_torch.ops import _cuda, fused
from ludwig_tpu_torch.ops import fused_binary as fb
from ludwig_tpu_torch.ops import fused_droplet as fd
from ludwig_tpu_torch.ops import fused_electro as fe
from ludwig_tpu_torch.ops import fused_lc as fl
from ludwig_tpu_torch.ops.collide import RelaxationScheme

SOURCE = "ludwig_tpu_torch/csrc/fused_lb.cu"
SOURCE_BINARY = "ludwig_tpu_torch/csrc/binary_phi.cu"
SOURCE_LC = "ludwig_tpu_torch/csrc/lc_q.cu"
SOURCE_DROPLET = "ludwig_tpu_torch/csrc/droplet.cu"
SOURCE_ELECTRO = "ludwig_tpu_torch/csrc/electro.cu"
SOURCE_STATS = "ludwig_tpu_torch/csrc/stats_ref.cu"
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, published
PEAK_F32_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
# f64: kernel and twin evaluate one expression tree operation by operation
# (nvcc -fmad=false); what is left is the twin folding a few scalar
# products in double before rounding (rdim * rtb, coef * force) and
# torch's reciprocal for 1/rho, ulp-level on O(1e-1) values.  f32: the
# same ulp-level differences at float precision, grown over 3 steps.
TOL = {torch.float64: dict(rtol=1e-12, atol=1e-13),
       torch.float32: dict(rtol=1e-5, atol=1e-7)}
MAIN_SIZE = (256, 256, 256)
MAIN_CYCLES = 40
BENCH_NSTEPS = 6        # bench.py's first n (absolute form, delta=False)
NSTEPS = tuple(range(1, fused.NSTEPS_MAX + 1))
BENCH_RUNGS = (6, 4, 3, 2)   # bench.py:65-66's ladder
# n-step plans (x segment, y-z tile) timed beside the default in phase 6
TILE_PASSES = 5
TILE_PLANS = tuple(fused.FusedPlan(*p) for p in (
    (64, 16, 32), (128, 16, 32), (256, 16, 32), (128, 8, 64), (128, 16, 64),
    (128, 32, 32)))


# the K1 x-march (binary, LC and droplet): the shapes held against the
# twins (the last two shorter than the halo or ragged against the tile),
# the plans held bitwise against the default layout at a ragged shape,
# and the plans timed beside the default at 128^3 and 256^3 (f32; the
# binary march at 256^3, its main path's size, over its own plans: its
# blocks are small, so more tiles and thread counts fit)
K1_SHAPES = ((16, 24, 40), (64, 64, 64), (9, 5, 3), (18, 40, 70))
K1_RAGGED = (18, 40, 70)
K1_PLANS = {torch.float32: tuple(_cuda.K1Plan(*p) for p in (
    (16, 512), (16, 512, 16), (8, 256), (8, 256, 16), (16, 256), (4, 128))),
            torch.float64: tuple(_cuda.K1Plan(*p) for p in (
                (8, 256), (8, 256, 5), (4, 128), (2, 64)))}
BINARY_K1_PLANS = {torch.float32: tuple(_cuda.K1Plan(*p) for p in (
    (8, 256), (8, 128), (8, 128, 32), (16, 256), (16, 512), (16, 128),
    (4, 128), (4, 64))),
                   torch.float64: K1_PLANS[torch.float64]}
# the K1 times (ms) of the designs the march replaced, as phases 9, 12
# and 15 of this script measured them on an NVIDIA H100 80GB HBM3 at
# 700.00 W: for LC and droplet an 8x8x32 box with a halo of 1 and level 1
# on all of it, for the binary fluid one thread a site recomputing its
# neighbours' level 1 (256^3 f32, order 2)
K1_BOX_MS = {("lc_q_force_step", 128): 0.2817,
             ("lc_q_force_step", 256): 2.1560,
             ("droplet_phi_q_force_step", 128): 0.3005,
             ("droplet_phi_q_force_step", 256): 2.3151}
BINARY_K1_THREAD_MS = 0.8321
# the times (ms) of the np_gradmu kernel the NP x-march replaced, one
# thread a site computing both faces of each axis (two species, with
# hydrodynamics), as phase 18 measured them on an NVIDIA H100 80GB HBM3 at
# 700.00 W, at 128^3 and 256^3
NP_THREAD_MS = {128: 0.1260, 256: 0.9224}
# the NP march's tiles timed beside the default in phase 18, and the
# shapes and species counts phase 16 holds it at (16x4x4: the CLI test's
# lattice, every axis shorter than the tile)
NP_PLANS = tuple(_cuda.NpPlan(*p) for p in ((8,), (4,), (16,), (3,),
                                            (8, 16)))
NP_SHAPES = ((16, 16, 128), (15, 16, 32), (64, 64, 64), (128, 128, 128),
             (16, 4, 4))
NP_SPECIES = {1: dict(valency=(1,), diffusivity=(0.01,)),
              2: dict(valency=(1, -1), diffusivity=(0.01, 0.0095)),
              3: dict(valency=(1, -1, 2), diffusivity=(0.01, 0.0095, 0.008))}

_T0 = time.perf_counter()


def phase(name):
    """A phase's header, with the seconds since the script started (the
    time a phase adds is the next header's time less its own)."""
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def rand_state(cfg, gen, amp=0.05):
    w = torch.as_tensor(cfg.model.wv, dtype=cfg.tdtype, device="cuda")
    noise = torch.randn((cfg.nvel,) + cfg.size, generator=gen,
                        dtype=cfg.tdtype, device="cuda")
    return (w.reshape(-1, 1, 1, 1) * (1.0 + amp * noise)).contiguous()


def max_err(a, b):
    return float((a - b).abs().max())


def check_close(what, a, b, dtype):
    torch.cuda.synchronize()
    err = max_err(a, b)
    if not torch.allclose(a, b, **TOL[dtype]):
        raise AssertionError(f"{what}: max |diff| {err:.3e} beyond "
                             f"{TOL[dtype]}")
    return err


def check_increment(what, x, a, b):
    """Kernel result a and twin result b as increments of x, held to one
    unit in the last place of the largest |b|.  A step changes Q by far
    less than Q itself, so the whole-value tolerance would pass an error
    of a few percent in one term of the update; this one does not.
    Returns (max |diff| of the increments, the same over the largest
    increment)."""
    torch.cuda.synchronize()
    inc = b - x
    err = max_err(a - x, inc)
    ulp = torch.finfo(b.dtype).eps * float(b.abs().max())
    if not err <= ulp:
        raise AssertionError(f"{what}: increments differ by {err:.3e}, "
                             f"beyond one ulp of the value, {ulp:.3e}")
    return err, err / float(inc.abs().max())


def bound(nbytes, nops):
    """(bound_ms, bound_by) from bytes moved and f32 operations."""
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * nops / PEAK_F32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def clocks_line():
    """The SM clock, power draw and limit as nvidia-smi reads them now."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                          "power.draw,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return res.stdout.strip().splitlines()[0]


def k1_floor_ms(kernel, lay, nsite, order=1):
    """The issue floor: the generated operations a site on the layout
    (level 1 times its evaluations a site, plus the site update) over
    the card's f32 issue rate without FMA."""
    return (1e3 * nsite * _cuda.k1_site_ops(kernel, lay.evals_per_site,
                                            order) / _cuda.K1_ISSUE_RATE)


def hold_k1_layout(x, kernel, lay, order=1):
    """The layout's blocks an SM as the card's occupancy query counts
    them, and the kernel's registers; raises where they differ."""
    regs, occ = _cuda.k1_occupancy(x, kernel, lay, order)
    if occ != lay.blocks_per_sm:
        raise AssertionError(f"{kernel} {lay}: the card keeps {occ} blocks "
                             f"an SM resident, k1_layout counts "
                             f"{lay.blocks_per_sm} ({regs} registers)")
    return regs


def k1_plans(kernel, dtype):
    """The plans held and timed beside a K1 kernel's default layout."""
    return (BINARY_K1_PLANS if kernel == _cuda.BINARY_KERNEL
            else K1_PLANS)[dtype]


def hold_k1_plans(what, run, x, kernel, ref, order=1):
    """Each plan of k1_plans for x's dtype, run through run(plan), is
    bitwise `ref` (the default layout's outputs): the tiling changes no
    operation."""
    for plan in k1_plans(kernel, x.dtype):
        lay = _cuda.k1_layout_on(x, kernel, order, plan)
        hold_k1_layout(x, kernel, lay, order)
        got = run(plan)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{what} on {lay}: not bitwise the default "
                                 "layout's outputs")
        print(f"{what} on [{lay}]: bitwise the default layout's")


def time_ms(fn, reps, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def cases():
    for nvel in (15, 19, 27):
        for scheme in ("m10", "bgk", "trt"):
            if not (scheme == "trt" and nvel == 27):   # ref asserts
                yield nvel, RelaxationScheme(scheme)


def phase3(gen):
    phase("3 kernels vs plain twins (3 chained steps)")
    worst = {"fused_step": 0.0, "fusedn_step": 0.0}
    for size in ((16, 24, 40), (64, 64, 64)):
        for nvel, scheme in cases():
            for dtype in ("float64", "float32"):
                cfg = LBConfig(size=size, nvel=nvel, eta_shear=0.1,
                               eta_bulk=0.14, scheme=scheme, dtype=dtype,
                               force_global=(1e-4, -2e-4, 5e-5),
                               device="cuda")
                model, params = cfg.model, cfg.collision_params()
                f0 = rand_state(cfg, gen)
                for delta in (True, False):
                    a = b = f0
                    for _ in range(3):
                        a = fused.fused_step(a, model, params, delta=delta)
                        b = fused._fused_step_plain(b, model, params, delta)
                    err = check_close(f"fused_step {size} q{nvel} "
                                      f"{scheme.value} {dtype} "
                                      f"delta={delta}", a, b, cfg.tdtype)
                    worst["fused_step"] = max(worst["fused_step"], err)
                    print(f"fused_step {size} D3Q{nvel} {scheme.value} "
                          f"{dtype} delta={delta} max_abs_err {err:.3e}")
    # the n-step twin walks the kernel's own tiles in Python: small sizes
    for nvel, scheme in cases():
        cfg = LBConfig(size=(16, 24, 40), nvel=nvel, eta_shear=0.1,
                       eta_bulk=0.14, scheme=scheme, dtype="float64",
                       force_global=(1e-4, -2e-4, 5e-5), device="cuda")
        model, params = cfg.model, cfg.collision_params()
        f0 = rand_state(cfg, gen)
        for delta in (True, False):
            a = fused.fusedn_step(f0, model, params, 3, delta=delta)
            b = fused._fusedn_step_plain(f0, model, params, 3,
                                         fused.FusedPlan(), delta)
            err = check_close(f"fusedn_step q{nvel} {scheme.value} "
                              f"delta={delta}", a, b, cfg.tdtype)
            worst["fusedn_step"] = max(worst["fusedn_step"], err)
            print(f"fusedn_step n=3 (16, 24, 40) D3Q{nvel} {scheme.value} "
                  f"float64 delta={delta} max_abs_err {err:.3e}")
    return worst


def nstep_route(lay):
    return (f"{lay.route} tile {lay.plan.BX}x{lay.plan.BY}x{lay.plan.BZ}, "
            f"{lay.threads} threads")


def hold_nstep(f0, model, params, n, plan, what):
    """fusedn_step bitwise n fused_step launches, in both forms; returns
    the route the launcher took."""
    lay = _cuda.nstep_layout_on(f0, model, plan, n)
    for delta in (True, False):
        a = fused.fusedn_step(f0, model, params, n, plan, delta)
        b = fused.make_fused_nstep(model, params, delta=delta)(f0, n)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(
                f"fusedn n={n} {plan} {what} delta={delta}: max |diff| "
                f"{max_err(a, b):.3e}, not bitwise")
        del a, b
    print(f"fusedn_step n={n} plan {plan.BX}x{plan.BY}x{plan.BZ} {what}: "
          f"{nstep_route(lay)}, both forms bitwise")
    return lay


def phase4(gen):
    phase("4 n-step kernel vs n single-step launches, bitwise")
    for dtype in ("float64", "float32"):
        cfg = LBConfig(size=(32, 32, 64), nvel=19, eta_shear=0.1,
                       eta_bulk=0.1, force_global=(1e-5, 0.0, 0.0),
                       dtype=dtype, device="cuda")
        model, params = cfg.model, cfg.collision_params()
        f0 = rand_state(cfg, gen)
        for n in NSTEPS:
            for plan in (fused.FusedPlan(), fused.FusedPlan(5, 7, 9)):
                hold_nstep(f0, model, params, n, plan,
                           f"(32, 32, 64) {dtype}")
    # the bench's rungs on its state size
    cfg = LBConfig(size=MAIN_SIZE, nvel=19, eta_shear=0.1, eta_bulk=0.1,
                   dtype="float32", device="cuda")
    model, params = cfg.model, cfg.collision_params()
    f0 = rand_state(cfg, gen, amp=0.01)
    for n in BENCH_RUNGS:
        lay = hold_nstep(f0, model, params, n, fused.FusedPlan(),
                         "256^3 float32")
        if n in (2, 3) and lay.route != "shared":
            raise AssertionError(f"fusedn n={n} 256^3 f32 ran {lay.route}, "
                                 "not in shared memory")


MAIN_INPUT = f"""
size {MAIN_SIZE[0]}_{MAIN_SIZE[1]}_{MAIN_SIZE[2]}
tpu_fused on
dtype float32
viscosity 0.1
viscosity_bulk 0.1
N_cycles {MAIN_CYCLES}
freq_statistics 20
"""


def phase5():
    phase("5 main path: D3Q19 256^3 f32, run_text on cuda + n-step bench")
    cfg = LBConfig(size=MAIN_SIZE, nvel=19, eta_shear=0.1, eta_bulk=0.1,
                   dtype="float32", device="cuda")
    torch.cuda.synchronize()
    _cuda.launches.reset()
    log = io.StringIO()
    t0 = time.perf_counter()
    run_text(MAIN_INPUT, out=log, device="cuda")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = _cuda.launches.fused_step
    # the bench entry: the n-step kernel from rest, as bench.py drives it
    # (its first rung, n=6, make_fusedn_nstep's default absolute form)
    nstep = fused.make_fusedn_nstep(cfg.model, cfg.collision_params(),
                                    BENCH_NSTEPS)
    fb = nstep(initial_rest(cfg), 2 * BENCH_NSTEPS)
    torch.cuda.synchronize()
    counts = {"fused_step": _cuda.launches.fused_step,
              "fusedn_step": _cuda.launches.fusedn_step}
    text = log.getvalue()
    print(text[text.rfind("Scalars"):text.rfind("Completed")].strip())
    if f"Completed cycle {MAIN_CYCLES}" not in text:
        raise AssertionError("run_text did not complete its cycles")
    nsite = MAIN_SIZE[0] * MAIN_SIZE[1] * MAIN_SIZE[2]
    totals = [float(v) for v in re.findall(r"\[rho\]\s+(\S+)", text)]
    # increment form keeps mass to f32 rounding (ACCURACY.md:62-71)
    if not all(abs(t - nsite) <= 1e-5 * nsite for t in totals):
        raise AssertionError(f"[rho] totals {totals} != {nsite}")
    if cli_launches != MAIN_CYCLES:
        raise AssertionError(f"fused_step launched {cli_launches} times "
                             f"for {MAIN_CYCLES} cycles")
    if counts["fusedn_step"] != 2:
        raise AssertionError(f"fusedn_step launched {counts['fusedn_step']}"
                             " times for 2 bench passes")
    mass = float(fb.double().sum())
    if not torch.isfinite(fb).all() or abs(mass - nsite) > 1e-5 * nsite:
        raise AssertionError(f"n-step bench state mass {mass} != {nsite}")
    print(f"run_text 256^3 x {MAIN_CYCLES} cycles: {cli_s:.2f} s wall, "
          f"[rho] totals {totals}, launches {counts}")
    return counts


def phase6(card, gen):
    phase(f"6 timing at 256^3 D3Q19 f32 on {card}")
    cfg = LBConfig(size=MAIN_SIZE, nvel=19, eta_shear=0.1, eta_bulk=0.1,
                   dtype="float32", device="cuda")
    model, params = cfg.model, cfg.collision_params()
    f0 = rand_state(cfg, gen, amp=0.01)
    nsite = MAIN_SIZE[0] * MAIN_SIZE[1] * MAIN_SIZE[2]

    nbytes = 2 * f0.numel() * f0.element_size()   # one read + one write

    def report(name, ms_step):
        print(f"{name}: {ms_step:.4f} ms/step [{card}]")
        print(f"{name}: {nsite / (ms_step * 1e3):.1f} MLUPS [{card}]")

    def twin_steps(n, delta):
        f = f0
        for _ in range(n):
            f = fused._fused_step_plain(f, model, params, delta)
        return f

    # the card's copy bandwidth on the state: the single step's bound
    dst = torch.empty_like(f0)
    copy_ms = time_ms(lambda: dst.copy_(f0), 20)
    del dst
    print(f"device copy of the state: {copy_ms:.4f} ms = "
          f"{nbytes / (copy_ms * 1e9):.3f} TB/s read+write [{card}]")

    res = {}
    plain_ms = time_ms(lambda: twin_steps(1, True), 3, warm=1)
    report("plain twin fused_step (delta)", plain_ms)
    step_ms = time_ms(lambda: fused.fused_step(f0, model, params), 20)
    report("kernel fused_step (delta)", step_ms)
    print(f"kernel fused_step (delta): {nbytes / (step_ms * 1e9):.3f} TB/s "
          f"= {100 * copy_ms / step_ms:.1f}% of the device copy [{card}]")
    err = check_close("fused_step 256^3", fused.fused_step(f0, model, params),
                      twin_steps(1, True), cfg.tdtype)
    print(f"fused_step 256^3 float32 delta=True vs twin max_abs_err "
          f"{err:.3e}")
    res["copy_ms"] = copy_ms
    res["copy_bytes"] = nbytes
    res["fused_step"] = dict(
        ms=step_ms, plain_ms=plain_ms, max_abs_err=err,
        nbytes=nbytes, nops=nsite * _cuda.site_ops("fused_step"))
    for n in NSTEPS:
        route = nstep_route(_cuda.nstep_layout_on(f0, model,
                                                  fused.FusedPlan(), n))
        for delta, form in ((True, "delta"), (False, "absolute")):
            ms = time_ms(lambda: fused.fusedn_step(f0, model, params, n,
                                                   delta=delta), 5)
            report(f"kernel fusedn_step n={n} ({form}; {route})", ms / n)
    # the plans the default was chosen from: the least median of the n=2
    # + n=3 time over TILE_PASSES passes, in turns forwards and backwards
    sums = {plan: [] for plan in TILE_PLANS}
    for rep in range(TILE_PASSES):
        for plan in TILE_PLANS[::1 if rep % 2 == 0 else -1]:
            sums[plan].append(sum(
                time_ms(lambda: fused.fusedn_step(f0, model, params, n, plan,
                                                  delta=True), 5) / n
                for n in (2, 3)))
    for plan, runs in sums.items():
        routes = [nstep_route(_cuda.nstep_layout_on(f0, model, plan, n))
                  for n in (2, 3)]
        tag = " (the default)" if plan == fused.FusedPlan() else ""
        print(f"tile sweep plan {plan.BX}x{plan.BY}x{plan.BZ}{tag} (n=2: "
              f"{routes[0]}; n=3: {routes[1]}): n=2 + n=3 increment, median "
              f"{sorted(runs)[len(runs) // 2]:.4f} ms/step of "
              f"{', '.join(f'{r:.4f}' for r in runs)} [{card}]")
    # the bench's form: n=6, absolute back transform
    n = BENCH_NSTEPS
    ms = time_ms(lambda: fused.fusedn_step(f0, model, params, n), 5) / n
    report(f"kernel fusedn_step n={n} (absolute)", ms)
    twin_ms = time_ms(lambda: twin_steps(n, False), 1, warm=1) / n
    report(f"plain twin {n} x fused_step (absolute)", twin_ms)
    err = check_close(f"fusedn_step n={n} 256^3",
                      fused.fusedn_step(f0, model, params, n),
                      twin_steps(n, False), cfg.tdtype)
    print(f"fusedn_step n={n} 256^3 float32 delta=False vs {n} twin steps "
          f"max_abs_err {err:.3e}")
    # per lattice step: one read and one write of f per n-step launch
    res["fusedn_step"] = dict(
        ms=ms, plain_ms=twin_ms, max_abs_err=err, nbytes=nbytes / n,
        nops=nsite * _cuda.site_ops("fusedn_step", delta=False))
    return res


FE = SymmetricFE(a=-0.00625, b=0.00625, kappa=0.004)   # BINARY_INPUT's
MOBILITY = 1.25
BINARY_CYCLES = 20
BINARY_INPUT = f"""
tpu_fused on
dtype float32
N_cycles {BINARY_CYCLES}
size {MAIN_SIZE[0]}_{MAIN_SIZE[1]}_{MAIN_SIZE[2]}
viscosity 0.00625
free_energy symmetric
A {FE.a}
B {FE.b}
K {FE.kappa}
phi0 0.0
phi_initialisation spinodal
mobility {MOBILITY}
fd_gradient_calculation 3d_7pt_fluid
fd_advection_scheme_order 2
periodicity 1_1_1
freq_statistics 10
random_seed 8361235
"""


def rand_phi_u(size, dtype, gen):
    phi = 0.05 * torch.randn(size, generator=gen, dtype=dtype,
                             device="cuda")
    u = 0.01 * torch.randn((3,) + size, generator=gen, dtype=dtype,
                           device="cuda")
    return phi.contiguous(), u.contiguous()


def binary_cfg(size, dtype, order):
    from ludwig_tpu_torch.binary import BinaryConfig
    lb = LBConfig(size=size, nvel=19, eta_shear=0.00625, dtype=dtype,
                  device="cuda")
    return BinaryConfig(lb=lb, fe=FE, mobility=MOBILITY,
                        advection_order=order)


def phase7(gen):
    phase("7 binary-fluid kernels vs plain twins")
    worst = {"binary_phi_force_step": 0.0, "fused_force_step": 0.0}
    kernel = _cuda.BINARY_KERNEL
    for size in K1_SHAPES:
        for dtype in (torch.float64, torch.float32):
            phi, u = rand_phi_u(size, dtype, gen)
            for order in fb.ORDERS:
                lay = _cuda.k1_layout_on(phi, kernel, order)
                regs = hold_k1_layout(phi, kernel, lay, order)
                a = fb.binary_phi_force_step(phi, u, FE, MOBILITY, order)
                b = fb._binary_phi_force_plain(phi, u, FE, MOBILITY, order)
                what = f"binary_phi_force_step {size} {dtype} order {order}"
                errs = [check_close(f"{what} {name}", x, y, dtype)
                        for name, x, y in zip(("phi", "force"), a, b)]
                worst[kernel] = max(worst[kernel], *errs)
                inc_err, inc_rel = check_increment(f"{what} phi' - phi", phi,
                                                   a[0], b[0])
                print(f"{what} layout [{lay}], {regs} registers: max_abs_err "
                      f"phi {errs[0]:.3e} force {errs[1]:.3e} bitwise "
                      f"{[torch.equal(x, y) for x, y in zip(a, b)]} "
                      f"(tolerance {TOL[dtype]}); increment phi' - phi "
                      f"within {inc_err:.3e}, {inc_rel:.3e} of its largest "
                      "(tolerance: one ulp of the largest |phi'|)")
                if size == K1_RAGGED:
                    hold_k1_plans(
                        what, lambda plan: _cuda.binary_phi_force_step(
                            phi, u, fb._consts(FE, MOBILITY), order,
                            plan=plan), phi, kernel, a, order)  # noqa
    for size in ((16, 24, 40), (64, 64, 64)):
        for nvel, scheme in cases():
            for dtype in ("float64", "float32"):
                cfg = LBConfig(size=size, nvel=nvel, eta_shear=0.1,
                               eta_bulk=0.14, scheme=scheme, dtype=dtype,
                               force_global=(1e-4, 0.0, 5e-5),
                               device="cuda")
                model, params = cfg.model, cfg.collision_params()
                f0 = rand_state(cfg, gen)
                frc = (1e-4 * torch.randn((3,) + size, generator=gen,
                                          dtype=cfg.tdtype, device="cuda")
                       ).contiguous()
                a = fused.fused_force_step(f0, frc, model, params)
                b = fused._fused_force_step_plain(f0, frc, model, params)
                err = max(check_close(f"fused_force_step {size} q{nvel} "
                                      f"{scheme.value} {dtype} {name}", x, y,
                                      cfg.tdtype)
                          for name, x, y in zip(("f", "u"), a, b))
                worst["fused_force_step"] = max(worst["fused_force_step"],
                                                err)
                print(f"fused_force_step {size} D3Q{nvel} {scheme.value} "
                      f"{dtype} max_abs_err {err:.3e}")
    # whole fused binary step: 3 chained steps, kernels vs twins
    for size in ((16, 24, 40), (64, 64, 64)):
        for dtype in ("float64", "float32"):
            for order in fb.ORDERS:
                bcfg = binary_cfg(size, dtype, order)
                phi0, _ = rand_phi_u(size, bcfg.lb.tdtype, gen)
                step = fb.make_fused_binary_step(bcfg)
                a = b = fb.initial_fused_binary(bcfg, phi0)
                for _ in range(3):
                    a = step(a)
                    f, phi, u = b
                    phi, frc = fb._binary_phi_force_plain(
                        phi, u, FE, MOBILITY, order)
                    f, u = fused._fused_force_step_plain(
                        f, frc, bcfg.lb.model, bcfg.lb.collision_params())
                    b = (f, phi, u)
                for name, x, y in zip(("f", "phi", "u"), a, b):
                    err = check_close(f"fused binary step {size} {dtype} "
                                      f"order {order} {name}", x, y,
                                      bcfg.lb.tdtype)
                    print(f"fused binary step x3 {size} {dtype} order "
                          f"{order} {name} max_abs_err {err:.3e}")
    return worst


def phase8():
    phase("8 binary main path: symmetric D3Q19 256^3 f32, run_text on cuda")
    nsite = MAIN_SIZE[0] * MAIN_SIZE[1] * MAIN_SIZE[2]
    torch.cuda.synchronize()
    _cuda.launches.reset()
    log = io.StringIO()
    t0 = time.perf_counter()
    sys_ = run_text(BINARY_INPUT, out=log, device="cuda")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = {"binary_phi_force_step": _cuda.launches.binary_phi_force_step,
              "fused_force_step": _cuda.launches.fused_force_step}
    text = log.getvalue()
    print(text[text.rfind("Scalars"):text.rfind("Completed")].strip())
    if f"Completed cycle {BINARY_CYCLES}" not in text:
        raise AssertionError("binary run_text did not complete its cycles")
    if sys_.fused_mode != "binary":
        raise AssertionError(f"fused_mode {sys_.fused_mode}, not binary")
    for name, n in counts.items():
        if n != BINARY_CYCLES:
            raise AssertionError(f"{name} launched {n} times for "
                                 f"{BINARY_CYCLES} cycles")
    f, phi, u = sys_.state
    for name, x, shape in (("f", f, (19,) + MAIN_SIZE), ("phi", phi, MAIN_SIZE),
                           ("u", u, (3,) + MAIN_SIZE)):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise AssertionError(f"{name}: {tuple(x.shape)} {x.dtype}")
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name} is not finite")
    # [phi] total: conserved by the flux form; f32 rounds each site's
    # update, the printed sums are f32 reductions.  Bound: 1e-7 of the
    # total |phi|.
    phis = [float(v) for v in re.findall(r"\[phi\]\s+(\S+)", text)]
    scale = 1e-7 * float(phi.double().abs().sum())
    if max(phis) - min(phis) > scale:
        raise AssertionError(f"[phi] totals {phis} not conserved "
                             f"within {scale:.3e}")
    rhos = [float(v) for v in re.findall(r"\[rho\]\s+(\S+)", text)]
    if not all(abs(t - nsite) <= 1e-5 * nsite for t in rhos):
        raise AssertionError(f"[rho] totals {rhos} != {nsite}")
    feds = [float(v) for v in re.findall(r"\[fed\]\s+\S+\s+(\S+)", text)]
    if len(feds) != 3 or len(phis) != 3:
        raise AssertionError(f"want 3 [phi]/[fed] blocks: {phis} {feds}")
    # run_text's timer table (host clocks; the statistics blocks
    # synchronise, so device time of the steps lands partly in them)
    print(text[text.find("Timer statistics"):].strip())
    print(f"binary run_text 256^3 x {BINARY_CYCLES} cycles: {cli_s:.2f} s "
          f"wall (spinodal init on the host included), [phi] totals {phis}"
          f" (spread {max(phis) - min(phis):.3e} <= {scale:.3e}), [rho] "
          f"totals {rhos}, [fed] {feds}, launches {counts}")
    return counts


def phase9(card, gen, copy_ms, copy_bytes):
    phase(f"9 binary timing at 256^3 D3Q19 f32 on {card}")
    bcfg = binary_cfg(MAIN_SIZE, "float32", 2)
    model, params = bcfg.lb.model, bcfg.lb.collision_params()
    nsite = MAIN_SIZE[0] * MAIN_SIZE[1] * MAIN_SIZE[2]
    phi, u = rand_phi_u(MAIN_SIZE, torch.float32, gen)
    u = 1e-3 * u
    f0 = rand_state(bcfg.lb, gen, amp=0.01)
    frc = (1e-5 * torch.randn((3,) + MAIN_SIZE, generator=gen,
                              device="cuda")).contiguous()
    res = {}

    def report(name, ms, plain_ms, nbytes, nops, err):
        b_ms, b_by = bound(nbytes, nops)
        copy_b = copy_ms * nbytes / copy_bytes
        print(f"{name}: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {nbytes / nsite:.0f} B/site, "
              f"{nops / nsite:.0f} flop/site), {100 * b_ms / ms:.1f}% of "
              f"it; copy bound {copy_b:.4f} ms, {100 * copy_b / ms:.1f}% of "
              f"it; max_abs_err vs twin {err:.3e} [{card}]")
        return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                    nbytes=nbytes, nops=nops)

    # K1: reads phi and u, writes phi' and the force: 8 values a site
    k1 = lambda: fb.binary_phi_force_step(phi, u, FE, MOBILITY, 2)  # noqa
    t1 = lambda: fb._binary_phi_force_plain(phi, u, FE, MOBILITY, 2)  # noqa
    a, b = k1(), t1()
    err = max(check_close(f"binary_phi_force_step 256^3 {n}", x, y,
                          torch.float32)
              for n, x, y in zip(("phi", "force"), a, b))
    inc_err, inc_rel = check_increment("binary_phi_force_step 256^3 phi' - "
                                       "phi", phi, a[0], b[0])
    print(f"binary_phi_force_step (K1) 256^3: bitwise "
          f"{[torch.equal(x, y) for x, y in zip(a, b)]}, increment phi' - "
          f"phi within {inc_err:.3e} of the twin's, {inc_rel:.3e} of its "
          "largest (tolerance: one ulp of the largest |phi'|)")
    r1 = report("binary_phi_force_step (K1, order 2)", time_ms(k1, 20),
                time_ms(t1, 3, warm=1), 8 * 4 * nsite,
                nsite * _cuda.site_ops("binary_phi_force_step", order=2), err)
    print(f"binary_phi_force_step (K1) 256^3 under load: {clocks_line()}")
    r1.update(k1_sweep(card, MAIN_SIZE, phi, _cuda.BINARY_KERNEL, r1["ms"], a,
                       lambda plan: _cuda.binary_phi_force_step(  # noqa
                           phi, u, fb._consts(FE, MOBILITY), 2, plan=plan),
                       order=2))
    del a, b
    res["binary_phi_force_step"] = r1
    # K2: reads f, force; writes f', u
    k2 = lambda: fused.fused_force_step(f0, frc, model, params)  # noqa
    t2 = lambda: fused._fused_force_step_plain(f0, frc, model, params)  # noqa
    err = max(check_close(f"fused_force_step 256^3 {n}", x, y,
                          torch.float32)
              for n, x, y in zip(("f", "u"), k2(), t2()))
    res["fused_force_step"] = report(
        "fused_force_step (K2, D3Q19 M10)", time_ms(k2, 20),
        time_ms(t2, 3, warm=1), 2 * (19 + 3) * 4 * nsite,
        nsite * _cuda.site_ops("fused_force_step"), err)
    # the whole step: K1 + K2 (force and u round-trip through memory)
    step = fb.make_fused_binary_step(bcfg)
    state = (f0, phi, u)

    def twin_step():
        _phi2, fr = fb._binary_phi_force_plain(phi, u, FE, MOBILITY, 2)
        return fused._fused_force_step_plain(f0, fr, model, params)

    step_ms = time_ms(lambda: step(state), 20)
    twin_ms = time_ms(twin_step, 3, warm=1)
    k1r, k2r = res["binary_phi_force_step"], res["fused_force_step"]
    report("fused binary step (K1 + K2, two-pass bound)", step_ms, twin_ms,
           k1r["nbytes"] + k2r["nbytes"], k1r["nops"] + k2r["nops"],
           max(k1r["max_abs_err"], k2r["max_abs_err"]))
    print(f"fused binary step: {nsite / (step_ms * 1e3):.1f} MLUPS [{card}]")
    return res

# the reference's blue-phase benchmark parameters (the JAX package's
# tests/test_ludwig_run.py LC_FUSED_INPUT)
LC_FE = dict(a0=0.01, gamma=3.0, q0=0.19635, kappa0=0.000648456,
             kappa1=0.000648456, xi=0.7)
LC_GAMMA = 0.5
LC_CYCLES = 20
LC_INPUT = f"""
tpu_fused on
N_cycles {LC_CYCLES}
viscosity 0.1
free_energy lc_blue_phase
fd_gradient_calculation 3d_7pt_fluid
fd_advection_scheme_order 1
lc_a0 {LC_FE['a0']}
lc_gamma {LC_FE['gamma']}
lc_q0 {LC_FE['q0']}
lc_kappa0 {LC_FE['kappa0']}
lc_kappa1 {LC_FE['kappa1']}
lc_xi {LC_FE['xi']}
lc_Gamma {LC_GAMMA}
lc_q_initialisation o8m
lc_q_init_amplitude -0.2
lc_init_redshift 1.0
periodicity 1_1_1
freq_statistics 10
colloid_init no_colloids
"""
LC_VARIANTS = (("passive", {}), ("active", dict(zeta0=0.002, zeta1=0.01)),
               ("redshift 0.93", dict(redshift=0.93)))


def lc_input(size, dtype):
    return (f"size {size[0]}_{size[1]}_{size[2]}\ndtype {dtype}\n"
            + LC_INPUT)


def rand_q_u(size, dtype, gen, u_amp=0.01):
    """The O8M blue phase with noise on it, and a velocity of both signs
    so that both upwind branches occur."""
    q = torch.as_tensor(lc_init_o8m(size, LC_FE["q0"], -0.2), dtype=dtype,
                        device="cuda")
    q = q + 0.02 * torch.randn(q.shape, generator=gen, dtype=dtype,
                               device="cuda")
    u = u_amp * torch.randn((3,) + size, generator=gen, dtype=dtype,
                            device="cuda")
    return q.contiguous(), u.contiguous()


def lc_cfg(size, dtype, **extra):
    from ludwig_tpu_torch.lc import LCConfig
    lb = LBConfig(size=size, nvel=19, eta_shear=0.1, dtype=dtype,
                  device="cuda")
    return LCConfig(lb=lb, fe=BluePhaseFE(**LC_FE, **extra), gamma=LC_GAMMA)


def lc_twin_step(state, lcfg):
    f, q, u = state
    q, frc = fl._lc_q_force_plain(q, u, lcfg.fe, lcfg.gamma)
    f, u = fused._fused_force_step_plain(f, frc, lcfg.lb.model,
                                         lcfg.lb.collision_params())
    return (f, q, u)


def phase10(gen):
    phase("10 liquid-crystal kernel vs plain twin")
    # the kernel divides the trace of W by 3 (IEEE); torch on a CUDA
    # tensor multiplies by the reciprocal of a Python scalar divisor, so
    # the twin divides by a tensor (dynamics/beris_edwards.py
    # remove_trace): held here bitwise to the IEEE quotient
    from ludwig_tpu_torch.dynamics.beris_edwards import remove_trace
    x = torch.randn(1 << 16, generator=gen, dtype=torch.float64,
                    device="cuda")
    print("torch on cuda: x / 3.0 equals x * (1 / 3.0) bitwise: "
          f"{torch.equal(x / 3.0, x * (1.0 / 3.0))}; equals the IEEE "
          f"quotient: {torch.equal(x / 3.0, x / torch.full_like(x, 3.0))}")
    for dtype in (torch.float64, torch.float32):
        w = [[torch.randn(1 << 16, generator=gen, dtype=dtype,
                          device="cuda") for _ in range(3)]
             for _ in range(3)]
        tr = (w[0][0] + w[1][1] + w[2][2]) / torch.full_like(w[0][0], 3.0)
        if not torch.equal(remove_trace(w)[0][0], w[0][0] - tr):
            raise AssertionError(f"remove_trace {dtype} on cuda: not the "
                                 "IEEE quotient")
    print("remove_trace on cuda: the IEEE quotient of the trace, bitwise")
    worst = 0.0
    for size in K1_SHAPES:
        for dtype in (torch.float64, torch.float32):
            q, u = rand_q_u(size, dtype, gen)
            lay = _cuda.k1_layout_on(q, _cuda.LC_KERNEL)
            regs = hold_k1_layout(q, _cuda.LC_KERNEL, lay)
            print(f"lc_q_force_step {size} {dtype} layout [{lay}], "
                  f"{regs} registers")
            for label, extra in LC_VARIANTS:
                fe = BluePhaseFE(**LC_FE, **extra)
                a = fl.lc_q_force_step(q, u, fe, LC_GAMMA)
                b = fl._lc_q_force_plain(q, u, fe, LC_GAMMA)
                errs = [check_close(f"lc_q_force_step {size} {dtype} "
                                    f"{label} {name}", x, y, dtype)
                        for name, x, y in zip(("q", "force"), a, b)]
                worst = max(worst, *errs)
                inc_err, inc_rel = check_increment(
                    f"lc_q_force_step {size} {dtype} {label} q' - q", q,
                    a[0], b[0])
                print(f"lc_q_force_step {size} {dtype} {label} max_abs_err "
                      f"q {errs[0]:.3e} force {errs[1]:.3e} bitwise "
                      f"{[torch.equal(x, y) for x, y in zip(a, b)]} "
                      f"(tolerance {TOL[dtype]}); increment q' - q within "
                      f"{inc_err:.3e}, {inc_rel:.3e} of its largest "
                      "(tolerance: one ulp of the largest |q'|)")
                if size == K1_RAGGED and label == "active":
                    hold_k1_plans(
                        f"lc_q_force_step {size} {dtype} {label}",
                        lambda plan: _cuda.lc_q_force_step(
                            q, u, fe, LC_GAMMA, plan=plan), q,  # noqa
                        _cuda.LC_KERNEL, a)
    # whole fused LC step: 3 chained steps, kernels vs twins
    for size in ((16, 24, 40), (64, 64, 64)):
        for dtype in ("float64", "float32"):
            lcfg = lc_cfg(size, dtype, zeta1=0.01)
            q0, _ = rand_q_u(size, lcfg.lb.tdtype, gen)
            step = fl.make_fused_lc_step(lcfg)
            a = b = fl.initial_fused_lc(lcfg, q0)
            for _ in range(3):
                a = step(a)
                b = lc_twin_step(b, lcfg)
            for name, x, y in zip(("f", "q", "u"), a, b):
                err = check_close(f"fused LC step {size} {dtype} {name}", x,
                                  y, lcfg.lb.tdtype)
                print(f"fused LC step x3 {size} {dtype} {name} max_abs_err "
                      f"{err:.3e} bitwise {torch.equal(x, y)}")
    return {"lc_q_force_step": worst}


def stat_floats(log):
    """All floats of the statistics lines of a run log."""
    vals = []
    for line in log.splitlines():
        if line.startswith(("[rho]", "[phi]", "[Q", "[fe]", "[fed]",
                            "[total", "[fluid", "[minimum", "[maximum",
                            "[eqipart.]", "[measd/kT]")):
            vals += [float(t) for t in line.split()
                     if re.match(r"^-?\d", t)]
    return torch.tensor(vals, dtype=torch.float64)


def phase11():
    phase("11 liquid-crystal main path: lc_blue_phase D3Q19 f32, run_text "
          "on cuda")
    # the card's log against the CPU twins' on a small lattice, f64:
    # statistics floats at the CLI tests' tolerance
    small = lc_input((16, 16, 32), "float64").replace(
        f"N_cycles {LC_CYCLES}", "N_cycles 4").replace(
        "freq_statistics 10", "freq_statistics 2")
    logs = {}
    for device in ("cuda", "cpu"):
        out = io.StringIO()
        torch.cuda.synchronize()
        _cuda.launches.reset()
        run_text(small, out=out, device=device)
        torch.cuda.synchronize()
        if device == "cuda":
            # `tpu_fused on` in f64 prints the reference statistics, as
            # the JAX package does: the scans of csrc/stats_ref.cu
            ref_counts = stat_scan_counts()
        logs[device] = stat_floats(out.getvalue())
    if logs["cuda"].numel() != logs["cpu"].numel() or not torch.allclose(
            logs["cuda"], logs["cpu"], rtol=1e-9, atol=1e-11):
        raise AssertionError("LC 16x16x32 f64: the card's statistics differ "
                             "from the CPU twins'")
    # three blocks (t = 0, 2, 4): [rho], the momentum and five Q lines
    want = {"seq_sum": 0, "field_stats_ref": 15, "rho_stats_ref": 3,
            "momentum_total_ref": 3}
    if ref_counts != want:
        raise AssertionError(f"LC f64 reference statistics: scans "
                             f"{ref_counts}, want {want}")
    print(f"LC 16x16x32 f64 on the card: reference-statistics scans "
          f"{ref_counts}")
    print(f"LC 16x16x32 f64, 4 cycles: {logs['cuda'].numel()} statistics "
          "floats on the card agree with the CPU twins' (rtol 1e-9, atol "
          f"1e-11), max |diff| "
          f"{float((logs['cuda'] - logs['cpu']).abs().max()):.3e}")
    counts = {}
    for size in (MAIN_SIZE, (128, 128, 128)):
        nsite = size[0] * size[1] * size[2]
        torch.cuda.synchronize()
        _cuda.launches.reset()
        log = io.StringIO()
        t0 = time.perf_counter()
        sys_ = run_text(lc_input(size, "float32"), out=log, device="cuda")
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        got = {"lc_q_force_step": _cuda.launches.lc_q_force_step,
               "fused_force_step": _cuda.launches.fused_force_step}
        text = log.getvalue()
        if f"Completed cycle {LC_CYCLES}" not in text:
            raise AssertionError("LC run_text did not complete its cycles")
        if sys_.fused_mode != "lc":
            raise AssertionError(f"fused_mode {sys_.fused_mode}, not lc")
        for name, n in got.items():
            if n != LC_CYCLES:
                raise AssertionError(f"{name} launched {n} times for "
                                     f"{LC_CYCLES} cycles")
        f, q, u = sys_.state
        for name, x, shape in (("f", f, (19,) + size), ("q", q, (5,) + size),
                               ("u", u, (3,) + size)):
            if tuple(x.shape) != shape or x.dtype != torch.float32:
                raise AssertionError(f"{name}: {tuple(x.shape)} {x.dtype}")
            if not torch.isfinite(x).all():
                raise AssertionError(f"{name} is not finite")
        rhos = [float(v) for v in re.findall(r"\[rho\]\s+(\S+)", text)]
        if not all(abs(t - nsite) <= 1e-5 * nsite for t in rhos):
            raise AssertionError(f"[rho] totals {rhos} != {nsite}")
        # the free energy relaxes: [fe] total falls from block to block
        fes = [float(v) for v in re.findall(r"\[fe\]\s+\S+\s+(\S+)", text)]
        if len(fes) != 3 or not fes[0] > fes[1] > fes[2]:
            raise AssertionError(f"[fe] totals {fes} do not fall")
        for line in text.splitlines():
            if line.startswith(("[Qxx]", "[fe]")):
                print(line)
        print(text[text.find("Timer statistics"):].strip())
        print(f"LC run_text {size} x {LC_CYCLES} cycles: {cli_s:.2f} s wall "
              f"(O8M init on the host included), [rho] totals {rhos}, [fe] "
              f"totals {fes}, launches {got}")
        if size == MAIN_SIZE:
            counts = got
    return counts, ref_counts


K1_LIBS = {_cuda.BINARY_KERNEL: (_cuda.BINARY_LIB, "binary_phi_force_kernel"),
           _cuda.LC_KERNEL: (_cuda.LC_LIB, "lc_q_force_kernel"),
           _cuda.DROPLET_KERNEL: (_cuda.DROPLET_LIB, "droplet_kernel")}


def k1_sweep(card, size, x, kernel, ms, ref, run, order=1):
    """K1 at `size`: what ptxas reported of its instances, its time
    against its issue floor and the replaced kernel's (the box kernel,
    or for the binary fluid the thread-per-site kernel), the layout held
    to the card's occupancy count, then each plan of k1_plans held
    bitwise to the default's outputs `ref` (hold_k1_plans) and timed
    (three passes, the median).  Returns the default layout."""
    nsite = size[0] * size[1] * size[2]
    lib, name = K1_LIBS[kernel]
    for line in _cuda.ptxas_lines(_cuda.build((lib,))[lib], (name,)):
        print(f"{kernel} ptxas: {line}")
    lay = _cuda.k1_layout_on(x, kernel, order)
    regs = hold_k1_layout(x, kernel, lay, order)
    floor = k1_floor_ms(kernel, lay, nsite, order)
    if kernel == _cuda.BINARY_KERNEL:
        before, old = "the thread-per-site kernel", BINARY_K1_THREAD_MS
    else:
        before, old = "the box kernel", K1_BOX_MS[(kernel, size[0])]
    print(f"{kernel} {size[0]}^3 on [{lay}], {regs} registers: "
          f"{ms:.4f} ms, issue floor {floor:.4f} ms ("
          f"{_cuda.k1_site_ops(kernel, lay.evals_per_site, order):.0f} "
          f"generated operations a site at {_cuda.K1_ISSUE_RATE / 1e12:.1f} "
          f"T/s), {100 * floor / ms:.1f}% of it; {before} {old:.4f} ms, "
          f"this one {100 * (ms / old - 1):+.1f}% [{card}]")
    hold_k1_plans(f"{kernel} {size}", run, x, kernel, ref, order)
    for plan in k1_plans(kernel, x.dtype):
        p_lay = _cuda.k1_layout_on(x, kernel, order, plan)
        times = sorted(time_ms(lambda: run(plan), 10) for _ in range(3))
        print(f"{kernel} {size[0]}^3 plan {plan}: [{p_lay}] {times[1]:.4f} "
              f"ms (passes {', '.join(f'{t:.4f}' for t in times)}), issue "
              f"floor {k1_floor_ms(kernel, p_lay, nsite, order):.4f} ms "
              f"[{card}]")
    return {"lay": lay}


def phase12(card, gen, copy_ms, copy_bytes):
    phase(f"12 liquid-crystal timing at 128^3 and 256^3 D3Q19 f32 on {card}")
    res = {}
    for size in ((128, 128, 128), MAIN_SIZE):
        lcfg = lc_cfg(size, "float32")
        model, params = lcfg.lb.model, lcfg.lb.collision_params()
        nsite = size[0] * size[1] * size[2]
        q, u = rand_q_u(size, torch.float32, gen, u_amp=1e-3)
        f0 = rand_state(lcfg.lb, gen, amp=0.01)
        frc = (1e-5 * torch.randn((3,) + size, generator=gen,
                                  device="cuda")).contiguous()

        def report(name, ms, plain_ms, nbytes, nops, err):
            b_ms, b_by = bound(nbytes, nops)
            copy_b = copy_ms * nbytes / copy_bytes
            print(f"{name} {size[0]}^3: kernel {ms:.4f} ms, twin "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                  f"{nbytes / nsite:.0f} B/site, {nops / nsite:.0f} "
                  f"flop/site), {100 * b_ms / ms:.1f}% of it; copy bound "
                  f"{copy_b:.4f} ms; max_abs_err vs twin {err:.3e} [{card}]")
            return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                        nbytes=nbytes, nops=nops)

        # K1: reads q5 and u, writes q5' and the force: 16 values a site
        k1 = lambda: fl.lc_q_force_step(q, u, lcfg.fe, LC_GAMMA)  # noqa
        t1 = lambda: fl._lc_q_force_plain(q, u, lcfg.fe, LC_GAMMA)  # noqa
        a, b = k1(), t1()
        err = max(check_close(f"lc_q_force_step {size} {n}", x, y,
                              torch.float32)
                  for n, x, y in zip(("q", "force"), a, b))
        inc_err, inc_rel = check_increment(
            f"lc_q_force_step {size} q' - q", q, a[0], b[0])
        print(f"lc_q_force_step (K1) {size[0]}^3: increment q' - q within "
              f"{inc_err:.3e} of the twin's, {inc_rel:.3e} of its largest "
              "(tolerance: one ulp of the largest |q'|)")
        r1 = report("lc_q_force_step (K1)", time_ms(k1, 20),
                    time_ms(t1, 2, warm=1), 16 * 4 * nsite,
                    nsite * _cuda.site_ops("lc_q_force_step"), err)
        print(f"lc_q_force_step (K1) {size[0]}^3 under load: {clocks_line()}")
        r1.update(k1_sweep(card, size, q, _cuda.LC_KERNEL, r1["ms"], a,
                           lambda plan: _cuda.lc_q_force_step(  # noqa
                               q, u, lcfg.fe, LC_GAMMA, plan=plan)))
        del a, b
        k2 = lambda: fused.fused_force_step(f0, frc, model, params)  # noqa
        t2 = lambda: fused._fused_force_step_plain(f0, frc, model,  # noqa
                                                   params)
        err = max(check_close(f"fused_force_step {size} {n}", x, y,
                              torch.float32)
                  for n, x, y in zip(("f", "u"), k2(), t2()))
        r2 = report("fused_force_step (K2, D3Q19 M10)", time_ms(k2, 20),
                    time_ms(t2, 3, warm=1), 2 * (19 + 3) * 4 * nsite,
                    nsite * _cuda.site_ops("fused_force_step"), err)
        step = fl.make_fused_lc_step(lcfg)
        state = (f0, q, u)
        step_ms = time_ms(lambda: step(state), 20)
        twin_ms = time_ms(lambda: lc_twin_step(state, lcfg), 2, warm=1)
        report("fused LC step (K1 + K2, two-pass bound)", step_ms, twin_ms,
               r1["nbytes"] + r2["nbytes"], r1["nops"] + r2["nops"],
               max(r1["max_abs_err"], r2["max_abs_err"]))
        print(f"fused LC step {size[0]}^3: {nsite / (step_ms * 1e3):.1f} "
              f"MLUPS [{card}]")
        if size == MAIN_SIZE:
            res["lc_q_force_step"] = r1
    return res


# the JAX package's droplet input (tests/test_ludwig_run.py:165-192)
DROP_SYMM = SymmetricFE(a=-0.0625, b=0.0625, kappa=0.053)
DROP_LC = dict(a0=0.1, gamma=3.0, q0=0.19635, kappa0=0.01, kappa1=0.01,
               xi=0.7)
DROP = dict(gamma0=2.586, delta=0.25)
DROP_MOBILITY, DROP_GAMMA = 0.05, 0.5
DROP_SIZE = (128, 128, 128)
DROP_CYCLES = 20
DROP_INPUT = f"""
tpu_fused on
N_cycles {DROP_CYCLES}
viscosity 0.5
free_energy lc_droplet
fd_gradient_calculation 3d_7pt_fluid
fd_advection_scheme_order 1
A {DROP_SYMM.a}
B {DROP_SYMM.b}
K {DROP_SYMM.kappa}
phi_initialisation spinodal
phi0 0.0
random_seed 8361235
mobility {DROP_MOBILITY}
lc_a0 {DROP_LC['a0']}
lc_gamma {DROP_LC['gamma']}
lc_q0 {DROP_LC['q0']}
lc_kappa0 {DROP_LC['kappa0']}
lc_kappa1 {DROP_LC['kappa1']}
lc_xi {DROP_LC['xi']}
lc_Gamma {DROP_GAMMA}
lc_q_initialisation random
lc_q_init_amplitude 0.2
lc_droplet_gamma {DROP['gamma0']}
lc_droplet_delta {DROP['delta']}
lc_droplet_W 0.0
freq_statistics 10
"""


def drop_fe(w=0.0):
    return LCDropletFE(symm=DROP_SYMM, lc=BluePhaseFE(**DROP_LC), w=w,
                       **DROP)


def drop_input(size, dtype):
    return (f"size {size[0]}_{size[1]}_{size[2]}\ndtype {dtype}\n"
            + DROP_INPUT)


def rand_drop(size, dtype, gen, u_amp=0.01):
    """A noisy phi of both signs, a random Q of amplitude ~0.1 and a
    velocity of both signs so that both upwind branches occur."""
    def rnd(shape, amp):
        return (amp * torch.randn(shape, generator=gen, dtype=dtype,
                                  device="cuda")).contiguous()
    return rnd(size, 0.05), rnd((5,) + size, 0.1), rnd((3,) + size, u_amp)


def drop_cfg(size, dtype, order=1, w=0.0):
    from ludwig_tpu_torch.lc_droplet import LCDropletConfig
    lb = LBConfig(size=size, nvel=19, eta_shear=0.5, dtype=dtype,
                  device="cuda")
    return LCDropletConfig(lb=lb, fe=drop_fe(w), mobility=DROP_MOBILITY,
                           gamma=DROP_GAMMA, advection_order=order)


def drop_twin_step(state, dcfg):
    f, phi, q, u = state
    phi, q, frc = fd._droplet_plain(phi, q, u, dcfg.fe, dcfg.gamma,
                                    dcfg.mobility, dcfg.advection_order)
    f, u = fused._fused_force_step_plain(f, fd.correct_momentum(frc),
                                         dcfg.lb.model,
                                         dcfg.lb.collision_params())
    return (f, phi, q, u)


def phase13(gen):
    phase("13 LC-droplet kernel vs plain twin")
    worst = 0.0
    for size in K1_SHAPES:
        for dtype in (torch.float64, torch.float32):
            phi, q, u = rand_drop(size, dtype, gen)
            for order in (1, 2):
                lay = _cuda.k1_layout_on(phi, _cuda.DROPLET_KERNEL, order)
                regs = hold_k1_layout(phi, _cuda.DROPLET_KERNEL, lay, order)
                print(f"droplet_phi_q_force_step {size} {dtype} order "
                      f"{order} layout [{lay}], {regs} registers")
                for w in (0.0, 0.02):
                    fe = drop_fe(w)
                    args = (phi, q, u, fe, DROP_GAMMA, DROP_MOBILITY, order)
                    a = fd.droplet_phi_q_force_step(*args)
                    b = fd._droplet_plain(*args)
                    what = f"droplet {size} {dtype} order {order} W {w}"
                    errs = [check_close(f"{what} {name}", x, y, dtype)
                            for name, x, y in zip(("phi", "q", "force"), a,
                                                  b)]
                    worst = max(worst, *errs)
                    incs = [check_increment(f"{what} {name}' - {name}", x0,
                                            x, y)
                            for name, x0, x, y in zip(("phi", "q"),
                                                      (phi, q), a, b)]
                    print(f"droplet_phi_q_force_step {size} {dtype} order "
                          f"{order} W {w} max_abs_err phi {errs[0]:.3e} q "
                          f"{errs[1]:.3e} force {errs[2]:.3e} bitwise "
                          f"{[torch.equal(x, y) for x, y in zip(a, b)]} "
                          f"(tolerance {TOL[dtype]}); increments phi' - phi "
                          f"within {incs[0][0]:.3e} ({incs[0][1]:.3e} of "
                          f"its largest), q' - q within {incs[1][0]:.3e} "
                          f"({incs[1][1]:.3e}) (tolerance: one ulp of the "
                          "largest value)")
                    if size == K1_RAGGED and w:
                        hold_k1_plans(
                            f"droplet {size} {dtype} order {order} W {w}",
                            lambda plan: _cuda.droplet_phi_q_force_step(
                                *args, plan=plan), phi,  # noqa
                            _cuda.DROPLET_KERNEL, a, order)
    # whole fused droplet step: 3 chained steps, kernels vs twins
    for size in ((16, 24, 40), (64, 64, 64)):
        for dtype in ("float64", "float32"):
            dcfg = drop_cfg(size, dtype, w=0.02)
            phi0, q0, _u = rand_drop(size, dcfg.lb.tdtype, gen)
            step = fd.make_fused_droplet_step(dcfg)
            a = b = fd.initial_fused_droplet(dcfg, phi0, q0)
            for _ in range(3):
                a = step(a)
                b = drop_twin_step(b, dcfg)
            for name, x, y in zip(("f", "phi", "q", "u"), a, b):
                err = check_close(f"fused droplet step {size} {dtype} "
                                  f"{name}", x, y, dcfg.lb.tdtype)
                print(f"fused droplet step x3 {size} {dtype} {name} "
                      f"max_abs_err {err:.3e} bitwise {torch.equal(x, y)}")
    return {"droplet_phi_q_force_step": worst}


def phase14():
    phase("14 LC-droplet main path: lc_droplet D3Q19 128^3 f32, run_text on "
          "cuda")
    small = drop_input((16, 16, 32), "float64").replace(
        f"N_cycles {DROP_CYCLES}", "N_cycles 4").replace(
        "freq_statistics 10", "freq_statistics 2")
    logs = {}
    for device in ("cuda", "cpu"):
        out = io.StringIO()
        run_text(small, out=out, device=device)
        logs[device] = stat_floats(out.getvalue())
    if logs["cuda"].numel() != logs["cpu"].numel() or not torch.allclose(
            logs["cuda"], logs["cpu"], rtol=1e-9, atol=1e-11):
        raise AssertionError("droplet 16x16x32 f64: the card's statistics "
                             "differ from the CPU twins'")
    print(f"droplet 16x16x32 f64, 4 cycles: {logs['cuda'].numel()} "
          "statistics floats on the card agree with the CPU twins' (rtol "
          "1e-9, atol 1e-11), max |diff| "
          f"{float((logs['cuda'] - logs['cpu']).abs().max()):.3e}")
    size = DROP_SIZE
    nsite = size[0] * size[1] * size[2]
    torch.cuda.synchronize()
    _cuda.launches.reset()
    log = io.StringIO()
    t0 = time.perf_counter()
    sys_ = run_text(drop_input(size, "float32"), out=log, device="cuda")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = {"droplet_phi_q_force_step":
              _cuda.launches.droplet_phi_q_force_step,
              "fused_force_step": _cuda.launches.fused_force_step}
    text = log.getvalue()
    if f"Completed cycle {DROP_CYCLES}" not in text:
        raise AssertionError("droplet run_text did not complete its cycles")
    if sys_.fused_mode != "droplet":
        raise AssertionError(f"fused_mode {sys_.fused_mode}, not droplet")
    for name, n in counts.items():
        if n != DROP_CYCLES:
            raise AssertionError(f"{name} launched {n} times for "
                                 f"{DROP_CYCLES} cycles")
    f, phi, q, u = sys_.state
    for name, x, shape in (("f", f, (19,) + size), ("phi", phi, size),
                           ("q", q, (5,) + size), ("u", u, (3,) + size)):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise AssertionError(f"{name}: {tuple(x.shape)} {x.dtype}")
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name} is not finite")
    # [phi] total: conserved by the flux form; f32 rounds each site's
    # update, the printed sums are f32 reductions.  Bound: 1e-7 of the
    # total |phi|.
    phis = [float(v) for v in re.findall(r"\[phi\]\s+(\S+)", text)]
    scale = 1e-7 * float(phi.double().abs().sum())
    if len(phis) != 3 or max(phis) - min(phis) > scale:
        raise AssertionError(f"[phi] totals {phis} not conserved within "
                             f"{scale:.3e}")
    rhos = [float(v) for v in re.findall(r"\[rho\]\s+(\S+)", text)]
    if not all(abs(t - nsite) <= 1e-5 * nsite for t in rhos):
        raise AssertionError(f"[rho] totals {rhos} != {nsite}")
    feds = [float(v) for v in re.findall(r"\[fed\]\s+\S+\s+(\S+)", text)]
    if len(feds) != 3:
        raise AssertionError(f"want 3 [fed] blocks: {feds}")
    for line in text.splitlines():
        if line.startswith(("[phi]", "[Qxx]", "[fed]")):
            print(line)
    print(text[text.find("Timer statistics"):].strip())
    print(f"droplet run_text {size} x {DROP_CYCLES} cycles: {cli_s:.2f} s "
          f"wall (spinodal and random Q made on the host included), [phi] "
          f"totals {phis} (spread {max(phis) - min(phis):.3e} <= "
          f"{scale:.3e}), [rho] totals {rhos}, [fed] {feds}, launches "
          f"{counts}")
    return counts


def phase15(card, gen, copy_ms, copy_bytes):
    phase(f"15 LC-droplet timing at 128^3 and 256^3 D3Q19 f32 on {card}")
    res = {}
    for size in (DROP_SIZE, MAIN_SIZE):
        dcfg = drop_cfg(size, "float32")
        model, params = dcfg.lb.model, dcfg.lb.collision_params()
        nsite = size[0] * size[1] * size[2]
        phi, q, u = rand_drop(size, torch.float32, gen, u_amp=1e-3)
        f0 = rand_state(dcfg.lb, gen, amp=0.01)
        frc = (1e-5 * torch.randn((3,) + size, generator=gen,
                                  device="cuda")).contiguous()

        def report(name, ms, plain_ms, nbytes, nops, err):
            b_ms, b_by = bound(nbytes, nops)
            copy_b = copy_ms * nbytes / copy_bytes
            print(f"{name} {size[0]}^3: kernel {ms:.4f} ms, twin "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                  f"{nbytes / nsite:.0f} B/site, {nops / nsite:.0f} "
                  f"flop/site), {100 * b_ms / ms:.1f}% of it; copy bound "
                  f"{copy_b:.4f} ms; max_abs_err vs twin {err:.3e} [{card}]")
            return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                        nbytes=nbytes, nops=nops)

        # K1: reads phi, q5 and u, writes phi', q5' and the force: 18
        # values a site
        args = (phi, q, u, dcfg.fe, DROP_GAMMA, DROP_MOBILITY, 1)
        k1 = lambda: fd.droplet_phi_q_force_step(*args)  # noqa
        t1 = lambda: fd._droplet_plain(*args)  # noqa
        a, b = k1(), t1()
        err = max(check_close(f"droplet_phi_q_force_step {size} {n}", x, y,
                              torch.float32)
                  for n, x, y in zip(("phi", "q", "force"), a, b))
        for n, x0, x, y in zip(("phi", "q"), (phi, q), a, b):
            inc_err, inc_rel = check_increment(
                f"droplet_phi_q_force_step {size} {n}' - {n}", x0, x, y)
            print(f"droplet_phi_q_force_step (K1) {size[0]}^3: increment "
                  f"{n}' - {n} within {inc_err:.3e} of the twin's, "
                  f"{inc_rel:.3e} of its largest (tolerance: one ulp of the "
                  "largest value)")
        raw = a[2]
        r1 = report("droplet_phi_q_force_step (K1, order 1)",
                    time_ms(k1, 20), time_ms(t1, 2, warm=1), 18 * 4 * nsite,
                    nsite * _cuda.site_ops("droplet_phi_q_force_step",
                                           order=1), err)
        print(f"droplet_phi_q_force_step (K1) {size[0]}^3 under load: "
              f"{clocks_line()}")
        r1.update(k1_sweep(card, size, phi, _cuda.DROPLET_KERNEL, r1["ms"],
                           a, lambda plan: _cuda.droplet_phi_q_force_step(
                               *args, plan=plan)))  # noqa
        del a, b
        # order 2 on the default layout, for the record
        args2 = args[:-1] + (2,)
        ms2 = time_ms(lambda: fd.droplet_phi_q_force_step(*args2), 20)
        print(f"droplet_phi_q_force_step (K1, order 2) {size[0]}^3: kernel "
              f"{ms2:.4f} ms, issue floor "
              f"{k1_floor_ms(_cuda.DROPLET_KERNEL, r1['lay'], nsite, 2):.4f}"
              f" ms [{card}]")
        # the mean subtraction, plain PyTorch: the bound reads the force
        # once and writes it once (the two-pass form moves 36 B a site)
        mean_ms = time_ms(lambda: fd.correct_momentum(raw), 20)
        rm = report("momentum correction (force - mean, PyTorch)", mean_ms,
                    mean_ms, 6 * 4 * nsite, 2 * 3 * nsite, 0.0)
        k2 = lambda: fused.fused_force_step(f0, frc, model, params)  # noqa
        t2 = lambda: fused._fused_force_step_plain(f0, frc, model,  # noqa
                                                   params)
        err = max(check_close(f"fused_force_step {size} {n}", x, y,
                              torch.float32)
                  for n, x, y in zip(("f", "u"), k2(), t2()))
        r2 = report("fused_force_step (K2, D3Q19 M10)", time_ms(k2, 20),
                    time_ms(t2, 3, warm=1), 2 * (19 + 3) * 4 * nsite,
                    nsite * _cuda.site_ops("fused_force_step"), err)
        step = fd.make_fused_droplet_step(dcfg)
        state = (f0, phi, q, u)
        step_ms = time_ms(lambda: step(state), 20)
        twin_ms = time_ms(lambda: drop_twin_step(state, dcfg), 2, warm=1)
        report("fused droplet step (K1 + mean + K2; two-pass bound K1 + K2)",
               step_ms, twin_ms, r1["nbytes"] + r2["nbytes"],
               r1["nops"] + r2["nops"],
               max(r1["max_abs_err"], r2["max_abs_err"]))
        print(f"fused droplet step {size[0]}^3: "
              f"{nsite / (step_ms * 1e3):.1f} MLUPS; K1 + mean + K2 "
              f"launched alone {r1['ms'] + rm['ms'] + r2['ms']:.4f} ms "
              f"[{card}]")
        if size == DROP_SIZE:
            res["droplet_phi_q_force_step"] = r1
    return res


# the JAX package's Gouy-Chapman bench (perf_bench.py:86-110, shaped like
# the reference's d3q19-elec serial-elec-gc1); no temperature key, so
# beta = 3.0e4
ELEC_EK = dict(valency=(1, -1), diffusivity=(0.01, 0.01), e=1.0, beta=3.0e4,
               epsilon=3.3e3, rel_tol=1e-8, abs_tol=1e-15, max_its=10000,
               solver="sor")
ELEC_RHO_EL, ELEC_SIGMA = 1.04e-3, 3.125e-2
ELEC_SIZE = (128, 128, 128)
ELEC_CYCLES = 20
ELEC_INPUT = f"""
N_cycles {ELEC_CYCLES}
freq_statistics 10
freq_psi_resid 1
viscosity 0.1
free_energy fe_electro
electrokinetics_z0 1
electrokinetics_z1 -1
electrokinetics_d0 0.01
electrokinetics_d1 0.01
electrokinetics_eunit 1.0
electrokinetics_epsilon 3.3e3
electrokinetics_init gouy_chapman
electrokinetics_init_rho_el {ELEC_RHO_EL}
electrokinetics_init_sigma {ELEC_SIGMA}
electrokinetics_solver_type sor
electrokinetics_rel_tol 1e-8
electrokinetics_abs_tol 1e-15
electrokinetics_maxits 10000
electrokinetics_multisteps 1
"""
# what the tests hold the SOR kernel's inputs to (tests/test_fused_electro.py
# :18-33): a loose tolerance, at most 500 iterations
SOR_TEST_EK = dict(valency=(1, -1), diffusivity=(0.01, 0.0095), beta=3.0e-4,
                   epsilon=3.3e3, rel_tol=1e-6, abs_tol=1e-7, max_its=500,
                   solver="sor")
# the JAX tests' shape, an odd X, and the main path's 128^3, where each
# thread of the cooperative SOR grid walks several sites a half-sweep
ELEC_SHAPES = ((16, 16, 128), (15, 16, 32), (64, 64, 64), (128, 128, 128))
SPLIT_ITS = (11, 41)  # iterations of the two solves that split a solve
SOR_SITE_OPS = 16    # 6-neighbour sum, residual, update, res^2 and its sum
NP_SITE_OPS = 120    # force 15, per species 3 faces x ~17 + divergence


def elec_input(size, dtype):
    return (f"size {size[0]}_{size[1]}_{size[2]}\ndtype {dtype}\n"
            + ELEC_INPUT)


def elec_cfg(size, dtype, device="cuda", **ek):
    from ludwig_tpu_torch.electro import ElectroConfig
    from ludwig_tpu_torch.electro_sim import ElectroSimConfig
    lb = LBConfig(size=size, nvel=19, eta_shear=0.1, dtype=dtype,
                  device=device)
    return ElectroSimConfig(lb=lb, ek=ElectroConfig(**(ek or ELEC_EK)))


def elec_state(cfg):
    """The Gouy-Chapman initial state on the configuration's device and
    its wall mask."""
    from ludwig_tpu_torch import electro_sim as es
    psi0, rho0, boundary = es.init_gouy_chapman(cfg.lb.size, ELEC_RHO_EL,
                                                ELEC_SIGMA)
    rho0 = es.electroneutral(rho0, cfg.ek.valency, boundary)
    state = es.initial_electro(cfg, initial_rest(cfg.lb), psi0, rho0)
    return state, torch.as_tensor(boundary, device=cfg.lb.device)


def rand_elec(size, dtype, gen, nk=2):
    """tests/test_fused_electro.py:25-33's kind of fields, on the card,
    with nk species."""
    def rnd(shape, amp, base=0.0, uniform=False):
        x = (torch.rand if uniform else torch.randn)(
            shape, generator=gen, dtype=dtype, device="cuda")
        return (base + amp * x).contiguous()
    fluid = torch.ones(size, dtype=torch.bool, device="cuda")
    fluid[0] = fluid[-1] = False
    return (rnd(size, 1e-3), rnd((nk,) + size, 1e-4, 1e-3, True),
            rnd((3,) + size, 1e-3), fluid)


def within_ulps(a, b, n):
    """|a - b| <= n units in the last place of b, everywhere."""
    spacing = torch.finfo(b.dtype).eps * b.abs().clamp_min(
        torch.finfo(b.dtype).tiny)
    return bool(((a - b).abs() <= n * spacing).all())


def hold_sor(what, k, t, route=None):
    """The SOR kernel's (psi, n, rnorm, which) held to its twin's: in
    float64 the same stop, the same criterion and psi within 1e-12; in
    float32 within 15 iterations and 2e-5 (tests/test_fused_electro.py).
    `route` names the route k was forced to (None: the one the launcher
    picks).  Returns (psi's max_abs_err, the pairs or sites a thread of
    a streaming route walks a half-sweep, 0 on chip)."""
    torch.cuda.synchronize()
    kn, tn, kw, tw = int(k[1]), int(t[1]), int(k[3]), int(t[3])
    err = max_err(k[0], t[0])
    if k[0].dtype == torch.float64:
        ok = kn == tn and kw == tw and err <= 1e-12
    else:
        ok = abs(kn - tn) <= 15 and err <= 2e-5
    lay, grid = _cuda.sor_plan(k[0], route)
    if not ok:
        raise AssertionError(f"sor_solve {what} {lay.route}: n {kn}/{tn} "
                             f"which {kw}/{tw} psi err {err:.3e}")
    work = k[0].numel() // (2 if lay.route == "in-place" else 1)
    walks = (0 if lay.route == "on-chip"
             else -(-work // (grid * _cuda.ELECTRO_THREADS)))
    where = (f"bricks {lay.bx}x{lay.by}x{k[0].shape[2]}, {lay.smem} B"
             if lay.route == "on-chip" else f"{walks} a thread a half-sweep")
    print(f"sor_solve {what} {lay.route} ({grid} blocks, {where}): n {kn} "
          f"(twin {tn}), which {kw} (twin {tw}), rnorm {float(k[2]):.6e} "
          f"(twin {float(t[2]):.6e}), psi max_abs_err {err:.3e} of max|psi| "
          f"{float(t[0].abs().max()):.3e}, bitwise {torch.equal(k[0], t[0])}")
    return err, walks


def hold_np(what, a, b):
    """The NP + grad-mu kernel's (rho', force, fsum) held to its twin's:
    rho' and the raw force within 2 ulp (both call CUDA's exp), fsum
    within 1e-12 (f64) / 1e-6 (f32) of the sum of |force| (a cancelling
    sum in another order).  Returns the max_abs_err of rho' and force."""
    torch.cuda.synchronize()
    f64 = a[0].dtype == torch.float64
    fs_tol = (1e-12 if f64 else 1e-6) * float(b[1].abs().sum())
    fs_err = max_err(a[2], b[2])
    if not (within_ulps(a[0], b[0], 2) and within_ulps(a[1], b[1], 2)
            and fs_err <= fs_tol):
        raise AssertionError(f"np_gradmu {what}: beyond 2 ulp or fsum "
                             f"{fs_err:.3e} > {fs_tol:.3e}")
    err = max(max_err(a[0], b[0]), max_err(a[1], b[1]))
    same = [torch.equal(x, y) for x, y in zip(a[:2], b[:2])]
    print(f"np_gradmu {what}: rho', force bitwise {same} (tolerance 2 ulp),"
          f" max_abs_err {err:.3e}; fsum {fs_err:.3e} (tolerance "
          f"{fs_tol:.3e})")
    return err


def hold_np_layout(psi, nk, hydro, lay):
    """The NP layout's blocks an SM as the card's occupancy query counts
    them, and the kernel's registers; raises where they differ."""
    regs, occ = _cuda.np_occupancy(psi, nk, hydro, lay)
    if occ != lay.blocks_per_sm:
        raise AssertionError(f"np_gradmu {lay}: the card keeps {occ} blocks "
                             f"an SM resident, np_layout counts "
                             f"{lay.blocks_per_sm} ({regs} registers)")
    return regs


def np_raw(cfg):
    """(ez, z, c, kt_e): the NP kernel's per-species constants."""
    ek = cfg.ek
    return ([float(ek.e * v) for v in ek.valency],
            [float(v) for v in ek.valency],
            [-float(d) * 0.5 for d in ek.diffusivity], 1.0 / (ek.beta * ek.e))


def _block_sum_nodes2(v):
    """(sum, sum of squared partial sums) of reduce.cuh's block_sum_all
    over the last axis of v (..., 256): the warp shuffle-down trees, then
    the eight warps' results in order."""
    v = v.reshape(v.shape[:-1] + (8, 32)).clone()
    nodes2 = torch.zeros(v.shape[:-2], dtype=v.dtype, device=v.device)
    o = 16
    while o:
        v[..., :o] += v[..., o:2 * o]
        nodes2 += v[..., :o].square().sum((-1, -2))
        o //= 2
    warps = v[..., 0].cumsum(-1)
    return warps[..., -1], nodes2 + warps[..., 1:].square().sum(-1)


def wall_momentum_exact(fp, solid, model, lam=6.0):
    """(gw, limit): the momentum that the solid collide+stream handed to
    the walls, summed exactly (math.fsum) from its output fp, and per
    axis the rounding limit of fused_force_step_solid_kernel's sum of the
    same terms, both float64.  A fluid site x whose neighbour x + c_q is
    solid holds its bounced value v in fp[anti(q)], and that link gives
    the walls 2 c_q v.  The kernel adds a site's terms, then 256 sites
    a block (block_sum_all), then the block partials, each thread every
    256th in order before a last block_sum_all.  Its error is the sum of
    its partial sums s_k times rounding errors below u = eps / 2; taken
    as independent and of mean zero, it stays under lam u sqrt(sum s_k^2)
    but with probability 2 exp(-lam^2 / 2), 3e-8 at lam 6 (Hoeffding).
    The partial sums are taken from this sum in float64, those inside a
    site at the most that the site's terms can make."""
    import math
    cvs = [tuple(int(c) for c in model.cv[q]) for q in range(model.nvel)]
    fluid = torch.logical_not(solid)
    f64 = dict(dtype=torch.float64, device=fp.device)
    site = torch.zeros((3,) + tuple(solid.shape), **f64)
    size, count = torch.zeros_like(site), torch.zeros_like(site)
    terms = ([], [], [])
    for q, c in enumerate(cvs):
        if not any(c):
            continue
        live = torch.logical_and(
            fluid, torch.roll(solid, shifts=tuple(-k for k in c),
                              dims=(0, 1, 2)))
        v = 2.0 * fp[cvs.index(tuple(-k for k in c))].double() * live
        for ax, k in enumerate(c):
            if k:
                site[ax] += k * v
                size[ax] += v.abs()
                count[ax] += live
                terms[ax].append(k * v[live])
    gw = [math.fsum(torch.cat(t).cpu().tolist()) for t in terms]
    site, size, count = (x.reshape(3, -1) for x in (site, size, count))
    nodes2 = ((count - 1).clamp(min=0) * size.square()).sum(-1)
    nblock = -(-site.shape[1] // 256)
    pad = torch.zeros((3, nblock * 256), **f64)
    pad[:, :site.shape[1]] = site
    part, n2 = _block_sum_nodes2(pad.reshape(3, nblock, 256))
    nodes2 += n2.sum(-1)
    pad = torch.zeros((3, -(-nblock // 256) * 256), **f64)
    pad[:, :nblock] = part
    runs = pad.reshape(3, -1, 256).cumsum(1)   # thread t: every 256th
    nodes2 += runs[:, 1:].square().sum((1, 2))
    nodes2 += _block_sum_nodes2(runs[:, -1])[1]
    u = torch.finfo(fp.dtype).eps / 2.0
    return torch.tensor(gw, **f64), lam * u * nodes2.sqrt()


def hold_k2_solid(what, a, b, model, solid):
    """The solid collide+stream's (f', u, gw) held to its twin's: f' and
    u on fluid sites by check_close, and bitwise in float64; gw, axis by
    axis, to the exact sum of the link terms in the kernel's f' within
    the rounding limit of the kernel's order of summation
    (wall_momentum_exact), and the twin's gw, summed in torch.sum's order,
    printed beside it.  Returns the max_abs_err of f' and u."""
    dtype = a[0].dtype
    fl3 = torch.logical_not(solid)[None]
    err_f = check_close(f"fused_force_step_solid {what} f", a[0], b[0],
                        dtype)
    ua, ub = a[1] * fl3, b[1] * fl3
    err_u = check_close(f"fused_force_step_solid {what} u", ua, ub, dtype)
    if dtype == torch.float64 and not (torch.equal(a[0], b[0])
                                       and torch.equal(ua, ub)):
        raise AssertionError(f"fused_force_step_solid {what}: not bitwise "
                             "its twin")
    ref, tol = wall_momentum_exact(a[0], solid, model)
    err = (a[2].double() - ref).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(
            f"fused_force_step_solid {what} gw {a[2].tolist()} against the "
            f"exact sum {ref.tolist()}: err {err.tolist()} beyond "
            f"{tol.tolist()}")
    twin = (b[2].double() - wall_momentum_exact(b[0], solid, model)[0]).abs()

    def e3(x):
        return [float(f"{v:.3e}") for v in x.tolist()]
    print(f"fused_force_step_solid {what}: f' bitwise "
          f"{torch.equal(a[0], b[0])} (max_abs_err {err_f:.3e}), u on fluid "
          f"sites bitwise {torch.equal(ua, ub)}, gw "
          f"{[round(v, 9) for v in a[2].tolist()]}, exact "
          f"{[round(v, 9) for v in ref.tolist()]}: err {e3(err)}, tolerance "
          f"{e3(tol)}, tolerance / |gw| {e3(tol / ref.abs())}; the twin's "
          f"err {e3(twin)}, kernel - twin {max_err(a[2], b[2]):.3e}")
    return max(err_f, err_u)


def elec_chain_step(state, cfg, solid, sor, npg, k2):
    """One step of the electrokinetic kernel route with the given SOR,
    NP + grad-mu and solid collide+stream functions (kernels or twins):
    electro_sim.make_electro_step's float32 route, written out so that
    the kernels are chained in float64 too (the step takes the reference
    route there) and so that the twins' step can be timed on the card."""
    from ludwig_tpu_torch.electro import rho_elec
    f, psi, rho, u, gwall = state
    fluid = torch.logical_not(solid)
    n_sites = float(psi.numel())
    psi = sor(psi, rho_elec(rho, cfg.ek))[0]
    rho, force, fsum = npg(psi, rho, u, fluid)
    force = force - (fsum / n_sites)[:, None, None, None]
    f, u, gw = k2(f, force, solid)
    return f, psi, rho, u, gwall + gw


def elec_routes(cfg, dt=1.0):
    """{kernel, twin}: the three functions elec_chain_step takes; the SOR
    functions return (psi', n, rnorm, which), the NP ones take a sub-step
    of dt."""
    ek = cfg.ek
    model, params = cfg.lb.model, cfg.lb.collision_params()
    ez, z, c, kt_e = np_raw(cfg)

    def sor_twin(psi, rel):
        X, _Y, Z = psi.shape
        rhs = ((ek.e * ek.beta) * rel).to(psi.dtype).contiguous()
        om = fe._omega_table_on(X, Z, ek.max_its, psi.dtype,
                                str(psi.device))
        return fe._sor_solve_plain(psi, rhs, om, ek.epsilon, ek.rel_tol,
                                   ek.abs_tol, ek.max_its, True)

    return {
        "kernel": (lambda psi, rel: fe.sor_solve_fused(psi, rel, ek),
                   lambda psi, rho, u, fl: fe.np_gradmu_fused(
                       psi, rho, u, fl, cfg, dt),
                   lambda f, force, solid: fused.fused_force_step(
                       f, force, model, params, solid=solid)),
        "twin": (sor_twin,
                 lambda psi, rho, u, fl: fe._np_plain(
                     psi, rho, u, fl, ez, z, c, kt_e, dt),
                 lambda f, force, solid: fused._fused_force_step_plain(
                     f, force, model, params, solid))}


def phase16(gen):
    phase("16 electrokinetic kernels vs plain twins")
    from ludwig_tpu_torch import electro_sim as es
    from ludwig_tpu_torch.electro import rho_elec
    worst = {"sor_solve": 0.0, "np_gradmu": 0.0,
             "fused_force_step_solid": 0.0}
    most_walks = 0
    for size in ELEC_SHAPES:
        for dtype in ("float64", "float32"):
            cfg = elec_cfg(size, dtype, **SOR_TEST_EK)
            psi, rho, u, fluid = rand_elec(size, cfg.lb.tdtype, gen)
            rel = rho_elec(rho, cfg.ek)
            routes = elec_routes(cfg, dt=0.5)
            kern, twin = routes["kernel"], routes["twin"]
            t = twin[0](psi, rel)
            err, walks = hold_sor(f"{size} {dtype}", kern[0](psi, rel), t)
            worst["sor_solve"] = max(worst["sor_solve"], err)
            most_walks = max(most_walks, walks)
            for route in _cuda.sor_routes(psi):
                err, walks = hold_sor(
                    f"{size} {dtype} forced",
                    fe._sor_solve_route(psi, rel, cfg.ek, route), t, route)
                worst["sor_solve"] = max(worst["sor_solve"], err)
                most_walks = max(most_walks, walks)
    # the NP march over NP_SHAPES, 1 to 3 species, with and without
    # advection, each case's layout printed and held to the card's
    # occupancy count
    for size in NP_SHAPES:
        for dtype in ("float64", "float32"):
            for nk, species in NP_SPECIES.items():
                cfg = elec_cfg(size, dtype, **dict(SOR_TEST_EK, **species))
                psi, rho, u, fluid = rand_elec(size, cfg.lb.tdtype, gen, nk)
                routes = elec_routes(cfg, dt=0.5)
                kern, twin = routes["kernel"], routes["twin"]
                for hydro in (True, False):
                    uu = u if hydro else None
                    lay = _cuda.np_layout_on(psi, nk, hydro)
                    regs = hold_np_layout(psi, nk, hydro, lay)
                    err = hold_np(f"{size} {dtype} nk {nk} hydro {hydro} "
                                  f"[{lay}], {regs} registers",
                                  kern[1](psi, rho, uu, fluid),
                                  twin[1](psi, rho, uu, fluid))
                    worst["np_gradmu"] = max(worst["np_gradmu"], err)
    # the grid-stride walk, whose coordinates step with carries, is held
    # only where a thread takes more than one site (or pair)
    if most_walks < 2:
        raise AssertionError("no SOR check walked more than one site a "
                             "thread")
    # K2 solid: D3Q19 M10 with the Gouy-Chapman walls and an obstacle
    for size in ELEC_SHAPES:
        for dtype in ("float64", "float32"):
            lb = LBConfig(size=size, nvel=19, eta_shear=0.1, dtype=dtype,
                          device="cuda")
            model, params = lb.model, lb.collision_params()
            f0 = rand_state(lb, gen)
            frc = (1e-4 * torch.randn((3,) + size, generator=gen,
                                      dtype=lb.tdtype, device="cuda")
                   ).contiguous()
            solid = torch.zeros(size, dtype=torch.bool, device="cuda")
            solid[0] = solid[-1] = True
            solid[size[0] // 2, 3:6, size[2] // 4:size[2] // 2] = True
            err = hold_k2_solid(
                f"{size} {dtype}",
                fused.fused_force_step(f0, frc, model, params, solid=solid),
                fused._fused_force_step_plain(f0, frc, model, params, solid),
                model, solid)
            worst["fused_force_step_solid"] = max(
                worst["fused_force_step_solid"], err)
    # three chained electrokinetic steps: in float32 the step the CLI runs
    # on the card (kernels) against the same step on the CPU (twins); in
    # float64, where the step takes the reference route, the kernels
    # chained by hand against the twins
    tol = {"float64": {"f": 1e-13, "psi": 1e-12, "rho": 1e-14, "u": 1e-13},
           "float32": {"f": 1e-6, "psi": 2e-5, "rho": 1e-8, "u": 1e-6}}
    size = (32, 16, 64)
    for dtype in ("float64", "float32"):
        cfg = elec_cfg(size, dtype)
        a, solid = elec_state(cfg)
        if dtype == "float32":
            cfg_cpu = elec_cfg(size, dtype, device="cpu")
            b, solid_cpu = elec_state(cfg_cpu)
            step_a = es.make_electro_step(cfg, solid=solid)
            step_b = es.make_electro_step(cfg_cpu, solid=solid_cpu)
            for t in range(3):
                a = step_a(a, t)[0]
                b = step_b(b, t)[0]
            b = tuple(x.to("cuda") for x in b)
            how = "make_electro_step on cuda vs on the CPU"
        else:
            routes = elec_routes(cfg)
            b = a
            for _ in range(3):
                a = elec_chain_step(a, cfg, solid, *routes["kernel"])
                b = elec_chain_step(b, cfg, solid, *routes["twin"])
            how = "kernels vs twins"
        torch.cuda.synchronize()
        fl3 = torch.logical_not(solid)[None]
        for name, x, y in zip(("f", "psi", "rho", "u", "gwall"), a, b):
            if name == "u":
                x, y = x * fl3, y * fl3
            err = max_err(x, y)
            # gwall sums ~1e4 link terms of ~1/18 over the two walls, which
            # cancel: 1e-14 (f64) / 1e-6 (f32) of the terms' total
            links = 3 * 2 * 5 * size[1] * size[2] * 2.0 / 18.0
            bound = (tol[dtype][name] if name != "gwall" else
                     (1e-14 if dtype == "float64" else 1e-6) * links)
            if not err <= bound:
                raise AssertionError(f"electro step x3 {dtype} {name}: "
                                     f"{err:.3e} > {bound:.3e}")
            print(f"electro step x3 {size} {dtype} ({how}) {name} "
                  f"max_abs_err {err:.3e} (tolerance {bound:.3e}) bitwise "
                  f"{torch.equal(x, y)}")
    return worst


def phase17():
    phase("17 electrokinetic main path: fe_electro Gouy-Chapman D3Q19 128^3 "
          "f32, run_text on cuda")
    small = elec_input((16, 8, 8), "float64").replace(
        f"N_cycles {ELEC_CYCLES}", "N_cycles 4").replace(
        "freq_statistics 10", "freq_statistics 2")
    logs, sors = {}, {}
    tags = ("[rho]", "[psi]", "[elc]", "[fed]", "[total", "[fluid", "[walls",
            "[minimum", "[maximum")
    for device in ("cuda", "cpu"):
        out = io.StringIO()
        run_text(small, out=out, device=device)
        text = out.getvalue()
        sors[device] = re.findall(r"converged to (\w+) tolerance\nSOR "
                                  r"residual\s+\S+ at (\d+) iterations", text)
        vals, loose = [], []
        for line in text.splitlines():
            if line.startswith(tags):
                nums = [float(t) for t in line.split()
                        if re.match(r"^-?\d", t)]
                vals += nums
                loose += [line.startswith(("[psi]", "[elc]")) and i == 0
                          for i in range(len(nums))]
        logs[device] = (torch.tensor(vals, dtype=torch.float64),
                        torch.tensor(loose))
    (a, loose), (b, _) = logs["cuda"], logs["cpu"]
    # the [psi] and [elc] totals cancel to ~0: 1e-12 x sites x max|value|
    scale = 1e-12 * 16 * 8 * 8 * float(b.abs().max())
    if (a.numel() != b.numel() or sors["cuda"] != sors["cpu"]
            or not torch.allclose(a[~loose], b[~loose], rtol=1e-9,
                                  atol=1e-11)
            or not torch.allclose(a[loose], b[loose], rtol=0, atol=scale)):
        raise AssertionError("electro 16x8x8 f64: the card's log differs "
                             "from the CPU's")
    print(f"electro 16x8x8 f64 (reference route), 4 cycles: {a.numel()} "
          "statistics floats on the card agree with the CPU's (rtol 1e-9, "
          f"atol 1e-11; [psi]/[elc] totals atol {scale:.3e}), max |diff| "
          f"{float((a - b).abs().max()):.3e}; SOR reports {sors['cuda']} "
          "equal")
    size = ELEC_SIZE
    torch.cuda.synchronize()
    _cuda.launches.reset()
    log = io.StringIO()
    t0 = time.perf_counter()
    sys_ = run_text(elec_input(size, "float32"), out=log, device="cuda")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = {"sor_solve": _cuda.launches.sor_solve,
              "np_gradmu": _cuda.launches.np_gradmu,
              "fused_force_step_solid": _cuda.launches.fused_force_step_solid}
    scans = stat_scan_counts()
    text = log.getvalue()
    if f"Completed cycle {ELEC_CYCLES}" not in text or not sys_.is_electro:
        raise AssertionError("electro run_text did not complete its cycles")
    for name, n in counts.items():
        if n != ELEC_CYCLES:
            raise AssertionError(f"{name} launched {n} times for "
                                 f"{ELEC_CYCLES} cycles")
    # an electrokinetic run prints the reference statistics: per block
    # [rho] and the momentum once, seq_sum for [psi], two [rho], [elc]
    nblocks = ELEC_CYCLES // 10 + 1
    want = {"seq_sum": 4 * nblocks, "field_stats_ref": 0,
            "rho_stats_ref": nblocks, "momentum_total_ref": nblocks}
    if scans != want:
        raise AssertionError(f"statistics scans {scans}, want {want}")
    counts.update(scans)
    f, psi, rho, u, gwall = sys_.state
    for name, x, shape in (("f", f, (19,) + size), ("psi", psi, size),
                           ("rho", rho, (2,) + size), ("u", u, (3,) + size),
                           ("gwall", gwall, (3,))):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise AssertionError(f"{name}: {tuple(x.shape)} {x.dtype}")
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name} is not finite")
    # each species' total is conserved by the flux form (f32 rounding of
    # the site updates: 1e-6 of the total); the net charge stays ~0 (1e-6
    # of the species' totals).  Both summed in f64 from the initial and
    # the final state: the log prints them as the JAX package's reference
    # statistics do, site-order f32 sums (seq_sum), whose rounding over
    # 2M sites is ~1e-2 of the total; the last block's lines must be
    # those sums of the final state, digit for digit
    from ludwig_tpu_torch import stats
    from ludwig_tpu_torch.electro import rho_elec
    from ludwig_tpu_torch.ludwig import build_system
    from ludwig_tpu_torch.runtime import RunTime
    rho0 = build_system(RunTime(elec_input(size, "float32")),
                        device="cuda").state[2]
    totals = [[float(r[k].double().sum()) for r in (rho0, rho)]
              for k in range(2)]
    for k, tk in enumerate(totals):
        if abs(tk[1] - tk[0]) > 1e-6 * abs(tk[0]):
            raise AssertionError(f"species {k} totals {tk} not conserved")
    net = float(rho_elec(rho.double(), sys_.electro_cfg.ek).sum())
    if abs(net) > 1e-6 * (totals[0][1] + totals[1][1]):
        raise AssertionError(f"net charge {net} not ~0")
    species = re.findall(r"\[rho\]\s+(\S+)\s+\S+\s+\S+\n", text)
    elc = re.findall(r"\[elc\]\s+(\S+)", text)
    printed = species[-2:] + elc[-1:]
    want = [f"{float(stats.seq_sum(x)):14.7e}".strip()
            for x in (rho[0], rho[1], rho_elec(rho, sys_.electro_cfg.ek))]
    if len(species) != 6 or printed != want:
        raise AssertionError(f"last [rho]/[elc] totals {printed}, the "
                             f"site-order sums of the state {want}")
    iters = [int(v) for v in re.findall(r"at (\d+) iterations", text)]
    if len(iters) != ELEC_CYCLES:
        raise AssertionError(f"{len(iters)} SOR reports for {ELEC_CYCLES} "
                             "cycles")
    for line in text.splitlines():
        if line.startswith(("[psi]", "[elc]", "[walls")):
            print(line)
    print(text[text.find("Timer statistics"):].strip())
    print(f"electro run_text {size} x {ELEC_CYCLES} cycles: {cli_s:.2f} s "
          f"wall (an SOR report and its read-back every cycle), SOR "
          f"iterations per cycle {iters}, species totals (f64 sums, "
          f"initial and final) {totals}, net charge {net:.3e}, printed "
          f"[rho] totals {species}, [elc] {elc}, launches {counts}")
    return counts, iters


def sor_split(card, size, gen):
    """Each SOR route's fixed cost and cost an iteration at `size` f32,
    from solves of a random field capped at SPLIT_ITS[0] and SPLIT_ITS[1]
    iterations.  A tolerance of 0 never stops them, and the residual of
    a random field falls steadily, so the f32 stall guard does not (from
    the main path's warm start it stops every solve after 10-11
    iterations)."""
    from ludwig_tpu_torch.electro import ElectroConfig, rho_elec
    psi, rho, _u, _fluid = rand_elec(size, torch.float32, gen)
    for route in _cuda.sor_routes(psi):
        split = []
        for its in SPLIT_ITS:
            ek = ElectroConfig(**dict(SOR_TEST_EK, rel_tol=0.0, abs_tol=0.0,
                                      max_its=its))
            rel = rho_elec(rho, ek)
            ran = int(fe._sor_solve_route(psi, rel, ek, route)[1]) + 1
            split.append((ran, time_ms(
                lambda: fe._sor_solve_route(psi, rel, ek, route), 10)))
        (n0, ms0), (n1, ms1) = split
        if n1 <= n0:
            raise AssertionError(f"sor_solve {route}: the stall guard "
                                 f"stopped both solves at {n0}")
        per_it = (ms1 - ms0) / (n1 - n0)
        print(f"sor_solve ({route}) {size[0]}^3 random field: {ms0:.4f} ms "
              f"for {n0} iterations, {ms1:.4f} ms for {n1}: {per_it:.5f} ms "
              f"an iteration, {ms0 - n0 * per_it:.4f} ms fixed [{card}]")


def device_ms(run, names, reps=20):
    """{name: ms a launch on the device} of the kernels whose names
    contain one of `names`, from torch.profiler over `reps` calls of
    run(): the card's own time, without the host's (at 128^3 a call's
    host work can outlast its kernels, and CUDA events then time the
    host)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in names:
            if name in e.key and e.count:
                out[name] = e.device_time_total / e.count / 1e3
    return out


def np_sweep(card, size, args, ms, ref):
    """np_gradmu at `size` (args: _cuda.np_gradmu's): its layout held to
    the card's occupancy count, its time against the thread-per-site
    kernel's, its device time (torch.profiler), then each plan of
    NP_PLANS held bitwise to the default's rho' and force `ref` (the
    tiling changes no operation; fsum's order follows the blocks) and
    timed (three passes, the median).  Returns the default layout and
    the device time of the kernel and of the sum of its partials."""
    psi, rho, u = args[:3]
    nk = rho.shape[0]
    lay = _cuda.np_layout_on(psi, nk, u is not None)
    regs = hold_np_layout(psi, nk, u is not None, lay)
    old = NP_THREAD_MS[size[0]]
    print(f"np_gradmu {size[0]}^3 on [{lay}], {regs} registers: {ms:.4f} "
          f"ms; the thread-per-site kernel {old:.4f} ms, this one "
          f"{100 * (ms / old - 1):+.1f}% [{card}]")
    dev = device_ms(lambda: _cuda.np_gradmu(*args),
                    ("np_gradmu_kernel", "reduce_partials_kernel"))
    if len(dev) == 2:
        print(f"np_gradmu {size[0]}^3 on the device (torch.profiler, 20 "
              f"calls): the march {dev['np_gradmu_kernel']:.4f} ms, the sum "
              f"of its partials {dev['reduce_partials_kernel']:.4f} ms "
              f"[{card}]")
    else:
        print(f"np_gradmu {size[0]}^3 device time: not measured (the "
              f"profiler saw {sorted(dev)})")
    for plan in NP_PLANS:
        p_lay = _cuda.np_layout_on(psi, nk, u is not None, plan)
        hold_np_layout(psi, nk, u is not None, p_lay)
        got = _cuda.np_gradmu(*args, plan=plan)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got[:2], ref[:2])):
            raise AssertionError(f"np_gradmu {size} on {p_lay}: rho' or the "
                                 "force not bitwise the default layout's")
        times = sorted(time_ms(lambda: _cuda.np_gradmu(*args, plan=plan), 10)
                       for _ in range(3))
        print(f"np_gradmu {size[0]}^3 plan {plan}: [{p_lay}] bitwise the "
              f"default's, {times[1]:.4f} ms (passes "
              f"{', '.join(f'{t:.4f}' for t in times)}) [{card}]")
    out = {"lay": lay}
    if len(dev) == 2:
        out["device_ms"] = sum(dev.values())
    return out


def phase18(card, gen, copy_ms, copy_bytes):
    phase(f"18 electrokinetic kernels held and timed at 128^3 and 256^3 "
          f"D3Q19 f32 on {card}")
    from ludwig_tpu_torch import electro_sim as es
    from ludwig_tpu_torch.electro import poisson_fft, rho_elec
    res = {}
    # the launcher goes on chip from SOR_CHIP_MIN_SITES = 64^3 sites on:
    # the routes' costs on each side
    for size in ((48, 48, 48), (64, 64, 64)):
        sor_split(card, size, gen)
    for size in (ELEC_SIZE, MAIN_SIZE):
        cfg = elec_cfg(size, "float32")
        ek = cfg.ek
        model, params = cfg.lb.model, cfg.lb.collision_params()
        nsite = size[0] * size[1] * size[2]
        state, solid = elec_state(cfg)
        # the CLI's step: no collision-time density
        step = es.make_electro_step(cfg, solid=solid, return_rho_lb=False)
        for t in range(2):       # a charged double layer, the fluid moving
            state, _aux = step(state, t)
        f, psi, rho, u, _gw = state
        fluid = torch.logical_not(solid)
        rel = rho_elec(rho, ek)
        routes = elec_routes(cfg)

        def report(name, ms, plain_ms, nbytes, nops, err, extra=""):
            b_ms, b_by = bound(nbytes, nops)
            copy_b = copy_ms * nbytes / copy_bytes
            print(f"{name} {size[0]}^3: kernel {ms:.4f} ms, twin "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                  f"{nbytes / nsite:.1f} B/site, {nops / nsite:.0f} "
                  f"flop/site), {100 * b_ms / ms:.1f}% of it; copy bound "
                  f"{copy_b:.4f} ms; max_abs_err vs twin {err:.3e}{extra} "
                  f"[{card}]")
            return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                        nbytes=nbytes, nops=nops)

        # each kernel held to its twin on the main path's state, by phase
        # 16's rules.  SOR from the state's psi (warm start, as in a step)
        t = routes["twin"][0](psi, rel)
        k = fe.sor_solve_fused(psi, rel, ek)
        err, _walks = hold_sor(f"{size[0]}^3 main-path state", k, t)
        n = int(k[1]) + 1
        sor_ms = time_ms(lambda: fe.sor_solve_fused(psi, rel, ek), 20)
        sor_twin = time_ms(lambda: routes["twin"][0](psi, rel), 2, warm=1)
        # the function reads psi and rhs and writes psi once (12 B/site);
        # an in-place sweep that streams the fields from memory moves 16
        # B/site an iteration (psi read and written, rhs read)
        sweep_ms = n * 1e3 * 16 * nsite / PEAK_BYTES_PER_S
        auto = _cuda.sor_plan(psi)[0].route
        r = report(f"sor_solve ({auto})", sor_ms, sor_twin, 12 * nsite,
                   SOR_SITE_OPS * n * nsite, err,
                   f"; {n} iterations, {sor_ms / n:.4f} ms an iteration, "
                   f"streaming-sweep bound {sweep_ms:.4f} ms")
        for route in _cuda.sor_routes(psi):
            if route == auto:
                continue
            kr = fe._sor_solve_route(psi, rel, ek, route)
            hold_sor(f"{size[0]}^3 main-path state forced", kr, t, route)
            nr = int(kr[1]) + 1
            ms_r = time_ms(lambda: fe._sor_solve_route(psi, rel, ek, route),
                           20)
            print(f"sor_solve ({route}) {size[0]}^3: kernel {ms_r:.4f} ms, "
                  f"{nr} iterations, {ms_r / nr:.4f} ms an iteration "
                  f"[{card}]")
        del t
        sor_split(card, size, gen)
        fft_ms = time_ms(lambda: poisson_fft(rel / ek.e, ek), 20)
        print(f"poisson_fft (torch.fft, context) {size[0]}^3: {fft_ms:.4f} "
              f"ms a solve [{card}]")
        res_size = {"sor_solve": r}
        # NP + grad-mu, the mean subtraction, K2 solid
        a = fe.np_gradmu_fused(psi, rho, u, fluid, cfg, 1.0)
        err = hold_np(f"{size[0]}^3 main-path state hydro True", a,
                      routes["twin"][1](psi, rho, u, fluid))
        res_size["np_gradmu"] = report(
            "np_gradmu (nk = 2, hydrodynamics)",
            time_ms(lambda: fe.np_gradmu_fused(psi, rho, u, fluid, cfg, 1.0),
                    20),
            time_ms(lambda: routes["twin"][1](psi, rho, u, fluid), 3,
                    warm=1), 45 * nsite, NP_SITE_OPS * nsite, err)
        res_size["np_gradmu"].update(np_sweep(
            card, size, (psi, rho, u, fluid, *np_raw(cfg), 1.0),
            res_size["np_gradmu"]["ms"], a))
        raw, fsum = a[1], a[2]
        mean_ms = time_ms(lambda: raw - (fsum / float(nsite))[
            :, None, None, None], 20)
        report("momentum correction (force - fsum / nsites, PyTorch)",
               mean_ms, mean_ms, 24 * nsite, 3 * nsite, 0.0)
        frc = (raw - (fsum / float(nsite))[:, None, None, None]).contiguous()
        err = hold_k2_solid(
            f"{size[0]}^3 main-path state",
            fused.fused_force_step(f, frc, model, params, solid=solid),
            fused._fused_force_step_plain(f, frc, model, params, solid),
            model, solid)
        res_size["fused_force_step_solid"] = report(
            "fused_force_step_solid (K2, D3Q19 M10)",
            time_ms(lambda: fused.fused_force_step(f, frc, model, params,
                                                   solid=solid), 20),
            time_ms(lambda: fused._fused_force_step_plain(
                f, frc, model, params, solid), 2, warm=1),
            (2 * (19 + 3) * 4 + 1) * nsite,
            nsite * _cuda.site_ops("fused_force_step"), err)
        del a
        step_ms = time_ms(lambda: step(state), 10)
        twin_ms = time_ms(lambda: elec_chain_step(state, cfg, solid,
                                                  *routes["twin"]), 1, warm=1)
        parts = [res_size[k] for k in ("sor_solve", "np_gradmu",
                                       "fused_force_step_solid")]
        report("electro step (SOR + NP + mean + K2 + PyTorch glue; bound of "
               "the three kernels)", step_ms, twin_ms,
               sum(p["nbytes"] for p in parts), sum(p["nops"] for p in parts),
               max(p["max_abs_err"] for p in parts))
        print(f"electro step {size[0]}^3: {nsite / (step_ms * 1e3):.1f} MLUPS"
              f" [{card}]")
        if size == ELEC_SIZE:
            res.update(res_size)
    return res


STAT_SCANS = ("seq_sum", "field_stats_ref", "rho_stats_ref",
              "momentum_total_ref")


def stat_scan_counts():
    return {name: getattr(_cuda.launches, name) for name in STAT_SCANS}


NOISE_KEYS = """
temperature 0.00002
isothermal_fluctuations on
random_seed 8361235
"""
NOISE_STEP0 = 2 ** 20 + 3      # t * 0x9e3779b9 wraps from t = 2


def noise_params(nvel, scheme, dtype, size=(16, 24, 40), eta_bulk=0.14,
                 force=(1e-4, -2e-4, 5e-5), kt=2e-5):
    """(LBConfig, CollisionParams, FusedNoise) on the card, the noise at
    temperature kt with a seed above 2^31."""
    from ludwig_tpu_torch.noise import var_bulk, var_eta, var_ghost
    cfg = LBConfig(size=size, nvel=nvel, eta_shear=0.1, eta_bulk=eta_bulk,
                   scheme=scheme, dtype=dtype, force_global=force,
                   device="cuda")
    params = cfg.collision_params()
    noise = fused.FusedNoise(
        seed=2 ** 31 + 8361235, v_eta=var_eta(1.0 / params.rtau_shear, kt),
        v_bulk=var_bulk(1.0 / params.rtau_bulk, kt),
        v_ghost=tuple(var_ghost(cfg.model, params.rtau_ghost, kt)))
    return cfg, params, noise


def hold_scans(x, f, model, mask, what):
    """Each reference-statistics scan on the card against its CPU twin on
    the same values: bitwise.  Returns the number of values held."""
    from ludwig_tpu_torch import stats
    xc, fc = x.cpu(), f.cpu()
    mc = None if mask is None else mask.cpu()
    pairs = [("seq_sum", stats.seq_sum(x, mask), stats.seq_sum(xc, mc)),
             ("rho_stats_ref", torch.stack(stats.rho_stats_ref(f, model,
                                                               mask)),
              torch.stack(stats.rho_stats_ref(fc, model, mc))),
             ("momentum_total_ref", stats.momentum_total_ref(f, model, mask),
              stats.momentum_total_ref(fc, model, mc))]
    for klein in ("klein", "kahan", False):
        pairs.append((f"field_stats_ref klein={klein}",
                      torch.stack(stats.field_stats_ref(x, mask, klein)),
                      torch.stack(stats.field_stats_ref(xc, mc, klein))))
    torch.cuda.synchronize()
    for name, a, b in pairs:
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"{name} {what}: the card's {a.tolist()} "
                                 f"is not its twin's {b.tolist()}")
    return len(pairs)


def phase19(gen):
    phase("19 fluctuating kernel and statistics scans vs plain twins")
    worst = 0.0
    for nvel, scheme in ((15, "m10"), (15, "trt"), (19, "m10"), (19, "trt"),
                         (27, "m10")):
        for dtype in ("float64", "float32"):
            cfg, params, noise = noise_params(nvel, RelaxationScheme(scheme),
                                              dtype)
            f0 = rand_state(cfg, gen)
            for delta in (True, False):
                for t0 in (0, NOISE_STEP0):
                    a = b = f0
                    for t in range(t0, t0 + 3):
                        a = fused.fused_step(a, cfg.model, params,
                                             noise=noise, t=t, delta=delta)
                        b = fused._fused_step_plain(b, cfg.model, params,
                                                    delta, noise, t)
                    what = (f"fused_step noise D3Q{nvel} {scheme} {dtype} "
                            f"delta={delta} t={t0}..{t0 + 2}")
                    err = check_close(what, a, b, cfg.tdtype)
                    worst = max(worst, err)
                    print(f"{what} max_abs_err {err:.3e}"
                          + (" bitwise" if torch.equal(a, b) else ""))
    for size in ((16, 16, 32), (64, 64, 64)):
        for dtype in ("float64", "float32"):
            cfg = LBConfig(size=size, nvel=19, dtype=dtype, device="cuda")
            f = rand_state(cfg, gen, amp=1e-3)
            x = torch.randn(size, generator=gen, dtype=cfg.tdtype,
                            device="cuda") * torch.exp(
                8.0 * torch.rand(size, generator=gen, dtype=cfg.tdtype,
                                 device="cuda") - 6.0)
            mask = torch.rand(size, generator=gen, device="cuda") > 0.2
            for m in (None, mask):
                n = hold_scans(x, f, cfg.model, m, f"{size} {dtype} "
                               f"mask={m is not None}")
                print(f"stats scans {size} {dtype} mask={m is not None}: "
                      f"{n} results bitwise their twins")
    return {"fused_step_noise": worst}


def noise_input(size, dtype, fused_req, cycles, freq):
    return (f"size {size[0]}_{size[1]}_{size[2]}\ntpu_fused {fused_req}\n"
            f"dtype {dtype}\nviscosity 0.1\nviscosity_bulk 0.1\n"
            f"N_cycles {cycles}\nfreq_statistics {freq}\n" + NOISE_KEYS)


def phase20():
    phase("20 fluctuating main path: D3Q19 256^3 f32 isothermal "
          "fluctuations, run_text on cuda")
    small_counts = {}
    # (tpu_fused, the noise kernel's launches: the JAX package's gate
    # sends float64 under `on` to the KISS route)
    for fused_req, launched in (("interpret", 6), ("on", 0), ("off", 0)):
        text = noise_input((16, 16, 32), "float64", fused_req, 6, 3)
        logs = {}
        for device in ("cuda", "cpu"):
            out = io.StringIO()
            torch.cuda.synchronize()
            _cuda.launches.reset()
            run_text(text, out=out, device=device)
            torch.cuda.synchronize()
            if device == "cuda":
                got = dict(stat_scan_counts(), fused_step_noise=_cuda.
                           launches.fused_step_noise)
            logs[device] = out.getvalue()
        a, b = stat_floats(logs["cuda"]), stat_floats(logs["cpu"])
        if (a.numel() != b.numel() or logs["cuda"].count("[measd/kT]") != 2
                or not torch.allclose(a, b, rtol=1e-9, atol=1e-11)):
            raise AssertionError(f"noise 16x16x32 f64 tpu_fused {fused_req}:"
                                 " the card's log differs from the CPU's")
        same = [ln for ln in logs["cuda"].splitlines() if ln.startswith("[")
                ] == [ln for ln in logs["cpu"].splitlines()
                      if ln.startswith("[")]
        kernel = got.pop("fused_step_noise")
        if kernel != launched:
            raise AssertionError(f"fused_step_noise launched {kernel} times")
        # the reference statistics on the KISS route: the scans, and the
        # lines the CPU twins print, digit for digit
        scans = 0 if launched else 3
        if got["rho_stats_ref"] != scans or got["momentum_total_ref"] != scans:
            raise AssertionError(f"reference statistics scans {got}")
        if scans and not same:
            raise AssertionError(f"noise 16x16x32 f64 tpu_fused {fused_req}:"
                                 " the card's reference statistics lines "
                                 "are not the CPU's as text")
        small_counts[fused_req] = dict(got, fused_step_noise=kernel)
        print(f"noise 16x16x32 f64 tpu_fused {fused_req}, 6 cycles: "
              f"{a.numel()} statistics floats (kT block included) on the "
              f"card agree with the CPU's (rtol 1e-9, atol 1e-11), max "
              f"|diff| {float((a - b).abs().max()):.3e}; statistics lines "
              f"{'identical as text' if same else 'not identical as text'};"
              f" launches {small_counts[fused_req]}")
    size = MAIN_SIZE
    nsite = size[0] * size[1] * size[2]
    torch.cuda.synchronize()
    _cuda.launches.reset()
    log = io.StringIO()
    t0 = time.perf_counter()
    sys_ = run_text(noise_input(size, "float32", "on", MAIN_CYCLES, 20),
                    out=log, device="cuda")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = {"fused_step_noise": _cuda.launches.fused_step_noise,
              "fused_step": _cuda.launches.fused_step}
    text = log.getvalue()
    if f"Completed cycle {MAIN_CYCLES}" not in text:
        raise AssertionError("noise run_text did not complete its cycles")
    if counts != {"fused_step_noise": MAIN_CYCLES, "fused_step": 0}:
        raise AssertionError(f"launches {counts} for {MAIN_CYCLES} cycles")
    f = sys_.state[0]
    if tuple(f.shape) != (19,) + size or not torch.isfinite(f).all():
        raise AssertionError("the fluctuating state is not finite")
    totals = [float(v) for v in re.findall(r"\[rho\]\s+(\S+)", text)]
    if len(totals) != 3 or not all(abs(t - nsite) <= 1e-5 * nsite
                                   for t in totals):
        raise AssertionError(f"[rho] totals {totals} != {nsite}")
    kts = [[float(v) for v in ln.split()[1:]] for ln in text.splitlines()
           if ln.startswith(("[eqipart.]", "[measd/kT]"))]
    if len(kts) != 4 or not all(math.isfinite(v) and v > 0
                                for row in kts for v in row):
        raise AssertionError(f"kT block {kts}")
    for line in text.splitlines():
        if line.startswith(("[rho]", "[eqipart.]", "[measd/kT]")):
            print(line)
    print(text[text.find("Timer statistics"):].strip())
    print(f"noise run_text 256^3 f32 x {MAIN_CYCLES} cycles: {cli_s:.2f} s "
          f"wall, [rho] totals {totals}, kT rows {kts}, launches {counts}")
    return counts, small_counts


def phase21(card, gen, copy_ms, copy_bytes):
    phase(f"21 fluctuation and statistics timing at 256^3 D3Q19 f32 on "
          f"{card}")
    from ludwig_tpu_torch import ludwig as tl
    from ludwig_tpu_torch import stats
    from ludwig_tpu_torch.lb import make_step
    from ludwig_tpu_torch.noise import NoiseConfig
    from ludwig_tpu_torch.noise_kiss import kiss_init
    from ludwig_tpu_torch.runtime import RunTime
    res = {}
    # the main path's: viscosities 0.1, no body force
    cfg, params, noise = noise_params(19, RelaxationScheme.M10, "float32",
                                      MAIN_SIZE, 0.1, (0.0, 0.0, 0.0))
    nsite = MAIN_SIZE[0] * MAIN_SIZE[1] * MAIN_SIZE[2]
    f0 = rand_state(cfg, gen, amp=0.01)
    nbytes = 2 * f0.numel() * f0.element_size()
    t = NOISE_STEP0
    err = check_close("fused_step noise 256^3",
                      fused.fused_step(f0, cfg.model, params, noise=noise,
                                       t=t),
                      fused._fused_step_plain(f0, cfg.model, params, True,
                                              noise, t), cfg.tdtype)
    # noiseless, noise, noise, noiseless: one card, in turns
    quiet = [time_ms(lambda: fused.fused_step(f0, cfg.model, params), 20)]
    loud = [time_ms(lambda: fused.fused_step(f0, cfg.model, params,
                                             noise=noise, t=t), 20)
            for _ in range(2)]
    quiet.append(time_ms(lambda: fused.fused_step(f0, cfg.model, params),
                         20))
    ms = min(loud)
    twin_ms = time_ms(lambda: fused._fused_step_plain(
        f0, cfg.model, params, True, noise, t), 2, warm=1)
    nops = nsite * _cuda.site_ops("fused_step_noise")
    b_ms, b_by = bound(nbytes, nops)
    print(f"fused_step noise 256^3: kernel {ms:.4f} ms (runs {loud[0]:.4f}, "
          f"{loud[1]:.4f}), noiseless {quiet[0]:.4f} / {quiet[1]:.4f} ms, "
          f"twin {twin_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{nbytes / nsite:.0f} B/site, {nops / nsite:.0f} op/site), "
          f"{100 * b_ms / ms:.1f}% of it, copy bound "
          f"{copy_ms * nbytes / copy_bytes:.4f} ms, max_abs_err vs twin "
          f"{err:.3e}, {nsite / (ms * 1e3):.1f} MLUPS [{card}]")
    res["fused_step_noise"] = dict(ms=ms, plain_ms=twin_ms, max_abs_err=err,
                                   nbytes=nbytes, nops=nops)
    # the KISS route's step: torch on the card, the state riding with f
    kcfg = LBConfig(size=MAIN_SIZE, nvel=19, eta_shear=0.1, eta_bulk=0.1,
                    dtype="float32", device="cuda",
                    noise=NoiseConfig(kt=2e-5, rho=True))
    kstep = make_step(kcfg)
    kstate = (f0, kiss_init(0, MAIN_SIZE, device="cuda"))
    kiss_ms = time_ms(lambda: kstep(kstate, 1), 3, warm=1)
    print(f"KISS route step (make_step, torch on the card) 256^3: "
          f"{kiss_ms:.4f} ms = {nsite / (kiss_ms * 1e3):.1f} MLUPS [{card}]")
    # one reference-statistics block of the plain fluctuating run
    for size in ((128, 128, 128), MAIN_SIZE):
        text = noise_input(size, "float32", "off", 1, 1)
        sys_ = tl.build_system(RunTime(text), device="cuda")
        f = rand_state(sys_.lb_cfg, gen, amp=0.01)
        sys_.state = (f, sys_.state[1])
        u = tl._fused_u(sys_, f)
        stats_fn = tl._make_stats_fn(sys_, reference=True)
        fast_fn = tl._make_stats_fn(sys_, reference=False)
        blk = time_ms(lambda: stats_fn(sys_.state, u), 2, warm=1)
        fast = time_ms(lambda: fast_fn(sys_.state, u), 5, warm=1)
        print(f"reference statistics block {size[0]}^3 f32 (rho_stats_ref, "
              f"momentum_total_ref, velocity, kT): {blk:.2f} ms; the plain "
              f"reductions' block {fast:.4f} ms [{card}]")
        del sys_, f, u
    # each scan kernel and its CPU twin at 128^3 (the electrokinetic main
    # path's size), the kernel also at 256^3
    for size in ((128, 128, 128), MAIN_SIZE):
        scfg = LBConfig(size=size, nvel=19, dtype="float32", device="cuda")
        f = rand_state(scfg, gen, amp=1e-3)
        x = f[0].contiguous()
        n = x.numel()
        runs = {
            "seq_sum": (lambda z: stats.seq_sum(z), x, 4 * n, n),
            "field_stats_ref": (lambda z: stats.field_stats_ref(z), x, 4 * n,
                                14 * n),
            "rho_stats_ref": (lambda z: stats.rho_stats_ref(z, scfg.model),
                              f, 4 * 19 * n, 21 * n),
            "momentum_total_ref": (lambda z: stats.momentum_total_ref(
                z, scfg.model), f, 4 * 18 * n, 3 * 18 * 5 * n)}
        for name, (fn, arg, nb, no) in runs.items():
            k_ms = time_ms(lambda: fn(arg), 2, warm=1)
            b_ms, b_by = bound(nb, no)
            line = (f"{name} {size[0]}^3 f32: kernel {k_ms:.3f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / k_ms:.3f}% of it")
            if size != MAIN_SIZE:
                argc = arg.cpu()
                t0 = time.perf_counter()
                want = fn(argc)
                twin = 1e3 * (time.perf_counter() - t0)
                got = fn(arg)
                got = torch.stack(got) if isinstance(got, tuple) else got
                want = (torch.stack(want) if isinstance(want, tuple)
                        else want)
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"{name} {size}: not bitwise")
                line += f", CPU twin {twin:.1f} ms, bitwise"
                res[name] = dict(ms=k_ms, plain_ms=twin, max_abs_err=0.0,
                                 nbytes=nb, nops=no)
            print(line + f" [{card}]")
        del f, x
    return res


# the plain fluid's boundaries: the JAX package's wall, Couette, duct
# and Lees-Edwards inputs (tests/test_ludwig_run.py:40, 195, 205, 216,
# 273; copied, this script imports nothing of the JAX package) and a
# porous one (its tests/test_map_file.py:129 geometry)
BOUNDARY_INPUTS = {
    "walls": """
N_cycles 5
size 18_8_8
viscosity 0.1
boundary_walls 1_0_0
force 0.0_0.00001_0.0
freq_statistics 5
""",
    "wall": """
N_cycles 6
size 16_16_32
viscosity 0.1
boundary_walls 1_0_0
force 0.0_0.00001_0.0
periodicity 0_1_1
freq_statistics 3
""",
    "couette": """
N_cycles 6
size 16_16_32
viscosity 0.1
boundary_walls 0_1_0
boundary_speed_bottom -0.001
boundary_speed_top 0.001
periodicity 1_0_1
freq_statistics 3
""",
    "duct": """
N_cycles 6
size 16_16_32
viscosity 0.1
boundary_walls 1_1_0
force 0.0_0.0_0.00001
periodicity 0_0_1
freq_statistics 3
""",
    "le": """
N_cycles 6
size 16_16_32
viscosity 0.1
free_energy none
N_LE_plane 2
LE_plane_vel 0.05
periodicity 1_1_1
freq_statistics 3
""",
    "porous": """
N_cycles 4
size 16_16_32
viscosity 0.1
force 0.00001_0.0_0.0
porous_media_init simple_cubic
porous_media_acell 8
freq_statistics 2
"""}
BOUNDARY_SHAPE = (16, 16, 64)
LE_T0 = 10 ** 6 - 1          # the slide's step in phase 22: uy t near 10^4
WALL_CASES = {"1_0_0": ((True, False, False), False),
              "0_1_0 moving": ((False, True, False), True),
              "1_1_0": ((True, True, False), False)}
# phase 24: the main path's lattice with moving walls (Couette) and with
# four Lees-Edwards planes, as the JAX package's TPU history timed them
WALL_MAIN_INPUT = MAIN_INPUT + """boundary_walls 0_1_0
boundary_speed_top 0.01
"""
LE_MAIN_INPUT = MAIN_INPUT + """N_LE_plane 4
LE_plane_vel 0.01
"""


def boundary_floats(log):
    """stat_floats with the [walls] row."""
    vals = [float(t) for line in log.splitlines()
            if line.startswith("[walls") for t in line.split()[2:]]
    return torch.cat([stat_floats(log),
                      torch.tensor(vals, dtype=torch.float64)])


def check_gwall(what, a, b, dtype, scale):
    """The walls' momentum, a sum of terms of summed size `scale`: held at
    TOL's rtol of that size (the card sums the planes in another
    order)."""
    torch.cuda.synchronize()
    tol = TOL[dtype]["rtol"] * scale
    err = max_err(a.cpu(), b.cpu())
    if not err <= tol:
        raise AssertionError(f"{what}: the walls' momentum differs by "
                             f"{err:.3e}, beyond {tol:.3e}")
    return err


def boundary_planes(f, ax):
    """The first and last plane of spatial axis ax, stacked along it (the
    JAX package's plane2)."""
    n = f.shape[1 + ax]
    return f.index_select(1 + ax, torch.tensor([0, n - 1], device=f.device))


def wall_scale(f, walls, nsteps):
    """The summed size of the walls' momentum terms over nsteps steps: 2
    |f| over the boundary planes of the walled axes, each step."""
    s = 0.0
    for ax in range(3):
        if walls[ax]:
            s += float(boundary_planes(f, ax).abs().sum())
    return 2.0 * nsteps * s


def phase22(gen):
    phase("22 walls, Lees-Edwards planes, open boundaries and porous media "
          "on the card vs the CPU")
    from ludwig_tpu_torch import lb as tlb
    from ludwig_tpu_torch.io.map_file import GEOMETRIES
    from ludwig_tpu_torch.ops.lees_edwards import LeesEdwardsConfig
    from ludwig_tpu_torch.ops.open_bc import OpenBCConfig
    from ludwig_tpu_torch.ops.walls import WallSpec

    worst = 0.0
    X = BOUNDARY_SHAPE[0]
    torch.cuda.synchronize()
    _cuda.launches.reset()
    expect_launches = 0
    for dtype in ("float64", "float32"):
        cfg = LBConfig(size=BOUNDARY_SHAPE, nvel=19, eta_shear=0.1,
                       eta_bulk=0.14, force_global=(0.0, 1e-5, 2e-5),
                       dtype=dtype, device="cuda")
        ccfg = dataclasses.replace(cfg, device="cpu")
        f0 = rand_state(cfg, gen)
        zero = torch.zeros(3, dtype=cfg.tdtype, device="cuda")
        runs = []
        for name, (walls, moving) in WALL_CASES.items():
            spec = WallSpec(walls=walls, ubot=(-0.01 * moving, 0.0, 0.0),
                            utop=(0.02 * moving, 0.0, 0.0))
            runs.append((f"fused wall step {name}", walls, True,
                         lambda c, s=spec: fused.make_fused_wall_step(c, s)))
        slip = WallSpec(walls=(True, True, False),
                        slip_bot=(0.5, 0.25, 0.0), slip_top=(0.25, 1.0, 0.0),
                        slip_active=True)
        runs.append(("wall step slip 1_1_0", slip.walls, False,
                     lambda c: tlb.make_wall_step(c, slip)))
        runs.append(("wall step 0_1_0 + open x", (False, True, False), False,
                     lambda c: tlb.make_wall_step(
                         c, WallSpec(walls=(False, True, False)),
                         open_bc=OpenBCConfig(u0=(0.01, 0.0, 0.0)))))
        for name, walls, is_fused, make in runs:
            out = {}
            for dev, c, f, g in (("cuda", cfg, f0, zero),
                                 ("cpu", ccfg, f0.cpu(), zero.cpu())):
                step, state = make(c), (f, g)
                for t in range(1, 4):
                    state = step(state, t)
                    if not is_fused:
                        state = state[0]
                out[dev] = state
            expect_launches += 3 if is_fused else 0
            what = f"{name} {dtype}"
            err = check_close(what, out["cuda"][0], out["cpu"][0].cuda(),
                              cfg.tdtype)
            gerr = check_gwall(what, out["cuda"][1], out["cpu"][1],
                               cfg.tdtype, wall_scale(f0, walls, 3))
            worst = max(worst, err)
            print(f"{what}, 3 steps: f max_abs_err {err:.3e}, gwall "
                  f"{gerr:.3e} ({out['cuda'][1].tolist()})")
        t0 = LE_T0 if dtype == "float32" else 7
        for nplanes in (2, X // 2):
            le = LeesEdwardsConfig(nplanes=nplanes, uy=0.05, nx=X)
            for label, is_fused in (("fused", True), ("unfused", False)):
                out = {}
                for dev, c, f in (("cuda", cfg, f0), ("cpu", ccfg, f0.cpu())):
                    if is_fused:
                        step, state = fused.make_fused_le_step(c, le), (f,)
                        for t in range(t0, t0 + 3):
                            state = step(state, t)
                        out[dev] = state[0]
                    else:
                        step = tlb.make_step(c, le=le)
                        for t in range(t0, t0 + 3):
                            f, _rho, _u = step(f, t)
                        out[dev] = f
                expect_launches += 3 if is_fused else 0
                what = (f"{label} LE step {nplanes} planes {dtype} t="
                        f"{t0}..{t0 + 2}")
                err = check_close(what, out["cuda"], out["cpu"].cuda(),
                                  cfg.tdtype)
                worst = max(worst, err)
                print(f"{what}: max_abs_err {err:.3e}")
        porous = GEOMETRIES["simple_cubic"](BOUNDARY_SHAPE, 8) != 0
        out = {}
        for dev, c, f in (("cuda", cfg, f0), ("cpu", ccfg, f0.cpu())):
            step = tlb.make_step(c, solid=tlb.solid_mask(c, porous))
            for t in range(1, 4):
                f, _rho, _u = step(f, t)
            out[dev] = f
        err = check_close(f"porous step {dtype}", out["cuda"],
                          out["cpu"].cuda(), cfg.tdtype)
        worst = max(worst, err)
        print(f"porous step (simple cubic, acell 8) {dtype}, 3 steps: "
              f"max_abs_err {err:.3e}")
    torch.cuda.synchronize()
    if _cuda.launches.fused_step != expect_launches:
        raise AssertionError(f"fused_step launched {_cuda.launches.fused_step}"
                             f" times, {expect_launches} expected")
    print(f"fused_step launched {expect_launches} times by the fused wall "
          "and LE steps on the card")
    return {"fused_step": worst}


def phase23():
    phase("23 boundary inputs through run_text on the card vs the CPU")
    import os
    import tempfile

    from ludwig_tpu_torch.io import read_state
    from ludwig_tpu_torch.io.ref_format import read_ref_field
    counts = {}
    for name, text in BOUNDARY_INPUTS.items():
        for fused_req in ("on", "off"):
            logs = {}
            for device in ("cuda", "cpu"):
                out = io.StringIO()
                torch.cuda.synchronize()
                _cuda.launches.reset()
                sys_ = run_text(f"tpu_fused {fused_req}\ndtype float64\n"
                                + text, out=out, device=device)
                torch.cuda.synchronize()
                if device == "cuda":
                    n = _cuda.launches.fused_step
                    mode = sys_.fused_mode
                logs[device] = out.getvalue()
            a, b = boundary_floats(logs["cuda"]), boundary_floats(logs["cpu"])
            if (a.numel() != b.numel() or a.numel() == 0
                    or not torch.allclose(a, b, rtol=1e-9, atol=1e-11)):
                raise AssertionError(f"{name} tpu_fused {fused_req}: the "
                                     "card's log differs from the CPU's")
            cycles = int(re.search(r"N_cycles (\d+)", text).group(1))
            if n != (cycles if mode in ("wall", "le") else 0):
                raise AssertionError(f"{name} tpu_fused {fused_req} "
                                     f"({mode}): fused_step launched {n} "
                                     "times")
            counts[f"{name} f64 tpu_fused {fused_req}"] = {"fused_step": n}
            print(f"{name} f64 tpu_fused {fused_req} (route {mode}): "
                  f"{a.numel()} statistics floats on the card agree with "
                  f"the CPU's (rtol 1e-9, atol 1e-11), max |diff| "
                  f"{float((a - b).abs().max()):.3e}, fused_step {n}")
    # a checkpoint, a restart and field files on the card
    text = ("tpu_fused on\ndtype float64\nfreq_vel 3\n"
            + BOUNDARY_INPUTS["couette"].replace("freq_statistics 3",
                                                 "freq_statistics 1"))
    with tempfile.TemporaryDirectory() as d:
        io_text = text + f"io_directory {d}\n"
        straight, first, rest = io.StringIO(), io.StringIO(), io.StringIO()
        run_text(io_text, out=straight, device="cuda")
        sys_ = run_text(io_text.replace("N_cycles 6", "N_cycles 3")
                        + "config_at_end yes\n", out=first, device="cuda")
        run_text(io_text.replace("N_cycles 6", "N_cycles 3")
                 + "N_start 3\n", out=rest, device="cuda")
        want = straight.getvalue()
        want = want[want.index("\n", want.index("Completed cycle 3\n")) + 1:]
        got = rest.getvalue()
        got = got[got.index("\n", got.index("Starting time step loop.")) + 1:]
        if want.split("\nTimer")[0] != got.split("\nTimer")[0]:
            raise AssertionError("couette restart at 3: the restarted log "
                                 "is not the straight log")
        back = read_state(d, 3, ["dist", "state01"])
        if (not torch.equal(torch.as_tensor(back["dist"]),
                            sys_.state[0].cpu())
                or not torch.equal(torch.as_tensor(back["state01"]),
                                   sys_.state[1].cpu())):
            raise AssertionError("the step-3 checkpoint does not read back")
        vel = read_ref_field(os.path.join(d, "vel-00000006.001-001"),
                             (16, 16, 32), 3)
        if vel.shape != (3, 16, 16, 32) or not (abs(vel) < 0.1).all():
            raise AssertionError(f"vel-00000006: {vel.shape}")
        names = sorted(os.listdir(d))
    print(f"couette f64 on the card: the restart from step 3 prints the "
          f"straight log's steps 4-6 as text; the checkpoint and "
          f"vel-00000006 read back; files {names}")
    return counts


def post_profile(run, reps=5):
    """(CUDA kernels a call, device ms a call, the five kernels of most
    device time as (name, launches a call, ms a call)) of run(), by
    torch.profiler over `reps` calls; (None, None, []) where the
    profiler sees no kernel or dropped some."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda]
    # a kernel seen a number of times that is not a multiple of reps
    # means the trace dropped events: nothing counted then
    if not events or any(e.count % reps for e in events):
        return None, None, []
    rows = [(e.key, e.count / reps, e.device_time_total / reps / 1e3)
            for e in events]
    rows.sort(key=lambda r: -r[2])
    return (sum(r[1] for r in rows), sum(r[2] for r in rows), rows[:5])


def phase24(card, gen):
    phase(f"24 the wall and Lees-Edwards steps at 256^3 D3Q19 f32 on {card}")
    from ludwig_tpu_torch.ops.collide import collide
    from ludwig_tpu_torch.ops.lees_edwards import (LeesEdwardsConfig,
                                                   apply_le_fused,
                                                   le_fix_plan)
    from ludwig_tpu_torch.ops.walls import (WallSpec, wall_bounce_back_fused,
                                            wall_fix_plan)
    cfg = LBConfig(size=MAIN_SIZE, nvel=19, eta_shear=0.1, eta_bulk=0.1,
                   dtype="float32", device="cuda")
    model, params = cfg.model, cfg.collision_params()
    nsite = MAIN_SIZE[0] * MAIN_SIZE[1] * MAIN_SIZE[2]
    f0 = rand_state(cfg, gen, amp=0.01)
    res, paths = {}, {}
    spec = WallSpec(walls=(False, True, False), utop=(0.01, 0.0, 0.0))
    wfix = wall_fix_plan(model, spec, MAIN_SIZE, cfg.rho0, "cuda")
    le = LeesEdwardsConfig(nplanes=4, uy=0.01, nx=MAIN_SIZE[0])
    lfix = le_fix_plan(model, le, MAIN_SIZE, cfg.tdtype, "cuda")
    out = fused.fused_step(f0, model, params)

    def wall_post():
        return wall_bounce_back_fused(out, model, spec, rho0=cfg.rho0,
                                      plan=wfix)

    def plane_collide():
        # what the JAX design adds to the post-pass: a second collide of
        # the walled axis' two boundary planes (ops/collide.py)
        return collide(boundary_planes(f0, 1), params)[0]

    def le_post():
        return apply_le_fused(out, model, le, 10 ** 6, plan=lfix)

    gwall = torch.zeros(3, dtype=cfg.tdtype, device="cuda")
    wstep = fused.make_fused_wall_step(cfg, spec)
    lstep = fused.make_fused_le_step(cfg, le)
    times = {}
    # kernel, wall step, LE step, the post-passes; then the same in turn
    # backwards: one card, in turns
    order = (("fused_step", lambda: fused.fused_step(f0, model, params)),
             ("wall step", lambda: wstep((f0, gwall), 1)),
             ("wall post-pass", wall_post),
             ("plane collide (the JAX design's, not run)", plane_collide),
             ("LE step", lambda: lstep((f0,), 10 ** 6)),
             ("LE post-pass", le_post))
    for rep in range(2):
        for name, fn in order[::1 if rep == 0 else -1]:
            times.setdefault(name, []).append(time_ms(fn, 20))
    ms = {name: min(v) for name, v in times.items()}
    profiled = {"wall step": post_profile(dict(order)["wall step"]),
                "wall post-pass": post_profile(wall_post),
                "LE step": post_profile(dict(order)["LE step"]),
                "LE post-pass": post_profile(le_post),
                "plane collide (the JAX design's, not run)":
                post_profile(plane_collide)}
    for name, runs in times.items():
        n, dev_ms, top = profiled.get(name, (None, None, []))
        prof = ("" if name not in profiled else
                ", kernels not counted" if n is None else
                f", {n:.0f} CUDA kernels a call, {dev_ms:.4f} ms of them on "
                f"the device (torch.profiler)")
        print(f"{name} 256^3 f32: {ms[name]:.4f} ms (runs "
              f"{', '.join(f'{r:.4f}' for r in runs)}){prof}, "
              f"{nsite / (ms[name] * 1e3):.1f} MLUPS [{card}]")
        for key, count, k_ms in top:
            print(f"    {k_ms:.4f} ms device, {count:.0f} a call: "
                  f"{key[:90]}")
    for label, text in (("wall", WALL_MAIN_INPUT), ("le", LE_MAIN_INPUT)):
        torch.cuda.synchronize()
        _cuda.launches.reset()
        log = io.StringIO()
        t0 = time.perf_counter()
        sys_ = run_text(text, out=log, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        n = _cuda.launches.fused_step
        text_ = log.getvalue()
        if (f"Completed cycle {MAIN_CYCLES}" not in text_
                or sys_.fused_mode != label or n != MAIN_CYCLES):
            raise AssertionError(f"{label} run_text: route {sys_.fused_mode}"
                                 f", fused_step launched {n} times")
        totals = [float(v) for v in re.findall(r"\[rho\]\s+(\S+)", text_)]
        if not all(abs(t - nsite) <= 1e-5 * nsite for t in totals):
            raise AssertionError(f"{label} [rho] totals {totals}")
        if not torch.isfinite(sys_.state[0]).all():
            raise AssertionError(f"{label}: the state is not finite")
        paths[label] = {"fused_step": n}
        for line in text_.splitlines():
            if line.startswith(("[rho]", "[total", "[walls")):
                print(line)
        print(f"{label} run_text 256^3 f32 x {MAIN_CYCLES} cycles: "
              f"{wall_s:.2f} s wall, [rho] totals {totals}, launches "
              f"{paths[label]} [{card}]")
        del sys_
    res = {"wall_step_ms": ms["wall step"],
           "wall_post_ms": ms["wall post-pass"],
           "le_step_ms": ms["LE step"], "le_post_ms": ms["LE post-pass"],
           "fused_step_ms_phase24": ms["fused_step"],
           "plane_collide_ms": ms["plane collide (the JAX design's, not "
                                  "run)"],
           "wall_post_kernels": profiled["wall post-pass"][0],
           "wall_post_device_ms": profiled["wall post-pass"][1],
           "le_post_kernels": profiled["LE post-pass"][0],
           "le_post_device_ms": profiled["LE post-pass"][1],
           "wall_step_device_ms": profiled["wall step"][1],
           "le_step_device_ms": profiled["LE step"][1]}
    return res, paths


# phases 25-26: Lees-Edwards planes of the binary, blue-phase and droplet
# families.  The JAX package's sheared test inputs (tests/test_ludwig_run.py
# :227, :248; its droplet input at 16_8_16 with two planes), in f64.
LE_BINARY_INPUT = """
N_cycles 4
size 16_8_16
viscosity 0.00625
free_energy symmetric
A -0.00625
B 0.00625
K 0.004
phi0 0.0
phi_initialisation spinodal
mobility 1.25
fd_gradient_calculation 3d_7pt_fluid
fd_advection_scheme_order 1
N_LE_plane 2
LE_plane_vel 0.04
LE_init_profile 1
periodicity 1_1_1
freq_statistics 2
random_seed 8361235
"""
LE_LC_INPUT = """
N_cycles 4
size 16_8_16
viscosity 0.1
free_energy lc_blue_phase
fd_gradient_calculation 3d_7pt_fluid
fd_advection_scheme_order 1
lc_a0 0.01
lc_gamma 3.0
lc_q0 0.19635
lc_kappa0 0.000648456
lc_kappa1 0.000648456
lc_xi 0.7
lc_Gamma 0.5
lc_q_initialisation o8m
lc_q_init_amplitude -0.2
lc_init_redshift 1.0
N_LE_plane 2
LE_plane_vel 0.04
LE_init_profile 1
periodicity 1_1_1
freq_statistics 2
colloid_init no_colloids
"""
LE_DROPLET_INPUT = (DROP_INPUT.replace("tpu_fused on\n", "")
                    .replace(f"N_cycles {DROP_CYCLES}", "N_cycles 4")
                    .replace("freq_statistics 10", "freq_statistics 2")
                    + "size 16_8_16\nN_LE_plane 2\nLE_plane_vel 0.04\n"
                    "LE_init_profile 1\n")
LE_INPUTS = {"binary": LE_BINARY_INPUT, "lc": LE_LC_INPUT,
             "droplet": LE_DROPLET_INPUT}
# the K1 kernel of each family's fused step (K2 is fused_force_step)
LE_K1 = {"binary": "binary_phi_force_step", "lc": "lc_q_force_step",
         "droplet": "droplet_phi_q_force_step"}
LE_SHAPES = ((16, 8, 16), (18, 10, 12))   # the JAX tests' lattice, ragged
LE_T0 = 7
# phase 26: the sheared blue phase as perf_bench.py:208-245 builds it
# (eta 0.5, the SC16 free energy, 4 planes at 0.05), the binary and
# droplet cells' inputs with 4 planes at 0.01
LE_BP_FE = dict(a0=0.0069, gamma=3.0, q0=0.19635, kappa0=0.02,
                kappa1=0.02, xi=0.7)
LE_CYCLES = 20
LE_BP_INPUT = f"""
tpu_fused on
dtype float32
N_cycles {LE_CYCLES}
viscosity 0.5
free_energy lc_blue_phase
fd_gradient_calculation 3d_7pt_fluid
fd_advection_scheme_order 1
lc_a0 {LE_BP_FE['a0']}
lc_gamma {LE_BP_FE['gamma']}
lc_q0 {LE_BP_FE['q0']}
lc_kappa0 {LE_BP_FE['kappa0']}
lc_kappa1 {LE_BP_FE['kappa1']}
lc_xi {LE_BP_FE['xi']}
lc_Gamma 0.5
lc_q_initialisation o8m
lc_q_init_amplitude -0.2
N_LE_plane 4
LE_plane_vel 0.05
LE_init_profile 1
freq_statistics 10
"""
LE_CELL_KEYS = "N_LE_plane 4\nLE_plane_vel 0.01\n"


def le_family(name, size, dtype, gen, nplanes=2, uy=0.04):
    """(configuration for the card, the same for the CPU, the state on
    the card) of one sheared family: the sheared profile, a random order
    parameter and a velocity of both signs."""
    from ludwig_tpu_torch.binary_le import BinaryLEConfig
    from ludwig_tpu_torch.ops.lees_edwards import (LeesEdwardsConfig,
                                                   le_init_shear_profile)
    le = LeesEdwardsConfig(nplanes=nplanes, uy=uy, nx=size[0])
    if name == "binary":
        cfg = BinaryLEConfig(binary=binary_cfg(size, dtype, 1), le=le)
        lb = cfg.binary.lb
        ccfg = dataclasses.replace(cfg, binary=dataclasses.replace(
            cfg.binary, lb=dataclasses.replace(lb, device="cpu")))
        fields = rand_phi_u(size, getattr(torch, dtype), gen)
    elif name == "lc":
        cfg = lc_cfg(size, dtype)
        lb = cfg.lb
        ccfg = dataclasses.replace(cfg, lb=dataclasses.replace(lb,
                                                               device="cpu"))
        fields = rand_q_u(size, getattr(torch, dtype), gen)
    else:
        cfg = drop_cfg(size, dtype)
        lb = cfg.lb
        ccfg = dataclasses.replace(cfg, lb=dataclasses.replace(lb,
                                                               device="cpu"))
        fields = rand_drop(size, getattr(torch, dtype), gen)
    state = (le_init_shear_profile(lb, le),) + tuple(fields)
    return cfg, ccfg, le, state


def le_steps(name, cfg, le):
    """(column fix, fused step, unfused step) of a family."""
    from ludwig_tpu_torch import binary_le, lc as tlc, lc_droplet
    if name == "binary":
        return (binary_le.make_binary_le_column_fix(cfg),
                fb.make_fused_binary_le_step(cfg),
                binary_le.make_binary_le_step(cfg))
    if name == "lc":
        return (tlc.make_lc_le_column_fix(cfg, le),
                fl.make_fused_lc_le_step(cfg, le),
                tlc.make_lc_le_step(cfg, le))
    return (lc_droplet.make_droplet_le_column_fix(cfg, le),
            fd.make_fused_droplet_le_step(cfg, le),
            lc_droplet.make_droplet_le_step(cfg, le))


def phase25(gen):
    phase("25 sheared binary, blue-phase and droplet steps on the card vs "
          "the CPU")
    import os
    import tempfile

    worst = {}
    expect = {k: 0 for k in ("fused_force_step", *LE_K1.values())}
    torch.cuda.synchronize()
    _cuda.launches.reset()
    for name in LE_INPUTS:
        for size in LE_SHAPES:
            for dtype in ("float64", "float32"):
                cfg, ccfg, le, state = le_family(name, size, dtype, gen)
                tdt = getattr(torch, dtype)
                cstate = tuple(x.cpu() for x in state)
                what = f"{name} LE {size} {dtype}"
                gfix, gfused, gstep = le_steps(name, cfg, le)
                cfix, cfused, cstep = le_steps(name, ccfg, le)
                errs = []
                # a fix reads the step's inputs after f
                for a, b in zip(gfix(*state[1:], LE_T0),
                                cfix(*cstate[1:], LE_T0)):
                    if isinstance(a, tuple):     # (columns, values) pairs
                        pairs = zip(a, b)
                    else:
                        pairs = ((a, b),)
                    for x, y in pairs:
                        if x.dtype == torch.int64:
                            if not torch.equal(x.cpu(), y):
                                raise AssertionError(f"{what} fix columns")
                        else:
                            errs.append(check_close(f"{what} column fix", x,
                                                    y.cuda(), tdt))
                outs = {}
                for label, g, c in (("fused", gfused, cfused),
                                    ("unfused", gstep, cstep)):
                    gs, cs = state, cstate
                    for t in range(LE_T0, LE_T0 + 3):
                        gs, cs = g(gs, t), c(cs, t)
                        if label == "unfused":
                            gs, cs = gs[0], cs[0]
                    outs[label] = max(check_close(f"{what} {label} step", x,
                                                  y.cuda(), tdt)
                                      for x, y in zip(gs, cs))
                expect["fused_force_step"] += 3
                expect[LE_K1[name]] += 3
                worst[LE_K1[name]] = max(worst.get(LE_K1[name], 0.0),
                                         outs["fused"])
                print(f"{what}, t={LE_T0}..{LE_T0 + 2}: column fix "
                      f"max_abs_err {max(errs):.3e}; 3 fused steps "
                      f"{outs['fused']:.3e}; 3 unfused steps "
                      f"{outs['unfused']:.3e} (TOL {TOL[tdt]})")
    torch.cuda.synchronize()
    got = {k: getattr(_cuda.launches, k) for k in expect}
    if got != expect:
        raise AssertionError(f"sheared steps launched {got}, {expect} "
                             "expected")
    print(f"the fused sheared steps launched {got} on the card")
    counts = {}
    for name, text in LE_INPUTS.items():
        for fused_req in ("on", "off"):
            logs = {}
            for device in ("cuda", "cpu"):
                out = io.StringIO()
                torch.cuda.synchronize()
                _cuda.launches.reset()
                sys_ = run_text(f"tpu_fused {fused_req}\n" + text, out=out,
                                device=device)
                torch.cuda.synchronize()
                if device == "cuda":
                    n = {k: getattr(_cuda.launches, k)
                         for k in ("fused_force_step", LE_K1[name])}
                    mode = sys_.fused_mode
                logs[device] = stat_floats(out.getvalue())
            a, b = logs["cuda"], logs["cpu"]
            if (a.numel() != b.numel() or a.numel() == 0
                    or not torch.allclose(a, b, rtol=1e-9, atol=1e-11)):
                raise AssertionError(f"{name} LE tpu_fused {fused_req}: the "
                                     "card's log differs from the CPU's")
            want = 4 if fused_req == "on" else 0
            if mode != (name if fused_req == "on" else None) or any(
                    v != want for v in n.values()):
                raise AssertionError(f"{name} LE tpu_fused {fused_req} "
                                     f"({mode}): launches {n}")
            counts[f"{name} LE f64 16x8x16 tpu_fused {fused_req}"] = n
            print(f"{name} LE f64 tpu_fused {fused_req} (route {mode}): "
                  f"{a.numel()} statistics floats on the card agree with "
                  f"the CPU's (rtol 1e-9, atol 1e-11), max |diff| "
                  f"{float((a - b).abs().max()):.3e}, launches {n}")
    # the sheared blue phase's unfused route on the card: a checkpoint
    # with its gradient leaves, a restart, the shear observables
    text = ("tpu_fused off\n" + LE_LC_INPUT.replace("freq_statistics 2",
                                                    "freq_statistics 1")
            + "freq_shear_measurement 1\nfreq_shear_output 2\n")
    with tempfile.TemporaryDirectory() as d:
        io_text = text + f"io_directory {d}\n"
        straight, rest = io.StringIO(), io.StringIO()
        run_text(io_text, out=straight, device="cuda")
        run_text(io_text.replace("N_cycles 4", "N_cycles 2")
                 + "config_at_end yes\n", out=io.StringIO(), device="cuda")
        run_text(io_text.replace("N_cycles 4", "N_cycles 2")
                 + "N_start 2\n", out=rest, device="cuda")
        want = straight.getvalue()
        want = want[want.index("\n", want.index("Completed cycle 2\n")) + 1:]
        got = rest.getvalue()
        got = got[got.index("\n", got.index("Starting time step loop.")) + 1:]
        if want.split("\nTimer")[0] != got.split("\nTimer")[0]:
            raise AssertionError("LC LE restart at 2: the restarted log is "
                                 "not the straight log")
        names = sorted(os.listdir(d))
        section = [float(v) for v in
                   open(os.path.join(d, "str-00000004.dat")).read().split()]
        if ("state04-00000002" not in names or len(section) != 16 * 16 * 22
                or not all(math.isfinite(v) for v in section)):
            raise AssertionError(f"LC LE files {names}")
    print(f"LC LE f64 unfused on the card: the restart from step 2 prints "
          f"the straight log's steps 3-4 as text; files {names}")
    return worst, counts


def phase26(card, gen):
    phase(f"26 sheared steps at 128^3 and 256^3 D3Q19 f32 on {card}")
    from ludwig_tpu_torch.lc import LCConfig, make_lc_le_column_fix
    from ludwig_tpu_torch.ops.lees_edwards import (LeesEdwardsConfig,
                                                   le_init_shear_profile,
                                                   make_le_post)
    res, paths = {}, {}
    for n in (128, 256):
        size = (n, n, n)
        nsite = n ** 3
        lb = LBConfig(size=size, nvel=19, eta_shear=0.5, dtype="float32",
                      device="cuda")
        lcfg = LCConfig(lb=lb, fe=BluePhaseFE(**LE_BP_FE), gamma=0.5)
        le = LeesEdwardsConfig(nplanes=4, uy=0.05, nx=n)
        # perf_bench.py:229 makes O8M with q0 = 0.3
        q5 = torch.as_tensor(lc_init_o8m(size, 0.3, -0.2),
                             dtype=torch.float32, device="cuda")
        state = (le_init_shear_profile(lb, le), q5.contiguous(),
                 torch.zeros((3,) + size, dtype=torch.float32,
                             device="cuda"))
        step = fl.make_fused_lc_le_step(lcfg, le)
        for t in range(1, 4):          # a velocity field to advect with
            state = step(state, t)
        f, q, u = state
        fix = make_lc_le_column_fix(lcfg, le)
        post = make_le_post(lb.model, le)
        params = lb.collision_params()
        q1, force = fl.lc_q_force_step(q, u, lcfg.fe, lcfg.gamma)
        order = (("K1 lc_q_force_step",
                  lambda: fl.lc_q_force_step(q, u, lcfg.fe, lcfg.gamma)),
                 ("K2 fused_force_step",
                  lambda: fused.fused_force_step(f, force, lb.model,
                                                 params)),
                 ("column fix", lambda: fix(q, u, 10 ** 4)),
                 ("LE pass", lambda: post(f.clone(), 10 ** 4)),
                 ("whole step", lambda: step(state, 10 ** 4)))
        times = {}
        for rep in range(2):
            for name, fn in order[::1 if rep == 0 else -1]:
                times.setdefault(name, []).append(time_ms(fn, 10))
        clone_ms = time_ms(lambda: f.clone(), 10)
        ms = {k: min(v) for k, v in times.items()}
        ms["LE pass"] = ms["LE pass"] - clone_ms
        # two calls a profile: thousands of kernels a call fill the
        # profiler's buffers
        prof = {"column fix": post_profile(lambda: fix(q, u, 10 ** 4), 2),
                "whole step": post_profile(lambda: step(state, 10 ** 4), 2)}
        for name, runs in times.items():
            k, dev_ms, top = prof.get(name, (None, None, []))
            extra = ("" if name not in prof else
                     ", kernels not counted" if k is None else
                     f", {k:.0f} CUDA kernels a call, {dev_ms:.4f} ms of "
                     "them on the device (torch.profiler)")
            copy = (f"; a copy of f, {clone_ms:.4f} ms, taken off"
                    if name == "LE pass" else "")
            print(f"sheared blue phase {n}^3 f32 {name}: {ms[name]:.4f} ms "
                  f"(runs {', '.join(f'{r:.4f}' for r in runs)}{copy})"
                  f"{extra} [{card}]")
            for key, count, k_ms in top:
                print(f"    {k_ms:.4f} ms device, {count:.0f} a call: "
                      f"{key[:90]}")
        print(f"sheared blue phase {n}^3 f32 whole step: "
              f"{nsite / (ms['whole step'] * 1e3):.1f} MLUPS [{card}]")
        res[n] = {"k1_ms": ms["K1 lc_q_force_step"],
                  "k2_ms": ms["K2 fused_force_step"],
                  "fix_ms": ms["column fix"], "le_pass_ms": ms["LE pass"],
                  "step_ms": ms["whole step"],
                  "fix_kernels": prof["column fix"][0],
                  "fix_device_ms": prof["column fix"][1],
                  "step_kernels": prof["whole step"][0],
                  "step_device_ms": prof["whole step"][1]}
        del state, f, q, u, q1, force, step
    runs = (("lc LE 128^3", "lc", "size 128_128_128\n" + LE_BP_INPUT),
            ("lc LE 256^3", "lc", "size 256_256_256\n" + LE_BP_INPUT),
            ("binary LE 256^3", "binary",
             BINARY_INPUT.replace(f"N_cycles {BINARY_CYCLES}",
                                  f"N_cycles {LE_CYCLES}") + LE_CELL_KEYS),
            ("droplet LE 128^3", "droplet",
             drop_input(DROP_SIZE, "float32").replace(
                 f"N_cycles {DROP_CYCLES}", f"N_cycles {LE_CYCLES}")
             + LE_CELL_KEYS))
    for label, fam, text in runs:
        torch.cuda.synchronize()
        _cuda.launches.reset()
        log = io.StringIO()
        t0 = time.perf_counter()
        sys_ = run_text(text, out=log, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        n = {k: getattr(_cuda.launches, k)
             for k in ("fused_force_step", LE_K1[fam])}
        out = log.getvalue()
        if (f"Completed cycle {LE_CYCLES}" not in out
                or sys_.fused_mode != fam or sys_.le_cfg is None
                or any(v != LE_CYCLES for v in n.values())):
            raise AssertionError(f"{label} run_text: route {sys_.fused_mode}"
                                 f", launches {n}")
        if not all(torch.isfinite(x).all() for x in sys_.state):
            raise AssertionError(f"{label}: the state is not finite")
        nsite = math.prod(sys_.lb_cfg.size)
        totals = [float(v) for v in re.findall(r"\[rho\]\s+(\S+)", out)]
        if not all(abs(t - nsite) <= 1e-5 * nsite for t in totals):
            raise AssertionError(f"{label} [rho] totals {totals}")
        step = re.search(r"Step dispatch:\s+\S+\s+\S+\s+\S+\s+(\S+)", out)
        paths[label] = n
        res[label] = {"run_text_s": wall_s,
                      "step_dispatch_ms": 1e3 * float(step.group(1))}
        print(f"{label} f32 run_text x {LE_CYCLES} cycles: {wall_s:.2f} s "
              f"wall (init on the host included), step dispatch "
              f"{res[label]['step_dispatch_ms']:.3f} ms a cycle (host clock), "
              f"[rho] totals {totals}, launches {n} [{card}]")
        del sys_
    return res, paths


# -- resolved colloids in the single fluid (phases 27-28) ----------------------

COLLOID_SIZE = (16, 16, 16)
# the card against the CPU: float64 elementwise the same IEEE operations
# and the reference-order chains added in order on both (the card's
# sqrt, sin and cos are not correctly rounded, which moves the swimming
# directions in their last places); the float32 segment sums are atomic
# additions in an order the card picks
COLLOID_TOL = {torch.float64: dict(rtol=1e-12, atol=1e-13),
               torch.float32: dict(rtol=1e-4, atol=1e-6)}
# name -> (n, dtype, rebuild_freq, walls, squirmers, route)
COLLOID_ROUTES = {
    "f64 n=2 rebuild 2": (2, "float64", 2, None, False, "ordered"),
    "f64 n=3 squirmers walls": (3, "float64", 1, (True, False, False), True,
                                "ordered"),
    "f64 n=6 exact": (6, "float64", 1, None, False, "ordered"),
    "f32 n=2": (2, "float32", 1, None, False, "ordered"),
    "f32 n=6": (6, "float32", 2, None, False, "segment"),
    "f32 n=6 squirmers walls": (6, "float32", 1, (True, False, False), True,
                                "segment")}
COLLOID_CLI = """
N_cycles 4
size 16_16_16
viscosity 0.1
free_energy none
freq_statistics 2
"""
COLLOID_INPUTS = {
    "input_two": COLLOID_CLI + """
colloid_init input_two
colloid_one_a0 2.3
colloid_one_ah 2.3
colloid_one_r 5.0_8.5_8.5
colloid_one_v 0.01_0.0_0.0
colloid_two_a0 2.3
colloid_two_ah 2.3
colloid_two_r 11.0_8.5_8.5
colloid_gravity 0.0_0.0_-0.0001
soft_sphere_on 1
soft_sphere_epsilon 0.0004
soft_sphere_sigma 0.1
soft_sphere_nu 1.0
soft_sphere_cutoff 1.5
colloid_io_freq 2
""",
    "input_random_walls": COLLOID_CLI + """
colloid_init input_random
colloid_random_no 3
colloid_random_a0 2.3
colloid_random_ah 2.3
colloid_random_dh 0.5
random_seed 102
periodicity 0_1_1
boundary_walls 1_0_0
wall_ss_cut_on 1
wall_ss_cut_epsilon 0.001
wall_ss_cut_sigma 0.1
wall_ss_cut_nu 1.0
wall_ss_cut_hc 0.8
boundary_lubrication_rcnormal 0.6
boundary_lubrication_dhnormal 0.1
colloid_gravity -0.0001_0.0_0.0
""",
    "subgrid": COLLOID_CLI.replace("16_16_16", "24_8_16") + """
colloid_init from_file
colloid_file_stub config.cds
colloid_gravity 0.0_0.0_-0.0001
bond_fene_on 1
bond_fene_k 0.001
bond_fene_r0 5.0
"""}
SUSPENSION_SIZE = (64, 64, 64)
SUSPENSION_N = 1000


def colloid_start(n, dtype, walls, squirmers, device, seed=5):
    """(ColloidParams, ColloidState) from a numpy seed at COLLOID_SIZE:
    moving particles of radius 2.3, the fluid near rest, gravity."""
    import numpy as np

    from ludwig_tpu_torch.colloids import ColloidParams, ColloidState
    rng = np.random.RandomState(seed)
    R = rng.uniform(3, 13, (n, 3))
    if walls:
        R[0, 0] = 1.6
    kw = dict(a0=(2.3,) * n, ah=(2.3,) * n, gravity=(0.0, 0.0, -1e-4))
    m = np.tile([1.0, 0.0, 0.0], (n, 1))
    if squirmers:
        m = rng.standard_normal((n, 3))
        m /= np.linalg.norm(m, axis=1, keepdims=True)
        kw.update(b1=(0.02,) * n, b2=(0.01,) * n, m=tuple(map(tuple, m)),
                  types=("active",) * n)
    w = np.asarray(LBConfig(size=COLLOID_SIZE).model.wv)
    f = (w[:, None, None, None] * np.ones((1,) + COLLOID_SIZE)
         + 1e-3 * rng.standard_normal((19,) + COLLOID_SIZE))
    V = 0.01 * rng.standard_normal((n, 3))
    W = 0.001 * rng.standard_normal((n, 3))
    dr = 0.3 * rng.standard_normal((n, 3))
    dt = torch.float64 if dtype == "float64" else torch.float32
    leaves = [torch.as_tensor(a, dtype=dt, device=device)
              for a in (f, R, V, W, dr, R, m)]
    state = ColloidState(*leaves)
    if walls:
        state = state._replace(gwall=torch.zeros(3, dtype=dt, device=device))
    return ColloidParams(**kw), state


def colloid_chain(name, device, nsteps=4):
    from ludwig_tpu_torch.colloids import make_colloid_step
    from ludwig_tpu_torch.ops.walls import WallSpec
    n, dtype, rf, walls, squirmers, route = COLLOID_ROUTES[name]
    params, state = colloid_start(n, dtype, walls, squirmers, device)
    extra = {}
    if walls:
        extra = dict(wallspec=WallSpec(walls=walls), lubr_rc=(0.5,) * 3,
                     lubr_dh=(0.1,) * 3, wall_ss=dict(epsilon=1e-3, sigma=0.1,
                                                      nu=1.0, hc=0.5))
    step = make_colloid_step(
        LBConfig(size=COLLOID_SIZE, nvel=19, eta_shear=0.1, dtype=dtype,
                 device=device), params, rebuild_freq=rf, **extra)
    if step.route != route:
        raise AssertionError(f"colloids {name}: route {step.route}, not "
                             f"{route}")
    for t in range(1, nsteps + 1):
        state, _ = step(state, t)
    return state


def colloid_floats(log):
    """The floats of the statistics and particle lines of a colloid log,
    and its lines with the floats blanked."""
    body = log[log.index("\nInitial conditions."):log.rindex("Completed")]
    words, vals = [], []
    for line in body.splitlines():
        toks = line.split()
        words.append(" ".join("#" if re.match(r"^[-+]?\d+\.", t) else t
                              for t in toks))
        vals += [float(t) for t in toks if re.match(r"^[-+]?\d+\.", t)]
    return words, torch.tensor(vals, dtype=torch.float64)


def hold_colloid_state(a, b, name):
    """The card's ColloidState a against the CPU's b: each field within
    COLLOID_TOL, the maps identical; returns each field's max |diff|."""
    tol = COLLOID_TOL[a.f.dtype]
    errs = []
    for i, what in enumerate(("f", "R", "V", "W", "dr", "Rmap", "M")):
        if not torch.allclose(a[i].cpu(), b[i], **tol):
            raise AssertionError(f"{name}: {what} on the card differs from "
                                 f"the CPU's beyond {tol}")
        errs.append(max_err(a[i].cpu(), b[i]))
    if not torch.equal(a.pmap[0].cpu(), b.pmap[0]):
        raise AssertionError(f"{name}: the maps differ")
    return errs


def phase27():
    phase("27 colloid routes and inputs on the card vs the CPU")
    import tempfile
    worst = 0.0
    for name in COLLOID_ROUTES:
        torch.cuda.synchronize()
        _cuda.launches.reset()
        a = colloid_chain(name, "cuda")
        torch.cuda.synchronize()
        chains = _cuda.launches.chain_sums
        b = colloid_chain(name, "cpu")
        tol = COLLOID_TOL[a.f.dtype]
        errs = hold_colloid_state(a, b, f"colloids {name}")
        ordered = COLLOID_ROUTES[name][5] == "ordered"
        if ordered != (chains > 0):
            raise AssertionError(f"colloids {name}: chain_sums launched "
                                 f"{chains} times")
        if a.f.dtype == torch.float64:
            worst = max(worst, max(errs))
        print(f"colloids {name}: 4 steps on the card against the CPU "
              f"within {tol}, max |diff| {max(errs):.3e}, maps identical, "
              f"chain_sums {chains}")
    counts = {}
    with tempfile.TemporaryDirectory() as d:
        for name, text in COLLOID_INPUTS.items():
            logs = {}
            for device in ("cuda", "cpu"):
                out = io.StringIO()
                torch.cuda.synchronize()
                _cuda.launches.reset()
                run_text(f"dtype float64\nio_directory {d}/{device}\n" + text,
                         out=out, device=device)
                torch.cuda.synchronize()
                if device == "cuda":
                    n = _cuda.launches.chain_sums
                logs[device] = out.getvalue()
            (wa, a), (wb, b) = (colloid_floats(logs[k])
                                for k in ("cuda", "cpu"))
            if (wa != wb or a.numel() == 0
                    or not torch.allclose(a, b, rtol=1e-9, atol=1e-11)):
                raise AssertionError(f"colloid input {name}: the card's log "
                                     "differs from the CPU's")
            counts[f"colloids f64 16^3 {name}"] = {"chain_sums": n}
            print(f"colloid input {name} f64 through run_text: {a.numel()} "
                  f"floats on the card agree with the CPU's (rtol 1e-9, "
                  f"atol 1e-11), max |diff| {float((a - b).abs().max()):.3e},"
                  f" chain_sums {n}")
        # a restart on the card: steps 3-4 from the step-2 checkpoint print
        # the straight run's log
        text = ("dtype float64\nfreq_statistics 1\n"
                + COLLOID_INPUTS["input_two"] + f"io_directory {d}/r\n")
        straight, rest = io.StringIO(), io.StringIO()
        run_text(text, out=straight, device="cuda")
        run_text(text.replace("N_cycles 4", "N_cycles 2")
                 + "config_at_end yes\n", out=io.StringIO(), device="cuda")
        run_text(text.replace("N_cycles 4", "N_cycles 2") + "N_start 2\n",
                 out=rest, device="cuda")
        want = straight.getvalue()
        want = want[want.index("\n", want.index("Completed cycle 2\n")) + 1:]
        got = rest.getvalue()
        got = got[got.index("\n", got.index("Starting time step loop.")) + 1:]
        if want.split("\nTimer")[0] != got.split("\nTimer")[0]:
            raise AssertionError("colloid restart at 2: the restarted log is "
                                 "not the straight log")
    print("colloids f64 on the card: the restart from step 2 prints the "
          "straight log's steps 3-4 as text")
    return worst, counts


def suspension(squirmers, device="cuda"):
    """perf_bench.py:50-66 / :255-266 on device: 1000 particles of
    radius 2.3 on a jittered 10^3 grid at 64^3, float32, from
    RandomState(3); squirmers b1 = 0.02, b2 = 0.01, random directions."""
    import numpy as np

    from ludwig_tpu_torch.colloids import (ColloidParams, ColloidState,
                                           make_colloid_step)
    from ludwig_tpu_torch.lb import initial_rest
    N = SUSPENSION_N
    cfg = LBConfig(size=SUSPENSION_SIZE, nvel=19, eta_shear=0.1,
                   dtype="float32", device=device)
    rng = np.random.RandomState(3)
    kw = dict(a0=(2.3,) * N, ah=(2.3,) * N)
    m = np.tile([1.0, 0.0, 0.0], (N, 1))
    if squirmers:
        m = rng.standard_normal((N, 3))
        m /= np.linalg.norm(m, axis=1, keepdims=True)
        kw.update(b1=(0.02,) * N, b2=(0.01,) * N, m=tuple(map(tuple, m)),
                  types=("active",) * N)
    g = (np.indices((10, 10, 10)).reshape(3, -1).T + 0.5) * 6.4
    R = g + rng.uniform(-1.0, 1.0, g.shape)
    Rt = torch.as_tensor(R, dtype=torch.float32, device=device)
    z = torch.zeros((N, 3), dtype=torch.float32, device=device)
    state = ColloidState(initial_rest(cfg), Rt, z, z, z, Rt.clone(),
                         torch.as_tensor(m, dtype=torch.float32,
                                         device=device))
    params = ColloidParams(**kw)
    return make_colloid_step(cfg, params, rebuild_freq=1), state, R, m


def phase28(card):
    phase(f"28 the 64^3 N=1000 suspensions (perf_bench.py) f32 on {card}")
    import tempfile

    import numpy as np

    from ludwig_tpu_torch.io.colloid_io import (default_state,
                                                write_colloid_file)
    res, paths = {}, {}
    for squirmers in (False, True):
        name = "squirmers" if squirmers else "suspension"
        step, state, R, m = suspension(squirmers)
        holder = {"s": step.prepare(state)}
        out = {"route": step.route}
        for rebuild in (True, False):
            def run(rebuild=rebuild):
                holder["s"], _ = step(holder["s"], 1, rebuild=rebuild)

            torch.cuda.synchronize()
            _cuda.launches.reset()
            ms = time_ms(run, 10, warm=3)
            n_chain = _cuda.launches.chain_sums
            kernels, dev_ms, top = post_profile(run, reps=3)
            key = "rebuild" if rebuild else "no_rebuild"
            out[key] = dict(ms=ms, kernels=kernels, device_ms=dev_ms,
                            top=[(k, c, round(t, 4)) for k, c, t in top])
            if n_chain:
                raise AssertionError(f"{name}: the float32 route launched "
                                     f"chain_sums {n_chain} times")
            f = holder["s"].f
            if not bool(torch.isfinite(f).all()):
                raise AssertionError(f"{name}: non-finite distributions")
            print(f"{name} 64^3 N={SUSPENSION_N} f32 ({step.route} route), "
                  f"{key} step: {ms:.4f} ms (CUDA events, 10 steps after 3); "
                  f"{kernels} CUDA kernels a step, {dev_ms} ms of device "
                  f"time (torch.profiler); top {out[key]['top'][:3]}")
        errs = suspension_parity(squirmers)
        out["card_vs_cpu_max_abs_diff"] = errs
        print(f"{name}: a rebuild step and another from the same state on "
              f"the card and on the CPU agree within "
              f"{COLLOID_TOL[torch.float32]}, maps identical; max |diff| "
              f"f {errs[0]:.3e}, R {errs[1]:.3e}, V {errs[2]:.3e}, "
              f"W {errs[3]:.3e}")
        # no step reads back or copies from the host once its constants
        # are on the card: CUDA's sync debug mode raises on any
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for rebuild in (True, False):
                holder["s"], _ = step(holder["s"], 1, rebuild=rebuild)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f"{name}: a rebuild step and another under CUDA's sync debug "
              "mode 'error': no host synchronisation")
        res[name] = out
        # 20 cycles through run_text of the same configuration from a file
        with tempfile.TemporaryDirectory() as d:
            recs = []
            for i in range(SUSPENSION_N):
                rec = default_state()
                rec["index"] = i + 1
                rec["a0"] = rec["ah"] = 2.3
                rec["r"] = [float(c) + 1.0 for c in R[i]]
                rec["m"] = [float(c) for c in m[i]]
                if squirmers:
                    rec["type"], rec["b1"], rec["b2"] = 1, 0.02, 0.01
                recs.append(rec)
            write_colloid_file(f"{d}/config.cds.init", recs)
            text = ("size 64_64_64\nviscosity 0.1\ndtype float32\n"
                    "free_energy none\ncolloid_init from_file\n"
                    f"colloid_file_stub {d}/config.cds\nN_cycles 20\n"
                    "freq_statistics 20\n")
            # the CLI's force terms under the sync debug mode too: the
            # same particles with dipoles s = m and a hydrodynamic radius
            # of 1.5, which keeps the pair gaps (r - 2 ah > 1.4) finite
            for rec in recs:
                rec["s"], rec["ah"] = list(rec["m"]), 1.5
            write_colloid_file(f"{d}/forces.cds.init", recs)
            cli_sync_check(text.replace("config.cds", "forces.cds")
                           + SYNC_FORCE_KEYS)
            print(f"{name}: the CLI's step with soft spheres, Yukawa, pair "
                  "lubrication, gravity and Ewald sums, a rebuild step and "
                  "another under the sync debug mode: no host "
                  "synchronisation")
            log = io.StringIO()
            torch.cuda.synchronize()
            _cuda.launches.reset()
            t0 = time.perf_counter()
            run_text(text, out=log, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            paths[f"colloids {name} 64^3 f32"] = {
                "chain_sums": _cuda.launches.chain_sums}
            lg = log.getvalue()
            loop = float(re.search(r"Time step loop:\s+(\S+)", lg).group(1))
            if "[colloids]" not in lg or "Completed cycle 20" not in lg:
                raise AssertionError(f"{name}: run_text log incomplete")
            out["run_text_ms_per_cycle"] = 1e3 * loop
            out["run_text_s"] = wall
            print(f"{name} through run_text: 20 cycles, {1e3 * loop:.2f} ms "
                  f"a cycle (the log's time step loop), {wall:.2f} s in all")
    return res, paths


def suspension_parity(squirmers):
    """One rebuild step and one other of the 64^3 suspension from the same
    state on the card and on the CPU, held to COLLOID_TOL: the map of
    the first step is built from the same positions on both."""
    got = {}
    for device in ("cuda", "cpu"):
        step, state, _, _ = suspension(squirmers, device)
        state = step.prepare(state)
        for rebuild in (True, False):
            state, _ = step(state, 1, rebuild=rebuild)
        got[device] = state
    return hold_colloid_state(got["cuda"], got["cpu"],
                              "squirmers 64^3" if squirmers
                              else "suspension 64^3")


# every pair term the CLI builds per step, gravity and the dipolar sums
SYNC_FORCE_KEYS = """soft_sphere_on 1
soft_sphere_epsilon 0.0004
soft_sphere_sigma 0.1
soft_sphere_nu 1.0
soft_sphere_cutoff 0.25
yukawa_on 1
yukawa_epsilon 0.0001
yukawa_kappa 1.0
yukawa_cutoff 6.0
lubrication_on 1
lubrication_normal_cutoff 0.5
lubrication_tangential_cutoff 0.25
colloid_gravity 0.0_0.0_-0.00001
ewald_sum 1
ewald_mu 0.03
colloid_rebuild_freq 2
"""


def cli_sync_check(text):
    """The CLI's colloid step of text on the card: two steps to put its
    constants on the device, then a rebuild step and another under
    CUDA's sync debug mode 'error'."""
    from ludwig_tpu_torch.ludwig import build_system
    from ludwig_tpu_torch.runtime import RunTime
    sys_ = build_system(RunTime(text), "cuda")
    for t in (1, 2):
        sys_.state, _ = sys_.step_fn(sys_.state, t)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in (3, 4):
            sys_.state, _ = sys_.step_fn(sys_.state, t)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def chain_sums_timing(card):
    """The chain kernel on the reference-order route's largest call at
    16^3 (pass-1 sums, 28 terms, 8 images of 6 particles, cubes of 11^3
    sites x 18 velocities) against its CPU twin, with its bound: the
    bytes (each value read once) and the dependent chain (one addition a
    value of a chain, ~4 cycles at 1.98 GHz) - the chain is the floor."""
    from ludwig_tpu_torch.colloids import chain_sums
    g = torch.Generator(device="cuda").manual_seed(27)
    B, L, nt = 48, 11 ** 3 * 18, 28
    seq = torch.randn((B, L, nt), generator=g, dtype=torch.float64,
                      device="cuda")
    seed = torch.randn((B, nt), generator=g, dtype=torch.float64,
                       device="cuda")
    v = seq.permute(1, 0, 2).reshape(L, B * nt).contiguous()
    s = seed.reshape(-1).contiguous()
    ms = time_ms(lambda: _cuda.chain_sums(v, s), 10)
    got = _cuda.chain_sums(v, s).reshape(B, nt).cpu()
    t0 = time.perf_counter()
    want = chain_sums(seq.cpu(), seed.cpu())
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if not torch.equal(got, want):
        raise AssertionError("chain_sums: the kernel's sums are not the "
                             "CPU twin's bits")
    chain_ms = 1e3 * L * 4 / 1.98e9
    print(f"chain_sums {B * nt} chains of {L}: {ms:.4f} ms on {card}, CPU "
          f"twin {plain_ms:.2f} ms, bitwise; the dependent chain takes "
          f"{chain_ms:.4f} ms at 4 cycles an addition")
    return {"ms": ms, "plain_ms": plain_ms, "nbytes": v.numel() * 8 + 16
            * s.numel(), "nops": v.numel(), "max_abs_err": 0.0}


# -- the binary fluid's boundaries and options (phases 29-30) ------------------

BINARY_ROUTE_SIZE = (16, 16, 32)
BINARY_KT = 2e-5
# name -> (BinaryConfig changes, noise (phi, rho) or None, halo walls,
# porous, kind): kind "step" binary.make_binary_step, "open" the open x
# boundary beside walls, "le" two Lees-Edwards planes
BINARY_ROUTES = {
    "walls 0_0_1 27pt solid": (dict(gradient="3d_27pt_solid",
                                    wetting=(0.02, -0.001)), None,
                               (False, False, True), False, "step"),
    "walls 1_1_0": ({}, None, (True, True, False), False, "step"),
    "porous 27pt per-site wetting": (dict(gradient="3d_27pt_solid",
                                          wetting="map"), None, None, True,
                                     "step"),
    "porous 7pt solid": (dict(gradient="3d_7pt_solid", wetting=(0.01, 0.0)),
                         None, None, True, "step"),
    "phi_gradmu grad_mu porous": (dict(force_method="phi_gradmu",
                                       gradmu_ex=(1e-4, 0.0, -2e-4)), None,
                                  None, True, "step"),
    "arrhenius order 3": (dict(visc="arrhenius", advection_order=3), None,
                          None, False, "step"),
    "hydrodynamics off order 5": (dict(hydrodynamics=False,
                                       advection_order=5), None, None,
                                  False, "step"),
    "kiss phi rho": ({}, (True, True), None, False, "step"),
    "kiss walls 0_1_0": ({}, (True, True), (False, True, False), False,
                         "step"),
    "open x walls 0_1_1": (dict(advection_order=2), None,
                           (False, True, True), False, "open"),
    "le 27pt order 3 kiss": (dict(gradient="3d_27pt_fluid",
                                  advection_order=3), (False, True), None,
                             False, "le"),
}


def binary_route(name, dtype, device, size=BINARY_ROUTE_SIZE):
    """(step, state) of a BINARY_ROUTES route at `size` on `device`: the
    state from numpy seeds (phi spinodal-like, u random, f perturbed), so
    the card and the CPU start from the same bits."""
    import numpy as np

    from ludwig_tpu_torch import binary, binary_le
    from ludwig_tpu_torch.noise import NoiseConfig
    from ludwig_tpu_torch.ops.lees_edwards import LeesEdwardsConfig
    from ludwig_tpu_torch.ops.open_bc import OpenBCConfig
    from ludwig_tpu_torch.ops.walls import WallSpec
    from ludwig_tpu_torch.visc import ViscArrhenius
    bch, nz, walls, porous, kind = BINARY_ROUTES[name]
    bch = dict(bch)
    rng = np.random.default_rng(29)
    nzc = (None if nz is None else
           NoiseConfig(kt=BINARY_KT, phi=nz[0], rho=nz[1]))
    lb = LBConfig(size=size, nvel=19, eta_shear=0.00625, dtype=dtype,
                  device=device, noise=nzc)
    tdt = lb.tdtype
    if bch.pop("visc", None):
        bch["visc_model"] = ViscArrhenius(0.01, 0.004)
    solid = None
    if porous:
        m = rng.random(size) < 0.1
        m[0] = True
        solid = torch.as_tensor(m, device=device)
    if bch.get("wetting") == "map":
        bch["wetting"] = tuple(torch.as_tensor(a, dtype=tdt, device=device)
                               for a in (0.01 * rng.random(size),
                                         0.002 * rng.standard_normal(size)))
    cfg = binary.BinaryConfig(lb=lb, fe=FE, mobility=MOBILITY, **bch)
    phi0 = 0.05 * rng.standard_normal(size)
    state = list(binary.initial_binary(cfg, phi0, walls=walls is not None))
    w = np.asarray(lb.model.wv)[:, None, None, None]
    state[0] = torch.as_tensor(
        w * (1.0 + 0.05 * rng.standard_normal((19,) + size)), dtype=tdt,
        device=device)
    state[2] = torch.as_tensor(0.01 * rng.standard_normal((3,) + size),
                               dtype=tdt, device=device)
    ws = None if walls is None else WallSpec(walls=walls)
    if kind == "open":
        step = binary.make_binary_open_step(
            cfg, ws, OpenBCConfig(u0=(1e-3, 0.0, 0.0)), -0.8)
    elif kind == "le":
        le = LeesEdwardsConfig(nplanes=2, uy=0.04, nx=size[0])
        step = binary_le.make_binary_le_step(
            binary_le.BinaryLEConfig(binary=cfg, le=le))
    else:
        step = binary.make_binary_step(cfg, solid=solid, wallspec=ws)
    return step, tuple(state)


def hold_binary_states(what, a, b, walls=None):
    """The card's state a against the CPU's b: float leaves within TOL,
    the KISS states (int64) bitwise, gwall (leaf 3 where there are halo
    walls, a sum of terms in another order on the card) at TOL's rtol of
    its terms' summed size (check_gwall); returns the max |diff| of the
    fields."""
    worst = 0.0
    for k, (x, y) in enumerate(zip(a, b)):
        x = x.cpu()
        if y.dtype == torch.int64:
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: KISS state {k} differs")
            continue
        if walls is not None and k == 3:
            check_gwall(f"{what} gwall", x, y, y.dtype,
                        wall_scale(b[0], walls, 3))
            continue
        if not torch.allclose(x, y, **TOL[y.dtype]):
            raise AssertionError(f"{what}: leaf {k} differs by "
                                 f"{max_err(x, y):.3e} beyond {TOL[y.dtype]}")
        worst = max(worst, max_err(x, y))
    return worst


BINARY_SMALL = """
N_cycles 4
size 8_8_16
viscosity 0.00625
free_energy symmetric
A -0.00625
B 0.00625
K 0.004
phi0 0.0
phi_initialisation spinodal
mobility 1.25
fd_gradient_calculation 3d_7pt_fluid
fd_advection_scheme_order 2
periodicity 1_1_1
freq_statistics 2
random_seed 8361235
"""
BINARY_S27 = BINARY_SMALL.replace("3d_7pt_fluid", "3d_27pt_solid")
BINARY_NOISE_KEYS = ("temperature 0.00002\nisothermal_fluctuations on\n"
                     "fd_phi_fluctuations 1\n")
# the binary route inputs of tests/test_torch_binary_cli.py (the 3-D ones)
# and a walls + noise input the JAX package's builder does not run
BINARY_ROUTE_INPUTS = {
    "walls_0_0_1": BINARY_S27 + "boundary_walls 0_0_1\n",
    "walls_1_1_0": BINARY_SMALL + "boundary_walls 1_1_0\n",
    "porous_c_h": BINARY_S27 + "porous_media_file @DIR@/capillary\n"
                               "porous_media_type status_with_c_h\n",
    "open_x_walls": BINARY_SMALL + "boundary_walls 0_1_1\nlb_bc_open 1\n"
                                   "lb_bc_inflow_rhou_u0 0.001_0_0\n"
                                   "phi_bc_inflow_fixed_phib -0.5\n",
    "phi_gradmu_grad_mu": BINARY_SMALL + "fe_force_method phi_gradmu\n"
                                         "grad_mu 0.0001_0_-0.0002\n",
    "arrhenius": BINARY_SMALL + "viscosity_model arrhenius\n"
                                "viscosity_arrhenius_eta_minus 0.01\n"
                                "viscosity_arrhenius_eta_plus 0.004\n",
    "hydrodynamics_off": BINARY_SMALL.replace(
        "fd_advection_scheme_order 2", "fd_advection_scheme_order 4")
    + "hydrodynamics off\n",
    "kiss_noise": BINARY_SMALL.replace("free_energy symmetric",
                                       "free_energy symmetric_noise")
    + BINARY_NOISE_KEYS,
    "le_27pt": BINARY_SMALL.replace("size 8_8_16", "size 16_8_16").replace(
        "3d_7pt_fluid", "3d_27pt_fluid") + "N_LE_plane 2\n"
                                           "LE_plane_vel 0.01\n",
    "walls_kiss_noise": BINARY_S27.replace(
        "free_energy symmetric", "free_energy symmetric_noise")
    + BINARY_NOISE_KEYS + "boundary_walls 0_1_0\n",
}


def write_porous_map(path, size, seed=7):
    """A status_with_c_h map file at `size` from a numpy seed: scattered
    solid sites, a solid column along z, per-site C and H."""
    import numpy as np

    from ludwig_tpu_torch.io.map_file import write_map
    rng = np.random.default_rng(seed)
    status = (rng.random(size) < 0.08).astype(np.int8)
    status[2:4, 2:4, :] = 1
    data = np.stack([0.01 * rng.random(size),
                     0.002 * rng.standard_normal(size)])
    write_map(path, status, data)


def phase29():
    phase("29 binary boundaries and options on the card vs the CPU")
    import tempfile
    worst = 0.0
    for name in BINARY_ROUTES:
        for dtype in ("float64", "float32"):
            got = {}
            for device in ("cuda", "cpu"):
                step, state = binary_route(name, dtype, device)
                for t in range(1, 4):
                    state, _ = step(state, t)
                got[device] = state
            err = hold_binary_states(f"binary {name} {dtype}",
                                     got["cuda"], got["cpu"],
                                     BINARY_ROUTES[name][2])
            if dtype == "float64":
                worst = max(worst, err)
            print(f"binary {name} {dtype}: 3 steps at 16x16x32 on the card "
                  f"against the CPU within {TOL[getattr(torch, dtype)]}, "
                  f"max |diff| {err:.3e}"
                  + (", KISS states bitwise" if BINARY_ROUTES[name][1]
                     else ""))
    with tempfile.TemporaryDirectory() as d:
        write_porous_map(f"{d}/capillary.001-001", (8, 8, 16))
        for name, text in BINARY_ROUTE_INPUTS.items():
            text = "dtype float64\n" + text.replace("@DIR@", d)
            logs = {}
            for device in ("cuda", "cpu"):
                out = io.StringIO()
                run_text(text, out=out, device=device)
                logs[device] = out.getvalue()
            (wa, a), (wb, b) = (colloid_floats(logs[k])
                                for k in ("cuda", "cpu"))
            if (wa != wb or a.numel() == 0
                    or not torch.allclose(a, b, rtol=1e-9, atol=1e-11)):
                raise AssertionError(f"binary input {name}: the card's log "
                                     "differs from the CPU's")
            print(f"binary input {name} f64 through run_text: {a.numel()} "
                  f"floats on the card agree with the CPU's (rtol 1e-9, "
                  f"atol 1e-11), max |diff| {float((a - b).abs().max()):.3e}"
                  + (", [walls] rows" if "[walls   ]" in logs["cuda"]
                     else ""))
        # a restart on the card: steps 3-4 from the step-2 checkpoint (the
        # KISS states and gwall ride) print the straight run's log
        text = ("dtype float64\nfreq_statistics 1\n"
                + BINARY_ROUTE_INPUTS["walls_kiss_noise"]
                + f"io_directory {d}/r\n")
        straight, rest = io.StringIO(), io.StringIO()
        run_text(text, out=straight, device="cuda")
        run_text(text.replace("N_cycles 4", "N_cycles 2")
                 + "config_at_end yes\n", out=io.StringIO(), device="cuda")
        run_text(text.replace("N_cycles 4", "N_cycles 2") + "N_start 2\n",
                 out=rest, device="cuda")
        want = straight.getvalue()
        want = want[want.index("\n", want.index("Completed cycle 2\n")) + 1:]
        got = rest.getvalue()
        got = got[got.index("\n", got.index("Starting time step loop.")) + 1:]
        if want.split("\nTimer")[0] != got.split("\nTimer")[0]:
            raise AssertionError("binary walls + noise restart at 2: the "
                                 "restarted log is not the straight log")
    print("binary walls + noise f64 on the card: the restart from step 2 "
          "prints the straight log's steps 3-4 as text")
    return worst


BINARY_CELL_CYCLES = 20
BINARY_WALL_INPUT = (BINARY_INPUT.replace("3d_7pt_fluid", "3d_27pt_solid")
                     .replace("freq_statistics 10",
                              f"freq_statistics {BINARY_CELL_CYCLES}")
                     + "boundary_walls 0_0_1\n")
BINARY_128 = (BINARY_INPUT.replace("size 256_256_256", "size 128_128_128")
              .replace("freq_statistics 10",
                       f"freq_statistics {BINARY_CELL_CYCLES}"))
BINARY_POROUS_INPUT = (BINARY_128.replace("3d_7pt_fluid", "3d_27pt_solid")
                       + "porous_media_file @DIR@/capillary\n"
                         "porous_media_type status_with_c_h\n")
BINARY_NOISE_INPUT = (BINARY_128.replace("free_energy symmetric",
                                         "free_energy symmetric_noise")
                      + BINARY_NOISE_KEYS)
BINARY_CELLS = {"binary walls 0_0_1 27pt 256^3": BINARY_WALL_INPUT,
                "binary porous c_h 27pt 128^3": BINARY_POROUS_INPUT,
                "binary symmetric_noise 128^3": BINARY_NOISE_INPUT}


def phase30(card):
    phase(f"30 binary walls, porous media and noise at full width f32 on "
          f"{card}")
    import tempfile

    from ludwig_tpu_torch.ludwig import build_system
    from ludwig_tpu_torch.runtime import RunTime
    res, paths = {}, {}
    with tempfile.TemporaryDirectory() as d:
        write_porous_map(f"{d}/capillary.001-001", (128, 128, 128))
        for label, text in BINARY_CELLS.items():
            text = text.replace("@DIR@", d)
            torch.cuda.synchronize()
            _cuda.launches.reset()
            log = io.StringIO()
            t0 = time.perf_counter()
            sys_ = run_text(text, out=log, device="cuda")
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            paths[label] = stat_scan_counts()
            out = log.getvalue()
            if (f"Completed cycle {BINARY_CELL_CYCLES}" not in out
                    or sys_.fused_mode is not None):
                raise AssertionError(f"{label}: route {sys_.fused_mode}, "
                                     "cycles incomplete")
            if not all(torch.isfinite(x).all() for x in sys_.state
                       if x.is_floating_point()):
                raise AssertionError(f"{label}: the state is not finite")
            phis = [float(v) for v in re.findall(r"\[phi\]\s+(\S+)", out)]
            scale = 1e-6 * float(sys_.state[1].double().abs().sum())
            if len(phis) != 2 or max(phis) - min(phis) > scale:
                raise AssertionError(f"{label}: [phi] totals {phis} not "
                                     f"conserved within {scale:.3e}")
            walls = re.findall(r"\[walls   \]\s+(\S+)\s+(\S+)\s+(\S+)", out)
            if (sys_.wallspec is not None) != (len(walls) == 2):
                raise AssertionError(f"{label}: [walls] rows {walls}")
            del sys_
            # the step alone: ms (CUDA events), kernels and device time
            # (torch.profiler), one step under the sync debug mode
            sys_ = build_system(RunTime(text), "cuda")
            holder = {"s": sys_.state, "t": 1}

            def run():
                holder["s"], _ = sys_.step_fn(holder["s"], holder["t"])
                holder["t"] += 1

            ms = time_ms(run, 5, warm=2)
            kernels, dev_ms, top = post_profile(run, reps=2)
            reps = 2
            if kernels is None:
                # two steps' events overflowed the trace: count one step
                # (a drop there would go unseen)
                kernels, dev_ms, top = post_profile(run, reps=1)
                reps = 1
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            nsite = math.prod(sys_.lb_cfg.size)
            res[label] = {"ms": ms, "mlups": nsite / (ms * 1e3),
                          "kernels": kernels, "device_ms": dev_ms,
                          "profiled_steps": reps,
                          "run_text_s": wall_s, "phi_totals": phis,
                          "walls": walls,
                          "top": [(k[:60], c, round(t, 4))
                                  for k, c, t in top]}
            print(f"{label} f32: {ms:.3f} ms a step (CUDA events, 5 steps "
                  f"after 2), {nsite / (ms * 1e3):.1f} MLUPS, "
                  f"{kernels} CUDA kernels a step, {dev_ms} ms of them on "
                  f"the device (torch.profiler, {reps} step(s)); one step "
                  f"under the sync "
                  f"debug mode 'error': no host synchronisation; run_text "
                  f"x {BINARY_CELL_CYCLES} cycles {wall_s:.2f} s, [phi] "
                  f"totals {phis}, [walls] {walls}, scans {paths[label]} "
                  f"[{card}]")
            for key, count, k_ms in top[:3]:
                print(f"    {k_ms:.4f} ms device, {count:.0f} a step: "
                      f"{key[:90]}")
            del sys_, holder
    return res, paths


MORE_FE_SIZE = (16, 16, 32)
MORE_FE_KT = 2e-5
# the JAX package's test parameters (tests/test_more_fe.py,
# tests/test_binary_lb.py, tests/test_electro_symmetric.py)
BRAZ = dict(a=-5e-4, b=5e-4, kappa=-6e-4, c=7.6e-4)
SURF = dict(a=-0.0208333, b=0.0208333, kappa=0.12, kt=0.00056587,
            epsilon=0.03, beta=0.0, w=0.0)
TERN = dict(alpha=1.0, kappa1=0.01, kappa2=0.02, kappa3=0.05, h1=0.001,
            h2=-0.001, h3=-0.0025)
POLAR = dict(a=-0.1, b=0.1, kappa1=0.01, lambda_=0.1, zeta=0.001)
MORE_FE_ROUTES = (
    "brazovskii", "brazovskii le 5pt d4", "surfactant", "ternary phi_gradmu",
    "ternary walls 3d_ternary_solid", "surfactant hydrodynamics off",
    "polar", "polar hydrodynamics off", "symmetric_lb 27pt",
    "symmetric_lb walls 27pt solid", "symmetric_lb le 27pt",
    "symmetric_lb kiss", "electro_symm contrast")


def more_fe_route(name, dtype, device, size=MORE_FE_SIZE):
    """(step, state) of a MORE_FE_ROUTES route at `size` on `device`, the
    state from numpy seeds (f perturbed about rest, u random), so the card
    and the CPU start from the same bits."""
    import numpy as np

    from ludwig_tpu_torch import (binary, binary_le, binary_lb, electro_symm,
                                  polar, two_field)
    from ludwig_tpu_torch.electro import ElectroConfig
    from ludwig_tpu_torch.fe.brazovskii import BrazovskiiFE
    from ludwig_tpu_torch.fe.electro_symmetric import ElectroSymmetricFE
    from ludwig_tpu_torch.fe.polar_active import PolarActiveFE
    from ludwig_tpu_torch.fe.surfactant import SurfactantFE
    from ludwig_tpu_torch.fe.ternary import TernaryFE
    from ludwig_tpu_torch.noise import NoiseConfig
    from ludwig_tpu_torch.noise_kiss import kiss_init
    from ludwig_tpu_torch.ops.le_ref import le_fields_2d5pt_d4, le_gradient
    from ludwig_tpu_torch.ops.lees_edwards import LeesEdwardsConfig
    from ludwig_tpu_torch.ops.solid_stencil import ternary_solid_ops
    from ludwig_tpu_torch.ops.walls import WallSpec
    rng = np.random.default_rng(31)
    nz = (NoiseConfig(kt=MORE_FE_KT, rho=True) if "kiss" in name else None)
    lb = LBConfig(size=size, nvel=19, eta_shear=0.1, dtype=dtype,
                  device=device, noise=nz)

    def t(a):
        return torch.as_tensor(a, dtype=lb.tdtype, device=device)

    w = np.asarray(lb.model.wv)[:, None, None, None]
    f0 = t(w * (1.0 + 0.05 * rng.standard_normal((19,) + size)))
    u0 = t(0.01 * rng.standard_normal((3,) + size))
    le = LeesEdwardsConfig(nplanes=2, uy=0.04, nx=size[0])
    zeros3 = torch.zeros((3,), dtype=lb.tdtype, device=device)
    if name.startswith("brazovskii"):
        cfg = binary.BinaryConfig(lb=lb, fe=BrazovskiiFE(**BRAZ),
                                  mobility=0.05, advection_order=2)
        phi = t(0.05 * rng.standard_normal(size))
        if " le " in name:
            step = binary_le.make_binary_le_step(
                binary_le.BinaryLEConfig(binary=cfg, le=le), keep_grads=True)
            return step, (f0, phi, u0) + le_fields_2d5pt_d4(phi, le, 0)[:2]
        return binary.make_binary_step(cfg), (f0, phi, u0)
    if name.startswith(("surfactant", "ternary")):
        fe = (SurfactantFE(**SURF) if name.startswith("surfactant")
              else TernaryFE(**TERN))
        cfg = two_field.TwoFieldConfig(
            lb=lb, fe=fe, mobilities=(0.15, 0.1), advection_order=2,
            hydrodynamics="off" not in name,
            force_method=("phi_gradmu" if name.startswith("ternary")
                          else "stress_divergence"))
        state = (f0, t(0.3 * rng.standard_normal(size)),
                 t(0.3 + 0.1 * rng.random(size)), u0)
        ws = ops = None
        if "walls" in name:
            ws = WallSpec(walls=(False, True, False))
            a2 = fe.alpha * fe.alpha
            hrka = ((-fe.h1 / fe.kappa1 + fe.h2 / fe.kappa2) / a2,
                    (-fe.h3 / fe.kappa3) / a2)
            ops = tuple(ternary_solid_ops(size, h, walls=ws.walls,
                                          device=device) for h in hrka)
            state = state + (zeros3,)
        return two_field.make_two_field_step(cfg, wallspec=ws,
                                             solid_ops=ops), state
    if name.startswith("polar"):
        cfg = polar.PolarConfig(lb=lb, fe=PolarActiveFE(**POLAR), gamma=0.3,
                                swim=0.02, advection_order=2,
                                hydrodynamics="off" not in name)
        p0 = (polar.polar_init_aster(size)
              + 0.05 * rng.standard_normal((3,) + size))
        return polar.make_polar_step(cfg), (f0, t(p0), u0)
    if name.startswith("symmetric_lb"):
        gradient = ("3d_27pt_solid" if "solid" in name else "3d_27pt_fluid"
                    if "27pt" in name else "3d_7pt_fluid")
        cfg = binary_lb.BinaryLBConfig(lb=lb, fe=FE, mobility=0.15,
                                       gradient=gradient)
        g = 0.02 * rng.standard_normal((19,) + size)
        g[0] += 0.3 * rng.standard_normal(size)
        state = (f0, t(g), u0)
        ws = lec = None
        if "walls" in name:
            ws = WallSpec(walls=(False, False, True))
            state = state + (zeros3,)
        if nz is not None:
            state = state + (kiss_init(0, size, device=device),)
        if " le " in name:
            lec = le
            phi = binary_lb.g_moments(state[1], lb.model)[0]
            state = state + le_gradient(phi, le, 0, gradient)
        return binary_lb.make_binary_lb_step(cfg, wallspec=ws, le=lec), state
    # the coupled electrolyte across a tanh interface with a contrast;
    # tolerances no solve reaches, so both devices run max_its iterations
    ek = ElectroConfig(valency=(1, -1), diffusivity=(0.01, 0.02),
                       epsilon=200.0, beta=3.0e4, rel_tol=1e-30,
                       abs_tol=1e-30, max_its=30, multisteps=2)
    cfg = electro_symm.ElectroSymmConfig(
        lb=lb, ek=ek, mobility=0.1,
        fe=ElectroSymmetricFE(symm=FE, electro=ek, epsilon1=300.0,
                              epsilon2=100.0, deltamu=(0.5, -0.5)))
    phi = np.tanh((np.arange(size[0]) - 0.5 * size[0]) / 2.0)[:, None, None] \
        * np.ones(size)
    rho = 0.01 + 0.001 * rng.standard_normal((2,) + size)
    state = (f0, t(phi), t(1e-3 * rng.standard_normal(size)), t(rho), u0)
    return electro_symm.make_electro_symm_step(cfg), state


def hold_more_fe_states(what, a, b, walls=None, scaled=False):
    """The card's state a against the CPU's b: float leaves within TOL,
    the KISS states (int64) bitwise, a walls' momentum (a (3,) leaf where
    there are halo walls, summed in another order on the card) at TOL's
    rtol of its terms' summed size; returns the max |diff| of the fields.
    `scaled` holds float32 leaves at TOL's rtol of the leaf's largest
    magnitude instead: the electrolyte's psi after 30 SOR iterations a
    step carries the card's expf (an ulp from the CPU's) at f32's own
    rounding of psi (4.1e-7 against f64 on the CPU, max |psi| 0.46)."""
    worst = 0.0
    for k, (x, y) in enumerate(zip(a, b)):
        x = x.cpu()
        if y.dtype == torch.int64:
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: KISS state {k} differs")
            continue
        if walls is not None and tuple(y.shape) == (3,):
            check_gwall(f"{what} gwall", x, y, y.dtype,
                        wall_scale(b[0], walls, 3))
            continue
        tol = TOL[y.dtype]
        if scaled and y.dtype == torch.float32:
            tol = dict(rtol=0.0, atol=tol["rtol"] * float(y.abs().max()))
        if not torch.allclose(x, y, **tol):
            raise AssertionError(f"{what}: leaf {k} differs by "
                                 f"{max_err(x, y):.3e} beyond {tol}")
        worst = max(worst, max_err(x, y))
    return worst


NUMBER = re.compile(r"[-+]?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?")
MORE_FE_TAGS = ("[rho]", "[phi]", "[fe", "[total", "[fluid", "[walls",
                "[minimum", "[maximum", "[eqipart", "[measd", "[psi]",
                "[elc]", "[Px ]", "[Py ]", "[Pz ]", "[surf/fl/tot]",
                "[rho/phi/psi]", "SOR residual")


def more_fe_floats(log):
    """(words, floats) of the statistics lines of a log: the words with the
    numbers blanked, and the numbers (the [phi] format glues a pair where
    the second is negative)."""
    body = log[log.index("\nInitial conditions."):log.index("\nTimer")]
    words, vals = [], []
    for line in body.splitlines():
        if line.startswith(MORE_FE_TAGS + ("Free energies", "SOR ")):
            tag, sep, rest = line.rpartition("]")
            words.append(" ".join((tag + sep + NUMBER.sub(" # ", rest))
                                  .split()))
            if line.startswith(MORE_FE_TAGS):
                vals += [float(v) for v in NUMBER.findall(rest)]
    return words, torch.tensor(vals, dtype=torch.float64)


MORE_FE_BASE = """
N_cycles 4
freq_statistics 2
size 8_8_16
viscosity 0.1
dtype float64
"""
SYMM_KEYS = "A -0.00625\nB 0.00625\nK 0.004\n"
# one input of each family (tests/test_torch_more_fe_cli.py's, 4 cycles)
MORE_FE_INPUTS = {
    "brazovskii": MORE_FE_BASE + "free_energy brazovskii\nA -0.0005\n"
    "B 0.0005\nK -0.0006\nC 0.00076\nmobility 0.05\n"
    "fd_advection_scheme_order 2\nnoise 0.01\nrandom_seed 7\n",
    "surfactant": MORE_FE_BASE + "free_energy surfactant\n"
    "surf_A -0.0208333\nsurf_B 0.0208333\nsurf_kappa 0.12\n"
    "surf_kT 0.00056587\nsurf_epsilon 0.03\nsurf_beta 0.01\n"
    "surf_psi0 0.05\nsurf_mobility_phi 0.15\nsurf_mobility_psi 0.1\n"
    "noise 0.05\n",
    "ternary_tee_walls": MORE_FE_BASE.replace("size 8_8_16", "size 16_16_1")
    + "free_energy ternary\nternary_alpha 1.0\nternary_kappa1 0.01\n"
    "ternary_kappa2 0.02\nternary_kappa3 0.05\nternary_mobility_phi 0.15\n"
    "ternary_mobility_psi 0.1\nternary_initialisation 2d_tee\n"
    "fd_gradient_calculation 2d_ternary_solid\nboundary_walls 0_1_0\n"
    "ternary_h1 0.001\nternary_h2 -0.002\n",
    "symmetric_lb_walls": MORE_FE_BASE + "free_energy symmetric_lb\n"
    + SYMM_KEYS + "mobility 0.15\nnoise 0.1\nboundary_walls 0_0_1\n"
    "fd_gradient_calculation 3d_27pt_solid\n",
    "symmetric_lb_le_kiss": MORE_FE_BASE.replace("size 8_8_16",
                                                 "size 16_8_16")
    + "free_energy symmetric_lb\n" + SYMM_KEYS + "mobility 0.15\n"
    "N_LE_plane 2\nLE_plane_vel 0.01\ntemperature 0.00002\n"
    "isothermal_fluctuations on\n",
    "polar_active": MORE_FE_BASE + "free_energy polar_active\n"
    "polar_active_a -0.1\npolar_active_b 0.1\npolar_active_k 0.01\n"
    "polar_active_zeta 0.001\npolar_active_lambda 0.1\n"
    "leslie_ericksen_gamma 0.3\nfd_advection_scheme_order 2\n",
    "fe_electro_symmetric": MORE_FE_BASE.replace("size 8_8_16",
                                                 "size 16_4_4")
    + "free_energy fe_electro_symmetric\n" + SYMM_KEYS + "mobility 0.05\n"
    "phi_initialisation block_X\nphi_init_block_dimension 6\n"
    "electrokinetics_epsilon1 4.4e3\nelectrokinetics_epsilon2 2.2e3\n"
    "electrosymmetric_delta_mu0 0.1\nelectrosymmetric_delta_mu1 -0.1\n"
    "temperature 3.33333333333e-5\nelectrokinetics_init gouy_chapman\n"
    "electrokinetics_init_rho_el 1.04e-3\n"
    "electrokinetics_init_sigma 3.125e-2\nelectrokinetics_rel_tol 1e-3\n"
    "electrokinetics_maxits 300\n",
}


def phase31():
    phase("31 the other free energies on the card vs the CPU")
    import tempfile
    worst = 0.0
    for name in MORE_FE_ROUTES:
        for dtype in ("float64", "float32"):
            got = {}
            for device in ("cuda", "cpu"):
                step, state = more_fe_route(name, dtype, device)
                for t in range(1, 4):
                    state, _ = step(state, t)
                got[device] = state
            walls = ((False, True, False) if name.startswith("ternary walls")
                     else (False, False, True) if "walls" in name else None)
            err = hold_more_fe_states(f"{name} {dtype}", got["cuda"],
                                      got["cpu"], walls,
                                      scaled=name.startswith("electro"))
            if dtype == "float64":
                worst = max(worst, err)
            tol = ("1e-5 of each leaf's max magnitude"
                   if name.startswith("electro") and dtype == "float32"
                   else TOL[getattr(torch, dtype)])
            print(f"{name} {dtype}: 3 steps at 16x16x32 on the card against "
                  f"the CPU within {tol}, max |diff| "
                  f"{err:.3e}" + (", KISS states bitwise" if "kiss" in name
                                  else ""))
    counts = {}
    for name, text in MORE_FE_INPUTS.items():
        logs = {}
        for device in ("cuda", "cpu"):
            _cuda.launches.reset()
            out = io.StringIO()
            run_text(text, out=out, device=device)
            logs[device] = out.getvalue()
            if device == "cuda":
                counts[f"{name} f64 8x8x16"] = stat_scan_counts()
        (wa, a), (wb, b) = (more_fe_floats(logs[k]) for k in ("cuda", "cpu"))
        if (wa != wb or a.numel() == 0
                or not torch.allclose(a, b, rtol=1e-9, atol=1e-11)):
            raise AssertionError(f"input {name}: the card's log differs "
                                 "from the CPU's")
        print(f"input {name} f64 through run_text: {a.numel()} floats on the "
              f"card agree with the CPU's (rtol 1e-9, atol 1e-11), max "
              f"|diff| {float((a - b).abs().max()):.3e}")
    with tempfile.TemporaryDirectory() as d:
        # a restart on the card: steps 3-4 of the walled ternary fluid from
        # the step-2 checkpoint (gwall rides) print the straight run's log
        text = (MORE_FE_INPUTS["ternary_tee_walls"].replace(
            "freq_statistics 2", "freq_statistics 1") + f"io_directory {d}\n")
        straight, rest = io.StringIO(), io.StringIO()
        run_text(text, out=straight, device="cuda")
        run_text(text.replace("N_cycles 4", "N_cycles 2")
                 + "config_at_end yes\n", out=io.StringIO(), device="cuda")
        run_text(text.replace("N_cycles 4", "N_cycles 2") + "N_start 2\n",
                 out=rest, device="cuda")
        want = straight.getvalue()
        want = want[want.index("\n", want.index("Completed cycle 2\n")) + 1:]
        got = rest.getvalue()
        got = got[got.index("\n", got.index("Starting time step loop.")) + 1:]
        if want.split("\nTimer")[0] != got.split("\nTimer")[0]:
            raise AssertionError("ternary walls restart at 2: the restarted "
                                 "log is not the straight log")
    print("ternary walls f64 on the card: the restart from step 2 prints the "
          "straight log's steps 3-4 as text")
    return worst, counts


MORE_FE_CYCLES = 20
MORE_FE_128 = f"""
N_cycles {MORE_FE_CYCLES}
freq_statistics {MORE_FE_CYCLES}
size 128_128_128
viscosity 0.1
dtype float32
"""
# the six full-width cells: each family's JAX test parameters at the
# reference benchmarks' 128^3 (symmetric_lb at the binary benchmark's
# 256^3, fe_electro_symmetric at 64^3).  The surfactant's mobilities are
# 0.05: the explicit CH update needs M (|A| k^2 + kappa k^4) < 2 at the
# 7-point stencil's largest k^2 = 12, and M 0.15 with kappa 0.12 grows
# the grid-scale mode 1.55x a step from the spinodal noise
MORE_FE_CELLS = {
    "brazovskii 128^3": MORE_FE_128 + "free_energy brazovskii\n"
    "A -0.0005\nB 0.0005\nK -0.0006\nC 0.00076\nmobility 0.05\n"
    "fd_advection_scheme_order 2\nphi_initialisation spinodal\n"
    "noise 0.01\n",
    "surfactant 128^3": MORE_FE_128 + "free_energy surfactant\n"
    "surf_A -0.0208333\nsurf_B 0.0208333\nsurf_kappa 0.12\n"
    "surf_kT 0.00056587\nsurf_epsilon 0.03\nsurf_psi0 0.01\n"
    "surf_mobility_phi 0.05\nsurf_mobility_psi 0.05\n"
    "fd_advection_scheme_order 2\nphi_initialisation spinodal\n"
    "noise 0.05\n",
    "ternary 128^3": MORE_FE_128 + "free_energy ternary\n"
    "ternary_alpha 1.0\nternary_kappa1 0.01\nternary_kappa2 0.02\n"
    "ternary_kappa3 0.05\nternary_mobility_phi 0.15\n"
    "ternary_mobility_psi 0.1\nternary_initialisation 2d_double_emulsion\n"
    "fe_force_method phi_gradmu\n",
    "symmetric_lb 256^3": MORE_FE_128.replace("size 128_128_128",
                                              "size 256_256_256")
    .replace("viscosity 0.1", "viscosity 0.00625") + "free_energy "
    "symmetric_lb\n" + SYMM_KEYS + "mobility 0.15\n"
    "fd_gradient_calculation 3d_27pt_fluid\nphi_initialisation spinodal\n",
    "polar_active 128^3": MORE_FE_128 + "free_energy polar_active\n"
    "polar_active_a -0.1\npolar_active_b 0.1\npolar_active_k 0.01\n"
    "polar_active_zeta 0.001\npolar_active_lambda 0.1\n"
    "leslie_ericksen_gamma 0.3\n",
    # 8 cycles, not 20: its 1000 SOR iterations a step take ~1.6 s, and
    # the script keeps to half its time limit with phases 33-34
    "fe_electro_symmetric 64^3": MORE_FE_128.replace(
        "size 128_128_128", "size 64_64_64").replace(
        f"N_cycles {MORE_FE_CYCLES}\nfreq_statistics {MORE_FE_CYCLES}",
        "N_cycles 8\nfreq_statistics 8") + "freq_psi_resid 1\n"
    "free_energy fe_electro_symmetric\n" + SYMM_KEYS + "mobility 0.05\n"
    "phi_initialisation block_X\nphi_init_block_dimension 32\n"
    "electrokinetics_z0 1\nelectrokinetics_z1 -1\nelectrokinetics_d0 0.01\n"
    "electrokinetics_d1 0.01\nelectrokinetics_eunit 1.0\n"
    "electrokinetics_epsilon1 4.4e3\nelectrokinetics_epsilon2 2.2e3\n"
    f"electrokinetics_init gouy_chapman\n"
    f"electrokinetics_init_rho_el {ELEC_RHO_EL}\n"
    f"electrokinetics_init_sigma {ELEC_SIGMA}\n"
    "electrokinetics_solver_type sor\nelectrokinetics_rel_tol 1e-8\n"
    "electrokinetics_abs_tol 1e-15\nelectrokinetics_maxits 1000\n",
}
# the conserved totals of each cell's state: the mass (f), the order
# parameters (phi; psi of a two-field run; symmetric_lb's g, whose sum is
# phi's) and the electrolyte's species (their sum weighted by the
# valencies is the charge); leaf index -> name
CONSERVED = {"brazovskii": {0: "mass", 1: "phi"},
             "surfactant": {0: "mass", 1: "phi", 2: "psi"},
             "ternary": {0: "mass", 1: "phi", 2: "psi"},
             "symmetric_lb": {0: "mass", 1: "phi"},
             "polar_active": {0: "mass"},
             "fe_electro_symmetric": {0: "mass", 1: "phi", 3: "species"}}


def state_totals(state, family):
    """{name: (float64 total, float64 sum of magnitudes)} of a state's
    conserved leaves (per species for the electrolyte), on the device."""
    out = {}
    for k, name in CONSERVED[family].items():
        x = state[k].double()
        dims = tuple(range(1, x.dim())) if name == "species" else None
        out[name] = ((x.sum(dim=dims), x.abs().sum(dim=dims)) if dims
                     else (x.sum(), x.abs().sum()))
    return out


def phase32(card):
    phase(f"32 the other free energies at full width f32 on {card}")
    import warnings

    from ludwig_tpu_torch.ludwig import build_system
    from ludwig_tpu_torch.runtime import RunTime
    res, paths = {}, {}
    for label, text in MORE_FE_CELLS.items():
        family = label.split()[0]
        start = state_totals(build_system(RunTime(text), "cuda").state,
                             family)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.launches.reset()
        log = io.StringIO()
        t0 = time.perf_counter()
        sys_ = run_text(text, out=log, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        paths[label] = stat_scan_counts()
        out = log.getvalue()
        ncycles = int(re.search(r"N_cycles (\d+)", text).group(1))
        if f"Completed cycle {ncycles}" not in out:
            raise AssertionError(f"{label}: cycles incomplete")
        if not all(torch.isfinite(x).all() for x in sys_.state
                   if x.is_floating_point()):
            raise AssertionError(f"{label}: the state is not finite")
        # the totals of the state, summed in float64 on the device (the
        # printed [rho] and species totals are float32 site-order sums,
        # off by up to ~1e-4 of a 128^3 total): float32's rounding of the
        # updates leaves a drift, held within 1e-5 of the sum of |x|
        totals = {}
        for name, (t1, a1) in state_totals(sys_.state, family).items():
            t0, a0 = start[name]
            tol = 1e-5 * torch.maximum(a0, a1)
            if not bool(((t1 - t0).abs() <= tol).all()):
                raise AssertionError(f"{label}: {name} total "
                                     f"{t0.tolist()} -> {t1.tolist()} not "
                                     f"conserved within {tol.tolist()}")
            totals[name] = (t0.tolist(), t1.tolist())
        nsite = math.prod(sys_.lb_cfg.size)
        sor = [int(n) for n in re.findall(
            r"SOR residual\s+\S+ at (\d+) iter", out)]
        del sys_
        # the step alone: ms (CUDA events), kernels and device time
        # (torch.profiler), one step under the sync debug mode
        sys_ = build_system(RunTime(text), "cuda")
        holder = {"s": sys_.state, "t": 1}

        def run():
            holder["s"], holder["aux"] = sys_.step_fn(holder["s"],
                                                      holder["t"])
            holder["t"] += 1

        ms = time_ms(run, 3 if family == "fe_electro_symmetric" else 5,
                     warm=2)
        kernels, dev_ms, top = post_profile(run, reps=1)
        torch.cuda.synchronize()
        # the electrolyte's SOR reads its convergence test back every 5
        # iterations: those read-backs, and nothing else, synchronise
        mode = "warn" if family == "fe_electro_symmetric" else "error"
        torch.cuda.set_sync_debug_mode(mode)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = len(caught)
        if mode == "warn":
            # the last iteration's index k: read-backs at 4, 9, .., up to
            # the first past k, or every 5 of max_its
            k = int(holder["aux"][1][0])
            max_its = sys_.electro_cfg.ek.max_its
            want = min(k // 5 + 1, max_its // 5)
            if syncs != want:
                raise AssertionError(f"{label}: {syncs} host syncs in a "
                                     f"step, the SOR's read-backs are {want}")
        nsite = math.prod(sys_.lb_cfg.size)
        res[label] = {"ms": ms, "mlups": nsite / (ms * 1e3),
                      "kernels": kernels, "device_ms": dev_ms,
                      "host_syncs": syncs, "run_text_s": wall_s,
                      "peak_gb": peak_gb,
                      "totals": totals, "sor_iterations": sor,
                      "top": [(k[:60], c, round(t, 4)) for k, c, t in top]}
        print(f"{label} f32: {ms:.3f} ms a step (CUDA events), "
              f"{nsite / (ms * 1e3):.1f} MLUPS, {kernels} CUDA kernels a "
              f"step, {dev_ms} ms of them on the device (torch.profiler, 1 "
              f"step); one step under the sync debug mode '{mode}': "
              f"{syncs} host syncs; run_text x {ncycles} cycles "
              f"{wall_s:.2f} s, peak {peak_gb:.2f} GB, totals {totals}"
              + (f", SOR iterations {sor}" if sor else "")
              + f", scans {paths[label]} [{card}]")
        for key, count, k_ms in top[:3]:
            print(f"    {k_ms:.4f} ms device, {count:.0f} a step: "
                  f"{key[:90]}")
        del sys_, holder
    return res, paths


LC_ROUTE_SIZE = (16, 16, 32)
# the blue phase's unfused routes (lc.make_lc_step, lc_colloid): halo walls
# on each axis with the s7 anchoring kinds, the 'two' style, porous solids
# under 3d_7pt_solid, the dynamic redshift, the electric field,
# hydrodynamics off, advection orders 3-5, colloids periodic and beside a
# wall
LC_ROUTES = ("walls x s7 normal", "walls y s7 planar", "walls z s7 fixed",
             "walls z two planar", "porous two normal", "redshift",
             "electric field", "hydrodynamics off walls z s7 normal",
             "order 3", "order 4", "order 5", "colloids",
             "colloids walls z s7 normal")
LC_EFIELD = dict(epsilon=41.4 / (12.0 * math.pi), e0=(0.0, 0.003, 0.01))


def lc_route(name, dtype, device, size=LC_ROUTE_SIZE):
    """(step, state) of an LC_ROUTES route at `size` on `device`: Q the O8M
    start with noise on it, f perturbed about rest, u random, from numpy
    seeds, so the card and the CPU start from the same bits."""
    import numpy as np

    from ludwig_tpu_torch import lc, lc_colloid
    from ludwig_tpu_torch.colloids import ColloidParams
    from ludwig_tpu_torch.io.map_file import GEOMETRIES
    from ludwig_tpu_torch.ops.lc_anchor import AnchoringParams
    from ludwig_tpu_torch.ops.walls import WallSpec

    rng = np.random.default_rng(33)
    words = name.split()
    fe = BluePhaseFE(**LC_FE, **(LC_EFIELD if name == "electric field"
                                 else {}))
    walls = None
    if "walls" in words:
        ax = "xyz".index(words[words.index("walls") + 1])
        walls = tuple(a == ax for a in range(3))
    style = next((w for w in ("s7", "two") if w in words),
                 "s7" if words[0] == "colloids" else None)
    kind = next((w for w in ("normal", "planar", "fixed") if w in words),
                "normal")
    anch = None
    if style is not None:
        anch = AnchoringParams(
            kappa0=fe.kappa0, kappa1=fe.kappa1, q0=fe.q0,
            amplitude=fe.amplitude0, wall=kind, wall_w1=0.01,
            wall_w2=0.002 if kind == "planar" else 0.0,
            wall_nfix=(0.0, 0.6, 0.8), coll="normal", coll_w1=0.01,
            method=style)
    cfg = lc.LCConfig(
        lb=LBConfig(size=size, nvel=19, eta_shear=0.1, dtype=dtype,
                    device=device), fe=fe, gamma=LC_GAMMA,
        advection_order=int(words[1]) if words[0] == "order" else 1,
        gradient={"s7": "s7_anchoring", "two": "3d_7pt_solid",
                  None: "3d_7pt_fluid"}[style],
        hydrodynamics=not name.startswith("hydrodynamics off"),
        wallspec=None if walls is None else WallSpec(walls=walls),
        anchoring=anch, redshift_update=name == "redshift", keep_grads=True)
    q0 = (lc_init_o8m(size, LC_FE["q0"], -0.2)
          + 0.02 * rng.standard_normal((5,) + size))
    f = 1.0 / 19.0 + 1e-3 * rng.standard_normal((19,) + size)
    f = torch.as_tensor(f, dtype=getattr(torch, dtype), device=device)
    u = torch.as_tensor(0.01 * rng.standard_normal((3,) + size),
                        dtype=getattr(torch, dtype), device=device)
    if words[0] == "colloids":
        cp = ColloidParams(a0=(2.3, 2.3), ah=(2.3, 2.3),
                           gravity=(0.0, 0.0, -1e-4))
        R0 = np.array([[4.2, 7.1, 9.6], [11.3, 8.6, 21.7]])
        V0 = 0.01 * rng.standard_normal((2, 3))
        state = list(lc_colloid.initial_lc_colloid(cfg, cp, q0, R0, V0))
        state[0], state[8] = f, u
        return (lc_colloid.make_lc_colloid_step(cfg, cp, rebuild_freq=2),
                tuple(state))
    solid = None
    if words[0] == "porous":
        solid = torch.as_tensor(GEOMETRIES["simple_cubic"](size, 8) != 0,
                                device=device)
    state = lc.initial_lc(cfg, q0)
    return (lc.make_lc_step(cfg, solid=solid), (f, state[1], u) + state[3:])


LC_TAGS = MORE_FE_TAGS + ("[Qxx]", "[Qxy]", "[Qxz]", "[Qyy]", "[Qyz]",
                          "[colloids]")


def lc_log(log):
    """(words, floats) of a log from 'Initial conditions.' to the timer
    table: every line with its numbers blanked, and the numbers of the
    statistics rows."""
    body = log[log.index("\nInitial conditions."):log.index("\nTimer")]
    words, vals = [], []
    for line in body.splitlines():
        words.append(" ".join(NUMBER.sub(" # ", line).split()))
        if line.startswith(LC_TAGS):
            vals += [float(v) for v in NUMBER.findall(line.split("]", 1)[1])]
    return words, torch.tensor(vals, dtype=torch.float64)


LC_SMALL = """
N_cycles 4
freq_statistics 2
size 8_8_16
viscosity 0.1
dtype float64
free_energy lc_blue_phase
lc_a0 0.01
lc_gamma 3.0
lc_q0 0.19635
lc_kappa0 0.000648456
lc_kappa1 0.000648456
lc_xi 0.7
lc_Gamma 0.5
lc_q_initialisation o8m
lc_q_init_amplitude -0.2
"""
LC_WALL_S7 = ("boundary_walls 0_0_1\nfd_gradient_calculation s7_anchoring\n"
              "lc_wall_anchoring normal\nlc_wall_anchoring_w1 0.01\n")
LC_COLLOID_KEYS = """fd_gradient_calculation s7_anchoring
lc_coll_anchoring normal
lc_coll_anchoring_w1 0.01
colloid_init input_two
colloid_one_a0 2.3
colloid_one_ah 2.3
colloid_one_r 4.0_6.5_6.5
colloid_one_v 0.01_0.0_0.0
colloid_two_a0 2.3
colloid_two_ah 2.3
colloid_two_r 9.5_6.5_7.0
colloid_gravity 0.0_0.0_-0.0001
"""
# one input of each kind (tests/test_torch_cli.py's), in float64
LC_INPUTS = {
    "walls s7 normal": LC_SMALL + LC_WALL_S7,
    "walls two planar": LC_SMALL + "boundary_walls 1_0_0\n"
    "fd_gradient_calculation 3d_7pt_solid\nlc_anchoring_method two\n"
    "lc_wall_anchoring planar\nlc_anchoring_strength 0.01\n"
    "lc_anchoring_strength_2 0.002\n",
    "porous 3d_7pt_solid": LC_SMALL + "porous_media_init simple_cubic\n"
    "porous_media_acell 4\nfd_gradient_calculation 3d_7pt_solid\n"
    "lc_anchoring_method two\nlc_wall_anchoring normal\n"
    "lc_anchoring_strength 0.01\n",
    "redshift": LC_SMALL + "lc_redshift_update 1\n",
    "electric field": LC_SMALL + "electric_e0 0.0_0.0_0.01\n"
    "lc_dielectric_anisotropy 41.4\n",
    "hydrodynamics off": LC_SMALL + LC_WALL_S7 + "hydrodynamics off\n",
    "order 3": LC_SMALL + "fd_advection_scheme_order 3\n",
    "random rectangle": LC_SMALL + "lc_q_init_rectangle_min 2_2_3\n"
    "lc_q_init_rectangle_max 5_6_9\n",
    "colloids": LC_SMALL.replace("size 8_8_16", "size 12_12_12")
    + LC_COLLOID_KEYS,
    "colloids walls": LC_SMALL.replace("size 8_8_16", "size 12_12_12")
    + LC_COLLOID_KEYS + "boundary_walls 0_0_1\nlc_wall_anchoring normal\n"
    "lc_wall_anchoring_w1 0.01\n",
}


def phase33():
    phase("33 the blue phase's walls, anchoring, solids, colloids and "
          "options on the card vs the CPU")
    import tempfile
    worst = 0.0
    for name in LC_ROUTES:
        for dtype in ("float64", "float32"):
            got = {}
            for device in ("cuda", "cpu"):
                step, state = lc_route(name, dtype, device)
                for t in range(3):
                    state, _ = step(state, t)
                got[device] = state
            m = re.search(r"walls (\w)", name)
            walls = (None if m is None
                     else tuple(a == "xyz".index(m.group(1))
                                for a in range(3)))
            err = hold_more_fe_states(f"{name} {dtype}", got["cuda"],
                                      got["cpu"], walls)
            if dtype == "float64":
                worst = max(worst, err)
            print(f"LC {name} {dtype}: 3 steps at 16x16x32 on the card "
                  f"against the CPU within {TOL[getattr(torch, dtype)]}, "
                  f"max |diff| {err:.3e}")
    counts = {}
    for name, text in LC_INPUTS.items():
        logs = {}
        for device in ("cuda", "cpu"):
            _cuda.launches.reset()
            out = io.StringIO()
            sys_ = run_text(text, out=out, device=device)
            logs[device] = out.getvalue()
            if device == "cuda":
                counts[f"lc {name} f64"] = stat_scan_counts()
                if sys_.fused_mode is not None:
                    raise AssertionError(f"LC input {name}: fused route")
        (wa, a), (wb, b) = (lc_log(logs[k]) for k in ("cuda", "cpu"))
        if (wa != wb or a.numel() == 0
                or not torch.allclose(a, b, rtol=1e-9, atol=1e-11)):
            raise AssertionError(f"LC input {name}: the card's log differs "
                                 "from the CPU's")
        print(f"LC input {name} f64 through run_text: {len(wa)} lines the "
              f"same but their numbers, {a.numel()} floats on the card "
              f"agree with the CPU's (rtol 1e-9, atol 1e-11), max |diff| "
              f"{float((a - b).abs().max()):.3e}")
    with tempfile.TemporaryDirectory() as d:
        # a restart on the card: steps 3-4 of the walled blue phase from
        # the step-2 checkpoint (gwall and the kept gradients ride) print
        # the straight run's log
        text = (LC_INPUTS["walls s7 normal"].replace(
            "freq_statistics 2", "freq_statistics 1") + f"io_directory {d}\n")
        straight, rest = io.StringIO(), io.StringIO()
        run_text(text, out=straight, device="cuda")
        run_text(text.replace("N_cycles 4", "N_cycles 2")
                 + "config_at_end yes\n", out=io.StringIO(), device="cuda")
        run_text(text.replace("N_cycles 4", "N_cycles 2") + "N_start 2\n",
                 out=rest, device="cuda")
        want = straight.getvalue()
        want = want[want.index("\n", want.index("Completed cycle 2\n")) + 1:]
        got = rest.getvalue()
        got = got[got.index("\n", got.index("Starting time step loop.")) + 1:]
        if want.split("\nTimer")[0] != got.split("\nTimer")[0]:
            raise AssertionError("LC walls restart at 2: the restarted log "
                                 "is not the straight log")
    print("LC walls s7 f64 on the card: the restart from step 2 prints the "
          "straight log's steps 3-4 as text")
    return worst, counts


LC_CELL_CYCLES = 20
LC_128 = (lc_input((128, 128, 128), "float32")
          .replace(f"N_cycles {LC_CYCLES}", f"N_cycles {LC_CELL_CYCLES}")
          .replace("freq_statistics 10", f"freq_statistics {LC_CELL_CYCLES}"))
# the three full-width cells: the blue-phase benchmark between walls on z
# with normal anchoring, a nematic holding 8 particles of radius 7.25 on a
# 2x2x2 lattice (rebuilt every step), and the benchmark with the dynamic
# redshift (its [fe] row, with the redshift, printed every cycle)
LC_CELLS = {
    "lc-walls": LC_128 + LC_WALL_S7,
    "lc-colloids": LC_128.replace("lc_q_initialisation o8m",
                                  "lc_q_initialisation nematic")
    .replace("lc_q_init_amplitude -0.2\n", "lc_init_nematic 1.0_0.0_0.0\n")
    .replace("colloid_init no_colloids\n", "")
    + "fd_gradient_calculation s7_anchoring\nlc_coll_anchoring normal\n"
    "lc_coll_anchoring_w1 0.01\ncolloid_init from_file\n"
    "colloid_file_stub @DIR@/config.cds\ncolloid_rebuild_freq 1\n",
    "lc-redshift": LC_128.replace(f"freq_statistics {LC_CELL_CYCLES}",
                                  "freq_statistics 1")
    + "lc_redshift_update 1\n",
}


def lattice_colloids(directory, n=2, a0=7.25, L=128):
    """config.cds.init in `directory`: n^3 particles of radius a0 at rest
    on a simple cubic lattice filling an L^3 box (1-based centres)."""
    import os

    from ludwig_tpu_torch.io.colloid_io import (default_state,
                                                write_colloid_file)
    recs = []
    for i in range(n ** 3):
        rec = default_state()
        rec["index"] = i + 1
        rec["a0"] = rec["ah"] = a0
        idx = ((i // (n * n)) % n, (i // n) % n, i % n)
        rec["r"] = [0.5 + (k + 0.5) * L / n for k in idx]
        rec["m"] = [1.0, 0.0, 0.0]
        recs.append(rec)
    write_colloid_file(os.path.join(directory, "config.cds.init"), recs)


def matvec_cost(run):
    """The walled step's ms and device time with the anchoring's 12- and
    18-unknown solves summed in float64 (ops/lc_anchor._matvec) and in
    the field's dtype, two rounds each in turn: {"float64" | "field
    dtype": [(ms, device ms), ...]}."""
    from ludwig_tpu_torch.ops import lc_anchor

    def same_dtype(m, b):
        x = m.to(b.dtype) @ b.reshape(b.shape[0], -1)
        return x.reshape((m.shape[0],) + b.shape[1:])

    f64 = lc_anchor._matvec
    out = {"float64": [], "field dtype": []}
    try:
        for _ in range(2):
            for k, fn in (("float64", f64), ("field dtype", same_dtype)):
                lc_anchor._matvec = fn
                out[k].append((time_ms(run, 5, warm=2),
                               post_profile(run, 1)[1]))
    finally:
        lc_anchor._matvec = f64
    for k, rows in out.items():
        for ms, dev in rows:
            print(f"    anchoring solves in {k}: {ms:.3f} ms a step (CUDA "
                  f"events), {dev} ms on the device (torch.profiler)")
    return out


def phase34(card):
    phase(f"34 the blue phase's walls, colloids and redshift at full width "
          f"f32 on {card}")
    import tempfile
    import warnings

    from ludwig_tpu_torch.ludwig import build_system
    from ludwig_tpu_torch.runtime import RunTime
    res, paths = {}, {}
    with tempfile.TemporaryDirectory() as d:
        lattice_colloids(d)
        for label, text in LC_CELLS.items():
            text = text.replace("@DIR@", d)
            start = build_system(RunTime(text), "cuda").state[0].double().sum()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _cuda.launches.reset()
            log = io.StringIO()
            t0 = time.perf_counter()
            sys_ = run_text(text, out=log, device="cuda")
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            paths[label] = stat_scan_counts()
            out = log.getvalue()
            if f"Completed cycle {LC_CELL_CYCLES}" not in out:
                raise AssertionError(f"{label}: cycles incomplete")
            if sys_.fused_mode is not None:
                raise AssertionError(f"{label}: not the unfused route")
            if not all(torch.isfinite(x).all() for x in sys_.state
                       if x.is_floating_point()):
                raise AssertionError(f"{label}: the state is not finite")
            extra = {}
            if label != "lc-colloids":
                # the fluid's mass, summed from the state in float64: the
                # walls bounce back, the periodic lattice keeps it
                mass = float(sys_.state[0].double().sum())
                if abs(mass - float(start)) > 1e-5 * float(start):
                    raise AssertionError(f"{label}: mass {float(start)} -> "
                                         f"{mass}")
                extra["mass"] = (float(start), mass)
            if label == "lc-redshift":
                extra["redshift"] = [float(ln.split()[-1]) for ln in
                                     out.splitlines()
                                     if ln.startswith("[fe]")][1:]
                if len(extra["redshift"]) != LC_CELL_CYCLES:
                    raise AssertionError(f"{label}: redshift rows missing")
            if label == "lc-walls":
                extra["fe"] = [ln for ln in out.splitlines()
                               if ln.startswith("[fe]")][-1]
            del sys_
            # the step alone: ms (CUDA events), kernels and device time
            # (torch.profiler), one step under the sync debug mode "error";
            # the colloid cell's rebuild steps apart from the others
            sys_ = build_system(RunTime(text), "cuda")
            modes = ((True, False) if label == "lc-colloids" else (None,))
            for rebuild in modes:
                holder = {"s": sys_.state, "t": 1}

                def run():
                    kw = {} if rebuild is None else {"rebuild": rebuild}
                    holder["s"], _aux = sys_.step_fn(holder["s"],
                                                     holder["t"], **kw)
                    holder["t"] += 1

                ms = time_ms(run, 5, warm=2)
                kernels, dev_ms, top = post_profile(run, reps=1)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        run()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                key = label + {None: "", True: " rebuild",
                               False: " no rebuild"}[rebuild]
                nsite = math.prod(sys_.lb_cfg.size)
                res[key] = {"ms": ms, "mlups": nsite / (ms * 1e3),
                            "kernels": kernels, "device_ms": dev_ms,
                            "host_syncs": len(caught),
                            "run_text_s": wall_s, "peak_gb": peak_gb,
                            "top": [(k[:60], c, round(t, 4))
                                    for k, c, t in top], **extra}
                print(f"{key} 128^3 f32: {ms:.3f} ms a step (CUDA events), "
                      f"{nsite / (ms * 1e3):.1f} MLUPS, {kernels} CUDA "
                      f"kernels a step, {dev_ms} ms of them on the device "
                      f"(torch.profiler, 1 step); one step under the sync "
                      f"debug mode 'error': {len(caught)} host syncs; "
                      f"run_text x {LC_CELL_CYCLES} cycles {wall_s:.2f} s, "
                      f"peak {peak_gb:.2f} GB, scans {paths[label]} [{card}]")
                for k, v in extra.items():
                    print(f"    {k}: {v}")
                for name, count, k_ms in top[:3]:
                    print(f"    {k_ms:.4f} ms device, {count:.0f} a step: "
                          f"{name[:90]}")
                if label == "lc-walls":
                    res[key]["matvec_in_field_dtype"] = matvec_cost(run)
            del sys_, holder
    return res, paths


FAMILY_SIZE = (16, 16, 32)
FAMILY_FE = SymmetricFE(a=-0.0625, b=0.0625, kappa=0.04)
# the colloid routes of the binary families and the electrolyte, and the
# repaired LC colloid route (phase 33's lc_route)
FAMILY_ROUTES = ("binary two walls z wetting", "binary five",
                 "symmetric_lb two walls z wetting", "symmetric_lb five",
                 "electro gradmu", "electro divstress", "lc colloids",
                 "lc colloids walls z s7 normal")


def family_route(name, dtype, device, size=FAMILY_SIZE):
    """(step, state) of a FAMILY_ROUTES route at `size` on `device`, from
    numpy seeds (the card and the CPU start from the same bits)."""
    import numpy as np

    from ludwig_tpu_torch import binary_colloid, binary_lb, electro_colloid
    from ludwig_tpu_torch.binary import BinaryConfig
    from ludwig_tpu_torch.colloids import ColloidParams
    from ludwig_tpu_torch.electro import ElectroConfig
    from ludwig_tpu_torch.electro_sim import ElectroSimConfig
    from ludwig_tpu_torch.ops.walls import WallSpec

    if name.startswith("lc "):
        return lc_route(name[3:], dtype, device, size)
    rng = np.random.default_rng(35)
    words = name.split()
    lb = LBConfig(size=size, nvel=19, eta_shear=0.1, dtype=dtype,
                  device=device)
    tdt = getattr(torch, dtype)
    if words[0] == "electro":
        ecfg = ElectroSimConfig(lb=lb, ek=ElectroConfig(
            valency=(1, -1), diffusivity=(0.01, 0.0095), beta=3.0e4,
            epsilon=3.3e3, rel_tol=1e-6, abs_tol=1e-9, max_its=200),
            e0=(2e-5, 0.0, 0.0))
        cp = ColloidParams(a0=(2.3,), ah=(2.3,))
        rho = 1e-3 + 1e-4 * rng.random((2,) + size)
        R0 = np.array([[6.3, 7.6, 14.2]])
        V0 = np.array([[0.03, -0.02, 0.01]])
        state = list(electro_colloid.initial_electro_colloid(
            ecfg, cp, np.zeros(size), rho, R0, V0))
        state[4] = state[2].clone()            # a move at once
        q = torch.as_tensor([[5.0, 0.0]], dtype=tdt, device=device)
        method = ("stress_divergence" if words[1] == "divstress"
                  else "phi_gradmu_correction")
        return (electro_colloid.make_electro_colloid_step(
            ecfg, cp, q, rebuild_freq=2, force_method=method), tuple(state))
    walled = "walls" in words
    ws = WallSpec(walls=(False, False, True)) if walled else None
    wet = (-0.002, 0.001) if "wetting" in words else (0.0, 0.0)
    if words[1] == "two":
        cp = ColloidParams(a0=(2.3, 2.3), ah=(2.3, 2.3),
                           gravity=(0.0, 0.0, -1e-4))
        R0 = np.array([[4.2, 7.1, 9.6], [11.3, 8.6, 21.7]])
    else:
        cp = ColloidParams(a0=(1.8,) * 5, ah=(1.8,) * 5)
        R0 = np.array([[3.5, 3.5, 4.0], [12.5, 4.5, 11.6], [4.2, 12.6, 19.5],
                       [12.8, 12.4, 27.3], [8.0, 7.7, 24.9]])
    V0 = 0.01 * rng.standard_normal((cp.n, 3))
    phi0 = 0.2 * np.tanh(rng.standard_normal(size))
    if words[0] == "binary":
        cfg = BinaryConfig(lb=lb, fe=FAMILY_FE, mobility=0.15, wetting=wet)
        state = binary_colloid.initial_binary_colloid(
            cfg, cp, phi0, R0, V0, dr0=V0, walls=walled)
        step = binary_colloid.make_binary_colloid_step(
            cfg, cp, rebuild_freq=2, phi_ref=0.01, wallspec=ws)
    else:
        cfg = binary_lb.BinaryLBConfig(lb=lb, fe=FAMILY_FE, mobility=0.15,
                                       gradient="3d_27pt_solid")
        state = binary_lb.initial_binary_lb_colloid(
            cfg, cp, phi0, R0, V0, dr0=V0, walls=walled)
        step = binary_lb.make_binary_lb_colloid_step(
            cfg, cp, rebuild_freq=2, phi_ref=0.01, wetting=wet, wallspec=ws)
    f = 1.0 / 19.0 + 1e-3 * rng.standard_normal((19,) + size)
    state = (torch.as_tensor(f, dtype=tdt, device=device),) + state[1:]
    return step, state


FAMILY_SMALL = """
N_cycles 4
size 12_12_12
viscosity 0.1
freq_statistics 2
"""
FAMILY_BINARY_KEYS = """A -0.0625
B 0.0625
K 0.04
mobility 0.15
phi_initialisation spinodal
noise 0.05
random_seed 13
colloid_init input_two
colloid_one_a0 2.3
colloid_one_ah 2.3
colloid_one_r 4.0_6.5_6.5
colloid_one_v 0.01_0.0_0.0
colloid_two_a0 2.3
colloid_two_ah 2.3
colloid_two_r 9.5_6.5_7.0
colloid_one_c -0.002
colloid_one_h 0.001
colloid_gravity 0.0_0.0_-0.0001
"""
FAMILY_ELECTRO_KEYS = """free_energy fe_electro
electrokinetics_d0 0.01
electrokinetics_d1 0.01
electrokinetics_epsilon 3300.0
temperature 3.33333333333333333e-5
electrokinetics_init uniform
electrokinetics_init_rho_el 0.001
electrokinetics_rel_tol 1e-06
electrokinetics_abs_tol 1e-07
electrokinetics_maxits 500
electric_e0 0.00002_0.0_0.0
colloid_init input_one
colloid_one_a0 2.3
colloid_one_ah 2.3
colloid_one_r 6.25_6.6_6.3
colloid_one_v 0.05_0.0_0.0
colloid_one_q0 5.0
"""
# one input of each family (tests/test_torch_cli.py's), in float64
FAMILY_INPUTS = {
    "binary walls": FAMILY_SMALL + FAMILY_BINARY_KEYS
    + "free_energy symmetric\nboundary_walls 0_0_1\n",
    "symmetric_lb": FAMILY_SMALL + FAMILY_BINARY_KEYS
    + "free_energy symmetric_lb\nfd_gradient_calculation 3d_7pt_fluid\n",
    "electro": FAMILY_SMALL + FAMILY_ELECTRO_KEYS,
}
FAMILY_TAGS = LC_TAGS + ("[psi_zeta]", "[colloids]")


def family_log(log):
    """lc_log over the families' statistics rows too."""
    body = log[log.index("\nInitial conditions."):log.index("\nTimer")]
    words, vals = [], []
    for line in body.splitlines():
        words.append(" ".join(NUMBER.sub(" # ", line).split()))
        if line.startswith(FAMILY_TAGS):
            rest = line.split("]", 1)[1] if "]" in line else line[12:]
            vals += [float(v) for v in NUMBER.findall(rest)]
    return words, torch.tensor(vals, dtype=torch.float64)


def phase35():
    phase("35 the binary, symmetric_lb and electrolyte colloids and the "
          "repaired LC colloid route on the card vs the CPU")
    worst = 0.0
    for name in FAMILY_ROUTES:
        for dtype in ("float64", "float32"):
            got = {}
            for device in ("cuda", "cpu"):
                step, state = family_route(name, dtype, device)
                for t in range(3):
                    state, _ = step(state, t)
                got[device] = state
            walls = (False, False, True) if "walls" in name else None
            a, b = got["cuda"], got["cpu"]
            if name.startswith("electro"):
                # deltaq: the charge the put-back left, a difference of
                # sums of the particle's charge 5: held at TOL's rtol of 5
                dq_tol = TOL[b[10].dtype]["rtol"] * 5.0
                if not torch.allclose(a[10].cpu(), b[10], rtol=0.0,
                                      atol=dq_tol):
                    raise AssertionError(f"{name} {dtype}: deltaq differs "
                                         f"by {max_err(a[10].cpu(), b[10])}")
                a, b = a[:10], b[:10]
            err = hold_more_fe_states(f"{name} {dtype}", a, b, walls,
                                      scaled=name.startswith("electro"))
            if dtype == "float64":
                worst = max(worst, err)
            print(f"colloids {name} {dtype}: 3 steps at 16x16x32 on the "
                  f"card against the CPU within {TOL[getattr(torch, dtype)]}"
                  f", max |diff| {err:.3e}")
    counts = {}
    for name, text in FAMILY_INPUTS.items():
        logs = {}
        for device in ("cuda", "cpu"):
            _cuda.launches.reset()
            out = io.StringIO()
            run_text(text, out=out, device=device)
            logs[device] = out.getvalue()
            if device == "cuda":
                counts[f"colloids {name} f64"] = stat_scan_counts()
        (wa, a), (wb, b) = (family_log(logs[k]) for k in ("cuda", "cpu"))
        if (wa != wb or a.numel() == 0
                or not torch.allclose(a, b, rtol=1e-9, atol=1e-11)):
            raise AssertionError(f"colloid input {name}: the card's log "
                                 "differs from the CPU's")
        print(f"colloid input {name} f64 through run_text: {len(wa)} lines "
              f"the same but their numbers, {a.numel()} floats on the card "
              f"agree with the CPU's (rtol 1e-9, atol 1e-11), max |diff| "
              f"{float((a - b).abs().max()):.3e}")
    return worst, counts


FAMILY_CELL_CYCLES = 20


def random_colloids(directory, n=1000, a0=4.0, L=128, seed=36):
    """config.cds.init in `directory`: n particles of radius a0 at rest,
    placed at random in an L^3 periodic box without overlap (a gap of one
    site), from a numpy seed (1-based centres)."""
    import os

    import numpy as np

    from ludwig_tpu_torch.io.colloid_io import (default_state,
                                                write_colloid_file)
    rng = np.random.default_rng(seed)
    pos = np.zeros((0, 3))
    while len(pos) < n:
        r = rng.uniform(0.0, L, 3)
        d = pos - r
        d -= L * np.round(d / L)
        if len(pos) == 0 or np.min(np.sum(d * d, axis=1)) > (2 * a0 + 1) ** 2:
            pos = np.vstack([pos, r])
    recs = []
    for i, r in enumerate(pos):
        rec = default_state()
        rec["index"] = i + 1
        rec["a0"] = rec["ah"] = a0
        rec["r"] = [0.5 + float(c) for c in r]
        rec["m"] = [1.0, 0.0, 0.0]
        recs.append(rec)
    write_colloid_file(os.path.join(directory, "config.cds.init"), recs)


FAMILY_128 = (BINARY_INPUT.replace("size 256_256_256", "size 128_128_128")
              .replace("tpu_fused on\n", "")
              .replace(f"N_cycles {BINARY_CYCLES}",
                       f"N_cycles {FAMILY_CELL_CYCLES}")
              .replace("freq_statistics 10",
                       f"freq_statistics {FAMILY_CELL_CYCLES}")
              + "colloid_init from_file\ncolloid_file_stub @DIR@/config.cds\n"
              "colloid_rebuild_freq 1\ncolloid_one_c 0.0\ncolloid_one_h 0.0\n")
# the three full-width cells: 1000 particles of radius 4 at random (12.8%
# by volume) in the spinodal binary fluid and in symmetric_lb at 128^3
# (bijels, Pickering emulsions), and one charged particle of radius 4 in
# the Gouy-Chapman bench's uniform electrolyte at 64^3 without its walls,
# a field on x (electrophoresis)
FAMILY_CELLS = {
    "binary-colloids 128^3": FAMILY_128,
    "binary-lb-colloids 128^3": FAMILY_128.replace(
        "free_energy symmetric", "free_energy symmetric_lb")
    .replace("fd_advection_scheme_order 2\n", ""),
    "electro-colloid 64^3": f"""
dtype float32
N_cycles {FAMILY_CELL_CYCLES}
freq_statistics {FAMILY_CELL_CYCLES}
size 64_64_64
viscosity 0.1
free_energy fe_electro
electrokinetics_z0 1
electrokinetics_z1 -1
electrokinetics_d0 0.01
electrokinetics_d1 0.01
electrokinetics_eunit 1.0
electrokinetics_epsilon 3300.0
temperature 3.33333333333333333e-5
electrokinetics_init uniform
electrokinetics_init_rho_el {ELEC_RHO_EL}
electrokinetics_solver_type sor
electrokinetics_rel_tol 1e-8
electrokinetics_abs_tol 1e-15
electrokinetics_maxits 10000
electric_e0 0.0001_0.0_0.0
colloid_init input_one
colloid_one_a0 4.0
colloid_one_ah 4.0
colloid_one_r 32.5_32.5_32.5
colloid_one_q0 10.0
colloid_rebuild_freq 1
""",
}


def phase36(card):
    phase(f"36 the binary, symmetric_lb and electrolyte colloids at full "
          f"width f32 on {card}")
    import tempfile
    import warnings

    from ludwig_tpu_torch.ludwig import build_system
    from ludwig_tpu_torch.runtime import RunTime
    res, paths = {}, {}
    with tempfile.TemporaryDirectory() as d:
        random_colloids(d)
        for label, text in FAMILY_CELLS.items():
            text = text.replace("@DIR@", d)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _cuda.launches.reset()
            log = io.StringIO()
            t0 = time.perf_counter()
            sys_ = run_text(text, out=log, device="cuda")
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            paths[label] = {**stat_scan_counts(),
                            "chain_sums": _cuda.launches.chain_sums}
            out = log.getvalue()
            if f"Completed cycle {FAMILY_CELL_CYCLES}" not in out:
                raise AssertionError(f"{label}: cycles incomplete")
            if not all(torch.isfinite(x).all() for x in sys_.state
                       if x.is_floating_point()):
                raise AssertionError(f"{label}: the state is not finite")
            electro = label.startswith("electro")
            fe_rows = [ln for ln in out.splitlines() if ln.startswith("[fe]")]
            extra = {"fe": fe_rows[-1],
                     "colloid_v_max": [ln for ln in out.splitlines()
                                       if ln.startswith("[maximum ]")][-2]}
            if electro:
                extra["psi_zeta"] = [ln for ln in out.splitlines()
                                     if ln.startswith("[psi_zeta]")][-1]
            del sys_
            # the step alone: ms (CUDA events), kernels and device time
            # (torch.profiler), rebuild steps apart from the others, one
            # step under the sync debug mode
            sys_ = build_system(RunTime(text), "cuda")
            for rebuild in (True, False):
                holder = {"s": sys_.state, "t": 1}

                def run():
                    holder["s"], holder["aux"] = sys_.step_fn(
                        holder["s"], holder["t"], rebuild=rebuild)
                    holder["t"] += 1

                ms = time_ms(run, 5, warm=2)
                kernels, dev_ms, top = post_profile(run, reps=1)
                torch.cuda.synchronize()
                mode = "warn" if electro else "error"
                torch.cuda.set_sync_debug_mode(mode)
                try:
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        run()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                syncs = len(caught)
                if electro:
                    # the SOR's read-backs: every 5 iterations from the first
                    k = int(holder["aux"][2][0])
                    max_its = sys_.electro_cfg.ek.max_its
                    want = min(k // 5 + 1, max_its // 5)
                    if syncs != want:
                        raise AssertionError(
                            f"{label}: {syncs} host syncs in a step, the "
                            f"SOR's read-backs are {want}")
                key = f"{label} {'rebuild' if rebuild else 'no rebuild'}"
                nsite = math.prod(sys_.lb_cfg.size)
                res[key] = {"ms": ms, "mlups": nsite / (ms * 1e3),
                            "kernels": kernels, "device_ms": dev_ms,
                            "host_syncs": syncs, "run_text_s": wall_s,
                            "peak_gb": peak_gb,
                            "top": [(k_[:60], c, round(t, 4))
                                    for k_, c, t in top], **extra}
                print(f"{key} f32: {ms:.3f} ms a step (CUDA events), "
                      f"{nsite / (ms * 1e3):.1f} MLUPS, {kernels} CUDA "
                      f"kernels a step, {dev_ms} ms of them on the device "
                      f"(torch.profiler, 1 step); one step under the sync "
                      f"debug mode '{mode}': {syncs} host syncs; run_text x "
                      f"{FAMILY_CELL_CYCLES} cycles {wall_s:.2f} s, peak "
                      f"{peak_gb:.2f} GB, launches {paths[label]} [{card}]")
                for k_, v in extra.items():
                    print(f"    {k_}: {v}")
                for name, count, k_ms in top[:3]:
                    print(f"    {k_ms:.4f} ms device, {count:.0f} a step: "
                          f"{name[:90]}")
            del sys_, holder
    return res, paths


# -- the two-dimensional fluid: D2Q9 on the one-step kernels -----------------

Q9_SCHEMES = ("m10", "bgk")      # TRT is not defined for D2Q9 (ref asserts)
Q9_SHAPES = ((64, 64, 1), (128, 96, 1))
Q9_SIZE = (4096, 4096, 1)        # the timed lattice: 2 x 604 MB of state


def phase37(card, gen):
    """D2Q9 on fused_lb_q9: fused_step and its fluctuating variant against
    their twins, 3 chained steps, f64 and f32, both back-transform forms;
    the n-step and force kernels refuse D2Q9 by name, as the JAX package's
    do; then each kernel at 4096x4096x1 f32 against its bound and the
    device copy of the state."""
    phase(f"37 D2Q9 kernels vs plain twins and timed at 4096x4096x1 f32 on "
          f"{card}")
    worst = {"fused_step": 0.0, "fused_step_noise": 0.0}
    for size in Q9_SHAPES:
        for scheme in Q9_SCHEMES:
            for dtype in ("float64", "float32"):
                cfg, params, noise = noise_params(
                    9, RelaxationScheme(scheme), dtype, size,
                    force=(1e-4, -2e-4, 0.0))
                model = cfg.model
                f0 = rand_state(cfg, gen)
                for delta in (True, False):
                    a = b = f0
                    for _ in range(3):
                        a = fused.fused_step(a, model, params, delta=delta)
                        b = fused._fused_step_plain(b, model, params, delta)
                    what = (f"fused_step D2Q9 {size} {scheme} {dtype} "
                            f"delta={delta}")
                    err = check_close(what, a, b, cfg.tdtype)
                    worst["fused_step"] = max(worst["fused_step"], err)
                    a = b = f0
                    for t in range(NOISE_STEP0, NOISE_STEP0 + 3):
                        a = fused.fused_step(a, model, params, noise=noise,
                                             t=t, delta=delta)
                        b = fused._fused_step_plain(b, model, params, delta,
                                                    noise, t)
                    nerr = check_close(f"{what} noise", a, b, cfg.tdtype)
                    worst["fused_step_noise"] = max(
                        worst["fused_step_noise"], nerr)
                    print(f"{what} max_abs_err {err:.3e}, with noise "
                          f"{nerr:.3e}")
    # refused by name on the card: no fallback to a twin
    cfg = LBConfig(size=Q9_SHAPES[0], nvel=9, dtype="float32", device="cuda")
    f0 = rand_state(cfg, gen)
    force = torch.zeros((3,) + cfg.size, dtype=cfg.tdtype, device="cuda")
    for name, call in (
            ("fusedn_step", lambda: fused.fusedn_step(
                f0, cfg.model, cfg.collision_params(), 2)),
            ("fused_force_step", lambda: fused.fused_force_step(
                f0, force, cfg.model, cfg.collision_params()))):
        try:
            call()
        except NotImplementedError as e:
            print(f"{name} D2Q9 refused: {e}")
        else:
            raise AssertionError(f"{name} ran D2Q9 on the card")

    cfg, params, noise = noise_params(9, RelaxationScheme.M10, "float32",
                                      Q9_SIZE, 0.1, (0.0, 0.0, 0.0))
    model = cfg.model
    nsite = Q9_SIZE[0] * Q9_SIZE[1] * Q9_SIZE[2]
    f0 = rand_state(cfg, gen, amp=0.01)
    nbytes = 2 * f0.numel() * f0.element_size()
    dst = torch.empty_like(f0)
    copy_ms = time_ms(lambda: dst.copy_(f0), 20)
    del dst
    print(f"device copy of the D2Q9 state: {copy_ms:.4f} ms = "
          f"{nbytes / (copy_ms * 1e9):.3f} TB/s read+write [{card}]")
    t = NOISE_STEP0
    res = {}
    for name, run, twin in (
            ("fused_step", lambda: fused.fused_step(f0, model, params),
             lambda: fused._fused_step_plain(f0, model, params, True)),
            ("fused_step_noise", lambda: fused.fused_step(
                f0, model, params, noise=noise, t=t),
             lambda: fused._fused_step_plain(f0, model, params, True, noise,
                                             t))):
        err = check_close(f"{name} D2Q9 {Q9_SIZE}", run(), twin(),
                          cfg.tdtype)
        ms = min(time_ms(run, 20) for _ in range(2))
        twin_ms = time_ms(twin, 2, warm=1)
        nops = nsite * _cuda.site_ops(name, nvel=9)
        b_ms, b_by = bound(nbytes, nops)
        cb_ms = copy_ms
        print(f"{name} D2Q9 {Q9_SIZE[0]}x{Q9_SIZE[1]}x{Q9_SIZE[2]} f32: "
              f"kernel {ms:.4f} ms, twin {twin_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {nbytes / nsite:.0f} B/site, "
              f"{nops / nsite:.0f} op/site), {100 * b_ms / ms:.1f}% of it, "
              f"copy bound {cb_ms:.4f} ms ({100 * cb_ms / ms:.1f}%), "
              f"max_abs_err vs twin {err:.3e}, "
              f"{nsite / (ms * 1e3):.1f} MLUPS [{card}]")
        res[name] = dict(ms=ms, plain_ms=twin_ms, max_abs_err=max(
            err, worst[name]), nbytes=nbytes, nops=nops, copy_ms=cb_ms)
    return res


# -- the full log: headers, probes and the 2-D fluid through run_text --------

KH_SIZE = (4096, 4096, 1)
KH_CYCLES = 20
KH_KEYS = """lb_nvel 9
free_energy none
viscosity 0.1
distribution_initialisation 2d_kelvin_helmholtz
2d_kelvin_helmholtz_u0 0.04
2d_kelvin_helmholtz_delta 0.05
2d_kelvin_helmholtz_kappa 80.0
"""
KH_INPUT = (f"size {KH_SIZE[0]}_{KH_SIZE[1]}_{KH_SIZE[2]}\ntpu_fused on\n"
            f"dtype float32\nN_cycles {KH_CYCLES}\n"
            f"freq_statistics {KH_CYCLES}\ntpu_timer_detail on\n" + KH_KEYS)
# the fluctuating shear layer: fused_step_noise's path
KH_NOISE_INPUT = ("size 1024_1024_1\ntpu_fused on\ndtype float32\n"
                  "N_cycles 10\nfreq_statistics 10\n" + KH_KEYS + NOISE_KEYS)
# one small input per family in float64, run on the card and on the CPU
LOG_INPUTS = {
    "none": "tpu_fused off\ndtype float64\n" + BOUNDARY_INPUTS["wall"],
    "none le": "tpu_fused on\ndtype float64\n" + BOUNDARY_INPUTS["le"],
    "none porous": "dtype float64\n" + BOUNDARY_INPUTS["porous"],
    "d2q9": "size 64_48_1\ntpu_fused on\ndtype float64\nN_cycles 4\n"
            "freq_statistics 2\n" + KH_KEYS,
    "symmetric": (BINARY_INPUT.replace("dtype float32", "dtype float64")
                  .replace("size 256_256_256", "size 16_16_32")
                  .replace(f"N_cycles {BINARY_CYCLES}", "N_cycles 4")
                  .replace("freq_statistics 10", "freq_statistics 2")),
    "lc_blue_phase": LC_SMALL,
    "lc_droplet": drop_input((16, 16, 32), "float64").replace(
        f"N_cycles {DROP_CYCLES}", "N_cycles 4").replace(
        "freq_statistics 10", "freq_statistics 2"),
    # the Gouy-Chapman input at 16x4x4 (its f64 route is the reference
    # one); the families' colloid inputs are phase 35's
    "fe_electro": elec_input((16, 4, 4), "float64").replace(
        f"N_cycles {ELEC_CYCLES}", "N_cycles 4").replace(
        "freq_statistics 10", "freq_statistics 2"),
    "symmetric_lb": MORE_FE_INPUTS["symmetric_lb_walls"],
    "brazovskii": MORE_FE_INPUTS["brazovskii"],
    "surfactant": MORE_FE_INPUTS["surfactant"],
    "ternary": MORE_FE_INPUTS["ternary_tee_walls"],
    "polar_active": MORE_FE_INPUTS["polar_active"],
    "fe_electro_symmetric": MORE_FE_INPUTS["fe_electro_symmetric"],
}
FINISH = "Ludwig finished normally."


def log_header(log):
    """A log's input header, up to and including "Initial conditions."."""
    return log[:log.index("\nInitial conditions.\n") + 21]


def cpu_header(text):
    """The input header the port writes for `text` on the CPU, without
    stepping: the system built there and its InitLog (fulllog.py)."""
    from ludwig_tpu_torch import ludwig as tl
    from ludwig_tpu_torch.fulllog import InitLog
    from ludwig_tpu_torch.runtime import RunTime
    rt = RunTime(text)
    sys_ = tl.build_system(rt, device="cpu")
    sys_.hydro_on = rt.switch("hydrodynamics", True)
    buf = io.StringIO()
    InitLog(rt, sys_, buf).emit()
    return buf.getvalue()


def log_body_close(a, b, what):
    """The logs' lines from "Initial conditions." to the timer table:
    the same words, and their numbers within rtol 1e-9 / atol 1e-11, as
    phase 17 holds the electrolyte: a [psi] or [elc] total, which
    cancels to ~0, within 1e-12 x sites x the largest value, the SOR
    report's iterations equal and its residual (a rounding-level sum
    once converged) not compared.  Returns the number of floats held and
    their largest difference."""
    def body(log):
        log = log[log.index("\nInitial conditions."):
                  log.index("\nTimer resolution")]
        words, vals, loose = [], [], []
        for line in log.splitlines():
            if line.startswith("SOR residual"):
                words.append(" ".join(NUMBER.sub(" # ", line, count=1)
                                      .split()))
                continue
            words.append(" ".join(NUMBER.sub(" # ", line).split()))
            nums = [float(v) for v in NUMBER.findall(line)]
            vals += nums
            loose += [line.startswith(("[psi]", "[elc]")) and i == 0
                      for i in range(len(nums))]
        return (words, torch.tensor(vals, dtype=torch.float64),
                torch.tensor(loose, dtype=torch.bool))
    (wa, va, la), (wb, vb, _) = body(a), body(b)
    if wa != wb or va.numel() != vb.numel():
        bad = next((x, y) for x, y in zip(wa + [""], wb + [""]) if x != y)
        raise AssertionError(f"{what}: the lines of the card's log are not "
                             f"the CPU's: {bad}")
    nsite = math.prod(int(v) for v in re.search(
        r"System size:\s+(\d+) (\d+) (\d+)", a).groups())
    scale = 1e-12 * nsite * float(vb.abs().max()) if vb.numel() else 0.0
    if not (torch.allclose(va[~la], vb[~la], rtol=1e-9, atol=1e-11)
            and torch.allclose(va[la], vb[la], rtol=0.0, atol=scale)):
        k = int(torch.argmax((va - vb).abs()))
        raise AssertionError(f"{what}: the card's statistics differ from "
                             f"the CPU's beyond the tolerance: "
                             f"{float(va[k])!r} against {float(vb[k])!r}")
    return va.numel(), max_err(va, vb) if va.numel() else 0.0


def probe_rows(log):
    """{row: seconds} of the timer-detail probes after the timer table."""
    return {ln.split(":")[0].strip(): float(ln.split()[-2])
            for ln in log.splitlines() if ln.endswith("(probe)")}


def phase38(card):
    """The full log on the card: the 256^3 main input with the timer
    probes, the 4096x4096x1 Kelvin-Helmholtz shear layer on fused_lb_q9
    (20 cycles, ms a step) and a fluctuating one, then one small input
    per family in float64 on the card and on the CPU: headers equal as
    text, statistics within rtol 1e-9 / atol 1e-11, each log ending with
    "Ludwig finished normally."."""
    phase(f"38 the full log on the card: headers, probes and the 2-D fluid "
          f"on {card}")
    counts, cells = {}, {}
    for name, text, kernel, cycles in (
            ("main 256^3 timer detail", MAIN_INPUT + "tpu_timer_detail on\n",
             "fused_step", MAIN_CYCLES),
            ("kh 4096x4096x1", KH_INPUT, "fused_step", KH_CYCLES),
            ("kh noise 1024x1024x1", KH_NOISE_INPUT, "fused_step_noise",
             10)):
        out = io.StringIO()
        torch.cuda.synchronize()
        _cuda.launches.reset()
        t0 = time.perf_counter()
        sys_ = run_text(text, out=out, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = getattr(_cuda.launches, kernel)
        counts[name] = {kernel: n}
        log = out.getvalue()
        rows = probe_rows(log)
        nprobe = 4 if rows else 0     # a warm-up call and three timed
        if n != cycles + nprobe:
            raise AssertionError(f"{name}: {kernel} launched {n} times for "
                                 f"{cycles} cycles and {nprobe} probes")
        if not log.rstrip().endswith(FINISH):
            raise AssertionError(f"{name}: the log does not end with "
                                 f"{FINISH!r}")
        if log_header(log) != cpu_header(text):
            raise AssertionError(f"{name}: the card's input header is not "
                                 "the CPU's")
        nsite = math.prod(sys_.lb_cfg.size)
        totals = [float(v) for v in re.findall(r"\[rho\]\s+(\S+)", log)]
        if not totals or not all(abs(t - nsite) <= 1e-5 * nsite
                                 for t in totals):
            raise AssertionError(f"{name}: [rho] totals {totals} != {nsite}")
        if re.search(r"(?i)\b-?(nan|inf)\b", log):
            raise AssertionError(f"{name}: a statistic is not finite")
        line = (f"{name}: run_text {wall:.2f} s, {kernel} x {n}, header "
                f"equal to the CPU's, [rho] {totals}")
        if rows:
            line += ", probes " + ", ".join(f"{k} {1e3 * v:.4f} ms"
                                            for k, v in rows.items())
        if name.startswith("kh 4096"):
            if sys_.lb_cfg.nvel != 9 or sys_.fused_mode != "plain":
                raise AssertionError(f"{name}: not the fused D2Q9 route")
            f = sys_.state[0]
            ms = min(time_ms(lambda: sys_.step_fn(f, 1), 20)
                     for _ in range(2))
            # the row's last column: seconds a cycle to 1e-6
            loop = re.search(r"Time step loop:(?:\s+\S+){3}\s+(\S+)",
                             log).group(1)
            cells[name] = dict(ms_step=ms, run_text_s=wall,
                               loop_s_per_cycle=float(loop),
                               probe_ms={k: 1e3 * v
                                         for k, v in rows.items()})
            line += (f", step {ms:.4f} ms = {nsite / (ms * 1e3):.1f} MLUPS, "
                     f"the timer's loop {float(loop):.4f} s a cycle")
        elif rows:
            cells[name] = dict(run_text_s=wall, probe_ms={
                k: 1e3 * v for k, v in rows.items()})
        print(line + f" [{card}]")
        if "Collide+stream" not in rows and kernel == "fused_step":
            raise AssertionError(f"{name}: no Collide+stream probe row")
        del sys_
        torch.cuda.empty_cache()
    worst = 0.0
    for name, text in LOG_INPUTS.items():
        logs = {}
        for device in ("cuda", "cpu"):
            out = io.StringIO()
            run_text(text, out=out, device=device)
            logs[device] = out.getvalue()
        if log_header(logs["cuda"]) != log_header(logs["cpu"]):
            raise AssertionError(f"{name}: the card's input header is not "
                                 "the CPU's")
        nval, err = log_body_close(logs["cuda"], logs["cpu"], name)
        for device, log in logs.items():
            if not log.rstrip().endswith(FINISH):
                raise AssertionError(f"{name} on {device}: the log does not "
                                     f"end with {FINISH!r}")
        worst = max(worst, err)
        print(f"{name} f64: header of {log_header(logs['cuda']).count(chr(10))}"
              f" lines equal to the CPU's, {nval} floats within rtol 1e-9 "
              f"(max |diff| {err:.3e})")
    return counts, cells, worst


# -- the fluctuations of every family (phases 39-40) -------------------------

STREAM_SHAPE = (5, 128, 128, 128)
STREAM_SEEDS = (0, 13, 8361235)
LC_NOISE_KEYS = "temperature 0.0001\nlc_noise 1\nrandom_seed 17\n"
LC_NOISE_128 = LC_128.replace("tpu_fused on\n", "") + LC_NOISE_KEYS
LC_NOISE_SMALL = (LC_SMALL.replace("size 8_8_16", "size 16_16_16")
                  + LC_NOISE_KEYS + "isothermal_fluctuations on\n")
NOISE_SMALL = {
    "lc lc_noise isothermal 16^3": LC_NOISE_SMALL,
    "colloids input_two 16^3": "dtype float64\n"
    + COLLOID_INPUTS["input_two"] + NOISE_KEYS,
    "subgrid 24x8x16": "dtype float64\n" + COLLOID_INPUTS["subgrid"]
    + NOISE_KEYS,
    "brazovskii 8x8x16": MORE_FE_INPUTS["brazovskii"] + NOISE_KEYS,
}
BRAZ_NOISE_128 = MORE_FE_CELLS["brazovskii 128^3"] + NOISE_KEYS


def kt_ratio(log):
    """The last [measd/kT] row's measured kT over the input's (the row
    prints the sum over the dimensions and kT times their number)."""
    rows = [ln.split() for ln in log.splitlines()
            if ln.startswith("[measd/kT]")]
    if not rows:
        raise AssertionError("no [measd/kT] row in the log")
    return float(rows[-1][1]) / float(rows[-1][2])


def card_vs_cpu_log(name, text):
    """text run on the card and on the CPU: the headers equal as text,
    the statistics within rtol 1e-9 / atol 1e-11 (log_body_close), both
    ending normally.  Returns (floats held, max |diff|, the card's log)."""
    logs = {}
    for device in ("cuda", "cpu"):
        out = io.StringIO()
        run_text(text, out=out, device=device)
        logs[device] = out.getvalue()
        if not logs[device].rstrip().endswith(FINISH):
            raise AssertionError(f"{name} on {device}: the log does not end "
                                 f"with {FINISH!r}")
    if log_header(logs["cuda"]) != log_header(logs["cpu"]):
        raise AssertionError(f"{name}: the card's input header is not the "
                             "CPU's")
    nval, err = log_body_close(logs["cuda"], logs["cpu"], name)
    return nval, err, logs["cuda"]


def step_cost(sys_, rebuild=None, reps=5):
    """(ms a step by CUDA events, CUDA kernels a step, device ms a step by
    torch.profiler, host syncs of one step under the sync debug mode
    'error') of sys_'s step from its state."""
    import warnings
    holder = {"s": sys_.state, "t": 1}

    def run():
        kw = {} if rebuild is None else {"rebuild": rebuild}
        holder["s"], _aux = sys_.step_fn(holder["s"], holder["t"], **kw)
        holder["t"] += 1

    ms = time_ms(run, reps, warm=2)
    kernels, dev_ms, _top = post_profile(run, reps=1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return ms, kernels, dev_ms, len(caught)


def phase39(card):
    """The threefry stream on the card bitwise the CPU's and its time at
    5 x 128^3; the 128^3 f32 blue phase with the Q noise through
    run_text; a 16^3 f64 input with the Q noise and the kT statistics,
    the card's log against the CPU's."""
    phase(f"39 the threefry stream and the fluctuating liquid crystal on "
          f"{card}")
    from ludwig_tpu_torch import noise as tnoise
    from ludwig_tpu_torch.ludwig import build_system
    from ludwig_tpu_torch.runtime import RunTime
    res, paths = {}, {}
    shape = STREAM_SHAPE[1:]
    for seed in STREAM_SEEDS:
        for step in (0, 1):
            a = tnoise.discrete_deviates(seed, step, STREAM_SHAPE[0], shape,
                                         torch.float32, device="cuda")
            b = tnoise.discrete_deviates(seed, step, STREAM_SHAPE[0], shape,
                                         torch.float32, device="cpu")
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"threefry seed {seed} step {step}: "
                                     "the card's deviates are not the CPU's")
    ms = min(time_ms(lambda: tnoise.discrete_deviates(
        13, 5, STREAM_SHAPE[0], shape, torch.float32, device="cuda"), 5)
        for _ in range(2))
    n = math.prod(STREAM_SHAPE)
    # the int64 passes: 2 words read and written each of 7 operations a
    # round, 20 rounds; the floor of one output word written
    res["stream"] = dict(shape=list(STREAM_SHAPE), ms=ms,
                         passes_bound_ms=1e3 * 20 * 7 * 2 * 8 * n
                         / PEAK_BYTES_PER_S,
                         write_bound_ms=1e3 * 4 * n / PEAK_BYTES_PER_S)
    print(f"threefry: 3 seeds x 2 steps at {STREAM_SHAPE} bitwise the "
          f"CPU's; discrete_deviates {ms:.3f} ms (CUDA events; its int64 "
          f"passes move at least {res['stream']['passes_bound_ms']:.3f} ms "
          f"of bytes, the output alone "
          f"{res['stream']['write_bound_ms']:.4f} ms) [{card}]")

    # the 128^3 f32 blue phase with the Q noise, 20 cycles of run_text
    log = io.StringIO()
    torch.cuda.synchronize()
    _cuda.launches.reset()
    t0 = time.perf_counter()
    sys_ = run_text(LC_NOISE_128, out=log, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths["lc noise 128^3 f32"] = stat_scan_counts()
    out = log.getvalue()
    if (f"Completed cycle {LC_CELL_CYCLES}" not in out
            or "LC fluctuations:           =  on" not in out):
        raise AssertionError("lc noise 128^3: log incomplete")
    if sys_.fused_mode is not None or sys_.lc_cfg.noise_kt != 1e-4:
        raise AssertionError("lc noise 128^3: not the unfused noisy route")
    q5 = sys_.state[1]
    if not bool(torch.isfinite(q5).all()):
        raise AssertionError("lc noise 128^3: Q is not finite")
    # the full tensor of the noisy Q: symmetric, traceless to f32 rounding
    from ludwig_tpu_torch.fe.blue_phase import q5_to_q33
    q33 = q5_to_q33(q5)
    asym = max(float((q33[a][b] - q33[b][a]).abs().max())
               for a in range(3) for b in range(3))
    trace = float((q33[0][0] + q33[1][1] + q33[2][2]).abs().max())
    qmax = float(q5.abs().max())
    if asym > 0.0 or trace > 4 * torch.finfo(q5.dtype).eps * qmax:
        raise AssertionError(f"lc noise 128^3: Q asymmetric by {asym} or "
                             f"with trace {trace}")
    del sys_
    sys_ = build_system(RunTime(LC_NOISE_128), "cuda")
    ms, kernels, dev_ms, syncs = step_cost(sys_)
    quiet = build_system(RunTime(LC_NOISE_128.replace("lc_noise 1",
                                                      "lc_noise 0")), "cuda")
    ms0 = step_cost(quiet)[0]
    nsite = math.prod(sys_.lb_cfg.size)
    res["lc noise 128^3"] = dict(ms=ms, ms_without_noise=ms0,
                                 mlups=nsite / (ms * 1e3), kernels=kernels,
                                 device_ms=dev_ms, host_syncs=syncs,
                                 run_text_s=wall, trace=trace)
    print(f"lc noise 128^3 f32 (lc_noise 1, unfused): {ms:.3f} ms a step "
          f"(CUDA events; {ms0:.3f} ms with lc_noise 0), "
          f"{nsite / (ms * 1e3):.1f} MLUPS, {kernels} CUDA kernels a step, "
          f"{dev_ms} ms of them on the device (torch.profiler); {syncs} "
          f"host syncs a step; run_text x {LC_CELL_CYCLES} cycles "
          f"{wall:.2f} s; |Q_ab - Q_ba| {asym}, |trace Q| {trace:.3e} of max "
          f"|Q| {qmax:.4f} [{card}]")
    del sys_, quiet
    torch.cuda.empty_cache()
    name = "lc lc_noise isothermal 16^3"
    nval, err, log = card_vs_cpu_log(name, NOISE_SMALL[name])
    res[name] = dict(floats=nval, max_abs_diff=err, kt_ratio=kt_ratio(log))
    print(f"{name} f64: header equal to the CPU's, {nval} floats within "
          f"rtol 1e-9 (max |diff| {err:.3e}); kT measured / input "
          f"{res[name]['kt_ratio']:.6f}")
    return res, paths


def noisy_suspension(device):
    """phase 28's 64^3 N=1000 suspension with the LB's KISS stream on."""
    from ludwig_tpu_torch.colloids import ColloidParams, make_colloid_step
    from ludwig_tpu_torch.noise import NoiseConfig
    _, state, _, _ = suspension(False, device)
    cfg = LBConfig(size=SUSPENSION_SIZE, nvel=19, eta_shear=0.1,
                   dtype="float32", device=device,
                   noise=NoiseConfig(kt=2e-5, rho=True))
    params = ColloidParams(a0=(2.3,) * SUSPENSION_N,
                           ah=(2.3,) * SUSPENSION_N)
    return make_colloid_step(cfg, params, rebuild_freq=1), state


def phase40(card):
    """The 64^3 N=1000 suspension with the LB's KISS stream: ms a step on
    rebuild steps and others, kernels and device time, no host
    synchronisation; the repository's 30 subgrid particles with their
    Langevin kicks and Brazovskii at 128^3 with the LB noise through
    run_text, then the same costs and host syncs of a step of each (the
    log's timer table printed beside them); one small f64 input of each,
    the card's log against the CPU's; the kT statistics' ratio to the
    input temperature."""
    phase(f"40 fluctuating colloids, subgrid particles and Brazovskii on "
          f"{card}")
    from types import SimpleNamespace
    from ludwig_tpu_torch.ludwig import build_system
    from ludwig_tpu_torch.runtime import RunTime
    res, paths = {}, {}
    step, state = noisy_suspension("cuda")
    # step_cost's view of the colloid step: its state, and a step_fn that
    # keeps the last state it made
    susp = SimpleNamespace(state=step.prepare(state))

    def step_fn(s, t, rebuild=None):
        susp.last, aux = step(s, t, rebuild=rebuild)
        return susp.last, aux

    susp.step_fn = step_fn
    if susp.state.noise is None or step.route != "segment":
        raise AssertionError("noisy suspension: no KISS state or not the "
                             "segment-sum route")
    out = {"route": step.route}
    for rebuild in (True, False):
        _cuda.launches.reset()
        ms, kernels, dev_ms, syncs = step_cost(susp, rebuild=rebuild,
                                               reps=10)
        if _cuda.launches.chain_sums:
            raise AssertionError("noisy suspension: the float32 route "
                                 "launched chain_sums")
        if syncs:
            raise AssertionError(f"noisy suspension: {syncs} host syncs")
        key = "rebuild" if rebuild else "no_rebuild"
        out[key] = dict(ms=ms, kernels=kernels, device_ms=dev_ms,
                        host_syncs=syncs)
        print(f"suspension 64^3 N={SUSPENSION_N} f32 with the KISS noise, "
              f"{key} step: {ms:.4f} ms (CUDA events, 10 steps after 2); "
              f"{kernels} CUDA kernels a step, {dev_ms} ms of device time "
              f"(torch.profiler); {syncs} host syncs under CUDA's sync "
              f"debug mode 'error' [{card}]")
    if not bool(torch.isfinite(susp.last.f).all()):
        raise AssertionError("noisy suspension: non-finite distributions")
    res["suspension noise 64^3"] = out
    del step, state, susp
    torch.cuda.empty_cache()

    for name, text, cycles in (
            ("subgrid 30 24x8x16 f32", "dtype float32\n"
             + COLLOID_INPUTS["subgrid"].replace("N_cycles 4", "N_cycles 20")
             .replace("freq_statistics 2", "freq_statistics 10")
             + NOISE_KEYS, 20),
            ("brazovskii noise 128^3 f32", BRAZ_NOISE_128, MORE_FE_CYCLES)):
        log = io.StringIO()
        torch.cuda.synchronize()
        _cuda.launches.reset()
        t0 = time.perf_counter()
        sys_ = run_text(text, out=log, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        paths[name] = stat_scan_counts()
        lg = log.getvalue()
        if f"Completed cycle {cycles}" not in lg:
            raise AssertionError(f"{name}: cycles incomplete")
        # the log's timer table: host clocks, which see the device's work
        # only where the host waits for it
        table = lg[lg.index("Timer statistics"):].split("\n\n")[0]
        for line in table.splitlines()[2:]:
            print(f"{name} log timer: {line.strip()}")
        ratio = kt_ratio(lg)
        cell = dict(run_text_s=wall, kt_ratio=ratio)
        if name.startswith("subgrid"):
            rngs = sys_.state[-1]
            if rngs.device.type != "cpu" or rngs.numel() != 30:
                raise AssertionError(f"{name}: the LCG states are not the "
                                     "30 particles' host words")
        del sys_
        sys_ = build_system(RunTime(text), "cuda")
        ms, kernels, dev_ms, syncs = step_cost(sys_)
        cell.update(ms=ms, kernels=kernels, device_ms=dev_ms,
                    host_syncs=syncs)
        print(f"{name}: {ms:.3f} ms a step (CUDA events), {kernels} "
              f"CUDA kernels a step, {dev_ms} ms of them on the device "
              f"(torch.profiler), {syncs} host syncs [{card}]")
        res[name] = cell
        print(f"{name}: run_text {cycles} cycles {wall:.2f} s (host clock, "
              f"initialisation included); kT measured / input {ratio:.6f} "
              f"[{card}]")
        del sys_
        torch.cuda.empty_cache()
    worst = 0.0
    for name, text in NOISE_SMALL.items():
        if name.startswith("lc"):
            continue                # phase 39's
        nval, err, log = card_vs_cpu_log(name, text)
        worst = max(worst, err)
        res[name] = dict(floats=nval, max_abs_diff=err,
                         kt_ratio=kt_ratio(log))
        print(f"{name} f64: header equal to the CPU's, {nval} floats within "
              f"rtol 1e-9 (max |diff| {err:.3e}); kT measured / input "
              f"{res[name]['kt_ratio']:.6f}")
    return res, paths, worst


# phase 41: the droplet's solids and options and the porous electrolyte,
# small f64 inputs on the card against the CPU (the droplet input of
# tests/test_ludwig_run.py:165-192 at 8x8x16; the Gouy-Chapman input at
# 16x8x8)
POROUS_KEYS = "porous_media_init simple_cubic\nporous_media_acell {}\n"
DROP_WALLS_KEYS = ("boundary_walls 0_0_1\n"
                   "fe_force_method relaxation_antisymmetric\n")
DROP_POROUS_KEYS = ("fd_gradient_calculation 3d_27pt_fluid\n"
                    "fd_advection_scheme_order 3\n" + POROUS_KEYS.format(4))


def small_input(text):
    return (text.replace("N_cycles 20", "N_cycles 4")
            .replace("freq_statistics 10", "freq_statistics 2"))


OPTION_SMALL = {
    "droplet walls relaxation_antisymmetric 8x8x16":
        small_input(drop_input((8, 8, 16), "float64")) + DROP_WALLS_KEYS,
    "droplet porous 27pt order 3 8x8x16":
        small_input(drop_input((8, 8, 16), "float64").replace(
            "fd_gradient_calculation 3d_7pt_fluid\n", "").replace(
            "fd_advection_scheme_order 1\n", "")) + DROP_POROUS_KEYS,
    "electro porous 16x8x8": small_input(elec_input((16, 8, 8), "float64"))
    + POROUS_KEYS.format(4),
}
# phase 42: the same options at full width, f32, 20 cycles
OPTION_CELLS = {
    "droplet walls relaxation_antisymmetric 128^3":
        drop_input(DROP_SIZE, "float32") + DROP_WALLS_KEYS,
    "droplet porous 128^3": drop_input(DROP_SIZE, "float32")
    + POROUS_KEYS.format(16),
    "electro porous 128^3": elec_input(ELEC_SIZE, "float32")
    + POROUS_KEYS.format(16),
}


def porous_masks(size, gen):
    """{name: solid}: the Gouy-Chapman walls on x joined with a
    simple-cubic porous map (acell 8) and with 8% of the sites at random,
    on the card."""
    from ludwig_tpu_torch.io.map_file import GEOMETRIES
    planes = torch.zeros(size, dtype=torch.bool, device="cuda")
    planes[0] = planes[-1] = True
    cubic = torch.as_tensor(GEOMETRIES["simple_cubic"](size, 8) != 0,
                            device="cuda")
    scattered = torch.rand(size, generator=gen, device="cuda") < 0.08
    return {"simple cubic": planes | cubic, "scattered 8%": planes | scattered}


def phase41(gen):
    """The droplet between walls with the relaxation force, the droplet in
    porous media with the 27-point stencil and order 3, and the porous
    Gouy-Chapman electrolyte in f64 on the card against the CPU; the NP
    and solid collide+stream kernels held to their twins at f32 on porous
    masks; an I/O-grid set written on the card recombined bitwise into
    the single file of the same field."""
    phase("41 the droplet's solids and options, the porous electrolyte and "
          "I/O-grid sets on the card vs the CPU")
    import tempfile

    from ludwig_tpu_torch.io import read_subfile_set
    from ludwig_tpu_torch.io.ref_format import read_ref_field
    res = {}
    for name, text in OPTION_SMALL.items():
        nval, err, _log = card_vs_cpu_log(name, text)
        res[name] = dict(floats=nval, max_abs_diff=err)
        print(f"{name} f64: header equal to the CPU's, {nval} floats within "
              f"rtol 1e-9 (max |diff| {err:.3e})")
    worst = {"np_gradmu": 0.0, "fused_force_step_solid": 0.0}
    for size in ((64, 64, 64), ELEC_SIZE):
        cfg = elec_cfg(size, "float32", **SOR_TEST_EK)
        psi, rho, u, _planes = rand_elec(size, cfg.lb.tdtype, gen)
        routes = elec_routes(cfg, dt=0.5)
        model, params = cfg.lb.model, cfg.lb.collision_params()
        f0 = rand_state(cfg.lb, gen)
        frc = (1e-4 * torch.randn((3,) + size, generator=gen,
                                  dtype=cfg.lb.tdtype, device="cuda")
               ).contiguous()
        for mask, solid in porous_masks(size, gen).items():
            fluid = torch.logical_not(solid)
            what = f"{size} float32 {mask} ({float(solid.float().mean()):.3f}"\
                   " solid)"
            err = hold_np(what, routes["kernel"][1](psi, rho, u, fluid),
                          routes["twin"][1](psi, rho, u, fluid))
            worst["np_gradmu"] = max(worst["np_gradmu"], err)
            err = hold_k2_solid(
                what,
                fused.fused_force_step(f0, frc, model, params, solid=solid),
                fused._fused_force_step_plain(f0, frc, model, params, solid),
                model, solid)
            worst["fused_force_step_solid"] = max(
                worst["fused_force_step_solid"], err)
    # the droplet input on the card with default_io_grid 2_2_1 and a
    # phi_io_grid 1_1_4 override, and again with the single I/O group:
    # each recombined set is, bitwise, the single file of its field
    text = (small_input(drop_input((8, 8, 16), "float32"))
            + "freq_phi 4\nfreq_vel 4\n")
    with tempfile.TemporaryDirectory() as d:
        sets, whole = os.path.join(d, "sets"), os.path.join(d, "whole")
        for where, keys in ((sets, "default_io_grid 2_2_1\n"
                                   "phi_io_grid 1_1_4\n"), (whole, "")):
            os.makedirs(where)
            run_text(text + keys + f"io_directory {where}\n",
                     out=io.StringIO(), device="cuda")
        for name, ncomp in (("phi", 1), ("vel", 3)):
            files = sorted(f for f in os.listdir(sets)
                           if f.startswith(f"{name}-00000004."))
            a = read_subfile_set(sets, name, 4)
            b = read_ref_field(os.path.join(whole,
                                            f"{name}-00000004.001-001"),
                               (8, 8, 16), ncomp)
            if not (a.shape == b.shape and (a == b).all()):
                raise AssertionError(f"{name}: the I/O-grid set is not the "
                                     "single file's values")
            print(f"{name}: {len(files)} subfiles {files[0]} .. {files[-1]}"
                  " recombine bitwise into the 1_1_1 file of the same run")
            res[f"io grid {name}"] = dict(subfiles=len(files))
    return res, worst


def electro_kernel_times(sys_):
    """ms of sor_solve, np_gradmu and the solid K2 (CUDA events, 20
    launches after 2) on the state and solid of an electrolyte system."""
    from ludwig_tpu_torch.electro import rho_elec
    cfg, solid = sys_.electro_cfg, sys_.solid
    f, psi, rho, u, _gw = sys_.state
    model, params = cfg.lb.model, cfg.lb.collision_params()
    fluid = torch.logical_not(solid)
    rel = rho_elec(rho, cfg.ek)
    raw, fsum = fe.np_gradmu_fused(psi, rho, u, fluid, cfg, 1.0)[1:]
    frc = (raw - (fsum / float(psi.numel()))[:, None, None, None]
           ).contiguous()
    return {
        "sor_solve": time_ms(lambda: fe.sor_solve_fused(psi, rel, cfg.ek),
                             20),
        "np_gradmu": time_ms(lambda: fe.np_gradmu_fused(psi, rho, u, fluid,
                                                        cfg, 1.0), 20),
        "fused_force_step_solid": time_ms(lambda: fused.fused_force_step(
            f, frc, model, params, solid=solid), 20)}


def phase42(card):
    """The droplet between walls with the relaxation force and in porous
    media, and the porous Gouy-Chapman electrolyte, at full width f32:
    20 cycles of each through run_text, ms a step, CUDA kernels a step and
    their device time, host syncs; the electrolyte's kernels on its
    porous state beside the plain Gouy-Chapman state's; a 128^3 q dump
    as an I/O-grid set 2_2_2 against the single file."""
    phase(f"42 the droplet's solids and the porous electrolyte at full "
          f"width f32 on {card}")
    import tempfile

    from ludwig_tpu_torch.io import read_subfile_set, write_sharded
    from ludwig_tpu_torch.io.ref_format import write_ref_field
    from ludwig_tpu_torch.ludwig import build_system
    from ludwig_tpu_torch.runtime import RunTime
    res, paths = {}, {}
    electro = ("sor_solve", "np_gradmu", "fused_force_step_solid")
    for name, text in OPTION_CELLS.items():
        log = io.StringIO()
        torch.cuda.synchronize()
        _cuda.launches.reset()
        t0 = time.perf_counter()
        sys_ = run_text(text, out=log, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = stat_scan_counts()
        if sys_.is_electro:
            counts.update({k: getattr(_cuda.launches, k) for k in electro})
            bad = {k: counts[k] for k in electro if counts[k] != ELEC_CYCLES}
            if bad:
                raise AssertionError(f"{name}: launches {bad} for "
                                     f"{ELEC_CYCLES} cycles")
        elif _cuda.launches.droplet_phi_q_force_step:
            raise AssertionError(f"{name}: the fused droplet kernel ran "
                                 "beside a solid")
        paths[name] = counts
        out = log.getvalue()
        cycles = ELEC_CYCLES if sys_.is_electro else DROP_CYCLES
        if (f"Completed cycle {cycles}" not in out
                or sys_.solid is None or sys_.fused_mode is not None):
            raise AssertionError(f"{name}: incomplete, or not the unfused "
                                 "route with a solid")
        if not all(bool(torch.isfinite(x).all()) for x in sys_.state):
            raise AssertionError(f"{name}: non-finite state")
        cell = dict(run_text_s=wall,
                    solid_fraction=float(sys_.solid.float().mean()))
        if sys_.is_electro:
            cell["kernels_porous"] = electro_kernel_times(sys_)
        del sys_
        torch.cuda.empty_cache()
        sys_ = build_system(RunTime(text), "cuda")
        ms, kernels, dev_ms, syncs = step_cost(sys_)
        if syncs and not sys_.is_electro:
            raise AssertionError(f"{name}: {syncs} host syncs a step")
        cell.update(ms=ms, kernels=kernels, device_ms=dev_ms,
                    host_syncs=syncs)
        print(f"{name}: {ms:.3f} ms a step (CUDA events), {kernels} CUDA "
              f"kernels a step, {dev_ms} ms of them on the device "
              f"(torch.profiler), {syncs} host syncs; run_text "
              f"{cycles} cycles {wall:.2f} s; solid "
              f"{cell['solid_fraction']:.3f} of the sites [{card}]")
        res[name] = cell
        del sys_
        torch.cuda.empty_cache()
    # the plain Gouy-Chapman cell's step and kernels in the same call
    plain = build_system(RunTime(elec_input(ELEC_SIZE, "float32")), "cuda")
    for t in range(2):
        plain.state = plain.step_fn(plain.state, t)[0]
    plain_k = electro_kernel_times(plain)
    plain_ms, plain_kern, plain_dev, plain_syncs = step_cost(plain)
    del plain
    torch.cuda.empty_cache()
    porous = res["electro porous 128^3"]
    res["electro plain 128^3"] = dict(ms=plain_ms, kernels=plain_kern,
                                      device_ms=plain_dev,
                                      host_syncs=plain_syncs,
                                      kernels_plain=plain_k)
    print(f"electro 128^3 a step: porous {porous['ms']:.3f} ms, plain "
          f"Gouy-Chapman {plain_ms:.3f} ms ({plain_kern} CUDA kernels, "
          f"{plain_dev} ms on the device, {plain_syncs} host syncs) [{card}]")
    for k in electro:
        print(f"{k} 128^3: porous state {porous['kernels_porous'][k]:.4f} ms,"
              f" plain Gouy-Chapman state {plain_k[k]:.4f} ms [{card}]")
    # a 128^3 q dump (5 doubles a site, from the card) as one file and as
    # the 2_2_2 set, in turns
    q = torch.randn((5,) + DROP_SIZE, generator=torch.Generator(
        device="cuda").manual_seed(42), device="cuda")
    dump = {"1_1_1": [], "2_2_2": []}
    with tempfile.TemporaryDirectory() as d:
        for rep in range(3):
            for grid in dump:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if grid == "1_1_1":
                    write_ref_field(d, "q", rep, q)
                else:
                    write_sharded(d, "q", rep, q, grid=(2, 2, 2))
                dump[grid].append(time.perf_counter() - t0)
        back = read_subfile_set(d, "q", 2)
        if not (back == q.double().cpu().numpy()).all():
            raise AssertionError("q 2_2_2: the set is not the field")
    res["q dump 128^3"] = {g: min(v) for g, v in dump.items()}
    print(f"q dump 128^3 (84 MB of doubles, from the card, host clock, "
          f"least of 3): 1_1_1 {res['q dump 128^3']['1_1_1']:.3f} s, "
          f"2_2_2 (8 subfiles + metadata) "
          f"{res['q dump 128^3']['2_2_2']:.3f} s [{card}]")
    return res, paths


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU; none is visible")
    phase("1 card")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("2 build")
    t0 = time.perf_counter()
    built = _cuda.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    # what ptxas says of the n-step and SOR kernels, then of the binary,
    # liquid-crystal, droplet and electrokinetic (SOR and NP) ones
    for lib, names in ((_cuda._lib_name(19), ("fusedn",)),
                       (_cuda.ELECTRO_LIB, ("sor_kernel",))):
        for line in _cuda.ptxas_lines(built[lib], names):
            print(f"{lib} ptxas: {line}")
    for lib in (_cuda.BINARY_LIB, _cuda.LC_LIB, _cuda.DROPLET_LIB,
                _cuda.ELECTRO_LIB):
        report = built[lib].with_suffix(".ptxas.txt").read_text()
        for line in report.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"{lib} ptxas: {line.strip()}")

    tr1, _t1, sites = _cuda._binary_trace()
    print(f"binary generated code: {tr1.nops} distinct operations for one "
          f"level-1 evaluation, {sites[1][0].nops} / {sites[2][0].nops} for "
          "the site update of order 1 / 2; the bound counts one level-1 "
          "evaluation a site")
    tr1, _t1, tr2, _t2, table = _cuda._lc_trace()
    print(f"lc_q generated code: {tr1.nops} distinct operations for one "
          f"level-1 evaluation, {tr2.nops} for the site update, "
          f"{len(table)} constants; the bound counts "
          f"{_cuda.site_ops('lc_q_force_step')} a site (level 1 once, the "
          "free energy factored)")
    tr1, _t1, sites, table = _cuda._droplet_trace()
    print(f"droplet generated code: {tr1.nops} distinct operations for one "
          f"level-1 evaluation, {sites[1][0].nops} / {sites[2][0].nops} for "
          f"the site update of order 1 / 2, {len(table)} constants; the "
          f"bound counts {_cuda.site_ops('droplet_phi_q_force_step', order=1)}"
          " a site at order 1 (level 1 once, the site's fields kept)")

    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst = phase3(gen)
    phase4(gen)
    counts = phase5()
    timed = phase6(card, gen)
    worst.update(phase7(gen))
    by_path = {"plain": counts, "binary": phase8()}
    timed.update(phase9(card, gen, timed["copy_ms"], timed["copy_bytes"]))
    worst.update(phase10(gen))
    by_path["lc"], by_path["lc f64 16x16x32"] = phase11()
    timed.update(phase12(card, gen, timed["copy_ms"], timed["copy_bytes"]))
    worst.update(phase13(gen))
    by_path["droplet"] = phase14()
    timed.update(phase15(card, gen, timed["copy_ms"], timed["copy_bytes"]))
    worst.update(phase16(gen))
    by_path["electro"], _iters = phase17()
    timed.update(phase18(card, gen, timed["copy_ms"], timed["copy_bytes"]))
    worst.update(phase19(gen))
    by_path["noise"], small = phase20()
    for fused_req, c in small.items():
        by_path[f"noise f64 16x16x32 tpu_fused {fused_req}"] = c
    timed.update(phase21(card, gen, timed["copy_ms"], timed["copy_bytes"]))
    worst["fused_step"] = max(worst["fused_step"], phase22(gen)["fused_step"])
    by_path.update(phase23())
    boundary, paths = phase24(card, gen)
    by_path.update(paths)
    timed["fused_step"].update(boundary)
    le_worst, le_counts = phase25(gen)
    for name, err in le_worst.items():
        worst[name] = max(worst[name], err)
    by_path.update(le_counts)
    le_times, le_paths = phase26(card, gen)
    by_path.update(le_paths)
    timed["lc_q_force_step"]["sheared"] = le_times
    colloid_err, colloid_counts = phase27()
    by_path.update(colloid_counts)
    suspensions, colloid_paths = phase28(card)
    by_path.update(colloid_paths)
    timed["chain_sums"] = chain_sums_timing(card)
    timed["chain_sums"]["suspensions"] = suspensions
    worst["chain_sums"] = colloid_err
    binary_worst = phase29()
    binary_cells, binary_paths = phase30(card)
    by_path.update(binary_paths)
    timed["momentum_total_ref"]["binary_cells"] = binary_cells
    more_fe_worst, more_fe_counts = phase31()
    by_path.update(more_fe_counts)
    more_fe_cells, more_fe_paths = phase32(card)
    by_path.update(more_fe_paths)
    timed["momentum_total_ref"]["more_fe_cells"] = more_fe_cells
    lc_worst, lc_counts = phase33()
    by_path.update(lc_counts)
    lc_cells, lc_paths = phase34(card)
    by_path.update(lc_paths)
    timed["momentum_total_ref"]["lc_cells"] = lc_cells
    family_worst, family_counts = phase35()
    by_path.update(family_counts)
    family_cells, family_paths = phase36(card)
    by_path.update(family_paths)
    timed["chain_sums"]["family_colloid_cells"] = family_cells
    worst["chain_sums"] = max(worst["chain_sums"], family_worst)
    q9 = phase37(card, gen)
    log_counts, log_cells, log_worst = phase38(card)
    # the D2Q9 kernels' launches: the two-dimensional paths of phase 38
    q9_paths = {path: c for path, c in log_counts.items()
                if path.startswith("kh")}
    by_path.update({path: c for path, c in log_counts.items()
                    if path not in q9_paths})
    timed["fused_step"]["log_cells"] = log_cells
    timed["fused_step"]["log_inputs_f64_max_abs_diff"] = log_worst
    lc_noise, lc_noise_paths = phase39(card)
    by_path.update(lc_noise_paths)
    colloid_noise, colloid_noise_paths, noise_worst = phase40(card)
    by_path.update(colloid_noise_paths)
    timed["fused_step_noise"]["fluctuations"] = {
        **lc_noise, **colloid_noise,
        "small_inputs_f64_max_abs_diff": noise_worst}
    for name in STAT_SCANS:
        worst[name] = 0.0        # held bitwise in phases 19 and 21
    option_small, option_worst = phase41(gen)
    for name, err in option_worst.items():
        worst[name] = max(worst[name], err)
    option_cells, option_paths = phase42(card)
    by_path.update(option_paths)
    timed["fused_force_step_solid"]["options"] = {**option_small,
                                                  **option_cells}
    print(f"all phases passed ({time.perf_counter() - _T0:.1f} s)")

    kernels = []
    for name, source, replaces in (
            ("fused_step", SOURCE, "ludwig_tpu/ops/fused.py:429"),
            ("fusedn_step", SOURCE, "ludwig_tpu/ops/fused.py:902"),
            ("binary_phi_force_step", SOURCE_BINARY,
             "ludwig_tpu/ops/fused_binary.py:49"),
            ("fused_force_step", SOURCE, "ludwig_tpu/ops/fused.py:1069"),
            ("lc_q_force_step", SOURCE_LC,
             "ludwig_tpu/ops/fused_lc.py:63"),
            ("droplet_phi_q_force_step", SOURCE_DROPLET,
             "ludwig_tpu/ops/fused_droplet.py:39"),
            ("fused_force_step_solid", SOURCE,
             "ludwig_tpu/ops/fused.py:1069 (with_solid)"),
            ("sor_solve", SOURCE_ELECTRO,
             "ludwig_tpu/ops/fused_electro.py:63"),
            ("np_gradmu", SOURCE_ELECTRO,
             "ludwig_tpu/ops/fused_electro.py:207"),
            ("fused_step_noise", SOURCE,
             "ludwig_tpu/ops/fused.py:429 (FusedNoise)"),
            # the reference statistics: lax.scan in the JAX package, no
            # Pallas kernel
            ("seq_sum", SOURCE_STATS, "ludwig_tpu/stats.py:59 (lax.scan)"),
            ("field_stats_ref", SOURCE_STATS,
             "ludwig_tpu/stats.py:84 (lax.scan)"),
            ("rho_stats_ref", SOURCE_STATS,
             "ludwig_tpu/stats.py:155 (lax.scan)"),
            ("momentum_total_ref", SOURCE_STATS,
             "ludwig_tpu/stats.py:239 (lax.scan)"),
            # the colloids' reference-order link sums: lax.scan too
            ("chain_sums", SOURCE_STATS,
             "ludwig_tpu/colloids.py:280 (lax.scan)")):
        t = timed[name]
        bound_ms, bound_by = bound(t["nbytes"], t["nops"])
        # each main path was driven with the counts at 0 just before it
        # and read just after; a kernel on several paths adds them up
        paths = {path: c[name] for path, c in by_path.items() if name in c}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": max(worst[name], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call computes a collide+stream, the
            # binary order-parameter update, the Q-tensor update, the
            # coupled droplet update, an SOR solve, the Nernst-Planck
            # face fluxes or a site-ordered (compensated) scan
            "library_ms": None,
            "copy_bound_ms": timed["copy_ms"] * t["nbytes"]
            / timed["copy_bytes"]})
        if "lay" in t:          # the K1 and NP marches: their layout
            kernels[-1].update(layout=str(t["lay"]))
        if "device_ms" in t:    # torch.profiler's time on the card
            kernels[-1].update(device_ms=t["device_ms"])
        if "sheared" in t:      # phase 26: the sheared blue phase, cells
            kernels[-1].update(sheared=t["sheared"])
        if "suspensions" in t:  # phase 28: the colloid cells (no kernel
            # of theirs: their float32 route is PyTorch)
            kernels[-1].update(suspensions=t["suspensions"])
        if "family_colloid_cells" in t:  # phase 36: the other families'
            # colloid cells (PyTorch; the electrolyte's reference-order
            # sums launch chain_sums)
            kernels[-1].update(family_colloid_cells=t["family_colloid_cells"])
        if "binary_cells" in t:  # phase 30: the binary boundary cells (no
            # kernel of theirs: their route is PyTorch; their statistics
            # launch the scans)
            kernels[-1].update(binary_cells=t["binary_cells"],
                               binary_routes_f64_max_abs_diff=binary_worst)
        if "more_fe_cells" in t:  # phase 32: the other free energies'
            # cells (PyTorch routes; their statistics launch the scans)
            kernels[-1].update(
                more_fe_cells=t["more_fe_cells"],
                more_fe_routes_f64_max_abs_diff=more_fe_worst)
        if "lc_cells" in t:  # phase 34: the blue phase's cells (PyTorch
            # routes; their statistics launch the scans)
            kernels[-1].update(lc_cells=t["lc_cells"],
                               lc_routes_f64_max_abs_diff=lc_worst)
        if "options" in t:  # phases 41-42: the droplet's solids and
            # options, the porous electrolyte, the I/O-grid sets
            kernels[-1].update(options=t["options"])
        if "fluctuations" in t:  # phases 39-40: the threefry stream, the
            # Q noise, the fluctuating colloids, subgrid particles and
            # Brazovskii (PyTorch routes, no kernel of their own)
            kernels[-1].update(fluctuations=t["fluctuations"])
        if "log_cells" in t:    # phase 38: the full log's runs
            kernels[-1].update(log_cells=t["log_cells"],
                               log_inputs_f64_max_abs_diff=t[
                                   "log_inputs_f64_max_abs_diff"])
        if "wall_step_ms" in t:   # the wall and LE steps around the kernel
            kernels[-1].update({k: t[k] for k in (
                "wall_step_ms", "wall_post_ms", "le_step_ms", "le_post_ms",
                "fused_step_ms_phase24", "plane_collide_ms",
                "wall_post_kernels", "wall_post_device_ms",
                "le_post_kernels", "le_post_device_ms",
                "wall_step_device_ms", "le_step_device_ms")})
    # the D2Q9 library fused_lb_q9 (phase 37), timed at 4096x4096x1 f32
    for name, replaces in (
            ("fused_step", "ludwig_tpu/ops/fused.py:429 (D2Q9)"),
            ("fused_step_noise",
             "ludwig_tpu/ops/fused.py:429 (FusedNoise, D2Q9)")):
        t = q9[name]
        bound_ms, bound_by = bound(t["nbytes"], t["nops"])
        paths = {path: c[name] for path, c in q9_paths.items()
                 if name in c}
        kernels.append({
            "name": f"{name}_q9", "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "copy_bound_ms": t["copy_ms"], "size": list(Q9_SIZE)})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
