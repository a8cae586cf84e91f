"""The port's input-file surface against ludwig_tpu's, on the CPU.

The same input text runs through ludwig_tpu.ludwig.run_text and
ludwig_tpu_torch.ludwig.run_text; the statistics-block floats must agree
at rtol 1e-9 / atol 1e-11, the bound test_ludwig_run.py holds the fused
CLI path to (the port sums with plain reductions, the JAX package's jnp
path with compensated ones)."""

import io
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from ludwig_tpu.ludwig import run_text as jrun_text
from ludwig_tpu_torch.ludwig import run_text
from test_ludwig_run import (BINARY_FUSED_INPUT, BINARY_LE_FUSED_INPUT,
                             COUETTE_FUSED_INPUT, DROPLET_FUSED_INPUT,
                             DUCT_FUSED_INPUT, LC_FUSED_INPUT,
                             LC_LE_FUSED_INPUT, LE_FUSED_INPUT,
                             PLAIN_FUSED_INPUT, PLAIN_INPUT,
                             WALL_FUSED_INPUT, WALLS_INPUT, _stat_floats)
from test_torch_more_fe_cli import INPUTS as MORE_FE_INPUTS


def _logs(jax_text, port_text):
    a, b = io.StringIO(), io.StringIO()
    jrun_text(jax_text, out=a)
    sys_ = run_text(port_text, out=b, device="cpu")
    return a.getvalue(), b.getvalue(), sys_


# the sheared inputs: the JAX package's binary and blue-phase ones
# (tests/test_ludwig_run.py:227, :248) and its droplet input at 16_8_16
# with two planes; the shear observables on
DROPLET_LE_INPUT = (DROPLET_FUSED_INPUT.replace("size 8_8_16", "size 16_8_16")
                    + "N_LE_plane 2\nLE_plane_vel 0.04\nLE_init_profile 1\n")
LE_INPUTS = {"binary": BINARY_LE_FUSED_INPUT, "lc": LC_LE_FUSED_INPUT,
             "droplet": DROPLET_LE_INPUT}
SHEAR_KEYS = "freq_shear_measurement 1\nfreq_shear_output 2\n"


def _binary_input(order):
    return BINARY_FUSED_INPUT.replace("fd_advection_scheme_order 2",
                                      f"fd_advection_scheme_order {order}")


@pytest.mark.parametrize("order", [2, 1])
def test_binary_cli_matches_jax(order):
    """The fused binary route (the K1 + K2 twins) against the JAX
    package's jnp binary path; [phi] and [fed] lines included."""
    text = _binary_input(order)
    jlog, log, sys_ = _logs(text, "tpu_fused on\n" + text)
    assert sys_.fused_mode == "binary"
    assert "Completed cycle 4" in log
    assert log.count("[fed]") == jlog.count("[fed]") == 3
    a, b = _stat_floats(jlog), _stat_floats(log)
    assert a.size == b.size and a.size > 0
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11)


def test_binary_cli_unfused_route_matches_jax():
    jlog, log, sys_ = _logs(BINARY_FUSED_INPUT, BINARY_FUSED_INPUT)
    assert sys_.fused_mode is None and sys_.binary_cfg is not None
    a, b = _stat_floats(jlog), _stat_floats(log)
    assert a.size == b.size and a.size > 0
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11)


# the binary keys the port refused until it took over the binary fluid's
# boundaries and options: each now runs and prints the JAX package's log
NOW_PORTED_BINARY = [
    "fd_advection_scheme_order 3", "fe_force_method phi_gradmu",
    "fd_gradient_calculation 3d_27pt_fluid", "hydrodynamics off",
    "phi_initialisation patches", "grad_mu 0.001_0_0",
    "viscosity_model arrhenius\nviscosity_arrhenius_eta_minus 0.01\n"
    "viscosity_arrhenius_eta_plus 0.005", "boundary_walls 0_0_1",
    # kT alone switches no fluctuations on; with the switch the LB's KISS
    # stream runs
    "temperature 0.001",
    "temperature 0.00002\nisothermal_fluctuations on"]


@pytest.mark.parametrize("line", NOW_PORTED_BINARY,
                         ids=lambda ln: ln.split("\n")[-1])
def test_binary_keys_now_ported_match_jax(line):
    text = BINARY_FUSED_INPUT + line + "\n"
    jlog, log, sys_ = _logs(text, text)
    assert sys_.binary_cfg is not None and sys_.fused_mode is None
    a, b = _stat_floats(jlog), _stat_floats(log)
    assert a.size == b.size and a.size > 0
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("line", [
    # the force methods the JAX package's binary step runs as
    # stress_divergence
    "fe_force_method no_force", "fe_force_method relaxation_symmetric",
    "viscosity_model eyring",
    # the binary colloids beside Lees-Edwards planes and porous media
    "N_LE_plane 2\nLE_plane_vel 0.01\ncolloid_init input_one\n"
    "colloid_one_a0 2.3",
    "porous_media_init simple_cubic\nporous_media_acell 8\n"
    "colloid_init input_one\ncolloid_one_a0 2.3",
    # moving and slip walls of the binary fluid (the JAX package reads
    # neither), the open boundary without halo walls
    "boundary_speed_top 0.01", "boundary_walls_slip_fraction_top 0.5_0_0",
    "lb_bc_open 1", "tpu_shard on", "lc_a0 0.01",
    # a psi file outside the electrolytes
    "freq_psi 2"])
def test_unported_binary_keys_raise(line):
    with pytest.raises(NotImplementedError, match=line.split()[0]):
        run_text(BINARY_FUSED_INPUT + line + "\n", out=io.StringIO(),
                 device="cpu")


@pytest.mark.parametrize("fused", ["on", "off"])
def test_lc_cli_matches_jax(fused):
    """The blue-phase input on the fused route (the K1 + K2 twins against
    the JAX package's Pallas kernels in interpret mode) and on the
    unfused one (against its jnp step); the [Qxx]..[Qyz] lines and the
    [fe] line, whose gradients are those of the Q before the step."""
    jfused = "interpret" if fused == "on" else "off"
    jlog, log, sys_ = _logs(f"tpu_fused {jfused}\n" + LC_FUSED_INPUT,
                            f"tpu_fused {fused}\n" + LC_FUSED_INPUT)
    assert sys_.fused_mode == ("lc" if fused == "on" else None)
    assert sys_.lc_cfg is not None and "Completed cycle 4" in log
    for tag in ("[Qxx]", "[Qyz]", "[fe]"):
        assert log.count(tag) == jlog.count(tag) == 3
    heads = [ln for ln in log.splitlines() if ln.startswith("Free energies")]
    assert heads == [ln for ln in jlog.splitlines()
                     if ln.startswith("Free energies")]
    a, b = _stat_floats(jlog), _stat_floats(log)
    assert a.size == b.size and a.size > 0
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11)


def test_lc_cli_order_2_runs_unfused():
    """As in the JAX package, `tpu_fused on` with order-2 advection takes
    the unfused step."""
    text = "tpu_fused on\n" + LC_FUSED_INPUT.replace(
        "fd_advection_scheme_order 1", "fd_advection_scheme_order 2")
    jlog, log, sys_ = _logs(text.replace("tpu_fused on", "tpu_fused off"),
                            text)
    assert sys_.fused_mode is None and sys_.lc_cfg.advection_order == 2
    np.testing.assert_allclose(_stat_floats(log), _stat_floats(jlog),
                               rtol=1e-9, atol=1e-11)


# the blue-phase keys the port refused until it took over the rest of the
# liquid crystal: each now runs its input on the JAX package's route and
# prints the JAX package's log (the anchoring inputs between walls on z)
WALL_S7 = ("boundary_walls 0_0_1\nfd_gradient_calculation s7_anchoring\n"
           "lc_wall_anchoring normal\nlc_wall_anchoring_w1 0.01")
NOW_PORTED_LC = [
    "lc_redshift_update 1", WALL_S7,
    "electric_e0 0.0_0.0_0.01\nlc_dielectric_anisotropy 41.4",
    "fd_advection_scheme_order 3", "hydrodynamics off",
    "lc_q_init_rectangle_min 2_2_3\nlc_q_init_rectangle_max 5_6_9",
    "boundary_walls 0_0_1\nfd_gradient_calculation 3d_7pt_solid\n"
    "lc_anchoring_method two\nlc_wall_anchoring planar\n"
    "lc_anchoring_strength 0.01\nlc_anchoring_strength_2 0.002",
    "boundary_walls 1_0_0\nfd_gradient_calculation s7_anchoring\n"
    "lc_wall_anchoring fixed\nlc_wall_anchoring_w1 0.01\n"
    "lc_wall_fixed_orientation 0_1_1",
    # porous solids with the 'two' stencil (which, as in the JAX package,
    # does not see them)
    "porous_media_init simple_cubic\nporous_media_acell 4\n"
    "fd_gradient_calculation 3d_7pt_solid\nlc_anchoring_method two\n"
    "lc_wall_anchoring normal\nlc_anchoring_strength 0.01"]


# the liquid crystal with two resolved particles (12^3, normal anchoring
# on their surface); between walls on z it is the restart case below
LC_COLLOIDS = """
N_cycles 4
size 12_12_12
viscosity 0.1
free_energy lc_blue_phase
lc_a0 0.01
lc_gamma 3.0
lc_q0 0.19635
lc_kappa0 0.000648456
lc_kappa1 0.000648456
lc_xi 0.7
lc_Gamma 0.5
lc_q_initialisation nematic
lc_init_nematic 1.0_0.0_0.0
freq_statistics 2
fd_gradient_calculation s7_anchoring
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
LC_COLLOIDS_WALLS = LC_COLLOIDS + """boundary_walls 0_0_1
lc_wall_anchoring normal
lc_wall_anchoring_w1 0.01
"""


@pytest.mark.parametrize("line", NOW_PORTED_LC,
                         ids=lambda ln: ln.replace("\n", " ")[:40])
def test_lc_keys_now_ported_match_jax(line):
    """Where the fused kernels are asked for (the port's `tpu_fused on`,
    the JAX package's `interpret` on the CPU), both packages'
    build_system take the same route: the JAX package's fused gate
    refuses each of these but the random rectangle.  The logs come from
    `tpu_fused off` (the same unfused route but for the rectangle, which
    then skips the JAX package's interpret-mode kernels): the same lines,
    their floats at rtol 1e-9 / atol 1e-11."""
    from ludwig_tpu import ludwig as jl
    from ludwig_tpu.runtime import RunTime as JRunTime
    from ludwig_tpu_torch import ludwig as tl
    from ludwig_tpu_torch.runtime import RunTime
    from test_torch_more_fe_cli import log_lines
    text = LC_FUSED_INPUT + line + "\n"
    jsys = jl.build_system(JRunTime("tpu_fused interpret\n" + text))
    tsys = tl.build_system(RunTime("tpu_fused on\n" + text), device="cpu")
    assert jsys.fused_mode == tsys.fused_mode == (
        "lc" if "rectangle" in line else None)
    jlog, log, sys_ = _logs("tpu_fused off\n" + text,
                            "tpu_fused off\n" + text)
    assert sys_.lc_cfg is not None and sys_.fused_mode is None
    (wj, fj), (wt, ft) = log_lines(jlog), log_lines(log)
    assert wt == wj and ft.size == fj.size > 0
    np.testing.assert_allclose(ft, fj, rtol=1e-9, atol=1e-11)
    if "boundary_walls" in line:
        assert log.count("[walls   ]") == 3
        assert log.count("f v f/v f_s1 fs_s2 redshift") == 3
    if "hydrodynamics off" in line:
        assert "[minimum ]" not in log


@pytest.mark.parametrize("line", [
    "lc_noise on",
    # the planes are ported; their oscillation the LC does not read
    "LE_oscillation_period 100", "lb_bc_open on",
    # beside planes, where the JAX package's run fails
    "N_LE_plane 1\nLE_plane_vel 0.01\nlc_redshift_update 1",
    "N_LE_plane 1\nLE_plane_vel 0.01\nboundary_walls 0_0_1",
    # walls with a fluid stencil: no anchoring for the walls' surface term
    "boundary_walls 1_0_0"])
def test_unported_lc_keys_raise(line):
    key = line.split("\n")[-1].split()[0]
    with pytest.raises(NotImplementedError, match=key):
        run_text("tpu_fused on\n" + LC_FUSED_INPUT + line + "\n",
                 out=io.StringIO(), device="cpu")


@pytest.mark.parametrize("fused", ["on", "off"])
def test_droplet_cli_matches_jax(fused):
    """The droplet input on the fused route (the K1 + mean + K2 twins)
    and on the unfused one, both against the JAX package's jnp droplet
    path (test_ludwig_run.py:304 holds its Pallas route to that path at
    the same tolerance); the [phi], [Qxx]..[Qyz] and [fed] lines, the
    last with the gradients of the phi and Q before the step."""
    jlog, log, sys_ = _logs(DROPLET_FUSED_INPUT,
                            f"tpu_fused {fused}\n" + DROPLET_FUSED_INPUT)
    assert sys_.fused_mode == ("droplet" if fused == "on" else None)
    assert sys_.droplet_cfg is not None and "Completed cycle 4" in log
    for tag in ("[phi]", "[Qxx]", "[Qyz]", "[fed]"):
        assert log.count(tag) == jlog.count(tag) == 3
    a, b = _stat_floats(jlog), _stat_floats(log)
    assert a.size == b.size and a.size > 0
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("line", [
    # the relaxation force beside planes and the force methods the JAX
    # package's droplet steps run as stress_divergence; hydrodynamics off,
    # which its step ignores while its log drops the velocity
    "fe_force_method relaxation_antisymmetric\nN_LE_plane 2\n"
    "LE_plane_vel 0.04",
    "fe_force_method phi_gradmu", "fe_force_method relaxation_symmetric",
    "hydrodynamics off", "electric_e0 0.01_0_0",
    # colloids (no droplet colloid route) and the open boundary
    "colloid_init input_one\ncolloid_one_a0 2.3", "lb_bc_open 1",
    "tpu_shard on", "freq_psi 2", "lc_activity yes", "lc_redshift_update 1"])
def test_unported_droplet_keys_raise(line):
    with pytest.raises(NotImplementedError, match=line.split()[0]):
        run_text("tpu_fused on\n" + DROPLET_FUSED_INPUT + line + "\n",
                 out=io.StringIO(), device="cpu")


# a Gouy-Chapman double layer (ref: d3q19-elec serial-elec-gc1, the
# JAX package's perf_bench.py:86-110 parameters) at 16x4x4, float64
ELECTRO_INPUT = """
N_cycles 6
freq_statistics 3
size 16_4_4
viscosity 0.1
dtype float64
free_energy fe_electro
electrokinetics_z0 1
electrokinetics_z1 -1
electrokinetics_d0 0.01
electrokinetics_d1 0.01
electrokinetics_eunit 1.0
electrokinetics_epsilon 3.3e3
temperature 3.33333333333e-5
electrokinetics_init gouy_chapman
electrokinetics_init_rho_el 1.04e-3
electrokinetics_init_sigma 3.125e-2
electrokinetics_solver_type sor
electrokinetics_rel_tol 1e-8
electrokinetics_abs_tol 1e-15
electrokinetics_maxits 10000
electrokinetics_multisteps 1
"""
ELECTRO_TAGS = ("[rho]", "[psi]", "[elc]", "[fed]", "[total", "[fluid",
                "[walls", "[minimum", "[maximum")


def _electro_floats(log):
    """(floats, looser): the statistics floats of an electrokinetic log and
    which of them are the [psi] and [elc] totals."""
    vals, loose = [], []
    for line in log.splitlines():
        if line.startswith(ELECTRO_TAGS):
            nums = [float(t) for t in line.split() if re.match(r"^-?\d", t)]
            vals += nums
            loose += [line.startswith(("[psi]", "[elc]")) and i == 0
                      for i in range(len(nums))]
    return np.array(vals), np.array(loose)


@pytest.mark.parametrize("solver", ["sor", "fft"])
def test_electro_cli_matches_jax(solver):
    """The Gouy-Chapman input through both packages in float64 (the
    reference route): every statistics float within rtol 1e-9 / atol
    1e-11 but the [psi] and [elc] totals, sums of values of both signs
    that cancel to ~0, held to 1e-12 x sites x max|value|; the SOR
    reports equal in their iteration counts and criteria."""
    text = ELECTRO_INPUT.replace("solver_type sor", f"solver_type {solver}")
    jlog, log, sys_ = _logs(text, text)
    assert sys_.is_electro and sys_.solid is not None
    assert "Completed cycle 6" in log
    for tag in ("[psi]", "[elc]", "[walls   ]", "[fed]"):
        assert log.count(tag) == jlog.count(tag) == 3
    assert log.count("[rho]") == jlog.count("[rho]") == 9
    a, loose = _electro_floats(jlog)
    b, _ = _electro_floats(log)
    assert a.size == b.size and a.size > 0
    np.testing.assert_allclose(b[~loose], a[~loose], rtol=1e-9, atol=1e-11)
    scale = 16 * 4 * 4 * max(abs(v) for v in a)
    np.testing.assert_allclose(b[loose], a[loose], rtol=0,
                               atol=1e-12 * scale)

    def sor(lg):
        return re.findall(r"SOR solver converged to (\w+) tolerance\n"
                          r"SOR residual\s+\S+ at (\d+) iterations\n"
                          r"(\d+) multisteps", lg)

    assert sor(log) == sor(jlog)
    assert len(sor(log)) == (2 if solver == "sor" else 0)


@pytest.mark.parametrize("line", [
    # subgrid particles in the electrolyte; colloids beside planes
    "colloid_init input_one\ncolloid_one_a0 2.3\ncolloid_one_type subgrid",
    "N_LE_plane 2\nLE_plane_vel 0.01\ncolloid_init input_one\n"
    "colloid_one_a0 2.3",
    # planes of the electrolyte
    "N_LE_plane 2\nLE_plane_vel 0.01",
    "tpu_shard on", "lc_redshift_update 1",
    # walls and porous media beside charged colloids
    "boundary_walls 0_1_0\ncolloid_init input_one\ncolloid_one_a0 2.3",
    "porous_media_init simple_cubic\nporous_media_acell 4\n"
    "colloid_init input_one\ncolloid_one_a0 2.3"])
def test_unported_electro_keys_raise(line):
    with pytest.raises(NotImplementedError, match=line.split()[0]):
        run_text(ELECTRO_INPUT + line + "\n", out=io.StringIO(),
                 device="cpu")


def test_no_device_means_the_card():
    """Named or not, a CUDA device that is not there raises; nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_text(PLAIN_INPUT, out=io.StringIO())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_text(BINARY_FUSED_INPUT, out=io.StringIO(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_text("tpu_fused on\n" + LC_FUSED_INPUT, out=io.StringIO())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_text("tpu_fused on\n" + DROPLET_FUSED_INPUT, out=io.StringIO())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_text(ELECTRO_INPUT, out=io.StringIO())


def test_fused_cli_matches_jax():
    jlog, log, sys_ = _logs("tpu_fused interpret\n" + PLAIN_FUSED_INPUT,
                            "tpu_fused on\n" + PLAIN_FUSED_INPUT)
    assert sys_.fused_mode == "plain"
    assert "Completed cycle 6" in log
    a, b = _stat_floats(jlog), _stat_floats(log)
    assert a.size == b.size and a.size > 0
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11)


def test_plain_cli_matches_jax():
    jlog, log, sys_ = _logs(PLAIN_INPUT, PLAIN_INPUT)
    assert sys_.fused_mode is None
    assert "Completed cycle 5" in log
    a, b = _stat_floats(jlog), _stat_floats(log)
    assert a.size == b.size and a.size > 0
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11)
    # body force adds momentum: gx = nsites * F * t
    gx_final = float(re.findall(r"\[total   \]\s+(\S+)", log)[-1])
    assert abs(gx_final - 16 * 8 * 8 * 1e-5 * 5) < 1e-10


@pytest.mark.parametrize("line", [
    "lc_redshift_update 1", "mobility 0.1", "freq_psi 2",
    # the plain fluid's walls, planes, restarts, periodicity and shear
    # observables are read since they are ported, and so are the colloids'
    # keys and the measurements, and so are the I/O grids; sharding, the
    # viscosity models and other families' keys are not (a key the JAX
    # package does not read runs: tests/test_torch_fulllog.py)
    "lc_a0 0.01", "surf_A -0.02", "tpu_shard on",
    "electric_e0 0.01_0_0", "ternary_alpha 1.0",
    "viscosity_model arrhenius"])
def test_unported_keys_raise(line):
    with pytest.raises(NotImplementedError, match=line.split()[0]):
        run_text(PLAIN_INPUT + line + "\n", out=io.StringIO(), device="cpu")


def test_inactive_defaults_accepted():
    text = PLAIN_INPUT + textwrap.dedent("""
        free_energy none
        colloid_init no_colloids
        periodicity 1_1_1
        boundary_walls 0_0_0
        temperature 0.0
        N_start 0
        dtype float32
        """)
    log = io.StringIO()
    sys_ = run_text(text, out=log, device="cpu")
    assert sys_.state[0].dtype == torch.float32
    assert "Completed cycle 5" in log.getvalue()


def test_cli_runs_without_jax(tmp_path):
    """`python -m ludwig_tpu_torch input --device cpu` in a fresh
    interpreter, for the plain, the binary, the liquid-crystal, the
    droplet, the electrokinetic, the fluctuating plain, the walled (with
    a velocity file) and the Lees-Edwards input, and the sheared binary
    (fused, with the shear observables), blue-phase (unfused) and droplet
    (fused) inputs: all run, and neither JAX nor ludwig_tpu is imported,
    the boundary, I/O and shear modules included; and the two-particle
    colloid input, with the colloid, interaction, Ewald and subgrid
    modules; and one input of each of the other free energies
    (brazovskii, surfactant, ternary, symmetric_lb, polar_active,
    fe_electro_symmetric)."""
    inp, inp_binary = tmp_path / "input", tmp_path / "input_binary"
    inp_lc, inp_drop = tmp_path / "input_lc", tmp_path / "input_droplet"
    inp_elec = tmp_path / "input_electro"
    inp_elec.write_text(ELECTRO_INPUT)
    inp_noise = tmp_path / "input_noise"
    inp_noise.write_text("tpu_fused off\n" + PLAIN_INPUT + NOISE_KEYS)
    inp_wall, inp_le = tmp_path / "input_wall", tmp_path / "input_le"
    inp_wall.write_text("tpu_fused on\n" + WALL_FUSED_INPUT
                        + f"freq_vel 6\nio_directory {tmp_path}\n")
    inp_le.write_text("tpu_fused on\n" + LE_FUSED_INPUT)
    inp.write_text("tpu_fused on\n" + PLAIN_INPUT)
    inp_binary.write_text("tpu_fused on\n" + BINARY_FUSED_INPUT)
    inp_lc.write_text("tpu_fused on\n" + LC_FUSED_INPUT)
    inp_drop.write_text("tpu_fused on\n" + DROPLET_FUSED_INPUT)
    sheared = []
    for name, fused in (("binary", "on"), ("lc", "off"), ("droplet", "on")):
        sheared.append(tmp_path / f"input_le_{name}")
        sheared[-1].write_text(f"tpu_fused {fused}\n" + LE_INPUTS[name]
                               + SHEAR_KEYS + f"io_directory {tmp_path}\n")
    inp_col = tmp_path / "input_colloids"
    inp_col.write_text(COLLOID_INPUTS["input_two"]
                       + f"io_directory {tmp_path}\n")
    # one input of each of the other free energies
    more_fe = []
    for name in ("brazovskii", "surfactant", "ternary_double_emulsion",
                 "symmetric_lb", "polar_active", "fe_electro_symmetric"):
        more_fe.append(tmp_path / f"input_{name}")
        more_fe[-1].write_text(MORE_FE_INPUTS[name])
    probe = textwrap.dedent(f"""
        import runpy, sys
        for path in ({str(inp)!r}, {str(inp_binary)!r}, {str(inp_lc)!r},
                     {str(inp_drop)!r}, {str(inp_elec)!r},
                     {str(inp_noise)!r}, {str(inp_wall)!r},
                     {str(inp_le)!r}, {str(inp_col)!r}) + {
                     tuple(str(p) for p in sheared + more_fe)!r}:
            sys.argv = ["ludwig_tpu_torch", path, "--device", "cpu"]
            runpy.run_module("ludwig_tpu_torch", run_name="__main__")
        import ludwig_tpu_torch.ops._cuda, ludwig_tpu_torch.convert
        import ludwig_tpu_torch.ops.fused_electro
        import ludwig_tpu_torch.ops.walls, ludwig_tpu_torch.ops.open_bc
        import ludwig_tpu_torch.ops.le_ref, ludwig_tpu_torch.binary_le
        import ludwig_tpu_torch.stats_extra
        import ludwig_tpu_torch.ops.lees_edwards, ludwig_tpu_torch.io
        import ludwig_tpu_torch.io.map_file, ludwig_tpu_torch.io.ref_format
        import ludwig_tpu_torch.colloids, ludwig_tpu_torch.colloids_fast
        import ludwig_tpu_torch.interactions, ludwig_tpu_torch.ewald
        import ludwig_tpu_torch.subgrid, ludwig_tpu_torch.io.colloid_io
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.")
               or m == "ludwig_tpu" or m.startswith("ludwig_tpu.")]
        assert not bad, bad
        print("NO_JAX_OK")
        """)
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert "Completed cycle 5" in res.stdout
    assert "[fed]" in res.stdout and "Completed cycle 4" in res.stdout
    assert "[Qxx]" in res.stdout and "[fe]" in res.stdout
    # LC and droplet runs, plain and sheared
    assert res.stdout.count("[Qyz]") == 3 + 3 + 3 + 3
    assert (tmp_path / "str-00000004.dat").exists()
    # fe_electro, then fe_electro_symmetric
    assert res.stdout.count("[elc]") == 3 + 3 and "[walls   ]" in res.stdout
    assert "SOR (heterogeneous) solver" in res.stdout
    assert res.stdout.count("[Pz ]") == 3            # the polar gel
    assert res.stdout.count("[surf/fl/tot]") == 3    # the ternary fluid
    assert res.stdout.count("[measd/kT]") == 1     # the noise input
    assert res.stdout.count("[walls   ]") == 3 + 3    # electro, walls
    assert "Writing rho/velocity output at step 6!" in res.stdout
    assert (tmp_path / "vel-00000006.001-001").exists()
    # electro, walls, LE and the six other free energies
    assert res.stdout.count("Completed cycle 6") == 3 + 6
    assert "[colloids]" in res.stdout and "Particle statistics:" in res.stdout
    assert (tmp_path / "config.cds00000004.001-001").exists()
    assert "NO_JAX_OK" in res.stdout


# isothermal fluctuations of the plain fluid (tests/test_ludwig_run.py:
# 423-435)
NOISE_KEYS = """
temperature 0.00002
isothermal_fluctuations on
random_seed 8361235
"""
KT_TAGS = ("[eqipart.]", "[measd/kT]")


# the plain fluid's boundaries: porous media (a simple cubic crystal of
# ref map_init.c), partial slip on the duct's walls, an open channel
# (walls on y, inflow / outflow along x) and walls with the KISS stream
POROUS_INPUT = """
N_cycles 4
size 8_8_8
viscosity 0.1
force 0.00001_0.0_0.0
porous_media_init simple_cubic
porous_media_acell 4
freq_statistics 2
"""
SLIP_INPUT = DUCT_FUSED_INPUT + """
boundary_walls_slip_fraction_bot 0.5_0.25_0
boundary_walls_slip_fraction_top 0.25_1.0_0
"""
OPEN_INPUT = """
N_cycles 6
size 16_8_8
viscosity 0.1
boundary_walls 0_1_0
lb_bc_open on
lb_bc_inflow_rhou_u0 0.01_0_0
lb_bc_outflow_rhou_rho0 1.0
freq_statistics 3
"""
BOUNDARY_INPUTS = {
    "walls": (WALLS_INPUT, "wall"), "wall": (WALL_FUSED_INPUT, "wall"),
    "couette": (COUETTE_FUSED_INPUT, "wall"),
    "duct": (DUCT_FUSED_INPUT, "wall"), "le": (LE_FUSED_INPUT, "le"),
    "porous": (POROUS_INPUT, None), "slip": (SLIP_INPUT, None),
    "open": (OPEN_INPUT, None), "walls-kiss": (WALL_FUSED_INPUT + NOISE_KEYS,
                                               None)}


def _kt_floats(log):
    return np.array([float(t) for line in log.splitlines()
                     if line.startswith(KT_TAGS) for t in line.split()[1:]])


@pytest.mark.parametrize("fused", ["interpret", "on", "off"])
def test_noise_cli_matches_jax(fused):
    """The fluctuating plain input on the fused route (FusedNoise: the
    counter-hash stream, the twin against the Pallas kernel in interpret
    mode) and on the KISS route (the reference-exact per-site stream),
    which float64 under `tpu_fused on` takes in both packages: every
    statistics float, the kT block's included, at rtol 1e-9 / atol
    1e-11."""
    text = f"tpu_fused {fused}\n" + PLAIN_FUSED_INPUT + NOISE_KEYS
    jlog, log, sys_ = _logs(text, text)
    assert sys_.fused_mode == ("plain" if fused == "interpret" else None)
    assert sys_.has_kiss == (fused != "interpret")
    assert "Completed cycle 6" in log
    for tag in ("Isothermal fluctuations\n[eqipart.]",) + KT_TAGS:
        assert log.count(tag) == jlog.count(tag) == 2
    a, b = _stat_floats(jlog), _stat_floats(log)
    assert a.size == b.size and a.size > 0
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11)
    ka, kb = _kt_floats(jlog), _kt_floats(log)
    assert ka.size == kb.size == 10
    np.testing.assert_allclose(kb, ka, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("text", [
    "tpu_fused interpret\n" + PLAIN_FUSED_INPUT,
    "tpu_fused on\n" + PLAIN_FUSED_INPUT,                      # float64
    "tpu_fused on\ndtype float32\n" + PLAIN_FUSED_INPUT,
    "tpu_fused on\ndtype float32\n"
    + PLAIN_FUSED_INPUT.replace("16_16_32", "16_12_32"),      # no plan
    "tpu_fused off\n" + PLAIN_FUSED_INPUT], ids=[
        "interpret", "on-f64", "on-f32", "on-no-plan", "off"])
def test_noise_route_follows_the_jax_gate(text):
    """With isothermal fluctuations the two routes draw different noise,
    so the port steps the route ludwig_tpu's build_system takes for the
    same input: FusedNoise on its fused route, the KISS stream where it
    leaves fused_mode None."""
    from ludwig_tpu import ludwig as jl
    from ludwig_tpu.runtime import RunTime as JRunTime
    from ludwig_tpu_torch import ludwig as tl
    from ludwig_tpu_torch.runtime import RunTime

    tsys = tl.build_system(RunTime(text + NOISE_KEYS), device="cpu")
    jsys = jl.build_system(JRunTime(text + NOISE_KEYS))
    assert (tsys.fused_mode is None) == (jsys.fused_mode is None)
    assert tsys.has_kiss == jsys.has_kiss == (jsys.fused_mode is None)
    assert len(tsys.state) == len(jsys.state)


def _jax_stats_lines(text, nsteps):
    """(JAX System after nsteps of its step, its u, the report lines of
    ludwig_tpu's report_statistics for that state)."""
    from ludwig_tpu import ludwig as jl
    from ludwig_tpu.runtime import RunTime as JRunTime

    jsys = jl.build_system(JRunTime(text))
    assert jsys.fused_mode is None
    state = jsys.state
    for t in range(1, nsteps + 1):
        if jsys.is_electro:
            state, _aux = jsys.step_fn(state, t)
            u = state[3]
        else:
            state, _rho, u = jsys.step_fn(state, t)
    jsys.state = state
    out = io.StringIO()
    jl.report_statistics(jsys, nsteps, u, jl._make_stats_fn(jsys), out=out)
    return jsys, u, out.getvalue()


def _port_stats_lines(text, state, u, nsteps):
    from ludwig_tpu_torch import ludwig as tl
    from ludwig_tpu_torch.runtime import RunTime

    tsys = tl.build_system(RunTime(text), device="cpu")
    assert tl.reference_statistics(tsys)
    tsys.state = state
    out = io.StringIO()
    tl.report_statistics(tsys, nsteps, u,
                         tl._make_stats_fn(tsys, reference=True), out=out)
    return out.getvalue()


def test_reference_statistics_lines_equal_jax_plain_kiss():
    """The repair of the port's statistics: for one state (four steps of
    the JAX package's KISS route, carried across), the port's lines are
    the JAX package's report_statistics lines as text - [rho], the
    near-zero momentum totals, the velocity and the kT block."""
    from ludwig_tpu_torch.convert import noise_state_from_jax, state_from_jax

    text = "tpu_fused off\n" + PLAIN_FUSED_INPUT + NOISE_KEYS
    jsys, u, want = _jax_stats_lines(text, 4)
    f, nstate = jsys.state
    state = (state_from_jax(np.asarray(f), "cpu", "float64"),
             noise_state_from_jax(np.asarray(nstate), "cpu"))
    got = _port_stats_lines(text, state, torch.as_tensor(np.asarray(u)), 4)
    assert "[measd/kT]" in got and "[total   ]" in got
    assert got == want


def test_reference_statistics_lines_equal_jax_electro():
    """The same for the electrokinetic input: [rho] over the fluid sites,
    the site-order [psi], [rho] and [elc] totals, [fed], the momentum
    with [walls] and the velocity."""
    from ludwig_tpu_torch.convert import electro_state_from_jax

    jsys, u, want = _jax_stats_lines(ELECTRO_INPUT, 3)
    state = electro_state_from_jax(*(np.asarray(a) for a in jsys.state),
                                   device="cpu", dtype="float64")
    got = _port_stats_lines(ELECTRO_INPUT, state, state[3], 3)
    assert "[elc]" in got and "[walls   ]" in got
    assert got == want


@pytest.mark.parametrize("text,reference", [
    ("tpu_fused off\n" + PLAIN_FUSED_INPUT, True),
    ("tpu_fused interpret\n" + PLAIN_FUSED_INPUT, False),
    ("tpu_fused on\n" + PLAIN_FUSED_INPUT, True),            # float64
    ("tpu_fused on\ndtype float32\n" + PLAIN_FUSED_INPUT, False),
    ("tpu_fused on\ndtype float32\n"
     + PLAIN_FUSED_INPUT.replace("16_16_32", "16_12_32"), True),  # no plan
    ("tpu_fused on\ndtype float32\n" + BINARY_FUSED_INPUT, True),  # z 16
    ("tpu_fused interpret\n" + BINARY_FUSED_INPUT, False),
    (ELECTRO_INPUT, True),
    ("tpu_fused on\n" + WALL_FUSED_INPUT, True),              # float64
    ("tpu_fused interpret\n" + WALL_FUSED_INPUT, False),
    ("tpu_fused on\ndtype float32\n" + COUETTE_FUSED_INPUT, False),
    ("tpu_fused on\ndtype float32\n"
     + DUCT_FUSED_INPUT.replace("16_16_32", "16_12_32"), True),  # no plan
    ("tpu_fused interpret\n" + LE_FUSED_INPUT, False),
    ("tpu_fused off\n" + LE_FUSED_INPUT, True),
    ("tpu_fused interpret\n" + POROUS_INPUT, True),
    ("tpu_fused interpret\n" + BINARY_LE_FUSED_INPUT, False),
    ("tpu_fused on\n" + BINARY_LE_FUSED_INPUT, True),        # float64
    ("tpu_fused off\n" + BINARY_LE_FUSED_INPUT, True),
    ("tpu_fused interpret\n" + LC_LE_FUSED_INPUT, False),
    ("tpu_fused off\n" + LC_LE_FUSED_INPUT, True),
    ("tpu_fused interpret\n" + DROPLET_LE_INPUT, False),
    ("tpu_fused on\ndtype float32\n" + DROPLET_LE_INPUT, True)], ids=[
        "plain-off", "plain-interpret", "plain-on-f64", "plain-on-f32",
        "plain-no-plan", "binary-z16", "binary-interpret", "electro",
        "wall-on-f64", "wall-interpret", "couette-on-f32", "duct-no-plan",
        "le-interpret", "le-off", "porous", "binary-le-interpret",
        "binary-le-on-f64", "binary-le-off", "lc-le-interpret", "lc-le-off",
        "droplet-le-interpret", "droplet-le-on-f32-z16"])
def test_statistics_follow_the_jax_route_rule(text, reference):
    """Reference statistics wherever ludwig_tpu's build_system leaves
    fused_mode None for the same input (porous media and masked runs are
    unfused in both packages)."""
    from ludwig_tpu import ludwig as jl
    from ludwig_tpu.runtime import RunTime as JRunTime
    from ludwig_tpu_torch import ludwig as tl
    from ludwig_tpu_torch.runtime import RunTime

    tsys = tl.build_system(RunTime(text), device="cpu")
    assert tl.reference_statistics(tsys) == reference
    assert (jl.build_system(JRunTime(text)).fused_mode is None) == reference


WALL_TAGS = ("[rho]", "[total", "[fluid", "[walls", "[minimum", "[maximum",
             "[eqipart.]", "[measd/kT]")


def _boundary_floats(log):
    """The statistics floats, the [walls] row and the kT block's
    included."""
    return np.array([float(t) for line in log.splitlines()
                     if line.startswith(WALL_TAGS) for t in line.split()
                     if re.match(r"^-?\d", t)])


@pytest.mark.parametrize("name", list(BOUNDARY_INPUTS))
def test_boundary_cli_matches_jax(name):
    """The JAX package's wall, Couette, duct, Lees-Edwards, porous, slip,
    open-boundary and walls-with-noise inputs in f64, through its jnp
    route: the port's log under `tpu_fused on` (the fused wall and LE
    steps where the gate takes them) and `off` within rtol 1e-9 / atol
    1e-11, [walls] rows included."""
    text, fused_mode = BOUNDARY_INPUTS[name]
    jlog = io.StringIO()
    jrun_text("tpu_fused off\n" + text, out=jlog)
    want = _boundary_floats(jlog.getvalue())
    assert want.size > 0
    for fused, mode in (("on", fused_mode), ("off", None)):
        log = io.StringIO()
        sys_ = run_text(f"tpu_fused {fused}\n" + text, out=log, device="cpu")
        assert sys_.fused_mode == mode
        assert (log.getvalue().count("[walls   ]")
                == jlog.getvalue().count("[walls   ]"))
        np.testing.assert_allclose(_boundary_floats(log.getvalue()), want,
                                   rtol=1e-9, atol=1e-11)


IO_KEYS = "freq_config 2\nfreq_vel 3\nconfig_at_end yes\n"


def test_io_cli_matches_jax(tmp_path):
    """The walled input with the KISS stream (its state: dist, the walls'
    momentum, the KISS words) and checkpoints, velocity files and the
    end configuration: the same files as the JAX package's unfused route
    writes, the same sidecars byte for byte, the same "Writing" lines,
    values within rtol 1e-9 (the KISS words equal); then the port's
    restart from its step-4 checkpoint prints its own straight log as
    text."""
    text = WALL_FUSED_INPUT + NOISE_KEYS + IO_KEYS
    dj, dt = tmp_path / "jax", tmp_path / "port"
    jlog, log, _sys = _logs(text + f"io_directory {dj}\n",
                            text + f"io_directory {dt}\n")
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt))
    assert "state02-00000006" in names and "vel-00000006.001-001" in names
    writing = [ln for ln in log.splitlines() if ln.startswith("Writing")]
    assert writing == [ln for ln in jlog.splitlines()
                       if ln.startswith("Writing")]
    assert len(writing) == 3 + 4      # configs 2, 4, 6; velocity 2, 3, 4, 6
    for name in names:
        a, b = (dj / name).read_bytes(), (dt / name).read_bytes()
        if "meta" in name or name.startswith("state02"):
            assert a == b, name
        else:
            np.testing.assert_allclose(np.frombuffer(b, "<f8"),
                                       np.frombuffer(a, "<f8"), rtol=1e-9,
                                       atol=1e-11)
    rest = io.StringIO()
    run_text(text.replace("N_cycles 6", "N_cycles 2")
             + f"N_start 4\nio_directory {dt}\n", out=rest, device="cpu")
    step6 = "Writing distribution output at step 6!"
    straight = log[log.index(step6):]
    resumed = rest.getvalue()
    resumed = resumed[resumed.index(step6):]
    assert straight.split("\nTimer")[0] == resumed.split("\nTimer")[0]


def test_lees_edwards_field_metadata(tmp_path):
    """A sheared run's velocity file records its planes in both metadata
    vintages, as the JAX package's fused route writes them."""
    text = ("tpu_fused on\n" + LE_FUSED_INPUT.replace("16_16_32", "16_8_8")
            + f"freq_vel 6\nio_directory {tmp_path}\n")
    run_text(text, out=io.StringIO(), device="cpu")
    meta = (tmp_path / "vel.001-001.meta").read_text()
    assert "Lees-Edwards planes:             2\n" in meta
    assert "Lees-Edwards plane speed         0.05000000000000\n" in meta
    js = (tmp_path / "vel-metadata.001-001").read_text()
    assert '"Number of planes": 2' in js and '"Plane speed": 0.05' in js


def test_psi_files_match_jax(tmp_path):
    """`freq_psi` writes psi and the charge densities of the
    Gouy-Chapman input as the JAX package does: the same files, the
    same sidecars, values within rtol 1e-9."""
    dj, dt = tmp_path / "jax", tmp_path / "port"
    dj.mkdir(), dt.mkdir()      # the field writers create no directory
    jlog, log, _sys = _logs(ELECTRO_INPUT + f"freq_psi 3\nio_directory {dj}\n",
                            ELECTRO_INPUT + f"freq_psi 3\nio_directory {dt}\n")
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt))
    assert "psi-00000006.001-001" in names and "rho-00000003.001-001" in names
    assert log.count("Writing psi file") == jlog.count("Writing psi file") == 2
    for name in names:
        a, b = (dj / name).read_bytes(), (dt / name).read_bytes()
        if "meta" in name:
            assert a == b, name
        else:
            np.testing.assert_allclose(np.frombuffer(b, "<f8"),
                                       np.frombuffer(a, "<f8"), rtol=1e-9,
                                       atol=1e-11)


@pytest.fixture(scope="module")
def jax_le_logs(tmp_path_factory):
    """ludwig_tpu's `tpu_fused off` run of each sheared input with the
    shear observables on: {name: (log, io directory)}, made once."""
    runs = {}
    for name, text in LE_INPUTS.items():
        d = tmp_path_factory.mktemp(f"jax_{name}")
        out = io.StringIO()
        jrun_text(f"tpu_fused off\n{text}{SHEAR_KEYS}io_directory {d}\n",
                  out=out)
        runs[name] = (out.getvalue(), d)
    return runs


VELOCITY = ("[minimum", "[maximum")


def _velocity_floats(log):
    return np.array([float(t) for line in log.splitlines()
                     if line.startswith(VELOCITY) for t in line.split()[2:]])


def _without(log, tags):
    return "\n".join(ln for ln in log.splitlines() if not ln.startswith(tags))


def _str_floats(path):
    return np.array([float(t) for t in path.read_text().split()])


def hold_str(got, want):
    """str-*.dat floats within rtol 1e-12; entries that cancel to the
    round-off of the two packages' states (the mean u_x of a sheared
    flow, ~1e-17) are held to 1e-12 of the file's largest magnitude."""
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("name", list(LE_INPUTS))
def test_le_cli_matches_jax(name, fused, jax_le_logs, tmp_path):
    """The sheared binary, blue-phase and droplet inputs on the port's
    fused route (K1, the column fix, K2, the LE post-pass) and its
    unfused one (carrying the LE gradients where the JAX package's does)
    against ludwig_tpu's unfused log: the statistics floats within rtol
    1e-9 / atol 1e-11, the [fed] / [fe] lines with the LE gradients of the
    pre-update field; the binary fluid's str-*.dat files (its stress
    included) as hold_str holds them.

    ludwig_tpu logs the min and max of Q's first three components as the
    velocity of its unfused sheared droplet (ludwig.py:3436-3438 take u =
    state[2] wherever le_cfg is set, which is Q in (f, phi, Q, u)).  The
    port logs u: the droplet's velocity block is held to the port's other
    route, and the JAX block to Q's extremes, which shows the fault."""
    jlog, jdir = jax_le_logs[name]
    text = f"tpu_fused {fused}\n{LE_INPUTS[name]}{SHEAR_KEYS}"
    out = io.StringIO()
    sys_ = run_text(text + f"io_directory {tmp_path}\n", out=out,
                    device="cpu")
    log = out.getvalue()
    assert sys_.le_cfg is not None and "Completed cycle 4" in log
    assert sys_.fused_mode == (name if fused == "on" else None)
    assert sys_.keep_grads == (fused == "off" and name != "droplet")
    tags = {"binary": ("[phi]", "[fed]"), "lc": ("[Qxx]", "[fe]"),
            "droplet": ("[phi]", "[Qyz]", "[fed]")}[name]
    for tag in tags:
        assert log.count(tag) == jlog.count(tag) == 3
    if name == "droplet":
        other = io.StringIO()
        run_text(text.replace(f"tpu_fused {fused}", "tpu_fused " + (
            "off" if fused == "on" else "on")), out=other, device="cpu")
        np.testing.assert_allclose(_velocity_floats(log),
                                   _velocity_floats(other.getvalue()),
                                   rtol=1e-9, atol=1e-11)
        for block in jlog.split("Completed cycle")[1:-1]:
            rows = {ln.split()[0]: ln.split() for ln in block.splitlines()
                    if ln.startswith("[")}
            assert ([float(rows[q][4]) for q in ("[Qxx]", "[Qxy]", "[Qxz]")]
                    == [float(v) for v in rows["[minimum"][2:5]])
        jlog, log = (_without(lg, VELOCITY) for lg in (jlog, log))
    a, b = _stat_floats(jlog), _stat_floats(log)
    assert a.size == b.size > 0
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11)
    names = sorted(p.name for p in tmp_path.glob("str-*.dat"))
    assert names == sorted(p.name for p in jdir.glob("str-*.dat")) == [
        "str-00000002.dat", "str-00000004.dat"]
    if name == "binary":
        for n in names:
            hold_str(_str_floats(tmp_path / n), _str_floats(jdir / n))


def test_plain_le_shear_observables_match_jax(tmp_path):
    """The plain fluid's Lees-Edwards input with the shear observables on
    both routes: the same str-*.dat files as ludwig_tpu's, the stress
    slots zero, the floats as hold_str holds them."""
    text = LE_FUSED_INPUT + "freq_shear_measurement 2\nfreq_shear_output 3\n"
    dj = tmp_path / "jax"
    dj.mkdir()
    jrun_text(f"tpu_fused off\n{text}io_directory {dj}\n", out=io.StringIO())
    want = sorted(p.name for p in dj.glob("str-*.dat"))
    assert want == ["str-00000003.dat", "str-00000006.dat"]
    for fused in ("on", "off"):
        dt = tmp_path / fused
        dt.mkdir()
        run_text(f"tpu_fused {fused}\n{text}io_directory {dt}\n",
                 out=io.StringIO(), device="cpu")
        assert sorted(p.name for p in dt.glob("str-*.dat")) == want
        for n in want:
            got = _str_floats(dt / n).reshape(-1, 22)
            assert not got[:, 6:12].any() and not got[:, 21].any()
            hold_str(got.ravel(), _str_floats(dj / n))


@pytest.mark.parametrize("name", ["binary", "lc"])
def test_reference_statistics_lines_equal_jax_le(name):
    """For one state (three steps of the JAX package's unfused sheared
    route, its kept LE gradients included, carried across) the port's
    reference statistics lines are ludwig_tpu's as text, [fed] / [fe]
    read from the kept gradients."""
    from ludwig_tpu import ludwig as jl
    from ludwig_tpu.runtime import RunTime as JRunTime
    from ludwig_tpu_torch import ludwig as tl
    from ludwig_tpu_torch.runtime import RunTime

    text = "tpu_fused off\n" + LE_INPUTS[name]
    jsys = jl.build_system(JRunTime(text))
    state = jsys.state
    step = jsys.step_fn.__wrapped__      # op by op: no XLA compile
    for t in range(1, 4):
        state, _rho = step(state, t)
    jsys.state = state
    want = io.StringIO()
    jl.report_statistics(jsys, 3, state[2], jl._make_stats_fn(jsys),
                         out=want)
    tsys = tl.build_system(RunTime(text), device="cpu")
    assert tl.reference_statistics(tsys) and tsys.keep_grads
    tsys.state = tuple(torch.as_tensor(np.array(a)) for a in state)
    got = io.StringIO()
    tl.report_statistics(tsys, 3, tsys.state[2],
                         tl._make_stats_fn(tsys, reference=True), out=got)
    assert "[fe" in got.getvalue()
    assert got.getvalue() == want.getvalue()


RESTART_INPUTS = {"lc": LC_FUSED_INPUT, "binary-le": BINARY_LE_FUSED_INPUT,
                  "lc-le": LC_LE_FUSED_INPUT}
# the port's fused routes where the JAX package's route is unfused and
# keeps the gradients: the blue phase under `tpu_fused on` in float64, the
# sheared binary fluid with z = 16 (not a multiple of 128); the port's
# checkpoint adds the pre-update field's gradients as state03 / state04.
# The fused and unfused routes round differently: 1e-13 on the states.
FUSED_RESTART = {"lc-fused-f64": LC_FUSED_INPUT,
                 "binary-le-fused-z16": BINARY_LE_FUSED_INPUT}
# two resolved particles from a config.cds.init in each run's io
# directory (@DIR@): the port's checkpoint carries the JAX package's
# ColloidState leaves and map, the restart reads config.cds00000003
COLLOID_RESTART = {"colloids-from-file": """
N_cycles 4
size 16_16_16
viscosity 0.1
free_energy none
colloid_init from_file
colloid_file_stub @DIR@/config.cds
colloid_gravity 0.0_0.0_-0.0001
freq_statistics 2
"""}


# the binary fluid's boundary and noise routes: halo walls with the
# 27-point wetting stencil (gwall rides as state03), and symmetric_noise
# with the LB's fluctuations (the KISS states of phi and rho as state03
# and state04, bitwise across)
BINARY_RESTART = {
    "binary-walls-27pt": (BINARY_FUSED_INPUT.replace(
        "3d_7pt_fluid", "3d_27pt_solid") + "boundary_walls 0_0_1\n",
        ["dist", "phi", "vel", "state03"]),
    "binary-kiss-noise": (BINARY_FUSED_INPUT.replace(
        "free_energy symmetric", "free_energy symmetric_noise")
        + "temperature 0.00002\nisothermal_fluctuations on\n"
          "fd_phi_fluctuations 1\n",
        ["dist", "phi", "vel", "state03", "state04"])}


# the liquid crystal's new state leaves: gwall (walls), the redshift, the
# particles between walls (f, R, V, W, dr, Rmap, M, q5, u, grad, delsq,
# gwall, named as the JAX package names an LC state's first leaves); the packages' whole-lattice
# sums (gwall, the redshift) and the particles' link sums round
# differently: 1e-13 on the states
LC_RESTART = {
    "lc-walls": (LC_FUSED_INPUT + WALL_S7 + "\n",
                 ["dist", "q", "vel", "state03", "state04", "state05"]),
    "lc-redshift": (LC_FUSED_INPUT + "lc_redshift_update 1\n",
                    ["dist", "q", "vel", "state03", "state04", "state05"]),
    "lc-colloids-walls": (
        LC_COLLOIDS_WALLS.replace("size 12_12_12", "size 10_10_10")
        .replace("colloid_two_r 9.5_6.5_7.0", "colloid_two_r 8.0_5.5_6.0"),
        ["dist", "q", "vel"] + [f"state{i:02d}" for i in range(3, 12)])}


# the binary fluid's colloids between walls on z (f, R, V, W, dr, Rmap, M,
# phi, u, grad, delsq, gwall; the first leaves named as the JAX package
# names a binary state's): the link and whole-lattice sums round in each
# package's order, 1e-13 on the states (the input is defined below)
FAMILY_RESTART = {"binary-colloids-walls": ["dist", "phi", "vel"]
                  + [f"state{i:02d}" for i in range(3, 12)]}


def _steps(log, after, last):
    """The statistics numbers of a log after the line `after`, up to
    'Completed cycle <last>': _stat_floats' tokens, where a token glues a
    pair (the [Q..] rows print a negative second float with no space)
    split in two."""
    tail = log[log.index(after):]
    tail = tail[:tail.index(f"Completed cycle {last}\n")]
    return np.array([
        float(v) for line in tail.splitlines()
        if line.startswith(("[rho]", "[phi]", "[Q", "[fe", "[total",
                            "[fluid", "[minimum", "[maximum"))
        for tok in line.split() if re.match(r"^-?\d", tok)
        for v in re.findall(r"-?\d+(?:\.\d*)?(?:e[-+]?\d+)?", tok)])


def _colloid_records(n, seed=1, a0=2.3):
    """config.cds records of n particles from a numpy seed, spread along
    x, moving."""
    from ludwig_tpu_torch.io.colloid_io import default_state
    rng = np.random.RandomState(seed)
    recs = []
    for i in range(n):
        rec = default_state()
        rec["index"] = i + 1
        rec["a0"] = rec["ah"] = a0
        rec["r"] = [1.0 + (i + 0.5) * 16.0 / n + rng.uniform(-0.5, 0.5),
                    float(rng.uniform(3.0, 14.0)),
                    float(rng.uniform(3.0, 14.0))]
        rec["v"] = [float(v) for v in 0.005 * rng.standard_normal(3)]
        rec["w"] = [float(v) for v in 0.001 * rng.standard_normal(3)]
        rec["dr"] = list(rec["v"])
        rec["m"] = [1.0, 0.0, 0.0]
        recs.append(rec)
    return recs


def _write_init(directory, recs):
    from ludwig_tpu_torch.io.colloid_io import write_colloid_file
    write_colloid_file(os.path.join(str(directory), "config.cds.init"), recs)


@pytest.mark.parametrize("name", list(RESTART_INPUTS) + list(FUSED_RESTART)
                         + list(COLLOID_RESTART) + list(BINARY_RESTART)
                         + list(LC_RESTART) + list(FAMILY_RESTART))
def test_restart_across_packages(name, tmp_path):
    """The unfused LC route (the repaired checkpoint: the gradient leaves
    state03 and state04 ride as the JAX package's do) and the unfused
    sheared binary and LC routes, in float64: the port writes its step-3
    checkpoint, ludwig_tpu.run_text restarts from it (N_start 3) and runs
    steps 4-6 and writes its step-6 checkpoint, from which the port
    restarts for step 7.  Each package's checkpoint is the other's file
    set; the states after steps 6 and 7 are the port's straight run's
    within 2e-15, the logged steps within rtol 1e-9."""
    from ludwig_tpu_torch.io import read_state

    import jax
    from ludwig_tpu_torch.ludwig import _state_leaves
    if name in FUSED_RESTART:
        text = f"tpu_fused on\n{FUSED_RESTART[name]}"
    elif name in COLLOID_RESTART:
        text = COLLOID_RESTART[name]
    elif name in BINARY_RESTART:
        text = f"tpu_fused off\n{BINARY_RESTART[name][0]}"
    elif name in LC_RESTART:
        text = LC_RESTART[name][0]
    elif name in FAMILY_RESTART:
        text = COLLOID_INPUTS["binary"].replace("freq_config 4\n", "")
    else:
        text = f"tpu_fused off\n{RESTART_INPUTS[name]}"
    # the fused and unfused routes round differently, and so do the
    # packages' whole-lattice sums of the walls' momentum (gwall)
    atol = (1e-13 if name in FUSED_RESTART or name in LC_RESTART
            or name in FAMILY_RESTART or name == "binary-walls-27pt"
            else 2e-15)
    base = (text.replace("N_cycles 4", "N_cycles 7")
            .replace("freq_statistics 2", "freq_statistics 1"))
    ds, dx = tmp_path / "straight", tmp_path / "shared"
    ds.mkdir(), dx.mkdir()
    if name in COLLOID_RESTART:
        for d in (ds, dx):
            _write_init(d, _colloid_records(2))

    def at(d, t):
        return t.replace("@DIR@", str(d))

    out = io.StringIO()
    straight = run_text(at(ds, base) + f"freq_config 6\nio_directory {ds}\n",
                        out=out, device="cpu")
    slog = out.getvalue()
    steps = base.replace("N_cycles 7", "N_cycles 3")
    run_text(at(dx, steps) + f"config_at_end yes\nio_directory {dx}\n",
             out=io.StringIO(), device="cpu")
    tail = (BINARY_RESTART[name][1][3:] if name in BINARY_RESTART
            else LC_RESTART[name][1][3:] if name in LC_RESTART
            else FAMILY_RESTART[name][3:] if name in FAMILY_RESTART
            else ["state03", "state04"])
    assert {f"{n}-00000003" for n in tail} <= set(os.listdir(dx))
    jout = io.StringIO()
    jsys = jrun_text(at(dx, steps) + f"N_start 3\nconfig_at_end yes\n"
                     f"io_directory {dx}\n", out=jout)
    assert (sorted(n.replace("00000003", "0000000N") for n in os.listdir(dx)
                   if "00000003" in n)
            == sorted(n.replace("00000006", "0000000N")
                      for n in os.listdir(ds) if "00000006" in n)
            == sorted(n.replace("00000006", "0000000N")
                      for n in os.listdir(dx) if "00000006" in n))
    if name in COLLOID_RESTART:
        # f, R, V, W, dr, Rmap, M, then the map (pid, inside)
        names = ["dist"] + [f"state{i:02d}" for i in range(1, 9)]
        assert ((dx / "config.cds00000006.001-001").read_bytes()
                == (ds / "config.cds00000006.001-001").read_bytes())
    elif name in BINARY_RESTART:
        names = BINARY_RESTART[name][1]
    elif name in LC_RESTART or name in FAMILY_RESTART:
        names = (LC_RESTART[name][1] if name in LC_RESTART
                 else FAMILY_RESTART[name])
        if name in ("lc-colloids-walls", "binary-colloids-walls"):
            # the records agree to the states' tolerance (the reference's
            # ASCII digits may differ in the last place)
            from ludwig_tpu_torch.io.colloid_io import read_colloid_file
            a, b = (read_colloid_file(str(d / "config.cds00000006.001-001"))
                    for d in (dx, ds))
            for ra, rb in zip(a, b):
                for key in ("r", "v", "w", "dr"):
                    np.testing.assert_allclose(ra[key], rb[key], rtol=0,
                                               atol=atol)
    else:
        names = ["dist", "phi" if "binary" in name else "q", "vel",
                 "state03", "state04"]
    port6 = read_state(str(ds), 6, names)
    for leaf, key in zip(jax.tree_util.tree_leaves(jsys.state), names):
        np.testing.assert_allclose(np.asarray(leaf), port6[key], rtol=0,
                                   atol=atol)
    np.testing.assert_allclose(
        _steps(jout.getvalue(), "Starting time step loop.", 6),
        _steps(slog, "Completed cycle 3\n", 6), rtol=1e-9, atol=1e-11)
    rest = run_text(at(dx, base).replace("N_cycles 7", "N_cycles 1")
                    + f"N_start 6\nio_directory {dx}\n", out=io.StringIO(),
                    device="cpu")
    for a, b in zip(_state_leaves(rest.state), _state_leaves(straight.state)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=atol)


# colloid inputs of the plain fluid (f64, 16^3): two particles with a
# soft-sphere pair and gravity (as the reference's serial-pair), random
# placement between halo walls with the soft-sphere wall and the wall
# lubrication, six bonded particles from a file (the JAX package's exact
# route) with the pair lubrication, and the repository's 30 subgrid
# particles with FENE bonds
COLLOID_BASE = """
N_cycles 4
size 16_16_16
viscosity 0.1
free_energy none
freq_statistics 2
"""
COLLOID_INPUTS = {
    "input_two": COLLOID_BASE + """
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
freq_config 4
colloid_io_freq 2
""",
    "input_random_walls": COLLOID_BASE + """
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
    "from_file": COLLOID_BASE + """
colloid_init from_file
colloid_file_stub @DIR@/config.cds
lubrication_on 1
lubrication_normal_cutoff 0.5
lubrication_tangential_cutoff 0.3
freq_config 4
""",
    # the hydrodynamic-radius calibration: the driving force and the
    # report (its spin-up, 64 steps at 8^3, is past the run; the
    # measurements are tests/test_torch_interactions.py's)
    "calibration": """
N_cycles 4
size 8_8_8
viscosity 1.0
free_energy none
colloid_init input_one
colloid_one_a0 2.3
colloid_one_ah 2.3
colloid_one_r 4.5_4.5_4.5
calibration on
freq_statistics 2
""",
    "subgrid": COLLOID_BASE.replace("16_16_16", "24_8_16") + f"""
colloid_init from_file
colloid_file_stub {Path(__file__).resolve().parent.parent / "config.cds"}
colloid_gravity 0.0_0.0_-0.0001
bond_fene_on 1
bond_fene_k 0.001
bond_fene_r0 5.0
""",
}
COLLOID_INPUTS["lc_colloids"] = LC_COLLOIDS + "colloid_io_freq 2\n"
# the other families' colloids (12^3, f64): two wetting particles in a
# spinodal binary fluid between walls on z; the same particles in
# symmetric_lb (7-point gradients, periodic); one charged particle in a
# uniform electrolyte with a field on x (the SOR's reference route, the
# Maxwell stress); each writes config.cds at step 4
FAMILY_COLLOIDS = """
N_cycles 4
size 12_12_12
viscosity 0.1
A -0.0625
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
freq_statistics 2
freq_config 4
"""
COLLOID_INPUTS["binary"] = (FAMILY_COLLOIDS + "free_energy symmetric\n"
                            "boundary_walls 0_0_1\n")
COLLOID_INPUTS["symmetric_lb"] = (FAMILY_COLLOIDS
                                  + "free_energy symmetric_lb\n"
                                  "fd_gradient_calculation 3d_7pt_fluid\n")
COLLOID_INPUTS["electro"] = """
N_cycles 4
size 12_12_12
viscosity 0.1
free_energy fe_electro
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
freq_statistics 2
freq_config 4
"""
FLOAT = re.compile(r"^[-+]?\d+\.\d*(e[-+]\d+)?$")


def _colloid_log(log):
    """The lines of a log from 'Initial conditions.' to the last
    'Completed cycle', split into (text with the floats blanked, floats)."""
    body = log[log.index("\nInitial conditions."):]
    body = body[:body.rindex("Completed cycle")]
    words, vals = [], []
    for line in body.splitlines():
        toks = line.split()
        words.append(" ".join("#" if FLOAT.match(t) else t for t in toks))
        vals += [float(t) for t in toks if FLOAT.match(t)]
    return words, np.array(vals)


@pytest.mark.parametrize("name", list(COLLOID_INPUTS))
def test_colloid_cli_matches_jax(name, tmp_path):
    """The port's log of each colloid input against ludwig_tpu.run_text's:
    the same lines (particle statistics, the [colloids] and [walls] rows,
    the colloid I/O lines, the families' [phi], [fe], [psi_zeta] and SOR
    rows), their floats at rtol 1e-9 / atol 1e-11; the plain fluid's
    config.cds files byte-identical, the other families' records at rtol
    1e-13 / atol 1e-15 (their step's whole-lattice and link sums run in
    each package's order)."""
    dj, dt = tmp_path / "jax", tmp_path / "port"
    dj.mkdir(), dt.mkdir()
    if name == "from_file":
        recs = _colloid_records(6, seed=4)
        for i, rec in enumerate(recs):
            rec["nbonds"], rec["bond"] = 1, [(i + 1) % 6 + 1, 0]
        for d in (dj, dt):
            _write_init(d, recs)
    a, b = io.StringIO(), io.StringIO()
    jrun_text(COLLOID_INPUTS[name].replace("@DIR@", str(dj))
              + f"io_directory {dj}\n", out=a)
    sys_ = run_text(COLLOID_INPUTS[name].replace("@DIR@", str(dt))
                    + f"io_directory {dt}\n", out=b, device="cpu")
    assert sys_.is_colloid and sys_.state[0].device.type == "cpu"
    (wj, vj), (wt, vt) = _colloid_log(a.getvalue()), _colloid_log(b.getvalue())
    assert wt == wj
    assert "[colloids]" in b.getvalue() and "Particle statistics:" in wt
    np.testing.assert_allclose(vt, vj, rtol=1e-9, atol=1e-11)
    if name == "calibration":
        def report(log):
            return log[log.index("Calibration result"):log.index("Timer")]
        assert report(b.getvalue()) == report(a.getvalue())
        assert "Number of measurements:              0" in b.getvalue()
    cds = sorted(p.name for p in dj.glob("config.cds0*"))
    assert cds == sorted(p.name for p in dt.glob("config.cds0*"))
    families = ("lc_colloids", "binary", "symmetric_lb", "electro")
    assert bool(cds) == (name in ("input_two", "from_file") + families)
    if name.startswith("lc_"):
        # the particles' surface row
        assert b.getvalue().count("f v f/v f_s a f_s/a") == 3
    if name in ("binary", "symmetric_lb"):
        assert b.getvalue().count("[phi]") == 3
        assert b.getvalue().count("[fe]") == 3
    if name == "electro":
        assert b.getvalue().count("[psi_zeta]") == 3
        assert b.getvalue().count("SOR solver converged") == 2
    for p in cds:
        if name not in families:
            assert (dj / p).read_bytes() == (dt / p).read_bytes()
            continue
        # the image-free remove/replace sums run in site order, the JAX
        # package's jnp.sum in XLA's; the reaction force and the walls'
        # account likewise: the records agree to a few hundred ulps of
        # their largest values
        from ludwig_tpu_torch.io.colloid_io import read_colloid_file
        recs = read_colloid_file(str(dt / p))
        for ra, rb in zip(recs, read_colloid_file(str(dj / p))):
            for key in ra:
                np.testing.assert_allclose(ra[key], rb[key], rtol=1e-13,
                                           atol=1e-15)
        if name == "electro":
            assert recs[0]["q0"] == 5.0 and recs[0]["deltaq0"] != 0.0


@pytest.mark.parametrize("line", [
    "free_energy symmetric_noise", "free_energy lc_droplet",
    "lb_bc_open on",
    "porous_media_init simple_cubic\nporous_media_acell 8",
    "N_LE_plane 2\nLE_plane_vel 0.01"])
def test_colloids_beside_unported_features_raise(line):
    """Colloids of the families without a colloid route (the JAX
    package's symmetric_noise branch drops them), beside the open
    boundary, porous media or Lees-Edwards planes raise
    NotImplementedError naming the key."""
    key = "colloid_init" if line.startswith("free_energy") else \
        line.split()[0]
    text = COLLOID_INPUTS["input_two"] + line + "\n"
    with pytest.raises(NotImplementedError, match=key):
        run_text(text, out=io.StringIO(), device="cpu")
