"""The port's input-file surface against ludwig_tpu's, on the CPU.

The same input text runs through ludwig_tpu.ludwig.run_text and
ludwig_tpu_torch.ludwig.run_text; the statistics-block floats must agree
at rtol 1e-9 / atol 1e-11, the bound test_ludwig_run.py holds the fused
CLI path to (the port sums with plain reductions, the JAX package's jnp
path with compensated ones)."""

import io
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
from test_ludwig_run import (BINARY_FUSED_INPUT, DROPLET_FUSED_INPUT,
                             LC_FUSED_INPUT, PLAIN_FUSED_INPUT, PLAIN_INPUT,
                             _stat_floats)


def _logs(jax_text, port_text):
    a, b = io.StringIO(), io.StringIO()
    jrun_text(jax_text, out=a)
    sys_ = run_text(port_text, out=b, device="cpu")
    return a.getvalue(), b.getvalue(), sys_


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


@pytest.mark.parametrize("line", [
    "fd_advection_scheme_order 3", "fe_force_method phi_gradmu",
    "fd_gradient_calculation 3d_27pt_fluid", "hydrodynamics off",
    "phi_initialisation patches", "grad_mu 0.001_0_0",
    "viscosity_model arrhenius", "boundary_walls 0_0_1",
    # kT of the electrolyte under fe_electro only
    "temperature 0.001",
    # the binary fluid's noise is not ported (the plain fluid's is)
    "isothermal_fluctuations on"])
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


@pytest.mark.parametrize("line", [
    "lc_noise on", "lc_redshift_update on",
    "fd_gradient_calculation s7_anchoring", "electric_e0 0.0_0.0_0.01",
    "fd_advection_scheme_order 3", "hydrodynamics off",
    "lc_q_init_rectangle_min 1_1_1", "lc_anchoring_method two",
    "boundary_walls 1_0_0", "N_LE_plane 2", "isothermal_fluctuations on"])
def test_unported_lc_keys_raise(line):
    with pytest.raises(NotImplementedError, match=line.split()[0]):
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
    "fe_force_method relaxation_antisymmetric",
    "fd_gradient_calculation 3d_27pt_fluid", "fd_advection_scheme_order 3",
    "hydrodynamics off", "N_LE_plane 2", "boundary_walls 0_0_1",
    "porous_media_file capillary", "lc_noise on", "temperature 0.001",
    "lc_activity yes", "lb_fluctuations on"])
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
    "colloid_init input_one", "colloid_one_a0 2.3", "freq_psi 2",
    "psi_io_format BINARY",
    "isothermal_fluctuations on", "boundary_walls 0_0_1",
    "porous_media_file capillary"])
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
    "free_energy brazovskii", "free_energy fe_electro_symmetric",
    "lc_noise on",
    "lc_a0 0.01", "boundary_walls 1_0_0", "N_LE_plane 2",
    # temperature alone (no fluctuations) is read since the plain fluid's
    # noise is ported; a restart is not
    "N_start 10", "bogus_key_xyz 42", "periodicity 0_1_1"])
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
    droplet, the electrokinetic and the fluctuating plain input: all
    run, and neither JAX nor ludwig_tpu is imported."""
    inp, inp_binary = tmp_path / "input", tmp_path / "input_binary"
    inp_lc, inp_drop = tmp_path / "input_lc", tmp_path / "input_droplet"
    inp_elec = tmp_path / "input_electro"
    inp_elec.write_text(ELECTRO_INPUT)
    inp_noise = tmp_path / "input_noise"
    inp_noise.write_text("tpu_fused off\n" + PLAIN_INPUT + NOISE_KEYS)
    inp.write_text("tpu_fused on\n" + PLAIN_INPUT)
    inp_binary.write_text("tpu_fused on\n" + BINARY_FUSED_INPUT)
    inp_lc.write_text("tpu_fused on\n" + LC_FUSED_INPUT)
    inp_drop.write_text("tpu_fused on\n" + DROPLET_FUSED_INPUT)
    probe = textwrap.dedent(f"""
        import runpy, sys
        for path in ({str(inp)!r}, {str(inp_binary)!r}, {str(inp_lc)!r},
                     {str(inp_drop)!r}, {str(inp_elec)!r},
                     {str(inp_noise)!r}):
            sys.argv = ["ludwig_tpu_torch", path, "--device", "cpu"]
            runpy.run_module("ludwig_tpu_torch", run_name="__main__")
        import ludwig_tpu_torch.ops._cuda, ludwig_tpu_torch.convert
        import ludwig_tpu_torch.ops.fused_electro
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
    assert res.stdout.count("[Qyz]") == 3 + 3   # LC and droplet runs
    assert res.stdout.count("[elc]") == 3 and "[walls   ]" in res.stdout
    assert res.stdout.count("[measd/kT]") == 1     # the noise input
    assert "NO_JAX_OK" in res.stdout


# isothermal fluctuations of the plain fluid (tests/test_ludwig_run.py:
# 423-435)
NOISE_KEYS = """
temperature 0.00002
isothermal_fluctuations on
random_seed 8361235
"""
KT_TAGS = ("[eqipart.]", "[measd/kT]")


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
    (ELECTRO_INPUT, True)], ids=[
        "plain-off", "plain-interpret", "plain-on-f64", "plain-on-f32",
        "plain-no-plan", "binary-z16", "binary-interpret", "electro"])
def test_statistics_follow_the_jax_route_rule(text, reference):
    """Reference statistics wherever ludwig_tpu's build_system leaves
    fused_mode None for the same input."""
    from ludwig_tpu import ludwig as jl
    from ludwig_tpu.runtime import RunTime as JRunTime
    from ludwig_tpu_torch import ludwig as tl
    from ludwig_tpu_torch.runtime import RunTime

    tsys = tl.build_system(RunTime(text), device="cpu")
    assert tl.reference_statistics(tsys) == reference
    assert (jl.build_system(JRunTime(text)).fused_mode is None) == reference
