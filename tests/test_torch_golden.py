"""The port's golden-log harness (ludwig_tpu_torch/utils/fpdiff.py,
utils/golden.py) against ludwig_tpu's, on the CPU.

fpdiff's filter, statistics subset, token and line comparisons and its
LCS diff, and golden's waivers and hint sniffing, are held to the JAX
package's on synthetic log text.  Then run_case and check_case run a
temporary suite - an input and the log the JAX package's run_text writes
for it, REF_DIRS pointed at it - and report parity; and the harness's
hint keys of older log vintages change both packages' logs alike.  No
reference tree is needed."""

import io

import pytest

import ludwig_tpu.ludwig as jludwig
from ludwig_tpu.ludwig import run_text as jrun_text
from ludwig_tpu.utils import fpdiff as jfp
from ludwig_tpu.utils import golden as jgolden
import ludwig_tpu_torch.ludwig as tludwig
from ludwig_tpu_torch.utils import fpdiff, golden
from test_ludwig_run import (BINARY_FUSED_INPUT, LC_FUSED_INPUT,
                             PLAIN_FUSED_INPUT)

REF_LOG = """Welcome to Ludwig v0.7.32 (Serial version running on 1 process)

Git commit: 1234abcd
Read 12 user parameters from serial-test.inp

System details
--------------
System size:    8 8 16
Decomposition:  2 1 1
Halo type:      lb_halo_target (full halo)
Force calculation:      phi_gradmu method
Relative tolerance:  1.0000000e-08
Absolute tolerance:  1.0000000e-15
Max. no. of iterations:  10000
Solver type:     sor
colloid_io_read: reading from single file config.cds.init.001-001
Anchoring method: two

Initial conditions.
[rho]  1.0240000e+03  1.0000000e+00 2.2204460e-16  1.0000000e+00  1.0000000e+00
[Qxx] -1.0000000e-02  1.2000000e-03 4.0000000e-04 -2.0000000e-02  2.0000000e-02
[fed]             0  1.0000000e-04  1.0000000e-04

Starting time step loop.
[rho]  1.0240000e+03  1.0000000e+00 2.2204460e-16  1.0000000e+00  1.0000000e+00
[total   ]  1.0000000e-14-2.0000000e-14  0.0000000e+00
[fluid   ]  1.0000000e-14 -2.0000000e-14  0.0000000e+00
Writing distribution output at step 2!
Completed cycle 2

Timer statistics
             Section:       tmin       tmax      total
               Total:      1.000      1.000      1.000   1.000000 (1 call)
Warning: key/value present in input but not used:
(Line 3): reduced_halo
(Line 9): vel_format
Ludwig finished normally.
"""
OUT_LOG = (REF_LOG.replace("1.0000000e-14-2.0000000e-14",
                           "1.0000000e-14 -2.0000000e-14")
           .replace("1.2000000e-03", "1.2000000000005e-03")
           .replace("2.0000000e-02  2.0000000e-02",
                    "2.0000000e-02  2.0000001e-02")
           .replace("Git commit: 1234abcd", "Git commit: 5678ef01")
           .replace("Halo type:      lb_halo_target (full halo)",
                    "Halo type:      full"))


def test_fpdiff_filters_as_jax():
    for text in (REF_LOG, OUT_LOG, "d2q9 R\nd3q19 R x\n\n  \nTimer x\n"):
        assert fpdiff.filter_lines(text) == jfp.filter_lines(text)
        assert fpdiff.stats_lines(text) == jfp.stats_lines(text)
    assert "Welcome" not in "".join(fpdiff.filter_lines(REF_LOG))


@pytest.mark.parametrize("pair", [
    ("[total   ]  1.0e-14-2.0e-14", "[total   ]  1.0e-14 -2.0e-14"),
    ("[rho] 1.0 2.0", "[rho] 1.0 2.0000000000001"),
    ("[rho] 1.0 2.0", "[rho] 1.0 2.1"), ("a b", "a c"), ("a", "a b")])
def test_fpdiff_tokens_and_lines_as_jax(pair):
    a, b = pair
    assert fpdiff._tokens(a) == jfp._tokens(a)
    for tol in (fpdiff.TOLERANCE, 0.2):
        assert fpdiff.lines_equal(a, b, tol) == jfp.lines_equal(a, b, tol)


@pytest.mark.parametrize("mode", ["stats", "full"])
def test_fpdiff_compare_as_jax(mode):
    ref, out = REF_LOG, OUT_LOG
    assert fpdiff.compare_logs(ref, out, mode) == jfp.compare_logs(
        ref, out, mode)
    a, b = jfp.filter_lines(ref), jfp.filter_lines(out)
    assert fpdiff.fp_diff(a, b) == jfp.fp_diff(a, b)
    assert fpdiff.fp_diff(a, a) == [] == jfp.fp_diff(a, a)
    assert fpdiff.fp_diff(a, b[:-3] + ["extra"]) == jfp.fp_diff(
        a, b[:-3] + ["extra"])


@pytest.mark.parametrize("name", ["d3q19-elec/serial-elec-ep2",
                                  "d3q19/long64-chol-bp2",
                                  "d3q19-elec/serial-elec-do1", "no-case"])
def test_waivers_as_jax(name):
    diffs = ["12 < [psi]  1.0e-11  0.0  0.0",
             "12 > [psi]  5.0e-11  0.0  0.0",
             "20 < [total   ]  1.0e-12  0.0  0.0",
             "20 > [total   ]  2.0e-12  0.0  0.0",
             "30 < SOR residual per site 1.0e-9 at 10 iterations",
             "30 > SOR residual per site 2.0e-9 at 12 iterations",
             "40 < [phi] -4.0156293e-04 1.0",
             "40 > [phi] -4.0156291e-04 1.0"]
    for k in range(0, len(diffs) + 1, 2):
        part = diffs[:k]
        assert (golden.waive_irreproducible(name, part)
                == jgolden.waive_irreproducible(name, part))


def _suite(tmp_path, name, inp, log):
    suite = tmp_path / "suites" / "d3q19-short"
    suite.mkdir(parents=True, exist_ok=True)
    (suite / f"{name}.inp").write_text(inp)
    (suite / f"{name}.log").write_text(log)
    return (str(suite),)


def test_hint_sniffing_as_jax(tmp_path, monkeypatch):
    """The text each harness hands its run_text: the input with the hint
    lines sniffed from the committed log (vintage, decomposition, labels,
    tolerances, the unused-key block, ...)."""
    inp = "N_cycles 2\nsize 8_8_16\nfree_energy lc_blue_phase\nlc_a0 0.01\n"
    dirs = _suite(tmp_path, "serial-test", inp, REF_LOG)
    monkeypatch.setattr(jgolden, "REF_DIRS", dirs)
    monkeypatch.setattr(golden, "REF_DIRS", dirs)
    seen = {}

    def fake(key):
        def run(text, out=None, **kw):
            seen[key] = text
            return None
        return run
    monkeypatch.setattr(jludwig, "run_text", fake("jax"))
    monkeypatch.setattr(tludwig, "run_text", fake("port"))
    jgolden.run_case("serial-test", workdir=str(tmp_path), strict_fp=False)
    golden.run_case("serial-test", workdir=str(tmp_path), device="cpu")
    assert seen["port"] == seen["jax"]
    for hint in ("_log_vintage 7", "_mpi_grid 2_1_1", "_q_labels q",
                 "_fed_block 1", "_halo_label lb_halo_target (full halo)",
                 "_psi_solver_line 1", "_unused_keys reduced_halo,vel_format",
                 "_has_finish 1", "_cfg_end_style inloop",
                 "_inp_name serial-test.inp", "_lc_anchor_fmt two"):
        assert f"\n{hint}\n" in seen["port"], hint


@pytest.mark.parametrize("name,text", [
    ("serial-plain", "tpu_fused off\n" + PLAIN_FUSED_INPUT),
    ("serial-binary", BINARY_FUSED_INPUT)], ids=["plain", "binary"])
def test_run_case_reports_parity(tmp_path, monkeypatch, name, text):
    """A suite of one case whose committed log is the JAX package's:
    the port's check_case finds parity in the statistics and in the
    whole filtered log."""
    buf = io.StringIO()
    jrun_text(text, out=buf)
    monkeypatch.setattr(golden, "REF_DIRS",
                        _suite(tmp_path, name, text, buf.getvalue()))
    work = tmp_path / "work"
    work.mkdir()
    for mode in ("stats", "full"):
        ok, diffs, log = golden.check_case(name, mode=mode,
                                           workdir=str(work), device="cpu")
        assert ok and diffs == [], diffs[:6]
    assert log.rstrip().endswith("Ludwig finished normally.")
    with pytest.raises(FileNotFoundError):
        golden.find_case("no-such-case")


HINTS = {
    # the plain rank-ordered sums of logs before v0.12
    "old-stats": ("tpu_fused off\n" + PLAIN_FUSED_INPUT,
                  "_log_vintage 11\n_mpi_grid 2_2_1\n"),
    # no free energy at t = 0; config_at_end after the loop
    "t0-fe-cfg-after": (BINARY_FUSED_INPUT.replace("N_cycles 4",
                                                   "N_cycles 2"),
                        "_t0_fe 0\n_cfg_end_style after\n"
                        "config_at_end yes\n"),
    # the per-site SOR residual of the logs up to v0.7
    "sor-per-site": (None, "_log_vintage 7\n"),
    # the Q rows labelled [phi], the generic density block
    "lc-labels": ("tpu_fused off\n" + LC_FUSED_INPUT.replace(
        "N_cycles 4", "N_cycles 2"), "_q_labels phi\n_fed_block 1\n"),
}


@pytest.mark.parametrize("name", sorted(HINTS))
def test_hint_keys_as_jax(tmp_path, name):
    """The harness's hint keys change the log where the JAX package's
    reading of them does: both packages' whole filtered logs agree."""
    from test_torch_cli import ELECTRO_INPUT
    text, hints = HINTS[name]
    if text is None:
        text = (ELECTRO_INPUT.replace("N_cycles 6", "N_cycles 2")
                .replace("freq_statistics 3", "freq_statistics 1"))
    text = text + hints + f"io_directory {tmp_path}\n"
    a, b = io.StringIO(), io.StringIO()
    jrun_text(text, out=a)
    tludwig.run_text(text, out=b, device="cpu")
    jlog, log = a.getvalue(), b.getvalue()
    ok, diffs = fpdiff.compare_logs(jlog, log, mode="full")
    assert ok, diffs[:6]
    if name == "sor-per-site":
        assert "SOR residual per site" in log
    if name == "lc-labels":
        assert "[Qxx]" not in log and log.count("[fed]") == 2
    if name == "t0-fe-cfg-after":
        assert log.count("[fed]") == jlog.count("[fed]") == 1
        assert "Writing phi file at step 2!" in log
