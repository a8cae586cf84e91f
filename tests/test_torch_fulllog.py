"""The port's reference log (ludwig_tpu_torch/fulllog.py and its wiring
in run_text) against ludwig_tpu's, on the CPU in float64.

One input per family builds both packages' systems and writes each
package's input header (InitLog.emit) without stepping: the text is the
same but for the welcome line, which names the package.  Three inputs
run whole through both run_text functions (2 cycles): after fpdiff's
filter the logs are equal as text, every float token within rtol 1e-9
(absolute 1e-12 for the roundoff zeros of a momentum total).  The input
check: a key the JAX package reads only for its log, or no code at all,
runs and is reported at the end of the log as the JAX package reports it;
a key the JAX package honours and the port does not is refused by name.
The port's set of the JAX package's keys is held against the keys its
modules read, from their source text."""

import glob
import io
import re
from pathlib import Path

import numpy as np
import pytest

from ludwig_tpu.fulllog import InitLog as JInitLog
from ludwig_tpu.ludwig import build_system as jbuild_system
from ludwig_tpu.ludwig import run_text as jrun_text
from ludwig_tpu.runtime import RunTime as JRunTime
from ludwig_tpu_torch import ludwig as tl
from ludwig_tpu_torch.fulllog import InitLog
from ludwig_tpu_torch.runtime import RunTime
from ludwig_tpu_torch.utils import fpdiff
from test_ludwig_run import (BINARY_FUSED_INPUT, DROPLET_FUSED_INPUT,
                             LC_FUSED_INPUT, LE_FUSED_INPUT,
                             PLAIN_FUSED_INPUT, WALL_FUSED_INPUT)
from test_torch_cli import COLLOID_INPUTS, ELECTRO_INPUT, POROUS_INPUT
from test_torch_more_fe_cli import INPUTS as MORE_FE

ROOT = Path(__file__).resolve().parents[1]


def _cycles(text, n):
    text = re.sub(r"(N_cycles|freq_statistics) \d+\n", "", text)
    return text + f"N_cycles {n}\nfreq_statistics 1\n"


# the two-dimensional fluid: a Kelvin-Helmholtz shear layer on D2Q9
KH_INPUT = """
size 16_16_1
lb_nvel 9
viscosity 0.1
free_energy none
distribution_initialisation 2d_kelvin_helmholtz
2d_kelvin_helmholtz_u0 0.04
2d_kelvin_helmholtz_delta 0.05
2d_kelvin_helmholtz_kappa 80.0
N_cycles 2
freq_statistics 1
"""

FAMILY_INPUTS = {
    "none": PLAIN_FUSED_INPUT,
    "none-walls": WALL_FUSED_INPUT,
    "none-le": LE_FUSED_INPUT,
    "none-porous": POROUS_INPUT,
    "none-colloids": COLLOID_INPUTS["input_two"],
    "symmetric": BINARY_FUSED_INPUT,
    "symmetric_lb": MORE_FE["symmetric_lb"],
    "lc_blue_phase": LC_FUSED_INPUT,
    "lc_droplet": DROPLET_FUSED_INPUT,
    "fe_electro": ELECTRO_INPUT,
    "fe_electro_symmetric": MORE_FE["fe_electro_symmetric"],
    "brazovskii": MORE_FE["brazovskii"],
    "surfactant": MORE_FE["surfactant"],
    "ternary": MORE_FE["ternary_double_emulsion"],
    "polar_active": MORE_FE["polar_active"],
    "d2q9": KH_INPUT,
}


def _headers(text):
    """(JAX header, port header), each without its welcome line."""
    out = []
    for rt_cls, build, log_cls, kw in (
            (JRunTime, jbuild_system, JInitLog, {}),
            (RunTime, tl.build_system, InitLog, {"device": "cpu"})):
        rt = rt_cls(text)
        sys_ = build(rt, **kw)
        sys_.hydro_on = rt.switch("hydrodynamics", True)
        buf = io.StringIO()
        log_cls(rt, sys_, buf).emit()
        lines = buf.getvalue().splitlines()
        assert lines[0].startswith("Welcome to Ludwig")
        out.append(lines[1:])
    return out


@pytest.mark.parametrize("name", sorted(FAMILY_INPUTS))
def test_init_header_matches_jax(name):
    jhdr, hdr = _headers(FAMILY_INPUTS[name])
    assert hdr == jhdr
    assert hdr[-1] == "Initial conditions."


def _floats_close(a_lines, b_lines):
    assert len(a_lines) == len(b_lines)
    for la, lb in zip(a_lines, b_lines):
        ta, tb = fpdiff._tokens(la), fpdiff._tokens(lb)
        assert len(ta) == len(tb), (la, lb)
        for x, y in zip(ta, tb):
            if fpdiff._is_float(x) and fpdiff._is_float(y):
                assert abs(float(x) - float(y)) <= (
                    1e-9 * abs(float(x)) + fpdiff.TOLERANCE), (la, lb)
            else:
                assert x == y, (la, lb)


WHOLE_LOGS = {
    "plain-off": ("tpu_fused off\n" + PLAIN_FUSED_INPUT,) * 2,
    "binary": (BINARY_FUSED_INPUT,) * 2,
    # the port's `on` is the JAX package's `interpret` on the CPU
    "d2q9-fused": ("tpu_fused interpret\n" + KH_INPUT,
                   "tpu_fused on\n" + KH_INPUT),
}


@pytest.mark.parametrize("name", sorted(WHOLE_LOGS))
def test_whole_log_matches_jax(name):
    jtext, text = (_cycles(t, 2) for t in WHOLE_LOGS[name])
    a, b = io.StringIO(), io.StringIO()
    jrun_text(jtext, out=a)
    sys_ = tl.run_text(text, out=b, device="cpu")
    if name == "d2q9-fused":
        assert sys_.fused_mode == "plain" and sys_.lb_cfg.nvel == 9
    jlog, log = a.getvalue(), b.getvalue()
    assert len(log.splitlines()) == len(jlog.splitlines())
    assert log.rstrip().endswith("Ludwig finished normally.")
    _floats_close(fpdiff.filter_lines(jlog), fpdiff.filter_lines(log))


def test_plain_log_has_the_jax_line_count():
    """PLAIN_FUSED_INPUT under `tpu_fused off`: 100 lines in both."""
    text = "tpu_fused off\n" + PLAIN_FUSED_INPUT
    a, b = io.StringIO(), io.StringIO()
    jrun_text(text, out=a)
    tl.run_text(text, out=b, device="cpu")
    assert len(b.getvalue().splitlines()) == len(a.getvalue().splitlines())
    assert "Timer resolution: 1e-09 second" in b.getvalue()


UNREAD = {"log-only": "lb_halo_scheme lb_halo_target",
          "typo": "my_typo_key 3",
          "both": "reduced_halo no\nmy_typo_key 3"}


@pytest.mark.parametrize("name", sorted(UNREAD))
def test_unread_keys_warn_as_jax(name):
    """A key the JAX package reads only for its header, or nothing reads,
    runs and ends the log with the JAX package's warning lines."""
    text = _cycles(PLAIN_FUSED_INPUT, 1) + UNREAD[name] + "\n"
    a, b = io.StringIO(), io.StringIO()
    jrun_text(text, out=a)
    tl.run_text(text, out=b, device="cpu")

    def tail(log):
        return log[log.index("Timer statistics"):].splitlines()[-4:]
    jt, t = tail(a.getvalue()), tail(b.getvalue())
    assert [ln for ln in t if "(probe)" not in ln and "call" not in ln] == [
        ln for ln in jt if "(probe)" not in ln and "call" not in ln]
    if "my_typo_key" in UNREAD[name]:
        line = text.splitlines().index("my_typo_key 3") + 1
        assert "Warning: key/value present in input but not used:\n" in (
            b.getvalue())
        assert f"(Line {line}): my_typo_key\n" in b.getvalue()
    else:
        assert "Warning" not in b.getvalue()
    assert b.getvalue().rstrip().endswith("Ludwig finished normally.")


@pytest.mark.parametrize("line", ["lc_noise on", "tpu_shard on",
                                  "electric_e0 0.01_0_0"])
def test_honoured_keys_still_refused(line):
    text = ("tpu_fused on\n" + LC_FUSED_INPUT if line.startswith("lc_")
            else PLAIN_FUSED_INPUT)
    with pytest.raises(NotImplementedError, match=line.split()[0]):
        tl.run_text(text + line + "\n", out=io.StringIO(), device="cpu")


_READ = re.compile(r"\brt\.(?:string|int|double|switch|int_vector|"
                   r"double_vector|double_required|int_required|required|"
                   r"has_key)\(\s*(f?)(\"[^\"]*\"|'[^']*')")


def test_jax_key_set_matches_the_jax_source():
    """JAX_KEYS with the colloid prefixes and the I/O grid suffix against
    the keys ludwig_tpu/**/*.py reads through rt.* (fulllog.py apart),
    from the source text; a computed key must fall under a prefix or the
    suffix."""
    keys, computed = set(), set()
    for path in sorted(glob.glob(str(ROOT / "ludwig_tpu" / "**" / "*.py"),
                                 recursive=True)):
        if path.endswith("fulllog.py"):
            continue
        for m in _READ.finditer(Path(path).read_text()):
            key = m.group(2)[1:-1]
            if key.startswith("_"):
                continue        # the golden harness's hint keys
            (computed if m.group(1) or "{" in key else keys).add(key)
    plain = {k for k in keys if not k.startswith(tl.COLLOID_PREFIXES)}
    assert plain == set(tl.JAX_KEYS)
    assert all(tl._jax_reads(k) for k in keys)
    assert computed
    for key in computed:
        probe = re.sub(r"\{[^}]*\}", "one", key)
        assert probe.startswith(tl.COLLOID_PREFIXES) or probe.endswith(
            "_io_grid"), key
    assert not tl._jax_reads("lb_halo_scheme")
    assert not tl._jax_reads("my_typo_key")


SIGMA_INPUT = BINARY_FUSED_INPUT.replace("size 8_8_16", "size 16_16_16") + (
    "calibration_sigma on\nfreq_measure 2\n")
OPTION_LOGS = {
    # the surface-tension calibration on the unfused and fused routes
    "sigma-off": ("tpu_fused off\n" + SIGMA_INPUT,) * 2,
    "sigma-fused": ("tpu_fused interpret\n" + SIGMA_INPUT,
                    "tpu_fused on\n" + SIGMA_INPUT),
    "vol-flux": ("tpu_fused off\nstats_vel_print_vol_flux yes\n"
                 + PLAIN_FUSED_INPUT,) * 2,
}


@pytest.mark.parametrize("name", sorted(OPTION_LOGS))
def test_option_logs_match_jax(name):
    """calibration_sigma with freq_measure (its banner in the header, the
    [sigma] rows) and stats_vel_print_vol_flux ([vol flux] rows): the
    whole filtered log as test_whole_log_matches_jax holds it."""
    jtext, text = (_cycles(t, 2) for t in OPTION_LOGS[name])
    a, b = io.StringIO(), io.StringIO()
    jrun_text(jtext, out=a)
    sys_ = tl.run_text(text, out=b, device="cpu")
    jlog, log = a.getvalue(), b.getvalue()
    tag = "[vol flux]" if name == "vol-flux" else "[sigma]"
    assert log.count(tag) == jlog.count(tag) > 0
    if name.startswith("sigma"):
        assert sys_.fused_mode == ("binary" if name == "sigma-fused"
                                   else None)
        assert "Surface tension calibration via droplet" in log
    _floats_close(fpdiff.filter_lines(jlog), fpdiff.filter_lines(log))


# the probe rows of each route (ludwig_tpu/ludwig.py:3546-3616; the JAX
# package's "Pad refresh" has no counterpart: the port keeps no pads).
# Its binary kernel probe needs a TPU (it does not pass interpret), so
# the fused binary route's rows are held to the names alone.
DETAIL = {"plain-fused": ("tpu_fused interpret\n" + PLAIN_FUSED_INPUT,
                          "tpu_fused on\n" + PLAIN_FUSED_INPUT,
                          ["Collide+stream"]),
          "binary-fused": (None, "tpu_fused on\n" + BINARY_FUSED_INPUT,
                           ["Phi+force kernel", "Full step"]),
          "plain-off": ("tpu_fused off\n" + PLAIN_FUSED_INPUT,
                        "tpu_fused off\n" + PLAIN_FUSED_INPUT,
                        ["Full step"])}


@pytest.mark.parametrize("name", sorted(DETAIL))
def test_timer_detail_rows_as_jax(name):
    """tpu_timer_detail: the probe rows after the timer table carry the
    JAX package's names for the route; each time is a positive number."""
    jtext, text, want = DETAIL[name]

    def rows(text, run, **kw):
        buf = io.StringIO()
        run(_cycles(text, 1) + "tpu_timer_detail on\n", out=buf, **kw)
        log = buf.getvalue()
        return log, [(ln.split(":")[0].strip(), float(ln.split()[-2]))
                     for ln in log.splitlines() if ln.endswith("(probe)")]
    log, trows = rows(text, tl.run_text, device="cpu")
    assert [n for n, _ in trows] == want
    assert all(t > 0.0 for _, t in trows)
    assert log.rstrip().endswith("Ludwig finished normally.")
    if jtext is not None:
        _jlog, jrows = rows(jtext, jrun_text)
        assert [n for n, _ in jrows if n != "Pad refresh"] == want
