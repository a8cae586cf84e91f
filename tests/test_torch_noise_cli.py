"""The fluctuation keys through the port's input-file surface against
ludwig_tpu's, on the CPU.

The same input text runs through ludwig_tpu.ludwig.run_text and
ludwig_tpu_torch.ludwig.run_text(device="cpu"), float64: the blue phase
with `isothermal_fluctuations on` (its step draws no LB noise, its log
prints the kT statistics) and with `lc_noise 1` (the threefry Q noise,
the unfused route even under `tpu_fused on`); the plain fluid's two
resolved particles and the repository's 30 subgrid particles with the
LB's KISS stream (the subgrid ones with their Langevin kicks); the
electrolyte, whose step draws no LB noise, with `isothermal_fluctuations
on`; the Brazovskii fluid with the LB's KISS stream. The header (its
first line, the package's name, apart) is the same text, the statistics
lines the same words, their floats within rtol 1e-9 / atol 1e-11 (the
SOR residual, a convergence measure of the electrolyte's solver, apart:
tests/test_torch_cli.py holds it by its words only). `lc_noise on`, on
which the JAX package's log header fails, raises naming the key.  A
fluctuating colloid run restarts across the packages with its KISS
state."""

import io

import jax
import numpy as np
import pytest
import torch

from ludwig_tpu.ludwig import run_text as jrun_text
from ludwig_tpu_torch.io import read_state
from ludwig_tpu_torch.ludwig import _state_leaves, run_text
from test_ludwig_run import LC_FUSED_INPUT
from test_torch_cli import COLLOID_INPUTS, ELECTRO_INPUT
from test_torch_more_fe_cli import BRAZOVSKII, NUMBER

NZ = "temperature 0.00002\nisothermal_fluctuations on\n"
INPUTS = {
    "lc-isothermal": "tpu_fused off\n" + LC_FUSED_INPUT + NZ,
    "lc-noise": "tpu_fused on\n" + LC_FUSED_INPUT
    + "temperature 0.0001\nlc_noise 1\nrandom_seed 17\n",
    "colloids-input-two": COLLOID_INPUTS["input_two"] + NZ,
    "subgrid": COLLOID_INPUTS["subgrid"] + NZ,
    "electrolyte": ELECTRO_INPUT + "isothermal_fluctuations on\n",
}
TAGS = ("[rho]", "[phi]", "[fe", "[total", "[fluid", "[walls", "[minimum",
        "[maximum", "[eqipart", "[measd", "[psi]", "[elc]", "[Qxx", "[Qxy",
        "[Qxz", "[Qyy", "[Qyz", "[colloid", "[velocity", "[Velocity",
        "[max", "[min", "SOR residual")


def log_lines(log):
    """(header, words, floats): the header but its first line; each
    statistics line's words with its numbers blanked; their numbers
    (the SOR residual's apart)."""
    head = log[log.index("\n"):log.index("\nInitial conditions.")]
    words, vals = [], []
    body = log[log.index("\nInitial conditions."):log.index("\nTimer")]
    for line in body.splitlines():
        if line.startswith(TAGS):
            tag, _, rest = line.rpartition("]")
            words.append(" ".join((tag + _ + NUMBER.sub(" # ", rest))
                                  .split()))
            if not line.startswith("SOR residual"):
                vals += [float(v) for v in NUMBER.findall(rest)]
    return head, words, np.array(vals)


@pytest.mark.parametrize("name", list(INPUTS))
def test_noise_log_matches_jax(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)      # the colloids write config.cds here
    text = INPUTS[name]
    a, b = io.StringIO(), io.StringIO()
    jrun_text(text, out=a)
    sys_ = run_text(text, out=b, device="cpu")
    jlog, log = a.getvalue(), b.getvalue()
    (hj, wj, fj), (ht, wt, ft) = log_lines(jlog), log_lines(log)
    assert ht == hj
    assert wt == wj
    assert ft.size == fj.size > 0
    np.testing.assert_allclose(ft, fj, rtol=1e-9, atol=1e-11)
    assert log.rstrip().endswith("Ludwig finished normally.")
    kt = log.count("[measd/kT]")
    assert kt == jlog.count("[measd/kT]")
    assert kt == (0 if name == "lc-noise" else log.count("Completed cycle"))
    if name == "lc-noise":
        assert sys_.fused_mode is None and sys_.lc_cfg.noise_kt == 1e-4
        assert sys_.lc_cfg.noise_seed == 17
        assert "LC fluctuations:           =  on" in log
    if name == "subgrid":
        rngs = sys_.state[-1]
        assert rngs.device.type == "cpu" and rngs.shape == (30,)
    if name == "colloids-input-two":
        assert sys_.state.noise is not None


def test_brazovskii_noise_log_matches_jax():
    """Brazovskii draws the LB's KISS stream.  The JAX package's run loop
    takes its periodic run's velocity from the last leaf of the state,
    which with the noise on is the KISS state: its velocity [minimum] /
    [maximum] rows print those words (a fault of the reference, ROADMAP).
    The port prints the fluid's velocity there; every other line agrees."""
    text = BRAZOVSKII + NZ
    a, b = io.StringIO(), io.StringIO()
    jrun_text(text, out=a)
    run_text(text, out=b, device="cpu")
    (hj, wj, fj), (ht, wt, ft) = log_lines(a.getvalue()), log_lines(
        b.getvalue())
    assert ht == hj and wt == wj and ft.size == fj.size > 0
    rows = np.repeat([w.startswith(("[minimum", "[maximum")) for w in wt],
                     [w.count("#") for w in wt])
    assert rows.sum() > 0 and np.all(np.abs(fj[rows]) > 1e3)
    assert np.all(np.abs(ft[rows]) < 1.0)
    np.testing.assert_allclose(ft[~rows], fj[~rows], rtol=1e-9, atol=1e-11)
    assert b.getvalue().count("[measd/kT]") == 2


@pytest.mark.parametrize("value", ["on", "yes"])
def test_lc_noise_switch_word_raises(value):
    """The JAX package's header reads lc_noise as an integer and its run
    fails on a switch word; the port raises first, naming the key and the
    form it takes."""
    text = "tpu_fused off\n" + LC_FUSED_INPUT + f"lc_noise {value}\n"
    with pytest.raises(ValueError):
        jrun_text(text, out=io.StringIO())
    with pytest.raises(NotImplementedError, match=r"lc_noise.*0\|1"):
        run_text(text, out=io.StringIO(), device="cpu")


def test_noisy_colloid_restart_across_packages(tmp_path):
    """The KISS state of a fluctuating colloid run rides its checkpoint as
    state07, between M and the map, as in the JAX package's pytree: the
    port writes its step-1 checkpoint, ludwig_tpu.run_text restarts from
    it and writes step 3, from which the port restarts for step 4.  The
    KISS words after steps 3 and 4 are the port's straight run's, the
    other leaves within 2e-15 (test_torch_cli.test_restart_across_packages'
    colloid tolerance)."""
    base = COLLOID_INPUTS["input_two"] + NZ
    ds, dx = tmp_path / "straight", tmp_path / "shared"
    ds.mkdir(), dx.mkdir()
    straight = run_text(base + f"freq_config 3\nio_directory {ds}\n",
                        out=io.StringIO(), device="cpu")
    run_text(base.replace("N_cycles 4", "N_cycles 1")
             + f"config_at_end yes\nio_directory {dx}\n",
             out=io.StringIO(), device="cpu")
    jsys = jrun_text(base.replace("N_cycles 4", "N_cycles 2")
                     + f"N_start 1\nconfig_at_end yes\nio_directory {dx}\n",
                     out=io.StringIO())
    # f, R, V, W, dr, Rmap, M, the KISS state, then the map (pid, inside)
    names = ["dist"] + [f"state{i:02d}" for i in range(1, 10)]
    port3 = read_state(str(ds), 3, names)
    jleaves = jax.tree_util.tree_leaves(jsys.state)
    assert jleaves[7].dtype == np.uint32 and port3["state07"].shape == (
        4, 16, 16, 16)
    for i, (leaf, key) in enumerate(zip(jleaves[:8], names)):
        atol = 0 if i == 7 else 2e-15
        np.testing.assert_allclose(np.asarray(leaf), port3[key], rtol=0,
                                   atol=atol)
    rest = run_text(base.replace("N_cycles 4", "N_cycles 1")
                    + f"N_start 3\nio_directory {dx}\n", out=io.StringIO(),
                    device="cpu")
    assert rest.state.noise is not None
    assert torch.equal(rest.state.noise, straight.state.noise)
    for a, b in zip(_state_leaves(rest.state), _state_leaves(straight.state)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-15)
