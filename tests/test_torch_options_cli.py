"""The droplet's and the electrolyte's boundary options through the port's
CLI against ludwig_tpu's, on the CPU.

The droplet between walls with `fe_force_method relaxation_antisymmetric`
(with a checkpoint the JAX package restarts from), the droplet in porous
media with the 27-point stencil and order-3 advection, and the float64
Gouy-Chapman electrolyte in porous media and between walls: the
statistics floats within rtol 1e-9 / atol 1e-11, as tests/
test_torch_cli.py holds them.  Each JAX run costs its XLA compiles, so the
other stencils and orders are held in tests/test_torch_droplet_options.py
and only routed here."""

import io
import os
import re

import numpy as np
import pytest

from ludwig_tpu.ludwig import run_text as jrun_text
from ludwig_tpu_torch.ludwig import _state_leaves, run_text
from test_ludwig_run import DROPLET_FUSED_INPUT, _stat_floats
from test_torch_cli import ELECTRO_INPUT, _electro_floats, _logs, _steps

DROPLET_WALLS = (DROPLET_FUSED_INPUT + "boundary_walls 0_0_1\n"
                 "fe_force_method relaxation_antisymmetric\n")
DROPLET_POROUS = (DROPLET_FUSED_INPUT
                  .replace("3d_7pt_fluid", "3d_27pt_fluid")
                  .replace("fd_advection_scheme_order 1",
                           "fd_advection_scheme_order 3")
                  + "porous_media_init simple_cubic\nporous_media_acell 4\n")
ELECTRO_OPTIONS = {
    "porous": (ELECTRO_INPUT.replace("size 16_4_4", "size 16_8_8")
               + "porous_media_init simple_cubic\nporous_media_acell 4\n"),
    "walls": ELECTRO_INPUT + "boundary_walls 0_1_0\n"}


def test_droplet_walls_relaxation_cli_and_restart_match_jax(tmp_path):
    """The droplet between walls on z with the relaxation force, tpu_fused
    on (the gate sends it to the unfused step with the solid): the [phi],
    [Q..], [fed] and velocity rows over the fluid sites match the JAX
    package's.  Then the port's step-2 checkpoint restarts the JAX
    package, whose steps 3-4 match the port's straight run, and restarts
    the port, whose state is its straight run's bitwise."""
    text = "tpu_fused on\n" + DROPLET_WALLS
    jlog, log, sys_ = _logs(text, text)
    assert sys_.fused_mode is None and sys_.solid is not None
    assert int(sys_.solid.sum()) == 2 * 8 * 8
    for tag in ("[phi]", "[Qxx]", "[fed]", "[total", "[fluid"):
        assert log.count(tag) == jlog.count(tag) == 3
    a, b = _stat_floats(jlog), _stat_floats(log)
    assert a.size == b.size and a.size > 0
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11)

    d = tmp_path
    steps = DROPLET_WALLS.replace("freq_statistics 2", "freq_statistics 1")
    half = steps.replace("N_cycles 4", "N_cycles 2")
    out = io.StringIO()
    straight = run_text(steps, out=out, device="cpu")
    run_text(half + f"config_at_end yes\nio_directory {d}\n",
             out=io.StringIO(), device="cpu")
    # (f, phi, q5, u) named as the JAX package names a droplet's leaves
    assert {"dist-00000002", "vel-00000002", "state02-00000002",
            "state03-00000002"} <= set(os.listdir(d))
    jout = io.StringIO()
    jrun_text(half + f"N_start 2\nio_directory {d}\n", out=jout)
    np.testing.assert_allclose(
        _steps(jout.getvalue(), "Starting time step loop.", 4),
        _steps(out.getvalue(), "Completed cycle 2\n", 4), rtol=1e-9,
        atol=1e-11)
    rest = run_text(half + f"N_start 2\nio_directory {d}\n",
                    out=io.StringIO(), device="cpu")
    for x, y in zip(_state_leaves(rest.state), _state_leaves(straight.state)):
        assert x.equal(y)


def test_droplet_porous_27pt_order3_cli_matches_jax():
    """The droplet in a simple-cubic porous medium with the 27-point
    stencil and order-3 advection: every statistics float over the fluid
    sites."""
    jlog, log, sys_ = _logs(DROPLET_POROUS, DROPLET_POROUS)
    assert sys_.droplet_cfg.gradient == "3d_27pt_fluid"
    assert sys_.droplet_cfg.advection_order == 3
    assert "Completed cycle 4" in log
    a, b = _stat_floats(jlog), _stat_floats(log)
    assert a.size == b.size and a.size > 0
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("name", list(ELECTRO_OPTIONS))
def test_electro_options_cli_match_jax(name):
    """The f64 Gouy-Chapman electrolyte (the reference route) with porous
    media or walls on y joined with its charged walls: the counter-charge
    over the union's fluid, every statistics float (the [walls] row the
    momentum the union's links take) as tests/test_torch_cli.py holds the
    plain input, the SOR reports equal."""
    text = ELECTRO_OPTIONS[name]
    jlog, log, sys_ = _logs(text, text)
    assert sys_.is_electro and "Completed cycle 6" in log
    x = sys_.lb_cfg.size[0]
    assert int(sys_.solid.sum()) > 2 * sys_.solid[0].numel()
    assert bool(sys_.solid[0].all() and sys_.solid[x - 1].all())
    for tag in ("[psi]", "[elc]", "[walls   ]", "[fed]"):
        assert log.count(tag) == jlog.count(tag) == 3
    a, loose = _electro_floats(jlog)
    b, _ = _electro_floats(log)
    assert a.size == b.size and a.size > 0
    np.testing.assert_allclose(b[~loose], a[~loose], rtol=1e-9, atol=1e-11)
    scale = sys_.solid.numel() * max(abs(v) for v in a)
    np.testing.assert_allclose(b[loose], a[loose], rtol=0,
                               atol=1e-12 * scale)
    sor = (r"SOR solver converged to (\w+) tolerance\n"
           r"SOR residual\s+\S+ at (\d+) iterations")
    assert re.findall(sor, log) == re.findall(sor, jlog)


@pytest.mark.parametrize("line", [
    "fd_gradient_calculation 2d_5pt_fluid", "fd_gradient_calculation dm3q27",
    "fd_gradient_calculation 2d_tomita_fluid",
    "fd_advection_scheme_order 4", "fd_advection_scheme_order 5",
    "porous_media_init simple_cubic\nporous_media_acell 4"])
def test_droplet_options_take_the_unfused_route(line):
    """Under `tpu_fused on` every option the JAX package's fused gate
    refuses runs the unfused step (its parity with the JAX step:
    tests/test_torch_droplet_options.py)."""
    text = "tpu_fused on\n" + DROPLET_FUSED_INPUT + line + "\n"
    sys_ = run_text(text.replace("N_cycles 4", "N_cycles 1"),
                    out=io.StringIO(), device="cpu")
    assert sys_.fused_mode is None
    assert all(bool(v.isfinite().all()) for v in sys_.state)


@pytest.mark.parametrize("line", ["boundary_walls 1_0_0",
                                  "porous_media_init simple_cubic\n"
                                  "porous_media_acell 4"])
def test_droplet_planes_beside_solids_raise_as_jax(line):
    """Lees-Edwards planes beside walls or porous media: ValueError in both
    packages, the port's naming the key."""
    text = (DROPLET_FUSED_INPUT.replace("size 8_8_16", "size 16_8_16")
            + "N_LE_plane 2\nLE_plane_vel 0.04\n" + line + "\n")
    with pytest.raises(ValueError, match="Lees-Edwards"):
        jrun_text(text, out=io.StringIO())
    with pytest.raises(ValueError, match=line.split()[0]):
        run_text(text, out=io.StringIO(), device="cpu")
