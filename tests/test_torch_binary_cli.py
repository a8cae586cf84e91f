"""The binary fluid's boundary and option inputs through the port's
run_text against ludwig_tpu's log, on the CPU.

Each input (halo walls 0_0_1 with the 27-point wetting stencil and 1_1_0,
porous media from a status_with_c_h map file, the open x boundary beside
walls, the phi-grad-mu force with grad_mu, the Arrhenius viscosity,
`hydrodynamics off` with order-4 advection, the KISS noise of
symmetric_noise with the LB's fluctuations, alone and beside porous
media, Lees-Edwards planes with 27-point gradients, 2-D inputs with the
Tomita stencil and with the 5-point one between walls) runs through
both packages in float64; every statistics float - [rho], [phi], [fe]
and [fed], the momentum rows with [walls], the velocity rows and the
isothermal-fluctuation rows - agrees at rtol 1e-9 / atol 1e-11, and the
lines' words (the free-energy headers among them) are the same."""

import io
import re

import numpy as np
import pytest

from ludwig_tpu.ludwig import run_text as jrun_text
from ludwig_tpu_torch.io.map_file import write_map
from ludwig_tpu_torch.ludwig import run_text
from test_ludwig_run import BINARY_FUSED_INPUT

B = BINARY_FUSED_INPUT
S27 = B.replace("3d_7pt_fluid", "3d_27pt_solid")
INPUTS = {
    "walls_0_0_1": S27 + "boundary_walls 0_0_1\n",
    "walls_1_1_0": B + "boundary_walls 1_1_0\n",
    "porous_c_h": S27 + "porous_media_file @DIR@/capillary\n"
                        "porous_media_type status_with_c_h\n",
    "open_x_walls": B + "boundary_walls 0_1_1\nlb_bc_open 1\n"
                        "lb_bc_inflow_rhou_u0 0.001_0_0\n"
                        "phi_bc_inflow_fixed_phib -0.5\n",
    "phi_gradmu_grad_mu": B + "fe_force_method phi_gradmu\n"
                              "grad_mu 0.0001_0_-0.0002\n",
    "arrhenius": B + "viscosity_model arrhenius\n"
                     "viscosity_arrhenius_eta_minus 0.01\n"
                     "viscosity_arrhenius_eta_plus 0.004\n"
                     "viscosity_arrhenius_phistar 0.9\n",
    "hydrodynamics_off": B.replace("fd_advection_scheme_order 2",
                                   "fd_advection_scheme_order 4")
    + "hydrodynamics off\n",
    "kiss_noise": B.replace("free_energy symmetric",
                            "free_energy symmetric_noise")
    + "temperature 0.00002\nisothermal_fluctuations on\n"
      "fd_phi_fluctuations 1\n",
    # the temperature statistics over the fluid sites only
    "porous_kiss_noise": B.replace(
        "free_energy symmetric", "free_energy symmetric_noise").replace(
        "3d_7pt_fluid", "3d_7pt_solid")
    + "temperature 0.00002\nisothermal_fluctuations on\n"
      "fd_phi_fluctuations 1\nporous_media_init simple_cubic\n"
      "porous_media_acell 4\n",
    "le_27pt": B.replace("size 8_8_16", "size 16_8_16").replace(
        "3d_7pt_fluid", "3d_27pt_fluid") + "N_LE_plane 2\n"
                                           "LE_plane_vel 0.01\n",
    "2d_tomita": B.replace("size 8_8_16", "size 16_16_1").replace(
        "3d_7pt_fluid", "2d_tomita_fluid"),
    "2d_5pt_walls": B.replace("size 8_8_16", "size 16_16_1").replace(
        "3d_7pt_fluid", "2d_5pt_fluid") + "boundary_walls 0_1_0\n",
}
TAGS = ("[rho]", "[phi]", "[fe", "[total", "[fluid", "[walls", "[minimum",
        "[maximum", "[eqipart", "[measd")


def log_lines(log):
    """(words, floats) of the statistics lines of a run log: each line's
    words with its floats blanked, and all its floats."""
    words, vals = [], []
    body = log[log.index("\nInitial conditions."):log.index("\nTimer")]
    for line in body.splitlines():
        if line.startswith("Free energies") or line.startswith(TAGS):
            toks = line.split()
            words.append(" ".join("#" if re.match(r"^-?\d", t) else t
                                  for t in toks))
            if line.startswith(TAGS):
                vals += [float(t) for t in toks if re.match(r"^-?\d", t)]
    return words, np.array(vals)


def _porous_map(directory):
    """A status_with_c_h map at 8x8x16: a solid column and scattered
    solid sites with per-site C and H, from a seed."""
    rng = np.random.default_rng(7)
    status = (rng.random((8, 8, 16)) < 0.08).astype(np.int8)
    status[2:4, 2:4, :] = 1
    data = np.stack([0.01 * rng.random((8, 8, 16)),
                     0.002 * rng.standard_normal((8, 8, 16))])
    write_map(str(directory / "capillary.001-001"), status, data)


@pytest.mark.parametrize("name", list(INPUTS))
def test_binary_input_matches_jax(name, tmp_path):
    _porous_map(tmp_path)
    text = INPUTS[name].replace("@DIR@", str(tmp_path))
    a, b = io.StringIO(), io.StringIO()
    jrun_text(text, out=a)
    sys_ = run_text(text, out=b, device="cpu")
    assert sys_.binary_cfg is not None and sys_.fused_mode is None
    (wj, fj), (wt, ft) = log_lines(a.getvalue()), log_lines(b.getvalue())
    assert wt == wj
    assert ft.size == fj.size > 0
    np.testing.assert_allclose(ft, fj, rtol=1e-9, atol=1e-11)
    if name.startswith(("walls", "open", "2d_5pt")):
        assert b.getvalue().count("[walls   ]") == 3
        assert "f v f/v f_s1 fs_s2" in b.getvalue()
    if name.endswith("kiss_noise"):
        assert b.getvalue().count("[eqipart.]") == 2
