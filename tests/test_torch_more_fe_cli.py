"""One input of each of the other free energies through ludwig_tpu's
run_text and the port's run_text(device="cpu"), and restarts across the
two packages.

The inputs - brazovskii (periodic, and sheared by a Lees-Edwards
plane), surfactant, ternary (the 2d_double_emulsion with its default
phi-grad-mu force, and the 2d_tee between walls with the 2-D ternary
wetting stencil), symmetric_lb (periodic, between walls, with
Lees-Edwards planes, with the LB's KISS noise),
polar_active (the aster) and fe_electro_symmetric (the Gouy-Chapman
electrolyte across a phi interface, epsilon1 != epsilon2) - run in
float64; every statistics float agrees at rtol 1e-9 / atol 1e-11 and
the lines' words are the same (the free-energy headers, [Px ] .. [Pz ],
the ternary [surf/fl/tot] and [rho/phi/psi] rows and the heterogeneous
SOR report among them).  The ternary, walled symmetric_lb and polar runs
restart from the other package's checkpoint at step 3 and end where the
straight run ends."""

import io
import re

import numpy as np
import pytest

from ludwig_tpu.ludwig import run_text as jrun_text
from ludwig_tpu_torch.ludwig import run_text

BASE = """
N_cycles 6
freq_statistics 3
size 8_8_16
viscosity 0.1
dtype float64
"""
BRAZOVSKII = BASE + """free_energy brazovskii
A -0.0005
B 0.0005
K -0.0006
C 0.00076
mobility 0.05
fd_advection_scheme_order 2
phi_initialisation spinodal
noise 0.01
random_seed 7
"""
SURFACTANT = BASE + """free_energy surfactant
surf_A -0.0208333
surf_B 0.0208333
surf_kappa 0.12
surf_kT 0.00056587
surf_epsilon 0.03
surf_beta 0.01
surf_psi0 0.05
surf_mobility_phi 0.15
surf_mobility_psi 0.1
phi_initialisation spinodal
noise 0.05
"""
TERNARY = BASE.replace("size 8_8_16", "size 16_16_2") + """free_energy ternary
ternary_alpha 1.0
ternary_kappa1 0.01
ternary_kappa2 0.02
ternary_kappa3 0.05
ternary_mobility_phi 0.15
ternary_mobility_psi 0.1
ternary_initialisation 2d_double_emulsion
"""
SYMMETRIC_LB = BASE + """free_energy symmetric_lb
A -0.00625
B 0.00625
K 0.004
mobility 0.15
phi_initialisation spinodal
noise 0.1
"""
POLAR = BASE + """free_energy polar_active
polar_active_a -0.1
polar_active_b 0.1
polar_active_k 0.01
polar_active_zeta 0.001
polar_active_lambda 0.1
leslie_ericksen_gamma 0.3
fd_advection_scheme_order 2
"""
ELECTRO_SYMM = BASE.replace("size 8_8_16", "size 16_4_4") + """
free_energy fe_electro_symmetric
A -0.00625
B 0.00625
K 0.004
mobility 0.05
phi_initialisation block_X
phi_init_block_dimension 6
electrokinetics_z0 1
electrokinetics_z1 -1
electrokinetics_d0 0.01
electrokinetics_d1 0.01
electrokinetics_eunit 1.0
electrokinetics_epsilon1 4.4e3
electrokinetics_epsilon2 2.2e3
electrosymmetric_delta_mu0 0.1
electrosymmetric_delta_mu1 -0.1
temperature 3.33333333333e-5
electrokinetics_init gouy_chapman
electrokinetics_init_rho_el 1.04e-3
electrokinetics_init_sigma 3.125e-2
electrokinetics_solver_type sor
electrokinetics_rel_tol 1e-3
electrokinetics_abs_tol 1e-15
electrokinetics_maxits 300
"""
# symmetric_lb's default is the 27-point stencil; its other inputs take
# the 7-point one, whose XLA compile is shorter (the 27-point solid and
# LE forms are held to the JAX package's in test_torch_more_fe_routes.py)
S7 = "fd_gradient_calculation 3d_7pt_fluid\n"
INPUTS = {
    "brazovskii": BRAZOVSKII,
    "brazovskii_le": BRAZOVSKII.replace("size 8_8_16", "size 16_8_8")
    + "N_LE_plane 1\nLE_plane_vel 0.01\n",
    "surfactant": SURFACTANT,
    "ternary_double_emulsion": TERNARY,
    "ternary_tee_walls": TERNARY.replace("2d_double_emulsion", "2d_tee")
    .replace("size 16_16_2", "size 16_16_1")
    + "fd_gradient_calculation 2d_ternary_solid\nboundary_walls 0_1_0\n"
      "ternary_h1 0.001\nternary_h2 -0.002\n",
    "symmetric_lb": SYMMETRIC_LB,
    "symmetric_lb_walls": SYMMETRIC_LB + "boundary_walls 0_0_1\n" + S7,
    "symmetric_lb_le": SYMMETRIC_LB.replace("size 8_8_16", "size 16_8_16")
    + "N_LE_plane 2\nLE_plane_vel 0.01\n" + S7,
    "symmetric_lb_kiss": SYMMETRIC_LB + "temperature 0.00002\n"
                                        "isothermal_fluctuations on\n" + S7,
    "polar_active": POLAR,
    "fe_electro_symmetric": ELECTRO_SYMM,
}
TAGS = ("[rho]", "[phi]", "[fe", "[total", "[fluid", "[walls", "[minimum",
        "[maximum", "[eqipart", "[measd", "[psi]", "[elc]", "[Px ]", "[Py ]",
        "[Pz ]", "[surf/fl/tot]", "[rho/phi/psi]", "SOR residual")
HEADS = ("Free energies", "SOR ")


NUMBER = re.compile(r"[-+]?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?")


def log_lines(log):
    """(words, floats) of the statistics lines of a run log: each line's
    words with its numbers blanked, and all its numbers (the reference's
    [phi] format glues a pair where the second is negative)."""
    words, vals = [], []
    body = log[log.index("\nInitial conditions."):log.index("\nTimer")]
    for line in body.splitlines():
        if line.startswith(HEADS) or line.startswith(TAGS):
            tag, _, rest = line.rpartition("]")
            words.append(tag + _ + NUMBER.sub(" # ", rest))
            words[-1] = " ".join(words[-1].split())
            if line.startswith(TAGS):
                vals += [float(v) for v in NUMBER.findall(rest)]
    return words, np.array(vals)


def _hold(jlog, tlog):
    (wj, fj), (wt, ft) = log_lines(jlog), log_lines(tlog)
    assert wt == wj
    assert ft.size == fj.size > 0
    np.testing.assert_allclose(ft, fj, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("name", list(INPUTS))
def test_input_matches_jax(name):
    a, b = io.StringIO(), io.StringIO()
    jrun_text(INPUTS[name], out=a)
    sys_ = run_text(INPUTS[name], out=b, device="cpu")
    assert sys_.fused_mode is None
    _hold(a.getvalue(), b.getvalue())
    log = b.getvalue()
    assert "Completed cycle 6" in log
    if name.startswith("ternary"):
        assert log.count("[surf/fl/tot]") == 3
        assert log.count("[rho/phi/psi]") == (3 if "walls" in name else 0)
    if name == "symmetric_lb_walls":
        assert log.count("[walls   ]") == 3
        assert "f v f/v f_s1 fs_s2" in log
    if name == "polar_active":
        assert log.count("[Pz ]") == 3
    if name == "fe_electro_symmetric":
        assert "SOR (heterogeneous) solver converged" in log


RESTARTS = ("ternary_tee_walls", "symmetric_lb_walls", "polar_active")


@pytest.mark.parametrize("name", RESTARTS)
@pytest.mark.parametrize("first", ["jax", "torch"])
def test_restart_across_packages(name, first, tmp_path):
    """The first 3 steps in one package with a checkpoint at step 3, the
    last 3 in the other from it (N_start 3): its statistics at step 6 are
    the straight run's."""
    text = INPUTS[name] + f"io_directory {tmp_path}\n"
    straight = io.StringIO()
    run_text(text, out=straight, device="cpu")
    head = text.replace("N_cycles 6", "N_cycles 3") + "freq_config 3\n"
    tail = text.replace("N_cycles 6", "N_cycles 3") + "N_start 3\n"
    out = io.StringIO()
    if first == "jax":
        jrun_text(head, out=io.StringIO())
        run_text(tail, out=out, device="cpu")
    else:
        run_text(head, out=io.StringIO(), device="cpu")
        jrun_text(tail, out=out)
    want = log_lines(straight.getvalue())[1]
    got = log_lines(out.getvalue())[1]
    # the last statistics block of each run
    n = got.size // 2
    np.testing.assert_allclose(got[-n:], want[-n:], rtol=1e-9, atol=1e-11)
