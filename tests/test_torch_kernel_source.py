"""The CUDA kernels' generated collision source, run on the CPU.

The kernels' collision is straight-line C++ generated from the port's
twin (ops/_cuda.py).  No CUDA compiler is needed to check its
arithmetic: each generated statement is also a Python statement once the
C++ declaration syntax is stripped, so the body runs here on tensors, as
one site per tensor element, and its pushed values stream exactly as the
kernel stores them.  It must equal the twin bitwise in f64."""

import re
import types

import numpy as np
import pytest
import torch

from ludwig_tpu_torch.lattice import lb_model
from ludwig_tpu_torch.ops import _cuda, fused
from ludwig_tpu_torch.ops.collide import CollisionParams, RelaxationScheme

SHAPE = (6, 8, 10)


def _body(header, delta, projected):
    name = f"lb_collide_d{int(delta)}_p{int(projected)}"
    m = re.search(name + r"\(.*?\{\n(.*?)\n\}", header, re.S)
    return m.group(1).splitlines()


def _run_generated(nvel, params, f, delta):
    """Stream the generated collision's emit(q, cx, cy, cz, v) calls
    like fused_step_kernel: value v of site x lands at x + c."""
    proj, par = _cuda._kernel_params(params.model, params, delta)
    lines = _body(_cuda.generate_header(nvel), delta, proj)
    p = types.SimpleNamespace(rt=par[0], rtb=par[1], fx=par[2], fy=par[3],
                              fz=par[4], g=list(par)[5:])
    out = [None] * nvel

    def emit(q, cx, cy, cz, v):
        assert out[q] is None
        assert (cx, cy, cz) == tuple(int(c) for c in params.model.cv[q])
        out[q] = torch.roll(v, (cx, cy, cz), (0, 1, 2))

    env = {"f": [f[q] for q in range(nvel)], "p": p, "T": float,
           "emit": emit}
    code = "\n".join(ln.strip().removeprefix("const T ").rstrip(";")
                     for ln in lines)
    exec(code, env)
    return torch.stack(out), bool(proj)


@pytest.mark.parametrize("nvel", [15, 19, 27])
@pytest.mark.parametrize("scheme", ["m10", "bgk", "trt"])
@pytest.mark.parametrize("delta", [True, False])
def test_generated_collision_is_the_twin(nvel, scheme, delta):
    if scheme == "trt" and nvel == 27:
        pytest.raises(ValueError, _cuda._kernel_params, lb_model(27),
                      CollisionParams(model=lb_model(27), eta_shear=0.1,
                                      eta_bulk=0.1,
                                      scheme=RelaxationScheme.TRT),
                      delta)
        return
    model = lb_model(nvel)
    params = CollisionParams(model=model, eta_shear=0.1, eta_bulk=0.14,
                             scheme=RelaxationScheme(scheme),
                             force_global=(1e-4, -2e-4, 5e-5))
    rng = np.random.default_rng(nvel)
    f = torch.as_tensor(model.wv.reshape(-1, 1, 1, 1) * (
        1.0 + 0.05 * rng.standard_normal((nvel,) + SHAPE)))
    got, projected = _run_generated(nvel, params, f, delta)
    assert projected == (scheme == "m10")
    assert torch.equal(got, fused.fused_step(f, model, params, delta=delta))


def _exec_body(lines, env):
    code = "\n".join(ln.strip().removeprefix("const T ").rstrip(";")
                     for ln in lines)
    exec(code, env)


@pytest.mark.parametrize("nvel", [15, 19, 27])
@pytest.mark.parametrize("scheme", ["m10", "bgk"])
def test_generated_force_collision_is_the_twin(nvel, scheme):
    """lb_collide_force_p*: the collision of fused_force_step_kernel with
    a per-site force, streamed as the kernel stores it, and its u."""
    model = lb_model(nvel)
    params = CollisionParams(model=model, eta_shear=0.1, eta_bulk=0.14,
                             scheme=RelaxationScheme(scheme),
                             force_global=(1e-4, 0.0, 5e-5))
    rng = np.random.default_rng(nvel + 1)
    f = torch.as_tensor(model.wv.reshape(-1, 1, 1, 1) * (
        1.0 + 0.05 * rng.standard_normal((nvel,) + SHAPE)))
    frc = torch.as_tensor(1e-4 * rng.standard_normal((3,) + SHAPE))
    proj, par = _cuda._kernel_params(model, params, True)
    name = f"lb_collide_force_p{proj}"
    m = re.search(name + r"\(.*?\{\n(.*?)\n\}", _cuda.generate_header(nvel),
                  re.S)
    p = types.SimpleNamespace(rt=par[0], rtb=par[1], g=list(par)[5:])
    # the kernel adds the global force where it is non-zero
    fs = [frc[a] + par[2 + a] if par[2 + a] != 0.0 else frc[a]
          for a in range(3)]
    out, u = [None] * nvel, [None] * 3

    def emit(q, cx, cy, cz, v):
        out[q] = torch.roll(v, (cx, cy, cz), (0, 1, 2))

    _exec_body(m.group(1).splitlines(),
               {"f": [f[q] for q in range(nvel)], "fs": fs, "p": p,
                "T": float, "emit": emit, "u": u})
    want_f, want_u = fused.fused_force_step(f, frc, model, params)
    assert torch.equal(torch.stack(out), want_f)
    assert torch.equal(torch.stack(u), want_u)


@pytest.mark.parametrize("order", [1, 2])
def test_generated_binary_site_is_the_twin(order):
    """binary_level1 and binary_site_o*: the device functions of
    binary_phi_force_kernel, run on whole tensors with P/U/S/MU as
    periodic neighbour fetches, against the twin."""
    from ludwig_tpu_torch.fe.symmetric import SymmetricFE
    from ludwig_tpu_torch.ops import fused_binary as fb

    rng = np.random.default_rng(order)
    phi = torch.as_tensor(0.05 * rng.standard_normal(SHAPE))
    u = torch.as_tensor(0.01 * rng.standard_normal((3,) + SHAPE))
    fe = SymmetricFE(-6.25e-3, 6.25e-3, 4e-3)
    header = _cuda.generate_binary_header()

    def at(x, *o):
        return torch.roll(x, tuple(-v for v in o), (0, 1, 2))

    def body(name):
        m = re.search(name + r"\(.*?\{\n(.*?)\n\}", header, re.S)
        return m.group(1).splitlines()

    p = fb._consts(fe, 0.45)
    mu, pth, out = [None], [None] * 9, [None] * 4
    _exec_body(body("void binary_level1"),
               {"P": lambda *o: at(phi, *o), "p": p, "T": float, "mu": mu,
                "pth": pth})
    _exec_body(body(f"void binary_site_o{order}"),
               {"P": lambda *o: at(phi, *o),
                "U": lambda a, *o: at(u[a], *o),
                "S": lambda a, b, *o: at(pth[3 * a + b], *o),
                "MU": lambda *o: at(mu[0], *o), "p": p, "T": float,
                "out": out, "sel": fb._where_pos})
    want_phi, want_force = fb.binary_phi_force_step(phi, u, fe, 0.45, order)
    assert torch.equal(out[0], want_phi)
    assert torch.equal(torch.stack(out[1:]), want_force)
    # the bound's operation count: one level-1 evaluation and one site
    # update a site; the issue floor's count on a layout of 1.3 level-1
    # evaluations a site is larger
    tr1, _tail, sites = _cuda._binary_trace()
    ops = _cuda.site_ops("binary_phi_force_step", order=order)
    assert ops == tr1.nops + sites[order][0].nops
    assert ops == _cuda.k1_site_ops(_cuda.BINARY_KERNEL, 1.0, order) < (
        _cuda.k1_site_ops(_cuda.BINARY_KERNEL, 1.3, order))


def test_header_declares_the_model():
    h = _cuda.generate_header(19)
    assert "#define LB_NVEL 19" in h and "#define LB_NGHOST 9" in h
    for d in (0, 1):
        for p in (0, 1):
            assert f"void lb_collide_d{d}_p{p}(" in h
        assert f"void lb_collide_force_p{d}(" in h
    # the projected absolute form carries no ghost rate at all
    assert "p.g[" not in "\n".join(_body(h, False, True))
    assert "LB_NO_FORCE" not in h and "for D3Q19 " in h
    # D2Q9: the one-step collisions with and without fluctuations, no
    # force collision (the TPU force kernel takes 3-D sets only)
    h9 = _cuda.generate_header(9)
    assert "#define LB_NVEL 9" in h9 and "#define LB_NGHOST 3" in h9
    assert "#define LB_NO_FORCE" in h9 and "for D2Q9 " in h9
    assert "lb_collide_force" not in h9
    for d in (0, 1):
        for p in (0, 1):
            assert f"void lb_collide_d{d}_p{p}(" in h9
            assert f"void lb_collide_noise_d{d}_p{p}(" in h9
    assert "fused_lb_q9" in _cuda._jobs()
    with pytest.raises(ValueError):
        _cuda.build(("fused_lb_q11",))    # no such velocity set


@pytest.mark.parametrize("nvel", [15, 19, 27])
def test_header_antipode_table(nvel):
    """lb_anti(q), the solid kernel's bounce-back target, is the model's
    reverse table: evaluated here as the Python conditional chain it
    spells."""
    h = _cuda.generate_header(nvel)
    expr = re.search(r"int lb_anti\(int q\) \{\n  return (.*);\n\}", h).group(1)
    py = re.sub(r"q == (\d+) \? (\d+) :", r"\2 if q == \1 else", expr)
    model = lb_model(nvel)
    assert [eval(py, {"q": q}) for q in range(nvel)] == list(model.reverse)
    assert (model.cv[model.reverse] == -model.cv).all()


@pytest.mark.parametrize("extra", [
    {}, dict(zeta0=0.002, zeta1=0.01), dict(redshift=0.93)],
    ids=["passive", "active", "redshift"])
def test_generated_lc_site_is_the_twin(extra):
    """lc_level1 and lc_site: the two device functions of
    lc_q_force_kernel, run on whole tensors with Q/U/S/H as periodic
    neighbour fetches, against the twin; the constant table p.c[] is
    folded on the host as the launch folds it."""
    from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE
    from ludwig_tpu_torch.fe.lc_init import lc_init_o8m
    from ludwig_tpu_torch.ops import fused_lc as fl

    fe = BluePhaseFE(a0=0.01, gamma=3.0, q0=0.19635, kappa0=0.000648456,
                     kappa1=0.0007, xi=0.7, **extra)
    rng = np.random.default_rng(5)
    q = torch.as_tensor(lc_init_o8m(SHAPE, fe.q0, -0.2)
                        + 0.02 * rng.standard_normal((5,) + SHAPE))
    u = torch.as_tensor(0.01 * rng.standard_normal((3,) + SHAPE))
    header = _cuda.generate_lc_header()
    p = types.SimpleNamespace(c=_cuda.lc_const_values(fe, 0.5))
    assert f"#define LC_NCONST {len(p.c)}" in header

    def at(x, *o):
        return torch.roll(x, tuple(-v for v in o), (0, 1, 2))

    def body(name):
        m = re.search(name + r"\(.*?\{\n(.*?)\n\}", header, re.S)
        return m.group(1).splitlines()

    pth, h5, out = [None] * 9, [None] * 5, [None] * 8
    _exec_body(body("void lc_level1"),
               {"Q": lambda n, *o: at(q[n], *o), "p": p, "T": float,
                "pth": pth, "h5": h5})
    _exec_body(body("void lc_site"),
               {"Q": lambda n, *o: at(q[n], *o),
                "U": lambda a, *o: at(u[a], *o),
                "S": lambda a, b, *o: at(pth[3 * a + b], *o),
                "H": lambda n: h5[n], "p": p, "T": float, "out": out,
                "sel": fl._where_pos})
    want_q, want_force = fl.lc_q_force_step(q, u, fe, 0.5)
    assert torch.equal(torch.stack(out[:5]), want_q)
    assert torch.equal(torch.stack(out[5:]), want_force)
    # the bound's operation count: one level-1 evaluation in the free
    # energy's factored form and one site update per site; fewer than
    # the kernel text's distinct operations, far more than the binary site
    kernel_ops = sum(tr.nops for tr in _cuda._lc_trace()[:3:2])
    assert 5 * _cuda.site_ops("binary_phi_force_step") < _cuda.site_ops(
        "lc_q_force_step") < kernel_ops


def test_trace_counts_distinct_operations():
    """A value met again is the temporary it already has: the same
    operator on the same operands, in either order where it commutes."""
    tr = _cuda._Trace(skip_exact=True)
    a, b = tr.load("A"), tr.load("B")
    assert tr.load("A") is a and tr.nops == 0
    assert (a * b) is (b * a) and (a + b) is (b + a) and tr.nops == 2
    assert (a - b) is not (b - a) and (a / b) is not (b / a)
    assert (2.0 * a) is (a * 2.0) and tr.nops == 7
    assert (0 + a) is a and (a * 1) is a and (-1 * a) is (-a)
    assert tr.nops == 8 and len(tr.lines) == 10


def test_factored_level1_is_the_twins_level1():
    """The factored free energy behind the bound's operation count is the
    function the twin and the kernel evaluate: float64, rtol 1e-12 of
    each component's largest value."""
    from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE
    from ludwig_tpu_torch.fe.lc_init import lc_init_o8m
    from ludwig_tpu_torch.ops import fused_lc as fl

    fe = BluePhaseFE(a0=0.01, gamma=3.0, q0=0.19635, kappa0=0.000648456,
                     kappa1=0.0007, xi=0.7, redshift=0.93, zeta0=0.002,
                     zeta1=0.01)
    rng = np.random.default_rng(6)
    q = torch.as_tensor(lc_init_o8m(SHAPE, fe.q0, -0.2)
                        + 0.02 * rng.standard_normal((5,) + SHAPE))

    def Q(n, *o):
        return torch.roll(q[n], tuple(-v for v in o), (0, 1, 2))

    want = fl._level1(Q, fe)
    got = fl._level1(Q, fe, factored=True)
    for w33, g33 in zip(want, got):
        for a in range(3):
            for b in range(3):
                tol = 1e-12 * float(w33[a][b].abs().max())
                assert float((g33[a][b] - w33[a][b]).abs().max()) <= tol


@pytest.mark.parametrize("order", [1, 2])
def test_generated_droplet_site_is_the_twin(order):
    """droplet_level1 and droplet_site_o*: the device functions of
    droplet_kernel, run on whole tensors with P/Q/U/MU/S/H as periodic
    neighbour fetches, against the twin, with W and delta non-zero and
    the active stress's zetas zero (the kernel adds that term always);
    the constant table p.c[] is folded on the host as the launch folds
    it."""
    from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE
    from ludwig_tpu_torch.fe.lc_droplet import LCDropletFE
    from ludwig_tpu_torch.fe.symmetric import SymmetricFE
    from ludwig_tpu_torch.ops import fused_droplet as fd

    fe = LCDropletFE(
        symm=SymmetricFE(-0.0625, 0.0625, 0.053),
        lc=BluePhaseFE(a0=0.1, gamma=2.586, q0=0.19635, kappa0=0.01,
                       kappa1=0.012, xi=0.7, redshift=0.93),
        gamma0=2.586, delta=0.25, w=0.02)
    rng = np.random.default_rng(7)
    phi = torch.as_tensor(0.05 * rng.standard_normal(SHAPE))
    q = torch.as_tensor(0.1 * rng.standard_normal((5,) + SHAPE))
    u = torch.as_tensor(0.01 * rng.standard_normal((3,) + SHAPE))
    header = _cuda.generate_droplet_header()
    p = types.SimpleNamespace(c=_cuda.droplet_const_values(fe, 0.5, 0.05))
    assert f"#define DROPLET_NCONST {len(p.c)}" in header

    def at(x, *o):
        return torch.roll(x, tuple(-v for v in o), (0, 1, 2))

    def body(name):
        m = re.search(name + r"\(.*?\{\n(.*?)\n\}", header, re.S)
        return m.group(1).splitlines()

    mu, pth, h, out = [None], [None] * 9, [None] * 9, [None] * 9
    _exec_body(body("void droplet_level1"),
               {"P": lambda *o: at(phi, *o),
                "Q": lambda n, *o: at(q[n], *o), "p": p, "T": float,
                "mu": mu, "pth": pth, "h": h})
    _exec_body(body(f"void droplet_site_o{order}"),
               {"P": lambda *o: at(phi, *o),
                "Q": lambda n, *o: at(q[n], *o),
                "U": lambda a, *o: at(u[a], *o),
                "MU": lambda *o: at(mu[0], *o),
                "S": lambda a, b, *o: at(pth[3 * a + b], *o),
                "H": lambda b, c: h[3 * b + c], "p": p, "T": float,
                "out": out, "sel": fd._where_pos})
    want_phi, want_q, want_force = fd.droplet_phi_q_force_step(
        phi, q, u, fe, 0.5, 0.05, order)
    assert torch.equal(out[0], want_phi)
    assert torch.equal(torch.stack(out[1:6]), want_q)
    assert torch.equal(torch.stack(out[6:]), want_force)
    # the bound's operation count: level 1 once and the site's fields
    # kept, fewer than the kernel text's operations
    tr1, _tail, sites, _table = _cuda._droplet_trace()
    assert tr1.nops < _cuda.site_ops("droplet_phi_q_force_step",
                                     order=order) < (
        tr1.nops + sites[order][0].nops)


@pytest.mark.parametrize("nvel,scheme", [(15, "m10"), (19, "m10"),
                                         (19, "trt"), (27, "bgk")])
@pytest.mark.parametrize("delta", [True, False])
def test_generated_noise_collision_is_the_twin(nvel, scheme, delta):
    """lb_collide_noise_d*_p*: the fluctuating collision of
    fused_step_kernel<NOISE>, fed the site deviates the kernel hashes
    (the twin's _window_deviates) and its noise parameters, streamed as
    the kernel stores it: bitwise the twin fused_step(noise=, t=)."""
    from ludwig_tpu_torch.noise import var_bulk, var_eta, var_ghost

    model = lb_model(nvel)
    params = CollisionParams(model=model, eta_shear=0.1, eta_bulk=0.14,
                             scheme=RelaxationScheme(scheme),
                             force_global=(1e-4, -2e-4, 5e-5))
    kt = 2e-5
    noise = fused.FusedNoise(
        seed=8361235, v_eta=var_eta(1.0 / params.rtau_shear, kt),
        v_bulk=var_bulk(1.0 / params.rtau_bulk, kt),
        v_ghost=tuple(var_ghost(model, params.rtau_ghost, kt)))
    t = 2 ** 20 + 3
    rng = np.random.default_rng(nvel + 7)
    f = torch.as_tensor(model.wv.reshape(-1, 1, 1, 1) * (
        1.0 + 0.05 * rng.standard_normal((nvel,) + SHAPE)))
    proj, par = _cuda._kernel_params(model, params, delta)
    name = f"lb_collide_noise_d{int(delta)}_p{proj}"
    m = re.search(name + r"\(.*?\{\n(.*?)\n\}", _cuda.generate_header(nvel),
                  re.S)
    eta2, eta, bulk, ghost = fused.noise_amplitudes(model, noise)
    p = types.SimpleNamespace(rt=par[0], rtb=par[1], fx=par[2], fy=par[3],
                              fz=par[4], g=list(par)[5:], nz_eta2=eta2,
                              nz_eta=eta, nz_bulk=bulk,
                              nz_g=[0.0 if a is None else a for a in ghost])
    r = fused._window_deviates(*fused._site_coords(SHAPE, "cpu"), t,
                               noise.seed, 6 + nvel - model.nhydro, f.dtype)
    out = [None] * nvel

    def emit(q, cx, cy, cz, v):
        out[q] = torch.roll(v, (cx, cy, cz), (0, 1, 2))

    _exec_body(m.group(1).splitlines(),
               {"f": [f[q] for q in range(nvel)], "r": r, "p": p,
                "T": float, "emit": emit})
    want = fused.fused_step(f, model, params, noise=noise, t=t, delta=delta)
    assert torch.equal(torch.stack(out), want)
    assert not torch.equal(want, fused.fused_step(f, model, params,
                                                  delta=delta))


# sha256 of the generated headers as they were before the fluctuating
# collision was added: with noise off every generated text is unchanged
# (the binary header's is that of its x-march form, level 1 and the site
# update apart)
HEADER_SHA256 = {
    15: "59379c843a6a42b23cadabad780183f320b8aec3968f26a3b2cf5e483d4923ca",
    19: "ef7a94a921fc01f1bdd1db69165f32996e652a49251522e083eb835a94180a5f",
    27: "f8fe823f91ed34d711fd401d75537ebdfa93088527cbee50aeb84d5e2571944c",
    "binary":
        "fae133d75d08a902f70059d1e3ab72867f2942d20725d1f7905703a262551864",
    "lc": "c7b8c0d6c8b4ef0d1294ccc6922bbdc491ec66af178fef4c764bce4fbebdd542",
    "droplet":
        "720db9e806d5e70029e4ecb0e5988dad6108a2cad339fe8eee3c90a60f8e63ba",
}


@pytest.mark.parametrize("which", sorted(HEADER_SHA256, key=str))
def test_headers_unchanged_with_noise_off(which):
    import hashlib

    if isinstance(which, int):
        # the fluctuating collisions come last: the text before the first
        # of them is the header as it was
        text = _cuda.generate_header(which)
        start = text.rindex("template", 0, text.index("lb_collide_noise"))
        text = text[:start - 1]
        assert "lb_collide_noise" not in text
    else:
        text = getattr(_cuda, f"generate_{which}_header")()
    assert hashlib.sha256(text.encode()).hexdigest() == HEADER_SHA256[which]


# sha256 of the generated LC K1 and droplet K1 headers at the commit
# before the blue phase's electric field, surface energy and dynamic
# redshift were ported: with no field (e0 zero) their text is unchanged
PARENT_K1_SHA256 = {
    "lc": "c7b8c0d6c8b4ef0d1294ccc6922bbdc491ec66af178fef4c764bce4fbebdd542",
    "droplet":
        "720db9e806d5e70029e4ecb0e5988dad6108a2cad339fe8eee3c90a60f8e63ba",
}


@pytest.mark.parametrize("which", sorted(PARENT_K1_SHA256))
def test_k1_headers_unchanged_with_e0_zero(which):
    """The LC and droplet K1 headers byte for byte, and the traced level-1
    text of a free energy with a dielectric anisotropy but e0 zero equal
    to the field-free one's: the electric-field terms sit behind the
    static `any(e0) and epsilon` test."""
    import dataclasses
    import hashlib

    from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE
    from ludwig_tpu_torch.ops import fused_lc

    text = getattr(_cuda, f"generate_{which}_header")()
    assert (hashlib.sha256(text.encode()).hexdigest()
            == PARENT_K1_SHA256[which])
    base = {k: _cuda._Const.named(k) for k in _cuda.LC_BASE}
    fe = BluePhaseFE(**{k: base[k] for k in _cuda.LC_BASE
                        if k != "be_gamma"})
    lines = []
    for f in (fe, dataclasses.replace(fe, epsilon=_cuda._Const.named("eps"),
                                      e0=(0.0, 0.0, 0.0))):
        tr = _cuda._Trace({}, skip_exact=True)
        h, pth = fused_lc._level1(
            lambda *a: tr.load(f"Q({', '.join(str(x) for x in a)})"), f)
        lines.append(tr.lines + [v.name for row in h + pth for v in row])
    assert lines[0] == lines[1]
