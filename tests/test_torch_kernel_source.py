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
    """binary_site_o*: one site of binary_phi_force_kernel, run on whole
    tensors with P/U as periodic neighbour fetches, against the twin."""
    from ludwig_tpu_torch.fe.symmetric import SymmetricFE
    from ludwig_tpu_torch.ops import fused_binary as fb

    rng = np.random.default_rng(order)
    phi = torch.as_tensor(0.05 * rng.standard_normal(SHAPE))
    u = torch.as_tensor(0.01 * rng.standard_normal((3,) + SHAPE))
    fe = SymmetricFE(-6.25e-3, 6.25e-3, 4e-3)
    m = re.search(rf"binary_site_o{order}\(.*?\{{\n(.*?)\n\}}",
                  _cuda.generate_binary_header(), re.S)
    out = [None] * 4

    def at(x, *o):
        return torch.roll(x, tuple(-v for v in o), (0, 1, 2))

    _exec_body(m.group(1).splitlines(),
               {"P": lambda *o: at(phi, *o),
                "U": lambda a, *o: at(u[a], *o),
                "p": fb._consts(fe, 0.45), "T": float, "out": out,
                "sel": fb._where_pos})
    want_phi, want_force = fb.binary_phi_force_step(phi, u, fe, 0.45, order)
    assert torch.equal(out[0], want_phi)
    assert torch.equal(torch.stack(out[1:]), want_force)
    # the bound's operation count: level-1 values once per site
    assert 0 < _cuda.site_ops("binary_phi_force_step", order=order) < (
        _cuda._binary_trace(order)[0].nops)


def test_header_declares_the_model():
    h = _cuda.generate_header(19)
    assert "#define LB_NVEL 19" in h and "#define LB_NGHOST 9" in h
    for d in (0, 1):
        for p in (0, 1):
            assert f"void lb_collide_d{d}_p{p}(" in h
        assert f"void lb_collide_force_p{d}(" in h
    # the projected absolute form carries no ghost rate at all
    assert "p.g[" not in "\n".join(_body(h, False, True))
    with pytest.raises(ValueError):
        _cuda.build((9,))         # no kernel for D2Q9
