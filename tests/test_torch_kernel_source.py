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


def test_header_declares_the_model():
    h = _cuda.generate_header(19)
    assert "#define LB_NVEL 19" in h and "#define LB_NGHOST 9" in h
    for d in (0, 1):
        for p in (0, 1):
            assert f"void lb_collide_d{d}_p{p}(" in h
    # the projected absolute form carries no ghost rate at all
    assert "p.g[" not in "\n".join(_body(h, False, True))
    with pytest.raises(ValueError):
        _cuda.build((9,))         # no kernel for D2Q9
