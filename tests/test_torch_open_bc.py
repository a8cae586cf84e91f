"""The port's open boundaries (ops/open_bc.py, lb.make_step(open_bc=),
lb.make_wall_step(open_bc=)) against ludwig_tpu's, on the CPU.

The same random states, made with numpy from a seed, go through both
packages.  The boundary values are held bitwise (the same polynomial
equilibrium in the same operation order); the steps at rtol 1e-12 in
f64."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ludwig_tpu import lb as jlb
from ludwig_tpu.lattice import lb_model as jlb_model
from ludwig_tpu.ops import open_bc as jobc
from ludwig_tpu.ops import walls as jwalls
from ludwig_tpu.ops.stream import stream as jstream
from ludwig_tpu_torch import lb as tlb
from ludwig_tpu_torch.convert import params_from_jax, wall_state_from_jax
from ludwig_tpu_torch.lattice import lb_model
from ludwig_tpu_torch.ops import open_bc as tobc
from ludwig_tpu_torch.ops import walls as twalls

SIZE = (12, 8, 6)
BC = dict(u0=(0.01, 0.002, 0.0), rho0=1.01)


def _rand(seed, dtype="float64"):
    w = np.asarray(jlb_model(19).wv).reshape(-1, 1, 1, 1)
    rng = np.random.default_rng(seed)
    return (w * (1.0 + 0.05 * rng.standard_normal((19,) + SIZE))).astype(
        dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_apply_open_bc_matches_jax(axis, dtype):
    fpre = _rand(1, dtype)
    fnew = np.array(jstream(jnp.asarray(fpre), jlb_model(19)))
    want = jobc.apply_open_bc(jnp.asarray(fnew), jnp.asarray(fpre),
                              jlb_model(19), jobc.OpenBCConfig(**BC),
                              axis=axis)
    got = tobc.apply_open_bc(torch.as_tensor(fnew), torch.as_tensor(fpre),
                             lb_model(19), tobc.OpenBCConfig(**BC),
                             axis=axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_open_bc_x_with_edge_hydro_matches_jax():
    """The x variant, with the edge hydro of a previous state
    (open_bc_edge_hydro) in place of the pre-stream one."""
    fpre, fold = _rand(2), _rand(3)
    fnew = np.array(jstream(jnp.asarray(fpre), jlb_model(19)))
    jedge = jobc.open_bc_edge_hydro(jnp.asarray(fold), jlb_model(19))
    tedge = tobc.open_bc_edge_hydro(torch.as_tensor(fold), lb_model(19))
    for a, b in zip(tedge, jedge):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jobc.apply_open_bc(jnp.asarray(fnew), jnp.asarray(fpre),
                              jlb_model(19), jobc.OpenBCConfig(**BC),
                              edge_hydro=jedge)
    got = tobc.apply_open_bc(torch.as_tensor(fnew), torch.as_tensor(fpre),
                             lb_model(19), tobc.OpenBCConfig(**BC),
                             edge_hydro=tedge)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tobc.apply_open_bc_x(torch.as_tensor(fnew), torch.as_tensor(fpre),
                             lb_model(19), tobc.OpenBCConfig(**BC)).numpy(),
        np.asarray(jobc.apply_open_bc_x(jnp.asarray(fnew),
                                        jnp.asarray(fpre), jlb_model(19),
                                        jobc.OpenBCConfig(**BC))))


def _cfgs():
    jcfg = jlb.LBConfig(size=SIZE, nvel=19, eta_shear=0.1, eta_bulk=0.14,
                        dtype="float64")
    tcfg = params_from_jax({f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(jcfg)},
                           device="cpu")
    return jcfg, tcfg


def test_make_step_open_bc_matches_jax():
    """collide -> stream -> inflow/outflow along x, 3 steps."""
    jcfg, tcfg = _cfgs()
    f0 = _rand(4)
    jstep = jlb.make_step(jcfg, open_bc=jobc.OpenBCConfig(**BC))
    tstep = tlb.make_step(tcfg, open_bc=tobc.OpenBCConfig(**BC))
    jf, tf = jnp.asarray(f0), torch.as_tensor(f0)
    for t in range(1, 4):
        jf, _jrho, _ju = jstep(jf, t)
        tf, _trho, _tu = tstep(tf, t)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-12,
                               atol=1e-15)


def test_make_wall_step_open_bc_matches_jax():
    """A channel: walls on y, the open boundary along z (the first
    unwalled axis but x, as the CLI would pick for walls on x), 3 steps,
    the walls' momentum included."""
    jcfg, tcfg = _cfgs()
    walls = (False, True, False)
    f0 = _rand(5)
    jstep = jlb.make_wall_step(jcfg, jwalls.WallSpec(walls=walls),
                               open_bc=jobc.OpenBCConfig(**BC), open_axis=2)
    tstep = tlb.make_wall_step(tcfg, twalls.WallSpec(walls=walls),
                               open_bc=tobc.OpenBCConfig(**BC), open_axis=2)
    js = (jnp.asarray(f0), jnp.zeros((3,)))
    ts = wall_state_from_jax(f0, np.zeros(3), "cpu", "float64")
    for t in range(1, 4):
        js, _jrho, _ju = jstep(js, t)
        ts, _trho, _tu = tstep(ts, t)
    np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0]), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(ts[1].numpy(), np.asarray(js[1]), rtol=1e-10,
                               atol=1e-14)
