"""The port's anchoring gradient (ludwig_tpu_torch/ops/lc_anchor.py)
against ludwig_tpu/ops/lc_anchor.py on the CPU.

The same numpy inputs from a seed go through both: every wall kind in
both styles ('two', the 3d_7pt_solid one, and 's7', s7_anchoring), halo
walls on each axis, a status map with porous (MAP_BOUNDARY) sites and
colloids whose normals come from their centres, and the droplet's phi
scaling; float64 at rtol 1e-12 / atol 1e-14.  The constant matrices are
bitwise the JAX package's."""

import numpy as np
import pytest
import torch

from ludwig_tpu.ops import lc_anchor as J
from ludwig_tpu_torch.ops import lc_anchor as T

SIZE = (6, 7, 8)
TOL = dict(rtol=1e-12, atol=1e-14)
KAPPA0, KAPPA1, Q0, AMP = 0.01, 0.015, 0.19635, 0.3


def _params(mod, wall, method, coll="none"):
    return mod.AnchoringParams(
        kappa0=KAPPA0, kappa1=KAPPA1, q0=Q0, amplitude=AMP, wall=wall,
        wall_w1=0.02, wall_w2=0.005 if wall == "planar" else 0.0,
        wall_nfix=(0.6, 0.0, 0.8), coll=coll, coll_w1=0.03,
        coll_w2=0.004 if coll == "planar" else 0.0, method=method)


def _q5(seed=1):
    return 0.1 * np.random.RandomState(seed).standard_normal((5,) + SIZE)


def _colloid_status(seed=2):
    """(status, pid, R): two spheres (0-based centres) and a few porous
    sites, the owner map by the nearest centre."""
    rng = np.random.RandomState(seed)
    R = np.array([[2.2, 3.1, 2.4], [3.6, 3.3, 6.1]]) + rng.uniform(
        -0.2, 0.2, (2, 3))
    g = np.stack(np.meshgrid(*[np.arange(n, dtype=float) for n in SIZE],
                             indexing="ij"))
    L = np.array(SIZE, float)[:, None, None, None]
    r2 = []
    for c in R:
        d = g - c[:, None, None, None]
        d = d - L * np.round(d / L)
        r2.append(np.sum(d * d, axis=0))
    r2 = np.stack(r2)
    inside = r2 < np.array([1.8, 1.6])[:, None, None, None] ** 2
    pid = np.where(inside.any(0), np.argmin(np.where(inside, r2, np.inf), 0),
                   -1).astype(np.int32)
    status = np.where(pid >= 0, T.MAP_COLLOID, T.MAP_FLUID).astype(np.int32)
    porous = rng.uniform(size=SIZE) < 0.04
    status = np.where(porous & (pid < 0), T.MAP_BOUNDARY, status)
    return status.astype(np.int32), pid, R


def _hold(jargs, targs, **kw):
    import jax.numpy as jnp

    gj, dj = J.anchoring_gradient(*jargs, **{
        k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
        for k, v in kw.items()})
    gt, dt = T.anchoring_gradient(*targs, **{
        k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
        for k, v in kw.items()})
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
    return gt


def _run(wall, method, status, walls=(False,) * 3, coll="none", **kw):
    import jax.numpy as jnp

    q5 = _q5()
    return _hold((jnp.asarray(q5), _params(J, wall, method, coll),
                  jnp.asarray(status)),
                 (torch.as_tensor(q5), _params(T, wall, method, coll),
                  torch.as_tensor(status)), walls=walls, **kw)


def test_constant_matrices_bitwise():
    for dn in ((1.0, 0.0, 0.0), (0.3, -0.4, 0.866), (0.0, 0.0, -1.0)):
        assert np.array_equal(T.bc_coefficients(KAPPA0, KAPPA1, dn),
                              J.bc_coefficients(KAPPA0, KAPPA1, dn))
    for a, b in zip(T.anchoring_matrices(KAPPA0, KAPPA1),
                    J.anchoring_matrices(KAPPA0, KAPPA1)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("method", ["two", "s7"])
@pytest.mark.parametrize("wall", ["none", "normal", "planar", "fixed"])
def test_every_kind_between_walls(wall, method):
    """Walls on all three axes: faces, edges (two unknowns) and corners
    (three) of the box."""
    status = np.zeros(SIZE, np.int32)
    _run(wall, method, status, walls=(True, True, True))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_walls_on_each_axis(axis):
    walls = tuple(a == axis for a in range(3))
    gt = _run("normal", "s7", np.zeros(SIZE, np.int32), walls=walls)
    # away from the walled faces the gradient is the plain 7-point one
    from ludwig_tpu_torch.ops.stencil import grad_7pt
    plain = grad_7pt(torch.as_tensor(_q5()))
    inner = [slice(None)] * 5
    inner[2 + axis] = slice(1, SIZE[axis] - 1)
    np.testing.assert_allclose(gt[tuple(inner)].numpy(),
                               plain[tuple(inner)].numpy(), **TOL)


@pytest.mark.parametrize("method", ["two", "s7"])
@pytest.mark.parametrize("coll", ["normal", "planar"])
def test_colloid_status_with_normals(coll, method):
    """A colloid status beside porous sites and a wall on z: the colloid
    faces take the normals from the centres, the others the lattice
    ones; the wall kind is fixed."""
    status, pid, R = _colloid_status()
    _run("fixed", method, status, walls=(False, False, True), coll=coll,
         pid=pid, R=R)


def test_phi_scaling():
    """The droplet's wetting: every constant term scaled by (1 + phi)/2."""
    status, pid, R = _colloid_status(seed=5)
    phi = np.tanh(np.random.RandomState(3).standard_normal(SIZE))
    _run("planar", "two", status, walls=(True, False, False), coll="normal",
         pid=pid, R=R, phi=phi)


def test_no_solid_is_the_plain_stencil():
    from ludwig_tpu_torch.ops.stencil import delsq_7pt, grad_7pt
    q5 = torch.as_tensor(_q5(4))
    g, d = T.anchoring_gradient(q5, _params(T, "normal", "s7"),
                                torch.zeros(SIZE, dtype=torch.int32))
    np.testing.assert_allclose(g.numpy(), grad_7pt(q5).numpy(), **TOL)
    np.testing.assert_allclose(d.numpy(), delsq_7pt(q5).numpy(), **TOL)
