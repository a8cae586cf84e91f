"""Fused liquid-crystal (blue phase) step: two kernels.

PyTorch port of the periodic single-device path of
ludwig_tpu/ops/fused_lc.py, the reference's headline benchmark (the
coupled Q-tensor + LB loop).  One step is two passes over the lattice:

  K1 lc_q_force_step: q5, u -> q5', force
      7-point gradients of Q, the Landau-de Gennes molecular field, the
      stress (+ active stress), its divergence, and the Beris-Edwards
      update (order-1 upwind advection + corotation).  The TPU kernel
      ``_lc_kernel`` becomes the CUDA kernel of csrc/lc_q.cu.
  K2 ops.fused.fused_force_step: f, force -> f', u.

u is the collision-time velocity K2 wrote in the previous step (zero at
the start), so K1 runs first.  Tensors are unpadded: q5 (5, X, Y, Z), u
and force (3, X, Y, Z), f (nvel, X, Y, Z); periodicity is index
arithmetic.

The arithmetic is written once, below, as Python over neighbour
accessors, in two functions: ``_level1`` (what a site and its six
neighbours each need: molecular field and stress from Q's 7-point
stencil) and ``_lc_site`` (force and Q update from the neighbours'
stress).  The twin evaluates them on whole tensors (level 1 once, then
rolled; a roll is exact); ops/_cuda.py traces them with symbols into the
kernel's straight-line C++.  Both follow the Pallas kernel's term order
(fused_lc.py:123-202), so float64 results agree with it to the last
bits.
"""

from __future__ import annotations

import torch

from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE, q5_to_q33, q33_to_q5
from ludwig_tpu_torch.lc import (GRADIENT, LCConfig, _s5_corotation,
                                 initial_lc, make_lc_le_column_fix)
from ludwig_tpu_torch.ops import _cuda
from ludwig_tpu_torch.ops.fused import fused_force_step
from ludwig_tpu_torch.ops.lees_edwards import make_le_post
from ludwig_tpu_torch.ops.stencil import roll3

_E = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
_O = (0, 0, 0)


def _neg(e):
    return tuple(-v for v in e)


def _level1(Q, fe: BluePhaseFE, factored: bool = False):
    """(h, pth), 3x3 lists: molecular field and stress (with the active
    part where the free energy has one) at a site, from Q(n, dx, dy, dz),
    component n of Q at an offset from that site (|offset| <= 1).  With
    `factored`, through the free energy's factored form (the bound's
    operation count; rounding differs)."""
    q1 = [Q(n, *_O) for n in range(5)]
    nb = [[(Q(n, *e), Q(n, *_neg(e))) for n in range(5)] for e in _E]
    grad1 = [[0.5 * (up - dn) for up, dn in nb[ax]] for ax in range(3)]
    dsq1 = [sum(nb[ax][n][0] + nb[ax][n][1] for ax in range(3))
            - 6.0 * q1[n] for n in range(5)]
    fields = {"q": q1, "grad_q": grad1, "delsq_q": dsq1}
    if factored:
        h, pth = fe.field_and_stress_factored(fields)
    else:
        h = fe.molecular_field(fields)
        pth = fe.stress(fields, h=h)
    sa = fe.active_stress(fields)
    if sa is not None:
        pth = [[pth[a][b] + sa[a][b] for b in range(3)] for a in range(3)]
    return h, pth


def _lc_site(Q, U, S, H, gamma, xi, select):
    """(q5' (5 values), force (3 values)) at one site.

    Q(n, dx, dy, dz) and U(a, dx, dy, dz) give Q_n and u_a at an offset,
    S(a, b, dx, dy, dz) the level-1 stress pth[a][b] there (only
    b = the offset's axis is read), H(n) the site's own molecular field
    in 5-component form, select(x, p, q) p where x > 0 else q.  Force =
    -div pth by central differences; dQ = Gamma H + S(W, Q) - div of the
    order-1 upwind face fluxes (face velocity 0.5 (u_i + u_{i+e}))."""
    force = []
    for a in range(3):
        acc = None
        for ax, e in enumerate(_E):
            d = 0.5 * (S(a, ax, *e) - S(a, ax, *_neg(e)))
            acc = d if acc is None else acc + d
        force.append(-acc)

    w = [[0.5 * (U(a, *e) - U(a, *_neg(e))) for e in _E] for a in range(3)]
    q5 = [Q(n, *_O) for n in range(5)]
    s5 = _s5_corotation(q5_to_q33(q5), w, xi)

    faces = []
    for ax, e in enumerate(_E):
        u0 = U(ax, *_O)
        faces.append((0.5 * (u0 + U(ax, *e)), 0.5 * (U(ax, *_neg(e)) + u0)))
    qnew = []
    for n in range(5):
        div = None
        for (uf_hi, uf_lo), e in zip(faces, _E):
            f_hi = uf_hi * select(uf_hi, q5[n], Q(n, *e))
            f_lo = uf_lo * select(uf_lo, Q(n, *_neg(e)), q5[n])
            d = f_hi - f_lo
            div = d if div is None else div + d
        qnew.append(q5[n] + gamma * H(n) + s5[n] - div)
    return qnew, force


def _where_pos(x, p, q):
    return torch.where(x > 0.0, p, q)


def _lc_q_force_plain(q5: torch.Tensor, u: torch.Tensor, fe: BluePhaseFE,
                      gamma: float):
    """Twin of K1 on whole tensors: (q5' (5, X, Y, Z), force (3, X, Y,
    Z))."""
    def shift(x, o):    # value at i + o, periodic
        return roll3(x, _neg(o))

    h, pth = _level1(lambda n, *o: shift(q5[n], o), fe)
    h5 = q33_to_q5(h)
    qnew, force = _lc_site(lambda n, *o: shift(q5[n], o),
                           lambda a, *o: shift(u[a], o),
                           lambda a, b, *o: shift(pth[a][b], o),
                           lambda n: h5[n], gamma, fe.xi, _where_pos)
    return torch.stack(qnew), torch.stack(force)


def _check_fields(q5: torch.Tensor, u: torch.Tensor):
    if q5.dim() != 4 or q5.shape[0] != 5:
        raise ValueError(f"q5 must be (5, X, Y, Z), got {tuple(q5.shape)}")
    if q5.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"q5 must be float32 or float64, got {q5.dtype}")
    if tuple(u.shape) != (3,) + tuple(q5.shape[1:]):
        raise ValueError(f"u must be (3, X, Y, Z) = "
                         f"{(3,) + tuple(q5.shape[1:])}, got {tuple(u.shape)}")
    if u.dtype != q5.dtype or u.device != q5.device:
        raise TypeError("u must have q5's dtype and device")
    if not (q5.is_contiguous() and u.is_contiguous()):
        raise ValueError("q5 and u must be C-contiguous (z fastest)")


def lc_q_force_step(q5: torch.Tensor, u: torch.Tensor, fe: BluePhaseFE,
                    gamma: float):
    """(q5', force): one fused Q-side update (K1) from q5 and the previous
    step's collision-time velocity u."""
    _check_fields(q5, u)
    if q5.device.type == "cpu":
        return _lc_q_force_plain(q5, u, fe, gamma)
    if q5.device.type == "cuda":
        return _cuda.lc_q_force_step(q5, u, fe, gamma)
    raise ValueError(f"no lc_q_force_step for device {q5.device}")


def _check_fused(lcfg: LCConfig):
    """The kernels take what the JAX package's fused gate admits: order-1
    advection, the 7-point fluid stencil, hydrodynamics on, no walls, no
    redshift update and no electric field."""
    if lcfg.advection_order != 1:
        raise ValueError("the fused LC step has order-1 advection only, "
                         f"got order {lcfg.advection_order}")
    if (lcfg.gradient != GRADIENT or lcfg.has_walls
            or not lcfg.hydrodynamics or lcfg.redshift_update
            or any(lcfg.fe.e0)):
        raise ValueError("the fused LC step takes the periodic 7-point, "
                         "hydrodynamics-on blue phase with a fixed redshift "
                         "and no electric field")


def make_fused_lc_step(lcfg: LCConfig):
    """Fused LC step: state (f, q5, u) -> state, K1 then K2.

    Periodic fluid, 7-point gradients, order-1 upwind advection,
    hydrodynamics on: the blue-phase benchmark configuration.  The
    sheared variant is make_fused_lc_le_step; the sharded one of the JAX
    package is not ported."""
    _check_fused(lcfg)
    model = lcfg.lb.model
    params = lcfg.lb.collision_params()

    def step(state, t=0):
        del t
        f, q5, u = state
        q5, force = lc_q_force_step(q5, u, lcfg.fe, lcfg.gamma)
        f, u = fused_force_step(f, force, model, params)
        return (f, q5, u)

    return step


def make_fused_lc_le_step(lcfg: LCConfig, le):
    """Fused LC step under Lees-Edwards shear: state (f, q5, u) -> state.

    The sheared blue phase is the reference's production configuration
    (ref: model_le.c:57 with the q-tensor branch of ludwig.c).  The two
    kernels run unmodified, x plain periodic; the shear enters as
    O(planes Y Z) column work: lc.make_lc_le_column_fix rewrites the
    plane-adjacent columns of q5' and the force between K1 and K2, and
    ops/lees_edwards.apply_le_fused reprojects and displaces the
    crossing populations of K2's output."""

    _check_fused(lcfg)
    model = lcfg.lb.model
    params = lcfg.lb.collision_params()
    fix = make_lc_le_column_fix(lcfg, le)
    post = make_le_post(model, le)

    def step(state, t=0):
        f, q5, u = state
        q5_new, force = lc_q_force_step(q5, u, lcfg.fe, lcfg.gamma)
        (qidx, qcols), (fidx, fcols) = fix(q5, u, t)
        q5_new.index_copy_(1, qidx, qcols)
        force.index_copy_(1, fidx, fcols)
        f, u_new = fused_force_step(f, force, model, params)
        return (post(f, t), q5_new, u_new)

    return step


def initial_fused_lc(lcfg: LCConfig, q0_field):
    """(f at rest, q5, u = 0): the unpadded state of the fused step, the
    same tensors as lc.initial_lc."""
    return initial_lc(lcfg, q0_field)
