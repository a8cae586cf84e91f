"""Fused liquid-crystal droplet (phi + Q coupled) step: two kernels.

PyTorch port of the periodic single-device path of
ludwig_tpu/ops/fused_droplet.py, the reference's second headline
benchmark (the coupled droplet loop, ref: src/ludwig.c:693-742,
src/lc_droplet.c).  One step is two passes over the lattice:

  K1 droplet_phi_q_force_step: phi, q5, u -> phi', q5', raw force
      7-point gradients of phi and Q and d_a d_b phi, the gamma(phi)
      chemical potential, molecular field (+ anchoring) and qh stress,
      the body force -phi grad mu - h_bc grad Q_bc plus the divergence
      of the stress, the flux-form Cahn-Hilliard update of phi, then the
      Beris-Edwards update of Q with gamma(phi') and the pre-update
      gradients.  The TPU kernel ``_droplet_kernel`` becomes the CUDA
      kernel of csrc/droplet.cu.
  (the mean of the force over the lattice is subtracted in plain
   PyTorch: hydro_correct_momentum, a global reduction, as the JAX
   package does it outside its kernel)
  K2 ops.fused.fused_force_step: f, force -> f', u.

u is the collision-time velocity K2 wrote in the previous step (zero at
the start), so K1 runs first.  Tensors are unpadded: phi (X, Y, Z), q5
(5, X, Y, Z), u and force (3, X, Y, Z), f (nvel, X, Y, Z); periodicity
is index arithmetic.

The arithmetic is written once, below, as Python over neighbour
accessors: ``_fields`` (phi's 19-point and Q's 7-point stencils at a
site), ``_level1`` (mu, the molecular field h and the stress at a site,
from its fields) and ``_droplet_site`` (force, phi' and q5' from the
site's fields and its neighbours' level-1 values).  The twin evaluates
them on whole tensors (level 1 once, then rolled; a roll is exact);
ops/_cuda.py traces them with symbols into the kernel's straight-line
C++.  Both follow the Pallas kernel's term order (fused_droplet.py:
103-253), which is not the jnp path's (lc_droplet.py holds that), so
float64 results agree with the Pallas kernel to the last bits.
"""

from __future__ import annotations

import torch

from ludwig_tpu_torch.fe.blue_phase import q5_to_q33
from ludwig_tpu_torch.lc import _s5_corotation
from ludwig_tpu_torch.lc_droplet import (FORCE_METHOD, GRADIENT,
                                         LCDropletConfig, initial_droplet,
                                         make_droplet_le_column_fix)
from ludwig_tpu_torch.ops import _cuda
from ludwig_tpu_torch.ops.force import correct_momentum
from ludwig_tpu_torch.ops.fused import fused_force_step
from ludwig_tpu_torch.ops.lees_edwards import make_le_post
from ludwig_tpu_torch.ops.stencil import roll3

_E = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
_O = (0, 0, 0)
# d_a Q_bc from the five components: Q_zz = -Q_xx - Q_yy
_QI = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 0): 1, (1, 1): 3, (1, 2): 4,
       (2, 0): 2, (2, 1): 4}


def _neg(e):
    return tuple(-v for v in e)


def _fields(P, Q, dab: bool = True):
    """The free energy's fields at a site from P(dx, dy, dz), phi at an
    offset (|component| <= 1), and Q(n, dx, dy, dz), component n of Q at
    a face offset.  d_a d_b phi reads the 12 edge neighbours; without
    `dab` it is left out (the molecular field does not read it)."""
    phi = P(*_O)
    nb = [(P(*e), P(*_neg(e))) for e in _E]
    fields = {"phi": phi,
              "grad_phi": [0.5 * (up - dn) for up, dn in nb],
              "delsq_phi": sum(up + dn for up, dn in nb) - 6.0 * phi}
    if dab:
        rows = [[None] * 3 for _ in range(3)]
        for a in range(3):
            oa = _E[a]
            rows[a][a] = P(*_neg(oa)) - 2.0 * phi + P(*oa)
            for b in range(a + 1, 3):
                ob = _E[b]
                pp = P(*[-(oa[i] + ob[i]) for i in range(3)])
                pm = P(*[-(oa[i] - ob[i]) for i in range(3)])
                mp = P(*[(oa[i] - ob[i]) for i in range(3)])
                mm = P(*[(oa[i] + ob[i]) for i in range(3)])
                rows[a][b] = 0.25 * (pp - pm - mp + mm)
                rows[b][a] = rows[a][b]
        fields["dab_phi"] = rows
    q = [Q(n, *_O) for n in range(5)]
    qnb = [[(Q(n, *e), Q(n, *_neg(e))) for n in range(5)] for e in _E]
    fields["q"] = q
    fields["grad_q"] = [[0.5 * (up - dn) for up, dn in qnb[ax]]
                        for ax in range(3)]
    fields["delsq_q"] = [sum(qnb[ax][n][0] + qnb[ax][n][1]
                             for ax in range(3)) - 6.0 * q[n]
                         for n in range(5)]
    return fields


def _level1(F, fe):
    """(mu, h (3x3), pth (3x3)) at a site from its fields F (_fields)."""
    h = fe.molecular_field(F)
    return fe.mu(F), h, fe.stress_qh(F, h=h)


def _droplet_site(F, P, Q, U, MU, S, H, fe, be_gamma, mobility, order,
                  select):
    """(phi', q5' (5 values), raw force (3 values)) at one site.

    F holds the site's fields (_fields, d_a d_b phi not needed);
    P(dx, dy, dz), Q(n, dx, dy, dz) and U(a, dx, dy, dz) give phi, Q_n
    and u_a at a face offset; MU(dx, dy, dz) and S(a, b, dx, dy, dz) the
    level-1 mu and stress pth[a][b] at the site or a face neighbour;
    H(b, c) the site's level-1 molecular field h[b][c]; select(x, p, q)
    p where x > 0 else q.  Force = -phi grad mu - h_bc d_a Q_bc - div pth
    (central differences); phi' = phi - div of the face fluxes
    (advective, order-1 upwind or order-2 centred, minus mobility times
    the mu difference); Q' = Q + ((Gamma h(phi') + S(W, Q)) - div of the
    advective face fluxes), h(phi') the molecular field with gamma(phi')
    and the pre-update gradients."""
    phi0 = F["phi"]
    gq = F["grad_q"]
    force = []
    for a in range(3):
        gmu_a = 0.5 * (MU(*_E[a]) - MU(*_neg(_E[a])))
        v = -phi0 * gmu_a
        for b in range(3):
            for c in range(3):
                if (b, c) in _QI:
                    dq_abc = gq[a][_QI[(b, c)]]
                else:
                    dq_abc = -(gq[a][0] + gq[a][3])
                v = v - H(b, c) * dq_abc
        acc = None
        for ax, e in enumerate(_E):
            d = 0.5 * (S(a, ax, *e) - S(a, ax, *_neg(e)))
            acc = d if acc is None else acc + d
        force.append(v - acc)

    faces = []
    for ax, e in enumerate(_E):
        u0 = U(ax, *_O)
        faces.append((0.5 * (u0 + U(ax, *e)), 0.5 * (U(ax, *_neg(e)) + u0)))

    def flux_div(x0, X, diffusive=False):
        """Sum over axes of the high face's flux of the value x0
        (X(offset) at a neighbour) minus the low face's: advective, and
        with `diffusive` minus mobility times the mu difference."""
        div = None
        for (uf_hi, uf_lo), e in zip(faces, _E):
            xp, xm = X(e), X(_neg(e))
            if order == 1:
                f_hi = uf_hi * select(uf_hi, x0, xp)
                f_lo = uf_lo * select(uf_lo, xm, x0)
            else:
                f_hi = uf_hi * (0.5 * (x0 + xp))
                f_lo = uf_lo * (0.5 * (xm + x0))
            if diffusive:
                mu0 = MU(*_O)
                f_hi = f_hi - mobility * (MU(*e) - mu0)
                f_lo = f_lo - mobility * (mu0 - MU(*_neg(e)))
            d = f_hi - f_lo
            div = d if div is None else div + d
        return div

    phinew = phi0 - flux_div(phi0, lambda o: P(*o), diffusive=True)

    fields_be = dict(F)
    fields_be["phi"] = phinew
    hbe = fe.molecular_field(fields_be)
    h5 = [hbe[0][0], hbe[0][1], hbe[0][2], hbe[1][1], hbe[1][2]]
    w = [[0.5 * (U(a, *e) - U(a, *_neg(e))) for e in _E] for a in range(3)]
    q5 = F["q"]
    s5 = _s5_corotation(q5_to_q33(q5), w, fe.lc.xi)
    qnew = [q5[n] + ((be_gamma * h5[n] + s5[n])
                     - flux_div(q5[n], lambda o, n=n: Q(n, *o)))
            for n in range(5)]
    return phinew, qnew, force


def _where_pos(x, p, q):
    return torch.where(x > 0.0, p, q)


def _droplet_plain(phi, q5, u, fe, be_gamma: float, mobility: float,
                   order: int):
    """Twin of K1 on whole tensors: (phi', q5' (5, X, Y, Z), raw force
    (3, X, Y, Z))."""
    def shift(x, o):    # value at i + o, periodic
        return roll3(x, _neg(o))

    def P(*o):
        return shift(phi, o)

    def Q(n, *o):
        return shift(q5[n], o)

    F = _fields(P, Q)
    mu, h, pth = _level1(F, fe)
    phinew, qnew, force = _droplet_site(
        F, P, Q, lambda a, *o: shift(u[a], o), lambda *o: shift(mu, o),
        lambda a, b, *o: shift(pth[a][b], o), lambda b, c: h[b][c], fe,
        be_gamma, mobility, order, _where_pos)
    return phinew, torch.stack(qnew), torch.stack(force)


ORDERS = (1, 2)     # the advection orders the fused kernel takes


def fused_droplet_ok(dcfg: LCDropletConfig) -> bool:
    """Whether the kernels run this configuration (the JAX package's fused
    gate, ludwig.py:1153-1156, less its solid and noise conditions): the
    7-point stencil, the stress-divergence force, order 1 or 2."""
    return (dcfg.gradient == GRADIENT and dcfg.force_method == FORCE_METHOD
            and dcfg.advection_order in ORDERS)


def _require_fused(dcfg: LCDropletConfig):
    if not fused_droplet_ok(dcfg):
        raise ValueError(
            f"fused droplet: gradient '{dcfg.gradient}', force method "
            f"'{dcfg.force_method}', order {dcfg.advection_order} (have "
            f"'{GRADIENT}', '{FORCE_METHOD}', {ORDERS})")


def _check_fields(phi, q5, u, order: int):
    if order not in ORDERS:
        raise ValueError(f"fused droplet: advection order {order} "
                         f"(have {ORDERS})")
    if phi.dim() != 3:
        raise ValueError(f"phi must be (X, Y, Z), got {tuple(phi.shape)}")
    if phi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"phi must be float32 or float64, got {phi.dtype}")
    for name, x, n in (("q5", q5, 5), ("u", u, 3)):
        if tuple(x.shape) != (n,) + tuple(phi.shape):
            raise ValueError(f"{name} must be ({n}, X, Y, Z) = "
                             f"{(n,) + tuple(phi.shape)}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != phi.dtype or x.device != phi.device:
            raise TypeError(f"{name} must have phi's dtype and device")
    if not (phi.is_contiguous() and q5.is_contiguous()
            and u.is_contiguous()):
        raise ValueError("phi, q5 and u must be C-contiguous (z fastest)")


def droplet_phi_q_force_step(phi: torch.Tensor, q5: torch.Tensor,
                             u: torch.Tensor, fe, be_gamma: float,
                             mobility: float, order: int):
    """(phi', q5', force_raw): one fused order-parameter update (K1) from
    phi, q5 and the previous step's collision-time velocity u.  The
    caller subtracts the force's mean (hydro_correct_momentum)."""
    _check_fields(phi, q5, u, order)
    if phi.device.type == "cpu":
        return _droplet_plain(phi, q5, u, fe, be_gamma, mobility, order)
    if phi.device.type == "cuda":
        return _cuda.droplet_phi_q_force_step(phi, q5, u, fe, be_gamma,
                                              mobility, order)
    raise ValueError(f"no droplet_phi_q_force_step for device {phi.device}")


def make_fused_droplet_step(dcfg: LCDropletConfig):
    """Fused droplet step: state (f, phi, q5, u) -> state, K1, the mean
    subtraction, then K2.

    Periodic fluid, 7-point gradients, stress-divergence force, advection
    order 1 or 2 (fused_droplet_ok; anything else raises).  The sheared
    variant is make_fused_droplet_le_step; the sharded one of the JAX
    package is not ported."""
    _require_fused(dcfg)
    model = dcfg.lb.model
    params = dcfg.lb.collision_params()

    def step(state, t=0):
        del t
        f, phi, q5, u = state
        phi, q5, force = droplet_phi_q_force_step(
            phi, q5, u, dcfg.fe, dcfg.gamma, dcfg.mobility,
            dcfg.advection_order)
        # the mean of the whole raw force: the stress divergence
        # telescopes, so this is the jnp path's body-force-only mean to
        # round-off
        f, u = fused_force_step(f, correct_momentum(force), model, params)
        return (f, phi, q5, u)

    return step


def make_fused_droplet_le_step(dcfg: LCDropletConfig, le):
    """Fused droplet step under Lees-Edwards shear: state (f, phi, q5, u)
    -> state (ref: lc_droplet.c + model_le.c:57).

    K1 runs unmodified, x plain periodic; lc_droplet.
    make_droplet_le_column_fix rewrites the plane-adjacent columns of
    phi', q5' and the force, then the force's mean is subtracted (after
    the fix: the LE flux divergence sums to its round-off after the
    per-plane mean fix), K2 runs, and ops/lees_edwards.apply_le_fused
    reprojects and displaces the crossing populations of its output."""
    _require_fused(dcfg)
    model = dcfg.lb.model
    params = dcfg.lb.collision_params()
    fix = make_droplet_le_column_fix(dcfg, le)
    post = make_le_post(model, le)

    def step(state, t=0):
        f, phi, q5, u = state
        phi_new, q5_new, force = droplet_phi_q_force_step(
            phi, q5, u, dcfg.fe, dcfg.gamma, dcfg.mobility,
            dcfg.advection_order)
        idx, pcols, qcols, fcols = fix(phi, q5, u, t)
        phi_new.index_copy_(0, idx, pcols)
        q5_new.index_copy_(1, idx, qcols)
        force.index_copy_(1, idx, fcols)
        f, u_new = fused_force_step(f, correct_momentum(force), model,
                                    params)
        return (post(f, t), phi_new, q5_new, u_new)

    return step


def initial_fused_droplet(dcfg: LCDropletConfig, phi0, q0_field):
    """(f at rest, phi, q5, u = 0): the unpadded state of the fused step,
    the same tensors as lc_droplet.initial_droplet."""
    return initial_droplet(dcfg, phi0, q0_field)
