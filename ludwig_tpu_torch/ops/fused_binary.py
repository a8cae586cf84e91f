"""Fused binary-fluid (symmetric + Cahn-Hilliard) step: two kernels.

PyTorch port of the periodic single-device path of
ludwig_tpu/ops/fused_binary.py.  One step is two passes over the lattice:

  K1 binary_phi_force_step: phi, u -> phi', force
      7-point gradients, mu = A phi + B phi^3 - kappa del^2 phi, the
      symmetric stress and its divergence, and the flux-form CH update
      (order-1 upwind or order-2 centred advection + two-point diffusive
      flux) (ref: src/phi_cahn_hilliard.c:295 flux_mu1, :1017 ufs
      update; src/phi_force.c:274-470; src/symmetric.c).  The TPU kernel
      ``_binary_kernel`` becomes the CUDA kernel of csrc/binary_phi.cu.
  K2 ops.fused.fused_force_step: f, force -> f', u.

u is the collision-time velocity K2 wrote in the previous step (zero at
the start), so K1 runs first.  Tensors are unpadded: phi (X, Y, Z),
u and force (3, X, Y, Z), f (nvel, X, Y, Z); periodicity is index
arithmetic.

The arithmetic is written once, below, as Python over neighbour
accessors, in two functions: ``_level1_march`` (mu and the stress of a
site from phi's 7-point stencil) and ``_binary_site`` (force and phi'
from phi, u and the neighbours' mu and stress).  The twin evaluates them
on whole tensors (level 1 once, then rolled; a roll is exact, so this
equals recomputing it per neighbour); ops/_cuda.py traces them with
symbols into the kernel's straight-line C++.  Both follow the Pallas kernel's
term order (fused_binary.py:106-158), so float64 results agree with it
to the last bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ludwig_tpu_torch.binary import BinaryConfig, initial_binary
from ludwig_tpu_torch.binary_le import make_binary_le_column_fix
from ludwig_tpu_torch.ops import _cuda
from ludwig_tpu_torch.ops.fused import fused_force_step
from ludwig_tpu_torch.ops.lees_edwards import make_le_post
from ludwig_tpu_torch.ops.stencil import roll3

ORDERS = (1, 2)     # the advection orders the fused kernels take

_E = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
_O = (0, 0, 0)


class _Consts(NamedTuple):
    """Free-energy and mobility constants as the Pallas kernel folds
    them (Python-float products such as 0.5 * A are formed once)."""

    a: object
    b: object
    kappa: object
    mob: object
    ha: object      # 0.5 * a
    b34: object     # 0.75 * b
    hk: object      # 0.5 * kappa


def _consts(fe, mobility) -> _Consts:
    return _Consts(fe.a, fe.b, fe.kappa, mobility, 0.5 * fe.a, 0.75 * fe.b,
                   0.5 * fe.kappa)


def _off(o, e, s=1):
    return (o[0] + s * e[0], o[1] + s * e[1], o[2] + s * e[2])


def _level1(P, o, c: _Consts):
    """(phi, grad phi (3), mu, p0) at offset o from phi there and at its
    6 neighbours, P(dx, dy, dz) giving phi at an offset; p0 is the
    isotropic part of the symmetric stress."""
    phi = P(*o)
    nb = [(P(*_off(o, e)), P(*_off(o, e, -1))) for e in _E]
    grad = [0.5 * (up - dn) for up, dn in nb]
    dsq = ((nb[0][0] + nb[0][1]) + (nb[1][0] + nb[1][1])
           + (nb[2][0] + nb[2][1]) - 6.0 * phi)
    mu = c.a * phi + c.b * phi * phi * phi - c.kappa * dsq
    g2 = grad[0] * grad[0] + grad[1] * grad[1] + grad[2] * grad[2]
    phi2 = phi * phi
    p0 = (c.ha * phi * phi + c.b34 * (phi2 * phi2) - c.kappa * phi * dsq
          - c.hk * g2)
    return phi, grad, mu, p0


def _stress(lv, a, b, c: _Consts):
    """P_ab = p0 delta_ab + kappa (d_a phi)(d_b phi) from level-1 values."""
    _phi, grad, _mu, p0 = lv
    v = c.kappa * grad[a] * grad[b]
    return p0 + v if a == b else v


def _level1_march(P, c: _Consts):
    """(mu, pth 3x3) at a site, what the site updates of its neighbours
    read: _level1 at the site, then every component of _stress.  P(dx,
    dy, dz) gives phi at an offset (|offset| <= 1)."""
    lv = _level1(P, _O, c)
    return lv[2], [[_stress(lv, a, b, c) for b in range(3)]
                   for a in range(3)]


def _binary_site(P, U, S, MU, c: _Consts, order: int, select):
    """(phi', [Fx, Fy, Fz]) at one site.

    P(dx, dy, dz) and U(a, dx, dy, dz) give phi and u_a at an offset,
    S(a, b, dx, dy, dz) the level-1 stress pth[a][b] there (only b = the
    offset's axis is read), MU(dx, dy, dz) the level-1 mu (|offset| <=
    1), select(x, p, q) p where x > 0 else q.  Force = -div P by central
    differences of the neighbours' stress; the CH update subtracts, per
    axis, the east face flux minus the west one, each advective (face
    velocity 0.5 (u_i + u_{i+e})) minus M (mu_{i+e} - mu_i)."""
    force = []
    for a in range(3):
        acc = None
        for ax, e in enumerate(_E):
            d = 0.5 * (S(a, ax, *_off(_O, e)) - S(a, ax, *_off(_O, e, -1)))
            acc = d if acc is None else acc + d
        force.append(-acc)

    phi0, mu0 = P(*_O), MU(*_O)
    div = None
    for ax, e in enumerate(_E):
        pe, me = _off(_O, e), _off(_O, e, -1)
        u0 = U(ax, *_O)
        uf_i = 0.5 * (u0 + U(ax, *pe))
        uf_im = 0.5 * (U(ax, *me) + u0)
        php, phm = P(*pe), P(*me)
        if order == 1:
            adv_i = uf_i * select(uf_i, phi0, php)
            adv_im = uf_im * select(uf_im, phm, phi0)
        else:
            adv_i = uf_i * (0.5 * (phi0 + php))
            adv_im = uf_im * (0.5 * (phm + phi0))
        flux_i = adv_i - c.mob * (MU(*pe) - mu0)
        flux_im = adv_im - c.mob * (mu0 - MU(*me))
        d = flux_i - flux_im
        div = d if div is None else div + d
    return phi0 - div, force


def _where_pos(x, p, q):
    return torch.where(x > 0.0, p, q)


def _binary_phi_force_plain(phi: torch.Tensor, u: torch.Tensor, fe,
                            mobility: float, order: int):
    """Twin of K1 on whole tensors: (phi', force (3, X, Y, Z))."""
    c = _consts(fe, mobility)

    def shift(x, o):    # value at i + o, periodic
        return roll3(x, tuple(-v for v in o))

    mu, pth = _level1_march(lambda *o: shift(phi, o), c)
    phinew, force = _binary_site(
        lambda *o: shift(phi, o), lambda a, *o: shift(u[a], o),
        lambda a, b, *o: shift(pth[a][b], o), lambda *o: shift(mu, o), c,
        order, _where_pos)
    return phinew, torch.stack(force)


def _check_fields(phi: torch.Tensor, u: torch.Tensor, order: int):
    if order not in ORDERS:
        raise ValueError(f"fused binary: advection order {order} "
                         f"(have {ORDERS})")
    if phi.dim() != 3:
        raise ValueError(f"phi must be (X, Y, Z), got {tuple(phi.shape)}")
    if phi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"phi must be float32 or float64, got {phi.dtype}")
    if tuple(u.shape) != (3,) + tuple(phi.shape):
        raise ValueError(f"u must be (3, X, Y, Z) = {(3,) + tuple(phi.shape)}"
                         f", got {tuple(u.shape)}")
    if u.dtype != phi.dtype or u.device != phi.device:
        raise TypeError("u must have phi's dtype and device")
    if not (phi.is_contiguous() and u.is_contiguous()):
        raise ValueError("phi and u must be C-contiguous (z fastest)")


def binary_phi_force_step(phi: torch.Tensor, u: torch.Tensor, fe,
                          mobility: float, order: int):
    """(phi', force): one fused order-parameter update (K1) from phi and
    the previous step's collision-time velocity u."""
    _check_fields(phi, u, order)
    if phi.device.type == "cpu":
        return _binary_phi_force_plain(phi, u, fe, mobility, order)
    if phi.device.type == "cuda":
        return _cuda.binary_phi_force_step(phi, u, _consts(fe, mobility),
                                           order)
    raise ValueError(f"no binary_phi_force_step for device {phi.device}")


def fused_binary_ok(bcfg: BinaryConfig) -> bool:
    """Whether the two kernels compute bcfg's step: the options the JAX
    package's fused gate admits (ludwig_tpu ludwig.py:996-1004), less
    its plan and dtype conditions."""
    return (bcfg.lb.noise is None and bcfg.visc_model is None
            and bcfg.force_method == "stress_divergence"
            and not any(g != 0.0 for g in bcfg.gradmu_ex)
            and all(isinstance(w, (int, float)) and w == 0.0
                    for w in bcfg.wetting)
            and bcfg.gradient == "3d_7pt_fluid"
            and bcfg.advection_order in ORDERS and bcfg.hydrodynamics
            and not any(bcfg.lb.walls))


def _check_fusable(bcfg: BinaryConfig):
    if not fused_binary_ok(bcfg):
        raise ValueError("the fused binary step takes the periodic, "
                         "stress-divergence, 7-point, order 1-2, noiseless "
                         "configuration only (fused_binary_ok); use "
                         "binary.make_binary_step")


def make_fused_binary_step(bcfg: BinaryConfig):
    """Fused binary step: state (f, phi, u) -> state, K1 then K2.

    Periodic fluid, stress-divergence force, 7-point gradients, advection
    order 1 or 2, hydrodynamics on, no noise, viscosity model, wetting or
    external chemical-potential gradient (fused_binary_ok): the flagship
    spinodal configuration.  The sheared variant is
    make_fused_binary_le_step; the sharded one of the JAX package is not
    ported."""
    _check_fusable(bcfg)
    model = bcfg.lb.model
    params = bcfg.lb.collision_params()

    def step(state, t=0):
        del t
        f, phi, u = state
        phi, force = binary_phi_force_step(phi, u, bcfg.fe, bcfg.mobility,
                                           bcfg.advection_order)
        f, u = fused_force_step(f, force, model, params)
        return (f, phi, u)

    return step


def make_fused_binary_le_step(lecfg):
    """Fused binary step under Lees-Edwards shear: state (f, phi, u) ->
    state (ref: model_le.c:57 + phi_ch_le_fix_fluxes).

    The two kernels run unmodified, x plain periodic; the shear enters as
    O(planes Y Z) column work: binary_le.make_binary_le_column_fix
    rewrites the plane-adjacent columns of phi' and the force between K1
    and K2, and ops/lees_edwards.apply_le_fused reprojects and displaces
    the crossing populations of K2's output."""

    bcfg = lecfg.binary
    _check_fusable(bcfg)
    le = lecfg.le
    model = bcfg.lb.model
    params = bcfg.lb.collision_params()
    fix = make_binary_le_column_fix(lecfg)
    post = make_le_post(model, le)

    def step(state, t=0):
        f, phi, u = state
        phi_new, force = binary_phi_force_step(phi, u, bcfg.fe, bcfg.mobility,
                                               bcfg.advection_order)
        (pidx, pcols), (fidx, fcols) = fix(phi, u, t)
        phi_new.index_copy_(0, pidx, pcols)
        force.index_copy_(1, fidx, fcols)
        f, u_new = fused_force_step(f, force, model, params)
        return (post(f, t), phi_new, u_new)

    return step


def initial_fused_binary(bcfg: BinaryConfig, phi0):
    """(f at rest, phi0, u = 0): the unpadded state of the fused step,
    the same tensors as binary.initial_binary."""
    return initial_binary(bcfg, phi0)
