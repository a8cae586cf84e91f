"""Carry a ludwig_tpu state and configuration into the port.

Values cross as numpy arrays and plain Python values, so this module
needs neither JAX nor ludwig_tpu: a caller that has both packages (the
parity tests) converts on its side and passes the values in.  Like every
entry point of the port, the results land on the GPU unless the caller
asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ludwig_tpu_torch.binary import BinaryConfig
from ludwig_tpu_torch.binary_lb import BinaryLBConfig
from ludwig_tpu_torch.colloids import ColloidParams, ColloidState
from ludwig_tpu_torch.electro import ElectroConfig
from ludwig_tpu_torch.electro_sim import ElectroSimConfig
from ludwig_tpu_torch.electro_symm import ElectroSymmConfig
from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE
from ludwig_tpu_torch.fe.brazovskii import BrazovskiiFE
from ludwig_tpu_torch.fe.electro_symmetric import ElectroSymmetricFE
from ludwig_tpu_torch.fe.lc_droplet import LCDropletFE
from ludwig_tpu_torch.fe.polar_active import PolarActiveFE
from ludwig_tpu_torch.fe.surfactant import SurfactantFE
from ludwig_tpu_torch.fe.symmetric import SymmetricFE
from ludwig_tpu_torch.fe.ternary import TernaryFE
from ludwig_tpu_torch.lc import LCConfig
from ludwig_tpu_torch.lc_droplet import LCDropletConfig
from ludwig_tpu_torch.lb import DTYPES, LBConfig
from ludwig_tpu_torch.noise import NoiseConfig
from ludwig_tpu_torch.ops.collide import RelaxationScheme
from ludwig_tpu_torch.ops.fused import FusedNoise
from ludwig_tpu_torch.ops.lc_anchor import AnchoringParams
from ludwig_tpu_torch.ops.walls import WallSpec
from ludwig_tpu_torch.polar import PolarConfig
from ludwig_tpu_torch.two_field import TwoFieldConfig
from ludwig_tpu_torch.visc import ViscArrhenius

# pad widths of the JAX package's fused binary, LC and droplet states
# (ops/fused.py HX, HY for f; ops/fused_lc.py HX, HY for phi and q)
_F_PAD = (1, 8)
_PHI_PAD = (2, 8)


def _tensor(a: np.ndarray, device, dtype) -> torch.Tensor:
    if isinstance(dtype, str):
        dtype = DTYPES[dtype]
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def state_from_jax(f: np.ndarray, device, dtype) -> torch.Tensor:
    """An unpadded (nvel, X, Y, Z) distribution array as a contiguous
    tensor on `device`; `dtype` a torch dtype or its name."""
    f = np.asarray(f)
    if f.ndim != 4:
        raise ValueError(f"want an unpadded (nvel, X, Y, Z) state, "
                         f"got shape {f.shape}")
    return _tensor(f, device, dtype)


def params_from_jax(lb_cfg_fields: dict, device="cuda") -> LBConfig:
    """LBConfig from the fields of a ludwig_tpu LBConfig (for example
    ``{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}``).
    The relaxation scheme may be the JAX package's enum or its value, the
    noise a JAX NoiseConfig, its fields as a dict, or None."""
    fields = dict(lb_cfg_fields)
    scheme = fields.get("scheme", RelaxationScheme.M10)
    fields["scheme"] = RelaxationScheme(getattr(scheme, "value", scheme))
    for key in ("size", "force_global", "walls", "wall_u"):
        if key in fields:
            fields[key] = tuple(fields[key])
    if fields.get("noise") is not None:
        fields["noise"] = NoiseConfig(**_fields_of(fields["noise"]))
    fields["device"] = str(device)
    return LBConfig(**fields)


def noise_state_from_jax(nstate, device="cuda") -> torch.Tensor:
    """The JAX package's per-site KISS state, a (4, X, Y, Z) uint32 array
    as numpy, as the port's int64 tensor of the same words on `device`."""
    a = np.asarray(nstate)
    if a.ndim != 4 or a.shape[0] != 4 or a.dtype != np.uint32:
        raise ValueError(f"want a (4, X, Y, Z) uint32 KISS state, got "
                         f"{a.dtype} {a.shape}")
    return torch.as_tensor(a.astype(np.int64), device=device)


def fused_noise_from_jax(fnz) -> FusedNoise:
    """The port's FusedNoise from a JAX FusedNoise (or its fields as a
    dict)."""
    fields = _fields_of(fnz)
    return FusedNoise(seed=int(fields["seed"]), v_eta=float(fields["v_eta"]),
                      v_bulk=float(fields["v_bulk"]),
                      v_ghost=tuple(float(v) for v in fields["v_ghost"]))


def _unpad_xy(a: np.ndarray, hx: int, hy: int) -> np.ndarray:
    return a[..., hx:a.shape[-3] - hx, hy:a.shape[-2] - hy, :]


def binary_state_from_jax(fpad, ppad, u, device, dtype):
    """The JAX fused binary state (fpad (nvel, X+2, Y+16, Z), ppad
    (X+4, Y+16, Z), u (3, X, Y, Z); z is not lane-padded on that path)
    as the port's unpadded (f, phi, u): the work of
    ops/fused.unpad_state and ops/fused_binary.unpad_phi, in numpy."""
    f = _unpad_xy(np.asarray(fpad), *_F_PAD)
    phi = _unpad_xy(np.asarray(ppad), *_PHI_PAD)
    u = np.asarray(u)
    if f.ndim != 4 or phi.shape != f.shape[1:] or u.shape != (3,) + phi.shape:
        raise ValueError(f"inconsistent padded binary state: f {f.shape}, "
                         f"phi {phi.shape}, u {u.shape}")
    return tuple(_tensor(a, device, dtype) for a in (f, phi, u))


def _take_inactive(fields: dict, inactive: dict, what: str):
    """Pop the fields of features the port has not taken over; each must
    be at its inactive default."""
    for key, off in inactive.items():
        value = fields.pop(key, off)
        if (tuple(value) if isinstance(value, (list, tuple)) else value) \
                != off:
            raise NotImplementedError(f"{what}.{key} = {value!r} is "
                                      "not ported yet, see ROADMAP")


def _lb_from_jax(lb, device) -> LBConfig:
    if dataclasses.is_dataclass(lb):
        lb = {f.name: getattr(lb, f.name) for f in dataclasses.fields(lb)}
    return params_from_jax(lb, device)


def binary_params_from_jax(bcfg_fields: dict, device="cuda") -> BinaryConfig:
    """BinaryConfig from the fields of a ludwig_tpu BinaryConfig, for
    example ``dataclasses.asdict(bcfg)``: "lb" the LBConfig's fields
    (its noise a NoiseConfig's fields), "fe" the symmetric free energy's
    a, b and kappa (a dict or an object with those attributes), the
    mobility, advection order, stencil, hydrodynamics switch, force
    method, external chemical-potential gradient, "visc_model" an
    Arrhenius model's eta_minus, eta_plus and phistar (or None) and the
    wetting (C, H), floats or per-site arrays (tensors on `device` in the
    lattice's dtype).  A free energy with a fourth coefficient c is the
    Brazovskii one."""
    fields = dict(bcfg_fields)
    fe = _fields_of(fields.pop("fe"))
    fe = (BrazovskiiFE(**fe) if set(fe) == {"a", "b", "kappa", "c"}
          else SymmetricFE(**fe))
    lb = _lb_from_jax(fields.pop("lb"), device)
    visc = fields.get("visc_model")
    if visc is not None:
        fields["visc_model"] = ViscArrhenius(**_fields_of(visc))
    wet = fields.get("wetting", (0.0, 0.0))
    fields["wetting"] = tuple(
        float(w) if np.ndim(w) == 0 else _tensor(np.asarray(w), device,
                                                  lb.dtype)
        for w in wet)
    if "gradmu_ex" in fields:
        fields["gradmu_ex"] = tuple(float(g) for g in fields["gradmu_ex"])
    return BinaryConfig(lb=lb, fe=fe, **fields)


def state_leaves_from_jax(state, device, dtype):
    """A JAX state whose leaves are unpadded as the port's: the KISS
    states (uint32) as the port's int64 words, the other leaves in
    `dtype`.  That is every unfused state: the binary fluid's (f, phi,
    u[, gwall][, nstate_phi][, nstate_rho]), the two-field fluids' (f,
    phi, psi, u[, gwall]), symmetric_lb's (f, g, u[, gwall][, nstate][,
    grad, delsq]), the polar gel's (f, p, u) and fe_electro_symmetric's
    (f, phi, psi, rho_k, u)."""
    return tuple(noise_state_from_jax(a, device)
                 if np.asarray(a).dtype == np.uint32
                 else _tensor(np.asarray(a), device, dtype) for a in state)



def two_field_params_from_jax(tcfg_fields: dict,
                              device="cuda") -> TwoFieldConfig:
    """TwoFieldConfig from the fields of a ludwig_tpu TwoFieldConfig, for
    example ``dataclasses.asdict(tcfg)``: "lb" the LBConfig's fields, "fe"
    the surfactant free energy's (a, b, kappa, kt, epsilon, beta, w) or
    the ternary one's (alpha, kappa1..3, h1..3), a dict or an object with
    those attributes, then the two mobilities, the advection order, the
    stencil, the hydrodynamics switch and the force method."""
    fields = dict(tcfg_fields)
    fe = _fields_of(fields.pop("fe"))
    fe = TernaryFE(**fe) if "alpha" in fe else SurfactantFE(**fe)
    fields["mobilities"] = tuple(float(m) for m in fields["mobilities"])
    return TwoFieldConfig(lb=_lb_from_jax(fields.pop("lb"), device), fe=fe,
                          **fields)


def binary_lb_params_from_jax(l2cfg_fields: dict,
                              device="cuda") -> BinaryLBConfig:
    """BinaryLBConfig (symmetric_lb) from the fields of a ludwig_tpu
    BinaryLBConfig, for example ``dataclasses.asdict(l2cfg)``: "lb" the
    LBConfig's fields (its noise a NoiseConfig's), "fe" the symmetric
    free energy's a, b and kappa, the mobility and the stencil."""
    fields = dict(l2cfg_fields)
    fe = SymmetricFE(**_fields_of(fields.pop("fe")))
    return BinaryLBConfig(lb=_lb_from_jax(fields.pop("lb"), device), fe=fe,
                          **fields)


def polar_params_from_jax(pcfg_fields: dict, device="cuda") -> PolarConfig:
    """PolarConfig from the fields of a ludwig_tpu PolarConfig, for
    example ``dataclasses.asdict(pcfg)``: "lb" the LBConfig's fields, "fe"
    the polar active free energy's (a, b, kappa1, delta, lambda_, zeta),
    the rotational mobility gamma, the swimming speed, the advection
    order, the stencil and the hydrodynamics switch."""
    fields = dict(pcfg_fields)
    fe = PolarActiveFE(**_fields_of(fields.pop("fe")))
    return PolarConfig(lb=_lb_from_jax(fields.pop("lb"), device), fe=fe,
                       **fields)


def _electro_config(ek) -> ElectroConfig:
    ek = _fields_of(ek)
    for key in ("valency", "diffusivity"):
        ek[key] = tuple(ek[key])
    return ElectroConfig(**ek)


def electro_symm_params_from_jax(escfg_fields: dict,
                                 device="cuda") -> ElectroSymmConfig:
    """ElectroSymmConfig (fe_electro_symmetric) from the fields of a
    ludwig_tpu ElectroSymmConfig, for example ``dataclasses.asdict(
    escfg)``: "lb" the LBConfig's fields, "ek" the ElectroConfig's, "fe"
    the coupled free energy's (its "symm" the symmetric free energy's,
    "electro" an ElectroConfig's, the two permittivities and deltamu),
    then the mobility, the advection order, the stencil, the external
    field, the hydrodynamics switch and the force method."""
    fields = dict(escfg_fields)
    fe = _fields_of(fields.pop("fe"))
    fe = ElectroSymmetricFE(
        symm=SymmetricFE(**_fields_of(fe["symm"])),
        electro=_electro_config(fe["electro"]),
        epsilon1=float(fe["epsilon1"]), epsilon2=float(fe["epsilon2"]),
        deltamu=tuple(float(d) for d in fe["deltamu"]))
    if "e0" in fields:
        fields["e0"] = tuple(float(v) for v in fields["e0"])
    return ElectroSymmConfig(lb=_lb_from_jax(fields.pop("lb"), device),
                             ek=_electro_config(fields.pop("ek")), fe=fe,
                             **fields)


def lc_state_from_jax(fpad, qpad, u, device, dtype):
    """The JAX fused LC state (fpad (nvel, X+2, Y+16, Z), qpad
    (5, X+4, Y+16, Z), u (3, X, Y, Z)) as the port's unpadded
    (f, q5, u): the work of ops/fused.unpad_state and
    ops/fused_lc.unpad_q, in numpy."""
    f = _unpad_xy(np.asarray(fpad), *_F_PAD)
    q5 = _unpad_xy(np.asarray(qpad), *_PHI_PAD)
    u = np.asarray(u)
    if (f.ndim != 4 or q5.shape != (5,) + f.shape[1:]
            or u.shape != (3,) + f.shape[1:]):
        raise ValueError(f"inconsistent padded LC state: f {f.shape}, "
                         f"q {q5.shape}, u {u.shape}")
    return tuple(_tensor(a, device, dtype) for a in (f, q5, u))


def _fields_of(x) -> dict:
    """A dataclass's fields (or a dict) as a new dict."""
    if isinstance(x, dict):
        return dict(x)
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def _blue_phase_from_jax(fe, efield: bool = True) -> BluePhaseFE:
    """The blue-phase free energy; the droplet's (efield False) takes no
    electric field."""
    fe = _fields_of(fe)
    inactive = {"zeta2": 0.0}
    if not efield:
        inactive.update(epsilon=0.0, e0=(0.0, 0.0, 0.0))
    _take_inactive(fe, inactive, "BluePhaseFE")
    if efield:
        fe["e0"] = tuple(float(v) for v in fe.get("e0", (0.0, 0.0, 0.0)))
    return BluePhaseFE(**fe)


def _tuples(d: dict) -> dict:
    """A dataclass's fields with its lists as tuples (dataclasses.asdict
    keeps tuples, a JSON round trip does not)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _wallspec_from_jax(ws) -> Optional[WallSpec]:
    return None if ws is None else WallSpec(**_tuples(_fields_of(ws)))


def _anchoring_from_jax(anch) -> Optional[AnchoringParams]:
    return None if anch is None else AnchoringParams(
        **_tuples(_fields_of(anch)))


def lc_params_from_jax(lcfg_fields: dict, device="cuda") -> LCConfig:
    """LCConfig from the fields of a ludwig_tpu LCConfig, for example
    ``dataclasses.asdict(lcfg)``: "lb" the LBConfig's fields, "fe" the
    blue-phase free energy's (the electric field's epsilon and e0
    included), the rotational mobility, the advection order, the stencil,
    hydrodynamics, the walls, the anchoring, the redshift update, the Q
    noise (noise_kt, noise_seed) and keep_grads (a dict or an object with
    those attributes each)."""
    fields = dict(lcfg_fields)
    fe = _blue_phase_from_jax(fields.pop("fe"))
    fields["wallspec"] = _wallspec_from_jax(fields.get("wallspec"))
    fields["anchoring"] = _anchoring_from_jax(fields.get("anchoring"))
    return LCConfig(lb=_lb_from_jax(fields.pop("lb"), device), fe=fe,
                    **fields)


def lc_colloid_state_from_jax(state, device="cuda", dtype=None) -> tuple:
    """The JAX package's LC colloid state (f, R, V, W, dr, Rmap, M, q5, u,
    grad_q, delsq_q[, gwall]) (ludwig_tpu lc_colloid.py:99), its leaves as
    numpy arrays, as the port's tuple of the same leaves in `dtype`
    (default: f's)."""
    leaves = [np.asarray(x) for x in state]
    if len(leaves) not in (11, 12):
        raise ValueError(f"an LC colloid state has 11 or 12 leaves, not "
                         f"{len(leaves)}")
    dtype = dtype or str(leaves[0].dtype)
    return tuple(_tensor(a, device, dtype) for a in leaves)


def _colloid_tuple_from_jax(state, lengths, what, device, dtype):
    leaves = [np.asarray(x) for x in state]
    if len(leaves) not in lengths:
        raise ValueError(f"{what} has {' or '.join(map(str, lengths))} "
                         f"leaves, not {len(leaves)}")
    dtype = dtype or str(leaves[0].dtype)
    return tuple(_tensor(a, device, dtype) for a in leaves)


def binary_colloid_state_from_jax(state, device="cuda", dtype=None) -> tuple:
    """The JAX package's binary colloid state (f, R, V, W, dr, Rmap, M,
    phi, u, grad_phi, delsq_phi[, gwall]) (ludwig_tpu
    binary_colloid.py:157), its leaves as numpy arrays, as the port's
    tuple in `dtype` (default: f's)."""
    return _colloid_tuple_from_jax(state, (11, 12), "a binary colloid state",
                                   device, dtype)


def binary_lb_colloid_state_from_jax(state, device="cuda",
                                     dtype=None) -> tuple:
    """The JAX package's symmetric_lb colloid state (f, R, V, W, dr, Rmap,
    M, g, u, dphi, grad, delsq[, gwall]) (ludwig_tpu binary_lb.py:197) as
    the port's tuple in `dtype` (default: f's)."""
    return _colloid_tuple_from_jax(state, (12, 13),
                                   "a symmetric_lb colloid state", device,
                                   dtype)


def electro_colloid_state_from_jax(state, device="cuda",
                                   dtype=None) -> tuple:
    """The JAX package's electrolyte colloid state (f, R, V, W, dr, Rmap,
    M, psi, rho, u, deltaq) (ludwig_tpu electro_colloid.py:208) as the
    port's tuple in `dtype` (default: f's)."""
    return _colloid_tuple_from_jax(state, (11,), "an electro colloid state",
                                   device, dtype)


def colloid_params_from_jax(cp_fields: dict) -> ColloidParams:
    """ColloidParams from the fields of a ludwig_tpu ColloidParams, for
    example ``dataclasses.asdict(cp)``, every sequence as tuples."""
    def deep(v):
        return tuple(deep(x) for x in v) if isinstance(v, (list, tuple)) \
            else v
    return ColloidParams(**{k: deep(v) for k, v in dict(cp_fields).items()})


def colloid_charges_from_jax(q_coll, device="cuda",
                             dtype="float64") -> torch.Tensor:
    """The particles' input charges (N, 2) (colloid_*_q0, q1; the JAX
    package's System.colloid_charge and make_electro_colloid_step's
    q_coll) as the tensor the port's electrolyte step takes."""
    return _tensor(np.asarray(q_coll, np.float64).reshape(-1, 2), device,
                   dtype)


def droplet_state_from_jax(fpad, ppad, qpad, u, device, dtype):
    """The JAX fused droplet state (fpad (nvel, X+2, Y+16, Z), ppad
    (X+4, Y+16, Z), qpad (5, X+4, Y+16, Z), u (3, X, Y, Z)) as the port's
    unpadded (f, phi, q5, u): the work of ops/fused.unpad_state,
    ops/fused_binary.unpad_phi and ops/fused_lc.unpad_q, in numpy."""
    f = _unpad_xy(np.asarray(fpad), *_F_PAD)
    phi = _unpad_xy(np.asarray(ppad), *_PHI_PAD)
    q5 = _unpad_xy(np.asarray(qpad), *_PHI_PAD)
    u = np.asarray(u)
    if (f.ndim != 4 or phi.shape != f.shape[1:]
            or q5.shape != (5,) + phi.shape or u.shape != (3,) + phi.shape):
        raise ValueError(f"inconsistent padded droplet state: f {f.shape}, "
                         f"phi {phi.shape}, q {q5.shape}, u {u.shape}")
    return tuple(_tensor(a, device, dtype) for a in (f, phi, q5, u))


def droplet_params_from_jax(dcfg_fields: dict,
                            device="cuda") -> LCDropletConfig:
    """LCDropletConfig from the fields of a ludwig_tpu LCDropletConfig, for
    example ``dataclasses.asdict(dcfg)``: "lb" the LBConfig's fields, "fe"
    the droplet free energy's (its "symm" and "lc" the symmetric and
    blue-phase free energies'; dicts or objects with those attributes),
    the two mobilities, the advection order, the gradient stencil and the
    force method.  What the port has not taken over raises, naming it."""
    fields = dict(dcfg_fields)
    fe = _fields_of(fields.pop("fe"))
    symm = _fields_of(fe.pop("symm"))
    symm = SymmetricFE(**{k: symm[k] for k in ("a", "b", "kappa")})
    fe = LCDropletFE(symm=symm, lc=_blue_phase_from_jax(fe.pop("lc"),
                                                          efield=False), **fe)
    return LCDropletConfig(lb=_lb_from_jax(fields.pop("lb"), device), fe=fe,
                           **fields)


def electro_state_from_jax(f, psi, rho, u, gwall, device, dtype):
    """The JAX electrokinetic state (f (nvel, X, Y, Z), psi (X, Y, Z), rho
    (nk, X, Y, Z), u (3, X, Y, Z), gwall (3,); none of it padded) as the
    port's (f, psi, rho, u, gwall)."""
    arrs = [np.array(a) for a in (f, psi, rho, u, gwall)]
    f, psi, rho, u, gwall = arrs
    if (f.ndim != 4 or psi.shape != f.shape[1:] or rho.ndim != 4
            or rho.shape[1:] != psi.shape or u.shape != (3,) + psi.shape
            or gwall.shape != (3,)):
        raise ValueError(f"inconsistent electrokinetic state: "
                         f"{[a.shape for a in arrs]}")
    return tuple(_tensor(a, device, dtype) for a in arrs)


def electro_params_from_jax(ecfg_fields: dict,
                            device="cuda") -> ElectroSimConfig:
    """ElectroSimConfig from the fields of a ludwig_tpu ElectroSimConfig,
    for example ``dataclasses.asdict(ecfg)``: "lb" the LBConfig's fields,
    "ek" the ElectroConfig's (a dict or an object with those fields), the
    external field, the hydrodynamics switch and the NP stencil.  The
    port's step is periodic: `periodic` must be all True."""
    fields = dict(ecfg_fields)
    ek = _electro_config(fields.pop("ek"))
    _take_inactive(fields, {"periodic": (True, True, True)},
                   "ElectroSimConfig")
    if "e0" in fields:
        fields["e0"] = tuple(float(v) for v in fields["e0"])
    return ElectroSimConfig(lb=_lb_from_jax(fields.pop("lb"), device),
                            ek=ek, **fields)


def _unpad_fused(f: np.ndarray, size) -> np.ndarray:
    """The JAX package's fused single-step state (nvel, X+2, Y+16, Zp),
    Zp the lane-padded z (ops/fused.py pad_state), as (nvel, X, Y, Z);
    an array already of the lattice's shape comes back as it is."""
    f = np.asarray(f)
    X, Y, Z = size
    if f.ndim != 4:
        raise ValueError(f"want a (nvel, X, Y, Z) state, got {f.shape}")
    if f.shape[1:] == (X, Y, Z):
        return f
    if f.shape[1:3] != (X + 2 * _F_PAD[0], Y + 2 * _F_PAD[1]):
        raise ValueError(f"state {f.shape} is neither unpadded nor padded "
                         f"for the lattice {tuple(size)}")
    return _unpad_xy(f, *_F_PAD)[..., :Z]


def wall_state_from_jax(fpad_or_f, gwall, device, dtype, size=None):
    """The JAX package's halo-wall state as the port's (f, gwall): its
    fused wall state (fpad, gwall) - pass the lattice `size` to unpad it
    - or its unfused (f, gwall)."""
    f = np.asarray(fpad_or_f)
    if size is not None:
        f = _unpad_fused(f, size)
    gwall = np.asarray(gwall)
    if f.ndim != 4 or gwall.shape != (3,):
        raise ValueError(f"inconsistent wall state: f {f.shape}, gwall "
                         f"{gwall.shape}")
    return _tensor(f, device, dtype), _tensor(gwall, device, dtype)


def le_state_from_jax(fpad_or_f, device, dtype, size=None):
    """The JAX package's Lees-Edwards state as the port's (f,): its fused
    state (fpad,) - pass the lattice `size` to unpad it - or its unfused
    (f,)."""
    f = np.asarray(fpad_or_f)
    if size is not None:
        f = _unpad_fused(f, size)
    return (state_from_jax(f, device, dtype),)


def colloid_state_from_jax(state, device="cuda", dtype=None):
    """The JAX package's ColloidState (its leaves as numpy arrays, in its
    field order: f, R, V, W, dr, Rmap, M, noise, gwall, pmap) as the
    port's, in `dtype` (default: f's).  The map cache pmap is dropped:
    the step's prepare rebuilds it from Rmap.  A KISS noise state (uint32
    words) crosses as the port's int64 words."""
    leaves = [np.asarray(x) for x in state[:7]]
    dtype = dtype or str(leaves[0].dtype)
    nstate = state[7] if len(state) > 7 else None
    gwall = state[8] if len(state) > 8 else None
    return ColloidState(*(_tensor(a, device, dtype) for a in leaves),
                        noise=None if nstate is None
                        else noise_state_from_jax(nstate, device),
                        gwall=None if gwall is None
                        else _tensor(np.asarray(gwall), device, dtype))


def _le_state(state, unpad, nfields, device, dtype):
    """A sheared state of the JAX package as the port's: its fused state,
    whose f is padded (f's lattice is not u's; u, after the nfields
    order parameters, is never padded), through `unpad`; its unfused one,
    gradient leaves and all, as it is."""
    if np.shape(state[0])[1:] != np.shape(state[1 + nfields])[1:]:
        return unpad(*state, device, dtype)
    return state_leaves_from_jax(state, device, dtype)


def binary_le_state_from_jax(state, device, dtype):
    """The JAX package's sheared binary state: its fused (fpad, ppad, u)
    unpadded as binary_state_from_jax unpads it, its unfused (f, phi, u,
    grad, delsq) as it is."""
    return _le_state(state, binary_state_from_jax, 1, device, dtype)


def lc_le_state_from_jax(state, device, dtype):
    """The JAX package's sheared LC state: its fused (fpad, qpad, u)
    unpadded as lc_state_from_jax unpads it, its unfused (f, q5, u,
    grad_q, delsq_q) as it is."""
    return _le_state(state, lc_state_from_jax, 1, device, dtype)


def droplet_le_state_from_jax(state, device, dtype):
    """The JAX package's sheared droplet state: its fused (fpad, ppad,
    qpad, u) unpadded as droplet_state_from_jax unpads it, its unfused
    (f, phi, q5, u) as it is."""
    return _le_state(state, droplet_state_from_jax, 2, device, dtype)


def checkpoint_from_jax(directory: str, step: int, names, size,
                        device="cuda") -> tuple:
    """A checkpoint the JAX package wrote (ludwig_tpu io.write_state) as
    the leaves of the port's state, in the order of `names` (for example
    ``["dist", "state01"]`` of a walled run, or ``["dist", "q", "vel",
    "state03", "state04"]`` of the unfused LC, sheared binary and sheared
    LC routes, whose gradient leaves pass as they are): `dist`, `phi` and
    `q` unpadded where the JAX package's fused routes (the sheared ones
    included) wrote their padded state, a KISS state's uint32 words as
    the port's int64.  The port reads its own
    checkpoints, which hold the unpadded layout, with
    ludwig.read_checkpoint."""
    from ludwig_tpu_torch.io import read_state

    data = read_state(directory, step, names)
    leaves = []
    for name in names:
        a = data[name]
        if name == "dist":
            a = _unpad_fused(a, size)
        elif name in ("phi", "q") and a.shape[-3:] != tuple(size):
            a = _unpad_xy(a, *_PHI_PAD)
        if a.dtype == np.uint32:
            leaves.append(noise_state_from_jax(a, device))
        else:
            leaves.append(torch.as_tensor(np.ascontiguousarray(a),
                                          device=device))
    return tuple(leaves)
