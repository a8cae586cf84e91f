"""Build, bind and launch the hand-written CUDA kernels (csrc/*.cu).

At first use, ``nvcc`` compiles the sources for Hopper (sm_90a) into
shared libraries with a plain C interface under ``build/kernels/``
inside the package, and ``ctypes`` loads them: ``csrc/fused_lb.cu`` once
per velocity set (the collide+stream kernels), ``csrc/binary_phi.cu``
once (the binary fluid's order-parameter kernel), ``csrc/lc_q.cu`` once
(the liquid crystal's Q-tensor kernel), ``csrc/droplet.cu`` once (the LC
droplet's coupled phi + Q kernel; the three K1 kernels march along x
with ``csrc/k1_march.cuh`` on the layout ``k1_layout`` picks),
``csrc/electro.cu`` once (the SOR Poisson solve and the Nernst-Planck +
grad-mu kernel, an x-march on the layout ``np_layout`` picks),
``csrc/stats_ref.cu`` once (the reference-ordered statistics scans).
Nothing is built or loaded when the module is imported, so the CPU tests
import it freely.

The per-site arithmetic reaches each kernel as straight-line C++
generated from the port's own Python, traced with symbols instead of
tensors: the collision from ops/fused.py (``_relax_modes``,
``_assemble_eo`` and friends) and lattice.py's tables, the binary site
update from ops/fused_binary.py (``_level1``, ``_binary_site``), the
liquid-crystal site update from ops/fused_lc.py (``_level1``,
``_lc_site``, which call fe/blue_phase.py's methods), the droplet's from
ops/fused_droplet.py (``_fields``, ``_level1``, ``_droplet_site``, which
call fe/lc_droplet.py's).  Kernel and twin
therefore evaluate the same expression tree, with the same constants.
The electrokinetic kernels and the solid variant's bounce-back are
short stencils written in the .cu files, term for term the twins of
ops/fused_electro.py and ops/fused.py.

Every launch adds one to the kernel's count in ``launches``; a caller can
reset the counts and read them back to see which kernels a run used.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import operator
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

from ludwig_tpu_torch.lattice import lb_model

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc" / "fused_lb.cu"
CSRC_BINARY = PKG_DIR / "csrc" / "binary_phi.cu"
CSRC_LC = PKG_DIR / "csrc" / "lc_q.cu"
CSRC_DROPLET = PKG_DIR / "csrc" / "droplet.cu"
CSRC_ELECTRO = PKG_DIR / "csrc" / "electro.cu"
CSRC_STATS = PKG_DIR / "csrc" / "stats_ref.cu"
BUILD_DIR = PKG_DIR / "build" / "kernels"
# -fmad=false: no mul+add contraction, so every kernel evaluates the
# generated expression tree operation by operation, like the twin.  With
# contraction the single- and n-step kernels contracted the increment
# form differently (f64 differences of ~1e-17 on an H100) and n-step
# results were no longer bitwise n single steps.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
KERNEL_NVELS = (9, 15, 19, 27)
# integer operations of the fluctuations' counter hash (csrc/fused_lb.cu
# lb_site_deviates): the site's key (3 products, a product by t, 4
# xors), then per deviate (6 + nghost of them) a xor with the mode's
# key, the murmur3 finalizer (3 shifts, 3 xors, 2 products), the 3-bit
# mask and the table select (4 compares)
NOISE_KEY_OPS, NOISE_DEVIATE_OPS = 8, 14


@dataclasses.dataclass
class LaunchCounts:
    """Kernel launches since the last reset()."""

    fused_step: int = 0
    fusedn_step: int = 0
    fused_force_step: int = 0
    binary_phi_force_step: int = 0
    lc_q_force_step: int = 0
    droplet_phi_q_force_step: int = 0
    fused_force_step_solid: int = 0
    sor_solve: int = 0
    np_gradmu: int = 0
    fused_step_noise: int = 0
    seq_sum: int = 0
    field_stats_ref: int = 0
    rho_stats_ref: int = 0
    momentum_total_ref: int = 0
    chain_sums: int = 0

    def reset(self):
        for field in dataclasses.fields(self):
            setattr(self, field.name, 0)


launches = LaunchCounts()
_libs = {}      # library name -> (loaded ctypes library, path)


# -- code generation ----------------------------------------------------------

class _Trace:
    """Records straight-line C++, one const temporary per distinct value:
    a load or an operation met again (the same operator on the same
    operands, in either order where it commutes) returns the temporary
    it already has, so `nops` counts the distinct arithmetic operations,
    loads excluded.  `consts` collects the host-folded constants (_Const)
    the code reads as p.c[k]; traces of one kernel share it.  With
    `skip_exact`, adding a Python zero and multiplying by an int +-1 emit
    nothing (or a negation): both are exact, and the free-energy text
    starts its sums from 0 and multiplies by Levi-Civita signs."""

    def __init__(self, consts=None, skip_exact=False):
        self.lines = []
        self.nops = 0
        self.values = {}        # expression text -> its _Sym
        self.consts = {} if consts is None else consts
        self.skip_exact = skip_exact

    def load(self, expr, key=None):
        key = key or expr
        if key not in self.values:
            name = f"t{len(self.lines)}"
            self.lines.append(f"  const T {name} = {expr};")
            self.values[key] = _Sym(self, name)
        return self.values[key]

    def op(self, expr, key=None):
        if (key or expr) not in self.values:
            self.nops += 1
        return self.load(expr, key)

    def lit(self, x):
        if isinstance(x, _Sym):
            return x.name
        if isinstance(x, _Const):
            k = self.consts.setdefault(x.key, (len(self.consts), x))[0]
            return f"p.c[{k}]"
        return f"T({float(x)!r})"


class _Sym:
    """A scalar of the generated code; arithmetic appends to the trace."""

    def __init__(self, trace, name):
        self.trace = trace
        self.name = name

    def _is(self, x, value):
        """x is the Python number `value`, in a trace that skips exact
        operations (+-1 as an int only: a Levi-Civita sign)."""
        kinds = (int, float) if value == 0 else (int,)
        return (self.trace.skip_exact and isinstance(x, kinds)
                and x == value)

    def _op(self, sym, o, swap=False):
        """self <sym> o, or o <sym> self with `swap`; a sum or a product
        is one value whatever the order of its operands."""
        a, b = self.name, self.trace.lit(o)
        if swap:
            a, b = b, a
        x, y = sorted((a, b)) if sym in "+*" else (a, b)
        return self.trace.op(f"{a} {sym} {b}", f"{x} {sym} {y}")

    def __add__(self, o):
        return self if self._is(o, 0) else self._op("+", o)

    def __radd__(self, o):
        return self if self._is(o, 0) else self._op("+", o, swap=True)

    def __sub__(self, o):
        return self if self._is(o, 0) else self._op("-", o)

    def __rsub__(self, o):
        return self._op("-", o, swap=True)

    def __mul__(self, o):
        if self._is(o, 1):
            return self
        return -self if self._is(o, -1) else self._op("*", o)

    def __rmul__(self, o):
        if self._is(o, 1):
            return self
        return -self if self._is(o, -1) else self._op("*", o, swap=True)

    def __truediv__(self, o):
        return self._op("/", o)

    def __rtruediv__(self, o):
        return self._op("/", o, swap=True)

    def __neg__(self):
        return self.trace.op(f"-{self.name}")


class _Const:
    """A parameter of the generated code, or a product of parameters and
    Python numbers folded on the host in double as the twin's Python
    folds them (for example a0 * (1.0 - r3 * gamma)).  `fn(base)`
    evaluates it from the named base parameters; `key` is its expression
    text.  Meeting a _Sym it becomes an entry p.c[k] of the kernel's
    constant table."""

    def __init__(self, key, fn):
        self.key = key
        self.fn = fn

    @classmethod
    def named(cls, name):
        return cls(name, lambda base: base[name])

    def _fold(self, o, sym, f, swap=False):
        """self <sym> o, or o <sym> self with `swap` (o a Python number
        then: a _Const or _Sym on the left takes the operation itself)."""
        if isinstance(o, _Sym):
            return NotImplemented
        other = o if isinstance(o, _Const) else _Const(repr(o), lambda b: o)
        x, y = (other, self) if swap else (self, other)
        return _Const(f"({x.key} {sym} {y.key})",
                      lambda b: f(x.fn(b), y.fn(b)))

    def _binary(sym, f):
        return (lambda self, o: self._fold(o, sym, f),
                lambda self, o: self._fold(o, sym, f, swap=True))

    __add__, __radd__ = _binary("+", operator.add)
    __sub__, __rsub__ = _binary("-", operator.sub)
    __mul__, __rmul__ = _binary("*", operator.mul)
    __truediv__, __rtruediv__ = _binary("/", operator.truediv)
    del _binary

    def __neg__(self):
        return _Const(f"(-{self.key})", lambda b: -self.fn(b))


def _collide_source(nvel: int, delta: bool, projected: bool,
                    noise: bool = False) -> str:
    """One device function: collide the site values f[0..nvel) and hand
    each post-collision value to emit(q, cx, cy, cz, value); with
    `noise`, add the fluctuations built from the site's unit-variance
    deviates r[0..6 + nghost) (lb_collide_noise_*)."""
    tr, emits = _collide_trace(nvel, delta, projected, noise=noise)
    if noise:
        name = f"lb_collide_noise_d{int(delta)}_p{int(projected)}"
        args = "const T* f, const T* r, const P& p, Emit& emit"
    else:
        name = f"lb_collide_d{int(delta)}_p{int(projected)}"
        args = "const T* f, const P& p, Emit& emit"
    return "\n".join(
        ["template <typename T, typename P, typename Emit>",
         f"__device__ __forceinline__ void {name}({args}) {{"]
        + tr.lines + emits + ["}", ""])


def _collide_trace(nvel: int, delta: bool, projected: bool,
                   site_force: bool = False, noise: bool = False):
    """(trace, tail lines) of one site's collision.  The force is the
    global one (p.fx, p.fy, p.fz) or, with `site_force`, the site's total
    fs[0..3) (per-site + global, summed in the kernel where the global one
    is non-zero, as ops/fused.py _collide does); then the tail also
    stores the collision-time velocity in u[0..3).  With `noise` the
    collision adds ops/fused.py _noise_sg of the deviates r[k] and the
    amplitudes p.nz_eta2, p.nz_eta, p.nz_bulk, p.nz_g[i] (each ghost
    amplitude a value, never a structural 0: the header does not depend
    on the temperature)."""
    from ludwig_tpu_torch.ops import fused

    model = lb_model(nvel)
    tr = _Trace()
    fl = [_Sym(tr, f"f[{q}]") for q in range(nvel)]
    ftot = ([_Sym(tr, f"fs[{a}]") for a in range(3)] if site_force
            else [_Sym(tr, f"p.f{a}") for a in "xyz"])
    nghost = nvel - model.nhydro
    if projected:
        # every ghost rate is 1: the JAX twin's constants exactly
        gcoef = [-1.0 if delta else 0.0] * nghost
    else:
        gcoef = [_Sym(tr, f"p.g[{i}]") for i in range(nghost)]
    noise_sg = None
    if noise:
        r = [_Sym(tr, f"r[{k}]") for k in range(6 + nghost)]
        noise_sg = fused._noise_sg(
            model, r, _Sym(tr, "p.nz_eta2"), _Sym(tr, "p.nz_eta"),
            _Sym(tr, "p.nz_bulk"),
            [_Sym(tr, f"p.nz_g[{i}]") for i in range(nghost)])
    modes, u = fused._relax_modes(model, fl, _Sym(tr, "p.rt"),
                                  _Sym(tr, "p.rtb"), ftot, [True] * 3,
                                  gcoef, delta, noise_sg)
    tail = []

    def emit(acc, q):
        cx, cy, cz = (int(c) for c in model.cv[q])
        tail.append(f"  emit({q}, {cx}, {cy}, {cz}, {acc.name});")

    if delta:
        fused._assemble_eo_deltas(model, fl, modes, emit)
    else:
        fused._assemble_eo(model, modes, emit)
    if site_force:
        tail += [f"  u[{a}] = {u[a].name};" for a in range(3)]
    return tr, tail


def _collide_force_source(nvel: int, projected: bool) -> str:
    """One device function: collide f[0..nvel) with the site force
    fs[0..3), hand each post-collision value to emit(q, cx, cy, cz,
    value) and store the collision-time velocity in u[0..3)."""
    tr, tail = _collide_trace(nvel, True, projected, site_force=True)
    return "\n".join(
        ["template <typename T, typename P, typename Emit>",
         f"__device__ __forceinline__ void lb_collide_force_p"
         f"{int(projected)}(const T* f, const T* fs, const P& p, "
         "Emit& emit, T* u) {"] + tr.lines + tail + ["}", ""])


def generate_header(nvel: int) -> str:
    """lb_generated.h for one velocity set; the fluctuating collisions
    (lb_collide_noise_*) come last, after the noiseless functions.  The
    force collisions (lb_collide_force_*) exist for the three-dimensional
    sets only: a D2Q9 header defines LB_NO_FORCE and has the one-step
    collisions with and without fluctuations, as the TPU kernels take
    D2Q9 there only."""
    model = lb_model(nvel)
    has_force = model.ndim == 3
    parts = [f"// Generated by ludwig_tpu_torch/ops/_cuda.py for "
             f"D{model.ndim}Q{nvel} from lattice.py; do not edit.",
             "#pragma once",
             f"#define LB_NVEL {nvel}",
             f"#define LB_NGHOST {nvel - model.nhydro}"]
    parts += [""] if has_force else ["#define LB_NO_FORCE", ""]
    for delta in (False, True):
        for projected in (False, True):
            parts.append(_collide_source(nvel, delta, projected))
    for projected in (False, True) if has_force else ():
        parts.append(_collide_force_source(nvel, projected))
    parts.append(_antipode_source(model))
    for delta in (False, True):
        for projected in (False, True):
            parts.append(_collide_source(nvel, delta, projected, noise=True))
    parts.append(_ring_source(model))
    return "\n".join(parts)


def _antipode_source(model) -> str:
    """lb_anti(q): the index of the velocity -c_q, a chain of compile-time
    comparisons that folds to a constant for a literal q."""
    rev = [int(r) for r in model.reverse]
    chain = "".join(f"q == {q} ? {r} : " for q, r in enumerate(rev[:-1]))
    return "\n".join([
        "__host__ __device__ __forceinline__ constexpr int lb_anti(int q) {",
        f"  return {chain}{rev[-1]};", "}", ""])


@functools.lru_cache(maxsize=None)
def _binary_trace():
    """(level-1 trace, its tail, {order: (site trace, its tail)}) of the
    binary order-parameter kernel.  The level-1 function loads P(dx, dy,
    dz) (phi, 7-point footprint) and stores mu[0] and pth[9] of one site;
    the site functions (one per advection order) load P, U(a, ...), the
    neighbours' S(a, b, ...) and MU(...), and store out[0] = phi',
    out[1..4) = the force.  The constants are p.<name> of
    ops/fused_binary._Consts."""
    from ludwig_tpu_torch.ops import fused_binary as fb

    def consts(tr):
        return fb._Consts(*(_Sym(tr, f"p.{k}") for k in fb._Consts._fields))

    tr1 = _Trace()
    load = _loader(tr1)
    mu, pth = fb._level1_march(lambda *o: load("P", *o), consts(tr1))
    tail1 = [f"  mu[0] = {mu.name};"] + [
        f"  pth[{3 * a + b}] = {pth[a][b].name};"
        for a in range(3) for b in range(3)]
    def site(order):
        tr = _Trace()
        load = _loader(tr)

        def select(x, p, q):
            return tr.op(f"sel({x.name}, {tr.lit(p)}, {tr.lit(q)})")

        phinew, force = fb._binary_site(
            lambda *o: load("P", *o), lambda *a: load("U", *a),
            lambda *a: load("S", *a), lambda *o: load("MU", *o), consts(tr),
            order, select)
        return tr, [f"  out[0] = {phinew.name};"] + [
            f"  out[{1 + a}] = {force[a].name};" for a in range(3)]

    return tr1, tail1, {order: site(order) for order in (1, 2)}


def generate_binary_header() -> str:
    """binary_generated.h: binary_level1 (mu and stress of one site) and
    binary_site_o1 / _o2 (phi' and the force, one per advection
    order)."""
    for order in (1, 2):
        k1_check_reads(BINARY_KERNEL, order)
    tr1, tail1, sites = _binary_trace()
    parts = ["// Generated by ludwig_tpu_torch/ops/_cuda.py from "
             "ops/fused_binary.py; do not edit.", "#pragma once", ""]
    parts.append("\n".join(
        ["template <typename T, typename LP>",
         "__device__ __forceinline__ void binary_level1(const LP& P, "
         "const BinParams<T>& p, T* mu, T* pth) {"]
        + tr1.lines + tail1 + ["}", ""]))
    for order, (tr2, tail2) in sites.items():
        parts.append("\n".join(
            ["template <typename T, typename LP, typename LU, typename LS, "
             "typename LM>",
             f"__device__ __forceinline__ void binary_site_o{order}("
             "const LP& P, const LU& U, const LS& S, const LM& MU, "
             "const BinParams<T>& p, T* out) {"]
            + tr2.lines + tail2 + ["}", ""]))
    return "\n".join(parts)


LC_BASE = ("a0", "gamma", "q0", "kappa0", "kappa1", "xi", "redshift",
           "zeta0", "zeta1", "be_gamma")


@functools.lru_cache(maxsize=None)
def _lc_trace(factored: bool = False):
    """(level-1 trace, its tail, site trace, its tail, constants) of the
    liquid-crystal kernel.  The level-1 function loads Q(n, dx, dy, dz)
    and stores the stress pth[9] and the molecular field h5[5] of one
    site; the site function loads Q, U(a, ...), the neighbours' stress
    S(a, b, dx, dy, dz) and its own H(n), and stores out[0..5) = q5' and
    out[5..8) = the force.  The free energy is traced with every
    parameter a _Const, the active stress included: with both zetas zero
    it adds an exact zero.  `constants` lists the table p.c[] in order,
    as _Const.  With `factored`, level 1 goes through the free energy's
    factored form: not the kernel's code, but the fewest operations this
    text knows for the same function (the bound's count)."""
    from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE
    from ludwig_tpu_torch.ops import fused_lc

    base = {k: _Const.named(k) for k in LC_BASE}
    fe = BluePhaseFE(**{k: base[k] for k in LC_BASE if k != "be_gamma"})
    consts = {}

    def loader(tr):
        return lambda name, *args: tr.load(
            f"{name}({', '.join(str(a) for a in args)})")

    tr1 = _Trace(consts, skip_exact=True)
    load = loader(tr1)
    h, pth = fused_lc._level1(lambda *a: load("Q", *a), fe, factored)
    tail1 = [f"  pth[{3 * a + b}] = {pth[a][b].name};"
             for a in range(3) for b in range(3)]
    h5 = (h[0][0], h[0][1], h[0][2], h[1][1], h[1][2])
    tail1 += [f"  h5[{n}] = {v.name};" for n, v in enumerate(h5)]

    tr2 = _Trace(consts, skip_exact=True)
    load = loader(tr2)

    def select(x, p, q):
        return tr2.op(f"sel({x.name}, {tr2.lit(p)}, {tr2.lit(q)})")

    qnew, force = fused_lc._lc_site(
        lambda *a: load("Q", *a), lambda *a: load("U", *a),
        lambda *a: load("S", *a), lambda n: load("H", n), base["be_gamma"],
        base["xi"], select)
    tail2 = [f"  out[{n}] = {v.name};" for n, v in enumerate(qnew + force)]
    table = [c for _k, c in sorted(consts.values(), key=lambda kc: kc[0])]
    return tr1, tail1, tr2, tail2, table


def lc_const_values(fe, be_gamma) -> list:
    """The kernel's constant table p.c[] for a BluePhaseFE and the
    rotational mobility, folded in double like the twin's Python."""
    base = {k: float(getattr(fe, k)) for k in LC_BASE if k != "be_gamma"}
    base["be_gamma"] = float(be_gamma)
    return [c.fn(base) for c in _lc_trace()[4]]


def generate_lc_header() -> str:
    """lc_generated.h: the constant table's size, lc_level1 (stress and
    molecular field of one site) and lc_site (force and Q update)."""
    k1_check_reads(LC_KERNEL)
    tr1, tail1, tr2, tail2, table = _lc_trace()
    parts = ["// Generated by ludwig_tpu_torch/ops/_cuda.py from "
             "ops/fused_lc.py and fe/blue_phase.py; do not edit.",
             "#pragma once", f"#define LC_NCONST {len(table)}",
             "// p.c[k], folded on the host:"]
    parts += [f"//   {k}: {c.key}" for k, c in enumerate(table)]
    parts += ["template <typename T>", "struct LcParams {",
              "  T c[LC_NCONST];", "};", ""]
    parts.append("\n".join(
        ["template <typename T, typename LQ>",
         "__device__ __forceinline__ void lc_level1(const LQ& Q, "
         "const LcParams<T>& p, T* pth, T* h5) {"]
        + tr1.lines + tail1 + ["}", ""]))
    parts.append("\n".join(
        ["template <typename T, typename LQ, typename LU, typename LS, "
         "typename LH>",
         "__device__ __forceinline__ void lc_site(const LQ& Q, const LU& U, "
         "const LS& S, const LH& H, const LcParams<T>& p, T* out) {"]
        + tr2.lines + tail2 + ["}", ""]))
    return "\n".join(parts)


DROPLET_BASE = ("a", "b", "kappa", "a0", "gamma", "q0", "kappa0", "kappa1",
                "xi", "redshift", "gamma0", "delta", "w", "zeta0", "zeta1",
                "be_gamma", "mobility")


def _droplet_fe(base):
    """An LCDropletFE whose parameters are the _Const of `base`."""
    from ludwig_tpu_torch.fe.blue_phase import BluePhaseFE
    from ludwig_tpu_torch.fe.lc_droplet import LCDropletFE
    from ludwig_tpu_torch.fe.symmetric import SymmetricFE

    lc = BluePhaseFE(**{k: base[k] for k in ("a0", "gamma", "q0", "kappa0",
                                             "kappa1", "xi", "redshift")})
    return LCDropletFE(symm=SymmetricFE(base["a"], base["b"], base["kappa"]),
                       lc=lc, **{k: base[k] for k in ("gamma0", "delta", "w",
                                                      "zeta0", "zeta1")})


def _loader(tr):
    return lambda name, *args: tr.load(
        f"{name}({', '.join(str(a) for a in args)})")


def _droplet_site_trace(order: int, consts, base, fields_loaded=False):
    """(trace, tail) of one site of the droplet update (_droplet_site).
    The site's fields are computed from its P/Q loads, as the kernel
    does, or with `fields_loaded` are loads themselves (the bound's
    count: an implementation keeping level 1's fields does not redo
    them)."""
    from ludwig_tpu_torch.ops import fused_droplet as fd

    tr = _Trace(consts, skip_exact=True)
    load = _loader(tr)

    def P(*o):
        return load("P", *o)

    def Q(n, *o):
        return load("Q", n, *o)

    def select(x, p, q):
        return tr.op(f"sel({x.name}, {tr.lit(p)}, {tr.lit(q)})")

    if fields_loaded:
        F = {"phi": P(0, 0, 0),
             "grad_phi": [load("GP", a) for a in range(3)],
             "q": [Q(n, 0, 0, 0) for n in range(5)],
             "grad_q": [[load("GQ", c, n) for n in range(5)]
                        for c in range(3)],
             "delsq_q": [load("DQ", n) for n in range(5)]}
    else:
        F = fd._fields(P, Q, dab=False)
    phinew, qnew, force = fd._droplet_site(
        F, P, Q, lambda *a: load("U", *a), lambda *a: load("MU", *a),
        lambda *a: load("S", *a), lambda *a: load("H", *a), _droplet_fe(base),
        base["be_gamma"], base["mobility"], order, select)
    tail = [f"  out[{k}] = {v.name};"
            for k, v in enumerate([phinew] + qnew + force)]
    return tr, tail


@functools.lru_cache(maxsize=None)
def _droplet_trace():
    """(level-1 trace, its tail, {order: (site trace, its tail)},
    constants) of the droplet kernel.  The level-1 function loads
    P(dx, dy, dz) (phi, 19-point footprint) and Q(n, dx, dy, dz) and
    stores mu[0], pth[9] and h[9] of one site; the site functions (one per
    advection order) load P, Q, U(a, ...), the neighbours' MU(...) and
    S(a, b, ...) and the site's own H(b, c), and store out[0] = phi',
    out[1..6) = q5', out[6..9) = the raw force.  The free energy is traced
    with every parameter a _Const, so one build serves all parameters,
    and the active stress is always added (an exact zero with both zetas
    zero).  `constants` lists the table p.c[] in order, as _Const."""
    from ludwig_tpu_torch.ops import fused_droplet as fd

    base = {k: _Const.named(k) for k in DROPLET_BASE}
    consts = {}
    tr1 = _Trace(consts, skip_exact=True)
    load = _loader(tr1)
    F = fd._fields(lambda *o: load("P", *o), lambda *a: load("Q", *a))
    mu, h, pth = fd._level1(F, _droplet_fe(base))
    tail1 = [f"  mu[0] = {mu.name};"]
    tail1 += [f"  pth[{3 * a + b}] = {pth[a][b].name};"
              for a in range(3) for b in range(3)]
    tail1 += [f"  h[{3 * a + b}] = {h[a][b].name};"
              for a in range(3) for b in range(3)]
    sites = {order: _droplet_site_trace(order, consts, base)
             for order in (1, 2)}
    table = [c for _k, c in sorted(consts.values(), key=lambda kc: kc[0])]
    return tr1, tail1, sites, table


def droplet_const_values(fe, be_gamma, mobility) -> list:
    """The droplet kernel's constant table p.c[] for an LCDropletFE, the
    rotational mobility and the phi mobility, folded in double like the
    twin's Python."""
    base = {k: float(getattr(fe.symm, k)) for k in ("a", "b", "kappa")}
    base.update({k: float(getattr(fe.lc, k))
                 for k in ("a0", "gamma", "q0", "kappa0", "kappa1", "xi",
                           "redshift")})
    base.update({k: float(getattr(fe, k))
                 for k in ("gamma0", "delta", "w", "zeta0", "zeta1")})
    base["be_gamma"], base["mobility"] = float(be_gamma), float(mobility)
    return [c.fn(base) for c in _droplet_trace()[3]]


def generate_droplet_header() -> str:
    """droplet_generated.h: the constant table's size, droplet_level1 (mu,
    stress and molecular field of one site) and droplet_site_o1 / _o2
    (force, phi' and q5')."""
    for order in (1, 2):
        k1_check_reads(DROPLET_KERNEL, order)
    tr1, tail1, sites, table = _droplet_trace()
    parts = ["// Generated by ludwig_tpu_torch/ops/_cuda.py from "
             "ops/fused_droplet.py and fe/lc_droplet.py; do not edit.",
             "#pragma once", f"#define DROPLET_NCONST {len(table)}",
             "// p.c[k], folded on the host:"]
    parts += [f"//   {k}: {c.key}" for k, c in enumerate(table)]
    parts += ["template <typename T>", "struct DropletParams {",
              "  T c[DROPLET_NCONST];", "};", ""]
    parts.append("\n".join(
        ["template <typename T, typename LP, typename LQ>",
         "__device__ __forceinline__ void droplet_level1(const LP& P, "
         "const LQ& Q, const DropletParams<T>& p, T* mu, T* pth, T* h) {"]
        + tr1.lines + tail1 + ["}", ""]))
    for order, (tr2, tail2) in sites.items():
        parts.append("\n".join(
            ["template <typename T, typename LP, typename LQ, typename LU, "
             "typename LM, typename LS, typename LH>",
             f"__device__ __forceinline__ void droplet_site_o{order}("
             "const LP& P, const LQ& Q, const LU& U, const LM& MU, "
             "const LS& S, const LH& H, const DropletParams<T>& p, T* out) {"]
            + tr2.lines + tail2 + ["}", ""]))
    return "\n".join(parts)


def ring_depths(model) -> list:
    """Slots per velocity in a ring of the n-step kernel's x-march: a
    value pushed along c_x waits 1 + c_x march steps before the next
    level reads it, so its ring holds 2 + c_x planes."""
    return [2 + int(c[0]) for c in model.cv]


def _ring_source(model) -> str:
    """lb_cx(q), lb_ring_base(q) (the first slot of velocity q in a ring)
    and LB_RING (slots of all velocities, 2 nvel for a set symmetric
    under c -> -c), as compile-time chains like lb_anti."""
    depth = ring_depths(model)
    base = [sum(depth[:q]) for q in range(model.nvel)]
    cx = [int(c[0]) for c in model.cv]

    def chain(name, vals):
        body = "".join(f"q == {q} ? {v} : " for q, v in enumerate(vals[:-1]))
        return [f"__host__ __device__ __forceinline__ constexpr int "
                f"{name}(int q) {{", f"  return {body}{vals[-1]};", "}"]

    return "\n".join([f"#define LB_RING {sum(depth)}"] + chain("lb_cx", cx)
                     + chain("lb_ring_base", base) + [""])


def site_ops(kernel: str, nvel: int = 19, order: int = 2,
             delta: bool = True) -> int:
    """Distinct arithmetic operations per site and step the function
    needs, for the bound: the M10 collision (fused_step, fusedn_step),
    the M10 collision with fluctuations (fused_step_noise: the
    collision's floating-point operations plus the integer operations of
    the counter hash), the M10 collision with a per-site force
    (fused_force_step, plus the three additions of a non-zero global
    force at most), or the binary
    site update with one level-1 evaluation per site
    (binary_phi_force_step), or the liquid-crystal update, likewise with
    one level-1 evaluation per site and the free energy in its factored
    form (lc_q_force_step), or the droplet update, with one level-1
    evaluation per site, the site's fields not recomputed, in the kernel
    text's own term order: no factored form of the droplet free energy
    is written (droplet_phi_q_force_step)."""
    if kernel in ("fused_step", "fusedn_step"):
        return _collide_trace(nvel, delta, True)[0].nops
    if kernel == "fused_step_noise":
        ndev = 6 + nvel - lb_model(nvel).nhydro
        return (_collide_trace(nvel, delta, True, noise=True)[0].nops
                + NOISE_KEY_OPS + NOISE_DEVIATE_OPS * ndev)
    if kernel == "fused_force_step":
        return _collide_trace(nvel, True, True, site_force=True)[0].nops + 3
    if kernel == "binary_phi_force_step":
        tr1, _t1, sites = _binary_trace()
        return tr1.nops + sites[order][0].nops
    if kernel == "lc_q_force_step":
        tr1, _t1, tr2, _t2, _c = _lc_trace(factored=True)
        return tr1.nops + tr2.nops
    if kernel == "droplet_phi_q_force_step":
        tr2, _tail = _droplet_site_trace(
            order, {}, {k: _Const.named(k) for k in DROPLET_BASE},
            fields_loaded=True)
        return _droplet_trace()[0].nops + tr2.nops
    raise ValueError(f"no operation count for {kernel}")


# -- build and load -----------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


BINARY_LIB = "binary_phi"
LC_LIB = "lc_q"
DROPLET_LIB = "droplet"
ELECTRO_LIB = "electro"
STATS_LIB = "stats_ref"
ELECTRO_THREADS = 256    # threads a block of csrc/electro.cu (kReduceThreads)


def _lib_name(nvel: int) -> str:
    return f"fused_lb_q{nvel}"


def _lib_path(name: str, src: Path, header: str) -> Path:
    shared = "".join(h.read_text()
                     for h in sorted(src.parent.glob("*.cuh")))
    key = hashlib.sha256((src.read_text() + shared + header
                          + " ".join(NVCC_FLAGS)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def _bind_lb(path: Path, nvel: int):
    lib = ctypes.CDLL(str(path))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dp = ctypes.POINTER(ctypes.c_double)
    lib.lb_nvel.argtypes = []
    lib.lb_nvel.restype = ci
    lib.lb_device_info.argtypes = [ci, ctypes.POINTER(ci),
                                   ctypes.POINTER(ci)]
    lib.lb_device_info.restype = ci
    lib.lb_fused_step.argtypes = [ci, ci, ci, vp, vp, ci, ci, ci, dp, dp,
                                  ctypes.c_uint32, ci, vp, ci]
    lib.lb_fused_step.restype = ci
    lib.lb_fusedn_step.argtypes = [ci, ci, ci, vp, vp, ci, ci, ci, ci, ci,
                                   ci, ci, vp, cll, ci, ci, ci, dp, vp, ci]
    lib.lb_fusedn_step.restype = ci
    lib.lb_fused_force_step.argtypes = [ci, ci, vp, vp, vp, vp, ci, ci, ci,
                                        dp, vp, ci]
    lib.lb_fused_force_step.restype = ci
    lib.lb_force_step_blocks.argtypes = [cll]
    lib.lb_force_step_blocks.restype = ci
    lib.lb_fused_force_step_solid.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp,
                                              vp, ci, ci, ci, dp, vp, ci]
    lib.lb_fused_force_step_solid.restype = ci
    if lib.lb_nvel() != nvel:
        raise RuntimeError(f"{path} was built for nvel={lib.lb_nvel()}")
    return lib


def _bind_lc(path: Path):
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lb_lc_nconst.argtypes = []
    lib.lb_lc_nconst.restype = ci
    ip = ctypes.POINTER(ci)
    lib.lb_lc_attrs.argtypes = [ci, ci, ci, ci, ip]
    lib.lb_lc_attrs.restype = ci
    lib.lb_lc_q_force.argtypes = [
        ci, vp, vp, vp, vp, ci, ci, ci, ctypes.POINTER(ctypes.c_double), ip,
        vp, ci]
    lib.lb_lc_q_force.restype = ci
    return lib


def _bind_droplet(path: Path):
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lb_droplet_nconst.argtypes = []
    lib.lb_droplet_nconst.restype = ci
    ip = ctypes.POINTER(ci)
    lib.lb_droplet_attrs.argtypes = [ci, ci, ci, ci, ci, ip]
    lib.lb_droplet_attrs.restype = ci
    lib.lb_droplet_phi_q_force.argtypes = [
        ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci,
        ctypes.POINTER(ctypes.c_double), ip, vp, ci]
    lib.lb_droplet_phi_q_force.restype = ci
    return lib


def _bind_binary(path: Path):
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ci)
    lib.lb_binary_attrs.argtypes = [ci, ci, ci, ci, ci, ip]
    lib.lb_binary_attrs.restype = ci
    lib.lb_binary_phi_force.argtypes = [
        ci, ci, vp, vp, vp, vp, ci, ci, ci, ctypes.POINTER(ctypes.c_double),
        ip, vp, ci]
    lib.lb_binary_phi_force.restype = ci
    return lib


def _bind_electro(path: Path):
    lib = ctypes.CDLL(str(path))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.lb_np_attrs.argtypes = [ci, ci, ci, ci, ci, ci, ip]
    lib.lb_np_attrs.restype = ci
    lib.lb_electro_device_info.argtypes = [ci, ip, ip]
    lib.lb_electro_device_info.restype = ci
    lib.lb_sor_grid.argtypes = [ci, ci, ci, cll, ci, ip]
    lib.lb_sor_grid.restype = ci
    lib.lb_sor_solve.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                 ci, ci, dp, ip, vp, ci]
    lib.lb_sor_solve.restype = ci
    lib.lb_np_gradmu.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, ci,
                                 ci, ci, ci, dp, ip, vp, ci]
    lib.lb_np_gradmu.restype = ci
    return lib


def _bind_stats(path: Path):
    lib = ctypes.CDLL(str(path))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lb_stats_scan.argtypes = [ci, ci, vp, vp, cll, vp, vp, ci]
    lib.lb_stats_scan.restype = ci
    lib.lb_stats_momentum.argtypes = [ci, ci, vp, vp, cll,
                                      ctypes.POINTER(ci), vp, vp, ci]
    lib.lb_stats_momentum.restype = ci
    lib.lb_chain_sums.argtypes = [ci, vp, vp, cll, cll, vp, vp, ci]
    lib.lb_chain_sums.restype = ci
    return lib


def _jobs() -> dict:
    """library name -> (source, generated header's name, its generator,
    binder of the loaded library)."""
    jobs = {_lib_name(nvel): (CSRC, "lb_generated.h",
                              lambda nvel=nvel: generate_header(nvel),
                              lambda p, nvel=nvel: _bind_lb(p, nvel))
            for nvel in KERNEL_NVELS}
    jobs[BINARY_LIB] = (CSRC_BINARY, "binary_generated.h",
                        generate_binary_header, _bind_binary)
    jobs[LC_LIB] = (CSRC_LC, "lc_generated.h", generate_lc_header, _bind_lc)
    jobs[DROPLET_LIB] = (CSRC_DROPLET, "droplet_generated.h",
                         generate_droplet_header, _bind_droplet)
    # hand-written throughout: no generated header
    jobs[ELECTRO_LIB] = (CSRC_ELECTRO, None, lambda: "", _bind_electro)
    jobs[STATS_LIB] = (CSRC_STATS, None, lambda: "", _bind_stats)
    return jobs


def build(names=None) -> dict:
    """Compile (where not already built) and load the named kernel
    libraries, all of them by default: fused_lb_q<nvel> per velocity set,
    binary_phi, lc_q, droplet, electro, stats_ref.  The nvcc runs go in
    parallel, and each writes its ptxas report (registers, spills) beside
    the library.  Returns {library name: path}."""
    jobs = _jobs()
    names = tuple(jobs) if names is None else tuple(names)
    bad = [name for name in names if name not in jobs]
    if bad:
        raise ValueError(f"no CUDA kernel library {bad}; there are "
                         f"{tuple(jobs)}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, done = {}, {}
    for name in names:
        src, header_name, gen_header, _b = jobs[name]
        if name in _libs:
            done[name] = _libs[name][1]
            continue
        header = gen_header()
        path = _lib_path(name, src, header)
        if path.exists():
            done[name] = path
            continue
        gen = BUILD_DIR / f"gen_{name}"
        gen.mkdir(exist_ok=True)
        if header_name is not None:
            (gen / header_name).write_text(header)
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(gen), "-o", str(tmp),
               str(src)]
        todo[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for name, (path, tmp, proc) in todo.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        path.with_suffix(".ptxas.txt").write_text(log)
        tmp.replace(path)
        done[name] = path
    for name, path in done.items():
        if name not in _libs:
            _libs[name] = (jobs[name][3](path), path)
    return done


def ptxas_lines(path: Path, names) -> list:
    """What ptxas reported (registers, shared memory, spills) of the
    kernels in the library at `path` whose mangled names contain one of
    `names`: one line an entry, with its name."""
    out, entry = [], None
    text = path.with_suffix(".ptxas.txt").read_text()
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and any(n in entry for n in names) and (
                "Used" in line or "spill" in line):
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return out


def _get_lib(name: str):
    """The loaded library `name`, built first where it is not yet."""
    if name not in _libs:
        build((name,))
    return _libs[name][0]


def _lib(nvel: int):
    return _get_lib(_lib_name(nvel))


# -- launches -----------------------------------------------------------------

def _kernel_params(model, params, delta: bool):
    """(projected, par): par = [rt, rtb, fx, fy, fz, ghost factors...]
    as the kernels' LBParams take it; projected when every ghost rate
    is 1 (M10, or ghosts off), which selects the variant whose ghost
    factors are the twin's constants."""
    from ludwig_tpu_torch.ops.fused import _ghost_coefs

    gcoef = _ghost_coefs(model, params, delta)
    projected = all(float(r) == 1.0
                    for r in params.rtau_ghost[model.nhydro:])
    fg = [float(v) for v in params.force_global[:3]]
    vals = [params.rtau_shear, params.rtau_bulk, *fg, *gcoef]
    return int(projected), (ctypes.c_double * len(vals))(*vals)


def _check_cuda_state(f: torch.Tensor):
    """The callers in ops/fused.py have checked shape, dtype and
    contiguity; the pointer must also be device memory."""
    if f.device.type != "cuda":
        raise ValueError(f"CUDA kernel needs a CUDA tensor, got {f.device}")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def fused_step(f: torch.Tensor, model, params, delta: bool) -> torch.Tensor:
    """Launch the single-step kernel on PyTorch's current stream."""
    _check_cuda_state(f)
    lib = _lib(model.nvel)
    proj, par = _kernel_params(model, params, delta)
    out = torch.empty_like(f)
    X, Y, Z = f.shape[1:]
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.lb_fused_step(int(f.dtype == torch.float64), int(delta), proj,
                           f.data_ptr(), out.data_ptr(), X, Y, Z, par, None,
                           0, 0, stream, f.device.index)
    _raise_on(rc, "fused_step")
    launches.fused_step += 1
    return out


def fused_step_noise(f: torch.Tensor, model, params, delta: bool, noise,
                     t: int) -> torch.Tensor:
    """Launch the single-step kernel with in-kernel fluctuations (a
    FusedNoise) at step t on PyTorch's current stream.  The amplitude
    products are folded in double here, as the twin folds them, and
    rounded to the dtype in the kernel's parameters."""
    from ludwig_tpu_torch.ops.fused import noise_amplitudes

    _check_cuda_state(f)
    lib = _lib(model.nvel)
    proj, par = _kernel_params(model, params, delta)
    eta2, eta, bulk, ghost = noise_amplitudes(model, noise)
    vals = [eta2, eta, bulk] + [0.0 if g is None else g for g in ghost]
    npar = (ctypes.c_double * len(vals))(*vals)
    out = torch.empty_like(f)
    X, Y, Z = f.shape[1:]
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.lb_fused_step(int(f.dtype == torch.float64), int(delta), proj,
                           f.data_ptr(), out.data_ptr(), X, Y, Z, par, npar,
                           noise.seed & 0x7FFFFFFF, t, stream,
                           f.device.index)
    _raise_on(rc, "fused_step_noise")
    launches.fused_step_noise += 1
    return out


def fused_force_step(f: torch.Tensor, force: torch.Tensor, model, params):
    """Launch the force-coupled collide+stream kernel (increment form);
    returns (f', u).  The caller (ops/fused.py) has checked shapes,
    dtypes and contiguity."""
    _check_cuda_state(f)
    lib = _lib(model.nvel)
    proj, par = _kernel_params(model, params, True)
    out = torch.empty_like(f)
    u = torch.empty_like(force)
    X, Y, Z = f.shape[1:]
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.lb_fused_force_step(int(f.dtype == torch.float64), proj,
                                 f.data_ptr(), force.data_ptr(),
                                 out.data_ptr(), u.data_ptr(), X, Y, Z, par,
                                 stream, f.device.index)
    _raise_on(rc, "fused_force_step")
    launches.fused_force_step += 1
    return out, u


def binary_phi_force_step(phi: torch.Tensor, u: torch.Tensor, consts,
                          order: int, plan=None):
    """Launch the binary order-parameter kernel on the layout k1_layout_on
    picks (or the K1Plan `plan`); returns (phi', force).  `consts` is
    ops/fused_binary._Consts of Python floats; the caller has checked
    shapes, dtypes, contiguity and the order."""
    _check_cuda_state(phi)
    lib = _get_lib(BINARY_LIB)
    par = (ctypes.c_double * len(consts))(*(float(v) for v in consts))
    lay = k1_layout_on(phi, BINARY_KERNEL, order=order, plan=plan)
    phi_out = torch.empty_like(phi)
    force = torch.empty_like(u)
    X, Y, Z = phi.shape
    stream = torch.cuda.current_stream(phi.device).cuda_stream
    rc = lib.lb_binary_phi_force(int(phi.dtype == torch.float64), order,
                                 phi.data_ptr(), u.data_ptr(),
                                 phi_out.data_ptr(), force.data_ptr(), X, Y,
                                 Z, par, lay.c_args(), stream,
                                 phi.device.index)
    _raise_on(rc, f"binary_phi_force_step ({lay})")
    launches.binary_phi_force_step += 1
    return phi_out, force


def lc_q_force_step(q5: torch.Tensor, u: torch.Tensor, fe, be_gamma,
                    plan=None):
    """Launch the liquid-crystal Q-tensor kernel on the layout k1_layout_on
    picks (or the K1Plan `plan`); returns (q5', force).  `fe` is a
    BluePhaseFE of Python floats, `be_gamma` the rotational mobility; the
    caller (ops/fused_lc.py) has checked shapes, dtypes and contiguity."""
    _check_cuda_state(q5)
    lib = _get_lib(LC_LIB)
    vals = lc_const_values(fe, be_gamma)
    if lib.lb_lc_nconst() != len(vals):
        raise RuntimeError(f"lc_q library has {lib.lb_lc_nconst()} "
                           f"constants, the generator {len(vals)}")
    par = (ctypes.c_double * len(vals))(*vals)
    lay = k1_layout_on(q5, LC_KERNEL, plan=plan)
    q_out = torch.empty_like(q5)
    force = torch.empty_like(u)
    X, Y, Z = q5.shape[1:]
    stream = torch.cuda.current_stream(q5.device).cuda_stream
    rc = lib.lb_lc_q_force(int(q5.dtype == torch.float64), q5.data_ptr(),
                           u.data_ptr(), q_out.data_ptr(), force.data_ptr(),
                           X, Y, Z, par, lay.c_args(), stream,
                           q5.device.index)
    _raise_on(rc, f"lc_q_force_step ({lay})")
    launches.lc_q_force_step += 1
    return q_out, force


def droplet_phi_q_force_step(phi: torch.Tensor, q5: torch.Tensor,
                             u: torch.Tensor, fe, be_gamma, mobility,
                             order: int, plan=None):
    """Launch the droplet kernel on the layout k1_layout_on picks (or the
    K1Plan `plan`); returns (phi', q5', raw force).  `fe` is an
    LCDropletFE of Python floats; the caller (ops/fused_droplet.py) has
    checked shapes, dtypes, contiguity and the order."""
    _check_cuda_state(phi)
    lib = _get_lib(DROPLET_LIB)
    vals = droplet_const_values(fe, be_gamma, mobility)
    if lib.lb_droplet_nconst() != len(vals):
        raise RuntimeError(f"droplet library has {lib.lb_droplet_nconst()} "
                           f"constants, the generator {len(vals)}")
    par = (ctypes.c_double * len(vals))(*vals)
    lay = k1_layout_on(phi, DROPLET_KERNEL, order=order, plan=plan)
    phi_out = torch.empty_like(phi)
    q_out = torch.empty_like(q5)
    force = torch.empty_like(u)
    X, Y, Z = phi.shape
    stream = torch.cuda.current_stream(phi.device).cuda_stream
    rc = lib.lb_droplet_phi_q_force(
        int(phi.dtype == torch.float64), order, phi.data_ptr(),
        q5.data_ptr(), u.data_ptr(), phi_out.data_ptr(), q_out.data_ptr(),
        force.data_ptr(), X, Y, Z, par, lay.c_args(), stream,
        phi.device.index)
    _raise_on(rc, f"droplet_phi_q_force_step ({lay})")
    launches.droplet_phi_q_force_step += 1
    return phi_out, q_out, force


def fused_force_step_solid(f: torch.Tensor, force: torch.Tensor,
                           solid: torch.Tensor, model, params):
    """Launch the force-coupled collide+stream with bounce-back on the
    bool mask `solid`, then the one-block sum of the wall momentum;
    returns (f', u, gw).  The caller (ops/fused.py) has checked shapes,
    dtypes and contiguity."""
    _check_cuda_state(f)
    lib = _lib(model.nvel)
    proj, par = _kernel_params(model, params, True)
    out = torch.empty_like(f)
    u = torch.empty_like(force)
    X, Y, Z = f.shape[1:]
    blocks = lib.lb_force_step_blocks(X * Y * Z)
    part = torch.empty(3 * blocks, dtype=f.dtype, device=f.device)
    gw = torch.empty(3, dtype=f.dtype, device=f.device)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.lb_fused_force_step_solid(
        int(f.dtype == torch.float64), proj, f.data_ptr(), force.data_ptr(),
        solid.view(torch.uint8).data_ptr(), out.data_ptr(), u.data_ptr(),
        part.data_ptr(), gw.data_ptr(), X, Y, Z, par, stream,
        f.device.index)
    _raise_on(rc, "fused_force_step_solid")
    launches.fused_force_step_solid += 1
    return out, u, gw


SOR_ROUTES = ("two-buffer", "in-place", "on-chip")  # electro.cu routes 0, 1, 2
SOR_CHIP_THREADS = 512   # threads a block of the on-chip route
# the on-chip route is picked from this many sites on: on an H100, f32
# solves of 41 iterations ran faster on chip than in place from 64^3 on
# and slower at 48^3 and below (chip_smoke.py phase 18)
SOR_CHIP_MIN_SITES = 64 ** 3
INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class SorLayout:
    """The SOR kernel's route; on-chip, the brick (bx, by, Z) each block
    keeps in shared memory and the bytes it takes."""
    route: str
    bx: int = 0
    by: int = 0
    smem: int = 0

    def blocks(self, shape) -> int:
        """Blocks of the on-chip route: one a brick."""
        return (shape[0] // self.bx) * (shape[1] // self.by)


def sor_brick_bytes(bx: int, by: int, Z: int, itemsize: int) -> int:
    """Shared memory of one on-chip brick: psi with a one-site halo in x
    and y, and rhs."""
    return ((bx + 2) * (by + 2) + bx * by) * Z * itemsize


def sor_layout(shape, itemsize: int, sms: int, optin: int,
               route=None) -> SorLayout:
    """The SOR kernel's route for a field of `shape` on a card with `sms`
    multiprocessors and `optin` bytes of shared memory a block.  An odd
    extent takes the two-buffer route (two sites of one colour meet
    across the wrap).  With every extent even, the on-chip route from
    SOR_CHIP_MIN_SITES sites on where psi and rhs fit: the most bricks
    (bx, by, Z) that divide X and Y, one a multiprocessor, then the least
    shared memory, then the longer y side; else the in-place route.
    `route` forces one (on-chip at any size it fits) and raises where it
    cannot run."""
    X, Y, Z = (int(v) for v in shape)
    if X * Y * Z > INT32_MAX:
        raise ValueError(f"sor_solve kernel indexes with int32: X*Y*Z = "
                         f"{X * Y * Z} exceeds {INT32_MAX}")
    if route not in (None,) + SOR_ROUTES:
        raise ValueError(f"no SOR route {route!r}; there are {SOR_ROUTES}")
    even = X % 2 == 0 and Y % 2 == 0 and Z % 2 == 0
    if route == "two-buffer" or (route is None and not even):
        return SorLayout("two-buffer")
    if not even:
        raise ValueError(f"the {route} route needs even extents, got "
                         f"{(X, Y, Z)}")
    if route == "in-place" or (route is None
                               and X * Y * Z < SOR_CHIP_MIN_SITES):
        return SorLayout("in-place")
    best = None
    for nbx in (d for d in range(1, X + 1) if X % d == 0):
        for nby in (d for d in range(1, Y + 1) if Y % d == 0):
            if nbx * nby > sms:
                continue
            bx, by = X // nbx, Y // nby
            # the block's static memory: one reduction slot a warp
            smem = sor_brick_bytes(bx, by, Z, itemsize)
            if smem + 8 * (SOR_CHIP_THREADS // 32 + 1) > optin:
                continue
            key = (nbx * nby, -smem, by)
            if best is None or key > best[0]:
                best = (key, SorLayout("on-chip", bx, by, smem))
    if best is not None:
        return best[1]
    if route == "on-chip":
        raise ValueError(f"psi and rhs of {(X, Y, Z)} do not fit the "
                         "shared memory of the card's multiprocessors")
    return SorLayout("in-place")


def sor_plan(psi: torch.Tensor, route=None):
    """(SorLayout, grid) of the cooperative SOR launch for psi on its
    card: the streaming routes take one block for each ELECTRO_THREADS
    sites (pairs, in place), capped at what the card keeps resident; the
    on-chip route one block a brick, which the card must keep resident
    at once.  Raises where the card lacks cooperative launches."""
    return _sor_plan(tuple(psi.shape), psi.dtype, psi.device.index, route)


def sor_routes(psi: torch.Tensor) -> list:
    """The routes the card can run for psi, in SOR_ROUTES order."""
    out = []
    for route in SOR_ROUTES:
        try:
            sor_plan(psi, route)
        except ValueError:
            continue
        out.append(route)
    return out


@functools.lru_cache(maxsize=64)
def _sor_plan(shape, dtype, dev: int, route):
    lib = _get_lib(ELECTRO_LIB)
    sms, optin = ctypes.c_int(), ctypes.c_int()
    _raise_on(lib.lb_electro_device_info(dev, ctypes.byref(sms),
                                         ctypes.byref(optin)), "device query")
    itemsize = torch.empty((), dtype=dtype).element_size()
    lay = sor_layout(shape, itemsize, sms.value, optin.value, route)
    grid = ctypes.c_int()
    rc = lib.lb_sor_grid(int(dtype == torch.float64),
                         SOR_ROUTES.index(lay.route), dev,
                         shape[0] * shape[1] * shape[2], lay.smem,
                         ctypes.byref(grid))
    if rc == -1:
        raise RuntimeError(f"sor_solve needs a cooperative launch, which "
                           f"{torch.cuda.get_device_name(dev)} lacks")
    _raise_on(rc, "sor_solve grid query")
    if lay.route != "on-chip":
        return lay, grid.value
    if lay.blocks(shape) > grid.value:
        raise RuntimeError(f"sor_solve on-chip: {lay.blocks(shape)} "
                           f"bricks, the card keeps {grid.value} resident")
    return lay, lay.blocks(shape)


def sor_solve(psi: torch.Tensor, rhs: torch.Tensor, om_tab: torch.Tensor,
              eps: float, rel_tol: float, abs_tol: float, max_its: int,
              zero_mean: bool, route=None):
    """Launch the cooperative SOR kernel from psi (left as it is), on the
    route sor_layout picks (or `route`); returns (psi', n, rnorm, which) as
    ops/fused_electro.sor_solve_fused documents.  The caller has checked
    shapes, dtypes and contiguity."""
    _check_cuda_state(psi)
    lib = _get_lib(ELECTRO_LIB)
    is_f64 = int(psi.dtype == torch.float64)
    X, Y, Z = psi.shape
    dev = psi.device.index
    lay, grid = sor_plan(psi, route)
    # the result; the two-buffer route iterates in it from a copy of psi
    p0 = psi.clone() if lay.route == "two-buffer" else torch.empty_like(psi)
    if psi.data_ptr() % (2 * psi.element_size()):
        psi = psi.clone()   # the kernel reads pairs of sites as vectors
    # the second buffer, or the in-place route's colour-split psi and rhs
    p1 = {"two-buffer": torch.empty_like(psi),
          "in-place": torch.empty(2 * psi.numel(), dtype=psi.dtype,
                                  device=psi.device)}.get(lay.route)
    part = torch.empty(7 * grid, dtype=psi.dtype, device=psi.device)
    faces = None
    if lay.route == "on-chip":   # a colour's boundary planes, per colour
        faces = torch.empty(2 * grid * (lay.bx + lay.by) * Z,
                            dtype=psi.dtype, device=psi.device)
    istats = torch.empty(2, dtype=torch.int32, device=psi.device)
    rstats = torch.empty(1, dtype=psi.dtype, device=psi.device)
    par = (ctypes.c_double * 5)(eps, 6.0 * eps, rel_tol, abs_tol, 0.995)
    ipar = (ctypes.c_int * 9)(X, Y, Z, max_its, om_tab.shape[0],
                              int(zero_mean), int(not is_f64), lay.bx,
                              lay.by)
    stream = torch.cuda.current_stream(psi.device).cuda_stream
    rc = lib.lb_sor_solve(
        is_f64, SOR_ROUTES.index(lay.route), psi.data_ptr(), p0.data_ptr(),
        None if p1 is None else p1.data_ptr(), rhs.data_ptr(),
        om_tab.data_ptr(), part.data_ptr(),
        None if faces is None else faces.data_ptr(), istats.data_ptr(),
        rstats.data_ptr(), grid, lay.smem, par, ipar, stream, dev)
    _raise_on(rc, f"sor_solve ({lay.route})")
    launches.sor_solve += 1
    return p0, istats[0], rstats[0], istats[1]


def np_gradmu(psi: torch.Tensor, rho: torch.Tensor, u, fluid: torch.Tensor,
              ez, z, c, kt_e: float, dt: float, plan=None):
    """Launch the Nernst-Planck + grad-mu x-march on the layout
    np_layout_on picks (or the NpPlan `plan`), then the one-block sum of
    its blocks' partial forces; returns (rho', force, fsum).  ez, z, c are
    per-species e z_k, z_k and -D_k/2; u is None without advection.  The
    caller (ops/fused_electro.py) has checked shapes, dtypes, devices and
    the int32 index range."""
    _check_cuda_state(psi)
    lib = _get_lib(ELECTRO_LIB)
    X, Y, Z = psi.shape
    nk = rho.shape[0]
    lay = np_layout_on(psi, nk, u is not None, plan)
    rho_out = torch.empty_like(rho)
    force = torch.empty((3,) + tuple(psi.shape), dtype=psi.dtype,
                        device=psi.device)
    part = torch.empty(3 * lay.blocks, dtype=psi.dtype, device=psi.device)
    fsum = torch.empty(3, dtype=psi.dtype, device=psi.device)
    vals = [kt_e, dt, *ez, *z, *c]
    par = (ctypes.c_double * len(vals))(*vals)
    stream = torch.cuda.current_stream(psi.device).cuda_stream
    rc = lib.lb_np_gradmu(
        int(psi.dtype == torch.float64), int(u is not None), psi.data_ptr(),
        rho.data_ptr(), (psi if u is None else u).data_ptr(),
        fluid.view(torch.uint8).data_ptr(), rho_out.data_ptr(),
        force.data_ptr(), part.data_ptr(), fsum.data_ptr(), X, Y, Z, nk, par,
        lay.c_args(), stream, psi.device.index)
    _raise_on(rc, f"np_gradmu ({lay})")
    launches.np_gradmu += 1
    return rho_out, force, fsum


def stats_scan(flat: torch.Tensor, keep, mode: int, name: str):
    """Launch the one-block site-order scan `mode` of csrc/stats_ref.cu
    over the contiguous 1-D tensor flat (keep: a bool mask of its
    values, or None); returns (2,) [total, second sum] on the device.
    `name` is the statistic the scan serves (seq_sum, field_stats_ref or
    rho_stats_ref), whose launch count it adds to."""
    _check_cuda_state(flat)
    lib = _get_lib(STATS_LIB)
    out = torch.empty(2, dtype=flat.dtype, device=flat.device)
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    rc = lib.lb_stats_scan(
        int(flat.dtype == torch.float64), mode, flat.data_ptr(),
        None if keep is None else keep.view(torch.uint8).data_ptr(),
        flat.numel(), out.data_ptr(), stream, flat.device.index)
    _raise_on(rc, name)
    setattr(launches, name, getattr(launches, name) + 1)
    return out


def momentum_total_ref(f: torch.Tensor, keep, model) -> torch.Tensor:
    """Launch the three Kahan chains of csrc/stats_ref.cu's momentum scan
    over the contiguous state f (keep: a flat bool mask of the sites, or
    None); returns the (3,) total on the device."""
    _check_cuda_state(f)
    lib = _get_lib(STATS_LIB)
    cv = [int(c) for c in model.cv.reshape(-1)]
    cvp = (ctypes.c_int * len(cv))(*cv)
    out = torch.empty(3, dtype=f.dtype, device=f.device)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.lb_stats_momentum(
        int(f.dtype == torch.float64), model.nvel, f.data_ptr(),
        None if keep is None else keep.view(torch.uint8).data_ptr(),
        f[0].numel(), cvp, out.data_ptr(), stream, f.device.index)
    _raise_on(rc, "momentum_total_ref")
    launches.momentum_total_ref += 1
    return out


def chain_sums(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Launch csrc/stats_ref.cu's chain_sums_kernel: (nchain,) sums
    seed[c] + v[0, c] + v[1, c] + ... added in that order, one thread a
    chain, for the contiguous (len, nchain) tensor v on the device."""
    _check_cuda_state(v)
    if v.dim() != 2 or seed.shape != (v.shape[1],) or not (
            v.is_contiguous() and seed.is_contiguous()):
        raise ValueError("chain_sums takes contiguous v (len, nchain) and "
                         "seed (nchain,)")
    lib = _get_lib(STATS_LIB)
    out = torch.empty_like(seed)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = lib.lb_chain_sums(int(v.dtype == torch.float64), v.data_ptr(),
                           seed.data_ptr(), v.shape[0], v.shape[1],
                           out.data_ptr(), stream, v.device.index)
    _raise_on(rc, "chain_sums")
    launches.chain_sums += 1
    return out


@functools.lru_cache(maxsize=None)
def _device_info(lib, dev: int):
    """(multiprocessors, shared-memory opt-in bytes per block)."""
    sms, smem_optin = ctypes.c_int(), ctypes.c_int()
    _raise_on(lib.lb_device_info(dev, ctypes.byref(sms),
                                 ctypes.byref(smem_optin)), "device query")
    return sms.value, smem_optin.value


SMEM_OPTIN_H100 = 232_448   # shared memory one block may opt into (H100)
NSTEP_MIN_BY = 8            # nstep_layout narrows BY no further
NSTEP_MIN_BZ = 32           # nor BZ: a warp reads 32 consecutive z


@dataclasses.dataclass(frozen=True)
class NstepLayout:
    """Where the n-step kernel keeps its rings, on which tile, and with
    how many threads a block."""
    route: str          # "shared" (memory of the SM) or "global" scratch
    plan: object        # the FusedPlan (tile and segment) the kernel runs
    ring_bytes: int     # one block's rings
    threads: int


def nstep_ring_bytes(nvel: int, nsteps: int, BY: int, BZ: int,
                     itemsize: int) -> int:
    """Bytes of one block's rings: levels 1..n-1, level L's window widened
    by n - L sites in y and z, two planes of nvel values a window site
    (2 + c_x slots per velocity)."""
    return 2 * nvel * itemsize * sum((BY + 2 * h) * (BZ + 2 * h)
                                     for h in range(1, nsteps))


def nstep_layout(nvel: int, nsteps: int, plan, itemsize: int,
                 optin: int = SMEM_OPTIN_H100) -> NstepLayout:
    """The n-step kernel's route, tile and block size for a FusedPlan.  BY
    halves (not below NSTEP_MIN_BY), then BZ (not below NSTEP_MIN_BZ),
    until one block's rings fit `optin` bytes of shared memory; where
    none fits, the rings go to global scratch on the narrowest tile.  An
    f32 block takes 256 threads where two blocks' rings share an SM, else
    512; an f64 block 256 (its collision needs up to 255 registers a
    thread)."""
    by, bz = plan.BY, plan.BZ
    while nstep_ring_bytes(nvel, nsteps, by, bz, itemsize) > optin:
        if by > NSTEP_MIN_BY:
            by = max(NSTEP_MIN_BY, by // 2)
        elif bz > NSTEP_MIN_BZ:
            bz = max(NSTEP_MIN_BZ, bz // 2)
        else:
            break
    ring = nstep_ring_bytes(nvel, nsteps, by, bz, itemsize)
    route = "shared" if ring <= optin else "global"
    two_fit = route == "shared" and ring <= optin // 2 - 1024
    threads = 256 if itemsize == 8 or two_fit else 512
    return NstepLayout(route, dataclasses.replace(plan, BY=by, BZ=bz), ring,
                       threads)


def nstep_layout_on(f: torch.Tensor, model, plan, nsteps: int):
    """nstep_layout for f on its card, with the card's opt-in: the route
    and tile fusedn_step takes."""
    _check_cuda_state(f)
    optin = _device_info(_lib(model.nvel), f.device.index)[1]
    return nstep_layout(model.nvel, nsteps, plan, f.element_size(), optin)


def fusedn_step(f: torch.Tensor, model, params, nsteps: int, plan,
                delta: bool) -> torch.Tensor:
    """Launch the n-step kernel on the tile nstep_layout_on picks: one
    block a tile, its rings in shared memory; or, where they do not fit,
    a persistent grid of one block an SM with the rings in a global
    scratch allocated here."""
    _check_cuda_state(f)
    lib = _lib(model.nvel)
    proj, par = _kernel_params(model, params, delta)
    X, Y, Z = f.shape[1:]
    lay = nstep_layout_on(f, model, plan, nsteps)
    tile = lay.plan
    ntiles = (-(-X // tile.BX)) * (-(-Y // tile.BY)) * (-(-Z // tile.BZ))
    dev = f.device.index
    per_block = lay.ring_bytes // f.element_size()
    scratch = None
    if lay.route == "shared":
        grid, smem = ntiles, lay.ring_bytes
    else:
        grid, smem = min(ntiles, _device_info(lib, dev)[0]), 0
        scratch = torch.empty(grid * per_block, dtype=f.dtype,
                              device=f.device)
    out = torch.empty_like(f)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.lb_fusedn_step(
        int(f.dtype == torch.float64), int(delta), proj, f.data_ptr(),
        out.data_ptr(), X, Y, Z, nsteps, tile.BX, tile.BY, tile.BZ,
        None if scratch is None else scratch.data_ptr(), per_block, grid,
        lay.threads, smem, par, stream, dev)
    _raise_on(rc, "fusedn_step")
    launches.fusedn_step += 1
    return out


# -- the K1 x-march of the binary fluid, the liquid crystal and the droplet

BINARY_KERNEL = "binary_phi_force_step"
LC_KERNEL = "lc_q_force_step"
DROPLET_KERNEL = "droplet_phi_q_force_step"
# slots of the march's shared buffers (csrc/k1_march.cuh): the staged
# planes x-1 .. x+3 (x+3 in flight), u's planes x-1 .. x+2, the ring of
# pth[:,0] and mu over planes x-1 .. x+1, and pth[:,1], pth[:,2] and h of
# planes x and x+1
K1_STAGE_SLOTS, K1_U_SLOTS, K1_RING, K1_BUFS = 5, 4, 3, 2
K1_MAX_THREADS = {4: 512, 8: 256}   # the kernels' launch bounds (f32, f64)
K1_BZ = 32              # the tile's z extent, fixed in csrc/k1_march.cuh
SM_RESERVED = 1024      # shared memory an H100 keeps back for each block
SM_REGS, SM_THREADS, SM_BLOCKS = 65536, 2048, 32    # an H100 SM's limits
# f32 operations an H100 SXM issues a second without FMA (132 SMs x 128
# lanes x 1.98 GHz): the generated code runs with -fmad=false
K1_ISSUE_RATE = 33.5e12
_ACCESS = re.compile(r"^([A-Z]+)\((-?\d+(?:, -?\d+)*)\)$")


def k1_reads(kernel: str, order: int = 1, level1: bool = False) -> dict:
    """{accessor: set of argument tuples} the K1 site update loads (with
    `level1`, one level-1 evaluation), from the traces the kernel's code
    is generated from: S(a, b, dx, dy, dz), MU(dx, dy, dz), Q(n, dx, dy,
    dz), P(dx, dy, dz), U(a, dx, dy, dz), H(n) or H(b, c)."""
    if kernel == BINARY_KERNEL:
        tr1, _t1, sites = _binary_trace()
        tr2 = sites[order][0]
    elif kernel == LC_KERNEL:
        tr1, _t1, tr2, _t2, _c = _lc_trace()
    elif kernel == DROPLET_KERNEL:
        tr1, _t1, sites, _c = _droplet_trace()
        tr2 = sites[order][0]
    else:
        raise ValueError(f"no K1 kernel {kernel!r}")
    out = {}
    for key in (tr1 if level1 else tr2).values:
        m = _ACCESS.match(key)
        if m:
            out.setdefault(m[1], set()).add(
                tuple(int(v) for v in m[2].split(", ")))
    return out


def k1_check_reads(kernel: str, order: int = 1):
    """Raise unless the march keeps what K1 reads: the stress pth[a][b]
    only at +-e_b, mu at the site and its six neighbours, the staged
    fields and u within one site on each axis (level 1 likewise, from
    the staged fields alone)."""
    site = k1_reads(kernel, order)
    lvl = k1_reads(kernel, order, level1=True)
    bad = [("S",) + s for s in site.get("S", ())
           if sorted(map(abs, s[2:])) != [0, 0, 1] or s[2 + s[1]] == 0]
    bad += [("MU",) + o for o in site.get("MU", ())
            if sum(map(abs, o)) > 1]
    for where, reads, names in (("site", site, ("P", "Q", "U")),
                                ("level 1", lvl, ("P", "Q"))):
        bad += [(where, name) + a for name in names
                for a in reads.get(name, ()) if max(map(abs, a[-3:])) > 1]
    bad += [("level 1", name) for name in lvl if name not in ("P", "Q")]
    if bad:
        raise ValueError(f"{kernel}: reads the x-march does not keep: "
                         f"{sorted(bad)}")


def k1_buffers(kernel: str, BY: int, BZ: int) -> dict:
    """Elements of one block's shared buffers on a BY x BZ tile
    (csrc/k1_march.cuh Layout), from what the traces read: the staged
    components (those level 1 loads) with a halo of level 1's reach plus
    the stress's, u with the site's reach, the stress components read
    across x and across the y and z faces, mu where it is read at the
    neighbours, and the components of h (none for the binary fluid)."""
    site, lvl = k1_reads(kernel), k1_reads(kernel, level1=True)
    staged = len({a[0] for a in lvl.get("Q", ())}) + ("P" in lvl)
    reach = max(max(map(abs, a[-3:])) for v in lvl.values() for a in v)
    halo = reach + max(max(map(abs, s[2:])) for s in site["S"])
    uh = max(max(map(abs, a[1:])) for a in site["U"])
    across = [{s[0] for s in site["S"] if s[1] == b} for b in range(3)]
    ni = BY * BZ
    plane_u = (BY + 2 * uh) * (BZ + 2 * uh)
    return {
        "staged": K1_STAGE_SLOTS * staged * (BY + 2 * halo)
        * (BZ + 2 * halo),
        "u": K1_U_SLOTS * len({a[0] for a in site["U"]}) * plane_u,
        "pth_x": K1_RING * len(across[0]) * ni,
        "pth_yz": K1_BUFS * (len(across[1]) * (BY + 2) * BZ
                             + len(across[2]) * BY * (BZ + 2)),
        "h": K1_BUFS * len(site.get("H", ())) * ni,
        "mu": K1_RING * plane_u if "MU" in site else 0}


def k1_smem_bytes(kernel: str, BY: int, BZ: int, itemsize: int) -> int:
    """Shared bytes of one block: the buffers, then the int32 in-plane
    offsets of the staged window's BY + 4 rows and BZ + 4 columns."""
    return (itemsize * sum(k1_buffers(kernel, BY, BZ).values())
            + 4 * (BY + 4 + BZ + 4))


def k1_blocks_per_sm(smem: int, threads: int, regs: int,
                     optin: int = None) -> int:
    """Blocks an SM keeps resident: the least of what its shared memory
    (the opt-in plus one reserve, less a reserve a block), its registers
    (allocated per warp in units of 256, from the register file of one of
    the SM's four schedulers, which holds a quarter of them) and its
    threads allow."""
    optin = SMEM_OPTIN_H100 if optin is None else optin
    by_smem = (optin + SM_RESERVED) // (smem + SM_RESERVED)
    warps = -(-threads // 32)
    warp_regs = -(-regs * 32 // 256) * 256
    by_regs = 4 * (SM_REGS // 4 // warp_regs) // warps
    return min(by_smem, by_regs, SM_THREADS // threads, SM_BLOCKS)


def k1_evals(shape, BX: int, BY: int, BZ: int) -> int:
    """Level-1 evaluations of one launch: per block and plane of its x
    segment the tile and its four y-z faces, plus the tile alone on the
    segment's two end planes (tiles overhanging the lattice included)."""
    X, Y, Z = shape
    ntiles = -(-Y // BY) * -(-Z // BZ)
    per = sum((min(BX, X - xs) + 2) * BY * BZ
              + min(BX, X - xs) * 2 * (BY + BZ) for xs in range(0, X, BX))
    return ntiles * per


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """The tile's rows BY (its z extent is K1_BZ) and the threads a block
    of the K1 march; the x segment BX, or None for the longest that keeps
    every SM busy in one wave."""
    BY: int = 16
    threads: int = 512
    BX: object = None


# the default plan of each kernel and itemsize: the least time at 128^3
# plus 256^3 f32 on an H100 among the plans chip_smoke.py phases 12 and
# 15 time (K1_PLANS there), LC one 16x32 block of 512 threads an SM,
# droplet two 8x32 blocks of 256; binary the least time at 256^3 f32 (its
# main path's size) among the plans phase 9 times; f64 8x32 (what fits)
K1_DEFAULT = {(BINARY_KERNEL, 4): K1Plan(8, 128),
              (BINARY_KERNEL, 8): K1Plan(8, 256),
              (LC_KERNEL, 4): K1Plan(16, 512),
              (LC_KERNEL, 8): K1Plan(8, 256),
              (DROPLET_KERNEL, 4): K1Plan(8, 256),
              (DROPLET_KERNEL, 8): K1Plan(8, 256)}


@dataclasses.dataclass(frozen=True)
class K1Layout:
    """The K1 march's launch: x segment BX, y-z tile BY x BZ, threads and
    shared bytes a block, blocks an SM and in all, waves (blocks over
    the SMs' resident slots) and level-1 evaluations a lattice site."""
    BX: int
    BY: int
    BZ: int
    threads: int
    smem: int
    blocks_per_sm: int
    blocks: int
    waves: float
    evals_per_site: float

    def c_args(self):
        return (ctypes.c_int * 4)(self.BX, self.BY, self.threads, self.smem)

    def __str__(self):
        return (f"{self.BY}x{self.BZ} tile, BX {self.BX}, {self.threads} "
                f"threads, {self.smem} B, {self.blocks_per_sm}/SM, "
                f"{self.blocks} blocks, {self.waves:.2f} waves, "
                f"{self.evals_per_site:.4f} level-1 evaluations a site")


def k1_layout(kernel: str, shape, itemsize: int, sms: int,
              optin: int = SMEM_OPTIN_H100, regs=None,
              plan=None) -> K1Layout:
    """The K1 march's layout for a lattice of `shape` on a card with `sms`
    multiprocessors and `optin` shared bytes a block, the kernel taking
    `regs` registers a thread (None: its launch bound's cap).  The tile
    (BY x K1_BZ) and threads are `plan`'s, or K1_DEFAULT's.  x is cut
    into segments of equal length, as long as they can be while the
    tiles' segments keep every SM's resident slots busy in one wave (one
    segment where the tiles alone fill the card), or of `plan`'s BX.
    Raises on a plan the kernel does not take, the default's included
    (every default fits an H100)."""
    X, Y, Z = (int(v) for v in shape)
    if Y * Z > INT32_MAX:
        raise ValueError(f"{kernel} indexes a plane with int32: Y*Z = "
                         f"{Y * Z} exceeds {INT32_MAX}")
    maxt = K1_MAX_THREADS[itemsize]
    regs = min(255, SM_REGS // maxt) if regs is None else int(regs)
    chosen = plan if plan is not None else K1_DEFAULT[(kernel, itemsize)]
    by, bz, threads = chosen.BY, K1_BZ, chosen.threads
    if threads % 32 or not 32 <= threads <= maxt or by < 1:
        raise ValueError(f"{kernel}: no {by}x{bz} tile of {threads} threads "
                         f"(threads a multiple of 32, at most {maxt})")
    smem = k1_smem_bytes(kernel, by, bz, itemsize)
    bps = k1_blocks_per_sm(smem, threads, regs, optin)
    if smem > optin or bps < 1:
        raise ValueError(f"{kernel}: a {by}x{bz} tile takes {smem} B of "
                         f"shared memory and {threads} x {regs} registers; "
                         f"the card gives {optin} B a block")
    ntiles = -(-Y // by) * -(-Z // bz)
    if chosen.BX is not None:
        bx = min(int(chosen.BX), X)
        if bx < 1:
            raise ValueError(f"{kernel}: segment BX {chosen.BX}")
    else:
        bx = -(-X // min(X, max(1, sms * bps // ntiles)))
    blocks = ntiles * -(-X // bx)
    return K1Layout(bx, by, bz, threads, smem, bps, blocks,
                    blocks / (sms * bps),
                    k1_evals((X, Y, Z), bx, by, bz) / (X * Y * Z))


def k1_site_ops(kernel: str, evals_per_site: float, order: int = 1) -> float:
    """Operations a lattice site of the generated code on a layout: one
    level-1 evaluation times the evaluations a site, plus the site
    update (the issue floor's count: the kernel's own term order, none
    of it fused)."""
    if kernel == BINARY_KERNEL:
        tr1, _t1, sites = _binary_trace()
        return tr1.nops * evals_per_site + sites[order][0].nops
    if kernel == LC_KERNEL:
        tr1, _t1, tr2, _t2, _c = _lc_trace()
        return tr1.nops * evals_per_site + tr2.nops
    tr1, _t1, sites, _c = _droplet_trace()
    return tr1.nops * evals_per_site + sites[order][0].nops


@functools.lru_cache(maxsize=64)
def _k1_attrs(kernel: str, is_f64: bool, order: int, dev: int,
              threads: int = 0, smem: int = 0):
    """(registers a thread, blocks an SM the card keeps resident with
    `threads` and `smem` (0 without), SMs, shared opt-in) of the K1
    kernel."""
    out = (ctypes.c_int * 4)()
    if kernel == BINARY_KERNEL:
        rc = _get_lib(BINARY_LIB).lb_binary_attrs(int(is_f64), order, dev,
                                                  threads, smem, out)
    elif kernel == LC_KERNEL:
        rc = _get_lib(LC_LIB).lb_lc_attrs(int(is_f64), dev, threads, smem,
                                          out)
    else:
        rc = _get_lib(DROPLET_LIB).lb_droplet_attrs(int(is_f64), order, dev,
                                                    threads, smem, out)
    _raise_on(rc, f"{kernel} attributes")
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _k1_layout_on(kernel, shape, itemsize, is_f64, order, dev, plan):
    regs, _b, sms, optin = _k1_attrs(kernel, is_f64, order, dev)
    return k1_layout(kernel, shape, itemsize, sms, optin, regs, plan)


def k1_layout_on(x: torch.Tensor, kernel: str, order: int = 1, plan=None):
    """k1_layout for the field x (its last three axes the lattice) on its
    card, with the card's SMs and opt-in and the kernel's registers."""
    _check_cuda_state(x)
    return _k1_layout_on(kernel, tuple(x.shape[-3:]), x.element_size(),
                         x.dtype == torch.float64, order, x.device.index,
                         plan)


def k1_occupancy(x: torch.Tensor, kernel: str, lay: K1Layout,
                 order: int = 1) -> tuple:
    """(registers a thread, blocks an SM the card's occupancy query gives
    for the layout): the card's own count beside lay.blocks_per_sm."""
    a = _k1_attrs(kernel, x.dtype == torch.float64, order, x.device.index,
                  lay.threads, lay.smem)
    return a[0], a[1]


# -- the Nernst-Planck x-march -----------------------------------------------

NP_BZ = 32              # the tile's z extent, fixed in csrc/electro.cu
NP_SLOTS = 3            # staged planes x, x+1, x+2 (in flight)
NP_STAGE_PER = 2        # staged sites a thread a plane (kNpStagePer)
NP_MAX_SPECIES = 8      # csrc/electro.cu kMaxSpecies
# the kernel's launch bounds: 512 threads and two blocks an SM in f32 (64
# registers a thread), 256 threads in f64
NP_MAX_REGS = {4: 64, 8: 255}


@dataclasses.dataclass(frozen=True)
class NpPlan:
    """The tile's rows BY of the NP x-march (its z extent is NP_BZ, a
    thread a column: BY x NP_BZ threads); the x segment BX, or None for
    the longest that keeps every SM busy in one wave.  BY >= 3: a thread
    stages at most NP_STAGE_PER sites of the tile and its halo."""
    BY: int = 8
    BX: object = None


# the default plan of each itemsize: the least time at 128^3 plus 256^3
# f32 on an H100 among the plans chip_smoke.py phase 18 times (NP_PLANS
# there); f64 the same tile
NP_DEFAULT = {4: NpPlan(8), 8: NpPlan(8)}


@dataclasses.dataclass(frozen=True)
class NpLayout:
    """The NP march's launch: x segment BX, y-z tile BY x NP_BZ, threads
    and shared bytes a block, blocks an SM and in all, waves and face
    flux evaluations a lattice site and species."""
    BX: int
    BY: int
    threads: int
    smem: int
    blocks_per_sm: int
    blocks: int
    waves: float
    faces_per_site: float

    def c_args(self):
        return (ctypes.c_int * 5)(self.BX, self.BY, self.threads, self.smem,
                                  self.blocks)

    def __str__(self):
        return (f"{self.BY}x{NP_BZ} tile, BX {self.BX}, {self.threads} "
                f"threads, {self.smem} B, {self.blocks_per_sm}/SM, "
                f"{self.blocks} blocks, {self.waves:.2f} waves, "
                f"{self.faces_per_site:.4f} face fluxes a site and species")


def np_smem_bytes(nk: int, hydro: bool, BY: int, itemsize: int) -> int:
    """Shared bytes of one NP block (csrc/electro.cu NpLayout): NP_SLOTS
    staged planes of psi, the mask, u (with hydrodynamics) and the nk rho
    on (BY + 2) x (NP_BZ + 2) sites, the +y faces of nk species on BY + 1
    rows, the halo column's +z faces, then the int32 offsets of the staged
    rows and columns."""
    nf = 2 + nk + (3 if hydro else 0)
    elems = (NP_SLOTS * nf * (BY + 2) * (NP_BZ + 2)
             + nk * ((BY + 1) * NP_BZ + BY))
    return itemsize * elems + 4 * (BY + 2 + NP_BZ + 2)


def np_faces(shape, BX: int, BY: int) -> int:
    """Face flux evaluations of one launch, a species: per tile and
    segment the -x face of its first plane, then per plane the tile's +x,
    +y and +z faces, the +y faces of the halo row and the +z faces of the
    halo column (tiles overhanging the lattice included)."""
    X, Y, Z = shape
    ntiles = -(-Y // BY) * -(-Z // NP_BZ)
    tile = BY * NP_BZ
    per = sum(tile + min(BX, X - xs) * (3 * tile + NP_BZ + BY)
              for xs in range(0, X, BX))
    return ntiles * per


def np_layout(shape, nk: int, hydro: bool, itemsize: int, sms: int,
              optin: int = SMEM_OPTIN_H100, regs=None,
              plan=None) -> NpLayout:
    """The NP march's layout for nk species on a lattice of `shape`, on a
    card with `sms` multiprocessors and `optin` shared bytes a block, the
    kernel taking `regs` registers a thread (None: its launch bound's
    cap, NP_MAX_REGS).  The tile is `plan`'s, or NP_DEFAULT's; x is cut
    into segments as k1_layout cuts it (one wave), or of `plan`'s BX.
    Raises on what
    the kernel does not take: nk outside 1..NP_MAX_SPECIES, a block of
    more threads than its launch bound or too few to stage the tile and
    its halo, buffers beyond the opt-in."""
    X, Y, Z = (int(v) for v in shape)
    if not 1 <= nk <= NP_MAX_SPECIES:
        raise ValueError(f"np_gradmu kernel takes 1 to {NP_MAX_SPECIES} "
                         f"species, got {nk}")
    maxt = K1_MAX_THREADS[itemsize]
    regs = NP_MAX_REGS[itemsize] if regs is None else int(regs)
    chosen = plan if plan is not None else NP_DEFAULT[itemsize]
    by = int(chosen.BY)
    threads = by * NP_BZ
    if threads > maxt or (by + 2) * (NP_BZ + 2) > NP_STAGE_PER * threads:
        raise ValueError(f"np_gradmu: no {by}x{NP_BZ} tile (a thread a "
                         f"column, at most {maxt} threads, each staging at "
                         f"most {NP_STAGE_PER} sites: BY >= 3)")
    smem = np_smem_bytes(nk, hydro, by, itemsize)
    bps = k1_blocks_per_sm(smem, threads, regs, optin)
    if smem > optin or bps < 1:
        raise ValueError(f"np_gradmu: a {by}x{NP_BZ} tile of {nk} species "
                         f"takes {smem} B of shared memory; the card gives "
                         f"{optin} B a block")
    ntiles = -(-Y // by) * -(-Z // NP_BZ)
    if chosen.BX is not None:
        bx = min(int(chosen.BX), X)
        if bx < 1:
            raise ValueError(f"np_gradmu: segment BX {chosen.BX}")
    else:
        bx = -(-X // min(X, max(1, sms * bps // ntiles)))
    blocks = ntiles * -(-X // bx)
    if blocks > INT32_MAX:
        raise ValueError(f"np_gradmu: {blocks} blocks")
    return NpLayout(bx, by, threads, smem, bps, blocks, blocks / (sms * bps),
                    np_faces((X, Y, Z), bx, by) / (X * Y * Z))


@functools.lru_cache(maxsize=64)
def _np_attrs(is_f64: bool, hydro: bool, nk: int, dev: int,
              threads: int = 0, smem: int = 0):
    """(registers a thread, blocks an SM the card keeps resident with
    `threads` and `smem` (0 without), SMs, shared opt-in) of the NP
    kernel's instance for nk species."""
    out = (ctypes.c_int * 4)()
    _raise_on(_get_lib(ELECTRO_LIB).lb_np_attrs(
        int(is_f64), int(hydro), nk, dev, threads, smem, out),
        "np_gradmu attributes")
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _np_layout_on(shape, nk, hydro, itemsize, is_f64, dev, plan):
    regs, _b, sms, optin = _np_attrs(is_f64, hydro, nk, dev)
    return np_layout(shape, nk, hydro, itemsize, sms, optin, regs, plan)


def np_layout_on(psi: torch.Tensor, nk: int, hydro: bool, plan=None):
    """np_layout for the field psi on its card, with the card's SMs and
    opt-in and the kernel's registers."""
    _check_cuda_state(psi)
    return _np_layout_on(tuple(psi.shape), nk, bool(hydro),
                         psi.element_size(), psi.dtype == torch.float64,
                         psi.device.index, plan)


def np_occupancy(psi: torch.Tensor, nk: int, hydro: bool,
                 lay: NpLayout) -> tuple:
    """(registers a thread, blocks an SM the card's occupancy query gives
    for the layout): the card's own count beside lay.blocks_per_sm."""
    a = _np_attrs(psi.dtype == torch.float64, bool(hydro), nk,
                  psi.device.index, lay.threads, lay.smem)
    return a[0], a[1]
