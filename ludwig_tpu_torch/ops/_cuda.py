"""Build, bind and launch the hand-written CUDA kernels (csrc/*.cu).

At first use, ``nvcc`` compiles the sources for Hopper (sm_90a) into
shared libraries with a plain C interface under ``build/kernels/``
inside the package, and ``ctypes`` loads them: ``csrc/fused_lb.cu`` once
per velocity set (the collide+stream kernels), ``csrc/binary_phi.cu``
once (the binary fluid's order-parameter kernel).  Nothing is built or
loaded when the module is imported, so the CPU tests import it freely.

The per-site arithmetic reaches each kernel as straight-line C++
generated from the port's own Python, traced with symbols instead of
tensors: the collision from ops/fused.py (``_relax_modes``,
``_assemble_eo`` and friends) and lattice.py's tables, the binary site
update from ops/fused_binary.py (``_level1``, ``_binary_site``).  Kernel
and twin therefore evaluate the same expression tree, with the same
constants.

Every launch adds one to the kernel's count in ``launches``; a caller can
reset the counts and read them back to see which kernels a run used.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ludwig_tpu_torch.lattice import lb_model

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc" / "fused_lb.cu"
CSRC_BINARY = PKG_DIR / "csrc" / "binary_phi.cu"
BUILD_DIR = PKG_DIR / "build" / "kernels"
# -fmad=false: no mul+add contraction, so every kernel evaluates the
# generated expression tree operation by operation, like the twin.  With
# contraction the single- and n-step kernels contracted the increment
# form differently (f64 differences of ~1e-17 on an H100) and n-step
# results were no longer bitwise n single steps.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
KERNEL_NVELS = (15, 19, 27)
BLOCKS_PER_SM = 2        # resident blocks per SM when scratch is global


@dataclasses.dataclass
class LaunchCounts:
    """Kernel launches since the last reset()."""

    fused_step: int = 0
    fusedn_step: int = 0
    fused_force_step: int = 0
    binary_phi_force_step: int = 0

    def reset(self):
        for field in dataclasses.fields(self):
            setattr(self, field.name, 0)


launches = LaunchCounts()
_libs = {}      # library name -> (loaded ctypes library, path)


# -- code generation ----------------------------------------------------------

class _Trace:
    """Records straight-line C++ (one const temporary per value); `nops`
    counts the arithmetic operations, loads excluded."""

    def __init__(self):
        self.lines = []
        self.nops = 0

    def load(self, expr):
        name = f"t{len(self.lines)}"
        self.lines.append(f"  const T {name} = {expr};")
        return _Sym(self, name)

    def op(self, expr):
        self.nops += 1
        return self.load(expr)


def _lit(x):
    if isinstance(x, _Sym):
        return x.name
    return f"T({float(x)!r})"


class _Sym:
    """A scalar of the generated code; arithmetic appends to the trace."""

    def __init__(self, trace, name):
        self.trace = trace
        self.name = name

    def __add__(self, o):
        return self.trace.op(f"{_lit(self)} + {_lit(o)}")

    def __radd__(self, o):
        return self.trace.op(f"{_lit(o)} + {_lit(self)}")

    def __sub__(self, o):
        return self.trace.op(f"{_lit(self)} - {_lit(o)}")

    def __rsub__(self, o):
        return self.trace.op(f"{_lit(o)} - {_lit(self)}")

    def __mul__(self, o):
        return self.trace.op(f"{_lit(self)} * {_lit(o)}")

    def __rmul__(self, o):
        return self.trace.op(f"{_lit(o)} * {_lit(self)}")

    def __truediv__(self, o):
        return self.trace.op(f"{_lit(self)} / {_lit(o)}")

    def __rtruediv__(self, o):
        return self.trace.op(f"{_lit(o)} / {_lit(self)}")

    def __neg__(self):
        return self.trace.op(f"-{self.name}")


def _collide_source(nvel: int, delta: bool, projected: bool) -> str:
    """One device function: collide the site values f[0..nvel) and hand
    each post-collision value to emit(q, cx, cy, cz, value)."""
    tr, emits = _collide_trace(nvel, delta, projected)
    name = f"lb_collide_d{int(delta)}_p{int(projected)}"
    return "\n".join(
        ["template <typename T, typename P, typename Emit>",
         f"__device__ __forceinline__ void {name}(const T* f, const P& p, "
         "Emit& emit) {"] + tr.lines + emits + ["}", ""])


def _collide_trace(nvel: int, delta: bool, projected: bool,
                   site_force: bool = False):
    """(trace, tail lines) of one site's collision.  The force is the
    global one (p.fx, p.fy, p.fz) or, with `site_force`, the site's total
    fs[0..3) (per-site + global, summed in the kernel where the global one
    is non-zero, as ops/fused.py _collide does); then the tail also
    stores the collision-time velocity in u[0..3)."""
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
    modes, u = fused._relax_modes(model, fl, _Sym(tr, "p.rt"),
                                  _Sym(tr, "p.rtb"), ftot, [True] * 3,
                                  gcoef, delta)
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
    """lb_generated.h for one velocity set."""
    model = lb_model(nvel)
    parts = [f"// Generated by ludwig_tpu_torch/ops/_cuda.py for D3Q{nvel}"
             " from lattice.py; do not edit.",
             "#pragma once",
             f"#define LB_NVEL {nvel}",
             f"#define LB_NGHOST {nvel - model.nhydro}", ""]
    for delta in (False, True):
        for projected in (False, True):
            parts.append(_collide_source(nvel, delta, projected))
    for projected in (False, True):
        parts.append(_collide_force_source(nvel, projected))
    return "\n".join(parts)


def _binary_trace(order: int, level1_once: bool = False):
    """Trace of one site of the binary order-parameter update.  Loads are
    P(dx, dy, dz) (phi) and U(a, dx, dy, dz) (u_a) at offsets; the
    constants are p.<name> of ops/fused_binary._Consts.  With
    level1_once the six neighbours' level-1 values are loads too, which
    leaves the operations an implementation computing each site's
    level-1 values once would do (the bound's operation count)."""
    from ludwig_tpu_torch.ops import fused_binary as fb

    tr = _Trace()
    loads = {}

    def load(expr):
        if expr not in loads:
            loads[expr] = tr.load(expr)
        return loads[expr]

    def P(*o):
        return load(f"P({o[0]}, {o[1]}, {o[2]})")

    def U(a, *o):
        return load(f"U({a}, {o[0]}, {o[1]}, {o[2]})")

    def L1(o):
        if level1_once and o != (0, 0, 0):
            n = "_".join(str(v) for v in o)
            return (P(*o), [load(f"g{a}_{n}") for a in range(3)],
                    load(f"mu_{n}"), load(f"p0_{n}"))
        return fb._level1(P, o, c)

    def select(x, p, q):
        return tr.op(f"sel({x.name}, {_lit(p)}, {_lit(q)})")

    c = fb._Consts(*(_Sym(tr, f"p.{k}") for k in fb._Consts._fields))
    phinew, force = fb._binary_site(L1, U, c, order, select)
    outs = [f"  out[0] = {phinew.name};"] + [
        f"  out[{1 + a}] = {force[a].name};" for a in range(3)]
    return tr, outs


def generate_binary_header() -> str:
    """binary_generated.h: binary_site_o1 / _o2, one site of K1 for each
    advection order."""
    parts = ["// Generated by ludwig_tpu_torch/ops/_cuda.py from "
             "ops/fused_binary.py; do not edit.", "#pragma once", ""]
    for order in (1, 2):
        tr, outs = _binary_trace(order)
        parts.append("\n".join(
            ["template <typename T, typename LP, typename LU>",
             f"__device__ __forceinline__ void binary_site_o{order}("
             "const LP& P, const LU& U, const BinParams<T>& p, T* out) {"]
            + tr.lines + outs + ["}", ""]))
    return "\n".join(parts)


def site_ops(kernel: str, nvel: int = 19, order: int = 2,
             delta: bool = True) -> int:
    """Arithmetic operations per site and step the function needs, for
    the bound: the M10 collision (fused_step, fusedn_step), the M10
    collision with a per-site force (fused_force_step, plus the three
    additions of a non-zero global force at most), or the binary site
    update with level-1 values computed once per site
    (binary_phi_force_step)."""
    if kernel in ("fused_step", "fusedn_step"):
        return _collide_trace(nvel, delta, True)[0].nops
    if kernel == "fused_force_step":
        return _collide_trace(nvel, True, True, site_force=True)[0].nops + 3
    if kernel == "binary_phi_force_step":
        return _binary_trace(order, level1_once=True)[0].nops
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


def _lib_name(nvel: int) -> str:
    return f"fused_lb_q{nvel}"


def _lib_path(name: str, src: Path, header: str) -> Path:
    key = hashlib.sha256((src.read_text() + header
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
    lib.lb_fused_step.argtypes = [ci, ci, ci, vp, vp, ci, ci, ci, dp, vp,
                                  ci]
    lib.lb_fused_step.restype = ci
    lib.lb_fusedn_step.argtypes = [ci, ci, ci, vp, vp, ci, ci, ci, ci, ci,
                                   ci, ci, vp, cll, ci, ci, dp, vp, ci]
    lib.lb_fusedn_step.restype = ci
    lib.lb_fused_force_step.argtypes = [ci, ci, vp, vp, vp, vp, ci, ci, ci,
                                        dp, vp, ci]
    lib.lb_fused_force_step.restype = ci
    if lib.lb_nvel() != nvel:
        raise RuntimeError(f"{path} was built for nvel={lib.lb_nvel()}")
    return lib


def _bind_binary(path: Path):
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lb_binary_phi_force.argtypes = [
        ci, ci, vp, vp, vp, vp, ci, ci, ci, ctypes.POINTER(ctypes.c_double),
        vp, ci]
    lib.lb_binary_phi_force.restype = ci
    return lib


def build(nvels=KERNEL_NVELS, binary: bool = True) -> dict:
    """Compile (where not already built) and load the kernel library of
    each velocity set and, with `binary`, the binary-fluid library; the
    nvcc runs go in parallel, and each writes its ptxas report
    (registers, spills) beside the library.  Returns {library name:
    path}."""
    bad = [nvel for nvel in nvels if nvel not in KERNEL_NVELS]
    if bad:
        raise ValueError(f"no CUDA kernel for nvel={bad}; "
                         f"built for {KERNEL_NVELS}")
    jobs = {_lib_name(nvel): (CSRC, "lb_generated.h",
                              lambda nvel=nvel: generate_header(nvel),
                              lambda p, nvel=nvel: _bind_lb(p, nvel))
            for nvel in nvels}
    if binary:
        jobs[BINARY_LIB] = (CSRC_BINARY, "binary_generated.h",
                            generate_binary_header, _bind_binary)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, done = {}, {}
    for name, (src, header_name, gen_header, _b) in jobs.items():
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


def _lib(nvel: int):
    name = _lib_name(nvel)
    if name not in _libs:
        build((nvel,), binary=False)
    return _libs[name][0]


def _binary_lib():
    if BINARY_LIB not in _libs:
        build((), binary=True)
    return _libs[BINARY_LIB][0]


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
                           f.data_ptr(), out.data_ptr(), X, Y, Z, par,
                           stream, f.device.index)
    _raise_on(rc, "fused_step")
    launches.fused_step += 1
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
                          order: int):
    """Launch the binary order-parameter kernel; returns (phi', force).
    `consts` is ops/fused_binary._Consts of Python floats; the caller has
    checked shapes, dtypes and contiguity."""
    _check_cuda_state(phi)
    lib = _binary_lib()
    par = (ctypes.c_double * len(consts))(*(float(v) for v in consts))
    phi_out = torch.empty_like(phi)
    force = torch.empty_like(u)
    X, Y, Z = phi.shape
    stream = torch.cuda.current_stream(phi.device).cuda_stream
    rc = lib.lb_binary_phi_force(int(phi.dtype == torch.float64), order,
                                 phi.data_ptr(), u.data_ptr(),
                                 phi_out.data_ptr(), force.data_ptr(), X, Y,
                                 Z, par, stream, phi.device.index)
    _raise_on(rc, "binary_phi_force_step")
    launches.binary_phi_force_step += 1
    return phi_out, force


def _window_sites(plan, halo: int) -> int:
    return ((plan.BX + 2 * halo) * (plan.BY + 2 * halo)
            * (plan.BZ + 2 * halo))


def _nstep_scratch(model, plan, nsteps: int) -> int:
    """Elements of intermediate state one block of the n-step kernel
    holds: the step-0 output window (halo n-1) and the step-1 output
    window (halo n-2), ping-ponged."""
    sites = (_window_sites(plan, nsteps - 1) if nsteps >= 2 else 0) + (
        _window_sites(plan, nsteps - 2) if nsteps >= 3 else 0)
    return model.nvel * sites


def _device_info(lib, dev: int):
    """(multiprocessors, shared-memory opt-in bytes per block)."""
    sms, smem_optin = ctypes.c_int(), ctypes.c_int()
    _raise_on(lib.lb_device_info(dev, ctypes.byref(sms),
                                 ctypes.byref(smem_optin)), "device query")
    return sms.value, smem_optin.value


def nstep_in_shared(f: torch.Tensor, model, plan, nsteps: int) -> bool:
    """Whether the n-step kernel keeps one block's intermediate windows in
    shared memory on f's card (else in global scratch)."""
    _check_cuda_state(f)
    optin = _device_info(_lib(model.nvel), f.device.index)[1]
    return _nstep_scratch(model, plan, nsteps) * f.element_size() <= optin


def fusedn_step(f: torch.Tensor, model, params, nsteps: int, plan,
                delta: bool) -> torch.Tensor:
    """Launch the n-step kernel.  The intermediate windows live in
    shared memory when one block's fit the card's opt-in limit, and
    otherwise in a global scratch allocated here, one slice per resident
    block of a persistent grid."""
    _check_cuda_state(f)
    lib = _lib(model.nvel)
    proj, par = _kernel_params(model, params, delta)
    X, Y, Z = f.shape[1:]
    ntiles = (-(-X // plan.BX)) * (-(-Y // plan.BY)) * (-(-Z // plan.BZ))
    dev = f.device.index
    per_block = _nstep_scratch(model, plan, nsteps)
    scratch = None
    if nstep_in_shared(f, model, plan, nsteps):
        grid, smem = ntiles, per_block * f.element_size()
    else:
        sms = _device_info(lib, dev)[0]
        grid, smem = min(ntiles, sms * BLOCKS_PER_SM), 0
        scratch = torch.empty(grid * per_block, dtype=f.dtype,
                              device=f.device)
    out = torch.empty_like(f)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.lb_fusedn_step(
        int(f.dtype == torch.float64), int(delta), proj, f.data_ptr(),
        out.data_ptr(), X, Y, Z, nsteps, plan.BX, plan.BY, plan.BZ,
        None if scratch is None else scratch.data_ptr(), per_block, grid,
        smem, par, stream, dev)
    _raise_on(rc, "fusedn_step")
    launches.fusedn_step += 1
    return out
