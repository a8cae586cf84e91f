"""Build, bind and launch the hand-written CUDA kernels (csrc/fused_lb.cu).

At first use, ``nvcc`` compiles ``csrc/fused_lb.cu`` for Hopper (sm_90a)
into a shared library with a plain C interface, one library per velocity
set, under ``build/kernels/`` inside the package; ``ctypes`` loads it.
Nothing is built or loaded when the module is imported, so the CPU tests
import it freely.

The collision of each velocity set reaches the kernel as straight-line
C++ generated from the port's own Python (ops/fused.py ``_relax_modes``,
``_assemble_eo`` and friends, traced with symbols instead of tensors) and
from the model tables of lattice.py.  Kernel and twin therefore evaluate
the same expression tree, with the same constants.

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

    def reset(self):
        self.fused_step = 0
        self.fusedn_step = 0


launches = LaunchCounts()
_libs = {}      # nvel -> loaded ctypes library (process-wide cache)


# -- code generation ----------------------------------------------------------

class _Trace:
    """Records straight-line C++ (one const temporary per operation)."""

    def __init__(self):
        self.lines = []

    def op(self, expr):
        name = f"t{len(self.lines)}"
        self.lines.append(f"  const T {name} = {expr};")
        return _Sym(self, name)


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
    from ludwig_tpu_torch.ops import fused

    model = lb_model(nvel)
    tr = _Trace()
    fl = [_Sym(tr, f"f[{q}]") for q in range(nvel)]
    ftot = [_Sym(tr, f"p.f{a}") for a in "xyz"]
    nghost = nvel - model.nhydro
    if projected:
        # every ghost rate is 1: the JAX twin's constants exactly
        gcoef = [-1.0 if delta else 0.0] * nghost
    else:
        gcoef = [_Sym(tr, f"p.g[{i}]") for i in range(nghost)]
    modes, _u = fused._relax_modes(model, fl, _Sym(tr, "p.rt"),
                                   _Sym(tr, "p.rtb"), ftot, [True] * 3,
                                   gcoef, delta)
    emits = []

    def emit(acc, q):
        cx, cy, cz = (int(c) for c in model.cv[q])
        emits.append(f"  emit({q}, {cx}, {cy}, {cz}, {acc.name});")

    if delta:
        fused._assemble_eo_deltas(model, fl, modes, emit)
    else:
        fused._assemble_eo(model, modes, emit)
    name = f"lb_collide_d{int(delta)}_p{int(projected)}"
    return "\n".join(
        ["template <typename T, typename P, typename Emit>",
         f"__device__ __forceinline__ void {name}(const T* f, const P& p, "
         "Emit& emit) {"] + tr.lines + emits + ["}", ""])


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
    return "\n".join(parts)


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


def _lib_path(nvel: int, header: str) -> Path:
    key = hashlib.sha256((CSRC.read_text() + header
                          + " ".join(NVCC_FLAGS)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfused_lb_q{nvel}_{key}.so"


def _bind(path: Path, nvel: int):
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
    if lib.lb_nvel() != nvel:
        raise RuntimeError(f"{path} was built for nvel={lib.lb_nvel()}")
    return lib


def build(nvels=KERNEL_NVELS) -> dict:
    """Compile (where not already built) and load the kernel library of
    each velocity set; the nvcc runs go in parallel, and each writes its
    ptxas report (registers, spills) beside the library.  Returns
    {nvel: library path}."""
    bad = [nvel for nvel in nvels if nvel not in KERNEL_NVELS]
    if bad:
        raise ValueError(f"no CUDA kernel for nvel={bad}; "
                         f"built for {KERNEL_NVELS}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, done = {}, {}
    for nvel in nvels:
        if nvel in _libs:
            done[nvel] = _libs[nvel][1]
            continue
        header = generate_header(nvel)
        path = _lib_path(nvel, header)
        if path.exists():
            done[nvel] = path
            continue
        gen = BUILD_DIR / f"gen_q{nvel}"
        gen.mkdir(exist_ok=True)
        (gen / "lb_generated.h").write_text(header)
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(gen), "-o", str(tmp),
               str(CSRC)]
        todo[nvel] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for nvel, (path, tmp, proc) in todo.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for D3Q{nvel}:\n{log}")
        path.with_suffix(".ptxas.txt").write_text(log)
        tmp.replace(path)
        done[nvel] = path
    for nvel, path in done.items():
        if nvel not in _libs:
            _libs[nvel] = (_bind(path, nvel), path)
    return done


def _lib(nvel: int):
    if nvel not in _libs:
        build((nvel,))
    return _libs[nvel][0]


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
