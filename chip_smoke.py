#!/usr/bin/env python
"""Smoke run of ludwig_tpu_torch on one NVIDIA GPU: build, check, run, time.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. the card (nvidia-smi name and power limit) and the CUDA version;
  2. build the CUDA kernels from ludwig_tpu_torch/csrc into the package's
     git-ignored build directory;
  3. each kernel against its plain PyTorch twin on the card, 3 chained
     steps, over velocity sets, relaxation schemes, both back-transform
     forms and both dtypes;
  4. the n-step kernel bitwise against n single-step launches, n in 1..8,
     on the default tile (windows in global scratch) and on small tiles
     whose windows fit in shared memory;
  5. the main path at full width: D3Q19 256^3 f32 (the flagship
     configuration of bench.py) for 40 cycles through run_text on the
     card, plus the bench's n-step loop (n=6, absolute form) through
     make_fusedn_nstep; the kernel launch counts of this phase show the
     path used the kernels;
  6. at 256^3: each kernel against its twin within TOL, and kernel, twin
     and device-copy times (ms/step and MLUPS).

The second-to-last line is the kernels' JSON record (ms and plain_ms per
lattice step, CUDA events), the last line {"ok": true, "device": {...}}.
There is no CPU path.
"""

import io
import json
import re
import subprocess
import sys
import time

import torch

from ludwig_tpu_torch.lb import LBConfig, initial_rest
from ludwig_tpu_torch.ludwig import run_text
from ludwig_tpu_torch.ops import _cuda, fused
from ludwig_tpu_torch.ops.collide import RelaxationScheme

SOURCE = "ludwig_tpu_torch/csrc/fused_lb.cu"
# f64: kernel and twin evaluate one expression tree operation by operation
# (nvcc -fmad=false); what is left is the twin folding a few scalar
# products in double before rounding (rdim * rtb, coef * force) and
# torch's reciprocal for 1/rho, ulp-level on O(1e-1) values.  f32: the
# same ulp-level differences at float precision, grown over 3 steps.
TOL = {torch.float64: dict(rtol=1e-12, atol=1e-13),
       torch.float32: dict(rtol=1e-5, atol=1e-7)}
MAIN_SIZE = (256, 256, 256)
MAIN_CYCLES = 40
BENCH_NSTEPS = 6        # bench.py's first n (absolute form, delta=False)
NSTEPS = (1, 2, 3, 4, 6, 8)
# tiles whose D3Q19 windows fit the H100's 227 KB shared-memory opt-in
# in f32 and f64 (the default FusedPlan's go to global scratch for n >= 2)
SMEM_CASES = ((2, fused.FusedPlan(4, 4, 32)), (3, fused.FusedPlan(2, 2, 16)),
              (4, fused.FusedPlan(2, 2, 8)))


def phase(name):
    print(f"== {name}", flush=True)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def rand_state(cfg, gen, amp=0.05):
    w = torch.as_tensor(cfg.model.wv, dtype=cfg.tdtype, device="cuda")
    noise = torch.randn((cfg.nvel,) + cfg.size, generator=gen,
                        dtype=cfg.tdtype, device="cuda")
    return (w.reshape(-1, 1, 1, 1) * (1.0 + amp * noise)).contiguous()


def max_err(a, b):
    return float((a - b).abs().max())


def check_close(what, a, b, dtype):
    torch.cuda.synchronize()
    err = max_err(a, b)
    if not torch.allclose(a, b, **TOL[dtype]):
        raise AssertionError(f"{what}: max |diff| {err:.3e} beyond "
                             f"{TOL[dtype]}")
    return err


def time_ms(fn, reps, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def cases():
    for nvel in (15, 19, 27):
        for scheme in ("m10", "bgk", "trt"):
            if not (scheme == "trt" and nvel == 27):   # ref asserts
                yield nvel, RelaxationScheme(scheme)


def phase3(gen):
    phase("3 kernels vs plain twins (3 chained steps)")
    worst = {"fused_step": 0.0, "fusedn_step": 0.0}
    for size in ((16, 24, 40), (64, 64, 64)):
        for nvel, scheme in cases():
            for dtype in ("float64", "float32"):
                cfg = LBConfig(size=size, nvel=nvel, eta_shear=0.1,
                               eta_bulk=0.14, scheme=scheme, dtype=dtype,
                               force_global=(1e-4, -2e-4, 5e-5),
                               device="cuda")
                model, params = cfg.model, cfg.collision_params()
                f0 = rand_state(cfg, gen)
                for delta in (True, False):
                    a = b = f0
                    for _ in range(3):
                        a = fused.fused_step(a, model, params, delta=delta)
                        b = fused._fused_step_plain(b, model, params, delta)
                    err = check_close(f"fused_step {size} q{nvel} "
                                      f"{scheme.value} {dtype} "
                                      f"delta={delta}", a, b, cfg.tdtype)
                    worst["fused_step"] = max(worst["fused_step"], err)
                    print(f"fused_step {size} D3Q{nvel} {scheme.value} "
                          f"{dtype} delta={delta} max_abs_err {err:.3e}")
    # the n-step twin walks the kernel's own tiles in Python: small sizes
    for nvel, scheme in cases():
        cfg = LBConfig(size=(16, 24, 40), nvel=nvel, eta_shear=0.1,
                       eta_bulk=0.14, scheme=scheme, dtype="float64",
                       force_global=(1e-4, -2e-4, 5e-5), device="cuda")
        model, params = cfg.model, cfg.collision_params()
        f0 = rand_state(cfg, gen)
        for delta in (True, False):
            a = fused.fusedn_step(f0, model, params, 3, delta=delta)
            b = fused._fusedn_step_plain(f0, model, params, 3,
                                         fused.FusedPlan(), delta)
            err = check_close(f"fusedn_step q{nvel} {scheme.value} "
                              f"delta={delta}", a, b, cfg.tdtype)
            worst["fusedn_step"] = max(worst["fusedn_step"], err)
            print(f"fusedn_step n=3 (16, 24, 40) D3Q{nvel} {scheme.value} "
                  f"float64 delta={delta} max_abs_err {err:.3e}")
    return worst


def phase4(gen):
    phase("4 n-step kernel vs n single-step launches (32, 32, 64) D3Q19, "
          "bitwise")
    cases = ([(n, fused.FusedPlan(), n == 1) for n in NSTEPS]
             + [(n, plan, True) for n, plan in SMEM_CASES])
    for dtype in ("float64", "float32"):
        cfg = LBConfig(size=(32, 32, 64), nvel=19, eta_shear=0.1,
                       eta_bulk=0.1, force_global=(1e-5, 0.0, 0.0),
                       dtype=dtype, device="cuda")
        model, params = cfg.model, cfg.collision_params()
        f0 = rand_state(cfg, gen)
        for n, plan, shared in cases:
            where = "shared" if shared else "global"
            if _cuda.nstep_in_shared(f0, model, plan, n) != shared:
                raise AssertionError(f"n={n} {plan} {dtype}: windows not "
                                     f"in {where} memory")
            for delta in (True, False):
                a = fused.fusedn_step(f0, model, params, n, plan, delta)
                b = fused.make_fused_nstep(model, params,
                                           delta=delta)(f0, n)
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"fusedn n={n} {plan} {dtype} delta={delta}: max "
                        f"|diff| {max_err(a, b):.3e}, not bitwise")
                print(f"fusedn_step n={n} tile {plan.BX}x{plan.BY}x{plan.BZ}"
                      f" ({where}) {dtype} delta={delta} bitwise")


MAIN_INPUT = f"""
size {MAIN_SIZE[0]}_{MAIN_SIZE[1]}_{MAIN_SIZE[2]}
tpu_fused on
dtype float32
viscosity 0.1
viscosity_bulk 0.1
N_cycles {MAIN_CYCLES}
freq_statistics 20
"""


def phase5():
    phase("5 main path: D3Q19 256^3 f32, run_text on cuda + n-step bench")
    cfg = LBConfig(size=MAIN_SIZE, nvel=19, eta_shear=0.1, eta_bulk=0.1,
                   dtype="float32", device="cuda")
    torch.cuda.synchronize()
    _cuda.launches.reset()
    log = io.StringIO()
    t0 = time.perf_counter()
    run_text(MAIN_INPUT, out=log, device="cuda")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = _cuda.launches.fused_step
    # the bench entry: the n-step kernel from rest, as bench.py drives it
    # (its first rung, n=6, make_fusedn_nstep's default absolute form)
    nstep = fused.make_fusedn_nstep(cfg.model, cfg.collision_params(),
                                    BENCH_NSTEPS)
    fb = nstep(initial_rest(cfg), 2 * BENCH_NSTEPS)
    torch.cuda.synchronize()
    counts = {"fused_step": _cuda.launches.fused_step,
              "fusedn_step": _cuda.launches.fusedn_step}
    text = log.getvalue()
    print(text[text.rfind("Scalars"):text.rfind("Completed")].strip())
    if f"Completed cycle {MAIN_CYCLES}" not in text:
        raise AssertionError("run_text did not complete its cycles")
    nsite = MAIN_SIZE[0] * MAIN_SIZE[1] * MAIN_SIZE[2]
    totals = [float(v) for v in re.findall(r"\[rho\]\s+(\S+)", text)]
    # increment form keeps mass to f32 rounding (ACCURACY.md:62-71)
    if not all(abs(t - nsite) <= 1e-5 * nsite for t in totals):
        raise AssertionError(f"[rho] totals {totals} != {nsite}")
    if cli_launches != MAIN_CYCLES:
        raise AssertionError(f"fused_step launched {cli_launches} times "
                             f"for {MAIN_CYCLES} cycles")
    if counts["fusedn_step"] != 2:
        raise AssertionError(f"fusedn_step launched {counts['fusedn_step']}"
                             " times for 2 bench passes")
    mass = float(fb.double().sum())
    if not torch.isfinite(fb).all() or abs(mass - nsite) > 1e-5 * nsite:
        raise AssertionError(f"n-step bench state mass {mass} != {nsite}")
    print(f"run_text 256^3 x {MAIN_CYCLES} cycles: {cli_s:.2f} s wall, "
          f"[rho] totals {totals}, launches {counts}")
    return counts


def phase6(card, gen):
    phase(f"6 timing at 256^3 D3Q19 f32 on {card}")
    cfg = LBConfig(size=MAIN_SIZE, nvel=19, eta_shear=0.1, eta_bulk=0.1,
                   dtype="float32", device="cuda")
    model, params = cfg.model, cfg.collision_params()
    f0 = rand_state(cfg, gen, amp=0.01)
    nsite = MAIN_SIZE[0] * MAIN_SIZE[1] * MAIN_SIZE[2]

    nbytes = 2 * f0.numel() * f0.element_size()   # one read + one write

    def report(name, ms_step):
        print(f"{name}: {ms_step:.4f} ms/step [{card}]")
        print(f"{name}: {nsite / (ms_step * 1e3):.1f} MLUPS [{card}]")

    def twin_steps(n, delta):
        f = f0
        for _ in range(n):
            f = fused._fused_step_plain(f, model, params, delta)
        return f

    # the card's copy bandwidth on the state: the single step's bound
    dst = torch.empty_like(f0)
    copy_ms = time_ms(lambda: dst.copy_(f0), 20)
    del dst
    print(f"device copy of the state: {copy_ms:.4f} ms = "
          f"{nbytes / (copy_ms * 1e9):.3f} TB/s read+write [{card}]")

    res = {}
    plain_ms = time_ms(lambda: twin_steps(1, True), 3, warm=1)
    report("plain twin fused_step (delta)", plain_ms)
    step_ms = time_ms(lambda: fused.fused_step(f0, model, params), 20)
    report("kernel fused_step (delta)", step_ms)
    print(f"kernel fused_step (delta): {nbytes / (step_ms * 1e9):.3f} TB/s "
          f"= {100 * copy_ms / step_ms:.1f}% of the device copy [{card}]")
    err = check_close("fused_step 256^3", fused.fused_step(f0, model, params),
                      twin_steps(1, True), cfg.tdtype)
    print(f"fused_step 256^3 float32 delta=True vs twin max_abs_err "
          f"{err:.3e}")
    res["fused_step"] = dict(ms=step_ms, plain_ms=plain_ms, max_abs_err=err)
    for n in NSTEPS:
        ms = time_ms(lambda: fused.fusedn_step(f0, model, params, n,
                                               delta=True), 5)
        report(f"kernel fusedn_step n={n} (delta)", ms / n)
    # the bench's form: n=6, absolute back transform
    n = BENCH_NSTEPS
    ms = time_ms(lambda: fused.fusedn_step(f0, model, params, n), 5) / n
    report(f"kernel fusedn_step n={n} (absolute)", ms)
    twin_ms = time_ms(lambda: twin_steps(n, False), 1, warm=1) / n
    report(f"plain twin {n} x fused_step (absolute)", twin_ms)
    err = check_close(f"fusedn_step n={n} 256^3",
                      fused.fusedn_step(f0, model, params, n),
                      twin_steps(n, False), cfg.tdtype)
    print(f"fusedn_step n={n} 256^3 float32 delta=False vs {n} twin steps "
          f"max_abs_err {err:.3e}")
    res["fusedn_step"] = dict(ms=ms, plain_ms=twin_ms, max_abs_err=err)
    return res


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU; none is visible")
    phase("1 card")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("2 build")
    t0 = time.perf_counter()
    built = _cuda.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst = phase3(gen)
    phase4(gen)
    counts = phase5()
    timed = phase6(card, gen)
    print("all phases passed")

    kernels = []
    for name, line in (("fused_step", 429), ("fusedn_step", 902)):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"ludwig_tpu/ops/fused.py:{line}",
            "launches": counts[name],
            "max_abs_err": max(worst[name], timed[name]["max_abs_err"]),
            "ms": timed[name]["ms"], "plain_ms": timed[name]["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
