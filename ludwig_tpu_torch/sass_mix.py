"""The instruction mix of the LC and droplet K1 marches' loops, read from
their SASS: a development probe for the analysis in PERF.md, not part of
the simulation.  It builds the two libraries from csrc/ (as the kernels'
first launch does) and disassembles them with the toolkit's cuobjdump.

    python3 -m ludwig_tpu_torch.sass_mix

prints, for each loop of at least 200 instructions in the f32 kernels
(level 1, the site update, the x loop around both), its instructions,
its f32 arithmetic and shared-memory loads, and its most frequent
opcodes."""

import re
import subprocess
from pathlib import Path

from ludwig_tpu_torch.ops import _cuda

# library, the mangled name of its f32 (order 1) K1 kernel
KERNELS = ((_cuda.LC_LIB, "lc_q_force_kernelIfE"),
           (_cuda.DROPLET_LIB, "droplet_kernelIfLi1EE"))


def sass_loops(path, pattern, least=200):
    """The loops (a backward branch and what it jumps over) of at least
    `least` instructions in the first kernel of the library at `path`
    whose mangled name contains `pattern`: a list of (instructions, f32
    arithmetic, shared-memory loads, top opcodes)."""
    tool = Path(_cuda._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs = [f for f in text.split("Function : ")[1:]
             if pattern in f.splitlines()[0]]
    if not funcs:
        raise RuntimeError(f"no kernel {pattern} in {path}")
    code = []
    for line in funcs[0].splitlines():
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)[^;]*?(?:0x([0-9a-f]+))?\s*;", line)
        if m:
            code.append((int(m[1], 16), m[2], m[3]))
    at = {a: k for k, (a, _op, _t) in enumerate(code)}
    loops = []
    for k, (a, op, target) in enumerate(code):
        if op == "BRA" and target and int(target, 16) <= a:
            body = [o for _a, o, _t in code[at[int(target, 16)]:k + 1]]
            if len(body) >= least:
                ops = {}
                for o in body:
                    ops[o] = ops.get(o, 0) + 1
                fp = sum(ops.get(o, 0) for o in ("FADD", "FMUL", "FFMA"))
                top = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
                loops.append((len(body), fp, ops.get("LDS", 0), top))
    return loops


def main():
    built = _cuda.build(tuple(lib for lib, _p in KERNELS))
    for lib, pattern in KERNELS:
        for n, fp, lds, top in sass_loops(built[lib], pattern):
            print(f"{lib} SASS loop ({pattern}): {n} instructions, f32 "
                  f"arithmetic {fp} ({100 * fp / n:.1f}%), LDS {lds}; "
                  f"most frequent {top}")


if __name__ == "__main__":
    main()
