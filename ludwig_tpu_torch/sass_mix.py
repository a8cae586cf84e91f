"""The instruction mix of hand-written kernels, read from their SASS: a
development probe for the analysis in PERF.md, not part of the
simulation.  It builds the kernels' libraries from csrc/ (as a kernel's
first launch does) and disassembles them with the toolkit's cuobjdump.

    python3 -m ludwig_tpu_torch.sass_mix [KERNEL ...]

KERNEL is a kernel's name (a key of KERNELS; default: the LC and
droplet K1 marches).  For each, its f32 instance (order 1; np_gradmu's
with hydrodynamics and at most two species) is read: its whole mix
(instructions, f32 arithmetic, transcendental and shared- and
global-memory instructions, the most frequent opcodes), then each loop
of at least 100 instructions the same way."""

import re
import subprocess
import sys
from pathlib import Path

from ludwig_tpu_torch.ops import _cuda

# kernel name -> (library, the mangled name of its f32 instance: order 1;
# for np_gradmu with hydrodynamics, for at most two species)
KERNELS = {
    "lc_q_force_kernel": (_cuda.LC_LIB, "lc_q_force_kernelIfE"),
    "droplet_kernel": (_cuda.DROPLET_LIB, "droplet_kernelIfLi1EE"),
    "binary_phi_force_kernel": (_cuda.BINARY_LIB,
                                "binary_phi_force_kernelIfLi1EE"),
    "np_gradmu_kernel": (_cuda.ELECTRO_LIB, "np_gradmu_kernelIfLi1ELi2E"),
}
DEFAULT = ("lc_q_force_kernel", "droplet_kernel")
FP32 = ("FADD", "FMUL", "FFMA")


def sass_code(path, pattern):
    """[(address, opcode, branch target or None)] of the first kernel of
    the library at `path` whose mangled name contains `pattern`."""
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
    return code


def mix(ops):
    """(instructions, f32 arithmetic, MUFU, LDS + STS, LDG + STG, the ten
    most frequent opcodes) of a list of opcodes."""
    count = {}
    for o in ops:
        count[o] = count.get(o, 0) + 1
    fp = sum(count.get(o, 0) for o in FP32)
    shared = count.get("LDS", 0) + count.get("STS", 0)
    glob = count.get("LDG", 0) + count.get("STG", 0)
    top = sorted(count.items(), key=lambda kv: -kv[1])[:10]
    return len(ops), fp, count.get("MUFU", 0), shared, glob, top


def sass_loops(code, least=100):
    """The loops (a backward branch and what it jumps over) of at least
    `least` instructions: a list of mix() of each."""
    at = {a: k for k, (a, _op, _t) in enumerate(code)}
    loops = []
    for k, (a, op, target) in enumerate(code):
        if op == "BRA" and target and int(target, 16) <= a:
            body = [o for _a, o, _t in code[at[int(target, 16)]:k + 1]]
            if len(body) >= least:
                loops.append(mix(body))
    return loops


def _line(what, m):
    n, fp, mufu, shared, glob, top = m
    return (f"{what}: {n} instructions, f32 arithmetic {fp} "
            f"({100 * fp / n:.1f}%), MUFU {mufu}, LDS+STS {shared}, "
            f"LDG+STG {glob}; most frequent {top}")


def main(argv=None):
    names = tuple(argv if argv else DEFAULT)
    bad = [n for n in names if n not in KERNELS]
    if bad:
        raise SystemExit(f"no kernel {bad}; there are {tuple(KERNELS)}")
    built = _cuda.build(tuple({KERNELS[n][0] for n in names}))
    for name in names:
        lib, pattern = KERNELS[name]
        code = sass_code(built[lib], pattern)
        print(_line(f"{lib} SASS ({pattern}) whole kernel",
                    mix([o for _a, o, _t in code])))
        for m in sass_loops(code):
            print(_line(f"{lib} SASS loop ({pattern})", m))


if __name__ == "__main__":
    main(sys.argv[1:])
