"""Floating-point-tolerant log diff: the reference regression contract.

Python port of the reference's test harness (ref: tests/test-diff.sh:80-137
filter list, tests/awk-fp-diff.sh TOLERANCE=1.0e-12 token comparison);
the PyTorch port's copy of ludwig_tpu/utils/fpdiff.py, which it does not
import.
Two log lines match when they are string-equal, or token-wise equal with
floating-point tokens agreeing within 1e-12 ABSOLUTE tolerance.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

TOLERANCE = 1.0e-12

# Lines removed before comparison (ref: test-diff.sh sed list).
_FILTERS = [
    r"call\)", r"calls\)", r"Welcome", r"Git commit:", r"Compiler:",
    r"^..name:", r"^..version-string:", r"^..options:",
    r"Target thread model:", r"Default threads per block", r"OpenMP",
    r"Note assertions", r"^\s*$", r"Timer", r"user.parameters.from",
    r"GPU INFO", r"SIMD vector", r"Start time", r"End time",
    r"SVN revision",
]
_FILTER_RE = [re.compile(p) for p in _FILTERS]

_FLOAT_RE = re.compile(r"^[-+]?[0-9]*\.?[0-9]+(e[-+]?[0-9]+)?$")

# The statistics sub-surface: the physics-bearing lines.  Used for the
# scoreboard's "stats parity" mode while full banner parity is built out.
_STATS_RE = re.compile(
    r"^(\[(rho|phi|psi|elc|fed|fe|Qxx|Qxy|Qxz|Qyy|Qyz|Px |Py |Pz |total"
    r"|fluid|walls|colloids|minimum|maximum)"
    r"|Scalars -|Momentum -|Velocity -|Completed cycle"
    r"|Free energy density|Free energies|Colloid velocities)")


def filter_lines(text: str) -> List[str]:
    out = []
    for line in text.splitlines():
        if any(r.search(line) for r in _FILTER_RE):
            continue
        line = line.replace("d2q9 R", "d2q9").replace(
            "d3q15 R", "d3q15").replace("d3q19 R", "d3q19")
        out.append(line)
    return out


def stats_lines(text: str) -> List[str]:
    return [ln for ln in filter_lines(text) if _STATS_RE.match(ln)]


def _is_float(tok: str) -> bool:
    return bool(_FLOAT_RE.match(tok))


_GLUE_RE = re.compile(r"(e[+-]\d{2,3})(?=[+-]\d)")


def _tokens(line: str):
    """Whitespace tokens, with glued %14.7e%14.7e pairs split: committed
    reference logs mix printf formats across eras ('%14.7e%14.7e' glued
    pairs in older logs vs all-spaced in newer ones), so a negative
    second number can fuse two tokens into one."""
    return _GLUE_RE.sub(r"\1 ", line).split()


def lines_equal(a: str, b: str, tol: float = TOLERANCE) -> bool:
    if a == b:
        return True
    ta, tb = _tokens(a), _tokens(b)
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if x == y:
            continue
        if _is_float(x) and _is_float(y):
            if abs(float(x) - float(y)) >= tol:
                return False
        else:
            return False
    return True


def fp_diff(ref_lines: List[str], out_lines: List[str],
            tol: float = TOLERANCE) -> List[str]:
    """LCS diff with FP-tolerant line equality; returns diff lines in the
    reference's '<line> </> text' style (empty list == match)."""
    n, m = len(ref_lines), len(out_lines)
    # trim the common prefix/suffix first (as the awk script does)
    lo = 0
    while lo < n and lo < m and lines_equal(ref_lines[lo], out_lines[lo],
                                            tol):
        lo += 1
    hi = 0
    while (hi < n - lo and hi < m - lo
           and lines_equal(ref_lines[n - 1 - hi], out_lines[m - 1 - hi],
                           tol)):
        hi += 1
    a = ref_lines[lo:n - hi]
    b = out_lines[lo:m - hi]
    la, lb = len(a), len(b)
    if la == 0 and lb == 0:
        return []
    # LCS table
    L = [[0] * (lb + 1) for _ in range(la + 1)]
    for i in range(la - 1, -1, -1):
        for j in range(lb - 1, -1, -1):
            if lines_equal(a[i], b[j], tol):
                L[i][j] = L[i + 1][j + 1] + 1
            else:
                L[i][j] = max(L[i + 1][j], L[i][j + 1])
    diffs = []
    i = j = 0
    while i < la and j < lb:
        if lines_equal(a[i], b[j], tol):
            i += 1
            j += 1
        elif L[i + 1][j] >= L[i][j + 1]:
            diffs.append(f"{lo + i + 1} < {a[i]}")
            i += 1
        else:
            diffs.append(f"{lo + j + 1} > {b[j]}")
            j += 1
    for k in range(i, la):
        diffs.append(f"{lo + k + 1} < {a[k]}")
    for k in range(j, lb):
        diffs.append(f"{lo + k + 1} > {b[k]}")
    return diffs


def compare_logs(ref_text: str, out_text: str, mode: str = "stats",
                 tol: float = TOLERANCE) -> Tuple[bool, List[str]]:
    """mode='stats': compare only statistics-block lines (physics parity);
    mode='full': the complete test-diff.sh surface."""
    if mode == "stats":
        ref, out = stats_lines(ref_text), stats_lines(out_text)
    else:
        ref, out = filter_lines(ref_text), filter_lines(out_text)
    diffs = fp_diff(ref, out, tol)
    return (len(diffs) == 0, diffs)
