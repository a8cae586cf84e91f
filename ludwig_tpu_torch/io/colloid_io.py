"""Reference-format colloid state files (config.cds...).

Reads/writes the reference's colloid I/O records so reference-generated
initial conditions (util/multi_poly_init etc.) and restarts interoperate
(ref: src/colloid.c colloid_state_read_ascii:29 / write_ascii:121,
colloid_state_read_binary:233 / write_binary:260 — a 512-byte struct of
32 ints + 48 doubles; src/colloid_io.c header = particle count).

A colloid state is represented here as a plain dict with the reference's
field names.  Copied from ludwig_tpu/io/colloid_io.py (the port imports
nothing of the JAX package): the files it writes are byte-identical.
"""

from __future__ import annotations

import struct
from typing import List

NBOND_MAX = 2
NPAD_INT = 13
NPAD_DBL = 15

# (name, count) in file order — integers first, then doubles
INT_FIELDS = [
    ("index", 1), ("rebuild", 1), ("nbonds", 1), ("nangles", 1),
    ("isfixedr", 1), ("isfixedv", 1), ("isfixedw", 1), ("isfixeds", 1),
    ("type", 1), ("bond", NBOND_MAX), ("rng", 1), ("isfixedrxyz", 3),
    ("isfixedvxyz", 3), ("inter_type", 1), ("intpad", NPAD_INT),
]
DBL_FIELDS = [
    ("a0", 1), ("ah", 1), ("r", 3), ("v", 3), ("w", 3), ("s", 3),
    ("m", 3), ("b1", 1), ("b2", 1), ("c", 1), ("h", 1), ("dr", 3),
    ("deltaphi", 1), ("q0", 1), ("q1", 1), ("epsilon", 1),
    ("deltaq0", 1), ("deltaq1", 1), ("sa", 1), ("saf", 1), ("al", 1),
    ("dpad", NPAD_DBL),
]


def default_state() -> dict:
    s = {}
    for name, cnt in INT_FIELDS:
        s[name] = [0] * cnt if cnt > 1 else 0
    for name, cnt in DBL_FIELDS:
        s[name] = [0.0] * cnt if cnt > 1 else 0.0
    s["rebuild"] = 1
    return s


def _iter_scalars(state, fields):
    for name, cnt in fields:
        v = state[name]
        if cnt == 1:
            yield v
        else:
            for i in range(cnt):
                yield v[i]


def read_colloid_file(path: str) -> List[dict]:
    """Read an ascii colloid file: count header + per-particle records."""
    with open(path) as fh:
        toks = fh.read().split()
    n = int(toks[0])
    pos = 1
    nint = sum(c for _, c in INT_FIELDS)
    ndbl = sum(c for _, c in DBL_FIELDS)
    out = []
    for _ in range(n):
        s = default_state()
        vals = toks[pos:pos + nint + ndbl]
        pos += nint + ndbl
        it = iter(vals)
        for name, cnt in INT_FIELDS:
            if cnt == 1:
                s[name] = int(next(it))
            else:
                s[name] = [int(next(it)) for _ in range(cnt)]
        for name, cnt in DBL_FIELDS:
            if cnt == 1:
                s[name] = float(next(it))
            else:
                s[name] = [float(next(it)) for _ in range(cnt)]
        s["rebuild"] = 1   # ref: colloid.c:106 always set on read
        out.append(s)
    return out


def write_colloid_file(path: str, states: List[dict]) -> None:
    """Write the ascii format (ref formats %24d / %24.15e)."""
    with open(path, "w") as fh:
        fh.write(f"{len(states):22d}\n")
        for s in states:
            for v in _iter_scalars(s, INT_FIELDS):
                fh.write(f"{int(v):24d}\n")
            for name, cnt in DBL_FIELDS:
                v = s[name]
                if cnt == 1:
                    fh.write(f"{float(v):24.15e}\n")
                elif cnt == 3:
                    fh.write(f"{float(v[0]):24.15e} {float(v[1]):24.15e} "
                             f"{float(v[2]):24.15e}\n")
                else:
                    for i in range(cnt):
                        fh.write(f"{float(v[i]):24.15e}\n")


def read_colloid_file_binary(path: str) -> List[dict]:
    """Binary records: 32 int32 + 48 float64 per particle (512 bytes)."""
    with open(path, "rb") as fh:
        data = fh.read()
    (n,) = struct.unpack_from("i", data, 0)
    pos = 4
    out = []
    for _ in range(n):
        s = default_state()
        ints = struct.unpack_from("32i", data, pos)
        pos += 128
        dbls = struct.unpack_from("48d", data, pos)
        pos += 384
        it = iter(ints)
        for name, cnt in INT_FIELDS:
            s[name] = (next(it) if cnt == 1
                       else [next(it) for _ in range(cnt)])
        it = iter(dbls)
        for name, cnt in DBL_FIELDS:
            s[name] = (next(it) if cnt == 1
                       else [next(it) for _ in range(cnt)])
        s["rebuild"] = 1
        out.append(s)
    return out


def write_colloid_file_binary(path: str, states: List[dict]) -> None:
    """Binary records: int32 count header, then 32 int32 + 48 float64
    per particle (ref: colloid.c colloid_state_write_binary)."""
    with open(path, "wb") as fh:
        fh.write(struct.pack("i", len(states)))
        for s in states:
            ints = [int(v) for v in _iter_scalars(s, INT_FIELDS)]
            dbls = [float(v) for v in _iter_scalars(s, DBL_FIELDS)]
            fh.write(struct.pack("32i", *ints))
            fh.write(struct.pack("48d", *dbls))
