"""Reference-exact fluctuation RNG: per-site KISS99 + Ladd discrete
table.

PyTorch port of ludwig_tpu/noise_kiss.py (ref: src/noise.c).  The
reference keeps a 4-word Marsaglia KISS99 state per lattice site, seeded
from the GLOBAL site coordinates so the stream is decomposition
independent, and draws discrete +-sqrt(2 +- sqrt 2)/0 deviates with unit
variance from 3-bit fields of one uniform draw (Ladd, Comp. Phys. Comm.
180 (2009) 2140).  This module reproduces that stream bit for bit,
vectorised over the lattice on the state's device:

* state: (4, X, Y, Z) int64 tensor, one KISS state per site, values
  below 2^32.  torch has no unsigned 32-bit arithmetic worth using
  (torch.uint32 lacks most operations, and >> on int32 is arithmetic),
  so the words ride in int64 and are masked to 32 bits after every
  shift left, product and sum, as ref_rng.kiss_advance does in numpy;
  no intermediate reaches 2^63;
* ``kiss_init`` seeds exactly as noise_init (ref: noise.c:136-211);
* ``reap`` = one uniform per site -> up to 10 table deviates (ref:
  noise.c noise_reap_n), advancing the state;
* ``extended=True`` adds the one-site halo ring of the reference's
  nextra = 1 seeding; halo states advance independently of their
  periodic-image interior sites, as in the reference.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

RTABLE = np.array([-math.sqrt(2.0 + math.sqrt(2.0)),
                   -math.sqrt(2.0 - math.sqrt(2.0)),
                   0.0, 0.0, 0.0, 0.0,
                   math.sqrt(2.0 - math.sqrt(2.0)),
                   math.sqrt(2.0 + math.sqrt(2.0))])

_STATE0 = (13, 12953, 712357, 22383979)
M32 = 0xFFFFFFFF


def _uniform(s: torch.Tensor):
    """One KISS99 step on a (4, ...) int64 state stack of 32-bit words;
    returns (state', uniform) (ref: noise.c noise_uniform)."""
    s0 = (s[0] * 69069 + 1234567) & M32
    b = s[1] ^ ((s[1] << 17) & M32)
    b = b ^ (b >> 13)
    s1 = b ^ ((b << 5) & M32)
    s2 = 36969 * (s[2] & 0xFFFF) + (s[2] >> 16)
    s3 = 18000 * (s[3] & 0xFFFF) + (s[3] >> 16)
    b = ((s2 << 16) + s3) & M32
    return torch.stack([s0, s1, s2, s3]), (s1 + (s0 ^ b)) & M32


def kiss_init(master_seed: int, size: Tuple[int, int, int],
              extended: bool = False, device="cuda") -> torch.Tensor:
    """The per-site state array (4, X, Y, Z) on `device`.

    size is the interior extent; with extended=True the array covers
    (X+2, Y+2, Z+2) - a one-site halo ring whose global coordinates
    wrap periodically (ref: noise.c:172-188).  Master seeds below 1
    fall back to 13, as in the reference."""
    seed0 = master_seed if master_seed > 0 else _STATE0[0]
    ex = 1 if extended else 0
    gs = []
    for n in size:
        g = torch.arange(1 - ex, n + ex + 1, dtype=torch.int64,
                         device=device)        # 1-based global coordinates
        g = torch.where(g < 1, g + n, g)
        gs.append(torch.where(g > n, g - n, g))
    ig, jg, kg = torch.meshgrid(*gs, indexing="ij")
    state = torch.stack([(seed0 + ig) & M32, _STATE0[1] + jg,
                         _STATE0[2] + kg,
                         torch.full_like(ig, _STATE0[3])])
    # warm-up: four uniforms become the working state (ref: noise.c:202)
    outs = []
    for _ in range(4):
        state, u = _uniform(state)
        outs.append(u)
    return torch.stack(outs)


@lru_cache(maxsize=8)
def _table(dtype, device: str) -> torch.Tensor:
    """The deviate table on `device`, made once: a draw copies nothing
    from the host."""
    return torch.as_tensor(RTABLE, dtype=dtype, device=device)


def reap(state: torch.Tensor, n: int, dtype=torch.float64):
    """(state', deviates (n, ...)): one uniform per site, 3 bits per
    deviate from bit 2 upward (ref: noise.c noise_reap_n)."""
    state, u = _uniform(state)
    u = u >> 2
    table = _table(dtype, str(state.device))
    vals = [table[(u >> (3 * i)) & 7] for i in range(n)]
    return state, torch.stack(vals)


def interior(x: torch.Tensor) -> torch.Tensor:
    """Interior view of an extended (1-halo) per-site array (works for
    (..., X+2, Y+2, Z+2) stacks)."""
    return x[..., 1:-1, 1:-1, 1:-1]
