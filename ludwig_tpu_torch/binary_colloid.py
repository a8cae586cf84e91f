"""The free energy's coupling to resolved colloids.

PyTorch port of colloid_fe_force of ludwig_tpu/binary_colloid.py (ref:
src/phi_force_colloid.c pth_force_driver 'COLLOID KERNEL'): the particles'
reaction force from the thermodynamic stress at their fluid links.  The
liquid crystal's colloids (lc_colloid.py) use it; the binary fluid's
colloids are not ported yet (ROADMAP).
"""

from __future__ import annotations

import numpy as np
import torch

from ludwig_tpu_torch.lattice import LatticeModel
from ludwig_tpu_torch.ops.force import _edge_plane
from ludwig_tpu_torch.ops.stencil import roll3


def colloid_fe_force(pth: torch.Tensor, pid: torch.Tensor,
                     inside: torch.Tensor, model: LatticeModel, n_part: int,
                     walls=(False, False, False)) -> torch.Tensor:
    """(N, 3) reaction force on each particle from the thermodynamic
    stress pth (3, 3, X, Y, Z): for every FLUID link with |c| == 1,
    force += c_id * pth(i)[:, id] evaluated at the outside (fluid) site.

    With plane walls, a link whose outside end wraps a walled axis has its
    outside site in the wall halo (MAP_BOUNDARY): no such link exists in
    the reference's map, so it is left out.  Each link direction's
    per-particle sums are one product of the particles' one-hot owner
    rows with the link values (a few particles at a time), summed over
    the directions in the JAX package's order: no scatter, so no atomic
    contention on the card, and nothing read back.  The sums run in
    float64 whatever the stress' dtype, as the reference's do."""
    fluid = ~inside
    shape = tuple(inside.shape)
    dev, f64 = pth.device, torch.float64
    nsite = inside.numel()
    zero = torch.zeros((), dtype=f64, device=dev)
    ids = torch.arange(n_part, device=dev)[:, None]
    chunk = max(1, (1 << 24) // nsite)      # one-hot rows of a product
    out = torch.zeros((n_part, 3), dtype=f64, device=dev)
    for q in range(1, model.nvel):
        c = model.cv[q]
        if int(np.sum(np.abs(c))) != 1:
            continue
        ax = int(np.argmax(np.abs(c)))
        sgn = float(c[ax])
        # link: outside site i with i + c inside particle n
        sh = tuple(-int(v) for v in c)
        m = fluid & roll3(inside, sh)
        if walls[ax]:
            m = m & ~_edge_plane(shape, ax, 1 if sgn > 0 else -1, str(dev))
        own = torch.where(m, roll3(pid, sh).to(torch.int64), -1).reshape(-1)
        vals = torch.where(m[None], pth[:, ax].to(f64), zero)
        vals = vals.reshape(3, nsite).T                      # (nsite, 3)
        sums = torch.cat([(own[None] == ids[s:s + chunk]).to(f64) @ vals
                          for s in range(0, n_part, chunk)])
        out = out + sgn * sums
    return out.to(pth.dtype)
