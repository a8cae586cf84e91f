"""Carry a ludwig_tpu state and configuration into the port.

Values cross as numpy arrays and plain Python values, so this module
needs neither JAX nor ludwig_tpu: a caller that has both packages (the
parity tests) converts on its side and passes the values in.
"""

from __future__ import annotations

import numpy as np
import torch

from ludwig_tpu_torch.lb import DTYPES, LBConfig
from ludwig_tpu_torch.ops.collide import RelaxationScheme


def state_from_jax(f: np.ndarray, device, dtype) -> torch.Tensor:
    """An unpadded (nvel, X, Y, Z) distribution array as a contiguous
    tensor on `device`; `dtype` a torch dtype or its name."""
    if isinstance(dtype, str):
        dtype = DTYPES[dtype]
    f = np.asarray(f)
    if f.ndim != 4:
        raise ValueError(f"want an unpadded (nvel, X, Y, Z) state, "
                         f"got shape {f.shape}")
    return torch.as_tensor(np.ascontiguousarray(f), dtype=dtype,
                           device=device)


def params_from_jax(lb_cfg_fields: dict, device="cpu") -> LBConfig:
    """LBConfig from the fields of a ludwig_tpu LBConfig (for example
    ``{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}``).
    The relaxation scheme may be the JAX package's enum or its value."""
    fields = dict(lb_cfg_fields)
    scheme = fields.get("scheme", RelaxationScheme.M10)
    fields["scheme"] = RelaxationScheme(getattr(scheme, "value", scheme))
    for key in ("size", "force_global", "walls", "wall_u"):
        if key in fields:
            fields[key] = tuple(fields[key])
    fields["device"] = str(device)
    return LBConfig(**fields)
