"""Checkpoint / restart IO with JSON metadata.

PyTorch port of ludwig_tpu/io/checkpoint.py (ref: src/io_metadata.c
:159,244 JSON metadata per file, src/ludwig.c:310-369 restart reads,
:868-916 freq_config dumps; file naming dist-%8.8d etc.).

Arrays are written per field as raw little-endian binaries with a JSON
sidecar describing shape/dtype/step, byte for byte as the JAX package
writes the same array.  A tensor is brought to the host with .cpu()
(where the JAX package calls jax.device_get); the reader returns numpy
arrays, which the caller places on its device.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np


def restart_filename(stub: str, step: int) -> str:
    """dist-00001000 style names (ref: 'dist-%8.8d')."""
    return f"{stub}-{step:08d}"


def _host(arr) -> np.ndarray:
    if hasattr(arr, "detach"):          # a torch tensor, on any device
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def write_state(directory: str, step: int, fields: Dict[str, object],
                extra_meta: Dict = None) -> None:
    """Write each named array as <name>-<step> (+ .meta.json sidecar)."""
    os.makedirs(directory, exist_ok=True)
    for name, arr in fields.items():
        a = _host(arr)
        path = os.path.join(directory, restart_filename(name, step))
        # store the run's own dtype (little-endian for floats) so the
        # sidecar dtype is what is actually on disk - an f32 run
        # restarts as f32, an f64 run bit-exactly
        a.astype(a.dtype.newbyteorder("<")
                 if a.dtype.kind == "f" else a.dtype).tofile(path)
        meta = {
            "io_metadata_version": 1,
            "name": name,
            "step": step,
            "shape": list(a.shape),
            "dtype": str(a.dtype),
            "byteorder": "little",
        }
        if extra_meta:
            meta.update(extra_meta)
        with open(path + ".meta.json", "w") as fh:
            json.dump(meta, fh, indent=1)


def read_state(directory: str, step: int, names) -> Dict[str, np.ndarray]:
    """Read named arrays written by write_state."""
    out = {}
    for name in names:
        path = os.path.join(directory, restart_filename(name, step))
        with open(path + ".meta.json") as fh:
            meta = json.load(fh)
        dtype = np.dtype(meta["dtype"])
        raw = np.fromfile(
            path, dtype=dtype.newbyteorder("<")
            if dtype.kind == "f" else dtype)
        out[name] = raw.reshape(meta["shape"]).astype(dtype)
    return out
