"""I/O-grid subfile sets: one field file per block of the I/O grid.

PyTorch port of the serial path of ludwig_tpu/io/sharded.py: the
reference's ``iogrid`` block decomposition of the lattice into subfiles
(ref: src/io_subfile.c:49-95) with per-file JSON metadata (ref:
src/io_metadata.c:159,244), as the CLI writes a field whose
``<name>_io_grid`` (or ``default_io_grid``) is other than ``1_1_1``.  The
record layout (site-major, z fastest, ncomp values a site, little-endian
doubles), the subfile names and the metadata are those of
``io/ref_format.py``, so reference tools recombine these sets too.

``write_sharded`` takes a tensor on any device or a numpy array and an
explicit ``grid``; the field is copied to the host once a dump and
sliced there.  The JAX package's device-shard path (its
``_grid_from_sharding``, the ``addressable_shards`` loop and
``read_sharded``, which writes and reads each device's shard of a sharded
array) is multi-device and waits for the port's multi-device slice on
torch.distributed.
"""

from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

import numpy as np


def subfile_name(name: str, step: int, index: int, nfile: int) -> str:
    """<name>-%8.8d.%3.3d-%3.3d (ref: io_subfile naming, 1-based index)."""
    return f"{name}-{step:08d}.{index + 1:03d}-{nfile:03d}"


def _meta_name(name: str, index: int, nfile: int) -> str:
    return f"{name}-metadata.{index + 1:03d}-{nfile:03d}"


def _block_starts(shape3, grid3) -> Tuple[Tuple[int, ...], ...]:
    """Per-axis block start offsets of a uniform I/O-grid split; the grid
    must divide the lattice extent."""
    starts = []
    for ext, g in zip(shape3, grid3):
        if ext % g:
            raise ValueError(f"io grid {grid3} does not divide {shape3}")
        b = ext // g
        starts.append(tuple(i * b for i in range(g)))
    return tuple(starts)


def _file_index(coords3, grid3) -> int:
    """Reference file ordering: x fastest (ref: io_subfile.c:86-89)."""
    return (coords3[0] + coords3[1] * grid3[0]
            + coords3[2] * grid3[0] * grid3[1])


def _blocks(shape3, grid3):
    """(index, coords, slices) of every block of the I/O grid, in the
    reference's loop order; the grid must divide the lattice."""
    starts = _block_starts(shape3, grid3)
    bshape = tuple(e // g for e, g in zip(shape3, grid3))
    for cz in range(grid3[2]):
        for cy in range(grid3[1]):
            for cx in range(grid3[0]):
                coords = (cx, cy, cz)
                yield (_file_index(coords, grid3), coords,
                       tuple(slice(starts[a][coords[a]],
                                   starts[a][coords[a]] + bshape[a])
                             for a in range(3)))


def _site_major(block: np.ndarray) -> np.ndarray:
    """(ncomp, bx, by, bz) or (bx, by, bz) -> site-major records
    (bx, by, bz[, ncomp]) as the reference writes them."""
    if block.ndim == 4:
        return np.moveaxis(block, 0, -1)
    return block


def _from_site_major(raw: np.ndarray, bshape3, ncomp: int) -> np.ndarray:
    if ncomp == 1:
        return raw.reshape(bshape3)
    return np.moveaxis(raw.reshape(tuple(bshape3) + (ncomp,)), -1, 0)


def _meta(shape3, grid, ncomp, index, coords, sl, periodic, lmin,
          le) -> dict:
    """The JSON metadata of one subfile (ref: io_metadata.c)."""
    return {
        "coords": {
            "options": {
                "System size (total)": list(shape3),
                "Periodic boundaries": [int(v) for v in periodic],
                "Left-end limit Lmin": [float(v) for v in lmin],
            },
            "lees_edwards": (
                {"Number of planes": 0} if le is None else
                {"Number of planes": int(le[0]),
                 "Plane speed": float(le[1])}),
        },
        "io_options": {
            "Mode": "mpiio", "Record format": "binary",
            "Metadata version": 2, "Report": False,
            "Asynchronous": False, "Compression level": 0,
            "I/O grid": list(grid),
        },
        "io_element": {
            "MPI_Datatype": "MPI_DOUBLE", "Size (bytes)": 8,
            "Count": ncomp, "Endianness": "LITTLE_ENDIAN",
        },
        "io_subfile": {
            "Number of files": grid[0] * grid[1] * grid[2],
            "File index": index,
            "Topology": list(grid), "Coordinate": list(coords),
            "Data ndims": 3,
            "File size (sites)": [v.stop - v.start for v in sl],
            "File offset (sites)": [v.start for v in sl],
        },
    }


def write_sharded(directory: str, name: str, step: int, arr,
                  grid: Sequence[int], periodic=(1, 1, 1),
                  lmin=(0.5, 0.5, 0.5), le=None) -> int:
    """Write `arr` ((X, Y, Z) or (ncomp, X, Y, Z); a tensor on any device
    or a numpy array) as the I/O-grid set of subfiles of `grid`, each
    with its JSON metadata; returns the number of files.  le: optional
    (nplanes, uy) recorded in the metadata.  A grid that does not divide
    the lattice raises ValueError."""
    if hasattr(arr, "detach"):          # a torch tensor, on any device
        arr = arr.detach().cpu().numpy()
    host = np.asarray(arr)
    os.makedirs(directory, exist_ok=True)
    shape3 = tuple(int(v) for v in host.shape[-3:])
    ncomp = 1 if host.ndim == 3 else int(host.shape[0])
    grid = tuple(int(g) for g in grid)
    nfile = grid[0] * grid[1] * grid[2]
    for index, coords, sl in _blocks(shape3, grid):
        block = np.asarray(host[(...,) + sl], np.float64)
        _site_major(block).astype("<f8").tofile(os.path.join(
            directory, subfile_name(name, step, index, nfile)))
        with open(os.path.join(directory, _meta_name(name, index, nfile)),
                  "w") as fh:
            json.dump(_meta(shape3, grid, ncomp, index, coords, sl,
                            periodic, lmin, le), fh, indent=1)
    return nfile


def _set_layout(directory: str, name: str):
    """(grid, shape3, ncomp, nfile) of a subfile set from its metadata."""
    files = sorted(f for f in os.listdir(directory)
                   if f.startswith(f"{name}-metadata."))
    if not files:
        raise FileNotFoundError(f"no metadata for {name} in {directory}")
    with open(os.path.join(directory, files[0])) as fh:
        meta = json.load(fh)
    grid = tuple(meta["io_subfile"]["Topology"])
    shape3 = tuple(meta["coords"]["options"]["System size (total)"])
    ncomp = int(meta["io_element"]["Count"])
    return grid, shape3, ncomp, int(meta["io_subfile"]["Number of files"])


def read_subfile_set(directory: str, name: str, step: int) -> np.ndarray:
    """Recombine a whole subfile set into one host array ((ncomp, X, Y, Z)
    or (X, Y, Z)), the extract utility's path."""
    grid, shape3, ncomp, nfile = _set_layout(directory, name)
    out = np.empty(((ncomp,) if ncomp > 1 else ()) + shape3, np.float64)
    for index, _coords, sl in _blocks(shape3, grid):
        raw = np.fromfile(os.path.join(
            directory, subfile_name(name, step, index, nfile)), "<f8")
        out[(...,) + sl] = _from_site_major(
            raw, [v.stop - v.start for v in sl], ncomp)
    return out
