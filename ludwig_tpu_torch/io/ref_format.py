"""Reference-format binary field files.

The reference writes each field as raw little-endian doubles in x-major
(z-fastest) site order with ncomp values per site, one file per I/O
group, named <name>-%8.8d.%3.3d-%3.3d, plus two metadata sidecars (the
v0.14 JSON '<name>-metadata' and the classic '<name>.meta'; ref:
src/io_impl_mpio.c:179-199 record layout, src/io_info_args.c naming).
This module reads and writes that format so reference tools
(util/extract.c) and reference-generated files interoperate.

The port's copy of ludwig_tpu/io/ref_format.py; the writer also takes a
tensor on any device and brings it to the host.
"""

from __future__ import annotations

import json
import os

import numpy as np


def field_filename(name: str, step: int, ifile: int = 1, nfile: int = 1):
    return f"{name}-{step:08d}.{ifile:03d}-{nfile:03d}"


def write_ref_field(directory: str, name: str, step: int, arr,
                    periodic=(1, 1, 1), lmin=(0.5, 0.5, 0.5),
                    le=None) -> str:
    """Write a (X,Y,Z) or (ncomp,X,Y,Z) array as a reference binary
    field file + metadata sidecars.  Returns the data file path.

    le: optional (nplanes, uy) recorded in both metadata vintages so
    sheared-run output post-processes correctly (ref:
    lees_edwards_options.c:75-86 JSON keys; extract.c:682-690 reads the
    legacy .meta plane count/speed for le_unroll)."""
    if hasattr(arr, "detach"):          # a torch tensor, on any device
        arr = arr.detach().cpu().numpy()
    arr = np.asarray(arr, np.float64)
    if arr.ndim == 3:
        data = arr
        ncomp = 1
        size = arr.shape
    else:
        ncomp = arr.shape[0]
        size = arr.shape[1:]
        # site-major records: (X,Y,Z,ncomp)
        data = np.moveaxis(arr, 0, -1)
    path = os.path.join(directory, field_filename(name, step))
    data.astype("<f8").tofile(path)

    meta = {
        "coords": {
            "options": {
                "System size (total)": list(int(v) for v in size),
                "Periodic boundaries": list(int(v) for v in periodic),
                "Left-end limit Lmin": list(float(v) for v in lmin),
            },
            "lees_edwards": (
                {"Number of planes": 0} if le is None else
                {"Number of planes": int(le[0]),
                 "Plane speed": float(le[1])}),
        },
        "io_options": {
            "Mode": "single", "Record format": "binary",
            "Metadata version": 1, "Report": False,
            "Asynchronous": False, "Compression level": 0,
            "I/O grid": [1, 1, 1],
        },
        "io_element": {
            "MPI_Datatype": "MPI_DOUBLE", "Size (bytes)": 8,
            "Count": ncomp, "Endianness": "LITTLE_ENDIAN",
        },
        "io_subfile": {
            "Number of files": 1, "File index": 0,
            "Topology": [1, 1, 1], "Coordinate": [0, 0, 0],
            "Data ndims": 3,
            "File size (sites)": list(int(v) for v in size),
            "File offset (sites)": [0, 0, 0],
        },
    }
    with open(os.path.join(directory, f"{name}-metadata.001-001"),
              "w") as fh:
        json.dump(meta, fh, indent=1)
    with open(os.path.join(directory, f"{name}.001-001.meta"),
              "w") as fh:
        fh.write(f"Metadata for file set prefix:    {name}\n")
        fh.write(f"Data description:                {name}\n")
        fh.write(f"Data size per site (bytes):      {8 * ncomp}\n")
        fh.write("is_bigendian():                  0\n")
        fh.write("Number of processors:            1\n")
        fh.write("Cartesian communicator topology: 1 1 1\n")
        fh.write(f"Total system size:               "
                 f"{size[0]} {size[1]} {size[2]}\n")
        np_, uy_ = (0, 0.0) if le is None else (int(le[0]),
                                                float(le[1]))
        fh.write(f"Lees-Edwards planes:             {np_}\n")
        fh.write(f"Lees-Edwards plane speed         {uy_:.14f}\n")
        fh.write("Number of I/O groups (files):    1\n")
        fh.write("I/O communicator topology:       1 1 1\n")
        fh.write("Write order:\n")
        fh.write(f"  0   0   0   0 {size[0]} {size[1]} {size[2]} "
                 "0 0 0\n")
    return path


def read_ref_field(path: str, size, ncomp: int = 1):
    """Read a reference binary field file -> (X,Y,Z) or (ncomp,X,Y,Z)."""
    data = np.fromfile(path, "<f8")
    nx, ny, nz = size
    if ncomp == 1:
        return data.reshape(size)
    return np.moveaxis(data.reshape(nx, ny, nz, ncomp), -1, 0)
