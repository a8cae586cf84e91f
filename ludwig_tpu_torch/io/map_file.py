"""Reference-format site maps (status + optional wetting data).

The port's copy of ludwig_tpu/io/map_file.py (numpy only), kept here so
the port imports nothing of the JAX package.

The reference stores the map as one record per site in global
(x-slowest, z-fastest) order: a status byte (binary) or "%2d" (ascii)
followed by ndata doubles (binary) or " %22.15e" each (ascii), where
ndata is 0 (status_only), 1 (status_with_h) or 2 (status_with_c_h)
(ref: src/map.c:480-585 map_write/read(_ascii), src/map_rt.c:100-176
map_init_porous_media_from_file; file stub "capillary.001-001").

Geometry initialisers mirror src/map_init.c (circle_xy, walls,
simple/body-centred/face-centred cubic crystals).

Status codes follow the reference enum (ref: src/map.h:23):
0 = fluid, 1 = boundary (solid), 2 = colloid.
"""

from typing import Optional, Tuple

import numpy as np

MAP_FLUID = 0
MAP_BOUNDARY = 1
MAP_COLLOID = 2


def write_map(path: str, status: np.ndarray,
              data: Optional[np.ndarray] = None,
              binary: bool = True) -> None:
    """Write a reference-format map file.

    status: (X, Y, Z) int array; data: (ndata, X, Y, Z) float64 or
    None.  Site order is x-slowest / z-fastest, matching the
    processor-independent serial read (ref: src/io_harness.c).
    """
    st = np.ascontiguousarray(status, np.int8)
    nd = 0 if data is None else int(data.shape[0])
    if nd:
        dat = np.ascontiguousarray(data, np.float64)
        # site-major interleave: status, d0..d{nd-1} per site
        flat = dat.reshape(nd, -1).T                     # (nsite, nd)
    if binary:
        with open(path, "wb") as fh:
            if nd == 0:
                fh.write(st.tobytes())
            else:
                sb = st.reshape(-1, 1).astype(np.int8)
                for s, row in zip(sb, flat):
                    fh.write(s.tobytes())
                    fh.write(row.tobytes())
    else:
        with open(path, "w") as fh:
            if nd == 0:
                for s in st.reshape(-1):
                    fh.write("%2d\n" % s)
            else:
                for s, row in zip(st.reshape(-1), flat):
                    fh.write("%2d" % s
                             + "".join(" %22.15e" % v for v in row)
                             + "\n")


def read_map(path: str, size: Tuple[int, int, int], ndata: int,
             binary: bool = True):
    """(status (X,Y,Z) int8, data (ndata,X,Y,Z) float64 or None)."""
    nsite = int(np.prod(size))
    if binary:
        rec = 1 + 8 * ndata
        raw = np.fromfile(path, np.uint8)
        if raw.size != nsite * rec:
            raise ValueError(
                f"map file {path}: {raw.size} bytes, expected "
                f"{nsite * rec} ({nsite} sites x {rec}B records)")
        raw = raw.reshape(nsite, rec)
        status = raw[:, 0].astype(np.int8).reshape(size)
        data = None
        if ndata:
            data = raw[:, 1:].copy().view(np.float64).reshape(
                nsite, ndata).T.reshape((ndata,) + tuple(size))
    else:
        vals = np.loadtxt(path, dtype=np.float64, ndmin=2)
        if vals.shape != (nsite, 1 + ndata):
            raise ValueError(
                f"map file {path}: shape {vals.shape}, expected "
                f"({nsite}, {1 + ndata})")
        status = vals[:, 0].astype(np.int8).reshape(size)
        data = (vals[:, 1:].T.reshape((ndata,) + tuple(size))
                if ndata else None)
    return status, data


# ---------------------------------------------------------------------------
# geometry initialisers (ref: src/map_init.c)

def _coords(size):
    """1-based global coordinate grids (reference convention)."""
    return np.meshgrid(*(np.arange(1, n + 1) for n in size),
                       indexing="ij")


def status_circle_xy(size) -> np.ndarray:
    """Solid outside a circle of radius (Lx-2)/2 centred in (x, y)
    (ref: map_init.c:34-84); uniform along z."""
    if size[0] != size[1]:
        raise ValueError("circle_xy needs Lx == Ly")
    x, y, _ = _coords(size)
    x0 = 0.5 * (1 + size[0])
    y0 = 0.5 * (1 + size[1])
    r0 = 0.5 * (size[0] - 2)
    fluid = (x - x0) ** 2 + (y - y0) ** 2 <= r0 * r0
    return np.where(fluid, MAP_FLUID, MAP_BOUNDARY).astype(np.int8)


def status_wall(size, axis: int) -> np.ndarray:
    """Boundary planes at 1 and L along the given axis
    (ref: map_init.c:93-132)."""
    g = _coords(size)[axis]
    solid = (g == 1) | (g == size[axis])
    return np.where(solid, MAP_BOUNDARY, MAP_FLUID).astype(np.int8)


def _crystal(size, acell: int, centres, radius: float) -> np.ndarray:
    """Union of spheres at (offsets + lattice points) of a cubic cell
    (0-based coordinates, ref: map_init.c:145-341)."""
    x, y, z = (g - 1 for g in _coords(size))       # 0-based as reference
    solid = np.zeros(size, bool)
    for (ox, oy, oz) in centres:
        # nearest lattice point of the shifted sublattice
        def dist(g, off):
            if off == 0.0:
                return g - np.round(g / acell) * acell
            return g - (np.floor(g / acell) + off) * acell
        dx, dy, dz = dist(x, ox), dist(y, oy), dist(z, oz)
        solid |= dx * dx + dy * dy + dz * dz <= radius * radius
    return np.where(solid, MAP_BOUNDARY, MAP_FLUID).astype(np.int8)


def status_simple_cubic(size, acell: int) -> np.ndarray:
    return _crystal(size, acell, [(0.0, 0.0, 0.0)], 0.5 * acell)


def status_body_centred_cubic(size, acell: int) -> np.ndarray:
    return _crystal(size, acell, [(0.0, 0.0, 0.0), (0.5, 0.5, 0.5)],
                    0.25 * np.sqrt(3.0) * acell)


def status_face_centred_cubic(size, acell: int) -> np.ndarray:
    return _crystal(size, acell,
                    [(0.0, 0.0, 0.0), (0.5, 0.5, 0.0),
                     (0.5, 0.0, 0.5), (0.0, 0.5, 0.5)],
                    0.25 * np.sqrt(2.0) * acell)


GEOMETRIES = {
    "circle_xy": lambda size, acell: status_circle_xy(size),
    "square_xy": lambda size, acell: np.maximum(
        status_wall(size, 0), status_wall(size, 1)),
    "wall_x": lambda size, acell: status_wall(size, 0),
    "wall_y": lambda size, acell: status_wall(size, 1),
    "wall_z": lambda size, acell: status_wall(size, 2),
    "simple_cubic": status_simple_cubic,
    "body_centred_cubic": status_body_centred_cubic,
    "face_centred_cubic": status_face_centred_cubic,
}
