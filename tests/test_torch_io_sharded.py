"""The port's I/O-grid subfile sets against ludwig_tpu's, on the CPU.

The same numpy arrays, made from a seed, go through the JAX package's
io/sharded.write_sharded (its host path, an explicit grid) and the
port's; the subfiles and their JSON metadata must be byte-identical, and
either package reads back the other's set.  One input runs through both
CLIs with `default_io_grid` and a `<name>_io_grid` override: the same
files, byte for byte."""

import io
import json
import os

import numpy as np
import pytest
import torch

from ludwig_tpu.io import sharded as jsharded
from ludwig_tpu.ludwig import run_text as jrun_text
from ludwig_tpu_torch.io import read_subfile_set, subfile_name, write_sharded
from ludwig_tpu_torch.ludwig import run_text
from test_ludwig_run import DROPLET_FUSED_INPUT

SHAPES = {"scalar": (8, 8, 16), "vector": (3, 8, 8, 16)}
GRIDS = [(2, 2, 1), (1, 1, 4), (2, 2, 2)]


def _field(shape, seed=11):
    return np.random.default_rng(seed).standard_normal(shape)


def _same_tree(a, b, near=()):
    """The same file names under a and b, the same bytes in each, but the
    data files whose names start with `near`: their doubles within 1e-15
    of their largest value."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        x, y = (a / name).read_bytes(), (b / name).read_bytes()
        if name.startswith(near) and "meta" not in name:
            x, y = np.frombuffer(x, "<f8"), np.frombuffer(y, "<f8")
            np.testing.assert_allclose(y, x, rtol=0,
                                       atol=1e-15 * np.abs(x).max())
        else:
            assert x == y, name
    return names


@pytest.mark.parametrize("le", [None, (2, 0.04)], ids=["periodic", "le"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "_".join(map(str, g)))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_subfile_sets_match_jax(shape, grid, le, tmp_path):
    """The port's writer, given a tensor, against the JAX package's, given
    the same values as numpy: the subfiles and the metadata byte for byte
    (the periodicity and the Lees-Edwards entries included); the port's
    reader recombines the set exactly."""
    arr = _field(SHAPES[shape])
    periodic = (1, 0, 1)
    nj = jsharded.write_sharded(str(tmp_path / "jax"), "q", 20, arr,
                                grid=grid, periodic=periodic, le=le)
    nt = write_sharded(str(tmp_path / "port"), "q", 20, torch.as_tensor(arr),
                       grid=grid, periodic=periodic, le=le)
    assert nt == nj == int(np.prod(grid))
    names = _same_tree(tmp_path / "jax", tmp_path / "port")
    assert len(names) == 2 * nt
    assert subfile_name("q", 20, nt - 1, nt) in names
    np.testing.assert_array_equal(
        read_subfile_set(str(tmp_path / "port"), "q", 20), arr)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_sets_read_across_packages(shape, tmp_path):
    """A set the JAX package writes reads back through the port's reader,
    and the port's set through the JAX package's, exactly."""
    arr = _field(SHAPES[shape], seed=12)
    jsharded.write_sharded(str(tmp_path / "jax"), "phi", 3, arr,
                           grid=(2, 1, 4))
    write_sharded(str(tmp_path / "port"), "phi", 3, arr, grid=(1, 4, 2))
    np.testing.assert_array_equal(
        read_subfile_set(str(tmp_path / "jax"), "phi", 3), arr)
    np.testing.assert_array_equal(
        jsharded.read_subfile_set(str(tmp_path / "port"), "phi", 3), arr)


def test_grid_that_does_not_divide_raises(tmp_path):
    arr = torch.zeros((8, 8, 16), dtype=torch.float64)
    for grid in ((3, 1, 1), (1, 1, 5)):
        with pytest.raises(ValueError, match="does not divide"):
            jsharded.write_sharded(str(tmp_path), "phi", 0, arr.numpy(),
                                   grid=grid)
        with pytest.raises(ValueError, match="does not divide"):
            write_sharded(str(tmp_path), "phi", 0, arr, grid=grid)


# the droplet between walls on z: phi and vel files, two I/O grids
IO_GRID_INPUT = (DROPLET_FUSED_INPUT.replace("N_cycles 4", "N_cycles 2")
                 + "boundary_walls 0_0_1\nfreq_phi 2\nfreq_vel 2\n"
                 "default_io_grid 2_1_1\nphi_io_grid 1_2_1\n")


def test_cli_io_grid_files_match_jax(tmp_path):
    """`default_io_grid 2_1_1` with a `phi_io_grid 1_2_1` override: vel
    in two x blocks, phi in two y blocks, the same files as the JAX CLI
    writes, the metadata and the phi subfiles byte-identical
    (the velocity's doubles differ in the last bit at a few sites: the
    order of a sum in the force's mean); a grid that does not divide the
    lattice raises ValueError at the first dump, as the JAX package's."""
    dj, dt = tmp_path / "jax", tmp_path / "port"
    dj.mkdir(), dt.mkdir()
    jrun_text(IO_GRID_INPUT + f"io_directory {dj}\n", out=io.StringIO())
    run_text(IO_GRID_INPUT + f"io_directory {dt}\n", out=io.StringIO(),
             device="cpu")
    names = _same_tree(dj, dt, near=("vel-",))
    assert len(names) == 8
    for stem, grid in (("phi", [1, 2, 1]), ("vel", [2, 1, 1])):
        assert f"{stem}-00000002.002-002" in names
        meta = json.loads((dt / f"{stem}-metadata.002-002").read_text())
        assert meta["io_options"]["I/O grid"] == grid
    bad = IO_GRID_INPUT.replace("phi_io_grid 1_2_1", "phi_io_grid 1_3_1")
    with pytest.raises(ValueError, match="does not divide"):
        run_text(bad + f"io_directory {dt}\n", out=io.StringIO(),
                 device="cpu")
