"""The port's I/O (io/map_file.py, io/ref_format.py, io/checkpoint.py and
run_text's checkpoints, restarts and field files) against ludwig_tpu's,
on the CPU.

The writers must write files byte-identical to the JAX package's for the
same array, and the readers must read the JAX package's files.  A run of
2n steps must print the same log, as text, as a run of n steps that
writes its state followed by N_start n for n more steps (f64 on the CPU;
the KISS state and the walls' momentum are part of what is written, and
the fused Lees-Edwards step continues its slide at n + 1).  The port
also restarts from the JAX package's checkpoints: its unfused route's as
they are, its fused route's padded state through
convert.checkpoint_from_jax."""

import io
import os
import re

import numpy as np
import pytest
import torch

from ludwig_tpu.io import checkpoint as jckpt
from ludwig_tpu.io import map_file as jmap
from ludwig_tpu.io import ref_format as jref
from ludwig_tpu.ludwig import run_text as jrun_text
from ludwig_tpu_torch.convert import checkpoint_from_jax
from ludwig_tpu_torch.io import checkpoint as tckpt
from ludwig_tpu_torch.io import map_file as tmap
from ludwig_tpu_torch.io import ref_format as tref
from ludwig_tpu_torch.ludwig import run_text
from test_ludwig_run import (BINARY_FUSED_INPUT, LE_FUSED_INPUT,
                             WALL_FUSED_INPUT, _stat_floats)

SIZE = (6, 5, 4)
NOISE_KEYS = """
temperature 0.00002
isothermal_fluctuations on
random_seed 8361235
"""


def _same_files(da, db, names):
    for name in names:
        with open(os.path.join(da, name), "rb") as fa, \
                open(os.path.join(db, name), "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("ndata", [0, 1, 2])
def test_write_map_is_the_jax_writer_and_reads_its_file(tmp_path, ndata,
                                                        binary):
    rng = np.random.default_rng(ndata)
    status = (rng.random(SIZE) > 0.7).astype(np.int8)
    data = rng.standard_normal((ndata,) + SIZE) if ndata else None
    jpath, tpath = str(tmp_path / "j.map"), str(tmp_path / "t.map")
    jmap.write_map(jpath, status, data, binary=binary)
    tmap.write_map(tpath, status, data, binary=binary)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    st, dat = tmap.read_map(jpath, SIZE, ndata, binary=binary)
    np.testing.assert_array_equal(st, status)
    if ndata:
        np.testing.assert_allclose(dat, data, rtol=1e-15 if binary else 1e-14)


@pytest.mark.parametrize("name", sorted(jmap.GEOMETRIES))
def test_geometries_match_jax(name):
    size = (12, 12, 8)
    np.testing.assert_array_equal(tmap.GEOMETRIES[name](size, 4),
                                  jmap.GEOMETRIES[name](size, 4))


@pytest.mark.parametrize("le", [None, (2, 0.05)])
@pytest.mark.parametrize("ncomp", [1, 3])
def test_write_ref_field_is_the_jax_writer(tmp_path, ncomp, le):
    """The data file and both metadata sidecars, byte for byte, for a
    tensor in the port and the same array in the JAX package; the
    reader reads the JAX file."""
    shape = SIZE if ncomp == 1 else (ncomp,) + SIZE
    arr = np.random.default_rng(ncomp).standard_normal(shape)
    dj, dt = tmp_path / "j", tmp_path / "t"
    dj.mkdir(), dt.mkdir()
    kw = dict(periodic=(0, 1, 1), le=le)
    jpath = jref.write_ref_field(str(dj), "vel", 7, arr, **kw)
    tpath = tref.write_ref_field(str(dt), "vel", 7, torch.as_tensor(arr),
                                 **kw)
    assert os.path.basename(jpath) == os.path.basename(tpath)
    _same_files(dj, dt, sorted(os.listdir(dj)))
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    np.testing.assert_array_equal(tref.read_ref_field(jpath, SIZE, ncomp),
                                  arr)


def test_write_state_is_the_jax_writer(tmp_path):
    """float64, float32 and a KISS state's uint32 words; the reader reads
    the JAX files and restores each dtype."""
    rng = np.random.default_rng(5)
    arrs = {"dist": rng.standard_normal((19,) + SIZE),
            "state01": rng.standard_normal(3).astype(np.float32),
            "state02": rng.integers(0, 2 ** 32, (4,) + SIZE,
                                    dtype=np.uint64).astype(np.uint32)}
    dj, dt = tmp_path / "j", tmp_path / "t"
    jckpt.write_state(str(dj), 40, arrs)
    tckpt.write_state(str(dt), 40, {k: (torch.as_tensor(v)
                                        if v.dtype != np.uint32 else v)
                                    for k, v in arrs.items()})
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    _same_files(dj, dt, sorted(os.listdir(dj)))
    back = tckpt.read_state(str(dj), 40, list(arrs))
    for k, v in arrs.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    assert tckpt.restart_filename("dist", 40) == "dist-00000040"


def _cycles(text, n, freq=1):
    text = re.sub(r"(N_cycles|freq_statistics) \d+\n", "", text)
    return text + f"N_cycles {n}\nfreq_statistics {freq}\n"


def _loop_log(log, after=None):
    """The log between the start of the loop (or the end of cycle
    `after`) and the timer table."""
    start = (log.index("Starting time step loop.\n") if after is None
             else log.index(f"Completed cycle {after}\n"))
    return log[log.index("\n", start) + 1:log.index("\nTimer statistics")]


RESTART_INPUTS = {
    "walls-kiss": WALL_FUSED_INPUT + NOISE_KEYS,
    "walls-fused": "tpu_fused on\n" + WALL_FUSED_INPUT,
    "le-fused": "tpu_fused on\n" + LE_FUSED_INPUT,
    "le": LE_FUSED_INPUT,
    "binary-fused": "tpu_fused on\n" + BINARY_FUSED_INPUT,
}


@pytest.mark.parametrize("name", list(RESTART_INPUTS))
def test_restart_prints_the_straight_log(tmp_path, name):
    """6 steps straight against 3 + config_at_end, then N_start 3 for 3
    more: the statistics of steps 4-6 identical as text."""
    text = RESTART_INPUTS[name] + f"io_directory {tmp_path}\n"
    straight, first, rest = io.StringIO(), io.StringIO(), io.StringIO()
    run_text(_cycles(text, 6), out=straight, device="cpu")
    run_text(_cycles(text, 3) + "config_at_end yes\n", out=first,
             device="cpu")
    assert "Writing distribution output at step 3!" in first.getvalue()
    run_text(_cycles(text, 3) + "N_start 3\n", out=rest, device="cpu")
    want = _loop_log(straight.getvalue(), after=3)
    assert "Completed cycle 6" in want
    assert _loop_log(rest.getvalue()) == want


def test_restart_from_the_jax_unfused_checkpoint(tmp_path):
    """The JAX package's unfused wall route with the KISS stream writes
    (dist, the walls' momentum, the uint32 KISS words) at step 3; the
    port reads them as they are and prints the JAX package's steps 4-6
    within rtol 1e-9 / atol 1e-11 (the [walls] row included)."""
    text = (_cycles(WALL_FUSED_INPUT + NOISE_KEYS, 3)
            + f"io_directory {tmp_path}\n")
    straight, rest = io.StringIO(), io.StringIO()
    jrun_text(text.replace("N_cycles 3", "N_cycles 6"), out=straight)
    jrun_text(text + "config_at_end yes\n", out=io.StringIO())
    run_text(text + "N_start 3\n", out=rest, device="cpu")
    want = _loop_log(straight.getvalue(), after=3)
    got = _loop_log(rest.getvalue())
    assert got.count("[walls   ]") == want.count("[walls   ]") == 3
    a, b = _stat_floats(want), _stat_floats(got)
    assert a.size == b.size > 0
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11)
    ja, jb = (np.array(re.findall(r"\[walls   \]\s+(\S+)\s+(\S+)\s+(\S+)",
                                  lg), float) for lg in (want, got))
    np.testing.assert_allclose(jb, ja, rtol=1e-9, atol=1e-11)


def test_restart_from_the_jax_fused_checkpoint(tmp_path):
    """The JAX package's fused Lees-Edwards route (its Pallas kernel in
    interpret mode, the file's one Pallas run) writes its padded state
    at steps 1-3; the port refuses it as a checkpoint of its own, and
    checkpoint_from_jax unpads it into the port's state, whose fused step
    from step 2 gives the JAX package's step 3 (rtol 1e-12)."""
    from ludwig_tpu_torch.ludwig import build_system
    from ludwig_tpu_torch.runtime import RunTime

    size = (16, 8, 8)
    text = (_cycles(LE_FUSED_INPUT, 3).replace("16_16_32", "16_8_8")
            + f"io_directory {tmp_path}\n")
    jrun_text("tpu_fused interpret\n" + text + "freq_config 1\n",
              out=io.StringIO())
    with pytest.raises(ValueError, match="checkpoint_from_jax"):
        run_text("tpu_fused on\n" + text + "N_start 2\n", out=io.StringIO(),
                 device="cpu")
    (f2,) = checkpoint_from_jax(str(tmp_path), 2, ["dist"], size, "cpu")
    (want,) = checkpoint_from_jax(str(tmp_path), 3, ["dist"], size, "cpu")
    sys_ = build_system(RunTime("tpu_fused on\n" + text), device="cpu")
    assert sys_.fused_mode == "le"
    (f3,) = sys_.step_fn((f2,), 3)
    torch.testing.assert_close(f3, want, rtol=1e-12, atol=1e-15)
