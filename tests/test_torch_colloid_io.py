"""The port's config.cds reader and writers (ludwig_tpu_torch/io/
colloid_io.py) against ludwig_tpu's, on the CPU: ASCII and binary files
from records made from a numpy seed are byte-identical, and the
repository's subgrid configuration config.cds.init.001-001 (30
particles) reads into identical records."""

from pathlib import Path

import numpy as np
import pytest

from ludwig_tpu.io import colloid_io as jio
from ludwig_tpu_torch.io import colloid_io as tio

INIT = Path(__file__).resolve().parent.parent / "config.cds.init.001-001"


def records(n=5, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        s = tio.default_state()
        s["index"] = i + 1
        s["type"] = int(rng.randint(0, 3))
        s["nbonds"] = 1
        s["bond"] = [int(rng.randint(1, n + 1)), 0]
        s["isfixedrxyz"] = [int(v) for v in rng.randint(0, 2, 3)]
        for name in ("a0", "ah", "b1", "b2", "al", "q0"):
            s[name] = float(rng.uniform(0.1, 3.0))
        for name in ("r", "v", "w", "s", "m", "dr"):
            s[name] = [float(v) for v in rng.standard_normal(3)]
        out.append(s)
    return out


@pytest.mark.parametrize("binary", [False, True])
def test_writers_byte_identical(tmp_path, binary):
    recs = records()
    a, b = tmp_path / "jax.cds", tmp_path / "port.cds"
    if binary:
        jio.write_colloid_file_binary(str(a), recs)
        tio.write_colloid_file_binary(str(b), recs)
        back = tio.read_colloid_file_binary(str(b))
        want = recs
    else:
        jio.write_colloid_file(str(a), recs)
        tio.write_colloid_file(str(b), recs)
        back = tio.read_colloid_file(str(b))
        want = jio.read_colloid_file(str(a))     # %24.15e rounds
    assert a.read_bytes() == b.read_bytes()
    assert back == want


def test_subgrid_init_file_reads_identically():
    mine, theirs = (tio.read_colloid_file(str(INIT)),
                    jio.read_colloid_file(str(INIT)))
    assert len(mine) == 30 and mine == theirs
    assert {r["type"] for r in mine} == {2}
    assert mine[0]["a0"] == 0.178
