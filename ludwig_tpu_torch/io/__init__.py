"""Checkpoints, reference-format field files, I/O-grid subfile sets and
site maps (the JAX package's device-shard reads and writes are not
ported)."""

from ludwig_tpu_torch.io.checkpoint import (read_state, restart_filename,
                                            write_state)  # noqa: F401
from ludwig_tpu_torch.io.sharded import (read_subfile_set, subfile_name,
                                         write_sharded)  # noqa: F401
