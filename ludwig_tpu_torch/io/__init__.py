"""Checkpoints, reference-format field files and site maps (the single
I/O group; the sharded writer of the JAX package is not ported)."""

from ludwig_tpu_torch.io.checkpoint import (read_state, restart_filename,
                                            write_state)  # noqa: F401
