"""Fault-tolerant training checkpoints (counterpart of
``paddle_tpu/checkpoint``): `CheckpointManager` writes the executor's
train state asynchronously with atomic commits and a manifest (step,
reader position, program fingerprint, vars) that makes
``Executor.train_loop(resume_from=...)`` exact.  The layout is the JAX
package's: a checkpoint written by either package restores in the
other."""
from .manager import (CheckpointManager, RestoredCheckpoint,  # noqa: F401
                      latest_checkpoint, describe, program_fingerprint,
                      MANIFEST)
