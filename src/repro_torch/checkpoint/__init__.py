"""Checkpoint archives of the port, in the JAX package's ``.npz`` format
(``repro.checkpoint``): the archive itself (``save_pytree``,
``load_pytree``, ``load_metadata``) and the per-round checkpoints of the
trainers (``checkpoint_path``, ``latest_checkpoint``,
``prune_checkpoints``, ``saved_array_specs``)."""
from repro_torch.checkpoint.io import (CheckpointCorruptError,
                                       CheckpointFormatError,
                                       checkpoint_path, latest_checkpoint,
                                       load_metadata, load_pytree,
                                       prune_checkpoints, save_pytree,
                                       saved_array_specs)

__all__ = ["CheckpointCorruptError", "CheckpointFormatError",
           "checkpoint_path", "latest_checkpoint", "load_metadata",
           "load_pytree", "prune_checkpoints", "save_pytree",
           "saved_array_specs"]
