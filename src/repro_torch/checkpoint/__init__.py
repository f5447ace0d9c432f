"""Checkpoint archives of the port, in the JAX package's ``.npz`` format
(``repro.checkpoint``): so far only what ``launch/train.py --out`` needs
(``save_pytree``, ``load_pytree``, ``load_metadata``)."""
from repro_torch.checkpoint.io import (CheckpointCorruptError,
                                       CheckpointFormatError, load_metadata,
                                       load_pytree, save_pytree)

__all__ = ["CheckpointCorruptError", "CheckpointFormatError",
           "load_metadata", "load_pytree", "save_pytree"]
