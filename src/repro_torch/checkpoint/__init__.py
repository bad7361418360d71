"""Checkpoints in the JAX package's on-disk layout (npz + manifest)."""
from .checkpoint import (AsyncCheckpointer, list_checkpoints,
                         prune_checkpoints, restore_checkpoint,
                         restore_latest, save_checkpoint)

__all__ = ["AsyncCheckpointer", "list_checkpoints", "restore_checkpoint",
           "restore_latest", "save_checkpoint", "prune_checkpoints"]
