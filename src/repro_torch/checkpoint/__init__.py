"""Async, atomic checkpointing of the port's training state."""

from .store import (CheckpointManager, latest_step, load_checkpoint,
                    named_leaves, save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint",
           "named_leaves", "save_checkpoint"]
