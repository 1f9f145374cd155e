"""Sharded, atomic, async checkpoints in the reference's format 2."""
from repro_torch.checkpoint.manager import (
    CheckpointManager,
    CheckpointWrite,
    CorruptCheckpoint,
)

__all__ = ["CheckpointManager", "CheckpointWrite", "CorruptCheckpoint"]
