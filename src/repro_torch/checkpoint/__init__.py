"""Atomic, CRC-verified, keep-N checkpoints (counterpart of
``repro.checkpoint``; the on-disk format is the reference's, so either
package restores what the other saved)."""
from repro_torch.checkpoint.checkpointer import (CheckpointManager,
                                                 checkpoint_meta, latest_step,
                                                 load_checkpoint,
                                                 load_checkpoint_flat,
                                                 save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "load_checkpoint_flat", "latest_step", "checkpoint_meta"]
