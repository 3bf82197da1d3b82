"""Crash-atomic checkpoints of a train state in the JAX package's format."""
from .ckpt import (CheckpointManager, SimulatedCrash, latest_step,
                   restore_checkpoint, save_checkpoint, tear_checkpoint,
                   valid_steps)

__all__ = ["CheckpointManager", "SimulatedCrash", "latest_step",
           "restore_checkpoint", "save_checkpoint", "tear_checkpoint",
           "valid_steps"]
