"""Checkpoints (port of `solvingpapers_tpu/checkpoint`)."""

from solvingpapers_tpu_torch.checkpoint.manager import (
    CheckpointManager,
    export_params,
    load_params,
    restore_for_inference,
)

__all__ = ["CheckpointManager", "export_params", "load_params",
           "restore_for_inference"]
