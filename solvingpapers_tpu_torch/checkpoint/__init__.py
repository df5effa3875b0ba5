"""Checkpoints (port of `solvingpapers_tpu/checkpoint`)."""

from solvingpapers_tpu_torch.checkpoint.manager import (
    CheckpointManager,
    export_params,
    load_params,
)

__all__ = ["CheckpointManager", "export_params", "load_params"]
