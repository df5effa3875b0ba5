"""Model registry (port of `solvingpapers_tpu/configs`, model entries only)."""

from solvingpapers_tpu_torch.configs.registry import (
    ModelEntry,
    dense_twin,
    get_config,
    list_configs,
)

__all__ = ["ModelEntry", "dense_twin", "get_config", "list_configs"]
