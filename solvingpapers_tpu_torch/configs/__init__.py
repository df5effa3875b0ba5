"""Run registry and factory (port of `solvingpapers_tpu/configs`: the
LLaMA-3 entries and the token-file training run)."""

from solvingpapers_tpu_torch.configs.registry import (
    RunConfig,
    dense_twin,
    get_config,
    list_configs,
)

__all__ = ["RunConfig", "dense_twin", "get_config", "list_configs"]
