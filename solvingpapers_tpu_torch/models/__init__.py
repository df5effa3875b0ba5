"""Models (port of `solvingpapers_tpu/models`: the LLaMA-3 family)."""

from solvingpapers_tpu_torch.models.llama3 import (
    Llama,
    LlamaBlock,
    LlamaConfig,
    init_params,
)

__all__ = ["Llama", "LlamaBlock", "LlamaConfig", "init_params"]
