"""Models (port of `solvingpapers_tpu/models`: the GPT, LLaMA-3 and
DeepSeek-V3 families)."""

from solvingpapers_tpu_torch.models import deepseekv3, gpt, llama3
from solvingpapers_tpu_torch.models.deepseekv3 import DeepSeekV3, DeepSeekV3Config
from solvingpapers_tpu_torch.models.gpt import GPT, GPTBlock, GPTConfig
from solvingpapers_tpu_torch.models.llama3 import (
    Llama,
    LlamaBlock,
    LlamaConfig,
    init_params,
)


def init_params_for(cfg):
    """The `init_params(cfg, generator)` of the family whose config `cfg`
    is (a state dict from the reference's initializers; DeepSeek-V3's
    holds its zero routing biases too)."""
    if isinstance(cfg, DeepSeekV3Config):
        return deepseekv3.init_params
    if isinstance(cfg, LlamaConfig):
        return llama3.init_params
    if isinstance(cfg, GPTConfig):
        return gpt.init_params
    raise NotImplementedError(f"no init_params ported for {type(cfg).__name__}")


__all__ = ["DeepSeekV3", "DeepSeekV3Config", "GPT", "GPTBlock", "GPTConfig",
           "Llama", "LlamaBlock", "LlamaConfig", "init_params",
           "init_params_for"]
