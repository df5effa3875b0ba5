"""Model registry (port of the LLaMA-3 entries of
`solvingpapers_tpu/configs/registry.py`).

Only the model half of each entry is carried across: the serving slice
needs the architecture, not the training, data or mesh settings. The
widths are the reference's own.

Vocabulary: the reference's factory resizes `vocab_size` to the corpus
tokenizer (char or BPE, `configs/factory.py`) before building a model.
The tokenizer is not ported yet, so here prompts are token ids and the
vocabulary stays at the registry's 50257 (tiktoken gpt2).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from solvingpapers_tpu_torch.models.llama3 import LlamaConfig


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    model_family: str
    model: Any
    notes: str = ""


_REGISTRY: dict[str, Callable[[], ModelEntry]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelEntry]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelEntry:
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> list[str]:
    return sorted(_REGISTRY)


def dense_twin(entry: ModelEntry) -> ModelEntry:
    """The single-device model `cli serve` serves for a context-parallel
    config: the same weights with `context_parallel` off (params are
    replicated at rest, so nothing else changes)."""
    if not getattr(entry.model, "context_parallel", False):
        return entry
    return dataclasses.replace(
        entry,
        model=dataclasses.replace(entry.model, context_parallel=False),
    )


@register("llama3_shakespeare")
def _llama3_shakespeare() -> ModelEntry:
    """The reference notebook's LLaMA-3 hyperparameters (llama3/LLaMA-jax
    cell 9)."""
    return ModelEntry(
        name="llama3_shakespeare",
        model_family="llama3",
        model=LlamaConfig(
            vocab_size=50257, max_seq_len=128, dim=256, n_layers=2, n_heads=4,
            n_kv_heads=2, hidden_dim=1024, dtype="bfloat16",
        ),
        notes="LLaMA-jax.ipynb cells 9, 29-31",
    )


@register("llama3_long")
def _llama3_long() -> ModelEntry:
    """Long-context LLaMA-3: dim 1024, 16 layers, 16 q / 8 kv heads
    (head_dim 64), SwiGLU hidden 2730, RoPE to 32768 positions, bf16,
    flash attention. Trained context-parallel in the reference; served
    as its dense twin."""
    return ModelEntry(
        name="llama3_long",
        model_family="llama3",
        model=LlamaConfig(
            vocab_size=50257, max_seq_len=32_768, dim=1024, n_layers=16,
            n_heads=16, n_kv_heads=8, dtype="bfloat16",
            context_parallel=True, use_flash=True,
        ),
        notes="beyond-reference long-context config",
    )


@register("llama3_long_smoke")
def _llama3_long_smoke() -> ModelEntry:
    """llama3_long at toy dims (the reference's CPU-mesh smoke)."""
    return ModelEntry(
        name="llama3_long_smoke",
        model_family="llama3",
        model=LlamaConfig(
            vocab_size=256, max_seq_len=256, dim=64, n_layers=2,
            n_heads=4, n_kv_heads=2, dtype="float32",
            context_parallel=True, use_flash=True,
        ),
        notes="llama3_long at smoke scale",
    )
