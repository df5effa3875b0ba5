"""Workload registry (port of the GPT, LLaMA-3 and DeepSeek-V3 entries of
`solvingpapers_tpu/configs/registry.py` that the port runs): name ->
RunConfig (model + train + data settings), with the reference's own
values.

Vocabulary: the factory resizes `vocab_size` to the corpus's tokenizer
(the char tokenizer of the char and Markov corpora, or the byte BPE of a
`kind: "bpe"` config, `data/bpe.py`), as the reference's does; token
files carry ids and keep the registry's vocabulary.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from solvingpapers_tpu_torch.models.deepseekv3 import DeepSeekV3Config
from solvingpapers_tpu_torch.models.gpt import GPTConfig
from solvingpapers_tpu_torch.models.llama3 import LlamaConfig
from solvingpapers_tpu_torch.train.engine import TrainConfig
from solvingpapers_tpu_torch.train.optim import OptimizerConfig


@dataclasses.dataclass(frozen=True)
class RunConfig:
    name: str
    model_family: str
    model: Any
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: dict = dataclasses.field(default_factory=dict)
    notes: str = ""


_REGISTRY: dict[str, Callable[[], RunConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], RunConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str, **overrides) -> RunConfig:
    """The registered run `name`, with `overrides`: a `TrainConfig`
    field name sets that train field (an overridden `steps` also moves
    the schedule's horizon, `optimizer.total_steps`, to it, as the
    reference keeps them aligned); any other name sets a `RunConfig`
    field."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; available: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    train_fields = {f.name for f in dataclasses.fields(TrainConfig)}
    train_overrides = {k: v for k, v in overrides.items() if k in train_fields}
    rest = {k: v for k, v in overrides.items() if k not in train_fields}
    if train_overrides:
        train = dataclasses.replace(cfg.train, **train_overrides)
        if "steps" in train_overrides:
            train = dataclasses.replace(train, optimizer=dataclasses.replace(
                train.optimizer, total_steps=train_overrides["steps"]))
        cfg = dataclasses.replace(cfg, train=train)
    if rest:
        cfg = dataclasses.replace(cfg, **rest)
    return cfg


def list_configs() -> list[str]:
    return sorted(_REGISTRY)


def dense_twin(cfg: RunConfig) -> RunConfig:
    """The single-device run of a context-parallel config: the same
    model with `context_parallel` off (params are replicated at rest, so
    nothing else changes) and the train settings without the mesh — what
    the reference's `cli serve` serves and `cli train` samples with."""
    if not getattr(cfg.model, "context_parallel", False):
        return cfg
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, context_parallel=False),
        train=dataclasses.replace(cfg.train, context_parallel=False, mesh=None),
    )


@register("gpt_tiny")
def _gpt_tiny() -> RunConfig:
    """CPU-runnable smoke config (debugging / CI)."""
    return RunConfig(
        name="gpt_tiny",
        model_family="gpt",
        model=GPTConfig(vocab_size=64, block_size=64, dim=64, n_layers=2,
                        n_heads=2, dropout=0.0),
        train=TrainConfig(
            steps=100, batch_size=16, log_every=20, eval_every=50, eval_batches=5,
            optimizer=OptimizerConfig(max_lr=3e-3, warmup_steps=10, total_steps=100),
            tokens_per_step=16 * 64,
        ),
        data={"kind": "char", "path": None, "block_size": 64},
        notes="smoke-test config, not a reference workload",
    )


@register("gpt_tiny_long")
def _gpt_tiny_long() -> RunConfig:
    """gpt_tiny with a 256-position budget (the serving benches' long-stream
    smoke config)."""
    return RunConfig(
        name="gpt_tiny_long",
        model_family="gpt",
        model=GPTConfig(vocab_size=64, block_size=256, dim=64, n_layers=2,
                        n_heads=2, dropout=0.0),
        train=TrainConfig(
            steps=300, batch_size=16, log_every=50, eval_every=0,
            optimizer=OptimizerConfig(max_lr=3e-3, warmup_steps=10,
                                      total_steps=300),
            tokens_per_step=16 * 256,
        ),
        data={"kind": "char", "path": None, "block_size": 256},
        notes="smoke/bench config for long serve streams, not a "
              "reference workload",
    )


@register("gpt_shakespeare")
def _gpt_shakespeare() -> RunConfig:
    """The reference's gpt/gpt-jax.ipynb cell 8 hyperparameters: dim 256,
    8 layers, 1 head, dropout 0.1, bf16, 128 x 256 tokens a step, windows
    of 10 steps (`scan_steps`)."""
    return RunConfig(
        name="gpt_shakespeare",
        model_family="gpt",
        model=GPTConfig(
            vocab_size=65, block_size=256, dim=256, n_layers=8, n_heads=1,
            dropout=0.1, dtype="bfloat16",
        ),
        train=TrainConfig(
            steps=1000, batch_size=128, log_every=50, eval_every=100,
            eval_batches=20, scan_steps=10,
            optimizer=OptimizerConfig(
                name="adamw", max_lr=1e-3, warmup_steps=0, total_steps=1000,
                weight_decay=0.1, grad_clip=1.0,
            ),
            tokens_per_step=128 * 256,
        ),
        data={"kind": "char", "path": None, "block_size": 256},
        notes="gpt/gpt-jax.ipynb cells 8-19; val loss 1.8871 @ step 1000 on T4",
    )


@register("llama3_shakespeare")
def _llama3_shakespeare() -> RunConfig:
    """The reference notebook's LLaMA-3 hyperparameters (llama3/LLaMA-jax
    cell 9), trained with its hand-rolled SGD (cell 29) over 30 epochs x
    1000 steps (cell 31)."""
    return RunConfig(
        name="llama3_shakespeare",
        model_family="llama3",
        model=LlamaConfig(
            vocab_size=50257, max_seq_len=128, dim=256, n_layers=2, n_heads=4,
            n_kv_heads=2, hidden_dim=1024, dropout=0.0, dtype="bfloat16",
        ),
        train=TrainConfig(
            steps=30_000, batch_size=16, log_every=100, eval_every=1000,
            eval_batches=20,
            optimizer=OptimizerConfig(
                name="sgd", max_lr=3e-4, warmup_steps=0, total_steps=30_000,
                grad_clip=0.0, weight_decay=0.0, min_lr_ratio=1.0,
            ),
            tokens_per_step=16 * 128,
        ),
        data={"kind": "char", "path": None, "block_size": 128},
        notes="LLaMA-jax.ipynb cells 9, 29-31",
    )


@register("llama3_long")
def _llama3_long() -> RunConfig:
    """Long-context LLaMA-3: dim 1024, 16 layers, 16 q / 8 kv heads
    (head_dim 64), SwiGLU hidden 2730, RoPE to 32768 positions, bf16,
    flash attention. Trained context-parallel over 4 chips in the
    reference; the port trains and serves its dense twin."""
    return RunConfig(
        name="llama3_long",
        model_family="llama3",
        model=LlamaConfig(
            vocab_size=50257, max_seq_len=32_768, dim=1024, n_layers=16,
            n_heads=16, n_kv_heads=8, dropout=0.0, dtype="bfloat16",
            context_parallel=True, use_flash=True,
        ),
        train=TrainConfig(
            steps=10_000, batch_size=8, log_every=50, eval_every=500,
            eval_batches=8, ckpt_every=1000,
            mesh={"data": -1, "context": 4},
            context_parallel=True,
            optimizer=OptimizerConfig(
                name="adamw", max_lr=3e-4, warmup_steps=200, total_steps=10_000,
                weight_decay=0.1, grad_clip=1.0,
            ),
            tokens_per_step=8 * 32_768,
        ),
        data={"kind": "bpe", "path": None, "block_size": 32_768,
              "bpe_vocab_size": 32_000, "synthetic_chars": 4_000_000},
        notes="beyond-reference long-context config",
    )


@register("llama3_long_smoke")
def _llama3_long_smoke() -> RunConfig:
    """llama3_long at toy dims (the reference's CPU-mesh smoke)."""
    return RunConfig(
        name="llama3_long_smoke",
        model_family="llama3",
        model=LlamaConfig(
            vocab_size=256, max_seq_len=256, dim=64, n_layers=2,
            n_heads=4, n_kv_heads=2, dropout=0.0, dtype="float32",
            context_parallel=True, use_flash=True,
        ),
        train=TrainConfig(
            steps=20, batch_size=4, log_every=5, eval_every=10,
            eval_batches=2,
            mesh={"data": -1, "context": 4},
            context_parallel=True,
            optimizer=OptimizerConfig(
                name="adamw", max_lr=1e-3, warmup_steps=5, total_steps=20,
                weight_decay=0.1, grad_clip=1.0,
            ),
            tokens_per_step=4 * 256,
        ),
        data={"kind": "char", "path": None, "block_size": 256},
        notes="llama3_long at smoke scale",
    )


@register("dsv3_long")
def _dsv3_long() -> RunConfig:
    """Long-context DeepSeek-V3 (MLA + MoE): dim 512, 6 layers, 8 heads,
    latent 64, decoupled RoPE 64, 8 experts top-2 with a shared expert,
    16,384-token context on one device through flash MLA (MQA over the
    latent stream, head dim 128) with per-layer remat and attention
    dropout 0.1 inside the flash kernels."""
    return RunConfig(
        name="dsv3_long",
        model_family="deepseekv3",
        model=DeepSeekV3Config(
            vocab_size=50257, block_size=16_384, dtype="bfloat16",
            use_flash=True, remat=True, pe_scale=0.02, rope_dim=64,
        ),
        train=TrainConfig(
            steps=10_000, batch_size=1, log_every=50, eval_every=500,
            eval_batches=4, ckpt_every=1000,
            optimizer=OptimizerConfig(
                name="adamw", max_lr=3e-4, warmup_steps=200, total_steps=10_000,
                b1=0.9, b2=0.95, weight_decay=0.1, grad_clip=1.0,
            ),
            tokens_per_step=16_384,
        ),
        data={"kind": "bpe", "path": None, "block_size": 16_384,
              "bpe_vocab_size": 32_000, "synthetic_chars": 2_000_000},
        notes="beyond-reference: 64x the reference's maximum context for "
              "its own flagship architecture, one chip",
    )


@register("dsv3_tinystories")
def _dsv3_tinystories() -> RunConfig:
    """The reference notebook's flagship DeepSeek-V3 (deepseekv3.ipynb
    cells 4, 42-44, 54): dim 512, 6 layers, 8 heads, latent 64, 8 experts
    top-2 with a shared expert, dropout 0.1, bf16, 16 x 256 tokens a
    step, AdamW 6e-4 with a 400-step warmup; `pe_scale` 0.02, capacity
    factor 4 and a 1e-2 balance loss as the reference registers it. The
    notebook tokenizes TinyStories with GPT-2 BPE; offline, the char
    pipeline (the factory resizes the vocab)."""
    return RunConfig(
        name="dsv3_tinystories",
        model_family="deepseekv3",
        model=DeepSeekV3Config(dtype="bfloat16", pe_scale=0.02,
                               capacity_factor=4.0, balance_loss_weight=1e-2),
        train=TrainConfig(
            steps=10_000, batch_size=16, log_every=100, eval_every=500,
            eval_batches=20, ckpt_every=1000,
            optimizer=OptimizerConfig(
                name="adamw", max_lr=6e-4, warmup_steps=400, total_steps=10_000,
                b1=0.9, b2=0.95, weight_decay=0.1, grad_clip=1.0, eps=1e-8,
            ),
            tokens_per_step=16 * 256,
        ),
        data={"kind": "char", "path": None, "block_size": 256},
        notes="deepseekv3 readme: loss 2.90068 / ppl 18.18644 @ 10k steps",
    )


@register("dsv3_mtp")
def _dsv3_mtp() -> RunConfig:
    """The flagship with multi-token prediction on (2 heads, loss weight
    0.3), as the reference registers it: dim 512, 6 layers, 8 heads,
    latent 64, 8 experts top-2 with a shared expert, dropout 0.1, bf16,
    16 x 256 tokens a step on the char corpus (the factory resizes the
    vocab)."""
    return RunConfig(
        name="dsv3_mtp",
        model_family="deepseekv3",
        model=DeepSeekV3Config(dtype="bfloat16", mtp_heads=2, pe_scale=0.02),
        train=TrainConfig(
            steps=10_000, batch_size=16, log_every=50, eval_every=500,
            eval_batches=8, ckpt_every=1000,
            optimizer=OptimizerConfig(
                name="adamw", max_lr=6e-4, warmup_steps=400, total_steps=10_000,
                b1=0.9, b2=0.95, weight_decay=0.1, grad_clip=1.0,
            ),
            tokens_per_step=16 * 256,
        ),
        data={"kind": "char", "path": None, "block_size": 256},
        notes="deepseekv3 with mtp_heads=2 live (the reference's dormant "
              "branch); main CE + 0.3 x MTP loss",
    )


# Entropy-calibrated rows on the order-2 Markov corpus (`data.synthetic`
# MarkovSource): the corpus's exact entropy rate is an absolute val-loss
# target.
_MARKOV_DATA = {"kind": "char", "source": "markov", "block_size": 256,
                "n_chars": 4_000_000}


def _markov_train(steps: int, batch_size: int, block: int,
                  max_lr: float = 1e-3) -> TrainConfig:
    return TrainConfig(
        steps=steps, batch_size=batch_size, log_every=100,
        eval_every=max(steps // 4, 1), eval_batches=20,
        optimizer=OptimizerConfig(
            name="adamw", max_lr=max_lr, warmup_steps=min(100, steps // 10),
            total_steps=steps, weight_decay=0.01, grad_clip=1.0,
        ),
        tokens_per_step=batch_size * block,
    )


@register("gpt_markov")
def _gpt_markov() -> RunConfig:
    return RunConfig(
        name="gpt_markov",
        model_family="gpt",
        model=GPTConfig(vocab_size=64, block_size=256, dim=256, n_layers=4,
                        n_heads=4, dropout=0.0, dtype="bfloat16"),
        train=_markov_train(3000, 64, 256),
        data=dict(_MARKOV_DATA),
        notes="entropy-calibrated quality row; target val_loss -> H ~= 2.362",
    )


@register("llama3_markov")
def _llama3_markov() -> RunConfig:
    return RunConfig(
        name="llama3_markov",
        model_family="llama3",
        model=LlamaConfig(vocab_size=64, max_seq_len=256, dim=256, n_layers=3,
                          n_heads=4, n_kv_heads=2, dropout=0.0, dtype="bfloat16"),
        train=_markov_train(3000, 64, 256),
        data=dict(_MARKOV_DATA),
        notes="entropy-calibrated quality row; target val_loss -> H ~= 2.362",
    )


@register("dsv3_markov")
def _dsv3_markov() -> RunConfig:
    """The MoE row of the Markov corpus, on a 16M-char corpus (the
    reference's capacity-matched size: on 4M chars the MoE memorizes)."""
    return RunConfig(
        name="dsv3_markov",
        model_family="deepseekv3",
        model=DeepSeekV3Config(vocab_size=64, block_size=256, dim=256,
                               n_layers=4, n_heads=4, latent_dim=32,
                               rope_dim=32, pe_scale=0.02,
                               n_experts=8, top_experts=2, dropout=0.0,
                               attn_dropout=0.0, dtype="bfloat16"),
        train=_markov_train(3000, 64, 256),
        data={**_MARKOV_DATA, "n_chars": 16_000_000},
        notes="entropy-calibrated quality row; target val_loss -> H ~= 2.362",
    )
