"""GPT decoder-only char LM (port of `solvingpapers_tpu/models/gpt.py`).

A learned position table of `block_size` rows, pre-LN blocks
(``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``) of causal multi-head
attention with biases and a 4x tanh-GELU MLP, a final LayerNorm and an
untied head without bias; a preallocated KV cache per layer
(`init_caches`) serves cached prefill and decode.

Dropout (embedding, attention probabilities, attention output, MLP) is
active in training mode and drawn from a seed the caller passes
(`forward`'s `dropout_seed`): layer i's masks come from ``mix_seed(seed,
i)``, split per site, the embedding's from ``mix_seed(seed, n_layers)``,
so a remat recomputation redraws the same masks. Context parallelism is
not part of the port (ROADMAP A7): a config that sets it raises.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from solvingpapers_tpu_torch.device import resolve_device
from solvingpapers_tpu_torch.infer.cache import KVCache
from solvingpapers_tpu_torch.kernels.dropout import dropout, mix_seed
from solvingpapers_tpu_torch.models.layers import (
    MLP,
    Attention,
    Dense,
    Embed,
    LayerNorm,
    default_positions,
    maybe_remat,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 65
    block_size: int = 256
    dim: int = 256
    n_layers: int = 8
    n_heads: int = 1
    mlp_mult: int = 4
    dropout: float = 0.1
    dtype: str = "float32"
    use_flash: bool = False
    remat: bool = False  # recompute each block's activations in the backward
    # the reference's ring/Ulysses context parallelism; not ported — a
    # model built from such a config raises
    context_parallel: bool = False
    context_impl: str = "ring"  # ring | ulysses

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, param_dtype=None):
        super().__init__()
        kw = dict(dtype=cfg.compute_dtype, param_dtype=param_dtype,
                  device=device)
        self.ln1 = LayerNorm(cfg.dim, device=device)
        self.attn = Attention(cfg.dim, cfg.n_heads, causal=True,
                              dropout=cfg.dropout, use_bias=True,
                              use_flash=cfg.use_flash, **kw)
        self.ln2 = LayerNorm(cfg.dim, device=device)
        self.mlp = MLP(cfg.dim, cfg.mlp_mult * cfg.dim, dropout=cfg.dropout,
                       **kw)

    def forward(self, x, positions=None, cache=None, attend_len=None, seed=None):
        """`seed` None runs the block deterministic; an int seeds its
        dropout: the attention's masks from ``mix_seed(seed, 0)``, the
        MLP's from ``mix_seed(seed, 1)``."""
        h, cache = self.attn(
            self.ln1(x), positions=positions, cache=cache, attend_len=attend_len,
            dropout_seed=None if seed is None else mix_seed(seed, 0))
        x = x + h
        x = x + self.mlp(self.ln2(x),
                         dropout_seed=None if seed is None else mix_seed(seed, 1))
        return x, cache


class GPT(nn.Module):
    """``GPT(cfg, device=None, param_dtype=None)`` on `device` (default
    ``cuda``; raises when there is none), `param_dtype` as in
    `models.llama3.Llama` (float32 master weights for training)."""

    def __init__(self, cfg: GPTConfig, device: str | torch.device | None = None,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        if cfg.context_parallel:
            raise NotImplementedError(
                "context parallelism is not ported (ROADMAP A7)")
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.compute_dtype, param_dtype=param_dtype,
                  device=device)
        self.tok_emb = Embed(cfg.vocab_size, cfg.dim, **kw)
        self.pos_emb = nn.Parameter(torch.empty(cfg.block_size, cfg.dim,
                                                device=device))
        self.blocks = nn.ModuleList(
            GPTBlock(cfg, device=device, param_dtype=param_dtype)
            for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.dim, device=device)
        self.lm_head = Dense(cfg.dim, cfg.vocab_size, **kw)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @property
    def max_positions(self) -> int:
        return self.cfg.block_size

    def forward(self, tokens: torch.Tensor, *,
                positions: torch.Tensor | None = None,
                caches: list[KVCache] | None = None,
                attend_len: int | None = None,
                dropout_seed: int | None = None):
        """tokens (B, S) -> (logits (B, S, vocab) in the compute dtype,
        caches). Modes as in `layers.Attention`. In training mode
        (`self.training`) dropout is active and `dropout_seed` must be
        given when the rate is > 0; eval mode is deterministic. Under
        `remat` each block is recomputed in the backward."""
        cfg = self.cfg
        drop = self.training and cfg.dropout > 0.0
        if drop and dropout_seed is None:
            raise ValueError("dropout_seed is required when dropout is active "
                             "(training mode, a rate > 0)")
        b, s = tokens.shape
        if positions is None:
            # the learned table's length bounds the positions: a longer
            # sequence raises instead of reading past the table
            positions = default_positions(b, s, max_positions=cfg.block_size,
                                          device=tokens.device)
        x = self.tok_emb(tokens) + self.pos_emb[positions].to(cfg.compute_dtype)
        if drop:
            x = dropout(x, cfg.dropout, mix_seed(dropout_seed, cfg.n_layers))
        new_caches = [] if caches is not None else None
        for i, block in enumerate(self.blocks):
            run = maybe_remat(block, cfg.remat and caches is None)
            seed = mix_seed(dropout_seed, i) if drop else None
            x, c = run(x, positions, None if caches is None else caches[i],
                       attend_len, seed)
            if new_caches is not None:
                new_caches.append(c)
        x = self.ln_f(x)
        return self.lm_head(x), new_caches

    def init_caches(self, batch: int, max_len: int, dtype=None) -> list[KVCache]:
        cfg = self.cfg
        dtype = dtype or cfg.compute_dtype
        return [
            KVCache.init(batch, max_len, cfg.n_heads, cfg.head_dim, dtype,
                         device=self.device)
            for _ in range(cfg.n_layers)
        ]


def init_params(cfg: GPTConfig, generator: torch.Generator) -> dict:
    """Random float32 parameters drawn from the reference's (Flax's)
    initializers, on the generator's device: lecun_normal Dense kernels
    with zero biases, `nn.Embed`'s normal of std sqrt(1 / dim), the
    position table's normal(0.02), ones and zeros for the LayerNorms. The
    bits differ from a JAX init (other generators); the distributions are
    the same. Returns a state dict for `GPT.load_state_dict`."""
    from solvingpapers_tpu_torch.models.llama3 import _lecun_normal

    dev = generator.device
    d, hidden = cfg.dim, cfg.mlp_mult * cfg.dim
    sd = {}
    emb = torch.empty(cfg.vocab_size, d, device=dev)
    sd["tok_emb.weight"] = emb.normal_(0.0, math.sqrt(1.0 / d), generator=generator)
    pos = torch.empty(cfg.block_size, d, device=dev)
    sd["pos_emb"] = pos.normal_(0.0, 0.02, generator=generator)

    def dense(name, fan_in, fan_out):
        sd[name + ".weight"] = _lecun_normal((fan_in, fan_out), generator, dev)
        sd[name + ".bias"] = torch.zeros(fan_out, device=dev)

    def norm(name):
        sd[name + ".weight"] = torch.ones(d, device=dev)
        sd[name + ".bias"] = torch.zeros(d, device=dev)

    for i in range(cfg.n_layers):
        p = f"blocks.{i}."
        norm(p + "ln1")
        for proj in ("q", "k", "v"):
            dense(p + "attn." + proj, d, d)
        dense(p + "attn.out", d, d)
        norm(p + "ln2")
        dense(p + "mlp.fc", d, hidden)
        dense(p + "mlp.proj", hidden, d)
    norm("ln_f")
    sd["lm_head.weight"] = _lecun_normal((d, cfg.vocab_size), generator, dev)
    return sd
