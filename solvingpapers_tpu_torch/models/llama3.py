"""LLaMA-3-style decoder-only LM (port of `solvingpapers_tpu/models/llama3.py`).

RMSNorm pre-norm blocks, GQA attention with interleaved-pair RoPE, a
SwiGLU feed-forward and an untied output head; a preallocated KV cache
per layer (`init_caches`) serves cached prefill and decode. Context
parallelism is not part of the port yet: a config with
`context_parallel=True` is served as its dense twin
(`configs.registry.dense_twin`), as the reference's `cli serve` does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from solvingpapers_tpu_torch import ops
from solvingpapers_tpu_torch.device import resolve_device
from solvingpapers_tpu_torch.infer.cache import KVCache
from solvingpapers_tpu_torch.models.layers import (
    GLUFFN,
    Attention,
    Dense,
    Embed,
    RMSNorm,
    default_positions,
    swiglu_hidden_dim,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 50257  # tiktoken gpt2
    max_seq_len: int = 128
    dim: int = 256
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    hidden_dim: int | None = None  # None => swiglu 2/3·4·dim convention
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "float32"
    use_flash: bool = False
    # the reference's ring/Ulysses context parallelism; not ported — a
    # model built from such a config raises (serve its dense twin)
    context_parallel: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def ffn_hidden(self) -> int:
        return self.hidden_dim or swiglu_hidden_dim(self.dim)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, rope, device=None):
        super().__init__()
        dt = cfg.compute_dtype
        self.attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, device=device)
        self.attn = Attention(cfg.dim, cfg.n_heads, cfg.n_kv_heads,
                              causal=True, rope=rope, dtype=dt,
                              use_flash=cfg.use_flash, device=device)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, device=device)
        self.ffn = GLUFFN(cfg.dim, cfg.ffn_hidden, ops.silu, dtype=dt,
                          device=device)

    def forward(self, x, positions=None, cache=None, attend_len=None):
        h, cache = self.attn(self.attn_norm(x), positions=positions,
                             cache=cache, attend_len=attend_len)
        x = x + h
        return x + self.ffn(self.ffn_norm(x)), cache


class Llama(nn.Module):
    """``Llama(cfg, device=None)``: built on `device` (default ``cuda``;
    raises when there is none — see `device.resolve_device`)."""

    def __init__(self, cfg: LlamaConfig, device: str | torch.device | None = None):
        super().__init__()
        if cfg.context_parallel:
            raise NotImplementedError(
                "context parallelism is not ported; build the dense twin "
                "(configs.registry.dense_twin) to serve this config"
            )
        device = resolve_device(device)
        self.cfg = cfg
        rope = ops.precompute_rope(cfg.head_dim, cfg.max_seq_len,
                                   cfg.rope_theta, device=device)
        self.tok_emb = Embed(cfg.vocab_size, cfg.dim,
                             dtype=cfg.compute_dtype, device=device)
        self.blocks = nn.ModuleList(
            LlamaBlock(cfg, rope, device=device) for _ in range(cfg.n_layers)
        )
        self.norm_f = RMSNorm(cfg.dim, cfg.norm_eps, device=device)
        self.lm_head = Dense(cfg.dim, cfg.vocab_size, dtype=cfg.compute_dtype,
                             device=device)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @property
    def max_positions(self) -> int:
        return self.cfg.max_seq_len

    def forward(self, tokens: torch.Tensor, *,
                positions: torch.Tensor | None = None,
                caches: list[KVCache] | None = None,
                attend_len: int | None = None):
        """tokens (B, S) -> (logits (B, S, vocab) in the compute dtype,
        caches). Modes as in `layers.Attention`."""
        b, s = tokens.shape
        if positions is None:
            positions = default_positions(b, s, device=tokens.device)
        x = self.tok_emb(tokens)
        new_caches = [] if caches is not None else None
        for i, block in enumerate(self.blocks):
            x, c = block(x, positions, None if caches is None else caches[i],
                         attend_len)
            if new_caches is not None:
                new_caches.append(c)
        x = self.norm_f(x)
        return self.lm_head(x), new_caches

    def init_caches(self, batch: int, max_len: int, dtype=None) -> list[KVCache]:
        cfg = self.cfg
        dtype = dtype or cfg.compute_dtype
        return [
            KVCache.init(batch, max_len, cfg.n_kv_heads, cfg.head_dim, dtype,
                         device=self.device)
            for _ in range(cfg.n_layers)
        ]


def _lecun_normal(shape, generator, device) -> torch.Tensor:
    """Flax's default Dense kernel init (lecun_normal): a standard normal
    truncated to [-2, 2], times sqrt(1 / fan_in) / 0.8796..., the
    truncated normal's own standard deviation. `shape` is Flax's
    (in, out); the result is torch's (out, in)."""
    fan_in, fan_out = shape
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(fan_out, fan_in, device=device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(std)


def init_params(cfg: LlamaConfig, generator: torch.Generator) -> dict:
    """Random float32 parameters drawn from the reference's (Flax's)
    default initializers, on the generator's device: lecun_normal Dense
    kernels, `nn.Embed`'s variance_scaling(1, fan_in, normal) — a normal
    of std sqrt(1 / dim) — and ones for norm weights. The bits differ
    from a JAX init (different generators); the distributions, and so
    the logit scale a random-init model serves at, are the same.
    Returns a state dict for `Llama.load_state_dict`."""
    dev = generator.device
    d, hd = cfg.dim, cfg.head_dim
    sd = {}
    emb = torch.empty(cfg.vocab_size, d, device=dev)
    sd["tok_emb.weight"] = emb.normal_(0.0, math.sqrt(1.0 / d),
                                       generator=generator)
    for i in range(cfg.n_layers):
        p = f"blocks.{i}."
        sd[p + "attn_norm.weight"] = torch.ones(d, device=dev)
        sd[p + "attn.q.weight"] = _lecun_normal((d, cfg.n_heads * hd), generator, dev)
        sd[p + "attn.k.weight"] = _lecun_normal((d, cfg.n_kv_heads * hd), generator, dev)
        sd[p + "attn.v.weight"] = _lecun_normal((d, cfg.n_kv_heads * hd), generator, dev)
        sd[p + "attn.out.weight"] = _lecun_normal((cfg.n_heads * hd, d), generator, dev)
        sd[p + "ffn_norm.weight"] = torch.ones(d, device=dev)
        sd[p + "ffn.gate.weight"] = _lecun_normal((d, cfg.ffn_hidden), generator, dev)
        sd[p + "ffn.up.weight"] = _lecun_normal((d, cfg.ffn_hidden), generator, dev)
        sd[p + "ffn.down.weight"] = _lecun_normal((cfg.ffn_hidden, d), generator, dev)
    sd["norm_f.weight"] = torch.ones(d, device=dev)
    sd["lm_head.weight"] = _lecun_normal((d, cfg.vocab_size), generator, dev)
    return sd
