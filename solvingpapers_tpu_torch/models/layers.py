"""Shared building blocks (port of `solvingpapers_tpu/models/layers.py`:
the parts LLaMA-3 uses, without context parallelism).

Parameters are created empty — they come from `models.llama3.init_params`
or from `convert.py` — and hold no gradient (this slice serves; training
is a later slice).

dtype placement follows Flax exactly: an `nn.Dense(dtype=bf16)` casts
both its input and its float32 kernel to bf16 and returns bf16. `Dense`
here stores its weight already in the compute dtype — rounding a float32
weight to bf16 once at load gives the same bits as rounding it at every
call, without re-reading the float32 copy per forward — and casts its
input. Norm weights stay float32, as the reference's are (`rms_norm`
multiplies in float32).
"""

from __future__ import annotations

import torch
from torch import nn

from solvingpapers_tpu_torch import ops
from solvingpapers_tpu_torch.infer.cache import KVCache, update_kv_cache
from solvingpapers_tpu_torch.kernels import flash_attention


def default_positions(b: int, s: int, max_positions: int | None = None,
                      device: str | torch.device | None = None) -> torch.Tensor:
    """Default (B, S) absolute positions, arange(s) per row. A sequence
    longer than `max_positions` raises instead of being clamped."""
    if max_positions is not None and s > max_positions:
        raise ValueError(f"sequence {s} exceeds max positions {max_positions}")
    return torch.arange(s, device=device).expand(b, s)


def _empty(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    """`nn.Dense` with a compute dtype: y = x.to(dtype) @ W^T (+ b).
    `weight` is (out, in), the transpose of Flax's (in, out) kernel."""

    def __init__(self, in_features: int, out_features: int, *,
                 use_bias: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.weight = _empty(out_features, in_features, dtype=dtype, device=device)
        self.bias = (_empty(out_features, dtype=dtype, device=device)
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x.to(self.weight.dtype), self.weight,
                                    self.bias)


class Embed(nn.Module):
    """`nn.Embed` with a compute dtype: Flax casts the float32 table to
    `dtype` and gathers; the table is stored cast (same bits)."""

    def __init__(self, num_embeddings: int, features: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.weight = _empty(num_embeddings, features, dtype=dtype,
                             device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(tokens, self.weight)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device),
                                   requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.rms_norm(x, self.weight, self.eps)


class Attention(nn.Module):
    """Multi-head attention with optional GQA/MQA, RoPE, causality and a
    KV cache — the three non-context-parallel modes of the reference:

    * uncached (`cache` None): full attention over `x` — the flash kernel
      under `use_flash`, else the dense op;
    * cached prefill (`cache` and `attend_len` given): the chunk's k/v are
      written at cache slots ``[attend_len - S, attend_len)`` and it
      attends END-aligned causally over the first `attend_len` slots (a
      slice, so no (S, max_len) mask or score tensor exists) — the flash
      kernel's ``Sq <= Skv`` mode under `use_flash`;
    * cached decode (`cache` given, `attend_len` None): each row writes at
      its own ``positions[:, 0]`` and attends densely over the whole cache
      with the mask ``kv_index <= position``.

    The prefill contract makes the chunk's first position equal to
    ``attend_len - S``, which is where the reference writes
    (``positions[0, 0]``); using the host-side integer keeps the write a
    slice. `rope` is the shared (cos, sin) table pair of the model, or
    None for no rotary embedding.
    """

    def __init__(self, dim: int, n_heads: int, n_kv_heads: int | None = None,
                 head_dim: int | None = None, *, causal: bool = True,
                 rope: tuple[torch.Tensor, torch.Tensor] | None = None,
                 use_bias: bool = False, dtype=torch.float32,
                 use_flash: bool = False, device=None):
        super().__init__()
        self.n_heads = n_heads
        self.n_kv = n_kv_heads or n_heads
        self.head_dim = head_dim or dim // n_heads
        self.causal = causal
        self.rope = rope
        self.use_flash = use_flash
        kw = dict(use_bias=use_bias, dtype=dtype, device=device)
        self.q = Dense(dim, n_heads * self.head_dim, **kw)
        self.k = Dense(dim, self.n_kv * self.head_dim, **kw)
        self.v = Dense(dim, self.n_kv * self.head_dim, **kw)
        self.out = Dense(n_heads * self.head_dim, dim, **kw)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor | None = None,
                cache: KVCache | None = None,
                attend_len: int | None = None):
        b, s, _ = x.shape
        if positions is None:
            positions = default_positions(b, s, device=x.device)
        q = self.q(x).view(b, s, self.n_heads, self.head_dim)
        k = self.k(x).view(b, s, self.n_kv, self.head_dim)
        v = self.v(x).view(b, s, self.n_kv, self.head_dim)
        if self.rope is not None:
            cos, sin = self.rope
            q = ops.apply_rope(q, cos, sin, positions=positions)
            k = ops.apply_rope(k, cos, sin, positions=positions)

        if cache is not None and attend_len is not None:
            cache = update_kv_cache(cache, k, v, attend_len - s)
            k_att = cache.k[:, :attend_len]
            v_att = cache.v[:, :attend_len]
            if self.use_flash:
                out = flash_attention(q, k_att, v_att, causal=True)
            else:
                out = ops.dot_product_attention(q, k_att, v_att, causal=True)
        elif cache is not None:
            cache = update_kv_cache(cache, k, v, positions[:, 0])
            kv_idx = torch.arange(cache.max_len, device=x.device)
            # (B, 1, S, max_len): the query at position p sees kv slots <= p
            mask = kv_idx[None, None, None, :] <= positions[:, None, :, None]
            out = ops.dot_product_attention(q, cache.k, cache.v, mask=mask)
        elif self.use_flash:
            out = flash_attention(q, k, v, causal=self.causal)
        else:
            out = ops.dot_product_attention(q, k, v, causal=self.causal)

        out = out.reshape(b, s, self.n_heads * self.head_dim)
        return self.out(out), cache


class GLUFFN(nn.Module):
    """Gated-linear-unit FFN: down(act(gate(x)) * up(x)); silu = SwiGLU."""

    def __init__(self, dim: int, hidden_dim: int, activation=ops.silu, *,
                 use_bias: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(use_bias=use_bias, dtype=dtype, device=device)
        self.activation = activation
        self.gate = Dense(dim, hidden_dim, **kw)
        self.up = Dense(dim, hidden_dim, **kw)
        self.down = Dense(hidden_dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(self.activation(self.gate(x)) * self.up(x))


def swiglu_hidden_dim(dim: int, multiplier: int = 4) -> int:
    """The (2/3)·4·dim sizing convention: ((2·dim)·4) // 3."""
    return (2 * dim * multiplier) // 3
