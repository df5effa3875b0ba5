"""Shared building blocks (port of `solvingpapers_tpu/models/layers.py`:
the parts GPT, LLaMA-3 and DeepSeek-V3 use, without context parallelism).

Parameters are created empty — they come from a family's `init_params`
(`models.llama3`, `models.deepseekv3`) or from `convert.py` — and are
trainable.

dtype placement follows Flax exactly: an `nn.Dense(dtype=bf16)` casts
both its input and its float32 kernel to bf16 and returns bf16; an
`nn.Embed(dtype=bf16)` gathers rows of its table cast to bf16. Two
storage layouts give those values:

* ``param_dtype=None`` (serving): `Dense` and `Embed` store their weight
  already in the compute dtype — rounding a float32 weight to bf16 once
  at load gives the same bits as rounding it at every call, without
  re-reading a float32 copy per forward;
* ``param_dtype=torch.float32`` (training): float32 master weights, cast
  to the compute dtype inside `forward`, so the optimizer updates
  float32 values and autograd carries the cast's gradient back to them.

Norm weights stay float32 in both, as the reference's are (`rms_norm`
and `layer_norm` multiply in float32).

Dropout (`Attention`, `MLP`) is a pure function of a seed passed to
`forward` (`kernels.dropout`): None runs the module deterministic, an int
draws its masks, so a remat recomputation redraws the same ones.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from solvingpapers_tpu_torch import ops
from solvingpapers_tpu_torch.infer.cache import KVCache, update_kv_cache
from solvingpapers_tpu_torch.kernels import flash_attention
from solvingpapers_tpu_torch.kernels.dropout import dropout, mix_seed


def default_positions(b: int, s: int, max_positions: int | None = None,
                      device: str | torch.device | None = None) -> torch.Tensor:
    """Default (B, S) absolute positions, arange(s) per row. A sequence
    longer than `max_positions` raises instead of being clamped."""
    if max_positions is not None and s > max_positions:
        raise ValueError(f"sequence {s} exceeds max positions {max_positions}")
    return torch.arange(s, device=device).expand(b, s)


def _empty(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Dense(nn.Module):
    """`nn.Dense` with a compute dtype: y = x.to(dtype) @ W.to(dtype)^T
    (+ b). `weight` is (out, in), the transpose of Flax's (in, out)
    kernel, stored in `param_dtype` (None: the compute dtype)."""

    def __init__(self, in_features: int, out_features: int, *,
                 use_bias: bool = False, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        stored = param_dtype or dtype
        self.weight = _empty(out_features, in_features, dtype=stored,
                             device=device)
        self.bias = (_empty(out_features, dtype=stored, device=device)
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return nn.functional.linear(x.to(self.dtype),
                                    self.weight.to(self.dtype), bias)


class Embed(nn.Module):
    """`nn.Embed` with a compute dtype: rows of the table in `dtype`.
    The table is stored in `param_dtype` (None: the compute dtype); a
    float32 table is gathered, then cast — the same values as Flax's
    cast-then-gather, without casting the whole table per forward."""

    def __init__(self, num_embeddings: int, features: int, *,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _empty(num_embeddings, features,
                             dtype=param_dtype or dtype, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(tokens, self.weight).to(self.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.rms_norm(x, self.weight, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.layer_norm(x, self.weight, self.bias, self.eps)


class Attention(nn.Module):
    """Multi-head attention with optional GQA/MQA, RoPE, causality and a
    KV cache — the three non-context-parallel modes of the reference:

    * uncached (`cache` None): full attention over `x` — under
      `use_flash` the flash kernels (differentiable: the training path),
      else the dense op (differentiable through autograd);
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

    With `dropout` > 0 and a `dropout_seed`, the uncached path drops
    attention probabilities (masks of ``mix_seed(seed, 0)``, inside the
    flash kernels under `use_flash`) and the output projection's result
    (``mix_seed(seed, 1)``), as the reference's module does.
    """

    def __init__(self, dim: int, n_heads: int, n_kv_heads: int | None = None,
                 head_dim: int | None = None, *, causal: bool = True,
                 rope: tuple[torch.Tensor, torch.Tensor] | None = None,
                 dropout: float = 0.0, use_bias: bool = False,
                 dtype=torch.float32, param_dtype=None,
                 use_flash: bool = False, device=None):
        super().__init__()
        self.dropout = dropout
        self.n_heads = n_heads
        self.n_kv = n_kv_heads or n_heads
        self.head_dim = head_dim or dim // n_heads
        self.causal = causal
        self.rope = rope
        self.use_flash = use_flash
        kw = dict(use_bias=use_bias, dtype=dtype, param_dtype=param_dtype,
                  device=device)
        self.q = Dense(dim, n_heads * self.head_dim, **kw)
        self.k = Dense(dim, self.n_kv * self.head_dim, **kw)
        self.v = Dense(dim, self.n_kv * self.head_dim, **kw)
        self.out = Dense(n_heads * self.head_dim, dim, **kw)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor | None = None,
                cache: KVCache | None = None,
                attend_len: int | None = None,
                dropout_seed: int | None = None):
        b, s, _ = x.shape
        drop = self.dropout > 0.0 and dropout_seed is not None
        if drop and cache is not None:
            raise ValueError("dropout is a training-path option; cached "
                             "attention runs deterministic")
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
            out = apply_flash_attention(
                q, k, v, causal=self.causal, dropout_rate=self.dropout,
                dropout_seed=mix_seed(dropout_seed, 0) if drop else 0,
                deterministic=not drop)
        else:
            out = ops.dot_product_attention(
                q, k, v, causal=self.causal, dropout_rate=self.dropout,
                dropout_seed=mix_seed(dropout_seed, 0) if drop else None,
                deterministic=not drop)

        out = self.out(out.reshape(b, s, self.n_heads * self.head_dim))
        if drop:
            out = dropout(out, self.dropout, mix_seed(dropout_seed, 1))
        return out, cache


class MLP(nn.Module):
    """Plain 2-layer MLP: proj(activation(fc(x))) with biases, then
    dropout of `dropout_seed`'s mask when `dropout` > 0 and a seed is
    given (the GPT block's feed-forward)."""

    def __init__(self, dim: int, hidden_dim: int, activation=ops.gelu_tanh, *,
                 dropout: float = 0.0, use_bias: bool = True,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        kw = dict(use_bias=use_bias, dtype=dtype, param_dtype=param_dtype,
                  device=device)
        self.activation = activation
        self.dropout = dropout
        self.fc = Dense(dim, hidden_dim, **kw)
        self.proj = Dense(hidden_dim, dim, **kw)

    def forward(self, x: torch.Tensor,
                dropout_seed: int | None = None) -> torch.Tensor:
        x = self.proj(self.activation(self.fc(x)))
        if self.dropout > 0.0 and dropout_seed is not None:
            x = dropout(x, self.dropout, dropout_seed)
        return x


class GLUFFN(nn.Module):
    """Gated-linear-unit FFN: down(act(gate(x)) * up(x)); silu = SwiGLU."""

    def __init__(self, dim: int, hidden_dim: int, activation=ops.silu, *,
                 use_bias: bool = False, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        kw = dict(use_bias=use_bias, dtype=dtype, param_dtype=param_dtype,
                  device=device)
        self.activation = activation
        self.gate = Dense(dim, hidden_dim, **kw)
        self.up = Dense(dim, hidden_dim, **kw)
        self.down = Dense(hidden_dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(self.activation(self.gate(x)) * self.up(x))


def swiglu_hidden_dim(dim: int, multiplier: int = 4) -> int:
    """The (2/3)·4·dim sizing convention: ((2·dim)·4) // 3."""
    return (2 * dim * multiplier) // 3


def apply_flash_attention(q, k, v, *, causal, scale=None, dropout_rate=0.0,
                          dropout_seed=0, deterministic=True):
    """Flash attention with the framework's dropout policy, shared by every
    `use_flash` model: attention-prob dropout when `dropout_rate > 0` and
    not `deterministic`, inside the kernels on the card and in their plain
    versions on the CPU — the same keep mask of `dropout_seed` either way
    (`kernels.dropout`), where the reference falls back to the dense op
    off the TPU. The reference's mesh branch (sharded flash) needs
    several cards and is not ported."""
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           dropout_rate=0.0 if deterministic else dropout_rate,
                           dropout_seed=dropout_seed)


def maybe_remat(block: nn.Module, remat: bool):
    """`block`, or `block` under `torch.utils.checkpoint` (non-reentrant)
    when `remat` is set and gradients are being recorded: its activations
    are recomputed in the backward instead of kept. The reference's
    `maybe_remat` (`jax.checkpoint` per decoder block, training only).

    A checkpointed block runs twice, so everything random in it must be a
    pure function of its arguments (the port passes a dropout seed in;
    `torch.utils.checkpoint` restores only the global RNG states) and it
    must not change state a second run would read (the MoE routing bias is
    updated after the optimizer step, never inside the forward). Nothing
    in the port's blocks draws from the global generators, so their
    states are not saved and restored around the recomputation."""
    if remat and torch.is_grad_enabled():
        return lambda *args: checkpoint(block, *args, use_reentrant=False,
                                        preserve_rng_state=False)
    return block
