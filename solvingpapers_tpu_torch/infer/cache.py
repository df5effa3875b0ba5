"""Preallocated KV caches (port of `solvingpapers_tpu/infer/cache.py`,
the `KVCache` half).

Masking contract, as in the reference: slots at or past the current
length hold stale data; attention masks with ``kv_index <=
query_position`` and never relies on zeroed slots.

Unlike the reference's functional updates, `update_kv_cache` writes into
the cache tensors IN PLACE (and returns the same cache): a serving pool
is one preallocated buffer per layer, and copying it per token would
double its traffic.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    """Per-layer key/value cache, laid out (batch, max_len, n_kv_heads, head_dim)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def init(
        cls,
        batch: int,
        max_len: int,
        n_kv_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None,
    ) -> "KVCache":
        shape = (batch, max_len, n_kv_heads, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[1]


def update_kv_cache(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                    index) -> KVCache:
    """Write `k_new`/`v_new` (B, S, n_kv, H) into the cache at sequence
    offset `index` — a python int shared by every row, or a (B,) integer
    tensor with one offset per row (the serving decode step, where every
    slot sits at its own position).

    The start is CLAMPED to ``[0, max_len - S]``, exactly as
    `jax.lax.dynamic_update_slice` clamps it (after counting a negative
    start from the end, as that function also does): a serving slot keeps
    stepping past its EOS or budget inside a decode block, and its
    discarded overshoot may reach past the lane's end. The reference
    writes such a step at the clamped start; on CUDA an unclamped index
    would be a device-side assert that kills the process.
    """
    s, max_len = k_new.shape[1], cache.max_len
    if s > max_len:
        raise ValueError(f"write of {s} positions exceeds cache max_len {max_len}")
    hi = max_len - s
    if isinstance(index, int):
        if index < 0:
            index += max_len
        start = min(max(index, 0), hi)
        cache.k[:, start:start + s] = k_new.to(cache.k.dtype)
        cache.v[:, start:start + s] = v_new.to(cache.v.dtype)
        return cache
    start = index.to(torch.long)
    start = torch.where(start < 0, start + max_len, start).clamp(0, hi)  # (B,)
    rows = torch.arange(k_new.shape[0], device=start.device)[:, None]
    cols = start[:, None] + torch.arange(s, device=start.device)[None, :]
    cache.k[rows, cols] = k_new.to(cache.k.dtype)
    cache.v[rows, cols] = v_new.to(cache.v.dtype)
    return cache
