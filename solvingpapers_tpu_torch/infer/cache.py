"""Preallocated caches (port of `solvingpapers_tpu/infer/cache.py`: the
`KVCache` of the GQA families and the `LatentCache` of MLA; the
context-parallel caches need a mesh, ROADMAP A7).

Masking contract, as in the reference: slots at or past the current
length hold stale data; attention masks with ``kv_index <=
query_position`` and never relies on zeroed slots.

Unlike the reference's functional updates, `update_kv_cache` and
`update_latent_cache` write into the cache tensors IN PLACE (and return
the same cache): a serving pool is one preallocated buffer per layer,
and copying it per token would double its traffic.
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


@dataclasses.dataclass
class LatentCache:
    """MLA's compressed cache: one (batch, max_len, latent_dim) tensor per
    layer, shared by every head — the latents, not decompressed k/v
    (with decoupled RoPE a row is ``cat(latent, k_rope)``)."""

    c: torch.Tensor

    @classmethod
    def init(
        cls,
        batch: int,
        max_len: int,
        latent_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None,
    ) -> "LatentCache":
        return cls(c=torch.zeros((batch, max_len, latent_dim), dtype=dtype,
                                 device=device))

    @property
    def max_len(self) -> int:
        return self.c.shape[1]


def _write_rows(tensors, news, index, max_len: int) -> None:
    """Write each of `news` (B, S, ...) into its tensor of `tensors` (B,
    max_len, ...) at sequence offset `index` — a python int shared by
    every row, or a (B,) integer tensor with one offset per row (the
    serving decode step, where every slot sits at its own position).

    The start is CLAMPED to ``[0, max_len - S]``, exactly as
    `jax.lax.dynamic_update_slice` clamps it (after counting a negative
    start from the end, as that function also does): a serving slot keeps
    stepping past its EOS or budget inside a decode block, and its
    discarded overshoot may reach past the lane's end. The reference
    writes such a step at the clamped start; on CUDA an unclamped index
    would be a device-side assert that kills the process.

    A write of S > 1 positions at per-row offsets (the speculative
    decode's ``1 + k`` chunk) clamps each COLUMN instead: a chunk that
    starts inside the lane keeps every position at its own slot, and
    positions past the lane's end collapse onto its last slot. A clamped
    start would shift the whole chunk left onto the committed KV just
    before it (the reference pads its lane views with ``k + 1`` slack
    slots for this; clamping the columns needs neither slack nor a
    copy). The last slot only ever holds KV that no real token attends:
    a stream's tokens fill positions [0, max_len), and position
    ``max_len - 1``'s KV serves only the query that would produce a
    token past the lane.
    """
    s = news[0].shape[1]
    if s > max_len:
        raise ValueError(f"write of {s} positions exceeds cache max_len {max_len}")
    hi = max_len - s
    if isinstance(index, int):
        if index < 0:
            index += max_len
        start = min(max(index, 0), hi)
        for t, new in zip(tensors, news):
            t[:, start:start + s] = new.to(t.dtype)
        return
    start = index.to(torch.long)
    start = torch.where(start < 0, start + max_len, start)  # (B,)
    rows = torch.arange(news[0].shape[0], device=start.device)[:, None]
    cols = torch.clamp(start.clamp(0, max_len - 1)[:, None]
                       + torch.arange(s, device=start.device)[None, :],
                       max=max_len - 1)
    for t, new in zip(tensors, news):
        t[rows, cols] = new.to(t.dtype)


def update_kv_cache(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                    index) -> KVCache:
    """Write `k_new`/`v_new` (B, S, n_kv, H) into the cache at sequence
    offset `index` (see `_write_rows`: a shared int or per-row offsets,
    clamped like `dynamic_update_slice`)."""
    _write_rows((cache.k, cache.v), (k_new, v_new), index, cache.max_len)
    return cache


def update_latent_cache(cache: LatentCache, c_new: torch.Tensor,
                        index) -> LatentCache:
    """Write latents (B, S, L) into the cache at sequence offset `index`
    (see `_write_rows`). The reference writes every row at
    ``positions[0, 0]``; the port's serving decode passes one offset per
    row, because the engine's slots sit at different positions."""
    _write_rows((cache.c,), (c_new,), index, cache.max_len)
    return cache
