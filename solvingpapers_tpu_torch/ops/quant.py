"""Symmetric int8 quantization with per-block absmax scales (port of
`solvingpapers_tpu/ops/quant.py`): the KV-cache compression primitive
behind `ServeConfig.kv_quant` (serve/kv_pool.py).

Layout contract (the cache layout of `infer/cache.py`): a cache tensor is
``(batch, time, n_heads, head_dim)`` (`KVCache` k/v) or ``(batch, time,
channels)`` (`LatentCache` c). Quantization blocks tile the TIME axis with
a fixed `block` length:

* 4-D tensors: one f32 scale per ``(batch, time-block, head)``. The paged
  pool passes ``block = page_size``, so each physical page carries one
  scale row per head; the lane pool tiles lanes with
  `ServeConfig.kv_quant_block`.
* 3-D tensors (MLA latents): one f32 scale per ``(batch, time-block)``.
  Per-channel scales would cost 4 bytes per `block` int8 entries (25 % at
  block 16, past the pool's 0.6x byte budget), so latents take the
  coarser per-block scalar and the bench's agreement rate measures the
  cost.

Scale semantics: ``scale = absmax / 127`` over the block, so the block's
max-magnitude entry maps to exactly +-127 and every entry obeys ``|x - q *
scale| <= scale / 2``. An all-zero block has scale 0 and round-trips
exactly (q = 0 -> 0). Re-quantizing an already dequantized block IN F32
with an unchanged absmax reproduces the same int8 codes. That fixed point
is what keeps committed entries stable under the serving programs'
windowed stores (serve/kv_pool.py): untouched blocks are never rewritten,
and within a block a step did write, positions outside the written window
re-encode from their own f32-dequantized codes, not from the
compute-dtype lane view (a bf16 cast shifts the block absmax and walks
committed codes step to step).

All math runs in f32 whatever the cache dtype. The arithmetic is the
reference's, operation for operation: ``absmax / 127`` then ``x /
scale`` as true divisions (a CUDA tensor divided by a Python scalar is
multiplied by its reciprocal, one ulp off in places, so the divisor is a
tensor on the operand's device), `torch.round` (half to even, as
`jnp.round`), clipped to +-127 (the -128 code is never used). So the
codes and scales are byte-equal to the reference's on the same f32 input.
"""

from __future__ import annotations

import dataclasses

import torch


def scale_shape(shape: tuple, block: int) -> tuple:
    """Scale-tensor shape for a cache tensor of `shape` tiled by `block`
    along the time axis: ``(B, T // block, H)`` for 4-D tensors, ``(B, T
    // block)`` for 3-D ones."""
    shape = tuple(shape)
    if len(shape) not in (3, 4):
        raise ValueError(f"cache leaves are (B, T, H, D) or (B, T, C); got {shape}")
    b, t = shape[0], shape[1]
    if t % block:
        raise ValueError(
            f"time length {t} is not a multiple of the quant block {block}")
    if len(shape) == 4:
        return (b, t // block, shape[2])
    return (b, t // block)


def _reduce_dims(ndim: int) -> tuple:
    # blocked view (B, nb, block, ...): the block axis and every trailing
    # axis except the head axis of 4-D tensors
    if ndim == 4:
        return (2, 4)
    if ndim == 3:
        return (2, 3)
    raise ValueError(f"cache leaves are 3-D or 4-D; got ndim {ndim}")


def quantize(x: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of a cache tensor: ``(q int8, scale
    f32)``, `q` shaped like `x` and `scale` shaped ``scale_shape(x.shape,
    block)``. ``q = round(x / scale)`` clipped to [-127, 127];
    zero-absmax blocks quantize to q = 0, scale = 0."""
    sshape = scale_shape(x.shape, block)  # validates the shape and block
    b, t = x.shape[0], x.shape[1]
    xs = x.to(torch.float32).reshape((b, t // block, block) + tuple(x.shape[2:]))
    absmax = torch.amax(xs.abs(), dim=_reduce_dims(x.ndim), keepdim=True)
    sfull = absmax / absmax.new_tensor(127.0)
    live = sfull > 0.0
    q = torch.where(live, xs / torch.where(live, sfull, 1.0), 0.0)
    q = torch.clamp(torch.round(q), -127.0, 127.0).to(torch.int8)
    return q.reshape(x.shape), sfull.reshape(sshape)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of `quantize`: ``q * scale`` broadcast per block, cast to
    `dtype` (the cache's compute dtype). The block length comes from the
    shapes: the scale tensor is the layout's metadata."""
    b, t = q.shape[0], q.shape[1]
    nb = scale.shape[1]
    if nb < 1 or t % nb:
        raise ValueError(f"scale blocks {nb} do not tile the time axis {t}")
    block = t // nb
    qs = q.to(torch.float32).reshape((b, nb, block) + tuple(q.shape[2:]))
    if q.ndim == 4:
        sfull = scale[:, :, None, :, None]
    elif q.ndim == 3:
        sfull = scale[:, :, None, None]
    else:
        raise ValueError(f"cache leaves are 3-D or 4-D; got ndim {q.ndim}")
    return (qs * sfull).reshape(q.shape).to(dtype)


def _fields(cache) -> dict:
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)}


def quantize_tree(caches: list, block: int) -> tuple[list, list]:
    """Quantize every tensor of a per-layer cache list: ``(q caches,
    scale caches)``, both lists of the input's cache dataclasses (a
    `KVCache` of scales is only a container)."""
    qs, ss = [], []
    for c in caches:
        pairs = {name: quantize(t, block) for name, t in _fields(c).items()}
        qs.append(dataclasses.replace(c, **{n: p[0] for n, p in pairs.items()}))
        ss.append(dataclasses.replace(c, **{n: p[1] for n, p in pairs.items()}))
    return qs, ss


def dequantize_tree(q_caches: list, scale_caches: list,
                    dtype: torch.dtype = torch.float32) -> list:
    """Tensorwise `dequantize` over parallel payload and scale lists."""
    out = []
    for qc, sc in zip(q_caches, scale_caches):
        s = _fields(sc)
        out.append(dataclasses.replace(qc, **{
            name: dequantize(t, s[name], dtype) for name, t in _fields(qc).items()}))
    return out


__all__ = ["dequantize", "dequantize_tree", "quantize", "quantize_tree",
           "scale_shape"]
