"""Attention core (port of `solvingpapers_tpu/ops/attention.py`): the
plain PyTorch path and the numerics reference for the flash kernel.

Layout: (batch, seq, num_heads, head_dim) — "BSNH", as in the JAX
package, so the parity tests compare like with like. Scores and softmax
are float32; the probabilities are cast to ``v.dtype`` before the PV
product, exactly where the reference casts them.
"""

from __future__ import annotations

import torch

BIG_NEG = -(2.0**30)  # mask fill; finite to keep softmax NaN-free in bf16/f32


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, n_kv, H) -> (B, S, n_kv * n_rep, H), repeating each kv head."""
    if n_rep == 1:
        return x
    b, s, n_kv, h = x.shape
    x = x[:, :, :, None, :].expand(b, s, n_kv, n_rep, h)
    return x.reshape(b, s, n_kv * n_rep, h)


def causal_mask(q_len: int, kv_len: int,
                device: str | torch.device | None = None) -> torch.Tensor:
    """(q_len, kv_len) bool lower-triangular mask aligned to the END of the
    kv axis: query i attends to kv positions [0, kv_len - q_len + i]."""
    q_idx = torch.arange(q_len, device=device)[:, None]
    kv_idx = torch.arange(kv_len, device=device)[None, :]
    return kv_idx <= q_idx + (kv_len - q_len)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Scaled dot-product attention over BSNH tensors.

    q: (B, Sq, N, H); k, v: (B, Skv, Nkv, H) with N % Nkv == 0 (GQA/MQA by
    repeating kv heads). `mask` is broadcastable to (B, N, Sq, Skv),
    True = attend. Inference only: the reference's attention dropout is
    not part of this slice.
    """
    n, n_kv = q.shape[-2], k.shape[-2]
    if n != n_kv:
        if n % n_kv:
            raise ValueError(f"num q heads {n} not a multiple of kv heads {n_kv}")
        k = repeat_kv(k, n // n_kv)
        v = repeat_kv(v, n // n_kv)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # (B, N, Sq, Skv); the product keeps the input dtype, as jnp.einsum does
    scores = torch.einsum("bqnh,bknh->bnqk", q, k).float() * scale
    if causal:
        cmask = causal_mask(q.shape[1], k.shape[1], device=q.device)
        mask = cmask if mask is None else mask & cmask
    if mask is not None:
        scores = scores.masked_fill(~mask, BIG_NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs, v)
