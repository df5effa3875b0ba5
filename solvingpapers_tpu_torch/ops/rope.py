"""Rotary position embeddings (port of `solvingpapers_tpu/ops/rope.py`,
the split cos/sin form).

Pairing convention: features rotate in INTERLEAVED (even, odd) pairs
``(x[..., 0::2], x[..., 1::2])`` — the complex-reshape convention of the
reference's llama3 notebook — not the half-split ``rotate_half`` most
PyTorch code uses. The rotation runs in float32 and the result is cast
back to the input dtype.
"""

from __future__ import annotations

import torch


def precompute_rope(
    head_dim: int,
    max_seq_len: int,
    theta: float = 10000.0,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (cos, sin), each of shape (max_seq_len, head_dim // 2)."""
    if head_dim % 2:
        raise ValueError(f"head_dim must be even, got {head_dim}")
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    freqs = 1.0 / (theta ** (exps / head_dim))
    pos = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(pos, freqs)
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rotate feature pairs of `x` by position-dependent angles.

    x:    (..., seq, num_heads, head_dim) — seq is axis -3.
    cos/sin: (max_seq_len, head_dim // 2) tables from `precompute_rope`.
    positions: optional int tensor (..., seq) of absolute positions;
        defaults to arange(seq). Positions past the table's end read its
        last row: a CUDA gather out of range is a device-side assert that
        kills the process, and the only caller that reaches past the end
        is a serving slot's discarded overshoot (see serve/engine.py).
    """
    seq = x.shape[-3]
    if positions is None:
        cos_p, sin_p = cos[:seq], sin[:seq]
    else:
        idx = positions.clamp(0, cos.shape[0] - 1)
        cos_p, sin_p = cos[idx], sin[idx]
    # broadcast over the heads axis: (..., seq, 1, head_dim // 2)
    cos_p = cos_p.unsqueeze(-2)
    sin_p = sin_p.unsqueeze(-2)
    x32 = x.float()
    x_even = x32[..., 0::2]
    x_odd = x32[..., 1::2]
    out_even = x_even * cos_p - x_odd * sin_p
    out_odd = x_even * sin_p + x_odd * cos_p
    # re-interleave: stack pairs on a trailing axis, then flatten
    out = torch.stack([out_even, out_odd], dim=-1).reshape(x.shape)
    return out.to(x.dtype)
