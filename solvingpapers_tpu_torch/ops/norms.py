"""Normalization primitives (port of `solvingpapers_tpu/ops/norms.py`).

Statistics are computed in float32 whatever the input dtype, and the
result is cast back to the input dtype, so the op can sit inside a bf16
matmul chain without precision loss in the reduction.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
             eps: float = 1e-6) -> torch.Tensor:
    """Root-mean-square normalization: x / sqrt(mean(x^2) + eps) * weight."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)
