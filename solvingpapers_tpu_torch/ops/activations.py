"""Activation primitives (port of `solvingpapers_tpu/ops/activations.py`:
the SiLU that SwiGLU uses and the swish of DeepSeek-V3's experts)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def swish(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Swish with temperature beta, ``x * sigmoid(beta * x)``; beta = 1
    is SiLU, computed the reference's way (not by `F.silu`)."""
    return x * torch.sigmoid(beta * x)
