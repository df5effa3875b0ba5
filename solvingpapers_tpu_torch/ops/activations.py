"""Activation primitives (port of `solvingpapers_tpu/ops/activations.py`:
the SiLU that SwiGLU uses, the swish of DeepSeek-V3's experts and GPT's
tanh-approximation GELU)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def swish(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Swish with temperature beta, ``x * sigmoid(beta * x)``; beta = 1
    is SiLU, computed the reference's way (not by `F.silu`)."""
    return x * torch.sigmoid(beta * x)


_GELU_C = math.sqrt(2.0 / math.pi)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximation GELU in the reference's form,
    ``0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))``."""
    return 0.5 * x * (1.0 + torch.tanh(_GELU_C * (x + 0.044715 * x.pow(3))))
