"""Activation primitives (port of `solvingpapers_tpu/ops/activations.py`:
the SiLU that SwiGLU uses)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
