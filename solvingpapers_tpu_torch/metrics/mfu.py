"""MFU accounting (port of `solvingpapers_tpu/metrics/mfu.py`).

flops-per-token uses the PaLM-appendix convention: 6N for the fwd+bwd
matmul flops of N active parameters plus the 12·L·D·S attention-score
term. The peak is the card's dense bf16 tensor-core rate, read from
`torch.cuda.get_device_name`; an unknown device (the CPU included) has
no peak, and then the peak and MFU are NaN rather than a mis-scaled
number.
"""

from __future__ import annotations

import math
import warnings

import torch

# dense bf16 peak FLOP/s by card name (NVIDIA's data sheets); the first
# key found in the lower-cased name wins, so "h100 pcie" precedes "h100"
_PEAK_FLOPS = {
    "h100 pcie": 756e12,
    "h100": 989e12,  # SXM
}

_warned_kinds: set[str] = set()


def chip_peak_flops(device: str | torch.device | None = None) -> float:
    """bf16 peak FLOP/s of `device` (default: the current CUDA card), or
    NaN when the device is not a known card."""
    device = torch.device("cuda") if device is None else torch.device(device)
    kind = ""
    if device.type == "cuda" and torch.cuda.is_available():
        kind = torch.cuda.get_device_name(device).lower()
    for key, val in _PEAK_FLOPS.items():
        if key in kind:
            return val
    if kind not in _warned_kinds:
        _warned_kinds.add(kind)
        warnings.warn(
            f"chip_peak_flops: no peak known for device {str(device)!r} "
            f"({kind or 'not a CUDA card'}); returning NaN — MFU is omitted "
            "rather than mis-scaled (extend metrics.mfu._PEAK_FLOPS)",
            stacklevel=2,
        )
    return float("nan")


def transformer_flops_per_token(
    n_active_params: int, n_layers: int, dim: int, seq_len: int,
    training: bool = True,
) -> float:
    """6N + 12·L·D·S per trained token (2N + 4·L·D·S for inference)."""
    mult = 6 if training else 2
    attn = (12 if training else 4) * n_layers * dim * seq_len
    return mult * n_active_params + attn


def mfu(tokens_per_sec: float, flops_per_token: float, n_chips: int = 1,
        device=None) -> float:
    """Model FLOP utilization, or NaN when it cannot be computed honestly
    (unknown peak, non-finite inputs)."""
    peak = chip_peak_flops(device) * n_chips
    achieved = tokens_per_sec * flops_per_token
    if not (math.isfinite(peak) and peak > 0 and math.isfinite(achieved)):
        return float("nan")
    return achieved / peak


def active_param_count(model_or_params, top_experts: int | None = None,
                       n_experts: int | None = None) -> int:
    """Parameters touched per token: every parameter of an `nn.Module`,
    or every tensor of a state dict (MoE routing-bias buffers skipped),
    except that of the routed expert weights (``...moe.w1/w2/w3``) only
    top_experts / n_experts count as active — the N of the 6N FLOPs
    model for a mixture of experts."""
    if isinstance(model_or_params, torch.nn.Module):
        named = model_or_params.named_parameters()
    else:
        named = ((k, v) for k, v in model_or_params.items()
                 if not k.endswith("routing_bias"))
    total = routed = 0
    for name, t in named:
        total += t.numel()
        if name.endswith((".moe.w1", ".moe.w2", ".moe.w3")):
            routed += t.numel()
    if top_experts and n_experts and routed:
        total -= routed - routed * top_experts // n_experts
    return total
