"""Device selection for the port's entry points.

The port is written for a CUDA card. An entry point (`ServeEngine`,
`generate`, model construction) runs on ``cuda`` unless its caller names
another device — the CPU tests pass ``device="cpu"``. With no device
named and no CUDA available it raises instead of carrying on quietly on
the CPU, so a run that meant to measure the card can never measure the
host by accident.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`device` as a `torch.device`; None means ``cuda`` and raises
    RuntimeError when no CUDA device is available. A CUDA device comes
    back with its index, so it compares equal to a tensor's device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available and no device was given: the "
                "port runs on the card by default — pass device='cpu' to "
                "run on the host explicitly"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
