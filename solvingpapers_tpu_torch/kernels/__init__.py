"""Hand-written Hopper kernels (port of `solvingpapers_tpu/kernels`).

Each kernel is a CUDA C++ source under `csrc/`, built with `nvcc` at
first use (`build.py`) and bound with `ctypes`, with its plain PyTorch
version and a launch counter beside its wrapper.
"""

from solvingpapers_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_reference,
)


def reset_counts() -> None:
    """Zero every kernel's launch count and plain-version call count."""
    flash_attention_fwd.launches = 0
    flash_attention_reference.calls = 0


__all__ = [
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_reference",
    "reset_counts",
]
