"""Hand-written Hopper kernels (port of `solvingpapers_tpu/kernels`).

Each kernel is a CUDA C++ source under `csrc/`, built with `nvcc` at
first use (`build.py`) and bound with `ctypes`, with its plain PyTorch
version and a launch counter beside its wrapper.
"""

from solvingpapers_tpu_torch.kernels.dropout import (
    dropout,
    dropout_apply,
    dropout_apply_reference,
    dropout_keep_reference,
    dropout_mask,
)
from solvingpapers_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_reference,
    flash_bwd_dkv,
    flash_bwd_dq,
)


def reset_counts() -> None:
    """Zero every kernel's launch count and plain-version call count."""
    flash_attention_fwd.launches = 0
    flash_bwd_dq.launches = 0
    flash_bwd_dkv.launches = 0
    dropout_mask.launches = 0
    dropout_apply.launches = 0
    flash_attention_reference.calls = 0
    flash_attention_bwd_reference.calls = 0
    dropout_keep_reference.calls = 0
    dropout_apply_reference.calls = 0


__all__ = [
    "dropout",
    "dropout_apply",
    "dropout_apply_reference",
    "dropout_keep_reference",
    "dropout_mask",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "flash_attention_reference",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "reset_counts",
]
