"""Plain PyTorch ops (port of `solvingpapers_tpu/ops`, the subset the
serving slice runs)."""

from solvingpapers_tpu_torch.ops.activations import silu
from solvingpapers_tpu_torch.ops.attention import (
    BIG_NEG,
    causal_mask,
    dot_product_attention,
    repeat_kv,
)
from solvingpapers_tpu_torch.ops.norms import rms_norm
from solvingpapers_tpu_torch.ops.rope import apply_rope, precompute_rope
from solvingpapers_tpu_torch.ops.sampling import (
    min_p_mask,
    sample_greedy,
    top_k_mask,
    top_p_mask,
)

__all__ = [
    "BIG_NEG",
    "apply_rope",
    "causal_mask",
    "dot_product_attention",
    "min_p_mask",
    "precompute_rope",
    "repeat_kv",
    "rms_norm",
    "sample_greedy",
    "silu",
    "top_k_mask",
    "top_p_mask",
]
