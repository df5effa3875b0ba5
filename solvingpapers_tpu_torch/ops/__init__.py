"""Plain PyTorch ops (port of `solvingpapers_tpu/ops`, the subset the
serving and training slices run). `ops.moe` (DeepSeek-V3's routing and
dispatch) is imported as a submodule."""

from solvingpapers_tpu_torch.ops.activations import gelu_tanh, silu, swish
from solvingpapers_tpu_torch.ops.attention import (
    BIG_NEG,
    causal_mask,
    dot_product_attention,
    repeat_kv,
)
from solvingpapers_tpu_torch.ops import moe
from solvingpapers_tpu_torch.ops.losses import cross_entropy
from solvingpapers_tpu_torch.ops.norms import layer_norm, rms_norm
from solvingpapers_tpu_torch.ops.rope import (
    apply_rope,
    precompute_rope,
    sinusoidal_position_encoding,
)
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
    "cross_entropy",
    "dot_product_attention",
    "gelu_tanh",
    "layer_norm",
    "min_p_mask",
    "moe",
    "precompute_rope",
    "repeat_kv",
    "rms_norm",
    "sample_greedy",
    "silu",
    "sinusoidal_position_encoding",
    "swish",
    "top_k_mask",
    "top_p_mask",
]
