"""KV cache and one-shot generation (port of `solvingpapers_tpu/infer`)."""

from solvingpapers_tpu_torch.infer.cache import KVCache, update_kv_cache
from solvingpapers_tpu_torch.infer.decode import generate

__all__ = ["KVCache", "generate", "update_kv_cache"]
