"""KV and latent caches and one-shot generation (port of `solvingpapers_tpu/infer`)."""

from solvingpapers_tpu_torch.infer.cache import (
    KVCache,
    LatentCache,
    update_kv_cache,
    update_latent_cache,
)
from solvingpapers_tpu_torch.infer.decode import generate

__all__ = ["KVCache", "LatentCache", "generate", "update_kv_cache",
           "update_latent_cache"]
