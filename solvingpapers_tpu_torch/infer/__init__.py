"""KV and latent caches, one-shot generation and MTP speculative decoding
(port of `solvingpapers_tpu/infer`)."""

from solvingpapers_tpu_torch.infer.cache import (
    KVCache,
    LatentCache,
    update_kv_cache,
    update_latent_cache,
)
from solvingpapers_tpu_torch.infer.decode import generate
from solvingpapers_tpu_torch.infer.speculative import generate_speculative

__all__ = ["KVCache", "LatentCache", "generate", "generate_speculative",
           "update_kv_cache", "update_latent_cache"]
