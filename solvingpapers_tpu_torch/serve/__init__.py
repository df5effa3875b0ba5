"""Continuous-batching serving over a lane pool or a paged pool, with a
radix prefix cache, per-request sampling, grammar-constrained JSON
decoding (JsonStepper) and an OpenAI-compatible HTTP front door
(ApiServer) (port of `solvingpapers_tpu/serve`)."""

from solvingpapers_tpu_torch.serve.api import ApiServer, EngineLoop
from solvingpapers_tpu_torch.serve.engine import ServeConfig, ServeEngine
from solvingpapers_tpu_torch.serve.grammar import JsonStepper
from solvingpapers_tpu_torch.serve.kv_pool import (
    TRASH_PAGE,
    KVSlotPool,
    PagedKVPool,
    extract_lane,
    gather_lane,
    gather_lanes,
    scatter_lane_pages,
    scatter_written_pages,
    store_lane,
)
from solvingpapers_tpu_torch.serve.metrics import ServeMetrics
from solvingpapers_tpu_torch.serve.prefix_cache import PrefixCache
from solvingpapers_tpu_torch.serve.sampling import (
    PackedSampling,
    SamplingParams,
    encode_params,
    fused_sample,
)
from solvingpapers_tpu_torch.serve.scheduler import FIFOScheduler, Request

__all__ = [
    "TRASH_PAGE",
    "ApiServer",
    "EngineLoop",
    "FIFOScheduler",
    "JsonStepper",
    "KVSlotPool",
    "PackedSampling",
    "PagedKVPool",
    "PrefixCache",
    "Request",
    "SamplingParams",
    "ServeConfig",
    "ServeEngine",
    "ServeMetrics",
    "encode_params",
    "extract_lane",
    "fused_sample",
    "gather_lane",
    "gather_lanes",
    "scatter_lane_pages",
    "scatter_written_pages",
    "store_lane",
]
