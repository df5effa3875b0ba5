"""Continuous-batching serving over a lane pool or a paged pool, with a
radix prefix cache, per-request sampling, grammar-constrained JSON
decoding (JsonStepper), an OpenAI-compatible HTTP front door
(ApiServer), a fleet router over engine replicas (FleetRouter) and a
journal replay harness (ReplayHarness) (port of
`solvingpapers_tpu/serve`)."""

from solvingpapers_tpu_torch.serve.api import ApiServer, EngineLoop
from solvingpapers_tpu_torch.serve.engine import ServeConfig, ServeEngine
from solvingpapers_tpu_torch.serve.fleet import FleetRouter, MigrationReport
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
from solvingpapers_tpu_torch.serve.replay import ReplayHarness
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
    "FleetRouter",
    "JsonStepper",
    "KVSlotPool",
    "MigrationReport",
    "PackedSampling",
    "PagedKVPool",
    "PrefixCache",
    "ReplayHarness",
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
