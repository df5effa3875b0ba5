"""Continuous-batching serving over a lane pool (port of
`solvingpapers_tpu/serve`, the lane-pool path)."""

from solvingpapers_tpu_torch.serve.engine import ServeConfig, ServeEngine
from solvingpapers_tpu_torch.serve.kv_pool import (
    KVSlotPool,
    extract_lane,
    store_lane,
)
from solvingpapers_tpu_torch.serve.metrics import ServeMetrics
from solvingpapers_tpu_torch.serve.sampling import (
    PackedSampling,
    SamplingParams,
    encode_params,
    fused_sample,
)
from solvingpapers_tpu_torch.serve.scheduler import FIFOScheduler, Request

__all__ = [
    "FIFOScheduler",
    "KVSlotPool",
    "PackedSampling",
    "Request",
    "SamplingParams",
    "ServeConfig",
    "ServeEngine",
    "ServeMetrics",
    "encode_params",
    "extract_lane",
    "fused_sample",
    "store_lane",
]
