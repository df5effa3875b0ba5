"""Training metrics (port of `solvingpapers_tpu/metrics`: the writer sinks
and MFU accounting the training loop uses)."""

from solvingpapers_tpu_torch.metrics.mfu import (
    active_param_count,
    chip_peak_flops,
    mfu,
    transformer_flops_per_token,
)
from solvingpapers_tpu_torch.metrics.writer import (
    ConsoleWriter,
    JSONLWriter,
    MetricsWriter,
    MultiWriter,
)

__all__ = [
    "ConsoleWriter",
    "JSONLWriter",
    "MetricsWriter",
    "MultiWriter",
    "active_param_count",
    "chip_peak_flops",
    "mfu",
    "transformer_flops_per_token",
]
