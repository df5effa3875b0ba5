"""Metrics (port of `solvingpapers_tpu/metrics`: the writer sinks and MFU
accounting the training loop uses, the text sample artifact, and the
log-bucketed latency histogram the serving metrics record into)."""

from solvingpapers_tpu_torch.metrics.hist import LogHistogram
from solvingpapers_tpu_torch.metrics.mfu import (
    active_param_count,
    chip_peak_flops,
    mfu,
    transformer_flops_per_token,
)
from solvingpapers_tpu_torch.metrics.viz import save_text_sample
from solvingpapers_tpu_torch.metrics.writer import (
    ConsoleWriter,
    JSONLWriter,
    MetricsWriter,
    MultiWriter,
)

__all__ = [
    "ConsoleWriter",
    "JSONLWriter",
    "LogHistogram",
    "MetricsWriter",
    "MultiWriter",
    "active_param_count",
    "chip_peak_flops",
    "mfu",
    "save_text_sample",
    "transformer_flops_per_token",
]
