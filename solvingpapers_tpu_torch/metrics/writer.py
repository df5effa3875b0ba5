"""Metrics writers (port of `MetricsWriter`, `ConsoleWriter`,
`JSONLWriter` and `MultiWriter` of `solvingpapers_tpu/metrics/writer.py`).

A sink-agnostic interface with wandb-compatible metric names
(train_loss, train_perplexity, lr, grad_norm, tokens, val_loss, ...,
plus step_time_s, tokens_per_sec and mfu).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Mapping


class MetricsWriter:
    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class ConsoleWriter(MetricsWriter):
    def __init__(self, stream: IO | None = None, every: int = 1):
        # stream resolved at write time so runtime redirection works
        self.stream = stream
        self.every = max(every, 1)

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        if step % self.every:
            return
        parts = " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in metrics.items()
        )
        print(f"step {step}: {parts}", file=self.stream or sys.stdout, flush=True)


class JSONLWriter(MetricsWriter):
    """Append-mode JSONL sink; usable as a context manager. `close()`
    flushes and fsyncs, so a crash right after cannot lose the tail of
    the log."""

    def __init__(self, path: str):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.f = open(path, "a", buffering=1)

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        rec = {"step": step, "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self.f.write(json.dumps(rec) + "\n")

    def __enter__(self) -> "JSONLWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:
        if self.f.closed:
            return
        self.f.flush()
        os.fsync(self.f.fileno())
        self.f.close()


class MultiWriter(MetricsWriter):
    def __init__(self, *writers: MetricsWriter):
        self.writers = writers

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        for w in self.writers:
            w.write(step, metrics)

    def close(self) -> None:
        """Close every writer even when one raises; the first error
        propagates after the sweep."""
        errs = []
        for w in self.writers:
            try:
                w.close()
            except Exception as e:  # noqa: BLE001 — the sweep must finish
                errs.append(e)
        if errs:
            raise errs[0]
