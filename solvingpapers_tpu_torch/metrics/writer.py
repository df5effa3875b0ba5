"""Metrics writers (port of `MetricsWriter`, `ConsoleWriter`,
`JSONLWriter`, `PrometheusTextWriter` and `MultiWriter` of
`solvingpapers_tpu/metrics/writer.py`).

A sink-agnostic interface with wandb-compatible metric names
(train_loss, train_perplexity, lr, grad_norm, tokens, val_loss, ...,
plus step_time_s, tokens_per_sec and mfu). `PrometheusTextWriter.render`
is also the text the live `/metrics` endpoints serve.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
from typing import IO, Mapping

from solvingpapers_tpu_torch.metrics.hist import LogHistogram


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


class PrometheusTextWriter(MetricsWriter):
    """Prometheus node-exporter textfile-collector sink.

    Each `write()` atomically replaces `path` (write to `path + ".tmp"`,
    fsync, `os.replace`) with the CURRENT metric set in text exposition
    format — the contract the textfile collector expects (it must never
    scrape a half-written file, and `os.replace` is atomic on POSIX).
    Metric names are sanitized to the Prometheus grammar
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``): ``serve/ttft_s_p99`` becomes
    ``serve_ttft_s_p99`` and the fractional-percentile key ``p99.9``
    becomes ``p99_9``. The engine `step` rides along as
    ``<prefix>last_step`` so dashboards can detect a stalled exporter.

    No wandb/TensorBoard dependency: point node_exporter's
    ``--collector.textfile.directory`` at the parent directory and the
    serve/train metrics are scrapeable as gauges.

    `metrics.hist.LogHistogram` values render as NATIVE Prometheus
    histograms (``<name>_bucket{le="..."}`` cumulative series + the
    ``_sum``/``_count`` pair) instead of gauges, on this textfile path
    and the live `/metrics` pull path alike (both go through `render`).
    Every bucket edge is emitted even at zero count: PromQL's
    ``sum by (le)`` across replicas needs ALIGNED `le` label sets, and
    the fixed layout is exactly what makes per-replica aggregation
    (`histogram_quantile(0.99, sum by (le) (rate(...)))`) correct.
    """

    accepts_histograms = True

    def __init__(self, path: str, prefix: str = ""):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.path = path
        self.prefix = self.sanitize(prefix) if prefix else ""

    @staticmethod
    def sanitize(name: str) -> str:
        name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
        if name and name[0].isdigit():
            name = "_" + name
        return name

    @staticmethod
    def _fmt(v: float) -> str:
        # the exposition format spells non-finite values +Inf/-Inf/NaN
        if v != v:
            return "NaN"
        if v == float("inf"):
            return "+Inf"
        if v == float("-inf"):
            return "-Inf"
        return repr(float(v))

    @staticmethod
    def _label_str(labels: Mapping[str, object] | None) -> str:
        """``{k="v",...}`` for a constant-label set ("" for none).
        Names are sanitized like metric names; values get the text-
        format escapes (backslash, quote, newline) — a replica id or
        model name with an odd character must not corrupt the scrape."""
        if not labels:
            return ""
        parts = []
        for k, v in labels.items():
            k = PrometheusTextWriter.sanitize(str(k))
            v = (str(v).replace("\\", "\\\\").replace('"', '\\"')
                 .replace("\n", "\\n"))
            parts.append(f'{k}="{v}"')
        return "{" + ",".join(parts) + "}"

    @classmethod
    def render(cls, step: int, metrics: Mapping[str, float],
               prefix: str = "",
               labels: Mapping[str, object] | None = None) -> str:
        """The exposition-format text for one metric set — shared by the
        textfile `write()` path and the live `/metrics` HTTP endpoint
        (serve/api.py), so names and dedupe rules cannot drift.
        `labels` stamps a constant label set (``replica="r0"``) on every
        rendered series; see `render_sets` for the multi-set contract.

        Dedupes by SANITIZED name (last write wins): two keys that
        collapse to one name ("serve/ttft" vs "serve.ttft") would emit
        the same series twice, and the textfile collector rejects the
        ENTIRE file on a duplicate — one colliding key must not blind
        every dashboard. The `last_step` staleness rider yields to a
        user metric of the same name for the same reason. Histogram
        values claim their ``_bucket``/``_sum``/``_count`` derived names
        ahead of any gauge that would collide with them.
        """
        return cls.render_sets([(step, labels, metrics)], prefix=prefix)

    @classmethod
    def render_sets(cls, sets, prefix: str = "") -> str:
        """One exposition from several ``(step, labels, metrics)`` sets
        — the fleet surface (serve/fleet.py): the merged set carries no
        labels while each replica's set carries ``replica="rN"``, and a
        metric NAME appears once with ONE ``# TYPE`` header over all of
        its labeled series (the text format rejects a name whose series
        are split across groups). Dedupe is by (sanitized name, label
        set) with last write winning — the single-set contract extended
        pointwise; a name that is a histogram in ANY set claims the name
        and its ``_bucket``/``_sum``/``_count`` derivations across ALL
        sets (gauge series under those names are dropped, same
        histogram-wins rule as `render`). Each set gets its own
        ``last_step{labels}`` staleness rider unless it shipped one.
        """
        # name -> {label_str -> formatted value | LogHistogram}; plain
        # dicts keep first-seen name order and last-write series values
        gauges: dict[str, dict[str, str]] = {}
        hists: dict[str, dict[str, LogHistogram]] = {}
        for step, labels, metrics in sets:
            ls = cls._label_str(labels)
            rider = f"{prefix}last_step"
            saw_rider = False
            for k, v in metrics.items():
                name = prefix + cls.sanitize(k)
                saw_rider = saw_rider or name == rider
                if isinstance(v, LogHistogram):
                    hists.setdefault(name, {})[ls] = v
                else:
                    gauges.setdefault(name, {})[ls] = cls._fmt(float(v))
            if not saw_rider:
                # setdefault on the SERIES: the rider must never clobber
                # a user gauge another set already placed at this name +
                # label set, and a later user gauge still overwrites it
                gauges.setdefault(rider, {}).setdefault(
                    ls, str(int(step)))
        reserved = {
            f"{h}{suffix}"
            for h in hists for suffix in ("_bucket", "_sum", "_count")
        }
        for name in (reserved | set(hists)) & set(gauges):
            del gauges[name]  # the histogram's series win the collision
        lines = []
        for name, series in gauges.items():
            lines.append(f"# TYPE {name} gauge")
            for ls, value in series.items():
                lines.append(f"{name}{ls} {value}")
        for name, series in hists.items():
            lines.append(f"# TYPE {name} histogram")
            for ls, h in series.items():
                # ONE cumulative pass feeds both the buckets and _count,
                # so the +Inf bucket == _count invariant (which
                # OpenMetrics parsers and histogram_quantile enforce)
                # holds even when a serving thread records into the live
                # histogram mid-render — a concurrently-added
                # observation is wholly absent from this scrape rather
                # than torn across its series
                cums = h.cumulative_counts()
                base = ls[1:-1] + "," if ls else ""
                for le, cum in zip(h.bucket_bounds(), cums):
                    label = ("+Inf" if le == float("inf")
                             else repr(float(le)))
                    lines.append(
                        f'{name}_bucket{{{base}le="{label}"}} {cum}')
                lines.append(f"{name}_sum{ls} {cls._fmt(h.sum)}")
                lines.append(f"{name}_count{ls} {cums[-1] if cums else 0}")
        return "\n".join(lines) + "\n"

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.render(step, metrics, prefix=self.prefix))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)


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
