"""Rolling in-process time series (port of
`solvingpapers_tpu/metrics/timeseries.py`): a fixed-budget ring of
periodic metric snapshots — the "what was the engine doing just before
X" record.

`ServeMetrics.snapshot()` answers "what are the totals NOW";
`FlightRecorder` answers "what did THIS request/step do". Neither
answers the incident-review question "what did throughput, queue depth
and tail latency look like over the two minutes BEFORE the quarantine"
— by the time anyone looks, the counters have moved on and the ring
has rolled. `TimeSeriesStore` keeps that window: every `interval_s`
the owner feeds it the current gauge readings plus the raw cumulative
counters, and the store keeps per-window DELTAS of the cumulative ones
(tokens/sec per window, finishes per window, histogram count/sum
increments) in bounded deques — O(capacity x n_series) memory, no
timer thread (the engine samples opportunistically from `step()`, so
an idle engine simply stops producing windows rather than burning a
wakeup).

Three consumers, all read-only:

* ``/timeseriesz`` (serve/api.py and metrics/http.py): the `doc()` JSON
  — timestamps plus one list per series — for dashboards-without-a-
  dashboard (curl + jq).
* ``/statusz``: `sparklines()` renders each series as a fixed-width
  Unicode sparkline so a human tailing statusz sees shape, not just
  the latest number.
* `AnomalyMonitor` dumps: every anomaly record carries the preceding
  N-window retrospective, so a quarantine/drain artifact explains
  itself without a co-located Prometheus.

Clock is injectable (`serve.metrics.now` by default) so tests drive
sampling deterministically and fleet replicas share one time base.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable

from solvingpapers_tpu_torch.serve.metrics import now

__all__ = ["TimeSeriesStore", "sparkline"]

_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values, width: int | None = None) -> str:
    """Render `values` (Nones skipped for scaling, shown as spaces) as
    a Unicode block sparkline. `width` caps the output by keeping the
    NEWEST `width` points — the rolling-window convention: the right
    edge is "now"."""
    vals = list(values)
    if width is not None and width > 0 and len(vals) > width:
        vals = vals[-width:]
    finite = [v for v in vals if v is not None]
    if not finite:
        return ""
    lo, hi = min(finite), max(finite)
    span = hi - lo
    out = []
    for v in vals:
        if v is None:
            out.append(" ")
        elif span <= 0:
            out.append(_BLOCKS[0])
        else:
            idx = int((v - lo) / span * (len(_BLOCKS) - 1))
            out.append(_BLOCKS[min(max(idx, 0), len(_BLOCKS) - 1)])
    return "".join(out)


class TimeSeriesStore:
    """Bounded ring of periodic metric samples with counter deltas.

    `sample(gauges, cumulative)` appends one window: gauge values are
    stored as-is; cumulative values are stored as the DELTA against
    the previous raw reading (the first window's delta is the raw
    value — everything before the store existed counts as window 0;
    a counter that goes backwards, i.e. the owner was swapped out,
    clamps to 0 rather than storing a negative rate). A series that
    appears mid-run back-fills None for the windows it missed; a
    series absent from a sample records None for that window — doc()
    rows always align with the timestamp ring.

    Thread-safe: the owner samples from its step thread while status
    request threads read `doc()`/`sparklines()`.
    """

    def __init__(self, capacity: int = 120, interval_s: float = 1.0,
                 clock: Callable[[], float] = now):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if interval_s <= 0:
            raise ValueError(
                f"interval_s must be > 0, got {interval_s}")
        self.capacity = capacity
        self.interval_s = interval_s
        self.clock = clock
        self._lock = threading.Lock()
        self._t: deque[float] = deque(maxlen=capacity)
        self._series: dict[str, deque] = {}
        self._prev_raw: dict[str, float] = {}
        self._last_sample: float | None = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._t)

    def due(self) -> bool:
        """Has `interval_s` elapsed since the last sample (or has none
        been taken)? The owner's opportunistic-sampling guard — cheap
        enough for a per-step call."""
        last = self._last_sample
        return last is None or (self.clock() - last) >= self.interval_s

    def sample(self, gauges: dict, cumulative: dict | None = None,
               ts: float | None = None) -> None:
        """Append one window. `gauges` stores raw values; `cumulative`
        stores per-window deltas vs the previous raw reading."""
        t = self.clock() if ts is None else ts
        row: dict[str, float | None] = dict(gauges)
        for k, raw in (cumulative or {}).items():
            prev = self._prev_raw.get(k)
            self._prev_raw[k] = raw
            row[k] = raw if prev is None else max(raw - prev, 0.0)
        with self._lock:
            n_before = len(self._t)
            self._t.append(t)
            for k, dq in self._series.items():
                dq.append(row.pop(k, None))
            for k, v in row.items():  # series first seen this window
                dq = deque(maxlen=self.capacity)
                dq.extend([None] * n_before)
                dq.append(v)
                self._series[k] = dq
        self._last_sample = t

    def doc(self) -> dict:
        """JSON-safe view: timestamps + aligned per-series rows (the
        ``/timeseriesz`` body)."""
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "capacity": self.capacity,
                "n": len(self._t),
                "t": [round(t, 6) for t in self._t],
                "series": {k: list(dq)
                           for k, dq in sorted(self._series.items())},
            }

    def sparklines(self, width: int = 60) -> dict[str, str]:
        """One sparkline string per series (the /statusz rendering);
        series with no finite point yet are omitted."""
        with self._lock:
            rows = {k: list(dq) for k, dq in sorted(self._series.items())}
        out = {}
        for k, vals in rows.items():
            s = sparkline(vals, width)
            if s:
                out[k] = s
        return out
