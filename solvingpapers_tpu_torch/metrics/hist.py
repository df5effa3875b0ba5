"""Mergeable log-bucketed latency histograms (port of
`solvingpapers_tpu/metrics/hist.py`, the HdrHistogram shape).

* FIXED log-spaced bucket boundaries, chosen at construction
  (``lo * 10**(i / buckets_per_decade)``), so every instance with the
  same layout has the same edges: the property that makes merge exact;
* O(1) record (one log10 + one integer increment), with total count,
  sum and exact min/max alongside;
* EXACT merge: same-layout histograms combine by adding count arrays,
  so a merge of shards equals one histogram that saw every observation;
* bounded-error quantiles: the estimate lands in the bucket of the exact
  nearest-rank sample, so its relative error is at most
  ``10**(1/buckets_per_decade) - 1`` (~15% at 16 buckets a decade);
* `bucket_bounds`/`cumulative_counts` give Prometheus `_bucket` series.

The default layout [100 µs, 10 000 s) at 16 buckets a decade covers
TTFT and ITL; values outside it land in the underflow/overflow buckets
(counted, clamped to the observed min/max in quantiles, never dropped).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["LogHistogram"]


class LogHistogram:
    """Fixed-layout log-bucketed histogram of non-negative observations.

    `add`, `mean`, `percentiles` and `__len__` are the latency-log API
    the serving metrics read.
    """

    __slots__ = ("lo", "hi", "buckets_per_decade", "n_buckets", "counts",
                 "count", "sum", "min", "max", "_log_lo", "_scale")

    def __init__(self, lo: float = 1e-4, hi: float = 1e4,
                 buckets_per_decade: int = 16):
        if not (lo > 0 and hi > lo):
            raise ValueError(
                f"need 0 < lo < hi, got lo={lo} hi={hi}"
            )
        if buckets_per_decade < 1:
            raise ValueError(
                f"buckets_per_decade must be >= 1, got {buckets_per_decade}"
            )
        self.lo = float(lo)
        self.hi = float(hi)
        self.buckets_per_decade = int(buckets_per_decade)
        self.n_buckets = int(
            math.ceil(round(math.log10(hi / lo) * buckets_per_decade, 9))
        )
        # [underflow] + n log buckets + [overflow]
        self.counts = np.zeros(self.n_buckets + 2, np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._log_lo = math.log10(self.lo)
        self._scale = float(buckets_per_decade)

    # ------------------------------------------------------------ layout

    @property
    def layout(self) -> tuple:
        """Merge-compatibility key: histograms merge iff layouts match."""
        return (self.lo, self.hi, self.buckets_per_decade)

    def edge(self, i: int) -> float:
        """Upper edge of log bucket i in [0, n_buckets)."""
        return self.lo * 10.0 ** ((i + 1) / self._scale)

    def bucket_bounds(self) -> list[float]:
        """Every bucket's inclusive upper bound, Prometheus `le` order:
        underflow (le=lo), the log buckets, overflow (le=+inf)."""
        return ([self.lo]
                + [self.edge(i) for i in range(self.n_buckets)]
                + [math.inf])

    def _index(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return self.n_buckets + 1
        i = int(math.floor((math.log10(v) - self._log_lo) * self._scale))
        # float rounding at an exact edge may land one off; clamp into
        # the log-bucket range (the under/overflow cases returned above)
        return 1 + min(max(i, 0), self.n_buckets - 1)

    # ------------------------------------------------------------ record

    def add(self, value: float, n: int = 1) -> None:
        """Record `value` `n` times (n > 1 is the decode block's
        amortized per-token gap — one bucket increment either way)."""
        v = max(float(value), 0.0)
        self.counts[self._index(v)] += n
        self.count += n
        self.sum += v * n
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    # ------------------------------------------------------------- merge

    def merge_from(self, other: "LogHistogram") -> "LogHistogram":
        """Fold `other`'s observations into self (exact: bucket counts
        add; layouts must match).

        Safe against a LIVE `other` (the fleet /metrics path merges
        replicas that are still recording): the shard's buckets are
        copied ONCE and the merged count derived FROM that copy, so an
        observation landing mid-merge is wholly present or wholly
        absent from the bucket/count pair — never torn across them
        (`add` updates counts before count, so reading count instead
        could disagree with the buckets in either direction). `sum`
        is a single read and may miss the same in-flight observation
        the buckets missed — the ordinary scrape-boundary skew. For
        quiescent shards this is byte-identical to the naive fold, so
        the exact-merge contract (merge-of-shards == shard-of-merged)
        is unchanged."""
        if other.layout != self.layout:
            raise ValueError(
                f"cannot merge histograms with different layouts: "
                f"{self.layout} vs {other.layout}"
            )
        shard = other.counts.copy()
        self.counts += shard
        self.count += int(shard.sum())
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    @classmethod
    def merge(cls, hists) -> "LogHistogram":
        """One histogram equivalent to having recorded every shard's
        observations (per-replica aggregation)."""
        hists = list(hists)
        if not hists:
            raise ValueError("merge needs at least one histogram")
        out = cls(*hists[0].layout[:2],
                  buckets_per_decade=hists[0].layout[2])
        for h in hists:
            out.merge_from(h)
        return out

    # ----------------------------------------------------------- summary

    def __len__(self) -> int:
        return self.count

    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile estimate, clamped to the observed
        [min, max]. The estimate lands in the bucket holding the exact
        nearest-rank sample, so |estimate - exact| <= that bucket's
        width (and a single-bucket population — e.g. one observation —
        reports exactly)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return float("nan")
        rank = max(1, math.ceil(q * self.count))
        cum = 0
        idx = len(self.counts) - 1
        for i, c in enumerate(self.counts):
            cum += int(c)
            if cum >= rank:
                idx = i
                break
        if idx == 0:
            rep = self.min  # underflow: [0, lo) — min/max are the only
        elif idx == self.n_buckets + 1:
            rep = self.max  # overflow: [hi, inf) — exact facts held
            # about values outside the layout
        else:
            lo_edge = self.lo * 10.0 ** ((idx - 1) / self._scale)
            rep = math.sqrt(lo_edge * self.edge(idx - 1))  # geometric mid
        return min(max(rep, self.min), self.max)

    def percentiles(self, qs: tuple[float, ...] = (50, 95, 99)) -> dict:
        """`{"p50": ..., ...}` (percent inputs, fractional labels
        kept)."""
        if self.count == 0:
            return {}
        out = {}
        for q in qs:
            label = f"p{int(q)}" if float(q).is_integer() else f"p{q}"
            out[label] = self.quantile(q / 100.0)
        return out

    # -------------------------------------------------------- exposition

    def cumulative_counts(self) -> list[int]:
        """Cumulative counts aligned with `bucket_bounds()` (Prometheus
        `_bucket` semantics: count of observations <= each `le`)."""
        return np.cumsum(self.counts).tolist()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"LogHistogram(n={self.count}, sum={self.sum:.6g}, "
                f"layout={self.layout})")
