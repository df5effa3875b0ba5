"""Serving observability (port of `solvingpapers_tpu/serve/metrics.py`:
the counters, latencies and gauges the engine records).

    serve/ttft_s_*          submit -> first token (includes queue wait)
    serve/itl_s_*           gap between consecutive token emissions (a
                            decode block emits in bursts: the amortized gap)
    serve/queue_wait_s_*    submit -> slot admission
    serve/prefill_s_*       admission -> first token on the host clock
                            (the first token's read waits for the device)
    serve/decode_block_s_*  one decode block, dispatch to its tokens on
                            the host (the token read waits for the device)
    serve/tokens_out        generated tokens
    serve/tokens_prefilled  prompt tokens the engine actually prefilled
                            (a prefix hit's cached tokens excluded, a
                            resume's recomputed ones included)
    serve/tokens_per_sec    generated tokens / elapsed wall time
    serve/slot_occupancy    mean fraction of slots decoding, per iteration
    serve/finish_<reason>   finished requests by outcome

TTFT, ITL and queue wait go into mergeable log histograms
(`metrics.hist.LogHistogram`: means exact, percentiles bucket-resolution
estimates), as the reference records them; the prefill and decode-block
times stay exact lists of every observation. `prom_snapshot` adds the
histograms themselves, which the `/metrics` exposition
(`metrics.writer.PrometheusTextWriter.render`) renders as native
``_bucket`` / ``_sum`` / ``_count`` series, one ``# TYPE`` line a name.

Paged-pool gauges (present iff `ServeConfig.paged`; the engine registers
a gauge provider):

    serve/pages_free           allocatable pages currently free
    serve/pages_active         pages referenced by slots or the tree
    serve/page_fragmentation   1 - live KV / allocated page capacity
    serve/preemptions          requests evicted mid-stream on page
                               exhaustion (recomputed on re-admission);
                               present iff any occurred, with
    serve/recompute_tokens     the tokens re-prefilled by those resumes

Prefix-cache counters (present once the engine's prefix cache looked a
prompt up):

    serve/prefix_lookups           admission-time radix-tree matches
    serve/prefix_hits              lookups that matched >= 1 page
    serve/prefix_hit_rate          hits / lookups
    serve/prefix_cached_tokens     prompt tokens served from the cache
    serve/tokens_prefilled_saved   the same: prefill compute avoided
    serve/prefix_evictions         LRU leaf evictions so far
    serve/prefix_hbm_bytes         device bytes the radix tree holds now

Fault-tolerance counters (serve/faults.py; each present iff its event
ever occurred, so a fault-free run keeps the key surface of an engine
without the fault plane):

    serve/fault_injected       fault-plan specs fired at a site
    serve/fault_quarantined    NaN/Inf-poisoned slots contained
    serve/fault_retries        systemic failures answered by a rebuild
    serve/fault_unhealthy      drains to `unhealthy` (retries exhausted)
    serve/watchdog_stalls      steps past `fault_step_deadline_s`
    serve/fault_recovery_s     first failure -> first clean step, last
                               episode
    serve/degrade_transitions  degradation-ladder moves, either way
    serve/shed_<class>         admissions load-shed by SLO class

Gauge providers the engine registers when the feature is on: the
journal's (`serve/journal_*`, `serve/recovered_requests`), the SLO
tracker's (`slo/<class>_*`, `serve/goodput_tokens[_per_s]`) and the
ladder's `serve/degradation_rung`.
"""

from __future__ import annotations

import time

import numpy as np

from solvingpapers_tpu_torch.metrics.hist import LogHistogram

# one latency bucket layout for every serve histogram (merges need
# identical layouts)
_LATENCY_LAYOUT = dict(lo=1e-4, hi=1e4, buckets_per_decade=16)
# the percentiles the snapshot reports (p95 is the reference's, which
# the serving bench reads)
_PERCENTILES = (50, 90, 95, 99)


def latency_histogram() -> LogHistogram:
    """A serve-layout latency histogram."""
    return LogHistogram(**_LATENCY_LAYOUT)


class LatencyLog:
    """Every observation of one latency, in seconds (exact)."""

    def __init__(self):
        self.values: list[float] = []

    def add(self, v: float, n: int = 1) -> None:
        self.values.extend([float(v)] * n)

    def __len__(self) -> int:
        return len(self.values)

    def mean(self) -> float:
        return float(np.mean(self.values))

    @property
    def sum(self) -> float:
        return float(np.sum(self.values))

    def percentiles(self, qs=_PERCENTILES) -> dict[str, float]:
        return {f"p{q}": float(v)
                for q, v in zip(qs, np.percentile(self.values, qs))}


class ServeMetrics:
    """Engine-side collector; one instance per `ServeEngine`."""

    def __init__(self):
        self.ttft = latency_histogram()
        self.itl = latency_histogram()
        self.queue_wait = latency_histogram()
        self.prefill = LatencyLog()
        self.decode_block = LatencyLog()
        self.occupancy: list[float] = []
        self.tokens_out = 0
        self.prefill_tokens = 0
        self.requests_finished = 0
        self.requests_rejected = 0
        self.finish_reasons: dict[str, int] = {}
        self.steps = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_cached_tokens = 0
        self.prefix_evictions = 0
        self.prefix_bytes_held = 0
        self.preemptions = 0
        self.recompute_tokens = 0
        self.faults_injected = 0
        self.quarantines = 0
        self.engine_retries = 0
        self.engine_unhealthy = 0
        self.watchdog_stalls = 0
        self.recoveries = 0
        self.recovery_s_last = 0.0
        self.degrade_transitions = 0
        self.sheds: dict[str, int] = {}
        self._t_first: float | None = None
        self._t_last: float | None = None
        # zero-argument {metric: float} providers merged into every
        # snapshot (the paged pool's gauges), registered only when the
        # feature is on, so their keys are present iff it is
        self._gauge_providers: list = []

    def add_gauge_provider(self, provider) -> None:
        """Attach a zero-arg callable returning {metric_name: float}; its
        keys ride every `snapshot()`."""
        self._gauge_providers.append(provider)

    def _touch(self, now: float) -> None:
        if self._t_first is None:
            self._t_first = now
        self._t_last = now

    @property
    def elapsed_s(self) -> float:
        if self._t_first is None or self._t_last is None:
            return 0.0
        return self._t_last - self._t_first

    def record_reject(self) -> None:
        self.requests_rejected += 1

    def record_admit(self, req, now: float) -> None:
        self._touch(now)
        self.queue_wait.add(now - req.submit_time)

    def record_first_token(self, req, now: float,
                           prefilled: int | None = None) -> None:
        """`prefilled` is the prompt tokens the engine ran prefill over
        (the uncovered suffix after a prefix hit); default the prompt."""
        self._touch(now)
        self.ttft.add(now - req.submit_time)
        self.prefill.add(now - req.admit_time)
        self.tokens_out += 1
        self.prefill_tokens += len(req.prompt) if prefilled is None else prefilled

    def record_tokens(self, n: int, span_s: float, now: float) -> None:
        """`n` tokens of one request emitted over `span_s` seconds."""
        self._touch(now)
        self.tokens_out += n
        if n > 0:
            self.itl.add(span_s / n, n)

    def record_decode_block(self, seconds: float) -> None:
        self.decode_block.add(seconds)

    def record_finish(self, req, now: float) -> None:
        self._touch(now)
        self.requests_finished += 1
        reason = req.finish_reason or "unknown"
        self.finish_reasons[reason] = self.finish_reasons.get(reason, 0) + 1

    def record_step(self, occupancy: float) -> None:
        self.steps += 1
        self.occupancy.append(occupancy)

    def record_prefix_lookup(self, matched_tokens: int) -> None:
        """One admission-time radix match; `matched_tokens` prompt tokens
        came from the cache instead of prefill (0 = miss)."""
        self.prefix_lookups += 1
        if matched_tokens > 0:
            self.prefix_hits += 1
            self.prefix_cached_tokens += matched_tokens

    def record_prefix_state(self, bytes_held: int, evictions: int) -> None:
        """Latest radix-tree gauges (bytes held, cumulative evictions)."""
        self.prefix_bytes_held = bytes_held
        self.prefix_evictions = evictions

    def record_preemption(self) -> None:
        """A paged-pool request lost its slot to page exhaustion (it
        recomputes on re-admission)."""
        self.preemptions += 1

    def record_recompute_tokens(self, n: int) -> None:
        """Prompt + stream tokens re-prefilled by a preempted request's
        resume: the compute cost of preemption by recompute."""
        self.recompute_tokens += n
        self.prefill_tokens += n

    def record_fault_injected(self) -> None:
        """The fault plan fired one spec at a hot-path site."""
        self.faults_injected += 1

    def record_quarantine(self) -> None:
        """A NaN/Inf-poisoned slot was contained (its request finished
        "error"; every other stream continued)."""
        self.quarantines += 1

    def record_engine_retry(self) -> None:
        """A systemic step failure consumed one pool-rebuild retry."""
        self.engine_retries += 1

    def record_engine_unhealthy(self) -> None:
        """Retries exhausted: the engine drained to `unhealthy`."""
        self.engine_unhealthy += 1

    def record_watchdog_stall(self, dur_s: float) -> None:
        """A step exceeded the absolute watchdog deadline (`dur_s` rides
        the trace instant and the anomaly dump, not a gauge)."""
        self.watchdog_stalls += 1

    def record_recovery(self, dur_s: float) -> None:
        """First clean step after a failure episode: `dur_s` = first
        failure -> first clean step (the serve/fault_recovery_s gauge)."""
        self.recoveries += 1
        self.recovery_s_last = dur_s

    def record_degrade_transition(self) -> None:
        """The degradation ladder moved one rung (either direction)."""
        self.degrade_transitions += 1

    def record_shed(self, slo_class: str) -> None:
        """An admission was load-shed by SLO class (ladder rung >= 3)."""
        self.sheds[slo_class] = self.sheds.get(slo_class, 0) + 1

    def _latencies(self):
        return (("ttft_s", self.ttft), ("itl_s", self.itl),
                ("queue_wait_s", self.queue_wait),
                ("prefill_s", self.prefill),
                ("decode_block_s", self.decode_block))

    def snapshot(self) -> dict[str, float]:
        """Current aggregate view, flat keys."""
        out = {
            "serve/tokens_out": float(self.tokens_out),
            "serve/tokens_prefilled": float(self.prefill_tokens),
            "serve/requests_finished": float(self.requests_finished),
            "serve/requests_rejected": float(self.requests_rejected),
            "serve/steps": float(self.steps),
        }
        for reason in sorted(self.finish_reasons):
            out[f"serve/finish_{reason}"] = float(self.finish_reasons[reason])
        if self.prefix_lookups:
            out["serve/prefix_lookups"] = float(self.prefix_lookups)
            out["serve/prefix_hits"] = float(self.prefix_hits)
            out["serve/prefix_hit_rate"] = self.prefix_hits / self.prefix_lookups
            out["serve/prefix_cached_tokens"] = float(self.prefix_cached_tokens)
            out["serve/tokens_prefilled_saved"] = float(self.prefix_cached_tokens)
            out["serve/prefix_evictions"] = float(self.prefix_evictions)
            out["serve/prefix_hbm_bytes"] = float(self.prefix_bytes_held)
        if self.preemptions:
            out["serve/preemptions"] = float(self.preemptions)
            out["serve/recompute_tokens"] = float(self.recompute_tokens)
        if self.faults_injected:
            out["serve/fault_injected"] = float(self.faults_injected)
        if self.quarantines:
            out["serve/fault_quarantined"] = float(self.quarantines)
        if self.engine_retries:
            out["serve/fault_retries"] = float(self.engine_retries)
        if self.engine_unhealthy:
            out["serve/fault_unhealthy"] = float(self.engine_unhealthy)
        if self.watchdog_stalls:
            out["serve/watchdog_stalls"] = float(self.watchdog_stalls)
        if self.recoveries:
            out["serve/fault_recovery_s"] = float(self.recovery_s_last)
        if self.degrade_transitions:
            out["serve/degrade_transitions"] = float(self.degrade_transitions)
        for cls in sorted(self.sheds):
            out[f"serve/shed_{cls}"] = float(self.sheds[cls])
        if self.elapsed_s > 0:
            out["serve/tokens_per_sec"] = self.tokens_out / self.elapsed_s
        if self.occupancy:
            out["serve/slot_occupancy"] = float(np.mean(self.occupancy))
        for name, log in self._latencies():
            if len(log):
                out[f"serve/{name}_mean"] = log.mean()
                out[f"serve/{name}_sum"] = float(log.sum)
                out[f"serve/{name}_count"] = float(len(log))
                for k, v in log.percentiles(_PERCENTILES).items():
                    out[f"serve/{name}_{k}"] = v
        for provider in self._gauge_providers:
            out.update(provider())
        return out

    def prom_snapshot(self) -> dict:
        """`snapshot()` plus the latency histograms themselves under their
        base names (``serve/ttft_s``): the metric set of the Prometheus
        exposition, where they render as native histograms (their
        ``_sum`` / ``_count`` claim those names over the snapshot's
        gauges)."""
        out = self.snapshot()
        for name, hist in (("ttft_s", self.ttft), ("itl_s", self.itl),
                           ("queue_wait_s", self.queue_wait)):
            if len(hist):
                out[f"serve/{name}"] = hist
        return out


def now() -> float:
    """The engine's clock (monotonic)."""
    return time.monotonic()
