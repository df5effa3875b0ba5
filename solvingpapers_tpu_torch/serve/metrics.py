"""Serving observability (port of `solvingpapers_tpu/serve/metrics.py`:
the counters and latencies the lane-pool engine records).

    serve/ttft_s_*          submit -> first token (includes queue wait)
    serve/itl_s_*           gap between consecutive token emissions (a
                            decode block emits in bursts: the amortized gap)
    serve/prefill_s_*       admission -> first token on the host clock
                            (the first token's read waits for the device)
    serve/decode_block_s_*  one decode block, dispatch to its tokens on
                            the host (the token read waits for the device)
    serve/tokens_out        generated tokens
    serve/tokens_prefilled  prompt tokens prefilled
    serve/tokens_per_sec    generated tokens / elapsed wall time
    serve/slot_occupancy    mean fraction of slots decoding, per iteration
    serve/finish_<reason>   finished requests by outcome

Latencies are kept as plain lists (exact percentiles; the reference's
mergeable log histograms come with the fleet layer in a later slice).
"""

from __future__ import annotations

import time

import numpy as np


class LatencyLog:
    """Every observation of one latency, in seconds."""

    def __init__(self):
        self.values: list[float] = []

    def add(self, v: float, n: int = 1) -> None:
        self.values.extend([float(v)] * n)

    def __len__(self) -> int:
        return len(self.values)

    def mean(self) -> float:
        return float(np.mean(self.values))

    def percentiles(self) -> dict[str, float]:
        p50, p90, p99 = np.percentile(self.values, [50, 90, 99])
        return {"p50": float(p50), "p90": float(p90), "p99": float(p99)}


class ServeMetrics:
    """Engine-side collector; one instance per `ServeEngine`."""

    def __init__(self):
        self.ttft = LatencyLog()
        self.itl = LatencyLog()
        self.prefill = LatencyLog()
        self.decode_block = LatencyLog()
        self.occupancy: list[float] = []
        self.tokens_out = 0
        self.prefill_tokens = 0
        self.requests_finished = 0
        self.requests_rejected = 0
        self.finish_reasons: dict[str, int] = {}
        self.steps = 0
        self._t_first: float | None = None
        self._t_last: float | None = None

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

    def record_admit(self, now: float) -> None:
        self._touch(now)

    def record_first_token(self, req, now: float) -> None:
        self._touch(now)
        self.ttft.add(now - req.submit_time)
        self.prefill.add(now - req.admit_time)
        self.tokens_out += 1
        self.prefill_tokens += len(req.prompt)

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

    def _latencies(self):
        return (("ttft_s", self.ttft), ("itl_s", self.itl),
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
        if self.elapsed_s > 0:
            out["serve/tokens_per_sec"] = self.tokens_out / self.elapsed_s
        if self.occupancy:
            out["serve/slot_occupancy"] = float(np.mean(self.occupancy))
        for name, log in self._latencies():
            if len(log):
                out[f"serve/{name}_mean"] = log.mean()
                out[f"serve/{name}_sum"] = float(np.sum(log.values))
                out[f"serve/{name}_count"] = float(len(log))
                for k, v in log.percentiles().items():
                    out[f"serve/{name}_{k}"] = v
        return out


def now() -> float:
    """The engine's clock (monotonic)."""
    return time.monotonic()
