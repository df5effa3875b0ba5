"""Request-scoped SLO accounting: attainment, error-budget burn, goodput
(port of `solvingpapers_tpu/serve/slo.py`).

Aggregate latency percentiles (serve/metrics.py) say how the engine is
doing on average; they say nothing about whether it is doing what each
CLASS of traffic was promised. An Orca-style iteration-level scheduler
can silently trade interactive TTFT for batch throughput under load —
the histograms keep looking healthy while every interactive user waits.
This module is the per-class accounting that makes the trade visible:

* SLO classes — each request carries a `SamplingParams.slo` tier
  (untagged requests default to ``"standard"``); per-class latency
  targets live in `ServeConfig.slo_targets` (class -> targets dict,
  `DEFAULT_SLO_TARGETS` below is the reference three-tier shape).
* Attainment — a finished request ATTAINS its SLO when every configured
  target holds: TTFT (submit -> first token), mean ITL (decode wall /
  emitted gaps), and e2e (submit -> finish). Cancelled and engine-error
  finishes are excluded (the client or the host failed, not the latency
  contract); timeouts count as violations (that IS the latency contract
  failing).
* Error-budget burn rate — the SRE control signal: violation rate over
  the recent `burn_window` finishes divided by the class's error budget
  (``1 - objective``). 1.0 means violations arrive exactly at the rate
  the objective tolerates; sustained > 1 means the budget is burning
  and the scheduler/capacity needs attention.
* Goodput — tokens delivered by SLO-attained requests only, the metric
  serving papers (DistServe) optimize: raw tokens/sec can rise while
  goodput falls (the engine is busy finishing requests nobody is still
  waiting for). Exposed as `serve/goodput_tokens[_per_s]`.

Pure host-side bookkeeping on the finish path, no device work; the
serve-bench ``--slo`` workload measures its cost against the plain
engine (`slo_overhead_pct`).
"""

from __future__ import annotations

from collections import deque

__all__ = ["DEFAULT_SLO_TARGETS", "SLO_METRICS", "SloTracker",
           "request_latencies"]

# the latency dimensions a class may target (seconds); a class dict may
# set any non-empty subset plus an "objective" (attainment fraction the
# error budget is derived from)
SLO_METRICS = ("ttft_s", "itl_s", "e2e_s")

# reference three-tier shape: interactive chat, standard API traffic,
# and offline batch. Values are seconds and deliberately loose enough
# for CPU bench hardware; production deployments pass their own dict.
DEFAULT_SLO_TARGETS = {
    "interactive": {"ttft_s": 0.5, "itl_s": 0.05, "e2e_s": 10.0,
                    "objective": 0.99},
    "standard": {"ttft_s": 2.0, "itl_s": 0.2, "e2e_s": 60.0,
                 "objective": 0.95},
    "batch": {"ttft_s": 30.0, "itl_s": 1.0, "e2e_s": 600.0,
              "objective": 0.9},
}

DEFAULT_CLASS = "standard"

# finish reasons that never count against (or for) an SLO: the client
# walked away, the engine itself failed, or the stream moved to a peer
# replica mid-flight (fleet drain — the ADOPTING replica owns the
# latency outcome; the drained one force-finishing "migrated" must not
# burn its own budget on a stream it deliberately handed off)
_EXCLUDED_REASONS = ("cancelled", "error", "migrated")


def request_latencies(req, now: float) -> dict[str, float]:
    """The request's observable latency dimensions from its own
    lifecycle timestamps (the SAME clock readings the flight recorder's
    spans and the latency histograms use, so the three surfaces can
    never disagree). A request that timed out before its first token
    has no ttft/itl observation — the attainment check treats a missing
    observation for a configured target as a violation iff the request
    never got that far (it certainly did not meet the target)."""
    out = {"e2e_s": max(now - req.submit_time, 0.0)}
    if req.first_token_time is not None:
        out["ttft_s"] = max(req.first_token_time - req.submit_time, 0.0)
        n_gaps = len(req.tokens) - 1
        if n_gaps > 0 and req.finish_time is not None:
            out["itl_s"] = max(
                req.finish_time - req.first_token_time, 0.0
            ) / n_gaps
    return out


class SloTracker:
    """Per-class attainment / burn-rate / goodput accounting.

    One instance per engine (`ServeConfig.slo_targets`); `observe` runs
    once per finish on the host loop — O(#targets) with no allocation
    beyond the result dict the request keeps for its debug timeline.
    """

    def __init__(self, targets: dict, burn_window: int = 256):
        if not isinstance(targets, dict) or not targets:
            raise ValueError(
                "slo_targets must be a non-empty dict of "
                "{class: {ttft_s/itl_s/e2e_s/objective}}"
            )
        if DEFAULT_CLASS not in targets:
            raise ValueError(
                f"slo_targets must define the {DEFAULT_CLASS!r} class — "
                "untagged requests fall into it, and a config that "
                "silently untracked them would under-count every burn"
            )
        if burn_window < 1:
            raise ValueError(
                f"burn_window must be >= 1, got {burn_window}"
            )
        self.targets: dict[str, dict] = {}
        for cls, spec in targets.items():
            if not isinstance(spec, dict):
                raise ValueError(
                    f"slo_targets[{cls!r}] must be a dict, got "
                    f"{type(spec).__name__}"
                )
            unknown = set(spec) - set(SLO_METRICS) - {"objective"}
            if unknown:
                raise ValueError(
                    f"slo_targets[{cls!r}] has unknown keys {sorted(unknown)} "
                    f"(allowed: {SLO_METRICS + ('objective',)})"
                )
            if not any(m in spec for m in SLO_METRICS):
                raise ValueError(
                    f"slo_targets[{cls!r}] sets no latency target "
                    f"(need at least one of {SLO_METRICS})"
                )
            for m in SLO_METRICS:
                if m in spec and not spec[m] > 0:
                    raise ValueError(
                        f"slo_targets[{cls!r}][{m!r}] must be > 0, "
                        f"got {spec[m]}"
                    )
            obj = spec.get("objective", 0.99)
            if not 0.0 < obj < 1.0:
                raise ValueError(
                    f"slo_targets[{cls!r}]['objective'] must be in (0, 1), "
                    f"got {obj}"
                )
            self.targets[cls] = {**{m: spec[m] for m in SLO_METRICS
                                    if m in spec},
                                 "objective": obj}
        self._stats = {
            cls: {
                "finished": 0,
                "attained": 0,
                "violations": dict.fromkeys(SLO_METRICS, 0),
                "window": deque(maxlen=burn_window),
            }
            for cls in self.targets
        }
        self.goodput_tokens = 0
        self.excluded = 0

    def classify(self, req) -> str:
        return req.params.slo or DEFAULT_CLASS

    # ------------------------------------------------------------ record

    def observe(self, req, now: float) -> dict | None:
        """Account one finished request; returns the per-request verdict
        (class / attained / violated metrics / latencies) that the HTTP
        debug timeline carries, or None for excluded finishes."""
        if req.finish_reason in _EXCLUDED_REASONS:
            self.excluded += 1
            return None
        cls = self.classify(req)
        spec = self.targets[cls]
        lat = request_latencies(req, now)
        violated = []
        for m in SLO_METRICS:
            if m not in spec:
                continue
            seen = lat.get(m)
            if seen is None:
                # configured target the request never reached (e.g. a
                # queue timeout before its first token): a violation —
                # "no observation" must not read as "attained"
                violated.append(m)
            elif seen > spec[m]:
                violated.append(m)
        attained = not violated
        st = self._stats[cls]
        st["finished"] += 1
        st["window"].append(attained)
        if attained:
            st["attained"] += 1
            self.goodput_tokens += len(req.tokens)
        else:
            for m in violated:
                st["violations"][m] += 1
        return {
            "class": cls,
            "attained": attained,
            "violated": violated,
            "latencies": {k: round(v, 6) for k, v in lat.items()},
            "targets": {m: spec[m] for m in SLO_METRICS if m in spec},
        }

    # ----------------------------------------------------------- surface

    def burn_rate(self, cls: str) -> float:
        """Windowed violation rate / error budget. 0 with an empty
        window (no invented burn before traffic arrives)."""
        st = self._stats[cls]
        if not st["window"]:
            return 0.0
        viol = st["window"].count(False) / len(st["window"])
        budget = 1.0 - self.targets[cls]["objective"]
        return viol / budget

    def gauges(self, elapsed_s: float) -> dict[str, float]:
        """The slo/* + goodput gauge family (riding ServeMetrics
        snapshots via the engine's provider — present iff slo_targets
        is configured, per the conditional-key-surface discipline).
        Attainment/burn appear once a class has finishes; rate keys
        once the metrics window is open (same absent-beats-NaN rule as
        serve/tokens_per_sec)."""
        out: dict[str, float] = {}
        for cls, st in self._stats.items():
            out[f"slo/{cls}_finished"] = float(st["finished"])
            if st["finished"]:
                out[f"slo/{cls}_attainment"] = (
                    st["attained"] / st["finished"]
                )
                out[f"slo/{cls}_burn_rate"] = self.burn_rate(cls)
        out["serve/goodput_tokens"] = float(self.goodput_tokens)
        if elapsed_s > 0:
            out["serve/goodput_tokens_per_s"] = (
                self.goodput_tokens / elapsed_s
            )
        return out

    def statusz(self) -> dict:
        """The /statusz `slo` section: per-class accounting + targets."""
        classes = {}
        for cls, st in self._stats.items():
            spec = self.targets[cls]
            classes[cls] = {
                "targets": {m: spec[m] for m in SLO_METRICS if m in spec},
                "objective": spec["objective"],
                "finished": st["finished"],
                "attained": st["attained"],
                "attainment": round(st["attained"] / st["finished"], 4)
                if st["finished"] else None,
                "burn_rate": round(self.burn_rate(cls), 4)
                if st["window"] else None,
                "violations": {m: v for m, v in st["violations"].items()
                               if v},
            }
        return {
            "classes": classes,
            "goodput_tokens": self.goodput_tokens,
            "excluded_finishes": self.excluded,
        }
