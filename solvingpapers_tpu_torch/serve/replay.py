"""Journal-backed request replay: the serving stack's correctness
observatory (port of `solvingpapers_tpu/serve/replay.py`).

The write-ahead journal (serve/journal.py) records everything needed to
re-serve a request exactly: the prompt's token ids, the full
`SamplingParams` (seed and SLO class included), the budget and EOS, the
arrival offset and the committed token stream. `ReplayHarness` loads a
journal (live file or rotated snapshot, through `journal.read_entries`),
rebuilds each finished request, re-serves the corpus against a CANDIDATE
`ServeConfig` on a fresh engine, and diffs the replayed streams against
the recorded ones: does the candidate serve yesterday's traffic
identically?

Two comparisons, by each stream's replayability class:

* **byte diff**: greedy streams (temperature 0) and SEEDED stochastic
  streams fold only ``(seed, sample index)`` into their sampling chains,
  so an identical-config replay must reproduce the recorded stream byte
  for byte (`byte_exact`); a mismatch carries its `first_divergence`
  token offset. Unseeded stochastic streams fold the engine step counter
  (serve/sampling.py): they are re-served for load realism but left out
  of the byte accounting.
* **teacher-forced agreement**: each byte-comparable stream is cut every
  `cut_stride` positions and the prefix re-served through the candidate
  for exactly one token. Greedy cuts submit the prefix as a plain prompt
  (argmax needs no seed pinning); seeded cuts ride
  `ServeEngine.replay_submit`'s committed-prefix path, which pins the
  recorded seed chain (admission re-prefills prompt + committed[:-1],
  discards the resampled token, and the next draw lands at sample index
  ``len(committed)``: the preemption-resume argument). Hence three rates:
  `agreement_rate_greedy` (the graded score), `agreement_rate_seeded`
  and `agreement_rate` over both. An identical config scores 1.0 on all
  three.

A journal recorded by either package replays on the port: the files read
the same in both (`read_entries`), and a reference journal's `kv_exact`
flag, a no-op on the port's unquantized pools, is dropped
(`engine.journaled_params`, as recovery rebuilds them).

Entries the candidate cannot replay token-exactly (grammar requests,
stop strings without a detokenizer, prompts beyond the candidate's
capacity, streams with no committed tokens, finishes that are not a
faithful prefix) land in the report as ``skipped`` with a reason, never
as divergences. The report also carries the replayed run's own
`ServeMetrics` latency and throughput summary and, with a baseline
config, paired deltas against a second re-serve of the same corpus.

A candidate the port cannot build is refused, never approximated:
`apply_overrides` raises a `ValueError` naming ROADMAP A5 for the
reference's quantized-pool and speculative knobs (``kv_quant=int8``
among them), because `ops/quant.py` and speculative decoding are not
ported.

Exposure: `cli replay` (exit 2 past the divergence threshold: the
canary gate), `POST /v1/replay` and `GET /v1/replay/<id>` on the HTTP
front door (serve/api.py), and the `replay/*` gauges (`report_gauges`)
through the gauge-provider mechanism. Nothing here is imported by the
engine, and no gauge exists until a replay has run.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from solvingpapers_tpu_torch.serve.engine import (
    ServeConfig,
    ServeEngine,
    journaled_params,
)
from solvingpapers_tpu_torch.serve.journal import JournalEntry, read_entries
from solvingpapers_tpu_torch.serve.sampling import SamplingParams

__all__ = [
    "ReplayHarness",
    "apply_overrides",
    "report_gauges",
    "sanitize_config",
]

# finish reasons whose committed stream is a faithful prefix of what an
# uninterrupted run would produce (cancel and timeout truncate the stream
# but never alter produced tokens)
_REPLAYABLE_REASONS = ("eos", "length", "stop", "cancelled", "timeout")

# the reference's ServeConfig knobs of pools and decoders the port does
# not have yet: a candidate naming one is refused, not approximated
_UNPORTED_KNOBS = {
    "kv_quant": "A5 (the quantized KV pool, ops/quant.py)",
    "kv_quant_block": "A5 (the quantized KV pool, ops/quant.py)",
    "kv_exact_lanes": "A5 (the quantized KV pool, ops/quant.py)",
    "speculative": "A5 (speculative decoding)",
    "spec_k": "A5 (speculative decoding)",
    "spec_rounds": "A5 (speculative decoding)",
}


def sanitize_config(cfg: ServeConfig, n_requests: int = 0) -> ServeConfig:
    """A candidate config made safe for a shadow re-serve: no journal of
    its own (shadow traffic must not write journal records), no listening
    ports, no fault injection, no tracing or time series: the replay
    engine is a measuring instrument, not a server. The queue bound is
    widened to hold the whole corpus (replay submits up front: admission
    order, not queue capacity, is under test)."""
    return dataclasses.replace(
        cfg,
        journal_path=None,
        journal_strict=False,
        api_port=None,
        status_port=None,
        fault_plan=None,
        trace=False,
        trace_dump_path=None,
        timeseries=False,
        profile_dir=None,
        max_waiting=max(cfg.max_waiting, n_requests + 1),
    )


def apply_overrides(cfg: ServeConfig, overrides: dict) -> ServeConfig:
    """Apply ``key=value`` candidate overrides to a ServeConfig. String
    values (from the CLI) go through `json.loads` first (ints, floats,
    ``true``/``false``, ``null``, lists) and stay raw strings otherwise.
    Unknown keys raise `ValueError` (a mistyped knob must not silently
    gate nothing), and so do the reference's quantized-pool and
    speculative knobs, naming the ROADMAP item that ports them."""
    fields = {f.name for f in dataclasses.fields(ServeConfig)}
    parsed = {}
    for key, val in overrides.items():
        if key in _UNPORTED_KNOBS:
            raise ValueError(
                f"config override {key!r} is not ported yet (ROADMAP "
                f"{_UNPORTED_KNOBS[key]}): the port cannot build that "
                "candidate")
        if key not in fields:
            raise ValueError(
                f"unknown ServeConfig field {key!r} in config overrides "
                f"(known: {sorted(fields)})")
        if isinstance(val, str):
            try:
                val = json.loads(val)
            except json.JSONDecodeError:
                pass  # a bare string value
        parsed[key] = val
    return dataclasses.replace(cfg, **parsed)


def _stream_kind(params: SamplingParams) -> str:
    """Replayability class: ``greedy`` and ``seeded`` streams are
    byte-comparable (their sampling chains fold only (seed, sample
    index)); ``stochastic`` (unseeded, temperature > 0) streams fold the
    engine step counter and are replayed for load only."""
    if params.temperature == 0:
        return "greedy"
    if params.seed is not None:
        return "seeded"
    return "stochastic"


def _first_divergence(recorded: list, replayed: list) -> int | None:
    """Token offset of the first mismatch (a length difference diverges
    at the shorter stream's end), None when byte-identical."""
    for i, (a, b) in enumerate(zip(recorded, replayed)):
        if int(a) != int(b):
            return i
    if len(recorded) != len(replayed):
        return min(len(recorded), len(replayed))
    return None


def _metrics_summary(eng: ServeEngine) -> dict:
    """The replayed run's own latency and throughput, flat and rounded:
    the paired deltas' source."""
    snap = eng.metrics.snapshot()
    out = {}
    for key, name in (
        ("serve/ttft_s_mean", "ttft_s_mean"),
        ("serve/ttft_s_p99", "ttft_s_p99"),
        ("serve/itl_s_mean", "itl_s_mean"),
        ("serve/e2e_s_mean", "e2e_s_mean"),
        ("serve/tokens_per_sec", "tokens_per_sec"),
        ("serve/requests_per_sec", "requests_per_sec"),
    ):
        if key in snap:
            out[name] = round(float(snap[key]), 6)
    return out


def report_gauges(report: dict | None) -> dict[str, float]:
    """The `replay/*` gauge family of a finished report, as a gauge
    provider's payload: absent until a replay has run, and None-valued
    aggregates (no byte-comparable streams, no divergences) omitted, not
    zero-filled."""
    if not report:
        return {}
    out = {
        "replay/streams_compared": float(report["streams_compared"]),
        "replay/streams_replayed": float(report["streams_replayed"]),
        "replay/streams_skipped": float(len(report["skipped"])),
        "replay/wall_s": float(report["replay_wall_s"]),
    }
    for src, name in (("byte_exact_rate", "replay/byte_exact_rate"),
                      ("agreement_rate", "replay/agreement_rate"),
                      ("agreement_rate_greedy", "replay/agreement_rate_greedy"),
                      ("first_divergence_p50", "replay/first_divergence_p50")):
        if report.get(src) is not None:
            out[name] = float(report[src])
    return out


class ReplayHarness:
    """Re-serve a journal's recorded traffic against a candidate
    `ServeConfig` and produce the divergence report.

    Holds the model half of an engine (the model, which carries its
    weights, and `detokenize`), so one harness drives several candidate
    configs over one loaded corpus. Construct it directly or borrow a
    live engine's model with `from_engine` (the HTTP front door's path:
    the replay engine is always a FRESH engine on the same weights; the
    live one is never touched). Runs on the model's device."""

    def __init__(self, model, *, detokenize=None):
        self.model = model
        self.detokenize = detokenize

    @classmethod
    def from_engine(cls, engine: ServeEngine) -> "ReplayHarness":
        return cls(engine.model, detokenize=engine.detokenize)

    # ------------------------------------------------------------- load

    @staticmethod
    def load(path: str, *, retries: int = 1) -> list[JournalEntry]:
        """Snapshot-load a journal file (live or rotated) through
        `journal.read_entries`: a torn tail is tolerated, and an ENOENT
        around a concurrent compaction swap is retried once."""
        return read_entries(path, retries=retries)

    # -------------------------------------------------------- selection

    def _screen(self, e: JournalEntry, cfg: ServeConfig
                ) -> tuple[SamplingParams | None, str | None]:
        """(params, None) for a replayable finished entry, (None, reason)
        otherwise: `ServeEngine._entry_request`'s checks in its order,
        with the corpus-level ones (unfinished, tokenless, not a faithful
        prefix). Skips are report rows, never divergences."""
        if not e.finished:
            return None, "still live at capture"
        if e.grammar:
            return None, "grammar stepper state is not journaled"
        if not e.tokens:
            return None, "no committed tokens to compare"
        if e.finish_reason not in _REPLAYABLE_REASONS:
            return None, (f"finish {e.finish_reason!r} is not a "
                          "token-faithful outcome")
        try:
            params = journaled_params(e.params)
        except (TypeError, ValueError) as exc:
            return None, f"unreplayable params: {exc}"
        limit = getattr(self.model, "max_positions", None)
        cap = min(cfg.max_len, limit or cfg.max_len)
        if len(e.prompt) < 1 or len(e.prompt) + len(e.tokens) > cap:
            return None, f"beyond the candidate's capacity {cap}"
        if params.stop and self.detokenize is None:
            return None, "stop strings need a detokenize callable"
        if params.top_k > cfg.sample_cap:
            return None, (f"top_k {params.top_k} exceeds the candidate's "
                          f"sample_cap {cfg.sample_cap}")
        return params, None

    # -------------------------------------------------------------- run

    @staticmethod
    def _drain(eng: ServeEngine) -> None:
        while eng.has_work():
            eng.step()

    def _serve_corpus(self, corpus, cfg: ServeConfig, pace: bool):
        """One full re-serve of the screened corpus on a fresh engine:
        submit in arrival order (paced at the recorded offsets when
        `pace`, all up front otherwise: exactness does not depend on
        arrivals, latency realism does), drain, and return (engine,
        handles, wall seconds). A journal holds its entries in arrival
        order, so the handles follow the corpus either way."""
        eng = ServeEngine(self.model, cfg, device=self.model.device,
                          detokenize=self.detokenize)
        handles = []

        def submit(e, params):
            handles.append(eng.replay_submit(
                np.asarray(e.prompt, np.int64), max_new_tokens=len(e.tokens),
                eos_id=e.eos_id, params=params))

        t0 = time.monotonic()
        if pace:
            base = min(e.arrival for e, _ in corpus)
            pending = sorted(((e.arrival - base, e, p) for e, p in corpus),
                             key=lambda r: r[0])
            i = 0
            while i < len(pending) or eng.has_work():
                elapsed = time.monotonic() - t0
                while i < len(pending) and pending[i][0] <= elapsed:
                    submit(pending[i][1], pending[i][2])
                    i += 1
                if eng.has_work():
                    eng.step()
                elif i < len(pending):
                    time.sleep(max(0.0, pending[i][0]
                                   - (time.monotonic() - t0)))
        else:
            for e, params in corpus:
                submit(e, params)
            self._drain(eng)
        wall = time.monotonic() - t0
        if not all(h.done for h in handles):
            raise RuntimeError("the replay engine drained with unfinished work")
        return eng, handles, wall

    @torch.no_grad()
    def run(self, entries, candidate: ServeConfig, *,
            baseline: ServeConfig | None = None,
            cut_stride: int = 8, max_cuts: int = 512,
            max_requests: int | None = None, pace: bool = False,
            journal_path: str | None = None, progress=None) -> dict:
        """Re-serve `entries` against `candidate` and return the
        divergence report (the module docstring has its semantics).

        `cut_stride` spaces the teacher-forced agreement cuts (0 turns the
        agreement pass off); `max_cuts` bounds their total (the report
        says how many were dropped). `baseline` re-serves the same corpus
        a second time for paired latency and throughput deltas.
        `progress(done, total)` is called from the calling thread as the
        phases finish: the HTTP front door's progress surface."""
        t_start = time.monotonic()
        entries = list(entries)
        if max_requests is not None:
            entries = entries[:max_requests]
        corpus, skipped = [], []
        for e in entries:
            params, reason = self._screen(e, candidate)
            if reason is not None:
                skipped.append({"rid": e.rid, "reason": reason})
            else:
                corpus.append((e, params))
        report = {
            "streams_total": len(entries),
            "streams_replayed": len(corpus),
            "streams_compared": 0,
            "skipped": skipped,
            "candidate": {
                "n_slots": candidate.n_slots,
                "max_len": candidate.max_len,
                "decode_block": candidate.decode_block,
                "paged": candidate.paged,
                "kv_quant": None,
                "speculative": None,
                "prefix_cache": candidate.prefix_cache,
            },
        }
        if journal_path is not None:
            report["journal"] = journal_path
        if not corpus:
            report.update(byte_exact_rate=None, agreement_rate=None,
                          agreement_rate_greedy=None,
                          agreement_rate_seeded=None,
                          first_divergence_p50=None, diverged=[], streams=[],
                          cut_positions=0, replay_metrics={},
                          replay_wall_s=round(time.monotonic() - t_start, 4))
            return report
        run_cfg = sanitize_config(candidate, len(corpus))

        total_phases = 2 + (1 if cut_stride else 0) + (baseline is not None)
        done_phases = 0

        def tick():
            nonlocal done_phases
            done_phases += 1
            if progress is not None:
                progress(done_phases, total_phases)

        tick()  # corpus screened
        eng, handles, serve_wall = self._serve_corpus(corpus, run_cfg, pace)
        tick()

        streams, diverged = [], []
        exact = compared = 0
        for (e, params), h in zip(corpus, handles):
            kind = _stream_kind(params)
            recorded = [int(t) for t in e.tokens]
            replayed = [int(t) for t in h.tokens]
            row = {
                "rid": e.rid, "kind": kind,
                "recorded_tokens": len(recorded),
                "replayed_tokens": len(replayed),
                "finish_recorded": e.finish_reason,
                "finish_replayed": h.finish_reason,
                "byte_exact": None, "first_divergence": None,
            }
            if kind in ("greedy", "seeded"):
                compared += 1
                offset = _first_divergence(recorded, replayed)
                row["byte_exact"] = offset is None
                row["first_divergence"] = offset
                if offset is None:
                    exact += 1
                else:
                    diverged.append({
                        "rid": e.rid, "kind": kind, "first_divergence": offset,
                        "recorded_tokens": len(recorded),
                        "replayed_tokens": len(replayed),
                    })
            streams.append(row)

        # teacher-forced cuts over the byte-comparable streams; greedy
        # cuts are the graded number (argmax agreement is robust to small
        # logit error), seeded cuts re-draw through the pinned seed chain
        agreement = None
        cut_total = cut_matches = cuts_dropped = 0
        by_kind = {"greedy": [0, 0], "seeded": [0, 0]}  # [total, match]
        if cut_stride:
            cuts = []  # (expected token, entry, params, offset, kind)
            for (e, params), row in zip(corpus, streams):
                if row["kind"] not in ("greedy", "seeded"):
                    continue
                for j in range(0, len(e.tokens), cut_stride):
                    cuts.append((int(e.tokens[j]), e, params, j, row["kind"]))
            if len(cuts) > max_cuts:
                cuts_dropped = len(cuts) - max_cuts
                cuts = cuts[:max_cuts]
            cut_params = {}
            cut_handles = []
            for expected, e, params, j, kind in cuts:
                key = id(params)
                if key not in cut_params:
                    # a pure continuation: the recorded stop conditions and
                    # budget must not cut the cut
                    cut_params[key] = dataclasses.replace(
                        params, stop=(), stop_token_ids=(), max_tokens=None)
                try:
                    if kind == "greedy":
                        h = eng.replay_submit(
                            np.concatenate([np.asarray(e.prompt, np.int64),
                                            np.asarray(e.tokens[:j], np.int64)]),
                            max_new_tokens=1, eos_id=None,
                            params=cut_params[key])
                        out_idx = 0
                    else:
                        h = eng.replay_submit(
                            np.asarray(e.prompt, np.int64),
                            max_new_tokens=j + 1, eos_id=None,
                            params=cut_params[key], committed=e.tokens[:j])
                        out_idx = j
                except ValueError:
                    cuts_dropped += 1
                    continue
                cut_handles.append((h, expected, out_idx, kind))
            self._drain(eng)
            for h, expected, out_idx, kind in cut_handles:
                cut_total += 1
                by_kind[kind][0] += 1
                if len(h.tokens) > out_idx and int(h.tokens[out_idx]) == expected:
                    cut_matches += 1
                    by_kind[kind][1] += 1
            if cut_total:
                agreement = cut_matches / cut_total
            tick()

        def rate(kind):
            total, match = by_kind[kind]
            return round(match / total, 6) if total else None

        fdivs = sorted(d["first_divergence"] for d in diverged)
        report.update(
            streams_compared=compared,
            byte_exact=exact,
            byte_exact_rate=(exact / compared) if compared else None,
            diverged=diverged,
            first_divergence_p50=(float(fdivs[len(fdivs) // 2])
                                  if fdivs else None),
            agreement_rate=(round(agreement, 6)
                            if agreement is not None else None),
            agreement_rate_greedy=rate("greedy"),
            agreement_rate_seeded=rate("seeded"),
            cut_positions=cut_total,
            cuts_dropped=cuts_dropped,
            cut_stride=cut_stride,
            streams=streams,
            replay_metrics=_metrics_summary(eng),
            serve_wall_s=round(serve_wall, 4),
        )
        eng.close()
        del eng  # its pool frees before a baseline engine allocates one

        if baseline is not None:
            beng, _, _ = self._serve_corpus(
                corpus, sanitize_config(baseline, len(corpus)), pace)
            base_metrics = _metrics_summary(beng)
            beng.close()
            del beng
            report["baseline_metrics"] = base_metrics
            cand = report["replay_metrics"]
            report["deltas"] = {
                f"{name}_delta_pct": round((cand[name] / val - 1.0) * 100.0, 2)
                for name, val in base_metrics.items() if name in cand and val
            }
            tick()

        report["replay_wall_s"] = round(time.monotonic() - t_start, 4)
        return report
