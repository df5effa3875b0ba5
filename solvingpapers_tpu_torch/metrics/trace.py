"""Flight recorder: bounded-ring structured event tracing for the serving
engine (port of `solvingpapers_tpu/metrics/trace.py`).

`ServeMetrics` answers aggregate questions ("what is p99 TTFT"); this
module answers the per-request and per-step ones ("why was THIS request's
TTFT 900 ms", "what did step 1412 spend its time on"). Three pieces:

* `FlightRecorder` — a thread-safe bounded ring of typed events
  (monotonic timestamps, category, display track, optional request id,
  small payload dicts). Recording is append-one-tuple-under-a-lock;
  everything expensive (JSON, flow synthesis, track naming) happens at
  export. When tracing is off the engine holds `None` instead of a
  recorder, so every hook site is a single `is not None` branch.

* Chrome trace-event export (`FlightRecorder.export_chrome`) — JSON
  loadable in Perfetto / `chrome://tracing`: one named track per KV slot
  (plus engine / queue / prefix / http tracks) and one flow per request,
  so a request's submit -> queue -> admit -> splice -> prefill ->
  decode-blocks -> finish lifecycle reads as a connected timeline.

* `AnomalyMonitor` — watches finishes (timeout / cancelled), rejection
  bursts, and engine steps exceeding k x the rolling-median step time;
  on trigger it appends the last N ring events, a metrics snapshot and
  the time-series retrospective to a JSONL file for post-mortem, then
  keeps going (rotating keep-newest past `max_dumps`).

`summarize_trace` / `format_summary` rebuild per-request timelines from
an exported trace (the `cli trace-summary` command): for every request
the lifecycle spans partition its wall time exactly — queue
(submit -> admit) + prefill (admit -> first token) + decode (first token
-> finish) — because the engine stamps them from the same
`Request.submit_time` / `admit_time` / `first_token_time` /
`finish_time` clock readings the latency metrics use. Those readings
are taken on the host after the block's host read, which waits for the
device, so tracing adds no device synchronisation of its own.

`fleet_events_to_chrome` stitches the fleet router's recorder and every
replica's into one trace, one Perfetto process a section, with flows
that follow a request across reroutes and drain migrations; the
summary's `fleet` section (`_fleet_section`, `format_fleet`: `cli
trace-summary --fleet`) reads the routing counters, the requests each
replica finished and the migrations back from it.

The reference's mesh section, its per-program roofline and anatomy
sections (read from XLA compile events) and its train-trace summary are
not here: their events do not exist in the port yet, and
`summarize_trace` has no such section when the trace holds no such
events, as in the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import threading
import time
from collections import deque
from typing import Callable


@dataclasses.dataclass(frozen=True, slots=True)
class TraceEvent:
    """One recorded event. `ph` follows the Chrome trace-event phases the
    exporter emits: "X" complete (ts + dur), "i" instant, "C" counter.
    `track` is the display lane ("engine", "queue", "prefix", "train",
    "slot<N>"); `req` binds the event into a request's flow."""

    name: str
    cat: str
    track: str
    ph: str
    ts: float  # seconds on the recorder's clock (monotonic)
    dur: float = 0.0  # seconds; complete events only
    req: int | None = None
    args: dict | None = None

    def to_dict(self) -> dict:
        d = {"name": self.name, "cat": self.cat, "track": self.track,
             "ph": self.ph, "ts": self.ts, "dur": self.dur}
        if self.req is not None:
            d["req"] = self.req
        if self.args:
            d["args"] = self.args
        return d


# fixed display order for the well-known tracks; slot tracks sort by
# index after them, then per-device stage tracks (the mesh observatory's
# pipeline lanes), anything else alphabetically at the end
_TRACK_ORDER = {"engine": 0, "queue": 1, "prefix": 2, "http": 3,
                "train": 4, "mesh": 5, "router": 6}


def _track_sort_key(track: str) -> tuple:
    if track in _TRACK_ORDER:
        return (0, _TRACK_ORDER[track], 0, track)
    if track.startswith("slot") and track[4:].isdigit():
        return (1, 0, int(track[4:]), track)
    if track.startswith("stage") and track[5:].isdigit():
        return (1, 1, int(track[5:]), track)
    return (2, 0, 0, track)


class FlightRecorder:
    """Thread-safe bounded ring of `TraceEvent`s.

    `capacity` bounds memory: the ring keeps the newest events (a
    long-lived serving loop records unboundedly many; the recent window
    is what an anomaly dump or an export wants). `clock` defaults to
    `time.monotonic` and is injectable so the serving engine can share
    its patchable `serve.metrics.now` clock with the latency metrics —
    one time base for spans and TTFT makes the trace-summary phase sums
    exact against measured latencies.
    """

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.clock = clock
        self._buf: deque[TraceEvent] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.total_recorded = 0

    def __len__(self) -> int:
        return len(self._buf)

    def _record(self, ev: TraceEvent) -> None:
        with self._lock:
            self._buf.append(ev)
            self.total_recorded += 1

    # ----------------------------------------------------------- recording

    def instant(self, name: str, cat: str, track: str, *,
                req: int | None = None, ts: float | None = None,
                **args) -> None:
        self._record(TraceEvent(
            name, cat, track, "i", self.clock() if ts is None else ts,
            req=req, args=args or None,
        ))

    def complete(self, name: str, cat: str, track: str, *, ts: float,
                 dur: float, req: int | None = None, **args) -> None:
        """A finished span: `ts` start, `dur` seconds (recorded at end —
        the ring holds only completed spans, so a reader never sees a
        dangling begin)."""
        self._record(TraceEvent(
            name, cat, track, "X", ts, dur=max(dur, 0.0), req=req,
            args=args or None,
        ))

    def counter(self, name: str, cat: str, track: str, *,
                ts: float | None = None, **values) -> None:
        """A sampled counter series (queue depth, active slots): Perfetto
        renders these as stacked area charts under the track."""
        self._record(TraceEvent(
            name, cat, track, "C", self.clock() if ts is None else ts,
            args=values or None,
        ))

    @contextlib.contextmanager
    def span(self, name: str, cat: str, track: str, *,
             req: int | None = None, **args):
        """Context-manager span on the recorder's clock (host-side work:
        data waits, checkpoint saves). Records even when the body raises
        — the span that blew up is the one the post-mortem wants."""
        t0 = self.clock()
        try:
            yield
        finally:
            self.complete(name, cat, track, ts=t0, dur=self.clock() - t0,
                          req=req, **args)

    # ------------------------------------------------------------- reading

    def events(self) -> list[TraceEvent]:
        """Snapshot copy of the ring, oldest first."""
        with self._lock:
            return list(self._buf)

    def last(self, n: int) -> list[TraceEvent]:
        with self._lock:
            if n >= len(self._buf):
                return list(self._buf)
            return list(self._buf)[-n:]

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    # -------------------------------------------------------------- export

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (the "JSON Object Format":
        {"traceEvents": [...]}) with thread-name/sort metadata per track
        and one flow per request stitched through its spans."""
        return events_to_chrome(self.events())

    def export_chrome(self, path: str) -> str:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


def events_to_chrome(events: list[TraceEvent]) -> dict:
    """Convert recorded events to the Chrome trace-event format.

    Timestamps are microseconds relative to the earliest event (Perfetto
    handles absolute monotonic stamps, but small offsets keep the JSON
    readable and diff-able). Each distinct `track` becomes a tid with a
    thread_name/thread_sort_index metadata record; request-bound duration
    events additionally get flow events (`ph` s/t/f, one flow id per
    request) so Perfetto draws arrows across tracks from submit to
    finish."""
    if not events:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(e.ts for e in events)
    tracks = sorted({e.track for e in events}, key=_track_sort_key)
    tids = {t: i for i, t in enumerate(tracks)}
    out: list[dict] = []
    for track, tid in tids.items():
        out.append({"ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                    "args": {"name": track}})
        out.append({"ph": "M", "pid": 1, "tid": tid,
                    "name": "thread_sort_index", "args": {"sort_index": tid}})

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    by_req: dict[int, list[TraceEvent]] = {}
    for e in events:
        rec = {"ph": e.ph, "pid": 1, "tid": tids[e.track], "name": e.name,
               "cat": e.cat, "ts": us(e.ts)}
        args = dict(e.args or {})
        if e.ph == "X":
            rec["dur"] = round(e.dur * 1e6, 3)
        elif e.ph == "i":
            rec["s"] = "t"  # thread-scoped instant
        elif e.ph == "C":
            rec["args"] = args
            out.append(rec)
            continue
        if e.req is not None:
            args["req"] = e.req
            by_req.setdefault(e.req, []).append(e)
        if args:
            rec["args"] = args
        out.append(rec)

    # one flow per request: start at its first event, step through every
    # later duration event, finish at its last event — synthesized here so
    # the hot recording path never pays for flow bookkeeping
    for req, evs in by_req.items():
        evs = sorted(evs, key=lambda e: (e.ts, -ord(e.ph[0])))
        for i, e in enumerate(evs):
            ph = "s" if i == 0 else ("f" if i == len(evs) - 1 else "t")
            if len(evs) == 1:
                break
            flow = {"ph": ph, "pid": 1, "tid": tids[e.track],
                    "name": f"req{req}", "cat": "flow", "id": req,
                    "ts": us(e.ts)}
            if ph == "f":
                flow["bp"] = "e"  # bind to the enclosing slice
            out.append(flow)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def fleet_events_to_chrome(sections) -> dict:
    """Stitch N recorders into ONE Chrome trace: `sections` is
    ``[(label, events), ...]`` — the router recorder plus one section
    per replica, all on the shared engine clock (`serve.metrics.now`),
    so one t0 aligns every section.

    Layout: each section becomes its own Perfetto PROCESS (pid = index
    + 1, named via process_name/process_sort_index metadata) with its
    own tracks as tids — the process-per-replica view the fleet drain
    post-mortem reads top-to-bottom. Per-section per-request flows are
    emitted exactly as `events_to_chrome` does (request ids are unique
    across in-process replicas, so the flow ids cannot collide);
    additionally, every event carrying a ``rid`` arg (the router's
    route/reroute/migrate spans and each engine's submit instant) joins
    a CROSS-SECTION flow keyed on the request's trace id — the arrow
    that follows a request from the router into its replica and, after
    a drain, across to the adopting peer. Flow ids are crc32(rid)
    (Chrome binds flows by (cat, name, id), and the name carries the
    full rid, so a crc collision cannot merge two requests' arrows).

    A ``fleet_manifest`` metadata record lists the declared section
    labels. It survives `load_chrome`'s events-only round trip, so
    `summarize_trace` can detect a PARTIAL export (a slice of the
    stitched file missing a declared section) and refuse loudly
    instead of summarizing half a fleet as the whole."""
    import zlib

    sections = [(label, list(evs)) for label, evs in sections]
    labels = [label for label, _ in sections]
    if len(set(labels)) != len(labels):
        raise ValueError(f"duplicate fleet section labels: {labels}")
    out: list[dict] = [{
        "ph": "M", "pid": 0, "tid": 0, "name": "fleet_manifest",
        "args": {"sections": labels},
    }]
    all_ts = [e.ts for _, evs in sections for e in evs]
    t0 = min(all_ts) if all_ts else 0.0

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    # (pid, ts, tid, rid) anchors for the cross-section flows
    rid_anchors: dict[str, list[tuple[float, int, int]]] = {}
    for idx, (label, evs) in enumerate(sections):
        pid = idx + 1
        out.append({"ph": "M", "pid": pid, "name": "process_name",
                    "args": {"name": label}})
        out.append({"ph": "M", "pid": pid, "name": "process_sort_index",
                    "args": {"sort_index": idx}})
        tracks = sorted({e.track for e in evs}, key=_track_sort_key)
        tids = {t: i for i, t in enumerate(tracks)}
        for track, tid in tids.items():
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name", "args": {"name": track}})
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_sort_index",
                        "args": {"sort_index": tid}})
        by_req: dict[int, list[TraceEvent]] = {}
        for e in evs:
            rec = {"ph": e.ph, "pid": pid, "tid": tids[e.track],
                   "name": e.name, "cat": e.cat, "ts": us(e.ts)}
            args = dict(e.args or {})
            if e.ph == "X":
                rec["dur"] = round(e.dur * 1e6, 3)
            elif e.ph == "i":
                rec["s"] = "t"
            elif e.ph == "C":
                rec["args"] = args
                out.append(rec)
                continue
            if e.req is not None:
                args["req"] = e.req
                by_req.setdefault(e.req, []).append(e)
            if args:
                rec["args"] = args
            rid = (e.args or {}).get("rid")
            if rid is not None:
                rid_anchors.setdefault(str(rid), []).append(
                    (e.ts, pid, tids[e.track]))
            out.append(rec)
        for req, revs in by_req.items():
            revs = sorted(revs, key=lambda e: (e.ts, -ord(e.ph[0])))
            if len(revs) == 1:
                continue
            for i, e in enumerate(revs):
                ph = "s" if i == 0 else ("f" if i == len(revs) - 1
                                         else "t")
                flow = {"ph": ph, "pid": pid, "tid": tids[e.track],
                        "name": f"req{req}", "cat": "flow", "id": req,
                        "ts": us(e.ts)}
                if ph == "f":
                    flow["bp"] = "e"
                out.append(flow)

    # the cross-section flow: router decision -> replica submit ->
    # (migrate) -> peer submit, joined on the request's trace id
    for rid, anchors in rid_anchors.items():
        if len(anchors) < 2:
            continue
        anchors.sort()
        fid = zlib.crc32(rid.encode())
        for i, (ts, pid, tid) in enumerate(anchors):
            ph = "s" if i == 0 else ("f" if i == len(anchors) - 1
                                     else "t")
            flow = {"ph": ph, "pid": pid, "tid": tid,
                    "name": f"req:{rid}", "cat": "fleet_flow",
                    "id": fid, "ts": us(ts)}
            if ph == "f":
                flow["bp"] = "e"
            out.append(flow)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


# --------------------------------------------------------------- anomalies


class AnomalyMonitor:
    """Post-mortem dumper: on an anomaly, append the recorder's last
    `last_n` events plus a metrics snapshot to `path` (JSONL, one record
    per anomaly — crash-safe: each dump opens/fsyncs/closes).

    Triggers (all host-side, O(1) amortized per observation):
      * `observe_finish` — finish reason "timeout" or "cancelled";
      * `observe_reject` — `reject_burst` consecutive rejected
        submissions (one dump per burst; an accepted submission resets);
      * `observe_step` — a step exceeding `slow_step_factor` x the
        rolling median of the last `step_window` step durations (armed
        after `min_steps` observations so compile-warm steps don't trip
        it).

    Past `max_dumps` records the file ROTATES keep-newest: the oldest
    record is rewritten out to make room (atomic tmp + rename, same
    fsync discipline), and the first rotation warns once. A hard cap
    that silently dropped every LATER incident — which is what this
    class did before — buries exactly the dumps a live incident needs:
    the most recent ones. `dumps` counts every dump ever taken; the
    file holds the newest `max_dumps` of them.
    """

    def __init__(
        self,
        recorder: FlightRecorder,
        path: str,
        snapshot_fn: Callable[[], dict] | None = None,
        last_n: int = 256,
        slow_step_factor: float = 10.0,
        step_window: int = 128,
        min_steps: int = 16,
        reject_burst: int = 8,
        max_dumps: int = 64,
        timeseries_fn: Callable[[], dict] | None = None,
    ):
        if slow_step_factor <= 1.0:
            raise ValueError(
                f"slow_step_factor must be > 1, got {slow_step_factor}"
            )
        self.recorder = recorder
        self.path = path
        self.snapshot_fn = snapshot_fn
        # timeseries_fn() -> TimeSeriesStore.doc(): when bound, every
        # dump carries the rolling retrospective — the N-window "what
        # was the engine doing just before this" record
        self.timeseries_fn = timeseries_fn
        self.last_n = last_n
        self.slow_step_factor = slow_step_factor
        self.min_steps = min_steps
        self.reject_burst = reject_burst
        self.max_dumps = max_dumps
        self.dumps = 0
        self._rotation_warned = False
        self._steps: deque[float] = deque(maxlen=step_window)
        self._consec_rejects = 0
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    def observe_step(self, dur_s: float) -> None:
        if len(self._steps) >= self.min_steps:
            med = statistics.median(self._steps)
            if med > 0 and dur_s > self.slow_step_factor * med:
                self.dump("slow_step", step_s=dur_s, median_s=med,
                          factor=round(dur_s / med, 1))
        self._steps.append(dur_s)

    def observe_reject(self) -> None:
        self._consec_rejects += 1
        if self._consec_rejects == self.reject_burst:
            self.dump("reject_burst", consecutive=self._consec_rejects)

    def observe_accept(self) -> None:
        self._consec_rejects = 0

    def observe_finish(self, reason: str) -> None:
        if reason in ("timeout", "cancelled"):
            self.dump(f"finish_{reason}")

    def dump(self, kind: str, **detail) -> None:
        rec = {
            "kind": kind,
            "ts": self.recorder.clock(),
            "detail": detail,
            "metrics": self.snapshot_fn() if self.snapshot_fn else None,
            "events": [e.to_dict() for e in self.recorder.last(self.last_n)],
        }
        if self.timeseries_fn is not None:
            rec["timeseries"] = self.timeseries_fn()
        line = json.dumps(rec)
        if self.dumps < self.max_dumps:
            with open(self.path, "a") as f:
                f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())
        else:
            # keep-newest rotation: rewrite the file with the oldest
            # record dropped (atomic tmp + replace, so a crash mid-
            # rotation never truncates the JSONL). Anomalies are rare
            # and the file is bounded by max_dumps, so the rewrite cost
            # is noise next to the dump's own event serialization.
            if not self._rotation_warned:
                self._rotation_warned = True
                import warnings

                warnings.warn(
                    f"anomaly dump cap ({self.max_dumps}) reached at "
                    f"{self.path}: rotating keep-newest from here on "
                    "(oldest records drop out)",
                    RuntimeWarning, stacklevel=2,
                )
            try:
                with open(self.path) as f:
                    lines = f.read().splitlines()
            except OSError:
                lines = []
            lines = lines[-(self.max_dumps - 1):] if self.max_dumps > 1 \
                else []
            lines.append(line)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write("\n".join(lines) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        self.dumps += 1


# ---------------------------------------------------------------- summary

# lifecycle phases in timeline order; the spans partition a request's wall
# time (queue + prefill + decode == finish - submit) by construction
_PHASES = ("queue", "prefill", "decode")

# HTTP front-door phases (serve/api.py, cat "http") in timeline order:
# accept + parse + queue_handoff precede the engine's queue span and
# sse_drain follows its decode span — contiguous stamps on the same
# clock, so http phases + engine phases partition the server-observed
# e2e wall. Joined into per-request rows when present (a direct-submit
# trace summarizes without them).
_HTTP_PHASES = ("accept", "parse", "queue_handoff", "sse_drain")


def load_chrome(path: str) -> list[dict]:
    """Read a Chrome trace-event JSON ({"traceEvents": [...]} or a bare
    event array) back into a list of event dicts."""
    with open(path) as f:
        obj = json.load(f)
    if isinstance(obj, dict):
        return obj.get("traceEvents", [])
    if isinstance(obj, list):
        return obj
    raise ValueError(f"{path} is not a Chrome trace-event JSON")


def _as_events(trace) -> list[dict]:
    if isinstance(trace, str):
        return load_chrome(trace)
    if isinstance(trace, dict):
        return trace.get("traceEvents", [])
    return list(trace)


def summarize_trace(trace) -> dict:
    """Rebuild per-request timelines from an exported trace.

    `trace` is a path to a Chrome trace-event JSON, the loaded dict, or a
    list of event dicts. Returns::

        {
          "requests": [  # sorted by total_s descending
            {"req": id, "phases": {"queue": s, "prefill": s, "decode": s},
             "total_s": s, "finish_reason": str|None, "slot": str|None,
             "start_us": us, "tokens": int|None},
            ...
          ],
          "n_requests": N,
          "rejected": count,  # admission-control rejects (no timeline)
          "finish_reasons": {reason: count},
          "phase_totals_s": {phase: total seconds across requests},
        }

    Durations come from the request-category lifecycle spans the engine
    stamps from its own request timestamps, so per-request
    ``sum(phases) == finish_time - submit_time`` — the measured TTFT +
    decode wall time — up to export rounding (µs). Only requests with a
    lifecycle span or finish event get a timeline row: rejected
    submissions are tallied in ``rejected`` (they never held a lane, so
    a zero-phase row would read as a served request the ring lost), and
    bare ``submit`` instants (requests still in flight at export) are
    skipped."""
    events = _as_events(trace)

    reqs: dict[int, dict] = {}

    def entry(rid: int) -> dict:
        return reqs.setdefault(rid, {
            "req": rid, "phases": {}, "total_s": 0.0, "finish_reason": None,
            "slot": None, "start_us": None, "tokens": None,
        })

    rejected = 0
    disconnects = 0
    # http spans collected side-band and attached only to requests that
    # earn a timeline row below — an in-flight request's accept span
    # must not create a zero-phase row of its own
    http_spans: dict[int, dict] = {}
    for e in events:
        args = e.get("args") or {}
        rid = args.get("req")
        if rid is None:
            continue
        if e.get("cat") == "http":
            if e.get("ph") == "X" and e.get("name") in _HTTP_PHASES:
                d = http_spans.setdefault(rid, {})
                d[e["name"]] = (d.get(e["name"], 0.0)
                                + e.get("dur", 0.0) / 1e6)
            elif e.get("name") == "disconnect":
                disconnects += 1
            continue
        if e.get("cat") != "request":
            continue
        if e.get("name") == "reject":
            rejected += 1
            continue
        is_phase = e.get("ph") == "X" and e.get("name") in _PHASES
        if not (is_phase or e.get("name") == "finish"):
            continue  # e.g. a bare "submit" instant: still in flight
        r = entry(rid)
        ts = e.get("ts", 0.0)
        if r["start_us"] is None or ts < r["start_us"]:
            r["start_us"] = ts
        if is_phase:
            dur_s = e.get("dur", 0.0) / 1e6
            r["phases"][e["name"]] = r["phases"].get(e["name"], 0.0) + dur_s
            r["total_s"] += dur_s
            if "tokens" in args:
                r["tokens"] = args["tokens"]
        else:
            r["finish_reason"] = args.get("reason")

    # resolve slot names from thread metadata (tid -> track name)
    tid_names = {
        e.get("tid"): (e.get("args") or {}).get("name")
        for e in events
        if e.get("ph") == "M" and e.get("name") == "thread_name"
    }
    for e in events:
        args = e.get("args") or {}
        rid = args.get("req")
        if (rid is not None and e.get("cat") == "request"
                and e.get("ph") == "X" and e.get("name") in ("prefill",
                                                             "decode")):
            name = tid_names.get(e.get("tid"))
            if name and name.startswith("slot"):
                reqs[rid]["slot"] = name

    # join the http phases onto served requests: `e2e_s` is the end-to-
    # end wall (http + engine phases — the partition extended across the
    # HTTP boundary); engine-only rows keep total_s as their whole story
    http_totals = dict.fromkeys(_HTTP_PHASES, 0.0)
    any_http = False
    for rid, hp in http_spans.items():
        r = reqs.get(rid)
        if r is None:
            continue
        any_http = True
        r["http_phases"] = {k: hp[k] for k in _HTTP_PHASES if k in hp}
        r["e2e_s"] = r["total_s"] + sum(hp.values())
        for k, v in hp.items():
            http_totals[k] += v

    ordered = sorted(reqs.values(), key=lambda r: -r["total_s"])
    finish_reasons: dict[str, int] = {}
    phase_totals = dict.fromkeys(_PHASES, 0.0)
    for r in ordered:
        if r["finish_reason"]:
            finish_reasons[r["finish_reason"]] = (
                finish_reasons.get(r["finish_reason"], 0) + 1
            )
        for k, v in r["phases"].items():
            phase_totals[k] = phase_totals.get(k, 0.0) + v
    summary = {
        "requests": ordered,
        "n_requests": len(ordered),
        "rejected": rejected,
        "finish_reasons": finish_reasons,
        "phase_totals_s": phase_totals,
    }
    if any_http:
        # present IFF the trace holds front-door spans — a direct-submit
        # trace summarizes with the key ABSENT
        summary["http"] = {
            "phase_totals_s": http_totals,
            "disconnects": disconnects,
        }
    fleet = _fleet_section(events)
    if fleet is not None:
        # present IFF the trace holds fleet events (router spans or the
        # stitched export's manifest): a single-engine trace summarizes
        # with the key absent
        summary["fleet"] = fleet
    return summary


def _fleet_section(events: list[dict]) -> dict | None:
    """Rebuild the router's view from a stitched fleet export: the
    declared sections (from the ``fleet_manifest`` metadata record),
    per-replica served-request counts (finish events grouped by
    process), and the routing counters (route/reroute/migrate/drain
    spans, cat "fleet"). None when the trace holds neither a manifest
    nor fleet events — the backward-compat contract for every
    single-engine trace recorded before the fleet fabric existed.

    Raises ValueError on a PARTIAL export: the manifest declares
    sections whose process records are missing (someone sliced the
    stitched file, or an exporter died mid-write past the JSON layer)
    — summarizing half a fleet as the whole would be silent data loss.
    """
    declared: list | None = None
    pid_labels: dict[int, str] = {}
    for e in events:
        if e.get("ph") != "M":
            continue
        if e.get("name") == "fleet_manifest":
            declared = list((e.get("args") or {}).get("sections") or [])
        elif e.get("name") == "process_name":
            label = (e.get("args") or {}).get("name")
            if label is not None:
                pid_labels[e.get("pid")] = label
    routing = {"route": 0, "attempts": 0, "reroutes": 0,
               "migrations": 0, "drains": 0}
    drain_wall_s = 0.0
    migrate_wall_s = 0.0
    migrations: list[dict] = []
    any_fleet = False
    for e in events:
        if e.get("cat") != "fleet":
            continue
        any_fleet = True
        name = e.get("name")
        args = e.get("args") or {}
        if name == "route":
            routing["route"] += 1
            routing["attempts"] += int(args.get("attempts", 1))
        elif name == "reroute":
            routing["reroutes"] += 1
        elif name == "migrate":
            routing["migrations"] += 1
            migrate_wall_s += e.get("dur", 0.0) / 1e6
            migrations.append({
                "rid": args.get("rid"),
                "from": args.get("src"),
                "to": args.get("dst"),
            })
        elif name == "drain":
            routing["drains"] += 1
            drain_wall_s += e.get("dur", 0.0) / 1e6
    if declared is None and not any_fleet:
        return None
    if declared is not None:
        observed = set(pid_labels.values())
        missing = [s for s in declared if s not in observed]
        if missing:
            raise ValueError(
                f"partial fleet export: manifest declares sections "
                f"{declared} but the trace is missing {missing} — "
                "refusing to summarize a slice of the fleet as the "
                "whole")
    # served requests per replica process (finish events carry the
    # authoritative per-request outcome; pid 1 is the router section
    # in a stitched export and never stamps request-cat events)
    by_replica: dict[str, int] = {}
    for e in events:
        if e.get("cat") == "request" and e.get("name") == "finish":
            label = pid_labels.get(e.get("pid"))
            if label is not None:
                by_replica[label] = by_replica.get(label, 0) + 1
    out: dict = {"routing": routing}
    if declared is not None:
        out["sections"] = declared
    if by_replica:
        out["requests_by_replica"] = dict(sorted(by_replica.items()))
    if routing["drains"]:
        out["drain_wall_s"] = round(drain_wall_s, 6)
    if migrations:
        out["migrate_wall_s"] = round(migrate_wall_s, 6)
        out["migrations"] = migrations
    return out


def format_summary(summary: dict, top: int = 5) -> str:
    """Human-readable report for `cli trace-summary`: phase breakdown
    totals, then the `top` slowest requests with per-phase timings."""
    lines = [f"requests: {summary['n_requests']}"]
    if summary.get("rejected"):
        lines.append(f"rejected submissions: {summary['rejected']}")
    if summary["finish_reasons"]:
        reasons = ", ".join(
            f"{k}={v}" for k, v in sorted(summary["finish_reasons"].items())
        )
        lines.append(f"finish reasons: {reasons}")
    totals = summary["phase_totals_s"]
    grand = sum(totals.values())
    if grand > 0:
        parts = "  ".join(
            f"{k}={v:.4f}s ({100 * v / grand:.1f}%)"
            for k, v in totals.items()
        )
        lines.append(f"phase totals: {parts}")
    lines.append("")
    lines.append(f"slowest {min(top, summary['n_requests'])} requests "
                 "(total = queue + prefill + decode):")
    header = (f"  {'req':>6} {'total_s':>9} {'queue_s':>9} {'prefill_s':>9} "
              f"{'decode_s':>9} {'slot':>6}  reason")
    lines.append(header)
    for r in summary["requests"][:top]:
        ph = r["phases"]
        lines.append(
            f"  {r['req']:>6} {r['total_s']:>9.4f} "
            f"{ph.get('queue', 0.0):>9.4f} {ph.get('prefill', 0.0):>9.4f} "
            f"{ph.get('decode', 0.0):>9.4f} {str(r['slot'] or '-'):>6}  "
            f"{r['finish_reason'] or '-'}"
        )
    http = summary.get("http")
    if http:
        totals = http["phase_totals_s"]
        parts = "  ".join(f"{k}={totals[k]:.4f}s" for k in _HTTP_PHASES)
        lines.append("")
        lines.append(f"http front door: {parts}")
        if http.get("disconnects"):
            lines.append(f"  disconnects: {http['disconnects']}")
    fleet = format_fleet(summary.get("fleet"))
    if fleet:
        lines.append("")
        lines.append(fleet)
    return "\n".join(lines)


def format_fleet(fleet: dict | None) -> str:
    """Human-readable fleet report (the `fleet` section of
    `summarize_trace`), or "" when the trace held no fleet events."""
    if not fleet:
        return ""
    lines: list[str] = []
    sections = fleet.get("sections")
    if sections:
        lines.append(f"fleet: {len(sections)} sections "
                     f"({', '.join(sections)})")
    else:
        lines.append("fleet: router events present")
    r = fleet["routing"]
    lines.append(
        f"  routing: {r['route']} routed ({r['attempts']} attempts, "
        f"{r['reroutes']} reroutes)  drains={r['drains']}  "
        f"migrations={r['migrations']}"
    )
    by_rep = fleet.get("requests_by_replica")
    if by_rep:
        parts = "  ".join(f"{k}={v}" for k, v in by_rep.items())
        lines.append(f"  requests finished by replica: {parts}")
    if fleet.get("drain_wall_s") is not None:
        lines.append(f"  drain wall: {fleet['drain_wall_s']:.4f}s")
    for m in fleet.get("migrations") or []:
        lines.append(
            f"  migrated {m.get('rid')}: {m.get('from')} -> "
            f"{m.get('to')}"
        )
    return "\n".join(lines)
