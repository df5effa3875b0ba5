"""OpenAI-compatible HTTP front door over a live `ServeEngine` or a fleet
of them (port of `solvingpapers_tpu/serve/api.py`).

One stdlib `ThreadingHTTPServer` on a daemon thread (no dependencies)
exposes:

    POST /v1/completions        OpenAI completions, string or token-id
                                prompts, SSE streaming (`stream: true`)
    POST /v1/chat/completions   chat messages through a minimal template
    GET  /v1/models             the one hosted model
    GET  /v1/requests/<id>      one request's end-to-end timeline, or its
                                write-ahead journal record
    POST /v1/replay             replay a journal against a candidate
                                config in the background (serve/replay.py)
    GET  /v1/replay/<id>        that run's progress, then its report
    GET  /healthz /metrics /statusz /timeseriesz   the inspection surface,
                                on the same listener

Concurrency: the engine stays single-threaded. `EngineLoop` owns the
only thread that calls `engine.step()` and serializes `submit` /
`cancel` from handler threads behind one lock (a submit waits at most
one engine step). Tokens flow back lock-free: the request's `stream_cb`
fires on the engine thread and pushes a COUNT into the connection's
bounded queue; the handler thread wakes, reads the request's token list
(append-only, so a prefix read is safe), detokenizes the delta and
writes the SSE event. A slow reader fills its queue and events coalesce
(counts, not payloads), so no client can block the engine.

Cancellation is disconnect-driven: a broken pipe, or a half-closed
socket probed between events, maps to `engine.cancel`, freeing the slot
(and its pages) at the next block boundary; `timeout_s` maps to
`submit(deadline_s=)`. Admission pressure maps to HTTP: a full waiting
queue, too many open streams, an unhealthy engine or a degradation rung
that sheds the request's SLO class answers 503 with a jittered
Retry-After (its base grows with the rung, given in
X-Degradation-Rung); an invalid request answers 400 with the OpenAI
error envelope (`serve/openai.py`), never a traceback over a socket.
/healthz answers 200 "ok", 200 "degraded" on a ladder rung, and 503
"unhealthy" while the engine drains after persistent failures or when
its loop has died.

Stream resumption (serve/journal.py): every SSE chunk carries an
``id: <request id>:<token offset>`` field; a client that lost its
connection POSTs again with ``Last-Event-ID`` set to the last id it
saw, and the server replays the committed tokens past that offset and
re-attaches the connection to the live tail — from the in-process
registry, from the engine's recovered set after a crash and restart
(`ServeEngine.recover`), or from the journal's record of a finished
stream. The client's `X-Request-Id` (honored when sane, else minted) is
the journal id, echoed on the response.

Request tracing: with the engine's flight recorder on, the front door
records its phases on an "http" track — `accept` (headers -> body
read), `parse` (body -> validated), `queue_handoff` (validated ->
engine submit), `sse_drain` (engine finish -> last byte written) and
`disconnect` instants — contiguous stamps on the engine's clock, so
with the engine's queue + prefill + decode they partition the
server-observed wall. `GET /v1/requests/<id>` assembles the same
timeline from a bounded registry, with or without the recorder.

Fleet mode (`ApiServer(router=...)`, serve/fleet.py): admissions route
through the `FleetRouter` (prefix affinity, SLO burn, load, with ranked
retry on a full replica); responses carry ``X-Replica-Id`` (and
``X-Fleet-Reroutes`` after a retry); /healthz is the router's view,
/metrics one merged unlabelled set plus one ``replica="rN"`` set a
replica, /statusz gains a ``fleet`` section. A drain closes a
"migrated" SSE stream WITHOUT its terminal chunk (the client's signal to
reconnect with its Last-Event-ID, which resolves on the adopting peer),
a blocking request rides the migration inside its one POST, and `GET
/v1/requests/<id>` stitches the hops. Replica 0's engine stays the
config, vocabulary and fault-plane source.

Replay (serve/replay.py): `POST /v1/replay` re-serves a journal (the
server's own by default) on a FRESH engine over the live engine's
weights, one run at a time, in the background; the runs are kept in a
bounded registry, and the last finished run's `replay/*` gauges ride
/metrics.

Shutdown (`ApiServer.close`, idempotent): refuse new work (503), drain
active streams up to `drain_timeout_s` then cancel the rest, stop the
engine loop, `engine.close()`, then the HTTP threads — so no handler
ever touches a closed engine.
"""

from __future__ import annotations

import json
import queue
import random
import re
import select
import socket
import threading
import time
import traceback
import uuid
from collections import OrderedDict
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from solvingpapers_tpu_torch.metrics.http import healthz_response
from solvingpapers_tpu_torch.metrics.writer import PrometheusTextWriter
from solvingpapers_tpu_torch.serve import metrics as smetrics
from solvingpapers_tpu_torch.serve import openai as oai
from solvingpapers_tpu_torch.serve.engine import check_drafter, weak_method
from solvingpapers_tpu_torch.serve.grammar import JsonStepper
from solvingpapers_tpu_torch.serve.openai import ApiError
from solvingpapers_tpu_torch.serve.scheduler import ACTIVE

# client-supplied X-Request-Id values honored: short, printable, safe to
# echo into headers and JSON verbatim; anything else gets a minted id
_RID_RE = re.compile(r"^[A-Za-z0-9._:-]{1,128}$")


class EngineLoop:
    """The engine's one stepping thread and the submit/cancel gateway.

    Every engine interaction from a handler thread goes through
    `self.lock`; the loop holds it across each `step()`, so the engine
    never sees concurrent mutation. Idle, it parks on an event that
    `submit` sets (no busy-spin)."""

    def __init__(self, engine, start: bool = True):
        self.engine = engine
        self.lock = threading.RLock()
        self._waiters = 0
        self._waiter_lock = threading.Lock()  # += is not atomic
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="engine-loop",
                                        daemon=True)
        if start:
            self._thread.start()

    @contextmanager
    def held(self):
        """The step lock, taken as a waiter: the loop hands it over after
        its current step instead of taking it straight back (a bare
        ``with loop.lock`` on a started loop can starve). Yields the
        engine, which no step mutates until the block ends."""
        with self._waiter_lock:
            self._waiters += 1
        try:
            with self.lock:
                yield self.engine
        finally:
            with self._waiter_lock:
                self._waiters -= 1

    def _locked(self, fn):
        """Run an engine call under the step lock (`held`)."""
        with self.held():
            return fn()

    def submit(self, *args, **kwargs):
        if self.error is not None:
            raise RuntimeError(f"engine loop died: {type(self.error).__name__}: "
                               f"{self.error}")
        req = self._locked(lambda: self.engine.submit(*args, **kwargs))
        self._wake.set()
        return req

    def cancel(self, req) -> None:
        # an ACTIVE request's cancel is one flag write the engine reads at
        # the next block boundary: taking the step lock here would make a
        # disconnect wait out the stream (the loop re-wins its lock back
        # to back). The bare flag is safe in every state (a preempted then
        # resumed stream cancels at its next block boundary, a finished
        # one ignores it). A WAITING request needs the lock for the queue
        # removal; if it races to ACTIVE, the locked engine.cancel
        # re-checks and writes the same flag.
        if req.state == ACTIVE:
            req.cancelled = True
        else:
            self._locked(lambda: self.engine.cancel(req))
        self._wake.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                with self.lock:
                    busy = self.engine.has_work()
                    if busy:
                        self.engine.step()
            except BaseException as e:  # noqa: BLE001 — must not die mute
                self._fail(e)
                return
            if self._waiters:
                # hand the lock over: without a yield this thread takes it
                # back before a parked submitter is ever scheduled
                time.sleep(0.001)
            elif not busy:
                self._wake.wait(0.05)
                self._wake.clear()

    def _fail(self, exc: BaseException) -> None:
        """A step() raised: the engine may be inconsistent, so the loop
        stops driving it. Record the error (new submissions fail fast,
        /healthz turns 503) and finish every in-flight request host-side
        with reason "error", so each connection gets its terminal event."""
        self.error = exc
        traceback.print_exception(type(exc), exc, exc.__traceback__)
        with self.lock:
            inflight = [r for r in self.engine._slot_req if r is not None]
            inflight += list(self.engine.scheduler.queue)
            now = time.monotonic()
            for r in inflight:
                r.state = "finished"
                r.finish_reason = "error"
                r.finish_time = now
                cb = r.stream_cb
                if cb is not None:
                    try:
                        cb(r, 0, True)
                    except Exception:  # noqa: BLE001
                        pass

    def close(self, drain_timeout_s: float = 0.0) -> None:
        """Stop the loop; with a drain timeout, let in-flight work finish
        first, then cancel whatever remains so every lane comes back.
        Bounded end to end: the cancel drain is capped in steps and wall
        time, and anything still in flight past the cap is finished
        host-side by `engine.force_drain` (no further device work)."""
        if not self._thread.is_alive():
            return
        deadline = time.monotonic() + drain_timeout_s
        while time.monotonic() < deadline:
            with self.lock:
                if not self.engine.has_work():
                    break
            time.sleep(0.01)
        with self.lock:
            for r in list(self.engine._slot_req):
                if r is not None:
                    self.engine.cancel(r)
            for r in list(self.engine.scheduler.queue):
                self.engine.cancel(r)
            steps = 0
            cancel_deadline = time.monotonic() + min(5.0, max(1.0,
                                                              drain_timeout_s))
            while (self.engine.has_work() and steps < 64
                   and time.monotonic() < cancel_deadline):
                self.engine.step()
                steps += 1
            if self.engine.has_work():
                self.engine.force_drain("cancelled")
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5)


class _Stream:
    """Per-connection bridge from the engine's stream_cb to a handler
    thread: a bounded queue of (n_new, finished) counts. A full queue
    coalesces (the reader catches up from the request's token list); the
    terminal event always lands (a slot is drained to make room)."""

    # events carry counts, so a slow reader never blocks the engine
    # thread: past this many pending events they coalesce
    MAXSIZE = 256

    def __init__(self):
        self.q: queue.Queue = queue.Queue(maxsize=self.MAXSIZE)

    def __call__(self, req, n_new: int, finished: bool) -> None:
        try:
            self.q.put_nowait((n_new, finished))
        except queue.Full:
            if finished:
                try:
                    self.q.get_nowait()
                except queue.Empty:
                    pass
                self.q.put_nowait((n_new, finished))


class ApiServer:
    """The front door: binds `engine.config.api_host:api_port` and serves
    the OpenAI surface and the status endpoints over one listener.

    `decode` (ids -> text) renders streamed text and backs json_object
    mode's token table; `encode` (text -> ids) admits string prompts —
    without it only token-id prompts are accepted. `token_table` (id ->
    string list) skips the per-id decode probe when the caller already
    built one (`cli serve` does). `loop` lets tests inject an unstarted
    `EngineLoop`; by default the server owns one. `router` (a
    `serve.fleet.FleetRouter`) puts the server in fleet mode: replica 0's
    engine and loop stand in for `engine` and `loop`.
    """

    # request timelines kept for GET /v1/requests/<id>: a debug surface,
    # so bounded and evict-oldest; a client re-using an id overwrites
    # the older entry (last wins)
    timeline_cap = 1024
    # replay runs kept for GET /v1/replay/<id>, bounded the same way (each
    # record holds a full divergence report)
    replay_cap = 16

    def __init__(self, engine=None, *, encode=None, decode=None,
                 token_table=None, model_name: str = "solvingpapers",
                 loop=None, router=None):
        self.router = router
        if router is not None:
            engine = engine if engine is not None else router.replicas[0].engine
            loop = loop if loop is not None else router.replicas[0].loop
        if engine is None:
            raise ValueError("ApiServer needs an engine or a router")
        cfg = engine.config
        self.engine = engine
        self.encode = encode
        self.decode = decode
        self.model_name = model_name
        self.loop = loop if loop is not None else EngineLoop(engine)
        self.closing = threading.Event()
        self._closed = False
        self._active = 0  # streams currently open
        self._counts = {"requests": 0, "streams": 0, "disconnects": 0,
                        "rejected": 0, "client_errors": 0}
        self._count_lock = threading.Lock()
        # jittered Retry-After: a fixed hint would bring every rejected
        # client back in one burst (seeded for reproducible tests)
        self._retry_rng = random.Random(0xFA17)
        self._retry_lock = threading.Lock()
        self._timelines: OrderedDict[str, dict] = OrderedDict()
        self._timeline_lock = threading.Lock()
        # the replay registry: one run in flight at a time (each builds an
        # engine and a pool of its own), and the replay/* gauges of the
        # last finished run ({} until one has run)
        self._replays: OrderedDict[str, dict] = OrderedDict()
        self._replay_lock = threading.Lock()
        self._replay_active = False
        self._replay_gauge_vals: dict[str, float] = {}
        self.vocab_size = engine.model.cfg.vocab_size
        # token table for grammar mode: caller-supplied, or derived by
        # decoding each id once (None = outside the detokenizer's range)
        self.token_table = list(token_table) if token_table else None
        if self.token_table is None and decode is not None \
                and self.vocab_size < (1 << 20):
            table = []
            for i in range(self.vocab_size):
                try:
                    table.append(decode([i]))
                except Exception:  # noqa: BLE001 — any decode failure
                    table.append(None)
            self.token_table = table
        # allowed-set memo shared by every request's stepper: all run over
        # the one token table, so state-keyed entries hold across requests
        self._grammar_cache: dict = {}
        self._grammar_err = None
        if cfg.json_mode and self.token_table is not None:
            try:
                JsonStepper(self.token_table)  # vocabulary viability
            except ValueError as e:
                self._grammar_err = str(e)
        elif cfg.json_mode:
            self._grammar_err = ("json_object mode needs the server "
                                 "constructed with a `decode` callable "
                                 "(token table)")
        # weak: the engine's metrics and the HTTP server's handler class
        # must not keep this server, and with it the engine, alive
        engine.metrics.add_gauge_provider(weak_method(self._gauges, {}))
        get, post = weak_method(self._get), weak_method(self._post)

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.0 close-delimited framing: SSE bodies end when the
            # connection does, no chunked encoding needed
            def log_message(self, fmt, *args):  # noqa: A003
                pass

            def do_GET(self):  # noqa: N802
                get(self)

            def do_POST(self):  # noqa: N802
                post(self)

        self._httpd = ThreadingHTTPServer((cfg.api_host, cfg.api_port or 0),
                                          Handler)
        self._httpd.daemon_threads = True
        self.host = cfg.api_host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="api-http", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ plumbing

    def url(self, path: str = "") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def _gauges(self) -> dict:
        c = self._counts
        return {
            "serve/http_connections": float(self._active),
            "serve/http_requests": float(c["requests"]),
            "serve/http_streams": float(c["streams"]),
            "serve/http_disconnects": float(c["disconnects"]),
            "serve/http_rejected": float(c["rejected"]),
            "serve/http_client_errors": float(c["client_errors"]),
            **self._replay_gauge_vals,
        }

    def _bump(self, key: str, delta: int = 1) -> None:
        with self._count_lock:
            self._counts[key] += delta

    def _bump_active(self, delta: int) -> None:
        with self._count_lock:
            self._active += delta

    @staticmethod
    def _send(h, code: int, body: str, ctype: str,
              headers: dict | None = None) -> None:
        data = body.encode()
        h.send_response(code)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            h.send_header(k, v)
        h.end_headers()
        h.wfile.write(data)

    def _send_json(self, h, code: int, obj: dict,
                   headers: dict | None = None) -> None:
        self._send(h, code, json.dumps(obj) + "\n", "application/json",
                   headers)

    def _retry_headers(self) -> dict:
        """Backpressure headers for every 503: a JITTERED Retry-After
        (integer seconds, its base growing with the degradation rung) and
        the rung itself."""
        src = self.router if self.router is not None else self.engine
        rung = src.degradation_rung
        with self._retry_lock:
            retry = self._retry_rng.randint(1 + rung, 4 + rung)
        return {"Retry-After": str(retry), "X-Degradation-Rung": str(rung)}

    def _engines(self) -> list:
        """Every engine behind this door: after a drain, a stream's record
        lives on a peer replica."""
        if self.router is not None:
            return [r.engine for r in self.router.replicas]
        return [self.engine]

    def _find_recovered(self, rid: str):
        """The recovered or adopted Request for `rid` on any replica, or
        None. Where a drained replica's "migrated" husk and a peer's
        adopted request share the id, the adopted one wins: its token list
        is the stream."""
        best = None
        for eng in self._engines():
            req = eng._recovered.get(rid)
            if req is None:
                continue
            if req.finish_reason != "migrated":
                return req
            best = best or req
        return best

    def _journal_lookup(self, rid: str):
        """The best journal record of `rid` across the engines: a live
        entry anywhere wins; among finished ones, a real outcome beats a
        drained replica's "migrated" record. None without a journal, or
        when aged out."""
        best = None
        for eng in self._engines():
            entry = None if eng.journal is None else eng.journal.lookup(rid)
            if entry is None:
                continue
            if not entry.finished:
                return entry
            if best is None or (best.finish_reason == "migrated"
                                and entry.finish_reason != "migrated"):
                best = entry
        return best

    def _loop_for(self, req):
        """The loop that owns `req`: the router's owner in fleet mode (a
        migrated stream's cancel must land on the replica decoding it)."""
        if self.router is not None:
            return self.router.owner_loop(req)
        return self.loop

    def _send_error(self, h, err: ApiError, headers: dict | None = None) -> None:
        self._bump("rejected" if err.status == 503 else "client_errors")
        headers = dict(headers or {})
        if err.status == 503:
            headers.update(self._retry_headers())
        try:
            self._send_json(h, err.status, err.body(), headers)
        except (BrokenPipeError, ConnectionResetError):
            pass

    # ------------------------------------------------------------- routes

    def _get(self, h) -> None:
        path = h.path.split("?", 1)[0]
        try:
            if path == "/healthz":
                # the engine's health state machine through the status
                # endpoint's own mapping; a dead loop is unhealthy. A fleet
                # serves the router's view: healthy while any admitting
                # replica is
                if self.router is not None:
                    state = self.router.health
                else:
                    state = ("unhealthy" if self.loop.error is not None
                             else self.engine.health)
                code, body = healthz_response(state)
                self._send(h, code, body, "text/plain")
            elif path == "/metrics":
                if self.router is not None:
                    # one merged unlabelled set, one replica="rN" set each
                    text = PrometheusTextWriter.render_sets(
                        self.router.prom_sets())
                else:
                    with self.loop.lock:
                        step, snap = (self.engine._step_idx,
                                      self.engine.metrics.prom_snapshot())
                    text = PrometheusTextWriter.render(step, snap)
                self._send(h, 200, text, "text/plain; version=0.0.4")
            elif path == "/statusz":
                with self.loop.lock:
                    doc = self.engine.statusz()
                if self.router is not None:
                    # replica 0's document stays the backbone; the fleet
                    # section adds every replica's facts and the routing
                    doc["fleet"] = self.router.statusz()
                self._send_json(h, 200, doc)
            elif path == "/timeseriesz":
                if self.router is not None:
                    self._send_json(h, 200, self.router.timeseriesz())
                elif self.engine.timeseries is not None:
                    self._send_json(h, 200, self.engine.timeseries.doc())
                else:
                    self._send(h, 404, "no time-series store (run with "
                               "timeseries enabled)\n", "text/plain")
            elif path == "/v1/models":
                self._send_json(h, 200, {
                    "object": "list",
                    "data": [{"id": self.model_name, "object": "model",
                              "owned_by": "local"}],
                })
            elif path.startswith("/v1/requests/"):
                self._request_status(h, path[len("/v1/requests/"):])
            elif path.startswith("/v1/replay/"):
                self._replay_status(h, path[len("/v1/replay/"):])
            else:
                self._send(h, 404, "not found\n", "text/plain")
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001 — a handler must not die
            try:
                self._send(h, 500, f"{type(e).__name__}: {e}\n", "text/plain")
            except (BrokenPipeError, ConnectionResetError):
                pass

    def _request_status(self, h, rid: str) -> None:
        """GET /v1/requests/<id>: the request's end-to-end timeline (HTTP
        phases and engine lifecycle phases, which partition the
        server-observed wall) and its SLO verdict; past the registry, or
        for a request of an earlier process, the journal's record."""
        with self._timeline_lock:
            rec = self._timelines.get(rid)
        if rec is None:
            doc = self._journal_timeline(rid)
            if doc is not None:
                self._send_json(h, 200, doc, {"X-Request-Id": rid})
                return
            self._send_json(h, 404, {"error": {
                "message": f"no timeline for request id {rid!r} (unknown, "
                           f"evicted past the last {self.timeline_cap} "
                           "requests with no journal record, or aged out of "
                           "the journal's finished window)",
                "type": "invalid_request_error", "param": None,
                "code": "request_not_found",
            }})
            return
        self._send_json(h, 200, self._assemble_timeline(rec),
                        {"X-Request-Id": rid})

    def _journal_timeline(self, rid: str) -> dict | None:
        """`GET /v1/requests/<id>` from the journal alone, marked
        ``source: "journal"``: no HTTP phases (the connection may predate
        this process), but the durable facts — sizes, the committed token
        ids, outcome, usage."""
        entry = self._journal_lookup(rid)
        if entry is None:
            return None
        recovered = self._find_recovered(rid) is not None
        if entry.finished:
            state = "finished"
        elif recovered:
            state = "active"
        else:
            state = "journaled"
        return {
            "request_id": rid,
            "source": "journal",
            "state": state,
            "recovered": recovered,
            "finish_reason": entry.finish_reason,
            "tokens": list(entry.tokens),
            "usage": entry.usage,
            "facts": {
                "prompt_tokens": len(entry.prompt),
                "completion_tokens": len(entry.tokens),
                "grammar": entry.grammar,
            },
        }

    # ---------------------------------------------------------- replay

    def _post_replay(self, h) -> None:
        """POST /v1/replay: start a background replay of a journal against
        a candidate config (serve/replay.py) on a FRESH engine over the
        live engine's weights; the live engine is never touched. Body:
        ``journal`` (default: this server's own journal), ``config_overrides``
        (ServeConfig field -> value), ``max_requests`` (default 256),
        ``cut_stride``, ``pace``. One run at a time (409 otherwise); 202
        with the run's id, then poll GET /v1/replay/<id>."""
        from solvingpapers_tpu_torch.serve import replay as replay_mod

        try:
            body = self._read_body(h)
            journal = body.get("journal") or self.engine.config.journal_path
            if not journal:
                raise ApiError("no journal to replay: pass 'journal' (a path "
                               "this server can read) or serve with --journal",
                               param="journal")
            overrides = body.get("config_overrides") or {}
            if not isinstance(overrides, dict):
                raise ApiError("config_overrides must be an object",
                               param="config_overrides")
            try:
                candidate = replay_mod.apply_overrides(self.engine.config,
                                                       dict(overrides))
                # the engine's drafter checks, before a run is accepted
                check_drafter(getattr(self.engine.model, "cfg", None),
                              candidate)
            except (ValueError, TypeError) as e:
                raise ApiError(str(e), param="config_overrides") from None
            max_requests = int(body.get("max_requests", 256))
            cut_stride = int(body.get("cut_stride", 8))
            pace = bool(body.get("pace", False))
        except ApiError as e:
            self._send_error(h, e)
            return
        with self._replay_lock:
            if self._replay_active:
                self._send_json(h, 409, {"error": {
                    "message": "a replay run is already in flight: poll it "
                               "to completion first",
                    "type": "invalid_request_error", "param": None,
                    "code": "replay_in_flight",
                }})
                return
            self._replay_active = True
            run_id = uuid.uuid4().hex[:12]
            rec = {"id": run_id, "state": "running",
                   "progress": {"done": 0, "total": 1}, "journal": journal,
                   "config_overrides": overrides, "report": None,
                   "error": None}
            self._replays[run_id] = rec
            while len(self._replays) > self.replay_cap:
                self._replays.popitem(last=False)
        harness = replay_mod.ReplayHarness.from_engine(self.engine)

        def work():
            try:
                entries = harness.load(journal)

                def prog(done, total):
                    rec["progress"] = {"done": done, "total": total}

                # grad mode is per thread: this one computes under no_grad
                with torch.no_grad():
                    rec["report"] = harness.run(
                        entries, candidate, cut_stride=cut_stride,
                        max_requests=max_requests, pace=pace,
                        journal_path=journal, progress=prog)
                rec["state"] = "finished"
                # the replay/* gauges ride the LIVE engine's /metrics
                self._replay_gauge_vals = replay_mod.report_gauges(
                    rec["report"])
            except Exception as e:  # noqa: BLE001 — surfaced through GET
                rec["error"] = f"{type(e).__name__}: {e}"
                rec["state"] = "error"
            finally:
                with self._replay_lock:
                    self._replay_active = False

        threading.Thread(target=work, name="replay", daemon=True).start()
        self._send_json(h, 202, {"id": run_id, "state": "running"},
                        {"Location": f"/v1/replay/{run_id}"})

    def _replay_status(self, h, run_id: str) -> None:
        """GET /v1/replay/<id>: state and progress while running, the
        report once finished, the error on failure; an evicted run 404s."""
        with self._replay_lock:
            rec = self._replays.get(run_id)
            doc = dict(rec) if rec is not None else None
        if doc is None:
            self._send_json(h, 404, {"error": {
                "message": f"no replay run {run_id!r} (unknown or evicted "
                           f"past the last {self.replay_cap} runs)",
                "type": "invalid_request_error", "param": None,
                "code": "replay_not_found",
            }})
            return
        self._send_json(h, 200, doc)

    @staticmethod
    def _hop_phases(req) -> dict[str, float]:
        """One hop's engine phases from its Request stamps: queue, prefill
        and decode up to ITS finish (a migrated husk finishes at the
        drain). A hop admitted but frozen before its first token spent its
        admitted life in prefill."""
        ph: dict[str, float] = {}
        if req.admit_time is not None:
            ph["queue"] = req.admit_time - req.submit_time
            if req.first_token_time is not None:
                ph["prefill"] = req.first_token_time - req.admit_time
                if req.finish_time is not None:
                    ph["decode"] = req.finish_time - req.first_token_time
            elif req.finish_time is not None:
                ph["prefill"] = req.finish_time - req.admit_time
        elif req.finish_time is not None:
            ph["queue"] = req.finish_time - req.submit_time
        return ph

    def _assemble_timeline(self, rec: dict) -> dict:
        """One JSON timeline from the HTTP record and the Request's own
        timestamps. The phases are adjacent intervals — accept -> parse ->
        [route] -> queue_handoff -> queue -> prefill -> decode -> [migrate
        -> peer_queue -> peer_prefill -> peer_decode ...] -> sse_drain —
        so their sum equals the server-observed wall to the clock's
        resolution; an in-flight request reports the phases it has
        reached. In a fleet, `route` is the router's ranking and retry
        wall, carved out of the handoff it happens in, and after a drain
        every hop stays: the drained replica's phases up to its
        "migrated" finish (the husks in ``rec["hops"]``), the migration
        gap, then the adopter's as peer_*."""
        req = rec["req"]
        hops = rec.get("hops") or []
        chain = [hp["req"] for hp in hops] + [req]
        req0 = chain[0]
        cfg = self.engine.config
        phases: dict[str, float] = {
            "accept": rec["t_body"] - rec["t_accept"],
            "parse": rec["t_parsed"] - rec["t_body"],
        }
        handoff = max(req0.submit_time - rec["t_parsed"], 0.0)
        route_s = min(max(getattr(req0, "fleet_route_s", 0.0), 0.0), handoff)
        if route_s > 0:
            phases["route"] = route_s
        phases["queue_handoff"] = handoff - route_s
        if not hops:
            if req.admit_time is not None:
                phases["queue"] = req.admit_time - req.submit_time
                if req.first_token_time is not None:
                    phases["prefill"] = req.first_token_time - req.admit_time
                    if req.finish_time is not None:
                        phases["decode"] = (req.finish_time
                                            - req.first_token_time)
            elif req.finish_time is not None:
                # never admitted: its whole engine life was queue time
                phases["queue"] = req.finish_time - req.submit_time
        else:
            phases.update(self._hop_phases(req0))
        for prev, nxt in zip(chain, chain[1:]):
            if prev.finish_time is not None:
                phases["migrate"] = (phases.get("migrate", 0.0)
                                     + max(nxt.submit_time - prev.finish_time,
                                           0.0))
            for k, v in self._hop_phases(nxt).items():
                phases[f"peer_{k}"] = phases.get(f"peer_{k}", 0.0) + v
        if rec["t_done"] is not None and req.finish_time is not None:
            phases["sse_drain"] = max(rec["t_done"] - req.finish_time, 0.0)
        phases = {k: round(v, 6) for k, v in phases.items()}
        facts: dict = {"prompt_tokens": int(req.prompt.size),
                       "completion_tokens": len(req.tokens),
                       "kv_quant": cfg.kv_quant,
                       "kv_exact": bool(req.params.kv_exact)}
        if cfg.speculative is not None:
            facts["spec"] = {
                "drafter": cfg.speculative,
                "proposed": req.spec_proposed,
                "accepted": req.spec_accepted,
                "rate": round(req.spec_accepted / req.spec_proposed, 4)
                if req.spec_proposed else None,
            }
        if cfg.paged:
            facts["pages_held"] = req.pages_held
            facts["page_size"] = self.engine.pool.page_size
        doc = {
            "request_id": rec["trace_id"],
            "engine_req": req.id,
            "kind": "chat" if rec["chat"] else "completion",
            "stream": rec["stream"],
            "state": req.state,
            "finish_reason": req.finish_reason,
            "disconnected": rec["disconnected"],
            "phases": phases,
            "phase_sum_s": round(sum(phases.values()), 6),
            "e2e_s": (round(rec["t_done"] - rec["t_accept"], 6)
                      if rec["t_done"] is not None else None),
            "facts": facts,
        }
        if req.slo_result is not None:
            doc["slo"] = req.slo_result
        elif cfg.slo_targets is not None:
            # in flight (or an excluded finish): class known, no verdict
            doc["slo"] = {"class": self.engine._slo.classify(req),
                          "attained": None}
        if self.router is not None:
            # which replica served it, how many refused first, and every
            # hop a drain moved it along
            doc["fleet"] = {
                "replica": rec.get("replica"),
                "reroutes": int(rec.get("reroutes") or 0),
                "migrated": bool(hops),
                "hops": [{"replica": hp.get("replica"),
                          "engine_req": hp["req"].id,
                          "finish_reason": hp["req"].finish_reason}
                         for hp in hops]
                + [{"replica": rec.get("replica"), "engine_req": req.id,
                    "finish_reason": req.finish_reason}],
            }
        return doc

    def _post(self, h) -> None:
        # the accept boundary: first stamp after the request line and the
        # headers were parsed
        t_accept = smetrics.now()
        path = h.path.split("?", 1)[0]
        if path == "/v1/replay":
            self._post_replay(h)
            return
        chat = path == "/v1/chat/completions"
        if not chat and path != "/v1/completions":
            self._send(h, 404, "not found\n", "text/plain")
            return
        self._bump("requests")
        # a reconnect presents the last SSE event id it saw instead of a
        # new job: replay the committed tokens past it and re-attach
        lei = (h.headers.get("Last-Event-ID") or "").strip()
        if lei:
            try:
                self._drain_body(h)
                self._resume_stream(h, lei, chat)
            except ApiError as e:
                self._send_error(h, e)
            except (BrokenPipeError, ConnectionResetError):
                self._bump("disconnects")
            except Exception as e:  # noqa: BLE001
                try:
                    self._send_json(h, 500, {"error": {
                        "message": f"{type(e).__name__}: {e}",
                        "type": "internal_error", "param": None, "code": None,
                    }})
                except (BrokenPipeError, ConnectionResetError):
                    pass
            return
        # honor the client's X-Request-Id (sane values only), else mint one
        rid_in = (h.headers.get("X-Request-Id") or "").strip()
        trace_id = rid_in if _RID_RE.match(rid_in) else uuid.uuid4().hex
        rid_headers = {"X-Request-Id": trace_id}
        try:
            body = self._read_body(h)
            t_body = smetrics.now()
            self._serve_completion(h, body, chat=chat, trace_id=trace_id,
                                   t_accept=t_accept, t_body=t_body)
        except ApiError as e:
            self._send_error(h, e, headers=rid_headers)
        except (BrokenPipeError, ConnectionResetError):
            self._bump("disconnects")
        except Exception as e:  # noqa: BLE001
            try:
                self._send_json(h, 500, {"error": {
                    "message": f"{type(e).__name__}: {e}",
                    "type": "internal_error", "param": None, "code": None,
                }}, rid_headers)
            except (BrokenPipeError, ConnectionResetError):
                pass

    @staticmethod
    def _check_resume_offset(offset: int, committed: int, rid: str) -> None:
        """A resume offset past the committed prefix is a 409, not a
        clamp: fsync batches a step, so after a hard crash a client can
        hold tokens the journal never made durable, and replaying from a
        clamp would hand it that span twice with no signal."""
        if offset > committed:
            raise ApiError(
                f"Last-Event-ID offset {offset} exceeds the {committed} "
                f"committed token(s) recoverable for request {rid!r}: the "
                "tail past the last durable commit was lost with the crash; "
                "resume from within the committed prefix or restart the "
                "stream", status=409, code="resume_offset_beyond_committed")

    def _sse_open(self, h, trace_id: str, replica: str | None = None,
                  reroutes: int = 0):
        """Send the SSE response headers and return THE event writer (one
        framing for live streams, re-attached resumes and journal-only
        replays): each event is an optional ``id: <trace_id>:<offset>``
        resume cursor and a ``data:`` line, and the fault plane's
        ``sse_write`` site pokes once an event. A fleet adds
        ``X-Replica-Id`` and, after a retry, ``X-Fleet-Reroutes``."""
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.send_header("X-Request-Id", trace_id)
        if replica is not None:
            h.send_header("X-Replica-Id", replica)
        if reroutes:
            h.send_header("X-Fleet-Reroutes", str(reroutes))
        h.end_headers()
        engine = self.engine

        def event(obj, eid: int | None = None) -> None:
            faults = engine._faults
            if faults is not None:
                for spec in faults.poke("sse_write"):
                    engine.metrics.record_fault_injected()
                    if engine.trace is not None:
                        engine.trace.instant("fault_injected", "engine",
                                             "http", site="sse_write",
                                             kind=spec.kind, slot=spec.slot)
                    if spec.kind == "socket_reset":
                        raise ConnectionResetError(
                            "injected socket reset at sse_write")
                    if spec.kind == "stall":
                        time.sleep(spec.stall_s)
            payload = b""
            if eid is not None:
                payload += f"id: {trace_id}:{eid}\n".encode()
            payload += b"data: " + json.dumps(obj).encode() + b"\n\n"
            h.wfile.write(payload)
            h.wfile.flush()

        return event

    @staticmethod
    def _drain_body(h) -> None:
        """Read and discard a resume's request body (it needs only the
        Last-Event-ID header, but the bytes must leave the socket)."""
        try:
            n = int(h.headers.get("Content-Length", 0))
        except ValueError:
            n = 0
        if 0 < n <= (8 << 20):
            h.rfile.read(n)

    def _resume_stream(self, h, lei: str, chat: bool) -> None:
        """Resume a stream from its last delivered SSE event id,
        ``<request id>:<token offset>``. Sources, in order: the live
        registry, the engine's recovered set (after `recover()`), then the
        journal's record of a finished stream. Committed tokens past the
        offset replay at once; a live request re-attaches this connection
        to its tail (the previous connection's bridge is abandoned: the
        last reconnect wins)."""
        rid, _, off_s = lei.rpartition(":")
        # ASCII digits only: str.isdigit() takes Unicode digits int() refuses
        if not rid or not (off_s.isascii() and off_s.isdigit()):
            raise ApiError(
                f"malformed Last-Event-ID {lei!r}: expected \"<request "
                "id>:<token offset>\" as stamped on the stream's id: fields",
                param="Last-Event-ID")
        offset = int(off_s)
        with self._timeline_lock:
            rec = self._timelines.get(rid)
        req = rec["req"] if rec is not None else None
        if req is None:
            req = self._find_recovered(rid)
        if (req is not None and req.finish_reason == "migrated"
                and self.router is not None):
            # the registry holds the DRAINED replica's husk; the peer's
            # adopted request (same id, same committed prefix) is the
            # stream the cursor belongs to
            adopted = self._find_recovered(rid)
            if adopted is not None and adopted is not req:
                if rec is not None:
                    # the husk's phases are the first leg of the trail
                    rec.setdefault("hops", []).append(
                        {"req": req, "replica": rec.get("replica")})
                    rec["req"] = adopted
                req = adopted
        if req is not None:
            self._check_resume_offset(offset, len(req.tokens), rid)
            owner = self.router.owner(rid) if self.router is not None else None
            if rec is not None and owner is not None:
                rec["replica"] = owner.rid
            now = smetrics.now()
            new_rec = {"trace_id": rid, "req": req, "chat": chat,
                       "stream": True, "t_accept": now, "t_body": now,
                       "t_parsed": now, "t_done": None, "disconnected": False,
                       "replica": owner.rid if owner is not None else None}
            bridge = _Stream()
            if not req.done:
                # the engine reads stream_cb at each notify: one reference
                # write re-attaches; a racing notify is absorbed by the
                # drain loop's req.done and token-count polling
                req.stream_cb = bridge
            bridge(req, 0, req.done)  # replay without waiting out a poll
            self._bump("streams")
            rid_out = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
            self._stream_response(h, req, bridge, rid_out, chat, new_rec,
                                  start=offset)
            return
        entry = self._journal_lookup(rid)
        if entry is None:
            raise ApiError(
                f"no resumable stream for request id {rid!r} (unknown, or "
                "aged out of the journal's finished window)", status=404,
                code="request_not_found")
        # journal-only replay: no live engine object (finished, or a
        # restart that never ran recover()): replay the record, close it
        self._check_resume_offset(offset, len(entry.tokens), rid)
        self._bump("streams")
        rid_out = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        event = self._sse_open(h, rid)
        rendered = ""
        if offset:
            _, rendered = self._delta(entry.tokens, offset, "")
        delta, _ = self._delta(entry.tokens, len(entry.tokens), rendered)
        upto = len(entry.tokens)
        if chat:
            event(oai.chat_chunk(rid_out, self.model_name, None, role=True),
                  eid=offset)
            if delta:
                event(oai.chat_chunk(rid_out, self.model_name, delta), eid=upto)
        elif delta:
            # the ids ride the logprobs block (logprobs null: the journal
            # keeps ids only), so a client can join the pieces by id
            span = entry.tokens[offset:upto]
            event(oai.completion_chunk(
                rid_out, self.model_name, delta,
                logprobs=oai.logprobs_block(span, [None] * len(span))),
                eid=upto)
        reason = entry.finish_reason if entry.finished else "error"
        if not entry.finished:
            event(oai.error_event(
                "stream is not live on this server (it was journaled but not "
                "recovered): committed tokens above are complete as "
                "delivered"))
        usage = entry.usage or {"prompt_tokens": len(entry.prompt),
                                "completion_tokens": len(entry.tokens)}
        usage = {**usage, "total_tokens": usage.get("prompt_tokens", 0)
                 + usage.get("completion_tokens", 0)}
        if chat:
            event(oai.chat_chunk(rid_out, self.model_name, None, reason=reason,
                                 usage=usage), eid=upto)
        else:
            event(oai.completion_chunk(rid_out, self.model_name, "",
                                       reason=reason, usage=usage), eid=upto)
        h.wfile.write(b"data: [DONE]\n\n")
        h.wfile.flush()

    @staticmethod
    def _read_body(h) -> dict:
        try:
            n = int(h.headers.get("Content-Length", 0))
        except ValueError:
            n = 0
        if n <= 0 or n > (8 << 20):
            raise ApiError("request body required (JSON)", param=None)
        raw = h.rfile.read(n)
        try:
            body = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ApiError(f"request body is not valid JSON: {e.msg}",
                           param=None) from None
        if not isinstance(body, dict):
            raise ApiError("request body must be a JSON object")
        return body

    # -------------------------------------------------------- completion

    def _serve_completion(self, h, body: dict, chat: bool, trace_id: str,
                          t_accept: float, t_body: float) -> None:
        cfg = self.engine.config
        if self.closing.is_set():
            raise ApiError("server is shutting down", status=503,
                           err_type="server_error", code="shutting_down")
        if self.router is None and self.loop.error is not None:
            # a fleet has no single fatal loop: a dead replica stops
            # admitting and the router routes around it
            raise ApiError("engine loop failed — the server needs a restart "
                           f"({type(self.loop.error).__name__})", status=503,
                           err_type="server_error", code="engine_failed")
        params, max_tokens, timeout_s = oai.parse_sampling(
            body, slo_classes=set(cfg.slo_targets) if cfg.slo_targets else None)
        stream = bool(body.get("stream", False))
        json_mode = oai.wants_json(body, cfg.json_mode)
        if json_mode and self._grammar_err:
            raise ApiError(self._grammar_err, param="response_format")
        if chat:
            prompt_ids = oai.parse_prompt({"prompt": oai.chat_prompt(body)},
                                          self.encode, self.vocab_size)
        else:
            prompt_ids = oai.parse_prompt(body, self.encode, self.vocab_size)
        if stream and self._active >= cfg.api_max_connections:
            raise ApiError(f"too many concurrent streams "
                           f"({cfg.api_max_connections}) — retry shortly",
                           status=503, err_type="server_error",
                           code="overloaded")
        # a fleet's probe is its fleet-wide queue room: one busy replica
        # must not 503 a request a peer has room for
        capacity = (self.router.capacity_left if self.router is not None
                    else self.engine.scheduler.capacity_left)
        fleet_note = " fleet-wide" if self.router is not None else ""
        if capacity == 0:
            raise ApiError(f"waiting queue is full{fleet_note} — retry shortly",
                           status=503, err_type="server_error",
                           code="overloaded")
        grammar = (JsonStepper(self.token_table, cache=self._grammar_cache)
                   if json_mode else None)
        bridge = _Stream()
        # the parse boundary: the next stamp is the request's own
        # submit_time inside the locked engine call, so the gap is the
        # submit-lock handoff
        t_parsed = smetrics.now()
        replica = None
        try:
            if self.router is not None:
                replica, req = self.router.submit(
                    np.asarray(prompt_ids, np.int64), max_new_tokens=max_tokens,
                    params=params, deadline_s=timeout_s, grammar=grammar,
                    stream_cb=bridge, trace_id=trace_id)
                if req is None:
                    raise ApiError("no replica is admitting (fleet draining or "
                                   "unhealthy) — retry shortly", status=503,
                                   err_type="server_error",
                                   code="engine_unhealthy")
            else:
                req = self.loop.submit(
                    np.asarray(prompt_ids, np.int64), max_new_tokens=max_tokens,
                    params=params, deadline_s=timeout_s, grammar=grammar,
                    stream_cb=bridge, trace_id=trace_id)
        except ValueError as e:
            code = ("context_length_exceeded"
                    if "exceeds the engine capacity" in str(e) else None)
            raise ApiError(str(e), code=code) from None
        if req.trace_id is not None and req.trace_id != trace_id:
            # the engine re-keyed a still-live duplicate id to protect the
            # journal: the client is told the id its stream answers to
            trace_id = req.trace_id
        rec = {"trace_id": trace_id, "req": req, "chat": chat,
               "stream": stream, "t_accept": t_accept, "t_body": t_body,
               "t_parsed": t_parsed, "t_done": None, "disconnected": False,
               # fleet: the admitting replica (X-Replica-Id), the peers that
               # refused first (X-Fleet-Reroutes) and, after a drain, the
               # husks of earlier hops (the trail of /v1/requests/<id>)
               "replica": replica.rid if replica is not None else None,
               "reroutes": int(getattr(req, "fleet_reroutes", 0) or 0),
               "hops": []}
        with self._timeline_lock:
            self._timelines[trace_id] = rec
            self._timelines.move_to_end(trace_id)
            while len(self._timelines) > self.timeline_cap:
                self._timelines.popitem(last=False)
        tr = self.engine.trace
        if tr is not None:
            # contiguous boundaries (t_accept -> t_body -> t_parsed ->
            # submit_time) extend the engine's partition across the door
            tr.complete("accept", "http", "http", ts=t_accept,
                        dur=t_body - t_accept, req=req.id, trace_id=trace_id)
            tr.complete("parse", "http", "http", ts=t_body,
                        dur=t_parsed - t_body, req=req.id)
            tr.complete("queue_handoff", "http", "http", ts=t_parsed,
                        dur=max(req.submit_time - t_parsed, 0.0), req=req.id)
        if req.state == "rejected":
            self._bump("rejected")
            rec["t_done"] = smetrics.now()
            why = req.reject_reason or ""
            if why == "unhealthy":
                err = ApiError("engine is unhealthy and draining — retry "
                               "shortly", status=503, err_type="server_error",
                               code="engine_unhealthy")
            elif why.startswith("shed:"):
                shed_eng = replica.engine if replica is not None else self.engine
                err = ApiError(
                    f"admissions for SLO class {why[5:]!r} are being "
                    f"load-shed (degradation rung "
                    f"{shed_eng.degradation_rung}) — retry after the "
                    "hinted delay", status=503, err_type="server_error",
                    code="overloaded")
            else:
                # the queue filled between the probe above and the submit
                err = ApiError(f"waiting queue is full{fleet_note} — retry "
                               "shortly", status=503, err_type="server_error",
                               code="overloaded")
            headers = {**self._retry_headers(), "X-Request-Id": trace_id}
            if rec["replica"] is not None:
                headers["X-Replica-Id"] = rec["replica"]
            if rec["reroutes"]:
                headers["X-Fleet-Reroutes"] = str(rec["reroutes"])
            self._send_json(h, 503, err.body(), headers)
            return
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        if stream:
            self._bump("streams")
            self._stream_response(h, req, bridge, rid, chat, rec)
        else:
            self._blocking_response(h, req, bridge, rid, chat, rec)

    def _delta(self, tokens, upto: int, rendered: str) -> tuple[str, str]:
        """Text delta for tokens[:upto] given what was already rendered.
        A full re-decode (not per token) keeps merge-y detokenizers right;
        suffix-after-prefix keeps the stream append-only."""
        if self.decode is None:
            text = "".join(str(t) + " " for t in tokens[:upto])
        else:
            text = self.decode(list(tokens[:upto]))
        if text.startswith(rendered):
            return text[len(rendered):], text
        return text, text  # a detokenizer that is not prefix-stable: resend

    @staticmethod
    def _disconnected(h) -> bool:
        """Probe the socket for a client half-close without consuming
        request data (there is none after the body in this protocol)."""
        try:
            r, _, _ = select.select([h.connection], [], [], 0)
            if r:
                return h.connection.recv(1, socket.MSG_PEEK) == b""
        except OSError:
            return True
        return False

    def _mark_disconnect(self, req, rec) -> None:
        rec["disconnected"] = True
        rec["t_done"] = smetrics.now()
        self._bump("disconnects")
        tr = self.engine.trace
        if tr is not None:
            tr.instant("disconnect", "http", "http", req=req.id)

    def _mark_done(self, req, rec, events: int = 0) -> None:
        """Stamp the drain boundary: engine finish -> last response byte
        flushed (event rendering, detokenize, socket writes)."""
        t_done = smetrics.now()
        rec["t_done"] = t_done
        tr = self.engine.trace
        if tr is not None and req.finish_time is not None:
            tr.complete("sse_drain", "http", "http", ts=req.finish_time,
                        dur=max(t_done - req.finish_time, 0.0), req=req.id,
                        events=events)

    def _stream_response(self, h, req, bridge, rid: str, chat: bool,
                         rec: dict, start: int = 0) -> None:
        """`start` > 0 is a Last-Event-ID reconnect: tokens[:start] were
        delivered already, and the stream resumes from there (the prefix
        is re-rendered so text deltas stay exact)."""
        event = self._sse_open(h, rec["trace_id"], replica=rec.get("replica"),
                               reroutes=int(rec.get("reroutes") or 0))
        self._bump_active(1)
        emitted = start
        events = 0
        rendered = ""
        if start > 0:
            _, rendered = self._delta(req.tokens, start, "")

        def cancel_if_mine() -> None:
            # the last reconnect wins: an abandoned connection noticing its
            # dead socket after a re-attach must not cancel the stream; the
            # cancel goes to the replica decoding it now
            if not req.done and req.stream_cb is bridge:
                self._loop_for(req).cancel(req)

        try:
            if chat:
                event(oai.chat_chunk(rid, self.model_name, None, role=True),
                      eid=emitted)
            while True:
                try:
                    _, finished = bridge.q.get(timeout=0.5)
                except queue.Empty:
                    if req.done:
                        finished = True  # the callback raced the queue
                    elif self._disconnected(h):
                        cancel_if_mine()
                        self._mark_disconnect(req, rec)
                        return
                    else:
                        # SSE comment heartbeat: keeps proxies from timing
                        # the stream out and surfaces a dead socket as a
                        # write error between tokens
                        h.wfile.write(b": ping\n\n")
                        h.wfile.flush()
                        continue
                # probe for a half-closed client BEFORE writing: a FIN
                # arrives long before a write raises (small SSE events
                # vanish into the send buffer)
                if self._disconnected(h):
                    cancel_if_mine()
                    self._mark_disconnect(req, rec)
                    return
                upto = len(req.tokens)
                if upto > emitted:
                    delta, rendered = self._delta(req.tokens, upto, rendered)
                    if chat:
                        event(oai.chat_chunk(rid, self.model_name, delta),
                              eid=upto)
                    else:
                        lps = (oai.logprobs_block(req.tokens[emitted:upto],
                                                  req.logprobs[emitted:upto])
                               if req.params.logprobs else None)
                        event(oai.completion_chunk(rid, self.model_name, delta,
                                                   logprobs=lps), eid=upto)
                    emitted = upto
                    events += 1
                if finished:
                    if req.finish_reason == "migrated":
                        # a fleet drain: the stream goes on on a peer. Close
                        # WITHOUT a terminal chunk or [DONE] (an unterminated
                        # SSE stream is the signal to reconnect with the
                        # Last-Event-ID; the cursor resolves on the adopter,
                        # token-exact from this offset). The committed prefix
                        # went out above: force_drain froze the token list
                        # before the entries were snapshotted.
                        h.wfile.write(b": migrated - reconnect with "
                                      b"Last-Event-ID\n\n")
                        h.wfile.flush()
                        self._mark_done(req, rec, events=events)
                        return
                    if req.finish_reason == "error":
                        # a quarantined or engine-failed stream ends with a
                        # structured error event before its terminal chunk
                        event(oai.error_event(
                            "the request failed in the engine (finish_reason "
                            "error) — partial output above is complete as "
                            "delivered"))
                    usage = oai.usage_block(req)
                    if chat:
                        event(oai.chat_chunk(rid, self.model_name, None,
                                             reason=req.finish_reason,
                                             usage=usage), eid=emitted)
                    else:
                        event(oai.completion_chunk(rid, self.model_name, "",
                                                   reason=req.finish_reason,
                                                   usage=usage), eid=emitted)
                    h.wfile.write(b"data: [DONE]\n\n")
                    h.wfile.flush()
                    self._mark_done(req, rec, events=events + 1)
                    return
        except (BrokenPipeError, ConnectionResetError, OSError):
            # the client went away mid-stream: free the slot at the next
            # block boundary
            cancel_if_mine()
            self._mark_disconnect(req, rec)
        except Exception as e:  # noqa: BLE001 — a server-side failure
            # after the 200 and the SSE headers went out: send the error
            # event, a terminal chunk with finish_reason "error" and
            # [DONE] (best effort), then release the engine side
            cancel_if_mine()
            try:
                term = (oai.chat_chunk(rid, self.model_name, None,
                                       reason="error") if chat
                        else oai.completion_chunk(rid, self.model_name, "",
                                                  reason="error"))
                payload = (b"data: " + json.dumps(oai.error_event(
                    f"{type(e).__name__}: {e}")).encode() + b"\n\n"
                    + b"data: " + json.dumps(term).encode()
                    + b"\n\ndata: [DONE]\n\n")
                h.wfile.write(payload)
                h.wfile.flush()
            except OSError:
                pass
            self._mark_done(req, rec, events=events + 2)
        finally:
            self._bump_active(-1)

    def _blocking_response(self, h, req, bridge, rid: str, chat: bool,
                           rec: dict) -> None:
        self._bump_active(1)
        try:
            while True:
                while not req.done:
                    try:
                        _, finished = bridge.q.get(timeout=0.5)
                        if finished and req.done:
                            break
                    except queue.Empty:
                        if self._disconnected(h):
                            self._loop_for(req).cancel(req)
                            self._mark_disconnect(req, rec)
                            return
                if req.finish_reason != "migrated" or self.router is None:
                    break
                # a drain mid-request: no bytes went out, so the migration
                # is transparent: wait on the adopted request instead
                nxt = self._find_recovered(req.trace_id)
                if nxt is None:
                    # the drain force-finishes the husk BEFORE the peer
                    # adopts it: give the adoption a bounded window to land
                    deadline = time.monotonic() + 5.0
                    while nxt is None and time.monotonic() < deadline:
                        time.sleep(0.002)
                        nxt = self._find_recovered(req.trace_id)
                if nxt is None or nxt is req:
                    break  # the adoption failed: report the husk
                rec.setdefault("hops", []).append(
                    {"req": req, "replica": rec.get("replica")})
                req = nxt
                rec["req"] = req
                owner = self.router.owner(req.trace_id)
                rec["replica"] = owner.rid if owner is not None else None
                if not req.done:
                    req.stream_cb = bridge
                bridge(req, 0, req.done)  # past the 0.5 s poll
            if self.decode is not None:
                text = self.decode(list(req.tokens))
            else:
                text = "".join(str(t) + " " for t in req.tokens)
            headers = {"X-Request-Id": rec["trace_id"]}
            if rec.get("replica") is not None:
                headers["X-Replica-Id"] = rec["replica"]
            if rec.get("reroutes"):
                headers["X-Fleet-Reroutes"] = str(rec["reroutes"])
            if req.finish_reason == "error":
                # no bytes went out yet: the honest status is a 500
                self._send_json(h, 500, oai.error_event(
                    "the request failed in the engine (finish_reason error)"),
                    headers)
                self._mark_done(req, rec, events=1)
                return
            make = oai.chat_response if chat else oai.completion_response
            self._send_json(h, 200, make(rid, self.model_name, req, text),
                            headers)
            self._mark_done(req, rec, events=1)
        finally:
            self._bump_active(-1)

    # -------------------------------------------------------------- close

    def close(self) -> None:
        """Graceful shutdown, idempotent: refuse new work, drain active
        streams (up to `drain_timeout_s`, then cancel), stop the engine
        loop, close the engine (every replica's, in a fleet), then the
        HTTP threads."""
        if self._closed:
            return
        self._closed = True
        self.closing.set()
        deadline = time.monotonic() + self.engine.config.drain_timeout_s
        while self._active > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        left = max(0.0, deadline - time.monotonic())
        if self.router is not None:
            # every replica's loop and engine, within the one budget
            self.router.close(drain_timeout_s=left)
        else:
            self.loop.close(drain_timeout_s=left)
            self.engine.close()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

