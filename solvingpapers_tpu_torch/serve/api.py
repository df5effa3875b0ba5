"""OpenAI-compatible HTTP front door over a live `ServeEngine` (port of
`solvingpapers_tpu/serve/api.py`, without its journal, stream
resumption, replay, fleet routing and request timelines).

One stdlib `ThreadingHTTPServer` on a daemon thread (no dependencies)
exposes:

    POST /v1/completions        OpenAI completions, string or token-id
                                prompts, SSE streaming (`stream: true`)
    POST /v1/chat/completions   chat messages through a minimal template
    GET  /v1/models             the one hosted model
    GET  /healthz /metrics /statusz   the inspection surface, on the same
                                listener

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
queue, or too many open streams, answers 503 with a jittered
Retry-After; an invalid request answers 400 with the OpenAI error
envelope (`serve/openai.py`), never a traceback over a socket. The
client's `X-Request-Id` is echoed (a fresh one is minted when it is
absent or malformed).

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
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from solvingpapers_tpu_torch.metrics.writer import PrometheusTextWriter
from solvingpapers_tpu_torch.serve import openai as oai
from solvingpapers_tpu_torch.serve.engine import weak_method
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

    def _locked(self, fn):
        """Run an engine call under the step lock, counted as a waiter so
        the loop hands the lock over instead of convoying."""
        with self._waiter_lock:
            self._waiters += 1
        try:
            with self.lock:
                return fn()
        finally:
            with self._waiter_lock:
                self._waiters -= 1

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
    `EngineLoop`; by default the server owns one.
    """

    def __init__(self, engine, *, encode=None, decode=None, token_table=None,
                 model_name: str = "solvingpapers", loop=None):
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
        """A jittered Retry-After (integer seconds) for every 503."""
        with self._retry_lock:
            retry = self._retry_rng.randint(1, 4)
        return {"Retry-After": str(retry)}

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
                # a dead engine loop is unhealthy: the balancer must drop it
                if self.loop.error is not None:
                    self._send(h, 503, "unhealthy\n", "text/plain")
                else:
                    self._send(h, 200, "ok\n", "text/plain")
            elif path == "/metrics":
                with self.loop.lock:
                    step, snap = (self.engine._step_idx,
                                  self.engine.metrics.prom_snapshot())
                self._send(h, 200, PrometheusTextWriter.render(step, snap),
                           "text/plain; version=0.0.4")
            elif path == "/statusz":
                with self.loop.lock:
                    doc = self.engine.statusz()
                self._send_json(h, 200, doc)
            elif path == "/v1/models":
                self._send_json(h, 200, {
                    "object": "list",
                    "data": [{"id": self.model_name, "object": "model",
                              "owned_by": "local"}],
                })
            else:
                self._send(h, 404, "not found\n", "text/plain")
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001 — a handler must not die
            try:
                self._send(h, 500, f"{type(e).__name__}: {e}\n", "text/plain")
            except (BrokenPipeError, ConnectionResetError):
                pass

    def _post(self, h) -> None:
        path = h.path.split("?", 1)[0]
        chat = path == "/v1/chat/completions"
        if not chat and path != "/v1/completions":
            self._send(h, 404, "not found\n", "text/plain")
            return
        self._bump("requests")
        # honor the client's X-Request-Id (sane values only), else mint one
        rid_in = (h.headers.get("X-Request-Id") or "").strip()
        trace_id = rid_in if _RID_RE.match(rid_in) else uuid.uuid4().hex
        rid_headers = {"X-Request-Id": trace_id}
        try:
            body = self._read_body(h)
            self._serve_completion(h, body, chat=chat, trace_id=trace_id)
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

    def _serve_completion(self, h, body: dict, chat: bool,
                          trace_id: str) -> None:
        cfg = self.engine.config
        if self.closing.is_set():
            raise ApiError("server is shutting down", status=503,
                           err_type="server_error", code="shutting_down")
        if self.loop.error is not None:
            raise ApiError("engine loop failed — the server needs a restart "
                           f"({type(self.loop.error).__name__})", status=503,
                           err_type="server_error", code="engine_failed")
        params, max_tokens, timeout_s = oai.parse_sampling(body)
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
        if self.engine.scheduler.capacity_left == 0:
            raise ApiError("waiting queue is full — retry shortly", status=503,
                           err_type="server_error", code="overloaded")
        grammar = (JsonStepper(self.token_table, cache=self._grammar_cache)
                   if json_mode else None)
        bridge = _Stream()
        try:
            req = self.loop.submit(
                np.asarray(prompt_ids, np.int64), max_new_tokens=max_tokens,
                params=params, deadline_s=timeout_s, grammar=grammar,
                stream_cb=bridge)
        except ValueError as e:
            code = ("context_length_exceeded"
                    if "exceeds the engine capacity" in str(e) else None)
            raise ApiError(str(e), code=code) from None
        if req.state == "rejected":
            # the queue filled between the probe above and the submit
            raise ApiError("waiting queue is full — retry shortly", status=503,
                           err_type="server_error", code="overloaded")
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        if stream:
            self._bump("streams")
            self._stream_response(h, req, bridge, rid, chat, trace_id)
        else:
            self._blocking_response(h, req, bridge, rid, chat, trace_id)

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

    def _stream_response(self, h, req, bridge, rid: str, chat: bool,
                         trace_id: str) -> None:
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.send_header("X-Request-Id", trace_id)
        h.end_headers()

        def event(obj) -> None:
            h.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            h.wfile.flush()

        def cancel() -> None:
            self.loop.cancel(req)
            self._bump("disconnects")

        self._bump_active(1)
        emitted = 0
        rendered = ""
        try:
            if chat:
                event(oai.chat_chunk(rid, self.model_name, None, role=True))
            while True:
                try:
                    _, finished = bridge.q.get(timeout=0.5)
                except queue.Empty:
                    if req.done:
                        finished = True  # the callback raced the queue
                    elif self._disconnected(h):
                        cancel()
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
                    cancel()
                    return
                upto = len(req.tokens)
                if upto > emitted:
                    delta, rendered = self._delta(req.tokens, upto, rendered)
                    if chat:
                        event(oai.chat_chunk(rid, self.model_name, delta))
                    else:
                        lps = (oai.logprobs_block(req.tokens[emitted:upto],
                                                  req.logprobs[emitted:upto])
                               if req.params.logprobs else None)
                        event(oai.completion_chunk(rid, self.model_name, delta,
                                                   logprobs=lps))
                    emitted = upto
                if finished:
                    if req.finish_reason == "error":
                        event(oai.error_event(
                            "the request failed in the engine (finish_reason "
                            "error) — partial output above is complete as "
                            "delivered"))
                    usage = oai.usage_block(req)
                    if chat:
                        event(oai.chat_chunk(rid, self.model_name, None,
                                             reason=req.finish_reason,
                                             usage=usage))
                    else:
                        event(oai.completion_chunk(rid, self.model_name, "",
                                                   reason=req.finish_reason,
                                                   usage=usage))
                    h.wfile.write(b"data: [DONE]\n\n")
                    h.wfile.flush()
                    return
        except (BrokenPipeError, ConnectionResetError, OSError):
            # the client went away mid-stream: free the slot at the next
            # block boundary
            cancel()
        except Exception as e:  # noqa: BLE001 — a server-side failure
            # after the 200 and the SSE headers went out: send the error
            # event, a terminal chunk with finish_reason "error" and
            # [DONE] (best effort), then release the engine side
            self.loop.cancel(req)
            try:
                term = (oai.chat_chunk(rid, self.model_name, None,
                                       reason="error") if chat
                        else oai.completion_chunk(rid, self.model_name, "",
                                                  reason="error"))
                event(oai.error_event(f"{type(e).__name__}: {e}"))
                event(term)
                h.wfile.write(b"data: [DONE]\n\n")
                h.wfile.flush()
            except OSError:
                pass
        finally:
            self._bump_active(-1)

    def _blocking_response(self, h, req, bridge, rid: str, chat: bool,
                           trace_id: str) -> None:
        self._bump_active(1)
        try:
            while not req.done:
                try:
                    _, finished = bridge.q.get(timeout=0.5)
                    if finished and req.done:
                        break
                except queue.Empty:
                    if self._disconnected(h):
                        self.loop.cancel(req)
                        self._bump("disconnects")
                        return
            if self.decode is not None:
                text = self.decode(list(req.tokens))
            else:
                text = "".join(str(t) + " " for t in req.tokens)
            headers = {"X-Request-Id": trace_id}
            if req.finish_reason == "error":
                # no bytes went out yet: the honest status is a 500
                self._send_json(h, 500, oai.error_event(
                    "the request failed in the engine (finish_reason error)"),
                    headers)
                return
            make = oai.chat_response if chat else oai.completion_response
            self._send_json(h, 200, make(rid, self.model_name, req, text),
                            headers)
        finally:
            self._bump_active(-1)

    # -------------------------------------------------------------- close

    def close(self) -> None:
        """Graceful shutdown, idempotent: refuse new work, drain active
        streams (up to `drain_timeout_s`, then cancel), stop the engine
        loop, close the engine, then the HTTP threads."""
        if self._closed:
            return
        self._closed = True
        self.closing.set()
        deadline = time.monotonic() + self.engine.config.drain_timeout_s
        while self._active > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        self.loop.close(drain_timeout_s=max(0.0, deadline - time.monotonic()))
        self.engine.close()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

