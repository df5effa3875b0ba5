"""Live status endpoint (port of `solvingpapers_tpu/metrics/http.py`):
/healthz, /metrics, /statusz and /timeseriesz over stdlib HTTP.

A running engine is otherwise a black box unless a tracer was attached
before launch; this module gives it a first-line inspection surface
with no dependencies:

    /healthz   200 "ok" while the owner is healthy (the probe a load
               balancer or CI smoke polls); with a `health_fn` bound,
               200 "degraded" on a degradation-ladder rung and 503
               "unhealthy" while the engine drains after persistent
               failures
    /metrics   the current metric snapshot in Prometheus text exposition
               format — the same rendering `PrometheusTextWriter` writes
               to textfiles (`PrometheusTextWriter.render`), so names and
               dedupe rules cannot drift between the pull and push paths
    /statusz   one JSON document: engine snapshot, slot occupancy,
               health state machine (fault plan + degradation ladder),
               write-ahead journal (present iff journaled), SLO classes,
               sparklines — whatever the owner's `statusz_fn` assembles
    /timeseriesz  the rolling in-process time-series ring
               (metrics/timeseries.TimeSeriesStore.doc()) as JSON —
               present iff the owner bound a `timeseries_fn`, 404
               otherwise

`StatusServer` is a `ThreadingHTTPServer` on a daemon thread bound to
127.0.0.1 by default (an inspection surface, not an API — front it with
a real proxy to expose it). Providers are zero-arg callables resolved
per request, so responses always reflect live state; a provider that
raises returns a 500 with the error text instead of killing the serving
loop. Opt-in via `ServeConfig.status_port` (port 0 binds an ephemeral
port, published as `server.port`).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from solvingpapers_tpu_torch.metrics.writer import PrometheusTextWriter


def healthz_response(state: str) -> tuple[int, str]:
    """ONE mapping from the engine health state machine to the /healthz
    wire contract, shared by this status-port server and the OpenAI
    front door (serve/api.py) so the two endpoints can never diverge:
    ``unhealthy`` -> 503 (a load balancer must drop the replica),
    ``degraded`` -> 200 "degraded" (keep it — still serving, just
    shedding load), anything else -> 200 "ok"."""
    if state == "unhealthy":
        return 503, "unhealthy\n"
    if state == "degraded":
        return 200, "degraded\n"
    return 200, "ok\n"


class StatusServer:
    """Serve /healthz, /metrics, /statusz from live provider callables.

    `statusz_fn() -> dict` builds the JSON status document;
    `metrics_fn() -> (step, {name: value})` feeds the Prometheus text
    rendering. Both run on the request thread — keep them snapshot-cheap
    (the engine's providers read host-side mirrors, never the device).
    """

    def __init__(
        self,
        statusz_fn: Callable[[], dict],
        metrics_fn: Callable[[], tuple[int, dict]],
        host: str = "127.0.0.1",
        port: int = 0,
        prefix: str = "",
        health_fn: Callable[[], str] | None = None,
        timeseries_fn: Callable[[], dict] | None = None,
    ):
        self.statusz_fn = statusz_fn
        self.metrics_fn = metrics_fn
        self.prefix = prefix
        # timeseries_fn() -> TimeSeriesStore.doc(): the rolling
        # retrospective served as /timeseriesz JSON; None (an owner
        # without a store) keeps the endpoint a 404
        self.timeseries_fn = timeseries_fn
        # health_fn() -> "healthy" | "degraded" | "unhealthy": /healthz
        # answers 503 for "unhealthy" (a draining engine must fall out
        # of its load balancer), 200 otherwise — "degraded" keeps the
        # replica in rotation but names its state in the body. None
        # keeps the historical always-200 "ok".
        self.health_fn = health_fn
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A003 — silence
                pass  # per-request stderr spam would drown engine logs

            def _send(self, code: int, body: str, ctype: str) -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/healthz":
                        state = ("healthy" if server.health_fn is None
                                 else server.health_fn())
                        code, body = healthz_response(state)
                        self._send(code, body, "text/plain")
                    elif path == "/metrics":
                        step, metrics = server.metrics_fn()
                        self._send(
                            200,
                            PrometheusTextWriter.render(
                                step, metrics, prefix=server.prefix
                            ),
                            "text/plain; version=0.0.4",
                        )
                    elif path == "/statusz":
                        self._send(
                            200,
                            json.dumps(server.statusz_fn(), default=str)
                            + "\n",
                            "application/json",
                        )
                    elif path == "/timeseriesz":
                        if server.timeseries_fn is None:
                            self._send(
                                404,
                                "no time-series store (run with "
                                "timeseries enabled)\n",
                                "text/plain",
                            )
                        else:
                            self._send(
                                200,
                                json.dumps(server.timeseries_fn(),
                                           default=str) + "\n",
                                "application/json",
                            )
                    else:
                        self._send(
                            404,
                            "not found — try /healthz, /metrics, "
                            "/statusz, /timeseriesz\n",
                            "text/plain",
                        )
                except BrokenPipeError:  # client went away mid-write
                    pass
                except Exception as e:  # noqa: BLE001 — a bad provider
                    # must answer 500, not kill the handler thread
                    try:
                        self._send(500, f"{type(e).__name__}: {e}\n",
                                   "text/plain")
                    except BrokenPipeError:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="statusz", daemon=True
        )
        self._thread.start()

    def url(self, path: str = "/statusz") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        """Stop serving and release the port (idempotent)."""
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        self._httpd = None
