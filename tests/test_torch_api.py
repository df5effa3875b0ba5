"""The port's OpenAI-compatible HTTP front door (`serve/api.py`,
`serve/openai.py`) over a real socket.

Across packages: a tiny float32 GPT with the JAX package's weights
(carried over by `convert.py`) behind the port's `ApiServer` and behind
the reference's gives, for one greedy token-id body with `logprobs 1`,
the same token ids and finish reason, and logprobs within 1e-4.

On the port alone, mirroring the reference's front-door tests: an SSE
stream is token-exact against a direct `submit` of the same body, on the
lane and the paged pool; a client that disconnects cancels its request
and frees its slot and every page; validation failures are 400s in the
OpenAI error envelope; a full queue is a 503 with Retry-After;
`timeout_s` becomes a deadline; `/metrics` has one ``# TYPE`` line a
name; shutdown is ordered and idempotent.

Model: GPT, vocab 64, dim 32, 2 layers, 2 heads, float32, on the CPU.
"""

import json
import socket
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from solvingpapers_tpu.models.gpt import GPT as JGPT
from solvingpapers_tpu.models.gpt import GPTConfig as JGPTConfig
from solvingpapers_tpu.serve import ApiServer as JApiServer
from solvingpapers_tpu.serve import ServeConfig as JServeConfig
from solvingpapers_tpu.serve import ServeEngine as JServeEngine
from solvingpapers_tpu_torch.convert import flax_to_torch
from solvingpapers_tpu_torch.models import GPT, GPTConfig
from solvingpapers_tpu_torch.serve import (
    ApiServer,
    EngineLoop,
    ServeConfig,
    ServeEngine,
)
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)

ALPHABET = '{}[]":,-.0123456789 \nabcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOP\\'
TABLE = list(ALPHABET[:64])
STOI = {c: i for i, c in enumerate(TABLE)}
TINY = dict(vocab_size=64, block_size=128, dim=32, n_layers=2, n_heads=2,
            dropout=0.0, dtype="float32")


def _encode(s):
    return [STOI[c] for c in s]


def _decode(ids):
    return "".join(TABLE[int(i)] for i in ids)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, the port's model) on one set of weights."""
    jm = JGPT(JGPTConfig(**TINY))
    params = jm.init({"params": jax.random.key(0)},
                     jnp.zeros((1, 8), jnp.int32))["params"]
    tm = GPT(GPTConfig(**TINY), device="cpu")
    tm.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    return jm, params, tm.eval()


def _engine(tm, **kw):
    cfg = dict(n_slots=4, max_len=128, decode_block=4, bucket=8, api_port=0)
    cfg.update(kw)
    return ServeEngine(tm, ServeConfig(**cfg), device="cpu",
                       detokenize=_decode)


@pytest.fixture(scope="module", params=[False, True], ids=["lane", "paged"])
def server(pair, request):
    eng = _engine(pair[2], paged=request.param,
                  page_size=8 if request.param else None)
    srv = ApiServer(eng, encode=_encode, decode=_decode, model_name="gpt-tiny")
    yield srv, eng
    srv.close()


def _post(srv, path, body, timeout=120, headers=None):
    req = urllib.request.Request(
        srv.url(path), data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _open_stream(srv, body):
    payload = json.dumps({**body, "stream": True}).encode()
    s = socket.create_connection((srv.host, srv.port), timeout=120)
    s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
              b"Content-Type: application/json\r\nContent-Length: "
              + str(len(payload)).encode() + b"\r\n\r\n" + payload)
    return s


def _stream_events(srv, body):
    """POST with stream=true over a raw socket; the parsed SSE events,
    the trailing [DONE] sentinel as "DONE"."""
    s = _open_stream(srv, body)
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += s.recv(4096)
    head, buf = buf.split(b"\r\n\r\n", 1)
    assert b"200" in head.split(b"\r\n")[0], head
    events = []
    while True:
        while b"\n\n" not in buf:
            chunk = s.recv(4096)
            if not chunk:
                s.close()
                return events
            buf += chunk
        frame, buf = buf.split(b"\n\n", 1)
        data = [ln for ln in frame.strip().split(b"\n") if ln.startswith(b"data: ")]
        if not data:
            continue  # heartbeat comments
        if data[-1][6:] == b"[DONE]":
            s.close()
            return events + ["DONE"]
        events.append(json.loads(data[-1][6:]))


def _wait(req, seconds=60):
    deadline = time.monotonic() + seconds
    while not req.done and time.monotonic() < deadline:
        time.sleep(0.01)
    assert req.done


# --------------------------------------------------------- across packages


def test_http_greedy_logprobs_match_the_jax_front_door(pair):
    """One greedy token-id body with logprobs 1 through both packages'
    front doors (no detokenizer: text is the ids): the same ids and
    finish reason; logprobs within 1e-4 in float32."""
    jm, params, tm = pair
    body = {"prompt": [3, 14, 15, 9, 26, 5, 35], "max_tokens": 12,
            "temperature": 0, "logprobs": 1}
    jeng = JServeEngine(jm, params, JServeConfig(
        n_slots=2, max_len=128, decode_block=4, bucket=8, api_port=0))
    jsrv = JApiServer(jeng)
    tsrv = ApiServer(_engine(tm, n_slots=2))
    try:
        (jst, _, jdoc), (tst, _, tdoc) = (_post(s, "/v1/completions", body)
                                          for s in (jsrv, tsrv))
    finally:
        jsrv.close()
        tsrv.close()
    assert jst == tst == 200
    jc, tc = jdoc["choices"][0], tdoc["choices"][0]
    assert tc["text"] == jc["text"]
    ids = [int(t) for t in jc["text"].split()]
    assert tc["logprobs"]["token_ids"] == ids and len(ids) == 12
    assert tc["finish_reason"] == jc["finish_reason"] == "length"
    np.testing.assert_allclose(tc["logprobs"]["token_logprobs"],
                               jc["logprobs"]["token_logprobs"], atol=1e-4)


# ------------------------------------------------------------- happy path


def test_stream_token_exact_vs_direct_submit(server):
    srv, _ = server
    prompt = list(range(20, 28))
    events = _stream_events(srv, {"prompt": prompt, "max_tokens": 12,
                                  "temperature": 0, "logprobs": 1})
    assert events[-1] == "DONE"
    chunks = events[:-1]
    text = "".join(c["choices"][0]["text"] for c in chunks)
    ids = [t for c in chunks if c["choices"][0]["logprobs"]
           for t in c["choices"][0]["logprobs"]["token_ids"]]
    terminal = chunks[-1]["choices"][0]
    assert terminal["finish_reason"] == "length"
    assert chunks[-1]["usage"]["completion_tokens"] == 12
    ref = srv.loop.submit(np.asarray(prompt), max_new_tokens=12)
    _wait(ref)
    assert ids == ref.tokens
    assert text == _decode(ref.tokens)
    # the blocking response of the same body carries the same text
    st, hdr, doc = _post(srv, "/v1/completions",
                         {"prompt": prompt, "max_tokens": 12, "temperature": 0})
    assert st == 200 and doc["choices"][0]["text"] == text
    assert doc["usage"] == {"prompt_tokens": 8, "completion_tokens": 12,
                            "total_tokens": 20}


def test_string_prompt_stop_string_chat_and_json(server):
    srv, _ = server
    st, _, doc = _post(srv, "/v1/completions",
                       {"prompt": "abcd", "max_tokens": 16, "temperature": 0})
    gen = doc["choices"][0]["text"]
    assert st == 200 and len(gen) == 16
    stop = gen[5:7]  # spans the first decode block's end
    first = gen.index(stop)
    st, _, doc = _post(srv, "/v1/completions", {
        "prompt": "abcd", "max_tokens": 16, "temperature": 0, "stop": stop})
    assert doc["choices"][0]["finish_reason"] == "stop"
    assert doc["choices"][0]["text"] == gen[:first + len(stop)]
    st, _, doc = _post(srv, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "abc"}], "max_tokens": 6,
        "temperature": 0})
    msg = doc["choices"][0]["message"]
    assert st == 200 and doc["object"] == "chat.completion"
    assert msg["role"] == "assistant" and len(msg["content"]) == 6
    st, _, doc = _post(srv, "/v1/completions", {
        "prompt": list(range(5, 10)), "max_tokens": 24, "temperature": 0,
        "response_format": {"type": "json_object"}})
    assert st == 200 and doc["choices"][0]["finish_reason"] == "stop"
    json.loads(doc["choices"][0]["text"])


def test_models_status_metrics_and_request_ids(server):
    srv, eng = server
    with urllib.request.urlopen(srv.url("/v1/models"), timeout=30) as r:
        assert json.loads(r.read())["data"][0]["id"] == "gpt-tiny"
    with urllib.request.urlopen(srv.url("/healthz"), timeout=30) as r:
        assert r.read() == b"ok\n"
    st, hdr, _ = _post(srv, "/v1/completions", {"prompt": [1, 2], "max_tokens": 2},
                       headers={"X-Request-Id": "client-7"})
    assert st == 200 and hdr["X-Request-Id"] == "client-7"
    st, hdr, _ = _post(srv, "/v1/completions", {"prompt": [1, 2], "max_tokens": 2},
                       headers={"X-Request-Id": "bad id\x01"})
    assert st == 200 and len(hdr["X-Request-Id"]) == 32  # minted
    with urllib.request.urlopen(srv.url("/metrics"), timeout=30) as r:
        prom = r.read().decode()
    types = [ln.split()[2] for ln in prom.splitlines() if ln.startswith("# TYPE")]
    assert len(types) == len(set(types))
    assert "serve_http_requests" in types and "serve_ttft_s" in types
    assert "# TYPE serve_ttft_s histogram" in prom
    with urllib.request.urlopen(srv.url("/statusz"), timeout=30) as r:
        doc = json.loads(r.read())
    assert "engine" in doc and len(doc["slots"]) == eng.config.n_slots
    assert ("kv_pages" in doc) == eng.config.paged


# ----------------------------------------------------------- error mapping


@pytest.fixture(scope="module")
def idle_server(pair):
    """A front door whose engine loop never runs (every body below fails
    before it reaches the engine)."""
    eng = _engine(pair[2], n_slots=1)
    srv = ApiServer(eng, encode=_encode, decode=_decode,
                    loop=EngineLoop(eng, start=False))
    yield srv
    srv.close()


@pytest.mark.parametrize("body,param", [
    ({"prompt": [1, 2], "temperature": -1}, None),
    ({"prompt": [1, 2], "top_p": 0}, None),
    ({"prompt": "abc", "n": 2}, "n"),
    ({"prompt": "abc", "echo": True}, "echo"),
    ({"prompt": [], "max_tokens": 4}, "prompt"),
    ({"prompt": [999999]}, "prompt"),
    ({"prompt": "a~c"}, "prompt"),
    ({"prompt": [1, 2], "stop": [1]}, "stop"),
    ({"prompt": [1, 2], "logprobs": 5}, "logprobs"),
    ({"prompt": [1, 2], "response_format": {"type": "xml"}}, "response_format"),
    ({"prompt": [1, 2], "timeout_s": -1}, "timeout_s"),
])
def test_400_envelope(idle_server, body, param):
    st, _, doc = _post(idle_server, "/v1/completions", body)
    assert st == 400, doc
    assert doc["error"]["type"] == "invalid_request_error"
    assert doc["error"]["message"]
    if param is not None:
        assert doc["error"]["param"] == param


def test_400_submit_validation_and_malformed_json(server):
    srv, _ = server
    st, _, doc = _post(srv, "/v1/completions",
                       {"prompt": list(range(8)), "max_tokens": 10_000})
    assert st == 400 and doc["error"]["code"] == "context_length_exceeded"
    st, _, doc = _post(srv, "/v1/completions",
                       {"prompt": list(range(8)), "top_k": 4096})
    assert st == 400 and "sample_cap" in doc["error"]["message"]
    req = urllib.request.Request(srv.url("/v1/completions"), data=b"{not json",
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400
    assert "not valid JSON" in json.loads(ei.value.read())["error"]["message"]


def test_503_retry_after_when_queue_full(pair):
    """The engine loop is not running, so the queue cannot drain."""
    eng = _engine(pair[2], n_slots=1, max_waiting=2)
    srv = ApiServer(eng, decode=_decode, loop=EngineLoop(eng, start=False))
    try:
        for _ in range(2):
            eng.submit(np.arange(4), max_new_tokens=4)
        st, headers, doc = _post(srv, "/v1/completions",
                                 {"prompt": [1, 2, 3], "max_tokens": 4})
    finally:
        srv.close()
    assert st == 503 and doc["error"]["code"] == "overloaded"
    assert 1 <= int(headers["Retry-After"]) <= 4


# --------------------------------------------------- cancel, deadline, close


@pytest.mark.parametrize("paged", [False, True], ids=["lane", "paged"])
def test_disconnect_cancels_and_frees_the_slot_and_pages(pair, paged):
    eng = _engine(pair[2], n_slots=2, paged=paged,
                  page_size=8 if paged else None)
    srv = ApiServer(eng, decode=_decode)
    try:
        s = _open_stream(srv, {"prompt": [5, 6, 7, 8], "max_tokens": 100,
                               "temperature": 0})
        buf = b""
        while buf.count(b"data: ") < 2:
            buf += s.recv(4096)
        s.close()  # the disconnect
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                eng.metrics.snapshot().get("serve/finish_cancelled")
                and eng.pool.n_active == 0):
            time.sleep(0.02)
        snap = eng.metrics.snapshot()
    finally:
        srv.close()
    assert snap.get("serve/finish_cancelled") == 1, snap
    assert snap["serve/tokens_out"] < 100 and eng.pool.n_active == 0
    assert snap["serve/http_disconnects"] >= 1
    if paged:
        assert eng.pool.pages_free == eng.pool.page_budget
        assert int(eng.pool.refcount.sum()) == 1  # the trash page only


def test_timeout_s_maps_to_deadline(server):
    srv, _ = server
    st, _, doc = _post(srv, "/v1/completions", {
        "prompt": list(range(6)), "max_tokens": 100, "temperature": 0,
        "timeout_s": 0.001})
    assert st == 200 and doc["choices"][0]["finish_reason"] == "timeout"


def test_close_is_ordered_and_idempotent(pair):
    eng = _engine(pair[2], n_slots=2)
    srv = ApiServer(eng, decode=_decode)
    st, _, _ = _post(srv, "/v1/completions", {"prompt": [1, 2, 3], "max_tokens": 4})
    assert st == 200
    h = srv.loop.submit(np.arange(4), max_new_tokens=100)
    srv.close()
    srv.close()
    assert h.done and not eng.has_work()
    assert not srv.loop._thread.is_alive() and not srv._thread.is_alive()
    with pytest.raises(OSError):
        socket.create_connection((srv.host, srv.port), timeout=2)


def test_healthz_is_503_once_the_engine_loop_has_died(pair):
    eng = _engine(pair[2], n_slots=1)
    srv = ApiServer(eng, decode=_decode, loop=EngineLoop(eng, start=False))
    try:
        with urllib.request.urlopen(srv.url("/healthz"), timeout=30) as r:
            assert r.status == 200 and r.read() == b"ok\n"
        srv.loop.error = RuntimeError("a step raised")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url("/healthz"), timeout=30)
        assert e.value.code == 503 and e.value.read() == b"unhealthy\n"
    finally:
        srv.close()


def test_stream_limit_answers_503(pair):
    """Past `api_max_connections` open streams a new stream is refused
    with 503 and Retry-After (the engine loop is not running, so the
    open stream stays open); the stream's disconnect then frees it."""
    eng = _engine(pair[2], n_slots=1, api_max_connections=1)
    srv = ApiServer(eng, decode=_decode, loop=EngineLoop(eng, start=False))
    try:
        s = _open_stream(srv, {"prompt": [5, 6, 7, 8], "max_tokens": 8})
        deadline = time.monotonic() + 30
        while srv._active < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        st, headers, doc = _post(srv, "/v1/completions", {
            "prompt": [1, 2, 3], "max_tokens": 4, "stream": True})
        s.close()
        deadline = time.monotonic() + 30
        while srv._active > 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        active = srv._active
    finally:
        srv.close()
    assert st == 503 and doc["error"]["code"] == "overloaded"
    assert "concurrent streams (1)" in doc["error"]["message"]
    assert int(headers["Retry-After"]) >= 1
    assert active == 0 and not eng.has_work()
