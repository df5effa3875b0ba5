"""The port's write-ahead journal (`serve/journal.py`), engine recovery
and stream resumption against the JAX package's.

Across packages: a journal written by either package's `Journal` reads
back equal through both packages' `read_entries` and `Journal` loaders —
as written, with a torn final line (a crash mid-write), and compacted to
its live set — so either package recovers the other's file.

On the port alone: a journaled engine dropped without `close()` (the
stand-in for SIGKILL: records are flushed a write and fsynced a step) and
a fresh engine on the same file recover every in-flight stream
token-exactly, greedy and seeded, at every block boundary, on the lane
and the paged pool, and on DeepSeek-V3's latent cache; an injected journal `io_error` degrades the engine to
journal-off without failing a stream, and `journal_strict` raises
instead; over loopback, SSE events carry ``id: <request id>:<offset>``,
a ``Last-Event-ID`` reconnect replays exactly the missing tail (live,
after a restart's `recover()`, and from the journal of a finished
stream), and `GET /v1/requests/<id>` falls back to the journal.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from durability_models import (
    BASE,
    PAGED,
    drive,
    no_leaks,
    port_dsv3,
    port_engine,
    prompts,
)
from solvingpapers_tpu.serve import journal as jjournal
from solvingpapers_tpu_torch.serve import SamplingParams
from solvingpapers_tpu_torch.serve import journal as tjournal
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)

NEW = 10
SEEDED = SamplingParams(temperature=0.8, top_p=0.9, seed=11)


def _write(mod, path):
    """Three requests through `mod.Journal`: one finished, two live with
    commits (one with a deadline and an SLO class)."""
    j = mod.Journal(path, rotate_finished=64)
    params = {"temperature": 0.0, "seed": None, "stop": [], "slo": None}
    j.append_submit("a", [1, 2, 3], 8, None, params, 1.5)
    j.append_submit("b", [4, 5], 6, 7, {**params, "slo": "batch"}, 2.25,
                    deadline_s=3.0)
    j.append_commit("a", [9, 8])
    j.append_submit("c", [6], 4, None, params, 3.0, grammar=True)
    j.append_commit("b", [1])
    j.append_commit("a", [7])
    j.append_finish("a", "length", {"prompt_tokens": 3,
                                    "completion_tokens": 3})
    j.sync()
    return j


@pytest.mark.parametrize("case", ["plain", "torn", "compacted"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_files_read_the_same_in_both_packages(tmp_path, writer, case):
    path = str(tmp_path / "j.jsonl")
    mod = tjournal if writer == "port" else jjournal
    j = _write(mod, path)
    if case == "compacted":
        j.compact()
    j.close()
    if case == "torn":
        with open(path, "a") as f:
            f.write('{"kind": "commit", "rid": "b", "tok')
    ours = [dataclasses.asdict(e) for e in tjournal.read_entries(path)]
    ref = [dataclasses.asdict(e) for e in jjournal.read_entries(path)]
    assert ours == ref
    want_live = ["b", "c"]
    assert [e["rid"] for e in ours if not e["finished"]] == want_live
    loaded = [(e.rid, e.tokens) for e in tjournal.Journal(path).live_entries()]
    assert loaded == [(e.rid, e.tokens)
                      for e in jjournal.Journal(path).live_entries()]
    assert loaded == [("b", [1]), ("c", [])]


def _params_for(i):
    return SEEDED if i % 3 == 2 else None


@pytest.mark.parametrize("model, paged", [(None, False), (None, True),
                                          ("dsv3", True)],
                         ids=["lane", "paged", "latent-paged"])
def test_recovery_is_token_exact_at_every_block_boundary(tmp_path, model, paged):
    """Greedy and seeded streams (every third seeded) killed after each
    step of an uninterrupted drain: the recovered engine's streams equal
    the uninterrupted run's, and both engines leak nothing. The
    latent-paged case re-prefills DeepSeek-V3's latent cache."""
    ps = prompts(4, seed=11)
    kw = dict(max_prefills_per_step=2, **(PAGED if paged else {}))
    if model == "dsv3":
        kw["model"] = port_dsv3()
    ref_eng = port_engine(**kw)
    ref = [ref_eng.submit(p, NEW, params=_params_for(i)) for i, p in enumerate(ps)]
    steps = 0
    while ref_eng.has_work():
        ref_eng.step()
        steps += 1
    for k in range(1, steps):
        path = str(tmp_path / f"j{k}.jsonl")
        eng = port_engine(journal_path=path, **kw)
        hs = [eng.submit(p, NEW, params=_params_for(i)) for i, p in enumerate(ps)]
        for _ in range(k):
            eng.step()
        del eng  # the crash: no close, no drain
        eng2 = port_engine(journal_path=path, **kw)
        resumed = {r.trace_id: r for r in eng2.recover()}
        assert resumed and eng2.statusz()["journal"]["recovered_requests"] == len(resumed)
        drive(eng2, [], NEW)
        got = [resumed[h.trace_id].tokens if h.trace_id in resumed else h.tokens
               for h in hs]
        assert got == [r.tokens for r in ref], f"killed after step {k}"
        assert no_leaks(eng2)
        assert not eng2.journal.live_entries()


def test_io_error_degrades_and_strict_raises(tmp_path):
    ps = prompts(3, seed=12)
    plan = [dict(site="journal_write", kind="io_error", visit=2)]
    eng = port_engine(journal_path=str(tmp_path / "j.jsonl"), fault_plan=plan)
    with pytest.warns(UserWarning, match="degrading to journal-off"):
        reqs = drive(eng, ps, 8)
    assert all(r.finish_reason == "length" for r in reqs)
    snap = eng.metrics.snapshot()
    assert snap["serve/journal_degraded"] == 1.0
    assert eng.statusz()["journal"]["degraded"] is True
    assert [r.tokens for r in reqs] == [r.tokens for r in
                                        drive(port_engine(), ps, 8)]
    assert no_leaks(eng)
    from solvingpapers_tpu_torch.serve.faults import InjectedFault

    strict = port_engine(journal_path=str(tmp_path / "s.jsonl"),
                         journal_strict=True, fault_plan=[
                             dict(site="journal_write", kind="io_error",
                                  visit=0)])
    with pytest.raises(InjectedFault, match="journal I/O"):
        strict.submit(ps[0], max_new_tokens=4)
    with pytest.raises(ValueError, match="journal_strict"):
        port_engine(journal_strict=True)


# ------------------------------------------------------- HTTP surface


def _decode(ids):
    return "".join(chr(97 + int(i) % 26) for i in ids)


def _sse(url, body=None, headers=None, timeout=60):
    """(X-Request-Id, [(event id, parsed event)]) of one SSE POST."""
    req = urllib.request.Request(
        url, data=json.dumps(body or {}).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    events = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        rid, cur = r.headers.get("X-Request-Id"), None
        for raw in r:
            line = raw.decode().rstrip("\n")
            if line.startswith("id: "):
                cur = line[4:]
            elif line.startswith("data: "):
                if line[6:] == "[DONE]":
                    break
                events.append((cur, json.loads(line[6:])))
    return rid, events


def _text(events):
    return "".join(e["choices"][0].get("text") or "" for _, e in events)


def _server(engine):
    from solvingpapers_tpu_torch.serve import ApiServer

    return ApiServer(engine, decode=_decode, model_name="gpt-tiny")


def test_last_event_id_resume_and_the_journal_fallback(tmp_path):
    """One journaled server: event ids, a resume from offset 5 of a
    finished stream (registry), the same from the journal once the
    registry has forgotten it, 400 / 404 / 409 on a malformed, unknown or
    too-far cursor, and GET /v1/requests/<id> from the registry, then the
    journal (source "journal")."""
    eng = port_engine(api_port=0, journal_path=str(tmp_path / "j.jsonl"))
    srv = _server(eng)
    url = srv.url("/v1/completions")
    try:
        body = {"prompt": [1, 2, 3, 4], "max_tokens": 12, "stream": True,
                "temperature": 0}
        rid, events = _sse(url, body, {"X-Request-Id": "jrn-1"})
        assert rid == "jrn-1" and events[-1][0] == "jrn-1:12"
        assert all(i.startswith("jrn-1:") for i, _ in events)
        full = _text(events)
        entry = eng.journal.lookup("jrn-1")
        assert entry.finished and _decode(entry.tokens) == full
        _, tail = _sse(url, {}, {"Last-Event-ID": "jrn-1:5"})
        assert _decode(entry.tokens[:5]) + _text(tail) == full
        assert tail[-1][1]["choices"][0]["finish_reason"] == "length"
        with urllib.request.urlopen(srv.url("/v1/requests/jrn-1")) as r:
            doc = json.loads(r.read())
        assert "source" not in doc and doc["state"] == "finished"
        assert doc["phase_sum_s"] == pytest.approx(doc["e2e_s"], abs=1e-4)
        # the reference's per-request facts of the KV storage
        assert (doc["facts"]["kv_quant"], doc["facts"]["kv_exact"]) == (None, False)
        with srv._timeline_lock:
            srv._timelines.clear()
        _, again = _sse(url, {}, {"Last-Event-ID": "jrn-1:5"})
        assert _text(again) == _text(tail)
        assert again[-1][0] == "jrn-1:12"
        with urllib.request.urlopen(srv.url("/v1/requests/jrn-1")) as r:
            doc = json.loads(r.read())
        assert doc["source"] == "journal" and doc["tokens"] == entry.tokens
        assert doc["usage"]["completion_tokens"] == 12
        for header, code in (("nope", 400), ("ghost:3", 404), ("jrn-1:13", 409)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _sse(url, {}, {"Last-Event-ID": header})
            assert e.value.code == code, header
    finally:
        srv.close()


@pytest.mark.parametrize("paged", [False, True], ids=["lane", "paged"])
def test_resume_after_restart_replays_the_recovered_stream(tmp_path, paged):
    """A journaled engine dies mid-stream (dropped unclosed); a fresh
    engine and server on the same journal recover it, and a Last-Event-ID
    reconnect to the NEW server gets the committed tokens past the
    client's offset and the live tail, to the same text as an
    uninterrupted run."""
    prompt = np.asarray([3, 1, 4, 1, 5], np.int64)
    kw = PAGED if paged else {}
    ref = drive(port_engine(**kw), [prompt], 12)[0]
    path = str(tmp_path / "j.jsonl")
    eng = port_engine(journal_path=path, **kw)
    req = eng.submit(prompt, max_new_tokens=12, trace_id="restart-1")
    eng.step()
    seen = len(req.tokens)
    assert 0 < seen < 12
    del eng, req
    eng2 = port_engine(api_port=0, journal_path=path, **kw)
    resumed = eng2.recover()
    assert [r.trace_id for r in resumed] == ["restart-1"]
    srv = _server(eng2)
    try:
        _, ev = _sse(srv.url("/v1/completions"), {},
                     {"Last-Event-ID": f"restart-1:{seen}"})
        assert _decode(ref.tokens[:seen]) + _text(ev) == _decode(ref.tokens)
        assert ev[-1][0] == "restart-1:12"
        assert ev[-1][1]["choices"][0]["finish_reason"] == "length"
    finally:
        srv.close()
    assert resumed[0].tokens == ref.tokens


def test_recovery_finishes_what_it_cannot_resume(tmp_path):
    """A grammar request finishes "error" at recovery, a committed
    stream that already ended ("length") is finished with its reason, an
    untracked SLO class is dropped, and an in-flight one resumes."""
    path = str(tmp_path / "j.jsonl")
    j = tjournal.Journal(path)
    greedy = dataclasses.asdict(SamplingParams())
    j.append_submit("g", [1, 2], 4, None, greedy, 0.0, grammar=True)
    j.append_submit("done", [1, 2], 2, None, greedy, 0.0)
    j.append_commit("done", [5, 6])
    j.append_submit("live", [3, 4], 6, None, {**greedy, "slo": "gold",
                                              "kv_exact": False}, 0.0)
    j.append_commit("live", [7])
    j.close()
    eng = port_engine(journal_path=path)
    with pytest.warns(UserWarning, match="cannot be recovered"):
        resumed = eng.recover()
    assert [r.trace_id for r in resumed] == ["live"]
    assert resumed[0].params.slo is None and resumed[0].tokens == [7]
    finished = {e.rid: e.finish_reason for e in eng.journal.finished.values()}
    assert finished == {"g": "error", "done": "length"}
    drive(eng, [], 6)
    assert resumed[0].finish_reason == "length" and len(resumed[0].tokens) == 6
    assert BASE["n_slots"] == 3  # the shape the journal's prompts fit
