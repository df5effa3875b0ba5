"""The port's replay harness (`serve/replay.py`), the engine's
`replay_submit`, and the front door's replay endpoint, against the
contracts of the JAX package's `tests/test_replay.py`. The harness's
cross-package check (a journal recorded by the JAX engine, replayed
byte-exact on the port) is in `test_torch_fleet.py`, on the journals of
its reference fleet.

Exactness: an identical-config replay of a journaled greedy and seeded
workload is byte-exact on the lane and the paged pool, paced or not, and
its teacher-forced cuts all agree. An n-gram speculative candidate is
built (its byte-exact replay is `tests/test_torch_spec.py`'s); an MTP one
is built and the engine's check refuses it for a model without heads;
a quantized one (``kv_quant=int8``) is built.
Screening: entries the candidate cannot replay token-exactly land
as skips with reasons, never as divergences. Snapshot loading: a torn
final line is tolerated, mid-file corruption raises, a journal rotating
under a concurrent reader never tears a record, and one ENOENT is
retried. `replay_submit` writes no journal record, keeps the harness's
budget over the recorded one, and leaves a replay-less engine's metrics
without replay keys. HTTP: `POST /v1/replay` runs in the background, one
at a time, and `GET /v1/replay/<id>` serves progress then the report,
whose `replay/*` gauges then ride the live engine's /metrics.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from durability_models import BASE, port_model
from solvingpapers_tpu_torch.serve import (
    ApiServer,
    ReplayHarness,
    SamplingParams,
    ServeConfig,
    ServeEngine,
)
from solvingpapers_tpu_torch.serve.journal import Journal, JournalError, read_entries
from solvingpapers_tpu_torch.serve.replay import (
    apply_overrides,
    report_gauges,
    sanitize_config,
)
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)


def _cfg(**kw):
    return ServeConfig(**{**BASE, "max_len": 32, "max_prefills_per_step": 3,
                          **kw})


def _prompts(n, seed=0, size=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=size) for _ in range(n)]


def _params_for(i):
    """Greedy and two seeded shapes: every stream byte-replayable."""
    if i % 3 == 1:
        return SamplingParams(temperature=0.8, top_p=0.9, seed=100 + i)
    if i % 3 == 2:
        return SamplingParams(temperature=1.3, top_k=8, seed=200 + i)
    return None


def _record(path, n=6, max_new=8, **cfg_kw):
    """Serve a small workload through a journaled engine (closed after)
    and return its handles: the recorded streams."""
    eng = ServeEngine(port_model(), _cfg(journal_path=path, **cfg_kw),
                      device="cpu")
    hs = [eng.submit(p, max_new_tokens=max_new, params=_params_for(i))
          for i, p in enumerate(_prompts(n))]
    eng.run()
    eng.close()
    return hs


def _harness():
    return ReplayHarness(port_model())


# ------------------------------------------------------------ exactness


@pytest.mark.parametrize("candidate, pace", [
    ({}, False), ({"paged": True, "page_size": 8}, False), ({}, True)],
    ids=["lane", "paged", "lane-paced"])
def test_identical_config_replay_byte_exact(tmp_path, candidate, pace):
    path = str(tmp_path / "j.jsonl")
    _record(path, **candidate)
    h = _harness()
    progress = []
    report = h.run(h.load(path), _cfg(**candidate), cut_stride=4, pace=pace,
                   progress=lambda d, t: progress.append((d, t)))
    assert report["streams_total"] == report["streams_compared"] == 6
    assert report["byte_exact_rate"] == 1.0, report["diverged"]
    assert report["agreement_rate"] == 1.0
    assert report["agreement_rate_greedy"] == 1.0
    assert report["agreement_rate_seeded"] == 1.0
    assert report["cut_positions"] > 0 and not report["skipped"]
    assert {r["kind"] for r in report["streams"]} == {"greedy", "seeded"}
    assert report["replay_metrics"]["tokens_per_sec"] > 0
    assert progress == [(1, 3), (2, 3), (3, 3)]


def test_quantized_or_speculative_candidate_is_refused_naming_a5():
    """An n-gram speculative candidate is built (its knobs land in the
    config); so is an MTP drafter's, and the engine's check then refuses
    it for a model without heads, with the engine's message: nothing
    falls back. The quantized pool's knobs build their int8 candidate, as
    the reference's do."""
    from solvingpapers_tpu_torch.serve.engine import check_drafter

    cand = apply_overrides(_cfg(), {"speculative": "ngram", "spec_k": "4",
                                    "spec_rounds": "2"})
    assert (cand.speculative, cand.spec_k, cand.spec_rounds) == ("ngram", 4, 2)
    for over in ({"speculative": "mtp"}, {"spec_k": "2", "speculative": "mtp"}):
        cand = apply_overrides(_cfg(), over)
        assert cand.speculative == "mtp"
        with pytest.raises(ValueError, match=r"\(mtp_heads == 0\)"):
            check_drafter(port_model().cfg, cand)
    cand = apply_overrides(_cfg(), {"kv_quant": "int8", "kv_quant_block": "8",
                                    "kv_exact_lanes": "2"})
    assert (cand.kv_quant, cand.kv_quant_block, cand.kv_exact_lanes) == ("int8", 8, 2)


def test_baseline_deltas_and_max_requests(tmp_path):
    path = str(tmp_path / "j.jsonl")
    _record(path)
    h = _harness()
    report = h.run(h.load(path), _cfg(decode_block=8), baseline=_cfg(),
                   cut_stride=0, max_requests=3)
    assert report["streams_total"] == 3
    assert report["agreement_rate"] is None  # the cut pass is off
    assert "baseline_metrics" in report
    assert any(k.endswith("_delta_pct") for k in report["deltas"])


# ------------------------------------------------------------ screening


def test_unreplayable_entries_become_skips(tmp_path):
    """Skips are never divergences. A `kv_exact` entry replays on an
    unquantized candidate, where the flag is a no-op."""
    path = str(tmp_path / "j.jsonl")
    j = Journal(path)
    for rid, params, commit, reason in (
            ("gram", {}, [5], "length"),
            ("stop", {"temperature": 0.0, "stop": ["xy"]}, [5], "stop"),
            ("topk", {"temperature": 1.0, "top_k": 999, "seed": 1}, [5],
             "length"),
            ("long", {}, list(range(40)), "length"),
            ("none", {}, [], "length"),
            ("err", {}, [5], "error"),
            ("live", {}, [5], None),
            ("kvx", {"temperature": 0.0, "kv_exact": True}, [5, 6], "length"),
            ("ok", {}, [5, 6], "length")):
        j.append_submit(rid, [1, 2], 40 if rid == "long" else 4, None, params,
                        0.0, grammar=rid == "gram")
        if commit:
            j.append_commit(rid, commit)
        if reason:
            j.append_finish(rid, reason, {})
    j.sync()
    j.close()
    report = _harness().run(read_entries(path), _cfg(), cut_stride=0)
    reasons = {s["rid"]: s["reason"] for s in report["skipped"]}
    assert "grammar" in reasons["gram"]
    assert "detokenize" in reasons["stop"]
    assert "sample_cap" in reasons["topk"]
    assert "capacity" in reasons["long"]
    assert "no committed tokens" in reasons["none"]
    assert "token-faithful" in reasons["err"]
    assert "still live" in reasons["live"]
    assert report["streams_replayed"] == report["streams_compared"] == 2
    assert {r["rid"] for r in report["streams"]} == {"kvx", "ok"}


def test_empty_corpus_report_shape(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = Journal(path)
    j.append_submit("live", [1, 2], 4, None, {}, 0.0)
    j.sync()
    j.close()
    report = _harness().run(read_entries(path), _cfg())
    assert report["streams_replayed"] == 0
    assert report["byte_exact_rate"] is None and report["agreement_rate"] is None
    g = report_gauges(report)
    assert "replay/byte_exact_rate" not in g  # omitted, not zero-filled
    assert g["replay/streams_compared"] == 0.0


# -------------------------------------------------------- snapshot load


@pytest.mark.parametrize("damage", ["torn_tail", "midfile"])
def test_damaged_journal_snapshot(tmp_path, damage):
    """A crash-torn final line is tolerated (the replay still matches);
    a malformed record before it is corruption and raises."""
    path = str(tmp_path / "j.jsonl")
    _record(path, n=3)
    if damage == "torn_tail":
        with open(path, "a") as f:
            f.write('{"kind":"commit","rid":"x","tok')
        entries = read_entries(path)
        assert len(entries) == 3
        report = _harness().run(entries, _cfg(), cut_stride=0)
        assert report["byte_exact_rate"] == 1.0
    else:
        lines = open(path).read().splitlines()
        lines[1] = '{"kind": "comm'
        open(path, "w").write("\n".join(lines) + "\n")
        with pytest.raises(JournalError):
            read_entries(path)


def test_rotation_under_concurrent_reader(tmp_path):
    """A journal compacting (atomic swap) while a reader loops
    `read_entries` on its path: every snapshot parses, whole."""
    path = str(tmp_path / "j.jsonl")
    j = Journal(path, rotate_finished=4)
    stop = threading.Event()
    errors = []

    def reader():
        while not stop.is_set():
            try:
                for e in read_entries(path):
                    assert e.rid.startswith("r")
            except (JournalError, FileNotFoundError) as exc:
                errors.append(exc)

    t = threading.Thread(target=reader)
    t.start()
    try:
        for i in range(120):
            rid = f"r{i}"
            j.append_submit(rid, [1, 2, 3], 8, None, {}, float(i))
            j.append_commit(rid, [4, 5])
            j.append_finish(rid, "length", {})
            j.sync()
    finally:
        stop.set()
        t.join()
        j.close()
    assert j.stats()["rotations"] > 10
    assert not errors, errors[0]


def test_enoent_during_swap_retried_once(tmp_path, monkeypatch):
    path = str(tmp_path / "j.jsonl")
    _record(path, n=3)
    real_open = open
    fails = {"n": 1}

    def flaky_open(p, *a, **kw):
        if p == path and fails["n"] > 0:
            fails["n"] -= 1
            raise FileNotFoundError(p)
        return real_open(p, *a, **kw)

    monkeypatch.setattr("builtins.open", flaky_open)
    assert len(read_entries(path, retry_delay_s=0.0)) == 3
    with pytest.raises(FileNotFoundError):
        read_entries(str(tmp_path / "gone.jsonl"), retry_delay_s=0.0)


# ------------------------------------------------------ config plumbing


def test_apply_overrides_and_sanitize():
    out = apply_overrides(_cfg(), {"decode_block": "8", "paged": "true"})
    assert out.decode_block == 8 and out.paged
    with pytest.raises(ValueError, match="unknown ServeConfig field"):
        apply_overrides(_cfg(), {"decode_blocks": 8})
    s = sanitize_config(_cfg(journal_path="x.jsonl", api_port=0, max_waiting=4,
                             trace=True, status_port=0), n_requests=100)
    assert s.journal_path is None and s.api_port is None
    assert s.status_port is None and not s.trace and s.max_waiting == 101


def test_replay_submit_contract(tmp_path):
    """Refused on a journaled engine; a committed prefix must leave budget;
    a recorded max_tokens never shadows the harness's budget, an SLO class
    the engine does not track is dropped, and a committed cut produces the
    one token the uninterrupted stream has there. A replay-less engine's
    metrics carry no replay keys."""
    jeng = ServeEngine(port_model(), _cfg(journal_path=str(tmp_path / "j.jsonl")),
                       device="cpu")
    with pytest.raises(ValueError, match="journal-off"):
        jeng.replay_submit(np.arange(4))
    jeng.close()
    eng = ServeEngine(port_model(), _cfg(), device="cpu")
    with pytest.raises(ValueError, match="budget"):
        eng.replay_submit(np.arange(4), max_new_tokens=2, committed=[1, 2])
    seeded = SamplingParams(temperature=0.9, seed=5, max_tokens=1,
                            slo="interactive")
    full = eng.replay_submit(np.arange(4), max_new_tokens=6, params=seeded)
    eng.run()
    assert len(full.tokens) == 6 and full.params.slo is None
    cut = eng.replay_submit(np.arange(4), max_new_tokens=5, params=seeded,
                            committed=full.tokens[:4])
    eng.run()
    assert cut.tokens == full.tokens[:5]
    assert not any(k.startswith("replay/") for k in eng.metrics.snapshot())


def test_report_gauge_contract(tmp_path):
    assert report_gauges(None) == {}
    path = str(tmp_path / "j.jsonl")
    _record(path, n=3)
    h = _harness()
    g = report_gauges(h.run(h.load(path), _cfg(), cut_stride=4))
    assert g["replay/byte_exact_rate"] == 1.0 and g["replay/agreement_rate"] == 1.0
    assert g["replay/streams_compared"] == 3.0 and g["replay/wall_s"] > 0
    assert "replay/first_divergence_p50" not in g  # no divergences


# ----------------------------------------------------------------- http


@pytest.fixture(scope="module")
def replay_server(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rj") / "j.jsonl")
    eng = ServeEngine(port_model(), _cfg(journal_path=path, api_port=0),
                      device="cpu")
    for i, p in enumerate(_prompts(4)):
        eng.submit(p, max_new_tokens=6, params=_params_for(i))
    eng.run()
    eng.journal.sync()
    srv = ApiServer(eng, model_name="gpt-tiny")
    yield srv, eng
    srv.close()


def _http(srv, path, body=None, method=None):
    req = urllib.request.Request(
        srv.url(path), data=json.dumps(body).encode() if body is not None
        else None, headers={"Content-Type": "application/json"},
        method=method or ("POST" if body is not None else "GET"))
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _await_replay(srv, run_id):
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        code, doc = _http(srv, f"/v1/replay/{run_id}", method="GET")
        assert code == 200
        if doc["state"] != "running":
            return doc
        time.sleep(0.02)
    return doc


@pytest.mark.parametrize("case", ["run", "single_flight", "quant"])
def test_http_replay_endpoint(replay_server, case):
    """Bad overrides 400 (an MTP candidate on a model without heads with
    the engine's message), an unknown run
    404s, a run goes 202 -> running -> finished with a byte-exact report
    and its gauges on the live engine's metrics; a second run while one
    is in flight answers 409; a kv_quant=int8 candidate runs, named in its
    report."""
    srv, eng = replay_server
    if case == "quant":
        code, doc = _http(srv, "/v1/replay", {
            "config_overrides": {"kv_quant": "int8", "kv_quant_block": 8},
            "cut_stride": 4})
        assert code == 202, doc
        doc = _await_replay(srv, doc["id"])
        assert doc["state"] == "finished", doc.get("error")
        rep = doc["report"]
        assert rep["candidate"]["kv_quant"] == "int8"
        assert rep["streams_compared"] == 4 and rep["cut_positions"] > 0
        return
    if case == "single_flight":
        with srv._replay_lock:
            srv._replay_active = True
        try:
            code, doc = _http(srv, "/v1/replay", {})
            assert code == 409 and doc["error"]["code"] == "replay_in_flight"
        finally:
            with srv._replay_lock:
                srv._replay_active = False
        return
    code, doc = _http(srv, "/v1/replay", {"config_overrides": {"nope": 1}})
    assert code == 400 and "nope" in doc["error"]["message"]
    code, doc = _http(srv, "/v1/replay", {"config_overrides": {"speculative": "mtp"}})
    assert code == 400 and "(mtp_heads == 0)" in doc["error"]["message"]
    code, doc = _http(srv, "/v1/replay/absent0000", method="GET")
    assert code == 404 and doc["error"]["code"] == "replay_not_found"
    code, doc = _http(srv, "/v1/replay", {"cut_stride": 4})
    assert code == 202, doc
    doc = _await_replay(srv, doc["id"])
    assert doc["state"] == "finished", doc.get("error")
    rep = doc["report"]
    assert rep["byte_exact_rate"] == 1.0 and rep["agreement_rate"] == 1.0
    assert doc["progress"]["done"] == doc["progress"]["total"]
    snap = eng.metrics.snapshot()
    assert snap["replay/byte_exact_rate"] == 1.0
    assert snap["replay/streams_compared"] == 4.0
