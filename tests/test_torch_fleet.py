"""The port's fleet router (`serve/fleet.py`), the engine's `adopt`, and
the front door's fleet mode, against the contracts of the JAX package's
`tests/test_fleet.py` and against the JAX package itself.

Routing: prefix affinity picks the replica whose radix tree covers the
longest prompt prefix; the health gate excludes draining, dead-loop and
unhealthy replicas; the burn gate steers an SLO class away from a burning
replica unless every candidate burns; a full replica reroutes to a peer
with room (and a traced fleet stamps the decision), and `capacity_left`
sums the admitting replicas only. Exactness: a two-replica fleet decodes
the greedy and seeded mix token for token as one engine does, and a
drain migrates every live stream onto a peer token-exactly while the
drained replica leaks nothing. Metrics: the merged histograms are the
exact sum of the replicas', and a stale shard is tagged and skipped.
HTTP: ``X-Replica-Id``, the ``fleet`` section of /statusz, one ``# TYPE``
a name in /metrics with the unlabelled count equal to the sum of the
labelled ones, ``X-Fleet-Reroutes``; a drain closes an SSE stream without
its terminal chunk and its Last-Event-ID reconnect resumes on the peer,
while a blocking request rides the migration inside its one POST. Those
two HTTP tests step the engines from the test thread (``start=False``),
so the drain lands mid-decode every time: the reference's blocking-drain
test races a started loop for the step lock and is flaky for it.

Across packages: the same prompts through the reference's manually
stepped `FleetRouter` and the port's land on the same replicas with the
same greedy streams, and the reference replicas' journals replay
byte-exact through the port's `ReplayHarness` with converted weights.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from durability_models import BASE, PAGED, gpt_tiny_pair, no_leaks, port_model
from solvingpapers_tpu_torch.metrics.hist import LogHistogram
from solvingpapers_tpu_torch.serve import (
    ApiServer,
    FleetRouter,
    SamplingParams,
    ServeConfig,
    ServeEngine,
)
from solvingpapers_tpu_torch.serve import metrics as smetrics
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)

NEW = 12


def _cfg(**kw):
    return ServeConfig(**{**BASE, "max_prefills_per_step": 3, **kw})


def _engine(**kw):
    return ServeEngine(port_model(), _cfg(**kw), device="cpu")


def _fleet(n=2, cfg_for=None, **kw):
    engines = [ServeEngine(port_model(), cfg_for(i) if cfg_for else _cfg(**kw),
                           device="cpu") for i in range(n)]
    return FleetRouter(engines, start=False)


def _prompts(n, seed=0, size=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=size) for _ in range(n)]


def _params_for(i):
    """Greedy and two seeded shapes: every stream replays."""
    if i % 3 == 1:
        return SamplingParams(temperature=0.8, top_p=0.9, seed=100 + i)
    if i % 3 == 2:
        return SamplingParams(temperature=1.3, top_k=8, seed=200 + i)
    return None


def _step_all(router):
    worked = False
    for r in router.replicas:
        if r.engine.has_work():
            with r.loop.lock:
                r.engine.step()
            worked = True
    return worked


def _drain_fleet(router):
    while _step_all(router):
        pass


def _reference(prompts, new=NEW, params_for=_params_for):
    eng = _engine()
    refs = [eng.submit(p, new, params=params_for(i) if params_for else None)
            for i, p in enumerate(prompts)]
    eng.run()
    return refs


def _warm(rep, stem):
    rep.engine.submit(stem, max_new_tokens=4)
    while rep.engine.has_work():
        rep.engine.step()


# ------------------------------------------------------------- routing


def test_prefix_affinity_routes_to_warm_replica():
    """The replica whose tree covers the prompt's prefix wins over an
    equally empty peer; with no cached prefix anywhere the least-loaded
    tie-break is deterministic."""
    router = _fleet(2, prefix_cache=True)
    rng = np.random.default_rng(5)
    stem = rng.integers(0, 64, size=32)
    _warm(router.replica("r1"), stem)
    assert router.replica("r1").probe(stem) > 0
    assert router.replica("r0").probe(stem) == 0
    probe = np.concatenate([stem[:16], rng.integers(0, 64, 8)])
    assert router.route(probe).rid == "r1"
    assert router.route(rng.integers(0, 64, size=24)).rid == "r0"


def test_health_gate_and_draining_excluded():
    router = _fleet(2)
    p = _prompts(1)[0]
    router.replica("r0").draining = True
    assert router.route(p).rid == "r1"
    router.replica("r1").loop.error = RuntimeError("loop died")
    assert router.route(p) is None
    assert router.submit(p) == (None, None)
    assert router.health == "unhealthy"
    router.replica("r0").draining = False
    assert router.route(p).rid == "r0" and router.health == "healthy"
    router.replica("r1").loop.error = None
    eng = router.replica("r1").engine
    eng._health, eng._recover_at = "unhealthy", smetrics.now() + 60.0
    assert not router.replica("r1").admitting


def test_burn_gate_steers_slo_class_away():
    """Interactive traffic avoids a replica burning that class's budget;
    when every candidate burns, the gate yields."""

    class _Hot:
        targets = {"interactive": {"objective": 0.99}}

        def burn_rate(self, cls):
            return 5.0

    router = _fleet(2)
    router.replica("r0").engine._slo = _Hot()
    p = _prompts(1)[0]
    assert router.route(p, slo="interactive").rid == "r1"
    assert router.stats["burn_avoided"] == 1
    assert router.route(p, slo="batch").rid == "r0"
    assert router.route(p).rid == "r0"
    router.replica("r1").engine._slo = _Hot()
    assert router.route(p, slo="interactive") is not None


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_full_replica_reroutes_to_peer_with_room(traced):
    """The first-ranked replica's full queue does not bounce the client:
    the router goes down the ranking, and `capacity_left` counts the
    admitting replicas only. Traced, the router's recorder stamps a
    `route` span with each candidate's scores and a `reroute` instant
    naming the replica that refused; untraced, it has no recorder."""
    router = _fleet(2, prefix_cache=True, max_waiting=2, trace=traced)
    assert (router.trace is not None) == traced
    rng = np.random.default_rng(9)
    stem = rng.integers(0, 64, size=32)
    r0, r1 = router.replica("r0"), router.replica("r1")
    _warm(r0, stem)
    for p in _prompts(2, seed=3):  # fill r0's queue (no stepping)
        assert r0.engine.submit(p, max_new_tokens=4).state != "rejected"
    assert r0.engine.scheduler.capacity_left == 0
    probe = np.concatenate([stem[:16], rng.integers(0, 64, 8)])
    assert router.route(probe).rid == "r0"  # affinity still ranks it first
    rep, req = router.submit(probe, max_new_tokens=4)
    assert rep.rid == "r1" and req.state != "rejected"
    assert router.stats["rerouted_full"] == 1
    assert req.fleet_reroutes == 1 and req.fleet_route_s >= 0.0
    assert router.capacity_left == r1.engine.scheduler.capacity_left
    r1.draining = True
    assert router.capacity_left == 0
    r1.draining = False
    if traced:
        evs = router.trace.events()
        (route,) = [e for e in evs if e.name == "route"]
        assert route.cat == "fleet" and route.args["replica"] == "r1"
        assert route.args["attempts"] == 2 and route.args["rid"] == req.trace_id
        rows = {s["replica"]: s for s in route.args["scores"]}
        assert rows["r0"]["match"] > rows["r1"]["match"]
        assert rows["r0"]["queue_room"] == 0 and "free" in rows["r1"]
        (reroute,) = [e for e in evs if e.name == "reroute"]
        assert reroute.args["rejected_by"] == "r0"
    _drain_fleet(router)


@pytest.mark.parametrize("case", ["shared_journal", "no_journal",
                                  "unknown_replica", "no_admitting_peer"])
def test_fleet_refusals(tmp_path, case):
    """Replicas may not share a journal; a drain needs a journal, a known
    replica and an admitting peer, and a refused drain leaves the gate
    open."""
    if case == "shared_journal":
        path = str(tmp_path / "same.jsonl")
        with pytest.raises(ValueError, match="OWN journal"):
            _fleet(2, journal_path=path)
        return
    if case == "no_journal":
        with pytest.raises(ValueError, match="journal"):
            _fleet(2).drain("r0")
        return
    router = _fleet(2, cfg_for=lambda i: _cfg(
        journal_path=str(tmp_path / f"j{i}.jsonl")))
    if case == "unknown_replica":
        with pytest.raises(KeyError, match="unknown replica"):
            router.drain("r9")
        return
    router.replica("r1").draining = True
    with pytest.raises(RuntimeError, match="no admitting peer"):
        router.drain("r0")
    assert router.replica("r0").admitting


# ----------------------------------------------------------- exactness


@pytest.mark.parametrize("pool", ["lane", "paged"])
def test_fleet_token_exact_vs_single_engine(pool):
    """Placement never changes a stream: every request through a
    two-replica fleet (greedy and seeded) decodes as one engine does, the
    work spreads, and nothing leaks."""
    prompts = _prompts(9, seed=1)
    refs = _reference(prompts, new=10)
    router = _fleet(2, **(PAGED if pool == "paged" else {}))
    handles, placed = [], set()
    for i, p in enumerate(prompts):
        rep, req = router.submit(p, max_new_tokens=10, params=_params_for(i))
        handles.append(req)
        placed.add(rep.rid)
    _drain_fleet(router)
    assert placed == {"r0", "r1"}
    assert [h.tokens for h in handles] == [r.tokens for r in refs]
    assert all(no_leaks(r.engine) for r in router.replicas)


@pytest.mark.parametrize("pool", ["lane", "paged"])
def test_drain_migrates_live_streams_token_exact(tmp_path, pool):
    """Drain r0 mid-decode: every live stream finishes on the peer equal
    to an uninterrupted run, the drained replica leaks nothing at once,
    the report maps each migrated id to its adopter (which journals,
    registers and traces the adoption), and the owner map follows."""
    prompts = _prompts(6, seed=2)
    refs = _reference(prompts)
    router = _fleet(2, cfg_for=lambda i: _cfg(
        journal_path=str(tmp_path / f"r{i}.jsonl"), trace=True,
        **(PAGED if pool == "paged" else {})))
    handles, where = [], {}
    for i, p in enumerate(prompts):
        rep, req = router.submit(p, max_new_tokens=NEW, params=_params_for(i),
                                 trace_id=f"mig-{i}")
        handles.append(req)
        where[req.trace_id] = rep.rid
    _step_all(router)  # one block everywhere: streams live mid-decode
    live_r0 = [h for h in handles if where[h.trace_id] == "r0" and not h.done]
    assert live_r0

    report = router.drain("r0")
    r0, r1 = router.replica("r0"), router.replica("r1")
    assert r0.draining and not r0.admitting
    assert no_leaks(r0.engine)  # reclaimed at the drain
    assert report.entries == len(live_r0) and report.errors == []
    assert sorted(report.targets) == sorted(h.trace_id for h in live_r0)
    assert all(h.done and h.finish_reason == "migrated" for h in live_r0)
    assert {peer for peer, _ in report.targets.values()} == {"r1"}
    adopted = [e for e in r1.engine.trace.events() if e.name == "journal_adopt"]
    assert sorted(e.args["rid"] for e in adopted) == sorted(report.targets)
    for h in live_r0:
        assert r1.engine.journal.is_live(h.trace_id)

    _drain_fleet(router)
    succ = {old: router.replica(peer).engine._recovered[new]
            for old, (peer, new) in report.targets.items()}
    streams = [succ[h.trace_id].tokens if h.trace_id in succ else h.tokens
               for h in handles]
    assert streams == [r.tokens for r in refs]
    assert all(router.owner(old).rid == "r1" for old in report.targets)
    assert all(no_leaks(r.engine) for r in router.replicas)
    assert router.stats["drains"] == 1
    assert router.stats["migrated_streams"] == len(live_r0)
    assert router.route(prompts[0]).rid == "r1"
    router.undrain("r0")
    assert r0.admitting


def test_held_pauses_a_started_loop_and_hands_its_lock_back():
    """`EngineLoop.held` on a running loop, as a drain under load takes
    it: counted as a waiter, it gets the lock after at most one step; no
    step runs while it is held; released, the loop finishes the stream
    as one engine does."""
    from solvingpapers_tpu_torch.serve.api import EngineLoop

    prompt = _prompts(1, seed=5)[0]
    loop = EngineLoop(_engine())
    try:
        req = loop.submit(prompt, max_new_tokens=NEW)
        with loop.held() as eng:
            assert eng is loop.engine and loop._waiters == 1
            n = len(req.tokens)
            time.sleep(0.05)
            assert len(req.tokens) == n
        assert loop._waiters == 0
        deadline = time.monotonic() + 60
        while not req.done and time.monotonic() < deadline:
            time.sleep(0.005)
        assert req.done
        assert req.tokens == _reference([prompt], params_for=None)[0].tokens
    finally:
        loop.close()


def test_adopt_refuses_what_it_cannot_resume_and_finishes_what_is_done(tmp_path):
    """`adopt` raises for an entry `_entry_request` refuses (a grammar
    stream) and queues nothing; an entry whose committed stream already
    hit its budget comes back finished, journaled through to its finish."""
    from solvingpapers_tpu_torch.serve.journal import JournalEntry

    eng = _engine(journal_path=str(tmp_path / "j.jsonl"))
    params = {"temperature": 0.0}
    with pytest.raises(ValueError, match="cannot be adopted"):
        eng.adopt(JournalEntry(rid="g", prompt=[1, 2], max_new_tokens=4,
                               eos_id=None, params=params, arrival=0.0,
                               grammar=True, tokens=[3]))
    assert not eng.has_work() and "g" not in eng._recovered
    req = eng.adopt(JournalEntry(rid="d", prompt=[1, 2], max_new_tokens=2,
                                 eos_id=None, params=params, arrival=0.0,
                                 tokens=[5, 6]))
    assert req.done and req.finish_reason == "length" and not eng.has_work()
    entry = eng.journal.lookup("d")
    assert entry.finished and entry.tokens == [5, 6]


# ------------------------------------------------------- fleet metrics


@pytest.mark.parametrize("stale", [False, True], ids=["live", "stale"])
def test_prom_sets_merge_equals_sum_of_replicas(stale):
    """The merged set's histograms are the exact merge of the replicas'
    and the fleet gauges ride it; every labelled set carries its shard's
    age, and a shard that is not admitting and past the cutoff is tagged
    stale and skipped by the merge (age alone never marks an admitting
    replica stale)."""
    router = _fleet(2)
    for i, p in enumerate(_prompts(6, seed=4)):
        router.submit(p, max_new_tokens=6, params=_params_for(i))
    _drain_fleet(router)
    r1 = router.replica("r1")
    router.stale_shard_cutoff_s = 0.05
    r1.engine.metrics._t_last = smetrics.now() - 1.0
    if stale:
        r1.draining = True
    (_, lab0, merged), (_, _, s0), (_, lab1, s1) = router.prom_sets()
    assert lab0 is None and lab1 == {"replica": "r1"}
    assert merged["fleet/replicas"] == 2.0 and merged["fleet/routed"] == 6.0
    assert merged["fleet/admitting"] == (1.0 if stale else 2.0)
    assert s1["serve/shard_age_s"] >= 0.9
    assert s1["serve/shard_stale"] == float(stale)
    assert merged["fleet/stale_shards"] == float(stale)
    hists = [k for k, v in merged.items() if isinstance(v, LogHistogram)]
    assert hists
    for k in hists:
        shards = [s0[k]] + ([] if stale else [s1[k]])
        assert merged[k].count == sum(s.count for s in shards)
        assert merged[k].sum == pytest.approx(sum(s.sum for s in shards))
    assert s1[hists[0]].count > 0  # the labelled set still serves it
    assert all(no_leaks(r.engine) for r in router.replicas)


# -------------------------------------------------------- HTTP surface


def _decode(ids):
    return "".join(chr(97 + int(i) % 26) for i in ids)


def _post(url, body, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    return urllib.request.urlopen(req, timeout=120)


def _read_sse(resp):
    """(events [(id, chunk)], saw [DONE], comment lines)."""
    events, done, comments, cur = [], False, [], None
    for raw in resp:
        line = raw.decode().rstrip("\n")
        if line.startswith("id: "):
            cur = line[4:]
        elif line.startswith("data: "):
            if line[6:] == "[DONE]":
                done = True
                break
            events.append((cur, json.loads(line[6:])))
        elif line.startswith(":"):
            comments.append(line)
    return events, done, comments


@pytest.fixture(scope="module")
def fleet_server(tmp_path_factory):
    """Two journaled replicas with started loops behind one front door."""
    jdir = tmp_path_factory.mktemp("fleet_j")
    engines = [ServeEngine(port_model(), _cfg(
        api_port=0, n_slots=2, journal_path=str(jdir / f"r{i}.jsonl")),
        device="cpu") for i in range(2)]
    srv = ApiServer(router=FleetRouter(engines), decode=_decode,
                    model_name="gpt-tiny")
    yield srv
    srv.close()


def test_http_replica_header_statusz_and_metrics(fleet_server):
    """Every response names its replica; /statusz has the fleet section,
    /healthz the router's view, and /metrics one ``# TYPE`` a name with
    each histogram's unlabelled count equal to its labelled counts' sum."""
    srv = fleet_server
    with _post(srv.url("/v1/completions"),
               {"prompt": [1, 2, 3, 4], "max_tokens": 6}) as r:
        doc = json.loads(r.read())
        assert r.headers["X-Replica-Id"] in {"r0", "r1"}
        assert r.headers.get("X-Fleet-Reroutes") is None
    assert doc["choices"][0]["finish_reason"] == "length"
    replicas = set()
    for i in range(3):
        with _post(srv.url("/v1/completions"),
                   {"prompt": [5 + i, 6, 7], "max_tokens": 4,
                    "stream": True}) as r:
            replicas.add(r.headers["X-Replica-Id"])
            _read_sse(r)
    with urllib.request.urlopen(srv.url("/statusz"), timeout=30) as r:
        fleet = json.loads(r.read())["fleet"]
    assert sorted(fleet["replicas"]) == ["r0", "r1"]
    assert fleet["routing"]["routed"] >= 4
    assert all(d["admitting"] and d["health"] == "healthy"
               for d in fleet["replicas"].values())
    with urllib.request.urlopen(srv.url("/healthz"), timeout=30) as r:
        assert r.read().strip() == b"ok"
    with urllib.request.urlopen(srv.url("/metrics"), timeout=30) as r:
        lines = r.read().decode().splitlines()
    types = {}
    for ln in lines:
        if ln.startswith("# TYPE "):
            name, kind = ln.split()[2:4]
            assert name not in types, f"duplicate TYPE for {name}"
            types[name] = kind
    assert types.get("fleet_replicas") == "gauge" and "fleet_replicas 2.0" in lines
    merged = 0
    for name in [n for n, k in types.items() if k == "histogram"]:
        unlabelled = sum(int(float(ln.rsplit(" ", 1)[1])) for ln in lines
                         if ln.startswith(f"{name}_count "))
        labelled = sum(int(float(ln.rsplit(" ", 1)[1])) for ln in lines
                       if ln.startswith(f"{name}_count{{"))
        assert unlabelled == labelled, name
        merged += unlabelled
    assert merged > 0
    assert any('replica="r0"' in ln for ln in lines)
    assert any('replica="r1"' in ln for ln in lines)


@pytest.fixture()
def stepped_server(tmp_path):
    """A journaled two-replica front door whose engines the TEST steps."""
    engines = [ServeEngine(port_model(), _cfg(
        api_port=0, n_slots=2, journal_path=str(tmp_path / f"r{i}.jsonl")),
        device="cpu") for i in range(2)]
    router = FleetRouter(engines, start=False)
    srv = ApiServer(router=router, decode=_decode, model_name="gpt-tiny")
    yield srv, router
    srv.close()


def _step_until(router, cond, timeout=60):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        if not _step_all(router):
            time.sleep(0.002)


@pytest.mark.parametrize("stream", [True, False], ids=["sse", "blocking"])
def test_http_drain_migrates_an_in_flight_request(stepped_server, stream):
    """The zero-drop protocol end to end, the drain landing mid-decode
    every time (the test steps the engines). SSE: the first connection
    ends WITHOUT a terminal chunk or [DONE], the Last-Event-ID reconnect
    lands on the adopting replica, and the two connections' text is the
    uninterrupted run's. Blocking: one POST returns the whole completion
    with the adopter's X-Replica-Id, and `GET /v1/requests/<id>` keeps
    both hops, its phases partitioning the server-observed wall."""
    srv, router = stepped_server
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    (ref,) = _reference([np.asarray(prompt)], new=24, params_for=None)
    rid = f"mig-{'sse' if stream else 'blk'}"
    out = {}

    def client():
        with _post(srv.url("/v1/completions"),
                   {"prompt": prompt, "max_tokens": 24, "temperature": 0,
                    "stream": stream}, {"X-Request-Id": rid}) as r:
            out["replica"] = r.headers.get("X-Replica-Id")
            if stream:
                out["events"], out["done"], out["comments"] = _read_sse(r)
            else:
                out["doc"] = json.loads(r.read())

    t = threading.Thread(target=client)
    t.start()
    _step_until(router, lambda: router.owner(rid) is not None)
    owner = router.owner(rid)
    for _ in range(2):  # prefill, then one block: live mid-decode
        _step_all(router)
    with owner.loop.lock:
        live = owner.engine.journal.lookup(rid)
        assert live is not None and not live.finished and live.tokens
        report = router.drain(owner.rid)
    peer, new_rid = report.targets[rid]
    assert peer != owner.rid and new_rid == rid
    _step_until(router, lambda: not t.is_alive())
    assert no_leaks(owner.engine)
    if stream:
        assert out["replica"] == owner.rid and not out["done"]
        assert any("migrated" in c for c in out["comments"])
        assert all(c["choices"][0].get("finish_reason") is None
                   for _, c in out["events"])
        seen = int(out["events"][-1][0].split(":")[1]) if out["events"] else 0
        second = {}

        def reconnect():
            with _post(srv.url("/v1/completions"), {},
                       {"Last-Event-ID": f"{rid}:{seen}"}) as r:
                second["replica"] = r.headers.get("X-Replica-Id")
                second["events"], second["done"], _ = _read_sse(r)

        t2 = threading.Thread(target=reconnect)
        t2.start()
        _step_until(router, lambda: not t2.is_alive())
        assert second["replica"] == peer and second["done"]
        head = "".join(c["choices"][0].get("text", "") for _, c in out["events"])
        tail = "".join(c["choices"][0].get("text", "")
                       for _, c in second["events"])
        assert head + tail == _decode(ref.tokens)
        assert second["events"][-1][1]["choices"][0]["finish_reason"] == "length"
        assert second["events"][-1][0] == f"{rid}:24"
    else:
        assert out["replica"] == peer
        doc = out["doc"]
        assert doc["choices"][0]["finish_reason"] == "length"
        assert doc["choices"][0]["text"] == _decode(ref.tokens)
        assert doc["usage"]["completion_tokens"] == 24
        with urllib.request.urlopen(srv.url(f"/v1/requests/{rid}"),
                                    timeout=30) as r:
            trail = json.loads(r.read())
        fl = trail["fleet"]
        assert fl["migrated"] and fl["replica"] == peer
        assert [h["replica"] for h in fl["hops"]] == [owner.rid, peer]
        assert [h["finish_reason"] for h in fl["hops"]] == ["migrated", "length"]
        assert "migrate" in trail["phases"] and "peer_decode" in trail["phases"]
        assert trail["phase_sum_s"] == pytest.approx(trail["e2e_s"], rel=0.05,
                                                     abs=1e-3)


def test_http_rerouted_response_carries_reroute_header(tmp_path):
    """A response whose submit was retried on a peer carries
    ``X-Fleet-Reroutes: 1`` beside X-Replica-Id (the engines are stepped
    by the test, so r0 is full when the request arrives)."""
    engines = [ServeEngine(port_model(), _cfg(
        api_port=0, n_slots=1, max_waiting=1, prefix_cache=True),
        device="cpu") for _ in range(2)]
    router = FleetRouter(engines, start=False)
    srv = ApiServer(router=router, decode=_decode, model_name="gpt-tiny")
    try:
        rng = np.random.default_rng(21)
        stem = rng.integers(0, 64, size=24)
        r0 = router.replica("r0")
        _warm(r0, stem)
        r0.engine.submit(rng.integers(0, 64, 8), max_new_tokens=20)
        r0.engine.step()  # admitted: the slot is busy
        r0.engine.submit(rng.integers(0, 64, 8), max_new_tokens=20)
        assert r0.engine.scheduler.capacity_left == 0
        out = {}

        def client():
            with _post(srv.url("/v1/completions"),
                       {"prompt": [int(x) for x in stem[:16]] + [1, 2, 3],
                        "max_tokens": 2, "temperature": 0}) as r:
                out["headers"], out["doc"] = r.headers, json.loads(r.read())

        t = threading.Thread(target=client)
        t.start()
        # no step before the request is routed: a step would admit r0's
        # queued request and free the room the test needs full
        deadline = time.monotonic() + 60
        while not router.stats["routed"] and time.monotonic() < deadline:
            time.sleep(0.002)
        _step_until(router, lambda: not t.is_alive())
        assert out["headers"]["X-Fleet-Reroutes"] == "1"
        assert out["headers"]["X-Replica-Id"] == "r1"
        assert out["doc"]["choices"][0]["finish_reason"] == "length"
    finally:
        srv.close()


# -------------------------------------------------- against the reference


@pytest.fixture(scope="module")
def reference_fleet(tmp_path_factory):
    """The same greedy traffic through the reference's manually stepped
    two-replica fleet (journaled, prefix cache on) and the port's, on one
    set of weights: prompts share four stems, and the replicas step after
    every second submission, so affinity and load both steer."""
    from solvingpapers_tpu.serve import fleet as jfleet
    from solvingpapers_tpu.serve.engine import ServeConfig as JServeConfig
    from solvingpapers_tpu.serve.engine import ServeEngine as JServeEngine

    jm, params, tm = gpt_tiny_pair()
    jdir = tmp_path_factory.mktemp("ref_fleet")
    rng = np.random.default_rng(7)
    stems = [rng.integers(0, 64, size=16) for _ in range(4)]
    prompts = [np.concatenate([stems[i % 4], rng.integers(0, 64, 8)])
               for i in range(12)]
    kw = dict(BASE, max_prefills_per_step=3, prefix_cache=True)
    jrouter = jfleet.FleetRouter(
        [JServeEngine(jm, params, JServeConfig(
            **kw, journal_path=str(jdir / f"r{i}.jsonl"))) for i in range(2)],
        start=False)
    trouter = FleetRouter(
        [ServeEngine(tm, ServeConfig(**kw), device="cpu") for _ in range(2)],
        start=False)
    picks = {"reference": [], "port": []}
    handles = {"reference": [], "port": []}
    for i, p in enumerate(prompts):
        for name, router in (("reference", jrouter), ("port", trouter)):
            rep, req = router.submit(p.astype(np.int32), max_new_tokens=NEW)
            picks[name].append(rep.rid)
            handles[name].append(req)
        if i % 2:
            _step_all(jrouter)
            _step_all(trouter)
    _drain_fleet(jrouter)
    _drain_fleet(trouter)
    for r in jrouter.replicas:
        r.engine.journal.sync()
    return {"picks": picks, "handles": handles, "tm": tm,
            "journals": [str(jdir / f"r{i}.jsonl") for i in range(2)],
            "stats": (jrouter.stats, trouter.stats)}


def test_routing_and_greedy_streams_match_the_reference_router(reference_fleet):
    """Each request lands on the same replica under both routers (the
    ranking's affinity, load and id keys agree) and every greedy stream is
    the reference's token for token."""
    f = reference_fleet
    assert f["picks"]["port"] == f["picks"]["reference"]
    assert set(f["picks"]["port"]) == {"r0", "r1"}
    assert ([h.tokens for h in f["handles"]["port"]]
            == [[int(t) for t in h.tokens] for h in f["handles"]["reference"]])
    jstats, tstats = f["stats"]
    assert tstats == jstats and tstats["affinity_hits"] > 0


@pytest.mark.parametrize("pool", ["lane", "paged"])
def test_reference_journal_replays_byte_exact_on_the_port(reference_fleet,
                                                          pool):
    """The reference replicas' journals, replayed by the port's
    `ReplayHarness` at the recording config on converted weights: every
    greedy stream byte-exact and every teacher-forced cut in agreement."""
    from solvingpapers_tpu_torch.serve import ReplayHarness

    harness = ReplayHarness(reference_fleet["tm"])
    cand = _cfg(**(PAGED if pool == "paged" else {"prefix_cache": True}))
    reports = [harness.run(harness.load(j), cand, cut_stride=5)
               for j in reference_fleet["journals"]]
    assert sum(r["streams_compared"] for r in reports) == 12
    assert all(r["byte_exact_rate"] == 1.0 and r["skipped"] == []
               for r in reports)
    assert all(r["agreement_rate_greedy"] == 1.0 for r in reports)
