"""The port's flight recorder (`metrics/trace.py`) and the engine's and
front door's trace hooks against the JAX package's.

Across packages: the same events recorded in both `FlightRecorder`s
export the identical Chrome trace; the reference's `summarize_trace` and
`format_summary` on a trace the port's engine and front door exported
equal the port's (the reference's always-present `programs` section is
empty on it); `load_chrome` agrees on both file shapes.

On the port alone: traced streams equal untraced ones (lane pool, and
paged with the prefix cache); each request's queue + prefill + decode
spans partition its submit -> finish wall exactly; the anomaly monitor
dumps the ring's tail, a metrics snapshot and the time series, and
rotates keep-newest past `max_dumps`; `cli trace-summary` prints the
summary of an exported file and exits 2 on a missing or truncated one.
"""

import json
import socket
import time

import numpy as np
import pytest

from durability_models import PAGED, drive, port_engine, prompts
from solvingpapers_tpu.metrics import trace as jtrace
from solvingpapers_tpu_torch import cli
from solvingpapers_tpu_torch.metrics import trace as ttrace
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)

NEW = 8


def _record(mod, clock):
    rec = mod.FlightRecorder(capacity=64, clock=clock)
    rec.instant("submit", "request", "queue", req=1, ts=0.5, prompt_len=7)
    rec.complete("queue", "request", "queue", ts=0.5, dur=0.25, req=1)
    rec.complete("prefill", "request", "slot10", ts=0.75, dur=0.125, req=1,
                 prefilled=7, matched=0)
    rec.counter("queue_depth", "engine", "engine", depth=3)
    rec.complete("decode_block", "engine", "slot2", ts=0.9, dur=0.05, req=2)
    rec.instant("prefix_lookup", "prefix", "prefix", matched=16, hit=1)
    with rec.span("step", "engine", "engine", prefills=1):
        pass
    rec.complete("decode", "request", "slot10", ts=0.875, dur=0.5, req=1,
                 tokens=4)
    rec.instant("finish", "request", "slot10", req=1, ts=1.375,
                reason="length")
    rec.complete("accept", "http", "http", ts=0.25, dur=0.1, req=1)
    rec.instant("only", "request", "queue", req=3)
    return rec


def test_recorders_export_the_same_chrome_trace():
    ticks = iter(np.arange(2.0, 3.0, 0.0625))
    ours = _record(ttrace, lambda: float(next(ticks)))
    ticks = iter(np.arange(2.0, 3.0, 0.0625))
    ref = _record(jtrace, lambda: float(next(ticks)))
    assert ours.to_chrome() == ref.to_chrome()
    assert [e.to_dict() for e in ours.last(4)] == [e.to_dict() for e in ref.last(4)]
    assert len(ours) == len(ref) and ours.total_recorded == ref.total_recorded
    small = ttrace.FlightRecorder(capacity=2)
    for i in range(5):
        small.instant(f"e{i}", "engine", "engine")
    assert [e.name for e in small.events()] == ["e3", "e4"]


def _sse(host, port, body, rid):
    payload = json.dumps({**body, "stream": True}).encode()
    s = socket.create_connection((host, port), timeout=60)
    s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: t\r\nX-Request-Id: "
              + rid.encode() + b"\r\nContent-Type: application/json\r\n"
              b"Content-Length: " + str(len(payload)).encode() + b"\r\n\r\n"
              + payload)
    buf = b""
    while not buf.endswith(b"data: [DONE]\n\n"):
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    s.close()
    return buf


@pytest.fixture(scope="module")
def served_trace(tmp_path_factory):
    """A traced engine behind the front door: two SSE requests and three
    direct submits, exported."""
    from solvingpapers_tpu_torch.serve import ApiServer

    eng = port_engine(api_port=0, trace=True)
    srv = ApiServer(eng)
    try:
        for i, p in enumerate(prompts(2, seed=21)):
            out = _sse(srv.host, srv.port, {"prompt": p.tolist(),
                                            "max_tokens": NEW,
                                            "temperature": 0}, f"t-{i}")
            assert out.endswith(b"data: [DONE]\n\n")
        reqs = [srv.loop.submit(p, max_new_tokens=NEW)
                for p in prompts(3, seed=22)]
        deadline = time.monotonic() + 60
        while not all(r.done for r in reqs) and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        srv.close()
    path = str(tmp_path_factory.mktemp("trace") / "t.json")
    eng.trace.export_chrome(path)
    return path, eng, reqs


def test_reference_summary_of_a_port_trace_equals_the_ports(served_trace):
    path, _, _ = served_trace
    ours = ttrace.summarize_trace(path)
    ref = jtrace.summarize_trace(path)
    assert ref.pop("programs") == {}
    assert ours == ref
    assert ours["n_requests"] == 5 and "http" in ours
    assert ours["finish_reasons"] == {"length": 5}
    for top in (2, 10):
        assert ttrace.format_summary(ours, top=top) == jtrace.format_summary(
            jtrace.summarize_trace(path), top=top)
    assert ttrace.load_chrome(path) == jtrace.load_chrome(path)
    events = ttrace.load_chrome(path)
    bare = path + ".events.json"
    with open(bare, "w") as f:
        json.dump(events, f)
    assert ttrace.load_chrome(bare) == jtrace.load_chrome(bare) == events


def test_phases_partition_each_request(served_trace):
    """queue + prefill + decode = finish - submit for every request, to
    the export's microsecond rounding; the HTTP phases extend it."""
    path, _, reqs = served_trace
    rows = {r["req"]: r for r in ttrace.summarize_trace(path)["requests"]}
    for req in reqs:
        row = rows[req.id]
        assert sum(row["phases"].values()) == pytest.approx(
            req.finish_time - req.submit_time, abs=5e-6)
        assert row["tokens"] == NEW and row["slot"].startswith("slot")
    http_rows = [r for r in rows.values() if "http_phases" in r]
    assert len(http_rows) == 2
    for r in http_rows:
        assert set(r["http_phases"]) == set(ttrace._HTTP_PHASES)
        assert r["e2e_s"] > r["total_s"]


@pytest.mark.parametrize("paged", [False, True], ids=["lane", "paged_prefix"])
def test_traced_streams_equal_untraced(paged):
    ps = prompts(5, seed=23)
    stem = prompts(1, seed=24, lo=16, hi=17)[0]
    ps += [np.concatenate([stem, p[:4]]) for p in ps[:3]]
    kw = dict(PAGED, prefix_cache=True, prefix_page=8) if paged else {}
    plain = drive(port_engine(**kw), ps, NEW)
    eng = port_engine(trace=True, **kw)
    traced = drive(eng, ps, NEW)
    assert [r.tokens for r in traced] == [r.tokens for r in plain]
    names = {e.name for e in eng.trace.events()}
    assert {"submit", "queue", "prefill", "decode", "finish", "step",
            "prefill_program", "decode_block"} <= names
    if paged:
        assert {"prefix_lookup", "prefix_snapshot", "share"} <= names


def test_anomaly_monitor_dumps_tail_snapshot_and_timeseries(tmp_path):
    from solvingpapers_tpu_torch.metrics.timeseries import TimeSeriesStore

    rec = ttrace.FlightRecorder(capacity=32)
    store = TimeSeriesStore(capacity=4, interval_s=1.0, clock=lambda: 0.0)
    store.sample({"occupancy": 0.5}, {"serve/tokens_out": 10.0})
    path = str(tmp_path / "dumps.jsonl")
    mon = ttrace.AnomalyMonitor(rec, path, snapshot_fn=lambda: {"x": 1.0},
                                last_n=3, min_steps=4, max_dumps=2,
                                reject_burst=2, timeseries_fn=store.doc)
    for i in range(6):
        rec.instant(f"e{i}", "engine", "engine")
    for _ in range(4):
        mon.observe_step(0.01)
    mon.observe_step(0.5)  # 50x the median: a slow step
    mon.observe_reject()
    mon.observe_reject()  # a burst of 2
    with pytest.warns(RuntimeWarning, match="rotating keep-newest"):
        mon.observe_finish("timeout")
    lines = [json.loads(ln) for ln in open(path)]
    assert [d["kind"] for d in lines] == ["reject_burst", "finish_timeout"]
    assert mon.dumps == 3
    assert lines[-1]["metrics"] == {"x": 1.0}
    assert [e["name"] for e in lines[-1]["events"]] == ["e3", "e4", "e5"]
    assert lines[-1]["timeseries"]["series"]["serve/tokens_out"] == [10.0]


def test_engine_anomaly_dump_on_quarantine(tmp_path):
    path = str(tmp_path / "dumps.jsonl")
    eng = port_engine(trace=True, trace_dump_path=path,
                      fault_plan=[dict(site="decode", kind="nan", visit=0)])
    drive(eng, prompts(1, seed=25), NEW)
    kinds = [json.loads(ln)["kind"] for ln in open(path)]
    assert "quarantine" in kinds
    dump = [json.loads(ln) for ln in open(path)][kinds.index("quarantine")]
    assert "timeseries" in dump and dump["metrics"]["serve/fault_injected"] == 1.0
    with pytest.raises(ValueError, match="trace_dump_path"):
        port_engine(trace_dump_path=path)


def test_cli_trace_summary_round_trip(served_trace, tmp_path, capsys):
    path, _, _ = served_trace
    assert cli.main(["trace-summary", path, "--top", "3"]) == 0
    out = capsys.readouterr().out.rstrip("\n")
    assert out == ttrace.format_summary(ttrace.summarize_trace(path), top=3)
    assert cli.main(["trace-summary", str(tmp_path / "none.json")]) == 2
    torn = tmp_path / "torn.json"
    torn.write_text(open(path).read()[:200])
    assert cli.main(["trace-summary", str(torn)]) == 2
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    assert cli.main(["trace-summary", str(empty)]) == 1
    err = capsys.readouterr().err
    assert "no trace file" in err and "not valid JSON" in err


# ------------------------------------------------------------------ fleet


def _fleet_sections(mod):
    """A router recorder (route, reroute, migrate and drain events) and two
    replica recorders, in `mod`'s package."""
    ticks = iter(np.arange(1.0, 9.0, 0.03125))
    router = mod.FlightRecorder(capacity=64, clock=lambda: float(next(ticks)))
    router.complete("route", "fleet", "router", ts=0.1, dur=0.01, req=1,
                    rid="a", replica="r0", attempts=1, scores=[])
    router.instant("reroute", "fleet", "router", req=2, ts=0.2, rid="b",
                   rejected_by="r0")
    router.complete("route", "fleet", "router", ts=0.2, dur=0.02, req=2,
                    rid="b", replica="r1", attempts=2, scores=[])
    router.complete("migrate", "fleet", "router", ts=0.6, dur=0.05, req=3,
                    rid="a", src="r0", dst="r1", old_rid="a")
    router.complete("drain", "fleet", "router", ts=0.55, dur=0.1,
                    replica="r0", entries=1, migrated=1, errors=0)
    r0 = _record(mod, lambda: float(next(ticks)))
    r0.instant("submit", "request", "queue", req=1, ts=0.12, rid="a")
    r1 = _record(mod, lambda: float(next(ticks)))
    r1.instant("submit", "request", "queue", req=2, ts=0.22, rid="b")
    r1.instant("submit", "request", "queue", req=3, ts=0.65, rid="a")
    return [("router", router.events()), ("r0", r0.events()),
            ("r1", r1.events())]


def test_fleet_exports_and_summaries_match_the_reference():
    """The stitched export, its fleet section, the report and the refusal
    of a partial export are the reference's: one process a section, flows
    across sections by rid, and a manifest that catches a missing one."""
    ours = ttrace.fleet_events_to_chrome(_fleet_sections(ttrace))
    ref = jtrace.fleet_events_to_chrome(_fleet_sections(jtrace))
    assert ours == ref
    summary = ttrace.summarize_trace(ours)
    jsummary = jtrace.summarize_trace(ref)
    assert jsummary.pop("programs") == {}
    assert summary == jsummary
    fleet = summary["fleet"]
    assert fleet["sections"] == ["router", "r0", "r1"]
    assert fleet["routing"] == {"route": 2, "attempts": 3, "reroutes": 1,
                                "migrations": 1, "drains": 1}
    assert fleet["migrations"] == [{"rid": "a", "from": "r0", "to": "r1"}]
    assert ttrace.format_summary(summary) == jtrace.format_summary(jsummary)
    assert "migrated a: r0 -> r1" in ttrace.format_fleet(fleet)
    assert any(e.get("cat") == "fleet_flow" for e in ours["traceEvents"])
    partial = [e for e in ours["traceEvents"]
               if not (e.get("pid") == 3 and e.get("name") == "process_name")]
    for mod in (ttrace, jtrace):
        with pytest.raises(ValueError, match="partial fleet export"):
            mod.summarize_trace(partial)
    with pytest.raises(ValueError, match="duplicate"):
        ttrace.fleet_events_to_chrome([("r0", []), ("r0", [])])
    assert "fleet" not in ttrace.summarize_trace(_record(
        ttrace, lambda: 0.0).to_chrome())


@pytest.mark.parametrize("export", ["stitched", "single", "partial"])
def test_cli_trace_summary_fleet(tmp_path, capsys, export):
    """`trace-summary --fleet` on a traced port fleet's drain: the
    stitched export prints the fleet section; a single-engine trace and a
    sliced fleet file exit 2, saying why."""
    from solvingpapers_tpu_torch.serve import FleetRouter

    engines = [port_engine(trace=True,
                           journal_path=str(tmp_path / f"r{i}.jsonl"))
               for i in range(2)]
    router = FleetRouter(engines, start=False)
    for p in prompts(4, seed=31):
        router.submit(p, max_new_tokens=NEW)
    for r in router.replicas:
        r.engine.step()
    report = router.drain("r0")
    for r in router.replicas:
        drive(r.engine, [], NEW)
    path = str(tmp_path / "fleet.json")
    doc = router.to_chrome_fleet()
    if export == "single":
        engines[1].trace.export_chrome(path)
    else:
        if export == "partial":
            doc["traceEvents"] = [e for e in doc["traceEvents"] if not (
                e.get("pid") == 2 and e.get("name") == "process_name")]
        with open(path, "w") as f:
            json.dump(doc, f)
    rc = cli.main(["trace-summary", path, "--fleet"])
    out, err = capsys.readouterr()
    if export == "stitched":
        assert rc == 0 and report.migrated
        assert out.rstrip("\n") == ttrace.format_summary(
            ttrace.summarize_trace(path))
        fleet = ttrace.summarize_trace(path)["fleet"]
        assert fleet["routing"]["drains"] == 1
        assert fleet["routing"]["migrations"] == len(report.migrated)
        assert sum(fleet["requests_by_replica"].values()) == 4 + len(
            report.migrated)  # each migrated stream finishes twice
    else:
        assert rc == 2 and not out
        assert ("holds no fleet events" if export == "single"
                else "partial fleet export") in err
