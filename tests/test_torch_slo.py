"""The port's SLO accounting (`serve/slo.py`), time series
(`metrics/timeseries.py`) and status endpoint (`metrics/http.py`)
against the JAX package's.

Across packages, on the same inputs: `SloTracker` verdicts, gauges,
`statusz()` and burn rates over one stream of finish records, and the
same `ValueError`s on bad targets; `TimeSeriesStore.doc()` and
`sparklines()` under one injected clock, and `sparkline`.

On the port alone: the SLO gauges are present iff `slo_targets` is set,
a class is refused without it, attained + violated finishes equal the
finishes less those cancelled or "error"; the degradation ladder sheds
batch, then standard admissions under SLO burn; `StatusServer` serves
/healthz (200 / 200 degraded / 503), /metrics, /statusz and
/timeseriesz (404 without a store), a raising provider is a 500, and an
engine's `status_port` serves its SLO section, sparklines and gauges.
"""

import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from durability_models import drive, port_engine, prompts
from solvingpapers_tpu.metrics import timeseries as jts
from solvingpapers_tpu.serve import slo as jslo
from solvingpapers_tpu_torch.metrics import timeseries as tts
from solvingpapers_tpu_torch.metrics.http import StatusServer
from solvingpapers_tpu_torch.serve import SamplingParams
from solvingpapers_tpu_torch.serve import slo as tslo
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)

CUSTOM = {"standard": {"ttft_s": 0.1, "objective": 0.5},
          "gold": {"e2e_s": 1.0, "itl_s": 0.01, "objective": 0.999}}


def _finishes(classes, n=120, seed=0):
    """Finish records as the engine's Request carries them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        submit = float(rng.uniform(0, 5))
        first = None if i % 11 == 0 else submit + float(rng.exponential(0.3))
        toks = list(range(int(rng.integers(1, 40))))
        fin = (first or submit) + float(rng.exponential(0.5))
        reason = ["length", "eos", "timeout", "cancelled", "error",
                  "length"][i % 6]
        cls = classes[i % len(classes)]
        out.append((types.SimpleNamespace(
            params=types.SimpleNamespace(slo=cls), finish_reason=reason,
            submit_time=submit, first_token_time=first, finish_time=fin,
            tokens=toks), fin + 0.01))
    return out


@pytest.mark.parametrize("targets,classes", [
    (tslo.DEFAULT_SLO_TARGETS, ["interactive", None, "batch", "standard"]),
    (CUSTOM, ["gold", None]),
], ids=["default", "custom"])
def test_slo_tracker_matches_the_reference(targets, classes):
    ours = tslo.SloTracker(targets, burn_window=16)
    ref = jslo.SloTracker(targets, burn_window=16)
    for req, now in _finishes(classes):
        assert ours.observe(req, now) == ref.observe(req, now)
        for cls in ours.targets:
            assert ours.burn_rate(cls) == ref.burn_rate(cls)
    for elapsed in (0.0, 12.5):
        assert ours.gauges(elapsed) == ref.gauges(elapsed)
    assert ours.statusz() == ref.statusz()
    assert tslo.request_latencies(req, now) == jslo.request_latencies(req, now)


@pytest.mark.parametrize("targets,burn", [
    ({}, 4), ({"batch": {"ttft_s": 1}}, 4), ({"standard": 1}, 4),
    ({"standard": {"ttft_s": 1, "p99": 2}}, 4),
    ({"standard": {"objective": 0.9}}, 4), ({"standard": {"ttft_s": 0}}, 4),
    ({"standard": {"ttft_s": 1, "objective": 1.0}}, 4),
    ({"standard": {"ttft_s": 1}}, 0),
])
def test_bad_targets_raise_the_references_errors(targets, burn):
    with pytest.raises(ValueError) as ours:
        tslo.SloTracker(targets, burn_window=burn)
    with pytest.raises(ValueError) as ref:
        jslo.SloTracker(targets, burn_window=burn)
    assert str(ours.value) == str(ref.value)


def test_timeseries_store_matches_the_reference():
    t = {"now": 0.0}
    ours = tts.TimeSeriesStore(capacity=5, interval_s=0.5, clock=lambda: t["now"])
    ref = jts.TimeSeriesStore(capacity=5, interval_s=0.5, clock=lambda: t["now"])
    rng = np.random.default_rng(2)
    total = 0.0
    for i in range(9):
        t["now"] += float(rng.uniform(0.3, 0.8))
        assert ours.due() == ref.due()
        total += float(rng.integers(0, 50))
        gauges = {"occupancy": float(rng.random())}
        if i >= 3:
            gauges["pages_free"] = float(rng.integers(0, 9))  # appears late
        cum = {"serve/tokens_out": total if i != 6 else total - 100.0}
        if i % 4:
            cum["serve/steps"] = float(i * 3)
        for store in (ours, ref):
            store.sample(gauges, cum)
        assert ours.doc() == ref.doc() and len(ours) == len(ref)
        for width in (3, 60):
            assert ours.sparklines(width) == ref.sparklines(width)
    for vals in ([], [None], [1.0], [2.0, 2.0], [0.0, None, 5.5, 3.0, -1.0]):
        assert tts.sparkline(vals) == jts.sparkline(vals)
        assert tts.sparkline(vals, 2) == jts.sparkline(vals, 2)
    with pytest.raises(ValueError):
        tts.TimeSeriesStore(capacity=0)


def test_slo_gauges_are_present_iff_configured():
    ps = prompts(6, seed=31)
    plain = port_engine()
    drive(plain, ps[:2], 4)
    assert not any(k.startswith("slo/") or "goodput" in k
                   for k in plain.metrics.snapshot())
    assert "slo" not in plain.statusz()
    with pytest.raises(ValueError, match="slo_targets"):
        plain.submit(ps[0], 4, params=SamplingParams(slo="batch"))
    eng = port_engine(slo_targets=tslo.DEFAULT_SLO_TARGETS)
    with pytest.raises(ValueError, match="unknown SLO class"):
        eng.submit(ps[0], 4, params=SamplingParams(slo="gold"))
    cycle = ("interactive", "standard", "batch", None)
    reqs = [eng.submit(p, 6, params=SamplingParams(slo=cycle[i % 4]))
            for i, p in enumerate(ps)]
    eng.cancel(reqs[-1])
    drive(eng, [], 6)
    snap = eng.metrics.snapshot()
    for cls in ("interactive", "standard", "batch"):
        assert f"slo/{cls}_finished" in snap
    assert "serve/goodput_tokens" in snap and "serve/goodput_tokens_per_s" in snap
    doc = eng.statusz()["slo"]
    counted = sum(d["finished"] for d in doc["classes"].values())
    attained = sum(d["attained"] for d in doc["classes"].values())
    violated = counted - attained
    excluded = sum(r.finish_reason in ("cancelled", "error") for r in reqs)
    assert attained + violated == len(reqs) - excluded == 5
    assert doc["excluded_finishes"] == excluded == 1
    assert reqs[0].slo_result["class"] == "interactive"
    assert reqs[-1].slo_result is None


def test_ladder_sheds_batch_then_standard_under_burn():
    """Targets no request can meet burn every class's budget; the ladder
    climbs a rung a step and from rung 3 rejects batch admissions, from
    rung 4 standard ones, never interactive."""
    tight = {c: {"ttft_s": 1e-9, "objective": 0.5}
             for c in ("interactive", "standard", "batch")}
    eng = port_engine(slo_targets=tight, degrade=True, degrade_up_steps=1,
                      degrade_down_steps=1000)
    ps = prompts(3, seed=32)
    drive(eng, ps, 2)
    while eng.degradation_rung < 4:
        eng.step()
    assert eng.health == "degraded"
    got = {c: eng.submit(ps[0], 2, params=SamplingParams(slo=c))
           for c in ("interactive", "standard", "batch")}
    assert got["interactive"].state == "waiting"
    assert [got[c].reject_reason for c in ("standard", "batch")] == [
        "shed:standard", "shed:batch"]
    snap = eng.metrics.snapshot()
    assert snap["serve/degradation_rung"] == 4.0
    assert snap["serve/shed_batch"] == snap["serve/shed_standard"] == 1.0
    assert eng.statusz()["health"]["ladder"]["shedding"] == ["batch", "standard"]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_status_server_serves_its_four_endpoints():
    state = {"health": "healthy"}
    store = tts.TimeSeriesStore(capacity=3, clock=lambda: 1.0)
    store.sample({"occupancy": 0.25}, {"serve/tokens_out": 4.0})
    srv = StatusServer(lambda: {"engine": {"step": 3}},
                       lambda: (3, {"serve/tokens_out": 4.0}),
                       health_fn=lambda: state["health"],
                       timeseries_fn=store.doc)
    bare = StatusServer(lambda: 1 / 0, lambda: (0, {}))
    try:
        for health, want in (("healthy", (200, "ok\n")),
                             ("degraded", (200, "degraded\n")),
                             ("unhealthy", (503, "unhealthy\n"))):
            state["health"] = health
            assert _get(srv.url("/healthz")) == want
        code, body = _get(srv.url("/timeseriesz"))
        assert code == 200 and json.loads(body) == store.doc()
        code, body = _get(srv.url("/metrics"))
        assert code == 200 and "serve_tokens_out 4.0" in body
        assert json.loads(_get(srv.url("/statusz"))[1]) == {"engine": {"step": 3}}
        assert _get(bare.url("/timeseriesz"))[0] == 404
        assert _get(bare.url("/statusz"))[0] == 500
        assert _get(bare.url("/healthz")) == (200, "ok\n")
        assert _get(bare.url("/nowhere"))[0] == 404
    finally:
        srv.close()
        bare.close()
    srv.close()  # idempotent


def test_engine_status_port_serves_slo_sparklines_and_gauges():
    eng = port_engine(slo_targets=tslo.DEFAULT_SLO_TARGETS, status_port=0,
                      timeseries_interval_s=1e-6)
    try:
        drive(eng, prompts(4, seed=33), 6,
              params=SamplingParams(slo="interactive"))
        doc = json.loads(_get(eng.status.url("/statusz"))[1])
        assert doc["slo"]["classes"]["interactive"]["finished"] == 4
        assert doc["timeseries"]["windows"] >= 1
        assert "serve/tokens_out" in doc["timeseries"]["sparklines"]
        series = json.loads(_get(eng.status.url("/timeseriesz"))[1])
        assert series["n"] >= 1 and "occupancy" in series["series"]
        prom = _get(eng.status.url("/metrics"))[1]
        assert "slo_interactive_attainment" in prom
        assert "serve_goodput_tokens" in prom
        assert _get(eng.status.url("/healthz")) == (200, "ok\n")
    finally:
        eng.close()
    assert eng.status is None
