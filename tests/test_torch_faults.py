"""The port's fault plane and fault boundary (`serve/faults.py`, the
engine's supervised step) against the JAX package's.

Across packages, on the same inputs: `FaultPlan` visits, firings and
`stats()`, and the `ValueError`s of bad specs; `DegradationLadder` rung
sequences and shed classes; `classify_failure` on the reference's cases.
`gpt_tiny` in float32 with the JAX package's weights (`convert.py`) under
one `FaultPlan` — NaN logits in one slot, then a synthetic device error
— through both packages' `ServeEngine`s finishes the same requests
"error" and gives the survivors the same tokens.

On the port alone: quarantine isolates a poisoned slot (nan and inf, lane
and paged pool); a real NaN written into a slot's lane or own pages is
caught by the guard, and after the scrub the slot's next occupant
streams token-exactly; a systemic failure rebuilds the pool and resumes
token-exactly; a persistent one drains `unhealthy` (every request
"error"), /healthz answers 503 through the front door and 200 after the
backoff, and the engine serves again; CUDA's errors classify systemic;
the watchdog counts a stalled step; the decode block and the prefill
make the same host reads with the planes off as without them.
"""

import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from durability_models import (
    BASE,
    PAGED,
    drive,
    gpt_tiny_pair,
    no_leaks,
    port_engine,
    prompts,
)
from solvingpapers_tpu.serve import faults as jfaults
from solvingpapers_tpu_torch.serve import SamplingParams
from solvingpapers_tpu_torch.serve import faults as tfaults
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)

NEW = 10
_CLEAN = {}


def _clean(ps, paged=False):
    """The fault-free engine's streams of `ps` (memoized)."""
    key = (tuple(p.tobytes() for p in ps), paged)
    if key not in _CLEAN:
        eng = port_engine(**(PAGED if paged else {}))
        _CLEAN[key] = [r.tokens for r in drive(eng, ps, NEW)]
    return _CLEAN[key]


# ------------------------------------------------------- across packages


PLANS = [
    [dict(site="decode", kind="nan", visit=1, slot=2),
     dict(site="prefill", kind="oom", visit=0, count=2)],
    [dict(site="scatter", kind="xla_error", visit=3),
     dict(site="sse_write", kind="socket_reset", visit=0),
     dict(site="journal_write", kind="io_error", visit=2, count=3),
     dict(site="decode", kind="stall", visit=5, stall_s=0.5)],
]


@pytest.mark.parametrize("plan", PLANS, ids=["engine_sites", "all_sites"])
def test_fault_plan_pokes_and_stats_match_the_reference(plan):
    """Both plans replay one schedule: the same specs fire at the same
    visits of the same sites, and `stats()` agree throughout."""
    ours, ref = tfaults.FaultPlan(plan), jfaults.FaultPlan(plan)
    rng = np.random.default_rng(0)
    for site in rng.choice(tfaults.FAULT_SITES, size=60):
        got = [(s.site, s.kind, s.visit, s.slot, s.stall_s, s.count)
               for s in ours.poke(site)]
        want = [(s.site, s.kind, s.visit, s.slot, s.stall_s, s.count)
                for s in ref.poke(site)]
        assert got == want
        assert ours.stats() == ref.stats()
    assert (tfaults.FAULT_SITES, tfaults.FAULT_KINDS, tfaults.RUNGS) == (
        jfaults.FAULT_SITES, jfaults.FAULT_KINDS, jfaults.RUNGS)
    # a live plan restarts from visit 0 in each engine
    again = tfaults.FaultPlan.from_config(ours)
    assert again.stats()["fired"] == 0 and again.specs == ours.specs


BAD_SPECS = [
    dict(site="nowhere", kind="nan", visit=0),
    dict(site="decode", kind="meteor", visit=0),
    dict(site="decode", kind="stall", visit=0),
    dict(site="decode", kind="socket_reset", visit=0),
    dict(site="scatter", kind="nan", visit=0),
    dict(site="sse_write", kind="oom", visit=0),
    dict(site="decode", kind="io_error", visit=0),
    dict(site="decode", kind="nan", visit=-1),
    dict(site="decode", kind="nan", visit=0, count=0),
    dict(site="decode", kind="nan", visit=0, slot=-1),
]


@pytest.mark.parametrize("spec", BAD_SPECS, ids=range(len(BAD_SPECS)))
def test_bad_specs_raise_the_references_errors(spec):
    with pytest.raises(ValueError) as ours:
        tfaults.FaultSpec(**spec)
    with pytest.raises(ValueError) as ref:
        jfaults.FaultSpec(**spec)
    assert str(ours.value) == str(ref.value)


def test_ladder_rungs_and_shedding_match_the_reference():
    rng = np.random.default_rng(1)
    signals = rng.random(300) < np.repeat([0.9, 0.1, 0.95, 0.02, 0.6], 60)
    for up, down in ((1, 1), (2, 16), (3, 5)):
        ours = tfaults.DegradationLadder(up_steps=up, down_steps=down)
        ref = jfaults.DegradationLadder(up_steps=up, down_steps=down)
        for i, p in enumerate(signals):
            reasons = ("pages",) if p else ()
            assert ours.observe(bool(p), reasons) == ref.observe(bool(p), reasons)
            assert ours.shed_classes() == ref.shed_classes()
            assert ours.stats() == ref.stats(), i
    with pytest.raises(ValueError):
        tfaults.DegradationLadder(max_rung=0)


class XlaRuntimeError(RuntimeError):
    pass


@pytest.mark.parametrize("exc", [
    tfaults.InjectedFault("xla_error", "decode"),
    tfaults.InjectedFault("oom", "prefill"),
    tfaults.InjectedFault("io_error", "journal_write"),
    XlaRuntimeError("INTERNAL: boom"),
    RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
    OSError("disk full"),
    ValueError("a host bug"),
], ids=["xla", "oom", "io", "xla_type", "exhausted", "oserror", "host"])
def test_classify_failure_matches_the_reference(exc):
    if isinstance(exc, tfaults.InjectedFault):
        twin = jfaults.InjectedFault(exc.kind, exc.site)
        assert str(twin) == str(exc)
    else:
        twin = exc
    assert tfaults.classify_failure(exc) == jfaults.classify_failure(twin)


@pytest.mark.parametrize("exc", [
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: device-side assert triggered"),
    RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling cublasGemmEx"),
    RuntimeError("cuDNN error: CUDNN_STATUS_INTERNAL_ERROR"),
    RuntimeError("flash_fwd kernel launch failed: error 700"),
] + ([torch.AcceleratorError("illegal address")]
     if hasattr(torch, "AcceleratorError") else []))
def test_cuda_failures_classify_systemic(exc):
    assert tfaults.classify_failure(exc) == "systemic"


def test_engines_under_one_fault_plan_agree_with_the_reference():
    """gpt_tiny float32 on both packages' weights, one plan: NaN logits in
    slot 1 at the second decode visit, then a synthetic device error at
    the fourth (a rebuild and a requeue). The same requests finish
    "error", the survivors give the same tokens and the same finish
    reasons, and the port leaks nothing."""
    from solvingpapers_tpu.serve import ServeConfig as JServeConfig
    from solvingpapers_tpu.serve import ServeEngine as JServeEngine

    jm, params, tm = gpt_tiny_pair()
    plan = [dict(site="decode", kind="nan", visit=1, slot=1),
            dict(site="decode", kind="xla_error", visit=3)]
    ps = prompts(5, seed=3)
    cfg = dict(BASE, max_prefills_per_step=3, fault_plan=plan,
               fault_retry_backoff_s=0.001)
    ours = port_engine(tm, **cfg)
    ref = JServeEngine(jm, params, JServeConfig(**cfg))
    a, b = drive(ours, ps, NEW), drive(ref, [p.astype(np.int32) for p in ps], NEW)
    assert [r.finish_reason for r in a] == [r.finish_reason for r in b]
    assert sum(r.finish_reason == "error" for r in a) == 1
    assert [r.tokens for r in a if r.finish_reason != "error"] == [
        r.tokens for r in b if r.finish_reason != "error"]
    snap, rsnap = ours.metrics.snapshot(), ref.metrics.snapshot()
    for key in ("serve/fault_injected", "serve/fault_quarantined",
                "serve/fault_retries", "serve/finish_error"):
        assert snap[key] == rsnap[key], key
    assert no_leaks(ours)


# ------------------------------------------------------------ port only


@pytest.mark.parametrize("kind", ["nan", "inf"])
@pytest.mark.parametrize("paged", [False, True], ids=["lane", "paged"])
def test_quarantine_isolates_poisoned_slot(paged, kind):
    """One of three streams poisoned at a decode visit, beside a greedy
    and a seeded top-p stream: it finishes "error", the other two are
    token-exact with the fault-free run (the poisoned row is sampled from
    zeros: the sampler's top-p cutoff would index out of range on NaN),
    no step failed, and the drained pool leaks nothing."""
    ps = prompts(3, seed=1)
    plan = [dict(site="decode", kind=kind, visit=1, slot=1)]
    kw = dict(max_prefills_per_step=3, **(PAGED if paged else {}))
    sampled = SamplingParams(temperature=0.8, top_p=0.9, seed=5)

    def run(**extra):
        eng = port_engine(**kw, **extra)
        reqs = [eng.submit(p, NEW, params=sampled if i == 2 else None)
                for i, p in enumerate(ps)]
        return eng, reqs + drive(eng, [], NEW)

    _, clean = run()
    eng, reqs = run(fault_plan=plan)
    errs = [i for i, r in enumerate(reqs) if r.finish_reason == "error"]
    assert errs == [1]
    assert [r.tokens for i, r in enumerate(reqs) if i != 1] == [
        r.tokens for i, r in enumerate(clean) if i != 1]
    snap = eng.metrics.snapshot()
    assert snap["serve/fault_quarantined"] == 1.0
    assert "serve/fault_retries" not in snap
    assert no_leaks(eng)


def _poison(eng, slot):
    """Write NaN into `slot`'s lane (lane pool) or its own pages and the
    trash page (paged pool), on the device, as a faulty kernel would."""
    if eng.config.paged:
        pool = eng.pool
        own = [int(p) for p in pool.table[slot, :int(pool.n_alloc[slot])]]
        for layer in pool.phys:
            for name in ("k", "v"):
                getattr(layer, name)[own + [0]] = float("nan")
    else:
        for layer in eng.pool.caches:
            for name in ("k", "v"):
                getattr(layer, name)[slot] = float("nan")


@pytest.mark.parametrize("paged", [False, True], ids=["lane", "paged"])
def test_scrubbed_storage_cannot_poison_the_next_occupant(paged):
    """A real non-finite lane (NaN written into the slot's storage
    mid-stream, its own pages and the trash page on the paged pool) is
    caught by the guard and quarantined; the next request admitted to
    that slot streams token-exactly: the scrub zeroed what masked
    attention would otherwise multiply by 0 (0 * NaN = NaN)."""
    p0, p1 = prompts(2, seed=4)
    eng = port_engine(n_slots=1, **(PAGED if paged else {}))
    r0 = eng.submit(p0, max_new_tokens=NEW)
    eng.step()
    assert r0.slot == 0 and not r0.done
    _poison(eng, 0)
    while eng.has_work():
        eng.step()
    assert r0.finish_reason == "error"
    r1 = drive(eng, [p1], NEW)[0]
    assert r1.tokens == _clean([p1], paged)[0]
    assert eng.metrics.snapshot()["serve/fault_quarantined"] == 1.0
    assert no_leaks(eng)


@pytest.mark.parametrize("paged", [False, True], ids=["lane", "paged"])
def test_systemic_failure_rebuilds_and_resumes_exactly(paged):
    ps = prompts(3, seed=5)
    plan = [dict(site="decode", kind="xla_error", visit=2),
            dict(site="prefill", kind="oom", visit=4)]
    eng = port_engine(fault_plan=plan, fault_retry_backoff_s=0.001,
                      max_prefills_per_step=3, **(PAGED if paged else {}))
    pool_before = eng.pool
    reqs = drive(eng, ps, NEW)
    assert [r.tokens for r in reqs] == _clean(ps, paged)
    snap = eng.metrics.snapshot()
    assert snap["serve/fault_retries"] == 2.0 and "serve/fault_recovery_s" in snap
    assert eng.pool is not pool_before and eng.health == "healthy"
    assert no_leaks(eng)


def test_sticky_rebuild_failure_drains_unhealthy_then_recovers(monkeypatch):
    """A failure whose rebuild raises too (a sticky CUDA error: the
    context is unusable) counts each failed rebuild as a retry, reaches
    `unhealthy` within `fault_max_retries`, finishes every request
    "error" host-side without killing the stepping thread, and serves
    again once a rebuild succeeds."""
    ps = prompts(3, seed=6)
    eng = port_engine(fault_max_retries=2, fault_retry_backoff_s=0.001,
                      fault_recover_backoff_s=0.05,
                      fault_plan=[dict(site="decode", kind="xla_error",
                                       visit=0)])
    make = eng._make_pool
    broken = {"on": True}

    def sticky():
        if broken["on"]:
            raise RuntimeError("CUDA error: device-side assert triggered")
        return make()

    monkeypatch.setattr(eng, "_make_pool", sticky)
    reqs = [eng.submit(p, max_new_tokens=NEW) for p in ps]
    for _ in range(5):
        eng.step()
    assert eng.health == "unhealthy" and eng._pool_lost
    assert [r.finish_reason for r in reqs] == ["error"] * 3
    assert eng.metrics.snapshot()["serve/fault_unhealthy"] == 1.0
    broken["on"] = False
    time.sleep(0.06)
    again = drive(eng, ps[:1], NEW)
    assert again[0].tokens == _clean(ps[:1])[0] and not eng._pool_lost
    assert no_leaks(eng)


def test_persistent_failure_drains_unhealthy_and_healthz_follows():
    """Two failures at max_retries 1: the engine drains every request
    "error" and reports unhealthy — /healthz 503 through the front door,
    submissions rejected "unhealthy" — and past the backoff /healthz is
    200 again and the engine serves token-exactly."""
    from solvingpapers_tpu_torch.serve import ApiServer

    p0 = prompts(1, seed=7)[0]
    plan = [dict(site="decode", kind="xla_error", visit=0, count=2)]
    eng = port_engine(fault_plan=plan, fault_max_retries=1,
                      fault_retry_backoff_s=0.001, fault_recover_backoff_s=0.3,
                      api_port=0)
    srv = ApiServer(eng)
    url = srv.url("/healthz")
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            assert r.status == 200 and r.read() == b"ok\n"
        h0 = srv.loop.submit(p0, max_new_tokens=NEW)
        deadline = time.monotonic() + 30
        while not h0.done and time.monotonic() < deadline:
            time.sleep(0.005)
        assert h0.finish_reason == "error" and eng.health == "unhealthy"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url, timeout=30)
        assert e.value.code == 503 and e.value.read() == b"unhealthy\n"
        assert eng.statusz()["health"]["unhealthy_episodes"] == 1
        hr = srv.loop.submit(p0, max_new_tokens=NEW)
        assert hr.state == "rejected" and hr.reject_reason == "unhealthy"
        time.sleep(0.35)
        with urllib.request.urlopen(url, timeout=30) as r:
            assert r.status == 200
        h1 = srv.loop.submit(p0, max_new_tokens=NEW)
        deadline = time.monotonic() + 30
        while not h1.done and time.monotonic() < deadline:
            time.sleep(0.005)
        assert h1.tokens == _clean([p0])[0]
        assert eng.health == "healthy" and srv.loop.error is None
    finally:
        srv.close()


def test_watchdog_counts_the_stalled_step():
    """A stall 25x the deadline at the third decode visit: the watchdog
    counts that step (only the stalled step is asserted on: a loaded
    host may stretch others), and the stream is unchanged."""
    p0 = prompts(1, seed=9)[0]
    plan = [dict(site="decode", kind="stall", visit=2, stall_s=0.5)]
    eng = port_engine(fault_plan=plan, fault_step_deadline_s=0.02)
    r = eng.submit(p0, max_new_tokens=NEW)
    eng.step()
    eng.step()
    before = eng.metrics.watchdog_stalls
    eng.step()  # the third decode visit: the stall
    assert eng.metrics.watchdog_stalls == before + 1
    while eng.has_work():
        eng.step()
    assert r.tokens == _clean([p0])[0]
    assert eng.statusz()["health"]["watchdog_stalls"] >= 1


class _Reads:
    """Counts device-to-host reads of tensors while installed: `.cpu()`,
    `.tolist()`, `.item()`, `int()`, `float()`, `bool()`, `index()`
    (`.numpy()` is not one: on a card it needs `.cpu()` first)."""

    NAMES = ("cpu", "tolist", "item", "__int__", "__float__", "__bool__",
             "__index__")

    def __init__(self, monkeypatch):
        self.n = 0
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, **k):
                self.n += 1
                return _orig(t, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, counted)


@pytest.mark.parametrize("paged", [False, True], ids=["lane", "paged"])
def test_planes_off_make_no_extra_host_reads(monkeypatch, paged):
    """With the fault plane, the journal and tracing off, a prefill makes
    ONE host read (its token and its finite flag together) and a decode
    block ONE (its tokens and the flags stacked), as many as the engine
    made before the planes: the guard rides copies the engine makes
    anyway."""
    p0 = prompts(1, seed=2)[0]
    eng = port_engine(timeseries=False, **(PAGED if paged else {}))
    assert eng.trace is None and eng.journal is None and eng._faults is None
    eng.submit(p0, max_new_tokens=NEW)
    reads = _Reads(monkeypatch)
    eng._admit(eng.scheduler.pick(eng.pool.n_free, 0)[0])
    assert reads.n == 1
    reads.n = 0
    eng._decode_block()
    assert reads.n == 1
