"""Serving benchmark on the port (port of the Poisson, shared-prefix,
paged, sampling, HTTP, SLO, chaos, journal, replay and fleet workloads
of `solvingpapers_tpu/serve/bench.py`, with its traced arm and status
endpoint).

Synthetic open-loop traffic: request arrivals are a Poisson process
(exponential interarrivals, seeded), prompts are slices of the
deterministic synthetic corpus (`data/synthetic.synthetic_text`) taken
as token ids. The request generators are numpy only and give the
reference's requests element for element.

* `run_serve_bench` — one `ServeEngine` against per-request one-shot
  `infer.generate` (batch 1), each request starting at ``max(previous
  finish, its arrival)``, on the same arrival offsets. Requests/s =
  n_requests / (last finish - first arrival).
* `run_prefix_bench` — N requests over K shared system prompts
  (`shared_prefix_requests`), the radix prefix cache on against off: the
  TTFT win of reusing a cached prefix instead of prefilling it again.
* `run_paged_bench` — the paged KV pool against the lane pool: ABBA-
  paired Poisson throughput at equal slots and memory (the paging tax), a
  capacity arm at EQUAL pool bytes with twice the slots (peak concurrency
  above the lane pool's slot count), and an ABBA-paired shared-prefix arm
  whose page-sharing hits make no device copy.
* `run_sampling_bench` — the same Poisson trace all-greedy against a
  per-request temperature / top-p / top-k / min-p mix.
* `run_http_bench` — the trace as concurrent SSE clients through the
  OpenAI front door (`serve/api.py`) against direct `submit`, with every
  streamed id sequence checked against the direct arm's.
* `run_slo_bench` — the trace through an engine with SLO classes
  (requests tagged interactive / standard / batch in turn) against the
  plain engine: the accounting's cost, per-class attainment and burn,
  and goodput.
* `run_chaos_bench` — one seeded fault schedule (`chaos_fault_plan`)
  through a fault-free reference, a ladder-off and a ladder-on engine:
  surviving streams token-exact, recovery time, zero leaks, goodput
  with the ladder against without, and an armed-but-quiet plan's cost.
* `run_journal_bench` — the journal's cost (ABBA) and a kill-and-recover
  arm: an engine abandoned mid-decode, its journal recovered by a fresh
  one, every stream token-exact with an uninterrupted run.
* `run_replay_bench` — a journaled greedy and seeded workload replayed
  through `serve/replay.py` at the identical config on the lane and the
  paged pool: byte-exact on both. The reference's int8-KV candidate arm
  waits for the quantized pool (ROADMAP A5); the result says so under
  ``notes`` and leaves out that arm's keys.
* `run_fleet_bench` — a one-replica `FleetRouter` against the bare
  engine (the routing tax), traced against untraced, and a drain of
  replica r0 while streams are live: migrated and every other stream
  token-exact with a single engine, no leak on any replica, the trails'
  phases partitioning their walls.

`trace=True` (Poisson, prefix and sampling workloads) adds an ABBA-paired
traced arm and records `trace_overhead_pct`, the traced req/s and the
event count (`_traced_arm_fields`), exporting the last traced run's
Chrome trace to `trace_out`. `status_port` keeps the probe engine open,
serving /healthz /metrics /statusz /timeseriesz for the run
(`status_hold_s` past its end).

Every workload warms the engine on one request per prompt length before
its timed arms, and runs a probe first: the warm trace once, recording
`peak_hbm_bytes`, the device's measured peak allocation over that run
(`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`; on
the CPU the key is absent). The reference's probe reads the XLA compile
registry and memory ledger instead (a projected peak) and also records
`compile_time_s`, `compile_programs`, `compile_compilations` and
`decode_step_wall_s`; eager PyTorch compiles no program, so those come
with the compile observatory's twin, and the paged decode decomposition
(`gather_wall_s` ... `attention_share_pct`) and the `anatomy_*` arm with
the kernel bench.

Two paged fields keep their names and take the port's pool as their
witness: `splice_programs_dispatched` counts the device copies
`KVSlotPool.splice_prefix` / `extract_prefix` made during a paged
cache-on run (`kv_pool.PREFIX_COPIES`; the reference counts compiled
splice programs), and `capacity_program_temp_bytes` is, on the card, the
capacity arm's peak allocation less what was allocated before it and
less its pool's bytes: the gathered lane view and the activations.

Each workload's detail adds `arms`: every timed arm's wall seconds and,
on the card, its peak allocated bytes. An arm's engine is dropped before
the next arm allocates its pool (the reference keeps the last engines of
a pair alive), so each arm's peak holds one pool. With HTTP streams that
differ from the direct arm's, the detail adds `stream_first_diff`: the
first request and position that differ, the tokens before it and the
two tokens.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from solvingpapers_tpu_torch import ops
from solvingpapers_tpu_torch.serve import kv_pool
from solvingpapers_tpu_torch.serve.engine import ServeConfig, ServeEngine
from solvingpapers_tpu_torch.serve.sampling import SamplingParams

_DECODER_FAMILIES = ("gpt", "llama3", "deepseekv3")

# the result schema: the reference's version 2 (provenance recorded at
# measurement time, the timestamp injected by the one writer, `cli
# serve-bench`), with torch and cuda where the reference has jax and
# jaxlib
BENCH_SCHEMA_VERSION = 2


def bench_provenance(timestamp: float, git_sha: str | None = None) -> dict:
    """The identity stamp of a bench result: WHO measured it (git sha,
    torch and CUDA versions, host device) and WHEN. `timestamp` is
    injected by the caller, one clock reading per bench run."""
    from solvingpapers_tpu_torch.buildinfo import build_info

    info = build_info()
    return {
        "schema_version": BENCH_SCHEMA_VERSION,
        "provenance": {
            "git_sha": git_sha if git_sha is not None else info["git_sha"],
            "timestamp": round(float(timestamp), 3),
            "torch": info["torch"],
            "cuda": info["cuda"],
            "python": info["python"],
            "platform": info["platform"],
            "device_kind": info["device_kind"],
        },
    }


def build_serve_model(config, device=None):
    """(model, vocab_size) for a registered decoder config (a name, or a
    `RunConfig` such as one with a smaller position budget): the model
    as its dense twin on `device` (default ``cuda``, raising without a
    card), weights in the compute dtype, random from a generator seeded
    with 0, in eval mode. The bench feeds raw token ids: the registry's
    vocabulary, no tokenizer."""
    from solvingpapers_tpu_torch.configs import dense_twin, get_config
    from solvingpapers_tpu_torch.configs.factory import build_model
    from solvingpapers_tpu_torch.device import resolve_device
    from solvingpapers_tpu_torch.models import init_params_for

    cfg = get_config(config) if isinstance(config, str) else config
    if cfg.model_family not in _DECODER_FAMILIES:
        raise ValueError(
            f"config {cfg.name!r} is family {cfg.model_family!r}; "
            f"serve-bench needs a decoder family {_DECODER_FAMILIES}"
        )
    if cfg.train.pipeline_parallel:
        raise ValueError(
            "pipeline-parallel configs have stage-stacked params; export "
            "to the dense family before serving"
        )
    # params are replicated at rest: serve a context-parallel config
    # through its dense twin
    cfg = dense_twin(cfg)
    device = resolve_device(device)
    model = build_model(cfg, device=device, param_dtype=None)
    gen = torch.Generator(device=device).manual_seed(0)
    model.load_state_dict(init_params_for(cfg.model)(cfg.model, gen))
    model.eval()
    return model, cfg.model.vocab_size


def synthetic_requests(
    n: int,
    vocab_size: int,
    prompt_lens=(8, 16, 24, 32),
    mean_interarrival_s: float = 0.002,
    seed: int = 0,
):
    """[(arrival_offset_s, prompt ids)] — Poisson arrivals, corpus prompts.

    Prompt lengths cycle through a small fixed set, so each arm meets a
    bounded number of prefill shapes.
    """
    from solvingpapers_tpu_torch.data.synthetic import synthetic_text

    rng = np.random.default_rng(seed)
    text = synthetic_text(n_chars=max(4096, n * max(prompt_lens) * 2),
                          seed=seed)
    corpus = np.frombuffer(text.encode("ascii", "replace"), np.uint8)
    ids = corpus.astype(np.int32) % vocab_size
    arrivals = np.cumsum(rng.exponential(mean_interarrival_s, size=n))
    out = []
    for i in range(n):
        length = prompt_lens[i % len(prompt_lens)]
        start = int(rng.integers(0, ids.size - length))
        out.append((float(arrivals[i]), ids[start:start + length]))
    return out


def shared_prefix_requests(
    n: int,
    vocab_size: int,
    n_prefixes: int = 4,
    prefix_len: int = 64,
    suffix_len: int = 8,
    mean_interarrival_s: float = 0.002,
    seed: int = 0,
):
    """[(arrival_offset_s, prompt ids)] — N requests over `n_prefixes`
    distinct system prompts: each prompt is one of K shared `prefix_len`
    stems plus a unique `suffix_len` tail, the traffic the radix prefix
    cache exists for (after each stem's first request only the tail needs
    prefill)."""
    rng = np.random.default_rng(seed)
    stems = [
        rng.integers(0, vocab_size, size=prefix_len).astype(np.int32)
        for _ in range(n_prefixes)
    ]
    arrivals = np.cumsum(rng.exponential(mean_interarrival_s, size=n))
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab_size, size=suffix_len).astype(np.int32)
        out.append(
            (float(arrivals[i]),
             np.concatenate([stems[i % n_prefixes], tail]))
        )
    return out


def sampling_params_mix(i: int) -> SamplingParams:
    """Request i's params in the sampling workload: one greedy slot in
    four, the rest a temperature/top-p/top-k/min-p rotation (seeded per
    request, so the workload replays). Every decode block mixes them."""
    mix = (
        SamplingParams(),  # greedy — must coexist with the rest
        SamplingParams(temperature=1.0, top_p=0.9, seed=i),
        SamplingParams(temperature=1.2, top_k=50, seed=i),
        SamplingParams(temperature=0.8, min_p=0.05, seed=i),
    )
    return mix[i % len(mix)]


def _round_if_present(snap: dict, key: str, out_key: str, digits: int) -> dict:
    """{out_key: rounded value} when the metric was observed, else {}."""
    if key in snap:
        return {out_key: round(snap[key], digits)}
    return {}


def _kv_entry_fields(eng, agreement: float = 1.0) -> dict:
    """The KV-storage triple every entry records: `kv_dtype` (the pool's
    storage dtype, as the reference names it), `kv_pool_bytes` (resident
    pool bytes) and `greedy_agreement_rate` (1.0: the port's pools are
    exact, the reference's definition for them)."""
    pool = eng.pool
    caches = pool.phys if hasattr(pool, "phys") else pool.caches
    first = next(iter(kv_pool._tensors(caches[0]).values()))
    return {
        "kv_dtype": str(first.dtype).removeprefix("torch."),
        "kv_pool_bytes": int(pool.nbytes),
        "greedy_agreement_rate": round(float(agreement), 4),
    }


def _token_agreement(ref_handles, handles) -> float:
    """Position-wise greedy-token agreement between two arms' request
    handles (same prompts, same order): matching tokens at the same
    stream index over the reference arm's total tokens."""
    total = sum(len(r.tokens) for r in ref_handles)
    if total == 0:
        return 1.0
    same = sum(
        int(a == b)
        for r, h in zip(ref_handles, handles)
        for a, b in zip(r.tokens, h.tokens)
    )
    return same / total


def _peak_concurrency(handles) -> int:
    """Max simultaneously-active slots, reconstructed from the requests'
    own [admit, finish) intervals — no polling in the timed loop."""
    events = []
    for h in handles:
        if h.admit_time is not None and h.finish_time is not None:
            events.append((h.admit_time, 1))
            events.append((h.finish_time, -1))
    events.sort()
    cur = peak = 0
    for _, d in events:
        cur += d
        peak = max(peak, cur)
    return peak


class _Arms:
    """Wall seconds and, on the card, peak allocated bytes of each timed
    arm, by label (the detail's `arms`)."""

    def __init__(self, device: torch.device):
        self.card = device.type == "cuda"
        self.device = device
        self.log: dict[str, dict] = {}

    def begin(self) -> None:
        if self.card:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int | None:
        return (int(torch.cuda.max_memory_allocated(self.device))
                if self.card else None)

    def run(self, label: str, fn, *args, **kwargs):
        self.begin()
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        rec = {"wall_s": round(time.monotonic() - t0, 4)}
        if self.card:
            rec["peak_bytes"] = self.peak()
        self.log[label] = rec
        return out


def _run_engine_arm(model, requests, serve_cfg, max_new, params_for=None):
    """One engine over the arrival trace: each request is submitted when
    the wall clock passes its offset, and `step()` runs while there is
    work. `params_for` (index -> SamplingParams | None) attaches
    per-request sampling params; None keeps every request greedy.
    Returns (engine, handles, makespan)."""
    eng = ServeEngine(model, serve_cfg, device=model.device)
    pending = sorted(requests, key=lambda r: r[0])
    handles = []
    t0 = time.monotonic()
    i = 0
    while i < len(pending) or eng.has_work():
        elapsed = time.monotonic() - t0
        while i < len(pending) and pending[i][0] <= elapsed:
            handles.append(eng.submit(
                pending[i][1], max_new_tokens=max_new,
                params=params_for(i) if params_for is not None else None,
            ))
            i += 1
        if eng.has_work():
            eng.step()
        elif i < len(pending):
            # engine idle before the next arrival: sleep the gap
            time.sleep(max(0.0, pending[i][0] - (time.monotonic() - t0)))
    makespan = (time.monotonic() - t0) - pending[0][0]
    assert all(h.done for h in handles), "engine drained with unfinished work"
    return eng, handles, makespan


def _engine_arm_stats(model, requests, serve_cfg, max_new, params_for=None):
    """`_run_engine_arm`, keeping (makespan, metrics snapshot, KV fields,
    handles) and dropping the engine, so its pool frees before the next
    arm allocates."""
    eng, handles, mk = _run_engine_arm(model, requests, serve_cfg, max_new,
                                       params_for=params_for)
    return mk, eng.metrics.snapshot(), _kv_entry_fields(eng), handles


def _run_sequential_arm(model, requests, max_new):
    """Per-request one-shot greedy `generate` at the same arrival offsets;
    returns (makespan, mean TTFT). Each call's time ends when the device
    has finished it."""
    from solvingpapers_tpu_torch.infer import generate

    dev = model.device
    ttfts = []
    cursor = None
    for arrival, prompt in sorted(requests, key=lambda r: r[0]):
        start = arrival if cursor is None else max(cursor, arrival)
        t0 = time.monotonic()
        generate(model, torch.as_tensor(prompt, device=dev)[None],
                 max_new_tokens=max_new, sampler=ops.sample_greedy, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dur = time.monotonic() - t0
        cursor = start + dur
        # one-shot generate emits nothing until the whole batch finishes:
        # first-token latency == completion latency
        ttfts.append(cursor - arrival)
    makespan = cursor - min(a for a, _ in requests)
    return makespan, float(np.mean(ttfts))


def _obs_probe(model, warm_requests, serve_cfg, max_new, params_for=None,
               arms: _Arms | None = None, status_port: int | None = None):
    """The warm trace once through an engine of `serve_cfg`, before the
    plain warmup: on the card, its measured peak allocation
    (`peak_hbm_bytes`); on the CPU, no field. Returns (fields, engine).
    The engine is dropped before the timed arms allocate theirs (engine
    None), unless `status_port` is given: then it serves /healthz
    /metrics /statusz /timeseriesz for the rest of the run (its port in
    `status_port`), and the caller closes it with `_release_probe`."""
    import sys

    arms = arms or _Arms(model.device)
    if status_port is None:
        arms.run("probe", _engine_arm_stats, model, warm_requests, serve_cfg,
                 max_new, params_for=params_for)
        eng = None
    else:
        cfg = dataclasses.replace(serve_cfg, status_port=status_port)
        eng, _, _ = arms.run("probe", _run_engine_arm, model, warm_requests,
                             cfg, max_new, params_for=params_for)
    peak = arms.log["probe"].get("peak_bytes")
    fields = {} if peak is None else {"peak_hbm_bytes": peak}
    if eng is not None:
        fields["status_port"] = eng.status.port
        print(f"[serve-bench] status endpoint live at "
              f"http://{eng.status.host}:{eng.status.port} (/healthz /metrics "
              "/statusz /timeseriesz)", file=sys.stderr, flush=True)
    return fields, eng


def _release_probe(eng, hold_s: float = 0.0) -> None:
    """Hold a status-serving probe engine `hold_s` seconds past the arms
    (a curl window), then close it."""
    if eng is None:
        return
    if hold_s > 0:
        time.sleep(hold_s)
    eng.close()


def _traced_arm_fields(model, requests, serve_cfg, max_new,
                       trace_out: str | None, trace_dump: str | None,
                       params_for=None, reps: int = 2,
                       arms: _Arms | None = None) -> dict:
    """The flight recorder's throughput cost: `trace_overhead_pct` = (1 -
    traced / untraced req/s) x 100 over ABBA-paired runs of the arrival
    trace, the traced arm's req/s and its recorded event count. Exports
    the last traced run's Chrome trace to `trace_out`; `trace_dump` arms
    the anomaly dumper."""
    tcfg = dataclasses.replace(serve_cfg, trace=True, trace_dump_path=trace_dump)
    arms = arms or _Arms(model.device)
    mk = {"traced": [], "untraced": []}
    recorder = None
    for rep in range(reps):
        order = ("traced", "untraced") if rep % 2 == 0 else ("untraced", "traced")
        for arm in order:
            eng, _, span = arms.run(f"{arm}[{rep}]", _run_engine_arm, model,
                                    requests, tcfg if arm == "traced"
                                    else serve_cfg, max_new,
                                    params_for=params_for)
            mk[arm].append(span)
            if arm == "traced":
                recorder = eng.trace  # the ring outlives its engine
            del eng
    traced_rps = len(requests) / (sum(mk["traced"]) / len(mk["traced"]))
    untraced_rps = len(requests) / (sum(mk["untraced"]) / len(mk["untraced"]))
    fields = {
        "trace_overhead_pct": round((1.0 - traced_rps / untraced_rps) * 100.0, 2),
        "traced_requests_per_sec": round(traced_rps, 2),
        "trace_events": recorder.total_recorded,
    }
    if trace_out:
        recorder.export_chrome(trace_out)
        fields["trace_out"] = trace_out
    return fields


def _paired_arm_stats(model, requests, on_cfg, off_cfg, max_new,
                      reps: int = 2, params_for=None,
                      arms: _Arms | None = None, names=("on", "off")):
    """ABBA-paired runs: even reps run on-then-off, odd reps flip, and
    each side keeps per-run (makespan, metrics snapshot). ABBA + mean
    cancels linear drift of a shared host. Returns (runs, kv) where kv
    holds each side's KV fields (from its last engine, which is dropped
    like every other). `names` label the sides in `arms`."""
    arms = arms or _Arms(model.device)
    runs = {"on": [], "off": []}
    kv = {"on": None, "off": None}
    for rep in range(reps):
        order = ("on", "off") if rep % 2 == 0 else ("off", "on")
        for arm in order:
            label = f"{names[0] if arm == 'on' else names[1]}[{rep}]"
            mk, snap, fields, _ = arms.run(
                label, _engine_arm_stats, model, requests,
                on_cfg if arm == "on" else off_cfg, max_new,
                params_for=params_for)
            runs[arm].append((mk, snap))
            kv[arm] = fields
    return runs, kv


def _tree_bytes(model, floor: int, n_prefixes: int, prompt_len: int,
                page: int) -> int:
    """The prefix tree's byte cap: `floor`, or more where that cannot
    hold every stem's page-aligned prompt at the model's KV bytes a token
    (a tree that cannot hold a stem has no hit; one of llama3_long's
    4080-token stems is 133.7 MB against the 64 MiB default)."""
    per_token = kv_pool.cache_bytes(model.init_caches(1, 1))
    return max(floor, n_prefixes * -(-prompt_len // page) * page * per_token)


def _warm_trace(requests):
    """One request per distinct prompt length, all at offset 0."""
    by_len: dict = {}
    for _, p in requests:
        by_len.setdefault(len(p), p)
    return [(0.0, p) for p in by_len.values()]


def _config_name(config) -> str:
    return config if isinstance(config, str) else config.name


def poisson_serve_config(requests, n_slots: int, max_new: int,
                         decode_block: int, seed: int = 0,
                         **extra) -> ServeConfig:
    """The engine config of the Poisson-trace workloads (serve, sampling,
    HTTP) for `requests`: max_len fits the longest prompt and the new
    tokens, the whole pool refills in one iteration (throughput-oriented:
    the default one prefill a step protects ITL but leaves slots idle
    under a drain-the-queue trace), and the queue never sheds load (an
    open-loop trace can queue every request at once). `extra` sets other
    fields."""
    max_prompt = max(len(p) for _, p in requests)
    return ServeConfig(
        n_slots=n_slots,
        max_len=max_prompt + max_new,
        decode_block=decode_block,
        bucket=min(32, max_prompt),
        max_prefills_per_step=n_slots,
        max_waiting=max(256, len(requests)),
        seed=seed,
        **extra,
    )


def run_serve_bench(
    config="llama3_shakespeare",
    n_requests: int = 32,
    n_slots: int = 8,
    max_new: int = 64,
    decode_block: int = 16,
    prompt_lens=(16, 32, 48, 64),
    mean_interarrival_s: float = 0.001,
    seed: int = 0,
    skip_sequential: bool = False,
    trace: bool = False,
    trace_out: str | None = None,
    trace_dump: str | None = None,
    status_port: int | None = None,
    status_hold_s: float = 0.0,
    device=None,
) -> dict:
    """The engine arm against the sequential arm; returns the result
    dict (`vs_baseline`: engine req/s over sequential req/s). `trace`
    adds the traced arm (`_traced_arm_fields`); `status_port` keeps the
    probe engine serving its status endpoint for the run."""
    model, vocab = build_serve_model(config, device)
    arms = _Arms(model.device)
    requests = synthetic_requests(
        n_requests, vocab, prompt_lens=prompt_lens,
        mean_interarrival_s=mean_interarrival_s, seed=seed,
    )
    serve_cfg = poisson_serve_config(requests, n_slots, max_new,
                                     decode_block, seed)
    warm = _warm_trace(requests)
    probe_fields, probe_eng = _obs_probe(model, warm, serve_cfg, max_new,
                                         arms=arms, status_port=status_port)
    _run_engine_arm(model, warm, serve_cfg, max_new)
    if not skip_sequential:
        _run_sequential_arm(model, warm, max_new)

    makespan, snap, kv, _ = arms.run("engine", _engine_arm_stats, model,
                                     requests, serve_cfg, max_new)
    rps = n_requests / makespan
    detail = {
        "config": _config_name(config),
        "n_requests": n_requests,
        "n_slots": n_slots,
        "max_new_tokens": max_new,
        "decode_block": decode_block,
        "prompt_lens": list(prompt_lens),
        "mean_interarrival_s": mean_interarrival_s,
        "engine_requests_per_sec": round(rps, 2),
        "engine_tokens_per_sec": round(
            snap.get("serve/tokens_per_sec", 0.0), 1
        ),
        # absent beats NaN (json.dumps would emit a non-RFC-8259 'NaN')
        **_round_if_present(snap, "serve/ttft_s_mean", "mean_ttft_s", 4),
        **_round_if_present(snap, "serve/ttft_s_p95", "ttft_p95_s", 4),
        **_round_if_present(snap, "serve/itl_s_p95", "itl_p95_s", 5),
        "slot_occupancy": round(snap.get("serve/slot_occupancy", 0.0), 3),
        # present only when the engine's prefix cache ran lookups
        **_round_if_present(snap, "serve/prefix_hit_rate",
                            "prefix_hit_rate", 3),
        **({"tokens_prefilled_saved":
            int(snap["serve/tokens_prefilled_saved"])}
           if "serve/tokens_prefilled_saved" in snap else {}),
        **kv,
        **probe_fields,
    }
    result = {
        "metric": "serve_requests_per_sec",
        "value": round(rps, 2),
        "unit": "req/s",
        "detail": detail,
    }
    if not skip_sequential:
        seq_makespan, seq_ttft = arms.run("sequential", _run_sequential_arm,
                                          model, requests, max_new)
        seq_rps = n_requests / seq_makespan
        detail["sequential_requests_per_sec"] = round(seq_rps, 2)
        detail["sequential_mean_ttft_s"] = round(seq_ttft, 4)
        result["vs_baseline"] = round(rps / seq_rps, 2)
    if trace:
        detail.update(_traced_arm_fields(model, requests, serve_cfg, max_new,
                                         trace_out, trace_dump, arms=arms))
    detail["arms"] = arms.log
    _release_probe(probe_eng, status_hold_s)
    return result


def run_prefix_bench(
    config="gpt_shakespeare",
    n_requests: int = 48,
    n_slots: int = 8,
    max_new: int = 4,
    decode_block: int = 4,
    n_prefixes: int = 4,
    prefix_len: int | None = None,
    suffix_len: int = 8,
    mean_interarrival_s: float = 0.002,
    prefix_page: int = 16,
    prefix_cache_bytes: int = 64 << 20,
    seed: int = 0,
    trace: bool = False,
    trace_out: str | None = None,
    trace_dump: str | None = None,
    status_port: int | None = None,
    status_hold_s: float = 0.0,
    device=None,
) -> dict:
    """Shared-prefix workload, prefix cache ON against OFF — same engine
    config, same arrival trace; the headline (`vs_baseline`) is cache-off
    mean TTFT over cache-on.

    `prefix_len=None` stretches the shared stem to the model's position
    budget (page-aligned): a long system prompt ahead of a short tail.
    The tree holds `prefix_cache_bytes`, or every stem where that is
    more (`_tree_bytes`)."""
    model, vocab = build_serve_model(config, device)
    arms = _Arms(model.device)
    limit = getattr(model, "max_positions", None)
    if prefix_len is None:
        room = (limit or 256) - suffix_len - max_new
        prefix_len = max(prefix_page, room // prefix_page * prefix_page)
    requests = shared_prefix_requests(
        n_requests, vocab, n_prefixes=n_prefixes, prefix_len=prefix_len,
        suffix_len=suffix_len, mean_interarrival_s=mean_interarrival_s,
        seed=seed,
    )
    max_prompt = prefix_len + suffix_len
    if limit is not None and max_prompt + max_new > limit:
        raise ValueError(
            f"prefix_len + suffix_len + max_new = {max_prompt + max_new} "
            f"exceeds the model's max positions {limit}"
        )
    tree_bytes = _tree_bytes(model, prefix_cache_bytes, n_prefixes,
                             max_prompt, prefix_page)

    def cfg(cache_on: bool) -> ServeConfig:
        return ServeConfig(
            n_slots=n_slots,
            max_len=max_prompt + max_new,
            decode_block=decode_block,
            # tight bucket: a hit prefills ~suffix_len tokens
            bucket=max(8, -(-suffix_len // 8) * 8),
            max_prefills_per_step=n_slots,
            max_waiting=max(256, n_requests),
            seed=seed,
            prefix_cache=cache_on,
            prefix_page=prefix_page,
            prefix_cache_bytes=tree_bytes,
        )

    # a 2-requests-per-stem mini-trace: the miss path's full prefill and
    # the hit path's suffix prefill (the tree is per engine, so each
    # timed engine still starts cold)
    warm = shared_prefix_requests(
        2 * n_prefixes, vocab, n_prefixes=n_prefixes,
        prefix_len=prefix_len, suffix_len=suffix_len,
        mean_interarrival_s=0.0, seed=seed + 1,
    )
    probe_fields, probe_eng = _obs_probe(model, warm, cfg(True), max_new,
                                         arms=arms, status_port=status_port)
    arms_out = {}
    raw_ttft = {}
    kv = None
    for cache_on in (True, False):
        _run_engine_arm(model, warm, cfg(cache_on), max_new)
        arm = "cache_on" if cache_on else "cache_off"
        makespan, snap, fields, _ = arms.run(arm, _engine_arm_stats, model,
                                             requests, cfg(cache_on), max_new)
        if cache_on:
            kv = fields
        raw_ttft[arm] = snap["serve/ttft_s_mean"]  # unrounded ratio
        arms_out[arm] = {
            "requests_per_sec": round(n_requests / makespan, 2),
            "mean_ttft_s": round(raw_ttft[arm], 4),
            **_round_if_present(snap, "serve/ttft_s_p95", "ttft_p95_s", 4),
            "prefix_hit_rate": round(
                snap.get("serve/prefix_hit_rate", 0.0), 3
            ),
            "prefix_evictions": int(snap.get("serve/prefix_evictions", 0.0)),
            "tokens_prefilled_saved": int(
                snap.get("serve/tokens_prefilled_saved", 0.0)
            ),
            "prefix_hbm_bytes": int(snap.get("serve/prefix_hbm_bytes", 0.0)),
        }
    # the traced arm mirrors the headline (cache-on) arm
    trace_fields = (_traced_arm_fields(model, requests, cfg(True), max_new,
                                       trace_out, trace_dump, arms=arms)
                    if trace else {})
    _release_probe(probe_eng, status_hold_s)
    # ratio of the UNROUNDED means
    speedup = raw_ttft["cache_off"] / raw_ttft["cache_on"]
    return {
        "metric": "serve_prefix_cache_ttft_speedup",
        "value": round(speedup, 2),
        "unit": "x (mean TTFT, cache off / on)",
        "vs_baseline": round(speedup, 2),
        "detail": {
            "config": _config_name(config),
            "workload": "shared-prefix",
            "n_requests": n_requests,
            "n_prefixes": n_prefixes,
            "prefix_len": prefix_len,
            "suffix_len": suffix_len,
            "n_slots": n_slots,
            "max_new_tokens": max_new,
            "decode_block": decode_block,
            "mean_interarrival_s": mean_interarrival_s,
            "prefix_page": prefix_page,
            **{f"{arm}_{k}": v for arm, d in arms_out.items()
               for k, v in d.items()},
            **kv,
            **probe_fields,
            **trace_fields,
            "arms": arms.log,
        },
    }


def run_paged_bench(
    config="gpt_shakespeare",
    n_requests: int = 32,
    n_slots: int = 8,
    max_new: int = 64,
    decode_block: int = 16,
    prompt_lens=(16, 32, 48, 64),
    mean_interarrival_s: float = 0.001,
    n_prefixes: int = 4,
    prefix_requests: int | None = None,
    suffix_len: int = 8,
    page_size: int = 16,
    seed: int = 0,
    reps: int = 2,
    status_port: int | None = None,
    status_hold_s: float = 0.0,
    device=None,
) -> dict:
    """Paged KV pool against the lane pool — three sub-workloads, one
    result.

    1. Poisson (ABBA-paired, same slots, same pool bytes): the paging tax
       (`paged_overhead_pct` on req/s).
    2. Capacity at EQUAL pool bytes: a paged engine with 2x the slots and
       a page budget equal to the lane pool's footprint, on shorter
       streams; `capacity_peak_active_slots` > `n_slots` shows slot
       count decoupled from max_len.
    3. Shared-prefix (ABBA-paired, paged cache-on against cache-off, and
       paged cache-on against lane cache-on): the prefix-hit TTFT win
       with page sharing, which makes no device copy
       (`splice_programs_dispatched` stays 0). The tree holds the
       engine's default cap, or every stem where that is more
       (`_tree_bytes`).
    """
    model, vocab = build_serve_model(config, device)
    dev = model.device
    arms = _Arms(dev)
    requests = synthetic_requests(
        n_requests, vocab, prompt_lens=prompt_lens,
        mean_interarrival_s=mean_interarrival_s, seed=seed,
    )
    max_prompt = max(len(p) for _, p in requests)
    # page tables need whole pages per lane: round max_len up
    max_len = -(-(max_prompt + max_new) // page_size) * page_size
    limit = getattr(model, "max_positions", None)
    if limit is not None and max_len > limit:
        max_len = limit // page_size * page_size
    base = dict(
        n_slots=n_slots, max_len=max_len, decode_block=decode_block,
        bucket=min(32, max_prompt), max_prefills_per_step=n_slots,
        max_waiting=max(256, n_requests), seed=seed,
    )
    lane_cfg = ServeConfig(**base)
    paged_cfg = ServeConfig(**base, paged=True, page_size=page_size)
    warm = _warm_trace(requests)
    probe_fields, probe_eng = _obs_probe(model, warm, paged_cfg, max_new,
                                         arms=arms, status_port=status_port)

    # ---- 1. Poisson: paged vs lane at the same slots + pool bytes ----
    _run_engine_arm(model, warm, lane_cfg, max_new)
    runs, kv = _paired_arm_stats(model, requests, paged_cfg, lane_cfg,
                                 max_new, reps=reps, arms=arms,
                                 names=("paged", "lane"))
    paged_rps = len(requests) / (
        sum(mk for mk, _ in runs["on"]) / len(runs["on"]))
    lane_rps = len(requests) / (
        sum(mk for mk, _ in runs["off"]) / len(runs["off"]))
    detail = {
        "config": _config_name(config),
        "workload": "paged-vs-lane",
        "n_requests": n_requests,
        "n_slots": n_slots,
        "page_size": page_size,
        "max_len": max_len,
        "max_new_tokens": max_new,
        "decode_block": decode_block,
        "prompt_lens": list(prompt_lens),
        "mean_interarrival_s": mean_interarrival_s,
        "paged_requests_per_sec": round(paged_rps, 2),
        "lane_requests_per_sec": round(lane_rps, 2),
        "paged_overhead_pct": round((1.0 - paged_rps / lane_rps) * 100.0, 2),
        "paged_kv_pool_bytes": kv["on"]["kv_pool_bytes"],
        "lane_kv_pool_bytes": kv["off"]["kv_pool_bytes"],
        **kv["on"],
        **probe_fields,
    }

    # ---- 2. capacity at equal pool bytes: 2x slots, lane-pool bytes --
    cap_new = max(8, max_new // 4)  # shorter streams: the mixed-length
    # regime where per-page booking beats whole-lane booking
    cap_budget = n_slots * (max_len // page_size)
    cap_cfg = ServeConfig(**{**base, "n_slots": 2 * n_slots},
                          paged=True, page_size=page_size,
                          page_budget=cap_budget)
    _run_engine_arm(model, warm, cap_cfg, cap_new)
    arms.begin()
    before = torch.cuda.memory_allocated(dev) if arms.card else 0
    t0 = time.monotonic()
    cap_eng, cap_handles, cap_mk = _run_engine_arm(model, requests, cap_cfg,
                                                   cap_new)
    arms.log["capacity"] = {"wall_s": round(time.monotonic() - t0, 4)}
    cap_snap = cap_eng.metrics.snapshot()
    cap_pool = int(cap_eng.pool.nbytes)
    del cap_eng
    detail.update({
        "capacity_n_slots": 2 * n_slots,
        "capacity_page_budget": cap_budget,
        "capacity_max_new_tokens": cap_new,
        "capacity_peak_active_slots": _peak_concurrency(cap_handles),
        "capacity_kv_pool_bytes": cap_pool,
        "capacity_requests_per_sec": round(n_requests / cap_mk, 2),
        "capacity_preemptions": int(cap_snap.get("serve/preemptions", 0.0)),
    })
    if arms.card:
        # the "equal bytes" claim is about the RESIDENT pool: what the
        # paged decode's gathered lane view and the activations add on
        # top is reported beside it, not hidden
        peak = arms.peak()
        arms.log["capacity"]["peak_bytes"] = peak
        detail["capacity_program_temp_bytes"] = peak - before - cap_pool

    # ---- 3. shared-prefix: page-sharing hit TTFT --------------------
    # long stems, a tiny generation budget: a hit skips the stem's
    # prefill, so prefill must dominate the request
    pmax_new = min(max_new, 4)
    pblock = min(decode_block, 4)
    # the stem stretches to the model's position budget, independent of
    # the Poisson arm's tighter max_len
    pmax_len = (limit or 256) // page_size * page_size
    plen = max(page_size,
               ((pmax_len - suffix_len - pmax_new) // page_size) * page_size)
    pn = 48 if prefix_requests is None else prefix_requests
    preqs = shared_prefix_requests(
        pn, vocab, n_prefixes=n_prefixes, prefix_len=plen,
        suffix_len=suffix_len, mean_interarrival_s=0.002, seed=seed,
    )
    pbase = dict(base, max_len=pmax_len,
                 bucket=max(8, -(-suffix_len // 8) * 8),
                 decode_block=pblock)
    tree = dict(prefix_cache=True, prefix_page=page_size,
                prefix_cache_bytes=_tree_bytes(
                    model, ServeConfig.prefix_cache_bytes, n_prefixes,
                    plen + suffix_len, page_size))
    pcfg_on = ServeConfig(**pbase, paged=True, page_size=page_size, **tree)
    pcfg_off = ServeConfig(**pbase, paged=True, page_size=page_size)
    lane_on = ServeConfig(**pbase, **tree)
    pwarm = shared_prefix_requests(
        2 * n_prefixes, vocab, n_prefixes=n_prefixes, prefix_len=plen,
        suffix_len=suffix_len, mean_interarrival_s=0.0, seed=seed + 1,
    )
    for warm_cfg in (pcfg_on, pcfg_off, lane_on):
        _run_engine_arm(model, pwarm, warm_cfg, pmax_new)
    # pair A: paged cache-on vs cache-off (one extra rep: TTFT means are
    # noisier than makespans)
    pruns, _ = _paired_arm_stats(model, preqs, pcfg_on, pcfg_off, pmax_new,
                                 reps=reps + 1, arms=arms,
                                 names=("paged_prefix", "paged_noprefix"))
    # pair B: paged cache-on vs LANE cache-on — page sharing vs the lane
    # pool's splice copy, hit for hit
    lruns, _ = _paired_arm_stats(model, preqs, pcfg_on, lane_on, pmax_new,
                                 reps=reps, arms=arms,
                                 names=("paged_prefix_b", "lane_prefix"))
    ttft_on = float(np.mean([s["serve/ttft_s_mean"] for _, s in pruns["on"]]))
    ttft_off = float(np.mean(
        [s["serve/ttft_s_mean"] for _, s in pruns["off"]]))
    ttft_lane = float(np.mean(
        [s["serve/ttft_s_mean"] for _, s in lruns["off"]]))
    on_snap = pruns["on"][-1][1]
    # the zero-copy witness: the cache-on paged config once more over
    # the warm trace, counting the lane pool's prefix copies
    copies = dict(kv_pool.PREFIX_COPIES)
    _engine_arm_stats(model, pwarm, pcfg_on, pmax_new)
    splices = sum(kv_pool.PREFIX_COPIES[k] - copies[k] for k in copies)
    detail.update({
        "prefix_len": plen,
        "suffix_len": suffix_len,
        "n_prefixes": n_prefixes,
        "prefix_n_requests": pn,
        "paged_prefix_mean_ttft_s": round(ttft_on, 4),
        "paged_noprefix_mean_ttft_s": round(ttft_off, 4),
        "lane_prefix_mean_ttft_s": round(ttft_lane, 4),
        "paged_prefix_ttft_speedup": round(ttft_off / ttft_on, 2),
        "paged_vs_lane_prefix_ttft": round(ttft_lane / ttft_on, 2),
        "paged_prefix_hit_rate": round(
            on_snap.get("serve/prefix_hit_rate", 0.0), 3
        ),
        "splice_programs_dispatched": splices,
        "arms": arms.log,
    })
    _release_probe(probe_eng, status_hold_s)
    return {
        "metric": "serve_paged_slots_at_equal_hbm",
        "value": detail["capacity_peak_active_slots"],
        "unit": "concurrent slots (lane-pool HBM budget)",
        "vs_baseline": round(detail["capacity_peak_active_slots"] / n_slots, 2),
        "detail": detail,
    }


def run_sampling_bench(
    config="llama3_shakespeare",
    n_requests: int = 32,
    n_slots: int = 8,
    max_new: int = 64,
    decode_block: int = 16,
    prompt_lens=(16, 32, 48, 64),
    mean_interarrival_s: float = 0.001,
    seed: int = 0,
    trace: bool = False,
    trace_out: str | None = None,
    trace_dump: str | None = None,
    status_port: int | None = None,
    status_hold_s: float = 0.0,
    device=None,
) -> dict:
    """Sampled against greedy decode on the same Poisson trace: the same
    engine config over the same arrival offsets, only the per-request
    SamplingParams differ. The headline (`vs_baseline`) is sampled req/s
    over greedy req/s: the fused sampler's cost when a batch mixes
    stochastic requests (an all-greedy batch takes the argmax-only path).
    """
    model, vocab = build_serve_model(config, device)
    arms = _Arms(model.device)
    requests = synthetic_requests(
        n_requests, vocab, prompt_lens=prompt_lens,
        mean_interarrival_s=mean_interarrival_s, seed=seed,
    )
    serve_cfg = poisson_serve_config(requests, n_slots, max_new,
                                     decode_block, seed)
    warm = _warm_trace(requests)
    # the probe mirrors the headline (sampled-mix) arm
    probe_fields, probe_eng = _obs_probe(model, warm, serve_cfg, max_new,
                                         params_for=sampling_params_mix,
                                         arms=arms, status_port=status_port)
    _run_engine_arm(model, warm, serve_cfg, max_new)
    _run_engine_arm(model, warm, serve_cfg, max_new,
                    params_for=sampling_params_mix)

    arms_out = {}
    kv = None
    for name, params_for in (("greedy", None),
                             ("sampled", sampling_params_mix)):
        makespan, snap, kv, _ = arms.run(name, _engine_arm_stats, model,
                                         requests, serve_cfg, max_new,
                                         params_for=params_for)
        arms_out[name] = {
            "requests_per_sec": n_requests / makespan,
            "tokens_per_sec": snap.get("serve/tokens_per_sec", 0.0),
            **_round_if_present(snap, "serve/ttft_s_mean", "mean_ttft_s", 4),
            **_round_if_present(snap, "serve/itl_s_p95", "itl_p95_s", 5),
        }
    # the traced arm mirrors the headline (sampled-mix) arm
    trace_fields = (_traced_arm_fields(model, requests, serve_cfg, max_new,
                                       trace_out, trace_dump,
                                       params_for=sampling_params_mix,
                                       arms=arms)
                    if trace else {})
    _release_probe(probe_eng, status_hold_s)
    ratio = (arms_out["sampled"]["requests_per_sec"]
             / arms_out["greedy"]["requests_per_sec"])
    return {
        "metric": "serve_sampling_requests_per_sec",
        "value": round(arms_out["sampled"]["requests_per_sec"], 2),
        "unit": "req/s",
        # > 1 would mean sampling was free (noise); ~0.9 = 10% overhead
        "vs_baseline": round(ratio, 3),
        "detail": {
            "config": _config_name(config),
            "workload": "sampling-mix",
            "n_requests": n_requests,
            "n_slots": n_slots,
            "max_new_tokens": max_new,
            "decode_block": decode_block,
            "prompt_lens": list(prompt_lens),
            "mean_interarrival_s": mean_interarrival_s,
            "sampling_overhead_pct": round((1.0 - ratio) * 100.0, 1),
            **{f"{arm}_{k}": (round(v, 2) if isinstance(v, float) else v)
               for arm, d in arms_out.items() for k, v in d.items()},
            **kv,
            **probe_fields,
            **trace_fields,
            "arms": arms.log,
        },
    }


def _run_http_arm(model, requests, serve_cfg, max_new):
    """The arrival trace served over the OpenAI HTTP front door: one SSE
    client thread per request, connecting at its Poisson offset.

    Latency is measured at the CLIENT side of the socket: TTFT = first
    text chunk - arrival, ITL = inter-chunk gaps spread over the chunk's
    token count (the server has no tokenizer here, so tokens stream as
    "id " text). Returns ``(makespan, stats)``, stats holding each
    request's ttft, gaps and streamed ids. The server's close drains and
    closes its engine, which is dropped with it."""
    import http.client
    import json as _json
    import threading

    from solvingpapers_tpu_torch.serve.api import ApiServer

    srv = ApiServer(ServeEngine(model, serve_cfg, device=model.device))
    pending = sorted(requests, key=lambda r: r[0])
    results: list = [None] * len(pending)
    t0 = time.monotonic()

    def client(i: int, arrival: float, prompt) -> None:
        delay = arrival - (time.monotonic() - t0)
        if delay > 0:
            time.sleep(delay)
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)
        body = _json.dumps({
            "prompt": [int(t) for t in prompt], "max_tokens": max_new,
            "temperature": 0, "stream": True,
        })
        conn.request("POST", "/v1/completions", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()[:200]
        ttft = None
        last = None
        gaps: list[float] = []
        text_parts: list[str] = []
        reason = None
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            payload = line[6:]
            if payload == b"[DONE]":
                break
            now = time.monotonic()
            choice = _json.loads(payload)["choices"][0]
            reason = choice["finish_reason"] or reason
            text = choice["text"]
            n = len(text.split())
            if n == 0:
                continue
            text_parts.append(text)
            if ttft is None:
                ttft = now - (t0 + arrival)
                n -= 1  # the first token stamps TTFT, not an ITL gap
            if last is not None and n > 0:
                gaps.extend([(now - last) / n] * n)
            last = now
        conn.close()
        ids = [int(x) for x in "".join(text_parts).split()]
        results[i] = {
            "ttft": ttft, "gaps": gaps, "ids": ids, "reason": reason,
            "finish": time.monotonic() - t0,
        }

    threads = [
        threading.Thread(target=client, args=(i, a, p), daemon=True)
        for i, (a, p) in enumerate(pending)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    srv.close()
    assert all(r is not None and r["reason"] for r in results), \
        "an HTTP stream died or ended without a finish_reason"
    makespan = max(r["finish"] for r in results) - pending[0][0]
    return makespan, results


def _first_diff(streams, handles) -> dict | None:
    """The first request (arrival order) whose streamed ids differ from
    its direct handle's, with the position, the tokens before it and the
    two tokens (None where a stream ended first); None when all agree."""
    for j, (ids, h) in enumerate(zip(streams, handles)):
        if ids == h.tokens:
            continue
        p = next((k for k, (a, b) in enumerate(zip(ids, h.tokens)) if a != b),
                 min(len(ids), len(h.tokens)))
        return {"request": j, "position": p, "common": h.tokens[:p],
                "http": ids[p] if p < len(ids) else None,
                "direct": h.tokens[p] if p < len(h.tokens) else None}
    return None


def run_http_bench(
    config="llama3_shakespeare",
    n_requests: int = 32,
    n_slots: int = 8,
    max_new: int = 64,
    decode_block: int = 16,
    prompt_lens=(16, 32, 48, 64),
    mean_interarrival_s: float = 0.001,
    seed: int = 0,
    reps: int = 2,
    status_port: int | None = None,
    status_hold_s: float = 0.0,
    device=None,
) -> dict:
    """The concurrent-SSE-connection soak: the Poisson trace ABBA-paired
    through (A) the OpenAI front door — n_requests concurrent SSE clients
    over loopback sockets, the engine driven by the ApiServer's
    EngineLoop thread — and (B) direct in-process `submit` + `step()`.
    `http_overhead_pct` is the whole network path's cost. Every streamed
    id sequence is checked against the direct arm's handle for the same
    prompt (`stream_token_exact`): the wire must not change the tokens.
    """
    model, vocab = build_serve_model(config, device)
    arms = _Arms(model.device)
    requests = synthetic_requests(
        n_requests, vocab, prompt_lens=prompt_lens,
        mean_interarrival_s=mean_interarrival_s, seed=seed,
    )
    # every client streams at once: the front door's connection cap must
    # clear the client count
    serve_cfg = poisson_serve_config(requests, n_slots, max_new,
                                     decode_block, seed,
                                     api_max_connections=max(64, n_requests))
    warm = _warm_trace(requests)
    probe_fields, probe_eng = _obs_probe(model, warm, serve_cfg, max_new,
                                         arms=arms, status_port=status_port)
    _run_engine_arm(model, warm, serve_cfg, max_new)

    http_mk: list[float] = []
    direct_mk: list[float] = []
    http_stats = None
    direct_handles = None
    kv = None
    for r in range(reps):
        order = ("http", "direct") if r % 2 == 0 else ("direct", "http")
        for arm in order:
            if arm == "http":
                mk, http_stats = arms.run(f"http[{r}]", _run_http_arm, model,
                                          requests, serve_cfg, max_new)
                http_mk.append(mk)
            else:
                mk, _, kv, direct_handles = arms.run(
                    f"direct[{r}]", _engine_arm_stats, model, requests,
                    serve_cfg, max_new)
                direct_mk.append(mk)
    # both arms process the arrival-sorted trace, so indexes align
    diff = _first_diff([s["ids"] for s in http_stats], direct_handles)
    http_rps = n_requests / (sum(http_mk) / len(http_mk))
    direct_rps = n_requests / (sum(direct_mk) / len(direct_mk))
    ttfts = [r["ttft"] for r in http_stats]
    gaps = [g for r in http_stats for g in r["gaps"]]
    detail = {
        "config": _config_name(config),
        "workload": "http-stream-soak",
        "n_requests": n_requests,
        "n_clients": n_requests,
        "n_slots": n_slots,
        "max_new_tokens": max_new,
        "decode_block": decode_block,
        "prompt_lens": list(prompt_lens),
        "mean_interarrival_s": mean_interarrival_s,
        "reps": reps,
        "http_requests_per_sec": round(http_rps, 2),
        "direct_requests_per_sec": round(direct_rps, 2),
        "http_overhead_pct": round((1.0 - http_rps / direct_rps) * 100.0, 2),
        "http_mean_ttft_s": round(float(np.mean(ttfts)), 4),
        "http_ttft_p95_s": round(float(np.percentile(ttfts, 95)), 4),
        "http_itl_p99_s": round(float(np.percentile(gaps, 99)), 5)
        if gaps else None,
        "stream_token_exact": diff is None,
        **kv,
        **probe_fields,
        "arms": arms.log,
    }
    if diff is not None:
        detail["stream_first_diff"] = diff
    _release_probe(probe_eng, status_hold_s)
    return {
        "metric": "serve_http_stream_requests_per_sec",
        "value": round(http_rps, 2),
        "unit": "req/s",
        # ~1.0 = the front door is free
        "vs_baseline": round(http_rps / direct_rps, 3),
        "detail": detail,
    }


# the SLO workload's class cycle, one class a request in arrival order
SLO_CLASS_CYCLE = ("interactive", "standard", "batch")


def run_slo_bench(
    config="llama3_shakespeare",
    n_requests: int = 32,
    n_slots: int = 8,
    max_new: int = 64,
    decode_block: int = 16,
    prompt_lens=(16, 32, 48, 64),
    mean_interarrival_s: float = 0.001,
    seed: int = 0,
    reps: int = 2,
    slo_targets: dict | None = None,
    status_port: int | None = None,
    status_hold_s: float = 0.0,
    device=None,
) -> dict:
    """`cli serve-bench --slo`: the Poisson trace ABBA-paired through (A)
    an engine with `slo_targets` set and every request tagged with a
    class cycling interactive / standard / batch, and (B) the plain
    engine. Both decode greedily and run the same programs (SLO
    accounting is host-side finish-path bookkeeping), so
    `slo_overhead_pct` is the accounting's cost. The result records
    per-class attainment, burn and `goodput_tokens_per_s` (tokens of
    SLO-attained requests only) of the last SLO-on run."""
    from solvingpapers_tpu_torch.serve.slo import DEFAULT_SLO_TARGETS

    targets = slo_targets or DEFAULT_SLO_TARGETS
    model, vocab = build_serve_model(config, device)
    arms = _Arms(model.device)
    requests = synthetic_requests(
        n_requests, vocab, prompt_lens=prompt_lens,
        mean_interarrival_s=mean_interarrival_s, seed=seed,
    )
    base_cfg = poisson_serve_config(requests, n_slots, max_new, decode_block,
                                    seed)
    slo_cfg = dataclasses.replace(base_cfg, slo_targets=targets)

    def params_for(i: int) -> SamplingParams:
        # greedy everywhere: only the class tag differs between the arms
        return SamplingParams(slo=SLO_CLASS_CYCLE[i % len(SLO_CLASS_CYCLE)])

    warm = _warm_trace(requests)
    probe_fields, probe_eng = _obs_probe(model, warm, slo_cfg, max_new,
                                         params_for=params_for, arms=arms,
                                         status_port=status_port)
    _run_engine_arm(model, warm, base_cfg, max_new)
    # ABBA with per-arm request params: the plain arm stays untagged (its
    # engine refuses a class)
    mk = {"slo": [], "plain": []}
    snap = slo_doc = kv = None
    for rep in range(reps):
        order = ("slo", "plain") if rep % 2 == 0 else ("plain", "slo")
        for arm in order:
            on = arm == "slo"
            eng, _, span = arms.run(f"{arm}[{rep}]", _run_engine_arm, model,
                                    requests, slo_cfg if on else base_cfg,
                                    max_new, params_for=params_for if on else None)
            mk[arm].append(span)
            if on:
                snap = eng.metrics.snapshot()
                slo_doc = eng.statusz()["slo"]
                kv = _kv_entry_fields(eng)
            del eng
    slo_rps = n_requests / (sum(mk["slo"]) / len(mk["slo"]))
    plain_rps = n_requests / (sum(mk["plain"]) / len(mk["plain"]))
    per_class = {
        cls: {"finished": d["finished"], "attainment": d["attainment"],
              "burn_rate": d["burn_rate"], "violations": d["violations"]}
        for cls, d in slo_doc["classes"].items()
    }
    tokens_per_s = snap.get("serve/tokens_per_sec", 0.0)
    goodput_per_s = snap.get("serve/goodput_tokens_per_s", 0.0)
    _release_probe(probe_eng, status_hold_s)
    return {
        "metric": "serve_slo_goodput_tokens_per_s",
        "value": round(goodput_per_s, 2),
        "unit": "tok/s from SLO-attained requests (last slo-on rep)",
        # goodput / raw throughput: 1.0 = every token within its targets
        "vs_baseline": (round(goodput_per_s / tokens_per_s, 3)
                        if tokens_per_s else 0.0),
        "detail": {
            "config": _config_name(config),
            "workload": "slo-observatory",
            "n_requests": n_requests,
            "n_slots": n_slots,
            "max_new_tokens": max_new,
            "decode_block": decode_block,
            "prompt_lens": list(prompt_lens),
            "mean_interarrival_s": mean_interarrival_s,
            "reps": reps,
            "class_cycle": list(SLO_CLASS_CYCLE),
            "slo_targets": {cls: dict(spec) for cls, spec in targets.items()},
            "slo_overhead_pct": round((1.0 - slo_rps / plain_rps) * 100.0, 2),
            "slo_requests_per_sec": round(slo_rps, 2),
            "plain_requests_per_sec": round(plain_rps, 2),
            "goodput_tokens_per_s": round(goodput_per_s, 2),
            "tokens_per_sec": round(tokens_per_s, 2),
            "goodput_ratio": (round(goodput_per_s / tokens_per_s, 4)
                              if tokens_per_s else 0.0),
            "attainment_by_class": per_class,
            "goodput_tokens": int(slo_doc["goodput_tokens"]),
            **_round_if_present(snap, "serve/ttft_s_p95", "ttft_p95_s", 4),
            **_round_if_present(snap, "serve/itl_s_p95", "itl_p95_s", 5),
            **kv,
            **probe_fields,
            "arms": arms.log,
        },
    }


# ------------------------------------------------------------------ chaos


def chaos_fault_plan(n_slots: int, seed: int = 0, stall_s: float = 0.05,
                     journal: bool = False) -> tuple:
    """The seeded chaos schedule `run_chaos_bench` drives: two slot poisons
    (NaN and Inf: the quarantine path, both finite-guard codes), one
    synthetic device error and one prefill out-of-memory (the rebuild and
    recompute path), and one step stall (the watchdog). With `journal`,
    one ``io_error`` at the ``journal_write`` site (the degraded-journal
    path). Deterministic given (n_slots, seed): the same schedule replays
    across the ladder-off and ladder-on arms."""
    rng = np.random.default_rng(seed)
    slots = rng.permutation(n_slots)
    v = sorted(int(x) for x in rng.integers(8, 48, size=4))
    plan = (
        dict(site="prefill", kind="oom", visit=int(rng.integers(3, 8))),
        dict(site="decode", kind="nan", visit=v[0], slot=int(slots[0])),
        dict(site="decode", kind="inf", visit=v[1],
             slot=int(slots[1 % len(slots)])),
        dict(site="decode", kind="xla_error", visit=v[2]),
        dict(site="decode", kind="stall", visit=v[3], stall_s=stall_s),
    )
    if journal:
        plan += (dict(site="journal_write", kind="io_error",
                      visit=int(rng.integers(6, 24))),)
    return plan


def _run_chaos_arm(model, requests, serve_cfg, max_new, params_for=None):
    """`_run_engine_arm` that tolerates rejects: under the degradation
    ladder (or an unhealthy window) submissions may bounce, and those are
    counted as shed. Returns (engine, accepted handles BY REQUEST INDEX
    (None = shed), shed count, makespan)."""
    eng = ServeEngine(model, serve_cfg, device=model.device)
    pending = sorted(enumerate(requests), key=lambda r: r[1][0])
    handles: list = [None] * len(requests)
    shed = 0
    t0 = time.monotonic()
    i = 0
    while i < len(pending) or eng.has_work():
        elapsed = time.monotonic() - t0
        while i < len(pending) and pending[i][1][0] <= elapsed:
            ridx, (_, prompt) = pending[i]
            h = eng.submit(prompt, max_new_tokens=max_new,
                           params=params_for(ridx) if params_for else None)
            if h.state == "rejected":
                shed += 1
            else:
                handles[ridx] = h
            i += 1
        if eng.has_work():
            eng.step()
        elif i < len(pending):
            time.sleep(max(0.0, pending[i][1][0] - (time.monotonic() - t0)))
    makespan = (time.monotonic() - t0) - pending[0][1][0]
    assert all(h.done for h in handles if h is not None), \
        "chaos arm drained unfinished"
    return eng, handles, shed, makespan


def _zero_leak_fields(eng) -> dict:
    """The drained pool's leak invariant as result facts: the slot free
    mask and free list consistent and, on a paged pool (its prefix tree
    evicted first: the one legitimate holder after a drain), every page
    free with the refcount sum back at the trash page's 1."""
    pool = eng.pool
    ok = (pool.n_active == 0 and bool(pool._free_mask.all())
          and sorted(pool._free) == list(range(pool.n_slots)))
    out = {"slots_clean": ok}
    if eng.prefix_cache is not None:
        while eng.prefix_cache.evict_one():
            pass
    if hasattr(pool, "refcount"):
        out["pages_free"] = pool.pages_free
        out["page_budget"] = pool.page_budget
        out["refcount_sum"] = int(pool.refcount.sum())
        ok = (ok and pool.pages_free == pool.page_budget
              and out["refcount_sum"] == 1)
    out["zero_leak"] = ok
    return out


def _page_max_len(requests, max_new: int, page: int = 16) -> int:
    """The longest prompt and its new tokens, rounded up to a page."""
    max_prompt = max(len(p) for _, p in requests)
    return -(-(max_prompt + max_new) // page) * page


def run_chaos_bench(
    config="llama3_shakespeare",
    n_requests: int = 48,
    n_slots: int = 4,
    max_new: int = 48,
    decode_block: int = 8,
    prompt_lens=(16, 32, 48, 64),
    # arrivals spread out: shedding shows only while admissions keep
    # arriving with the ladder up
    mean_interarrival_s: float = 0.15,
    seed: int = 0,
    reps: int = 4,
    # the stall alone must exceed the watchdog deadline below
    stall_s: float = 0.75,
    slo_targets: dict | None = None,
    status_port: int | None = None,
    status_hold_s: float = 0.0,
    device=None,
) -> dict:
    """`cli serve-bench --chaos`: the fault-tolerance soak. One seeded
    fault schedule (`chaos_fault_plan`, with a journal ``io_error``)
    replays over the Poisson trace through three paged, SLO-tracked
    engines:

    * reference, fault-free: the token-exactness oracle;
    * chaos, ladder OFF, journaled: `streams_survived` (finished other
      than "error"), `survivors_token_exact` (every survivor equal to the
      reference: quarantine contained the poison, rebuilds recomputed
      exactly), `fault_recovery_s`, `journal_degraded_exercised` and the
      drained pool's `zero_leak`;
    * chaos, ladder ON: the same schedule with the degradation ladder,
      `goodput_ladder_on` against `goodput_ladder_off`.

    `fault_overhead_pct` is the ABBA-paired cost of an armed plan that
    never fires against none."""
    import os
    import tempfile

    from solvingpapers_tpu_torch.serve.slo import DEFAULT_SLO_TARGETS

    targets = slo_targets or DEFAULT_SLO_TARGETS
    model, vocab = build_serve_model(config, device)
    arms = _Arms(model.device)
    requests = synthetic_requests(
        n_requests, vocab, prompt_lens=prompt_lens,
        mean_interarrival_s=mean_interarrival_s, seed=seed)
    max_prompt = max(len(p) for _, p in requests)
    plan = chaos_fault_plan(n_slots, seed=seed, stall_s=stall_s, journal=True)
    journal_dir = tempfile.mkdtemp(prefix="serve_chaos_journal_")
    base_cfg = ServeConfig(
        n_slots=n_slots, max_len=_page_max_len(requests, max_new),
        decode_block=decode_block, bucket=min(32, max_prompt),
        max_prefills_per_step=n_slots, max_waiting=max(256, n_requests),
        paged=True, page_size=16, seed=seed)
    ref_cfg = dataclasses.replace(base_cfg, slo_targets=targets)
    # the watchdog's deadline BELOW the injected stall, so the stall trips it
    chaos_cfg = dataclasses.replace(
        ref_cfg, fault_plan=plan,
        fault_step_deadline_s=max(0.25, 0.75 * stall_s),
        journal_path=os.path.join(journal_dir, "chaos_off.jsonl"))
    ladder_cfg = dataclasses.replace(
        chaos_cfg, degrade=True,
        journal_path=os.path.join(journal_dir, "chaos_on.jsonl"))

    def params_for(i: int) -> SamplingParams:
        return SamplingParams(slo=SLO_CLASS_CYCLE[i % len(SLO_CLASS_CYCLE)])

    probe_fields, probe_eng = _obs_probe(
        model, _warm_trace(requests), ref_cfg, max_new, params_for=params_for,
        arms=arms, status_port=status_port)
    ref_eng, ref_handles, _, _ = arms.run(
        "reference", _run_chaos_arm, model, requests, ref_cfg, max_new,
        params_for=params_for)
    kv = _kv_entry_fields(ref_eng)
    del ref_eng

    off_eng, off_handles, off_shed, _ = arms.run(
        "chaos_off", _run_chaos_arm, model, requests, chaos_cfg, max_new,
        params_for=params_for)
    off_snap = off_eng.metrics.snapshot()
    survivors = [(i, h) for i, h in enumerate(off_handles)
                 if h is not None and h.finish_reason != "error"]
    errored = sum(1 for h in off_handles
                  if h is not None and h.finish_reason == "error")
    exact = all(h.tokens == ref_handles[i].tokens for i, h in survivors)
    leak_fields = _zero_leak_fields(off_eng)
    journal_degraded = bool(off_eng._journal_degraded)
    goodput_off = off_snap.get("serve/goodput_tokens_per_s", 0.0)
    del off_eng

    on_eng, _, on_shed, _ = arms.run(
        "chaos_on", _run_chaos_arm, model, requests, ladder_cfg, max_new,
        params_for=params_for)
    goodput_on = on_eng.metrics.snapshot().get(
        "serve/goodput_tokens_per_s", 0.0)
    ladder_stats = on_eng.statusz()["health"].get("ladder", {})
    on_leaks = _zero_leak_fields(on_eng)
    del on_eng

    # an armed plan that never fires against none: the hooks' cost
    quiet = (dict(site="decode", kind="stall", visit=1_000_000_000,
                  stall_s=0.001),)
    runs, _ = _paired_arm_stats(
        model, requests, dataclasses.replace(base_cfg, fault_plan=quiet),
        base_cfg, max_new, reps=reps, arms=arms, names=("armed", "plain"))
    armed_rps = n_requests / np.mean([mk for mk, _ in runs["on"]])
    plain_rps = n_requests / np.mean([mk for mk, _ in runs["off"]])
    _release_probe(probe_eng, status_hold_s)
    admitted = sum(1 for h in off_handles if h is not None)
    return {
        "metric": "serve_chaos_streams_survived",
        "value": len(survivors),
        "unit": (f"streams finished non-error of {admitted} admitted under "
                 "the seeded fault schedule (ladder-off arm)"),
        "vs_baseline": round(len(survivors) / admitted, 4) if admitted else 0.0,
        "detail": {
            "config": _config_name(config),
            "workload": "chaos",
            "n_requests": n_requests,
            "n_slots": n_slots,
            "max_new_tokens": max_new,
            "decode_block": decode_block,
            "prompt_lens": list(prompt_lens),
            "mean_interarrival_s": mean_interarrival_s,
            "reps": reps,
            "fault_plan": [dict(spec) for spec in plan],
            "streams_survived": len(survivors),
            "streams_admitted": admitted,
            "streams_quarantined": errored,
            "streams_shed_off_arm": off_shed,
            "survivors_token_exact": exact,
            "faults_injected": int(off_snap.get("serve/fault_injected", 0)),
            "fault_retries": int(off_snap.get("serve/fault_retries", 0)),
            "fault_recovery_s": round(
                off_snap.get("serve/fault_recovery_s", 0.0), 4),
            "watchdog_stalls": int(off_snap.get("serve/watchdog_stalls", 0)),
            "journal_degraded_exercised": journal_degraded,
            **leak_fields,
            "ladder_zero_leak": on_leaks["zero_leak"],
            "goodput_ladder_on": round(goodput_on, 2),
            "goodput_ladder_off": round(goodput_off, 2),
            "goodput_ladder_ratio": (round(goodput_on / goodput_off, 4)
                                     if goodput_off else None),
            "ladder_max_shed": on_shed,
            "ladder_rung_final": ladder_stats.get("rung"),
            "ladder_transitions": ladder_stats.get("transitions"),
            "fault_overhead_pct": round((1.0 - armed_rps / plain_rps) * 100.0,
                                        2),
            "armed_requests_per_sec": round(float(armed_rps), 2),
            "plain_requests_per_sec": round(float(plain_rps), 2),
            **kv,
            **probe_fields,
            "arms": arms.log,
        },
    }


# ---------------------------------------------------------------- journal


def _journal_params_for(i: int) -> SamplingParams | None:
    """The durability workloads' sampling cycle: greedy and two SEEDED
    stochastic shapes, so every stream replays (seeded chains fold only
    (seed, sample index))."""
    if i % 3 == 1:
        return SamplingParams(temperature=0.8, top_p=0.9, seed=1000 + i)
    if i % 3 == 2:
        return SamplingParams(temperature=1.2, top_k=8, seed=2000 + i)
    return None


def run_journal_bench(
    config="llama3_shakespeare",
    n_requests: int = 32,
    n_slots: int = 8,
    max_new: int = 64,
    decode_block: int = 16,
    prompt_lens=(16, 32, 48, 64),
    mean_interarrival_s: float = 0.001,
    seed: int = 0,
    reps: int = 4,
    kill_step: int | None = None,
    journal_dir: str | None = None,
    status_port: int | None = None,
    status_hold_s: float = 0.0,
    device=None,
) -> dict:
    """`cli serve-bench --journal`: the durability workload.

    * overhead: ABBA-paired journal-on against journal-off req/s on the
      Poisson trace (`journal_overhead_pct`; records are buffered writes,
      fsynced once a step);
    * kill and recover: every request submitted up front through a
      journaled engine, which is ABANDONED mid-decode (after a third of
      the requests finish, or at `kill_step`: no close, no drain); a fresh
      engine opens the same journal, `recover()` requeues the live set and
      the drain completes every stream. `recovered_token_exact` holds
      every stream (finished before the kill or recovered) equal to an
      uninterrupted reference run over greedy and seeded sampling;
      `recovery_wall_s` runs from the fresh engine's construction to the
      last recovered finish; `zero_leak` holds after the drain."""
    import os
    import tempfile

    model, vocab = build_serve_model(config, device)
    arms = _Arms(model.device)
    requests = synthetic_requests(
        n_requests, vocab, prompt_lens=prompt_lens,
        mean_interarrival_s=mean_interarrival_s, seed=seed)
    max_prompt = max(len(p) for _, p in requests)
    jdir = journal_dir or tempfile.mkdtemp(prefix="serve_journal_bench_")
    base_cfg = ServeConfig(
        n_slots=n_slots, max_len=_page_max_len(requests, max_new),
        decode_block=decode_block, bucket=min(32, max_prompt),
        max_prefills_per_step=n_slots, max_waiting=max(256, n_requests),
        seed=seed)
    jcfg = dataclasses.replace(base_cfg,
                               journal_path=os.path.join(jdir, "overhead.jsonl"))
    probe_fields, probe_eng = _obs_probe(model, _warm_trace(requests),
                                         base_cfg, max_new, arms=arms,
                                         status_port=status_port)
    # the reference arm first: the uninterrupted oracle, and the plain
    # path's warm-up (every sampling shape runs here once)
    upfront = [(0.0, p) for _, p in requests]
    ref_eng, ref_handles, _ = arms.run(
        "reference", _run_engine_arm, model, upfront, base_cfg, max_new,
        params_for=_journal_params_for)
    kv = _kv_entry_fields(ref_eng)
    del ref_eng

    # overhead: journal-on against journal-off, ABBA and mean; the last
    # journaled engine's journal gives the record counts
    mk = {"on": [], "off": []}
    jstats = None
    for rep in range(reps):
        order = ("on", "off") if rep % 2 == 0 else ("off", "on")
        for arm in order:
            eng, _, span = arms.run(
                f"journal_{arm}[{rep}]", _run_engine_arm, model, requests,
                jcfg if arm == "on" else base_cfg, max_new)
            mk[arm].append(span)
            if arm == "on":
                jstats = eng.journal.stats()
                eng.close()
            del eng
    on_rps = n_requests / np.mean(mk["on"])
    off_rps = n_requests / np.mean(mk["off"])

    # kill and recover
    kcfg = dataclasses.replace(base_cfg,
                               journal_path=os.path.join(jdir, "recover.jsonl"))
    eng_a = ServeEngine(model, kcfg, device=model.device)
    handles = [eng_a.submit(p, max_new_tokens=max_new,
                            params=_journal_params_for(i))
               for i, (_, p) in enumerate(requests)]
    finish_target = max(1, n_requests // 3)
    steps = 0
    while eng_a.has_work():
        eng_a.step()
        steps += 1
        done = sum(1 for h in handles if h.done)
        if kill_step is not None:
            if steps >= kill_step:
                break
        elif finish_target <= done < n_requests:
            break
    finished_before = sum(1 for h in handles if h.done)
    live_at_kill = n_requests - finished_before
    # the in-process stand-in for a SIGKILL: no close, no drain; only what
    # the journal flushed survives
    del eng_a

    t0 = time.monotonic()
    eng_b = ServeEngine(model, kcfg, device=model.device)
    resumed = eng_b.recover()
    eng_b.run()
    recovery_wall_s = time.monotonic() - t0
    assert all(r.done for r in resumed), "recovery drained unfinished"
    by_rid = {r.trace_id: r for r in resumed}
    exact = all(
        (by_rid[h.trace_id].tokens if h.trace_id in by_rid else h.tokens)
        == r.tokens for h, r in zip(handles, ref_handles))
    leak_fields = _zero_leak_fields(eng_b)
    eng_b.close()
    del eng_b
    _release_probe(probe_eng, status_hold_s)
    return {
        "metric": "serve_journal_recovered_requests",
        "value": len(resumed),
        "unit": (f"in-flight requests recovered token-exactly after a "
                 f"mid-decode kill ({live_at_kill} live at kill)"),
        "vs_baseline": (round(len(resumed) / live_at_kill, 4)
                        if live_at_kill else 1.0),
        "detail": {
            "config": _config_name(config),
            "workload": "journal",
            "n_requests": n_requests,
            "n_slots": n_slots,
            "max_new_tokens": max_new,
            "decode_block": decode_block,
            "prompt_lens": list(prompt_lens),
            "mean_interarrival_s": mean_interarrival_s,
            "reps": reps,
            "journal_overhead_pct": round((1.0 - on_rps / off_rps) * 100.0, 2),
            "journal_on_requests_per_sec": round(float(on_rps), 2),
            "journal_off_requests_per_sec": round(float(off_rps), 2),
            "journal_records": jstats["records"],
            "journal_bytes": jstats["bytes_written"],
            "journal_fsyncs": jstats["fsyncs"],
            "journal_fsync_s": jstats["fsync_s"],
            "journal_rotations": jstats["rotations"],
            "kill_after_steps": steps,
            "finished_before_kill": finished_before,
            "live_at_kill": live_at_kill,
            "recovered_requests": len(resumed),
            "recovery_wall_s": round(recovery_wall_s, 4),
            "recovered_token_exact": exact,
            **leak_fields,
            **kv,
            **probe_fields,
            "arms": arms.log,
        },
    }


# ----------------------------------------------------------------- replay


def _train_bench_model(model, config, corpus_ids, steps: int, seed: int = 0):
    """Briefly fit the bench model on the synthetic corpus (the family's
    LM loss) at its full context, and load the fitted weights into
    `model` (cast to its dtype). The fit runs on a float32-master twin in
    the training layout, on `model`'s device, from the same seed-0
    initialisation `build_serve_model` draws."""
    import sys

    from solvingpapers_tpu_torch.configs import dense_twin, get_config
    from solvingpapers_tpu_torch.configs.factory import build_model, loss_fn_for
    from solvingpapers_tpu_torch.data.batches import lm_batch_iterator
    from solvingpapers_tpu_torch.metrics.writer import ConsoleWriter
    from solvingpapers_tpu_torch.train import OptimizerConfig, TrainConfig, Trainer

    cfg = dense_twin(get_config(config) if isinstance(config, str) else config)
    seq = min(256, getattr(model, "max_positions", None) or 64)
    tcfg = dataclasses.replace(
        TrainConfig(steps=steps, batch_size=16, log_every=10 * steps,
                    eval_every=0,
                    optimizer=OptimizerConfig(max_lr=3e-3, warmup_steps=10,
                                              total_steps=steps)),
        checkpoint_dir=None, ckpt_every=0, seed=0)
    twin = build_model(cfg, device=model.device, param_dtype=torch.float32)
    trainer = Trainer(twin, tcfg, loss_fn=loss_fn_for(cfg), device=model.device)
    trainer.fit(lm_batch_iterator(corpus_ids, 16, seq, seed=seed),
                writer=ConsoleWriter(stream=sys.stderr))
    with torch.no_grad():
        model.load_state_dict(twin.state_dict())
    model.eval()


def run_replay_bench(
    config="gpt_tiny_long",
    n_requests: int = 24,
    n_slots: int = 8,
    max_new: int = 48,
    decode_block: int = 8,
    prompt_lens=(16, 32, 48, 64),
    train_steps: int = 200,
    seed: int = 0,
    page_size: int = 16,
    cut_stride: int = 8,
    journal_dir: str | None = None,
    status_port: int | None = None,
    status_hold_s: float = 0.0,
    device=None,
) -> dict:
    """`cli serve-bench --replay`: the replay observatory's own gate.
    Journals a seeded workload (greedy and two seeded stochastic shapes,
    `_journal_params_for`: every stream byte-replayable) on the lane and
    the paged pool, then replays each journal through
    `serve.replay.ReplayHarness` at the IDENTICAL config on its pool:
    `byte_exact_rate` must be 1.0 on both (`replay_byte_exact`, the
    never-flip gate), and the lane arm's teacher-forced cuts score
    `identical_agreement_rate` 1.0.

    The reference's third arm, an int8-KV candidate graded by its
    teacher-forced greedy agreement, waits for the quantized pool (ROADMAP
    A5): the result leaves out its keys (`replay_agreement_rate` and its
    seeded and combined twins, `quant_byte_exact_rate`,
    `replay_first_divergence_p50`), says so under ``notes``, and its
    headline is the identical-config byte-exact rate. The model is
    briefly trained first (`train_steps`, 0 = random init), as the
    reference's is."""
    import os
    import tempfile

    from solvingpapers_tpu_torch.data.synthetic import synthetic_text
    from solvingpapers_tpu_torch.serve.replay import ReplayHarness

    model, vocab = build_serve_model(config, device)
    arms = _Arms(model.device)
    text = synthetic_text(n_chars=80000, seed=seed)
    ids = np.frombuffer(text.encode("ascii", "replace"),
                        np.uint8).astype(np.int32) % vocab
    if train_steps > 0:
        arms.run("train", _train_bench_model, model, config, ids, train_steps,
                 seed=seed)
    # corpus-slice prompts, all up front: replay exactness does not depend
    # on arrivals
    rng = np.random.default_rng(seed)
    requests = []
    for i in range(n_requests):
        length = prompt_lens[i % len(prompt_lens)]
        start = int(rng.integers(0, ids.size - length))
        requests.append((0.0, ids[start:start + length]))
    max_prompt = max(len(p) for _, p in requests)
    max_len = _page_max_len(requests, max_new, page_size)
    limit = getattr(model, "max_positions", None)
    if limit is not None and max_len > limit:
        max_len = limit // page_size * page_size
    jdir = journal_dir or tempfile.mkdtemp(prefix="serve_replay_bench_")
    base = dict(n_slots=n_slots, max_len=max_len, decode_block=decode_block,
                bucket=min(32, max_prompt), max_prefills_per_step=n_slots,
                max_waiting=max(256, n_requests), seed=seed)
    lane_rec_cfg = ServeConfig(**base,
                               journal_path=os.path.join(jdir, "lane.jsonl"))
    paged_rec_cfg = ServeConfig(**base, paged=True, page_size=page_size,
                                journal_path=os.path.join(jdir, "paged.jsonl"))
    probe_fields, probe_eng = _obs_probe(model, _warm_trace(requests),
                                         ServeConfig(**base), max_new,
                                         arms=arms, status_port=status_port)

    # record: journaled lane and paged runs
    lane_eng, _, _ = arms.run("record_lane", _run_engine_arm, model, requests,
                              lane_rec_cfg, max_new,
                              params_for=_journal_params_for)
    lane_eng.journal.sync()
    jstats = lane_eng.journal.stats()
    leak_fields = _zero_leak_fields(lane_eng)
    kv = _kv_entry_fields(lane_eng)
    lane_eng.close()
    del lane_eng
    paged_eng, _, _ = arms.run("record_paged", _run_engine_arm, model,
                               requests, paged_rec_cfg, max_new,
                               params_for=_journal_params_for)
    paged_eng.journal.sync()
    paged_eng.close()
    del paged_eng

    # replay: the identical config on each pool
    harness = ReplayHarness(model)
    t0 = time.monotonic()
    lane_report = arms.run(
        "replay_lane", harness.run, harness.load(lane_rec_cfg.journal_path),
        ServeConfig(**base), cut_stride=cut_stride,
        journal_path=lane_rec_cfg.journal_path)
    paged_report = arms.run(
        "replay_paged", harness.run, harness.load(paged_rec_cfg.journal_path),
        ServeConfig(**base, paged=True, page_size=page_size),
        cut_stride=0,  # agreement is the lane arm's story
        journal_path=paged_rec_cfg.journal_path)
    replay_wall_s = time.monotonic() - t0
    byte_exact = (lane_report["byte_exact_rate"] == 1.0
                  and paged_report["byte_exact_rate"] == 1.0)
    rates = [r["byte_exact_rate"] for r in (lane_report, paged_report)
             if r["byte_exact_rate"] is not None]
    headline = min(rates) if rates else 0.0
    _release_probe(probe_eng, status_hold_s)
    return {
        "metric": "serve_replay_byte_exact_rate",
        "value": round(float(headline), 4),
        "unit": ("byte-exact share of the greedy and seeded streams replayed "
                 "at the identical config, the lower of the lane and paged "
                 "pools"),
        "vs_baseline": round(float(headline), 4),
        "detail": {
            "config": _config_name(config),
            "workload": "replay",
            "n_requests": n_requests,
            "n_slots": n_slots,
            "max_new_tokens": max_new,
            "decode_block": decode_block,
            "prompt_lens": list(prompt_lens),
            "train_steps": train_steps,
            "cut_stride": cut_stride,
            "replay_byte_exact": byte_exact,
            "replay_byte_exact_rate_lane": lane_report["byte_exact_rate"],
            "replay_byte_exact_rate_paged": paged_report["byte_exact_rate"],
            "identical_agreement_rate": lane_report["agreement_rate"],
            "replay_diverged": lane_report["diverged"] + paged_report["diverged"],
            "replay_streams_compared": lane_report["streams_compared"],
            "replay_streams_skipped": len(lane_report["skipped"]),
            "replay_cut_positions": lane_report["cut_positions"],
            "replay_wall_s": round(replay_wall_s, 4),
            "journal_records": jstats["records"],
            "journal_bytes": jstats["bytes_written"],
            "journal_rotations": jstats["rotations"],
            "notes": ("the int8-KV candidate arm (replay_agreement_rate, "
                      "replay_agreement_rate_seeded, replay_agreement_rate_all, "
                      "quant_byte_exact_rate, replay_first_divergence_p50) "
                      "waits for the quantized pool, ROADMAP A5"),
            **leak_fields,
            **kv,
            **probe_fields,
            "arms": arms.log,
        },
    }


# ------------------------------------------------------------------ fleet


def _fleet_engines(model, serve_cfg, n_replicas: int, journal_dir=None,
                   stem: str = "r"):
    """`n_replicas` engines on one model (one copy of its weights), each
    with its own pool and, with `journal_dir`, its own journal."""
    import os

    engines = []
    for i in range(n_replicas):
        cfg = serve_cfg
        if journal_dir is not None:
            cfg = dataclasses.replace(
                serve_cfg, journal_path=os.path.join(journal_dir,
                                                     f"{stem}{i}.jsonl"))
        engines.append(ServeEngine(model, cfg, device=model.device))
    return engines


def _step_fleet(router) -> bool:
    """One step of every replica with work, under its loop lock; True if
    any stepped."""
    worked = False
    for r in router.replicas:
        if r.engine.has_work():
            with r.loop.lock:
                r.engine.step()
            worked = True
    return worked


def _run_fleet_arm(model, requests, serve_cfg, max_new, n_replicas,
                   params_for=None, journal_dir=None):
    """The arrival trace through a manually stepped `FleetRouter`: each
    submission goes through `router.submit` (the whole ranking), and the
    replicas step inline under their loop locks, single-threaded like
    `_run_engine_arm`, so a pairing against the bare engine isolates the
    router's own cost. Returns (router, handles, makespan)."""
    from solvingpapers_tpu_torch.serve.fleet import FleetRouter

    router = FleetRouter(_fleet_engines(model, serve_cfg, n_replicas,
                                        journal_dir), start=False)
    pending = sorted(requests, key=lambda r: r[0])
    handles = []
    t0 = time.monotonic()
    i = 0
    while i < len(pending) or any(r.engine.has_work() for r in router.replicas):
        elapsed = time.monotonic() - t0
        while i < len(pending) and pending[i][0] <= elapsed:
            _, req = router.submit(
                pending[i][1], max_new_tokens=max_new,
                params=params_for(i) if params_for is not None else None)
            assert req is not None and req.state != "rejected", \
                "the fleet arm is sized to admit everything"
            handles.append(req)
            i += 1
        if not _step_fleet(router) and i < len(pending):
            time.sleep(max(0.0, pending[i][0] - (time.monotonic() - t0)))
    makespan = (time.monotonic() - t0) - pending[0][0]
    return router, handles, makespan


def _migrated_trail_fields(handles, successors) -> dict:
    """The fleet trail's invariant on every migrated stream: the phase
    walls from the request stamps (route, then queue, prefill and decode
    on the drained replica, the migration hop, then the peer's queue,
    prefill and decode), each clamped at zero as `/v1/requests/<id>`
    clamps them, must partition the route-start to peer-finish wall.
    With the router and every engine on one clock no clamp fires and the
    error is zero; `trail_partition_err_pct` is the worst stream's."""
    worst = 0.0
    n = 0
    for h in handles:
        succ = successors.get(h.trace_id)
        if succ is None:
            continue
        n += 1
        route_s = max(getattr(h, "fleet_route_s", 0.0) or 0.0, 0.0)
        phases = [route_s]
        for r in (h, succ):
            admit = r.admit_time if r.admit_time is not None else r.submit_time
            first = (r.first_token_time if r.first_token_time is not None
                     else r.finish_time)
            phases.append(max(admit - r.submit_time, 0.0))
            phases.append(max(first - admit, 0.0))
            phases.append(max(r.finish_time - first, 0.0))
        phases.append(max(succ.submit_time - h.finish_time, 0.0))
        e2e = max(succ.finish_time - h.submit_time + route_s, 1e-9)
        worst = max(worst, abs(sum(phases) - e2e) / e2e * 100.0)
    return {"trail_partition_ok": n > 0 and worst <= 5.0,
            "trail_partition_err_pct": round(worst, 3),
            "trail_partition_streams": n}


def run_fleet_bench(
    config="llama3_shakespeare",
    n_requests: int = 32,
    n_slots: int = 8,
    max_new: int = 64,
    decode_block: int = 16,
    prompt_lens=(16, 32, 48, 64),
    mean_interarrival_s: float = 0.001,
    n_replicas: int = 2,
    seed: int = 0,
    reps: int = 4,
    journal_dir: str | None = None,
    status_port: int | None = None,
    status_hold_s: float = 0.0,
    trace_out: str | None = None,
    device=None,
) -> dict:
    """`cli serve-bench --fleet`: the fleet workload, three arms.

    * router overhead: ABBA-paired req/s of the Poisson trace through a
      ONE-replica `FleetRouter` (manually stepped, no journal) against the
      bare `_run_engine_arm` on the same engine config: the routing tax
      alone (`router_overhead_pct`).
    * fleet trace overhead: a one-replica fleet on both sides, tracing on
      against off (`fleet_trace_overhead_pct`).
    * drain migration: every request submitted up front through an
      `n_replicas`-way journaled, traced fleet (greedy and seeded
      sampling); after a third of the requests finish, replica r0 is
      drained MID-DECODE and its peers adopt its live streams; the fleet
      then drains. `migrated_token_exact` holds every migrated stream
      (prefix before the drain and suffix after the adoption) equal to an
      uninterrupted single-engine reference, `fleet_token_exact` every
      stream; `migration_wall_s` runs from the gate's close to the last
      adoption; `zero_leak` holds on the drained replica and its peers;
      the migrated trails partition their walls (`trail_partition_ok`).
      With `trace_out`, the stitched fleet trace is written there for
      `cli trace-summary --fleet`."""
    import tempfile

    from solvingpapers_tpu_torch.serve.fleet import FleetRouter

    model, vocab = build_serve_model(config, device)
    arms = _Arms(model.device)
    requests = synthetic_requests(
        n_requests, vocab, prompt_lens=prompt_lens,
        mean_interarrival_s=mean_interarrival_s, seed=seed)
    max_prompt = max(len(p) for _, p in requests)
    jdir = journal_dir or tempfile.mkdtemp(prefix="serve_fleet_bench_")
    base_cfg = ServeConfig(
        n_slots=n_slots, max_len=_page_max_len(requests, max_new),
        decode_block=decode_block, bucket=min(32, max_prompt),
        max_prefills_per_step=n_slots, max_waiting=max(256, n_requests),
        seed=seed)
    probe_fields, probe_eng = _obs_probe(model, _warm_trace(requests),
                                         base_cfg, max_new, arms=arms,
                                         status_port=status_port)
    # the reference first: the uninterrupted single-engine oracle of both
    # exactness claims, and the warm-up of every sampling shape
    upfront = [(0.0, p) for _, p in requests]
    ref_eng, ref_handles, _ = arms.run(
        "reference", _run_engine_arm, model, upfront, base_cfg, max_new,
        params_for=_journal_params_for)
    kv = _kv_entry_fields(ref_eng)
    del ref_eng

    def paired(label_a, run_a, label_b, run_b):
        mk = {label_a: [], label_b: []}
        for rep in range(reps):
            order = ((label_a, run_a), (label_b, run_b))
            for label, run in (order if rep % 2 == 0 else order[::-1]):
                out = arms.run(f"{label}[{rep}]", run)
                mk[label].append(out[-1])
                del out
        return (n_requests / np.mean(mk[label_a]),
                n_requests / np.mean(mk[label_b]))

    fleet_rps, bare_rps = paired(
        "fleet", lambda: _run_fleet_arm(model, requests, base_cfg, max_new, 1),
        "bare", lambda: _run_engine_arm(model, requests, base_cfg, max_new))
    tcfg = dataclasses.replace(base_cfg, trace=True)
    traced_rps, plain_rps = paired(
        "fleet_traced",
        lambda: _run_fleet_arm(model, requests, tcfg, max_new, 1),
        "fleet_untraced",
        lambda: _run_fleet_arm(model, requests, base_cfg, max_new, 1))

    # drain migration: a journaled, traced fleet
    router = FleetRouter(
        _fleet_engines(model, tcfg, max(2, n_replicas), jdir, "migrate_r"),
        start=False)
    arms.begin()
    t_arm = time.monotonic()
    handles = []
    for i, (_, p) in enumerate(requests):
        _, req = router.submit(p, max_new_tokens=max_new,
                               params=_journal_params_for(i))
        assert req is not None and req.state != "rejected"
        handles.append(req)
    finish_target = max(1, n_requests // 3)
    while _step_fleet(router):
        if finish_target <= sum(1 for h in handles if h.done) < n_requests:
            break
    report = router.drain("r0")
    while _step_fleet(router):
        pass
    assert all(r.done for r in report.migrated), \
        "the drain left adopted streams unfinished"
    arms.log["drain_fleet"] = {"wall_s": round(time.monotonic() - t_arm, 4),
                               **({"peak_bytes": arms.peak()}
                                  if arms.card else {})}
    oracle = {h.trace_id: r.tokens for h, r in zip(handles, ref_handles)}
    successors = {old: router.replica(peer).engine._recovered[new]
                  for old, (peer, new) in report.targets.items()}
    migrated_exact = all(successors[t].tokens == oracle[t] for t in successors)
    fleet_exact = all(
        (successors[h.trace_id].tokens if h.trace_id in successors
         else h.tokens) == oracle[h.trace_id] for h in handles)
    leak0 = _zero_leak_fields(router.replica("r0").engine)
    leak_peers = [_zero_leak_fields(r.engine) for r in router.replicas
                  if r.rid != "r0"]
    trail_fields = _migrated_trail_fields(handles, successors)
    trace_fields = {}
    if trace_out:
        router.export_chrome_fleet(trace_out)
        trace_fields["fleet_trace_out"] = trace_out
    routing = dict(router.stats)
    n_reps = len(router.replicas)
    router.close()
    del router
    _release_probe(probe_eng, status_hold_s)
    live_at_drain = report.entries
    zero_peers = all(f["zero_leak"] for f in leak_peers)
    return {
        "metric": "serve_fleet_migrated_streams",
        "value": len(report.migrated),
        "unit": (f"live streams migrated token-exactly by a mid-decode drain "
                 f"({live_at_drain} live at drain, {n_reps} replicas)"),
        "vs_baseline": (round(len(report.migrated) / live_at_drain, 4)
                        if live_at_drain else 1.0),
        "detail": {
            "config": _config_name(config),
            "workload": "fleet",
            "n_requests": n_requests,
            "n_slots": n_slots,
            "n_replicas": n_reps,
            "max_new_tokens": max_new,
            "decode_block": decode_block,
            "prompt_lens": list(prompt_lens),
            "mean_interarrival_s": mean_interarrival_s,
            "reps": reps,
            "router_overhead_pct": round((1.0 - fleet_rps / bare_rps) * 100.0,
                                         2),
            "fleet_requests_per_sec": round(float(fleet_rps), 2),
            "bare_requests_per_sec": round(float(bare_rps), 2),
            "fleet_trace_overhead_pct": round(
                (1.0 - traced_rps / plain_rps) * 100.0, 2),
            "fleet_traced_requests_per_sec": round(float(traced_rps), 2),
            "fleet_untraced_requests_per_sec": round(float(plain_rps), 2),
            "live_at_drain": live_at_drain,
            "migrated_streams": len(report.migrated),
            "migration_errors": len(report.errors),
            "migration_wall_s": round(report.wall_s, 4),
            "migrated_token_exact": migrated_exact,
            "fleet_token_exact": fleet_exact,
            "zero_leak_drained": leak0["zero_leak"],
            "zero_leak_peers": zero_peers,
            "zero_leak": leak0["zero_leak"] and zero_peers,
            "routing": routing,
            **trail_fields,
            **trace_fields,
            **kv,
            **probe_fields,
            "arms": arms.log,
        },
    }


__all__ = [
    "BENCH_SCHEMA_VERSION",
    "bench_provenance",
    "build_serve_model",
    "chaos_fault_plan",
    "poisson_serve_config",
    "run_chaos_bench",
    "run_fleet_bench",
    "run_http_bench",
    "run_journal_bench",
    "run_paged_bench",
    "run_prefix_bench",
    "run_replay_bench",
    "run_sampling_bench",
    "run_serve_bench",
    "run_slo_bench",
    "sampling_params_mix",
    "shared_prefix_requests",
    "synthetic_requests",
]
