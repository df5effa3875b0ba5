"""Serving benchmark on the port (port of the Poisson, shared-prefix,
paged, sampling, HTTP and SLO workloads of
`solvingpapers_tpu/serve/bench.py`, with its traced arm and status
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


__all__ = [
    "BENCH_SCHEMA_VERSION",
    "bench_provenance",
    "build_serve_model",
    "poisson_serve_config",
    "run_http_bench",
    "run_paged_bench",
    "run_prefix_bench",
    "run_sampling_bench",
    "run_serve_bench",
    "run_slo_bench",
    "sampling_params_mix",
    "shared_prefix_requests",
    "synthetic_requests",
]
