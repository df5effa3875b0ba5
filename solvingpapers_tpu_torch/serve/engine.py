"""Continuous-batching serving engine over a lane pool or a paged pool,
with an optional radix prefix cache (port of
`solvingpapers_tpu/serve/engine.py`).

`infer.generate` is one static batch to completion. `ServeEngine`
instead advances a pool of S independent slots one iteration at a time
(Orca-style iteration-level scheduling): each `step()` admits waiting
requests into free lanes with a chunked, bucketed prefill (the same
end-aligned `attend_len` contract as `generate`, so `use_flash` models
run the flash kernel there), then advances every active slot by a block
of single-token steps, emitting per-request token streams. A slot freed
by an early EOS is re-acquired by the next queued request at once.

From the reference's `vmap` to a batch: the reference applies a batch-1
single-token forward per slot under `vmap`, so each slot's scalar write
position becomes per-slot. Here one batch-S forward runs over the whole
pool, and what `vmap` gave implicitly is written out: per-slot RoPE
positions, per-slot cache writes (clamped like `dynamic_update_slice`,
see `infer.cache.update_kv_cache`) and the per-slot ``kv_index <=
position`` decode mask. Every block runs the full `decode_block` steps;
a slot that hits EOS or its budget mid-block keeps stepping and the host
discards its overshoot (its writes stay inside its own lane, which the
next prefill overwrites). Idle slots run masked dummy steps at position 0.

A model whose layers route tokens (DeepSeek-V3's MoE, `routes_tokens`)
decodes the pool with ``row_routing=True``: under `vmap` each slot's
batch-1 forward met an expert capacity of its own, while one batch-S
dispatch would rank every slot's token, idle slots' dummies included,
against one capacity — and a request's routing would depend on its
neighbours. Per-row routing gives each slot its batch-1 routing back.
Prefill is per lane at batch 1 and keeps the reference's capacity over
the padded chunk. The model's routing biases are its buffers, so they
need no extra variables.

Prompts pad right to a multiple of `bucket` (the pad is causally
invisible to real tokens, and its cache slots are overwritten by the
decode stream before they are ever attended), and prefill runs in
`prefill_chunk` pieces (2048 automatically above 4096 tokens, as in the
reference).

Per-request sampling (`serve/sampling.py`): greedy slots (temperature 0)
take argmax and are token-exact with greedy `generate`; a seeded
stochastic slot replays its stream run to run.

Paged pool (`ServeConfig.paged`, `serve/kv_pool.py` `PagedKVPool`):
memory is booked per page, not per `max_len` lane. Each program gathers
its lanes' logical view from the page tables once, runs the same
forwards as the lane programs on it, and scatters back only the pages
it wrote. Admission follows a page budget (the scheduler's `can_admit`
gate), and a stream that runs out of pages sheds prefix-tree leaves
first, then preempts the youngest other stream, which returns to the
queue head and later re-prefills prompt + emitted tokens (greedy and
seeded streams are unchanged by that).

Prefix cache (`ServeConfig.prefix_cache`, `serve/prefix_cache.py`): an
admitted request reuses its longest cached page-aligned prompt prefix —
spliced into the lane (a device copy) on the lane pool, appended to the
page table (no copy) on the paged pool — and prefills only the
uncovered suffix from that position, end-aligned as before. Greedy
streams are token-exact with the cache on or off.

Per-request contracts (the HTTP front door, `serve/api.py`, maps onto
them): a grammar (`serve/grammar.py`, JSON mode) restricts each draw to
the stepper's allowed ids through the sampler's allow-list, which rides
the call's one control transfer; a constrained slot accepts only the
first token of a decode block (the list is stale after one advance; the
tail is discarded like post-EOS overshoot), while unconstrained slots in
the same block are unchanged. Stop token ids and stop strings are
matched on the host, across block boundaries; the matching token is
kept and the finish reason is "stop". `logprobs` requests get the chosen
token's log-softmax under the raw logits per token. Deadlines expire in
the queue and at block boundaries ("timeout"). `stream_cb(req, n_new,
finished)` fires on the engine's thread after every append and at
finish.

The durability and observability planes (see `ServeConfig`): the
supervised step boundary with its finite-logits guard, quarantine, pool
rebuild, unhealthy drain, watchdog, seeded fault injection and
degradation ladder (serve/faults.py); the write-ahead journal with
`recover()` (serve/journal.py); SLO accounting (serve/slo.py); the
flight recorder and anomaly dumps (metrics/trace.py); the rolling time
series (metrics/timeseries.py) and the status endpoint
(metrics/http.py). The finite guard and the fault row ride the control
and output copies the engine makes anyway: with the fault plane, the
journal and tracing off, a decode block makes the same host-device
copies as without the planes.

The replay harness and the fleet router ride two entry points:
`replay_submit` (serve/replay.py's shadow traffic) and `adopt`
(serve/fleet.py's drain migration), both through the preemption-resume
path `recover()` uses.

Not in this slice (kept by the reference, listed in ROADMAP.md): the
quantized pools, speculative decoding, and the compile observatory.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
import uuid
import warnings
import weakref

import numpy as np
import torch

from solvingpapers_tpu_torch.device import resolve_device
from solvingpapers_tpu_torch.metrics.profile import ProfileWindow, scope
from solvingpapers_tpu_torch.serve import metrics as smetrics
from solvingpapers_tpu_torch.serve.faults import (
    FAULT_INF,
    FAULT_NAN,
    DegradationLadder,
    FaultPlan,
    InjectedFault,
    classify_failure,
)
from solvingpapers_tpu_torch.serve.grammar import encode_allow
from solvingpapers_tpu_torch.serve.journal import Journal, JournalError
from solvingpapers_tpu_torch.serve.kv_pool import (
    TRASH_PAGE,
    KVSlotPool,
    PagedKVPool,
    extract_lane,
    gather_lane,
    gather_lanes,
    scatter_lane_pages,
    scatter_written_pages,
    scrub_lane,
    scrub_pages,
    store_lane,
)
from solvingpapers_tpu_torch.serve.metrics import ServeMetrics
from solvingpapers_tpu_torch.serve.prefix_cache import PrefixCache
from solvingpapers_tpu_torch.serve.sampling import (
    GREEDY_ROW,
    PackedSampling,
    SamplingParams,
    encode_params,
    fused_sample,
    request_generator,
)
from solvingpapers_tpu_torch.serve.scheduler import (
    ACTIVE,
    FINISHED,
    REJECTED,
    WAITING,
    FIFOScheduler,
    Request,
)
from solvingpapers_tpu_torch.serve.slo import SloTracker


def weak_method(method, dead=None):
    """`method` as a callable that does not keep its engine alive: the
    metrics' gauge provider and the scheduler's lookups would otherwise
    form a cycle with the engine, so a dropped engine's device pool would
    stay allocated until a full collection. Returns `dead` once the
    engine is gone."""
    ref = weakref.WeakMethod(method)

    def call(*args):
        bound = ref()
        return dead if bound is None else bound(*args)

    return call


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine shape/policy knobs (the reference's, without its quantized,
    speculative and compile-observatory knobs).

    `decode_block` amortizes host work: each decode call advances all
    slots `block` tokens before the host looks at the streams again.
    `bucket` quantizes prefill lengths. `sample_cap` bounds the support
    stochastic sampling draws from (requests' top_k must fit under it).
    `max_waiting`, `decode_priority`, `max_prefills_per_step` and
    `max_wait_steps` configure the scheduler; `eos_id` is the default
    per-request EOS (None = run to budget); `seed` keys sampling.

    Paged pool: `paged` serves from one physical pool of `page_budget`
    pages of `page_size` tokens plus per-slot page tables. `page_size`
    defaults to `prefix_page` (both must be equal when the prefix cache
    is on too: shared page ids need tree edges on page boundaries) and
    must divide `max_len`; `page_budget` None is the lane-pool
    equivalent, n_slots * max_len / page_size. Shrink it (or raise
    n_slots) to trade worst-case room for concurrency.

    Prefix cache: `prefix_cache` reuses cached page-aligned prompt
    prefixes of `prefix_page` tokens; `prefix_cache_bytes` caps what the
    tree may hold (LRU leaf eviction; pinned nodes never go);
    `prefix_sched` admits waiting requests shortest uncovered suffix
    first (the wait budget still overrides).

    HTTP front door (`serve/api.py`, started by `cli serve` or
    `ApiServer`, never by the engine; `cli serve` sets each of these by
    a flag): `api_port` (0 = ephemeral, published as `ApiServer.port`)
    and `api_host` (loopback by default) bind its listener;
    `api_max_connections` concurrent streams before it answers 503
    (ahead of the bounded waiting queue, which 503s the overflow after
    it); `json_mode` accepts `response_format {"type": "json_object"}`
    (grammar-constrained slots advance one token per decode block);
    `drain_timeout_s` bounds `ApiServer.close`'s wait for active streams
    before it cancels them.

    Profiler (`profile_dir`): a `torch.profiler` window over engine steps
    [`profile_steps[0]`, `profile_steps[1]`), written as a Chrome trace
    under `profile_dir` when it closes (`metrics/profile.py`), with the
    prefill and decode-block calls labelled ``serve/prefill`` and
    ``serve/decode_block``. `run()` and `close()` close a window still
    open; a caller that steps the engine itself calls `stop_profile()`.

    Flight recorder (`trace`, metrics/trace.py): per-request lifecycle
    spans (queue / prefill / decode, one track per slot, one flow per
    request), per-step composition (prefills, decode slots, control
    transfers, the programs' device-waited time), scheduler and
    prefix-cache events, in a bounded ring of `trace_capacity` events.
    Spans are stamped from the host clock readings the latency metrics
    use, taken after each program's host read (which waits for the
    device), so tracing adds no synchronisation. Export with
    `engine.trace.export_chrome(path)`; `cli trace-summary` rebuilds the
    timelines. `trace_dump_path` arms the anomaly dumper (timeout and
    cancelled finishes, `trace_reject_burst` consecutive rejections, a
    step over `trace_slow_step_factor` x the rolling median, quarantines,
    engine faults, watchdog stalls), each dump holding the last
    `trace_dump_events` events, a metrics snapshot and the time series.
    Off, the engine holds None and each hook is one branch.

    Time series (`timeseries`, metrics/timeseries.py, on by default): a
    ring of `timeseries_capacity` windows of load gauges and per-window
    counter deltas, sampled from `step()` every `timeseries_interval_s`
    (no timer thread), served as /timeseriesz and as /statusz
    sparklines. `status_port` (0 = ephemeral, published as
    `engine.status.port`; None = no server) serves /healthz /metrics
    /statusz /timeseriesz on `status_host` (metrics/http.py); `close()`
    stops it.

    SLO accounting (`slo_targets`, serve/slo.py; None = off, and then a
    request that names a class is refused): {class: {"ttft_s" / "itl_s"
    / "e2e_s": seconds, "objective": fraction}} — pass
    `serve.slo.DEFAULT_SLO_TARGETS` for the interactive / standard /
    batch tiers. Every finish is accounted under its request's
    `SamplingParams.slo` ("standard" when untagged): attainment, burn
    rate over the last `slo_burn_window` finishes, and goodput, as slo/*
    and serve/goodput_tokens[_per_s] gauges and a /statusz section.

    Fault boundary (serve/faults.py, always armed): `step()` quarantines
    a slot whose logits went non-finite (its request finishes "error",
    its lane or own pages and the trash page scrubbed to zero, every
    other stream byte-identical) and answers a systemic failure (a CUDA
    error, an out-of-memory error, anything escaping the step) with a
    pool rebuild — the old pool's references dropped before the new one
    is allocated — and a requeue, at most `fault_max_retries` times in a
    row with a backoff from `fault_retry_backoff_s`; then the engine
    drains every request "error" host-side and reports `unhealthy`
    (/healthz 503) for `fault_recover_backoff_s` (doubling per episode).
    `fault_step_deadline_s` arms a watchdog that counts steps over it.
    `fault_plan` (a sequence of `FaultSpec`s or dicts; None = off) arms
    the seeded injection plane at the reference's named sites.

    Journal (`journal_path`, serve/journal.py; None = off): submit,
    commit (once per decode block) and finish records, fsynced once per
    step, compacted at `journal_rotate_bytes` / `journal_rotate_finished`;
    an existing file is loaded and `recover()` resumes its unfinished
    requests. A journal I/O failure degrades the engine to journal-off
    with one warning, unless `journal_strict`.

    Degradation ladder (`degrade`): under page exhaustion (free pages
    below `degrade_free_page_frac` of the budget) or SLO burn (a class's
    burn rate above `degrade_burn_threshold`) the engine climbs a rung
    every `degrade_up_steps` pressured steps and steps down after
    `degrade_down_steps` clear ones: shed prefix-cache leaves, (hold
    speculation: a no-op until the port decodes speculatively), shed
    batch admissions, then standard ones. The reference's third pressure
    reason, `hbm` (the projected peak against `degrade_headroom_frac` of
    the device), reads its XLA memory ledger, which exists only under
    `xla_obs`; the port has no such ledger until ROADMAP A8, so its
    ladder has no `hbm` reason, as the reference's has none with
    `xla_obs=False`, and no `degrade_headroom_frac` until that reason
    comes.
    """

    n_slots: int = 8
    max_len: int = 512
    decode_block: int = 8
    bucket: int = 64
    prefill_chunk: int | None = None
    sample_cap: int = 64
    max_waiting: int = 256
    decode_priority: bool = True
    max_prefills_per_step: int = 1
    max_wait_steps: int = 64
    eos_id: int | None = None
    seed: int = 0
    paged: bool = False
    page_size: int | None = None
    page_budget: int | None = None
    prefix_cache: bool = False
    prefix_page: int = 16
    prefix_cache_bytes: int = 64 << 20
    prefix_sched: bool = False
    api_port: int | None = None
    api_host: str = "127.0.0.1"
    api_max_connections: int = 64
    json_mode: bool = True
    drain_timeout_s: float = 10.0
    # torch.profiler window over engine steps [start, stop)
    profile_dir: str | None = None
    profile_steps: tuple[int, int] = (10, 15)
    # SLO accounting (serve/slo.py)
    slo_targets: dict | None = None
    slo_burn_window: int = 256
    # the fault boundary and the injection plane (serve/faults.py)
    fault_plan: object | None = None
    fault_max_retries: int = 2
    fault_retry_backoff_s: float = 0.05
    fault_recover_backoff_s: float = 0.25
    fault_step_deadline_s: float | None = None
    # the write-ahead journal (serve/journal.py)
    journal_path: str | None = None
    journal_strict: bool = False
    journal_rotate_bytes: int = 4 << 20
    journal_rotate_finished: int = 256
    # the degradation ladder (serve/faults.py)
    degrade: bool = False
    degrade_up_steps: int = 2
    degrade_down_steps: int = 16
    degrade_free_page_frac: float = 0.125
    degrade_burn_threshold: float = 1.5
    # the flight recorder (metrics/trace.py)
    trace: bool = False
    trace_capacity: int = 65536
    trace_dump_path: str | None = None
    trace_dump_events: int = 256
    trace_slow_step_factor: float = 10.0
    trace_reject_burst: int = 8
    # the rolling time series (metrics/timeseries.py)
    timeseries: bool = True
    timeseries_capacity: int = 120
    timeseries_interval_s: float = 1.0
    # the status endpoint (metrics/http.py)
    status_port: int | None = None
    status_host: str = "127.0.0.1"


_UNSET = object()


def journaled_params(recorded: dict) -> SamplingParams:
    """A journal record's SamplingParams (either package's: the stop
    fields back as tuples, and the reference's `kv_exact`, a no-op on the
    port's unquantized pools, dropped); raises TypeError or ValueError
    for a record it cannot rebuild."""
    p = dict(recorded)
    p.pop("kv_exact", None)
    p["stop_token_ids"] = tuple(p.get("stop_token_ids") or ())
    p["stop"] = tuple(p.get("stop") or ())
    return SamplingParams(**p)


def _inject_fault(logits, fault):
    """The fault plane's logits poison: `fault` is the int code riding
    the packed control transfer (0 clean, FAULT_NAN / FAULT_INF poison
    the slot's whole logits row), shaped like `logits` less its vocab
    axis. The engine passes a fault only while a plan is armed, so with
    the plane off there is no row and no op."""
    mask = (fault > 0)[..., None]
    bad = torch.where(fault == FAULT_NAN, float("nan"), float("inf"))
    return torch.where(mask, bad[..., None].to(logits.dtype), logits)


def _finite_ok(logits):
    """Per-slot finite-logits guard: (the rows' flags, the logits with a
    non-finite row replaced by zeros). A flag is True iff every logit the
    sampler would draw from is finite: one reduction beside the program's
    outputs, read back in the copy the engine makes anyway (the prefill's
    first token, the decode block's tokens), never a transfer of its own.
    A poisoned row is sampled from zeros (its tokens are discarded by the
    quarantine): on NaN the sampler's top-p cutoff would index out of
    range, which on a card is a device-side assert that leaves the CUDA
    context unusable for every stream. Finite rows pass through
    unchanged."""
    ok = torch.isfinite(logits).all(dim=-1)
    return ok, torch.where(ok[..., None], logits, 0.0)


def _prefill_lane(model, padded, chunk, start, lane, prompt, length):
    """Chunked-prefill core: run `prompt` ((padded,) ids, right-padded)
    through the batch-1 `lane` from position `start`; returns the lane
    and the logits row of the LAST REAL token (index `length - 1`, taken
    from whichever chunk holds it)."""
    step = chunk or padded
    last = None
    for cs in range(0, padded, step):
        ce = min(cs + step, padded)
        positions = torch.arange(start + cs, start + ce, device=prompt.device)[None]
        logits, lane = model(prompt[None, cs:ce], positions=positions,
                             caches=lane, attend_len=start + ce)
        if cs <= length - 1 < ce:
            last = logits[0, length - 1 - cs]
    return lane, last


def _prefill_program(model, padded, chunk, start, cap, caches, prompt, slot,
                     length, packed, generator, allow=None, need_lp=False,
                     fault=None):
    """Prefill one request into lane `slot` and sample its first token
    (sample index 0 of its chain); returns the caches, the (2,) head
    [token, finite flag] (one host read gives both) and the token's
    logprob (None without `need_lp`).

    `start` is the prefix-cache match length: `prompt` is the UNCOVERED
    SUFFIX ((padded,) ids), lane positions [0, start) already hold the
    spliced prefix, and positions and `attend_len` shift by `start` (0
    is a full prefill). `allow` is the request's (1, cap) grammar
    allow-list for the first token, or None. `fault` is the fault plane's
    0-d poison code on the device, or None with the plane off."""
    lane = extract_lane(caches, slot)
    lane, last = _prefill_lane(model, padded, chunk, start, lane, prompt,
                               length)
    head, lp = _sample_first(last, cap, packed, generator, allow, need_lp,
                             fault)
    caches = store_lane(caches, lane, slot)
    return caches, head, lp


def _sample_first(last, cap, packed, generator, allow, need_lp, fault):
    """The prefill's first draw from the last real token's logits, with
    the fault poison applied first and the finite guard read beside the
    token: ((2,) [token, ok], logprob or None)."""
    if fault is not None:
        last = _inject_fault(last, fault)
    ok, last = _finite_ok(last)
    first, lp = fused_sample(last[None], packed, [generator], cap=cap,
                             allow=allow, need_lp=need_lp)
    return (torch.stack([first[0], ok.to(first.dtype)]),
            None if lp is None else lp[0])


def _paged_prefill_program(model, padded, chunk, start, cap, phys, prompt,
                           row, length, packed, generator, allow=None,
                           need_lp=False, fault=None):
    """Paged-pool prefill: `_prefill_program`'s contract over a lane
    GATHERED from the slot's page-table `row`, with only the pages the
    prefill may have written going back. On a prefix hit pages [0,
    start // page) hold shared prefix KV the gather reads; the scatter
    starts at ``start // page``, so shared pages are read, never
    written."""
    lane = gather_lane(phys, row)
    lane, last = _prefill_lane(model, padded, chunk, start, lane, prompt,
                               length)
    head, lp = _sample_first(last, cap, packed, generator, allow, need_lp,
                             fault)
    page = phys[0].max_len
    phys = scatter_lane_pages(phys, lane, row, start // page)
    return phys, head, lp


def pooled_decode_kwargs(model) -> dict:
    """Keyword arguments of a forward over the whole pool: per-row
    routing for a model that routes tokens (see the module's docstring)."""
    return {"row_routing": True} if getattr(model, "routes_tokens", False) else {}


def _decode_program(model, block, cap, caches, toks, pos, active, eos, packed,
                    generators, allow=None, need_lp=False, fault=None):
    """Advance every slot `block` tokens; inactive slots run masked.

    toks/pos/eos are (S,) int64 and active (S,) bool device tensors;
    `generators(t)` gives step t's per-slot generators (None for greedy
    slots); `allow` is the (S, cap) grammar allow-lists (all -1 =
    unconstrained; None = no constrained slot), the same at every step
    (a constrained slot keeps only the block's first token). EOS padding
    is sticky: a slot whose previous token was its EOS emits EOS again,
    as `generate` pads. `fault` is the fault plane's (S,) poison row, or
    None with the plane off.

    Returns the caches, a (block + 1, S) int64 tensor — the emitted
    tokens, then each slot's finite-logits flag over the whole block (the
    guard rides the token copy the host makes anyway) — and, with
    `need_lp`, the tokens' (block, S) logprobs (else None).
    """
    out, lps = [], []
    ok = torch.ones_like(active)
    kw = pooled_decode_kwargs(model)
    for t in range(block):
        logits, caches = model(toks[:, None], positions=pos[:, None],
                               caches=caches, **kw)
        logits = logits[:, 0]
        if fault is not None:
            logits = _inject_fault(logits, fault)
        step_ok, logits = _finite_ok(logits)
        ok = ok & step_ok
        nxt, lp = fused_sample(logits, packed, generators(t), cap=cap,
                               allow=allow, need_lp=need_lp)
        hit_eos = (eos >= 0) & (toks == eos)
        nxt = torch.where(hit_eos, eos, nxt)
        nxt = torch.where(active, nxt, toks)
        pos = torch.where(active, pos + 1, pos)
        out.append(nxt)
        lps.append(lp)
        toks = nxt
    out.append(ok.to(toks.dtype))
    return caches, torch.stack(out), torch.stack(lps) if need_lp else None


def _paged_decode_program(model, block, cap, phys, table, toks, pos, active,
                          eos, packed, generators, allow=None, need_lp=False,
                          fault=None):
    """Paged-pool decode block: `_decode_program` over the lanes gathered
    once from the (S, pages_per_lane) page `table`, then only each slot's
    write window goes back. The block writes positions [pos, pos +
    block), at most ``(block - 1) // page + 2`` pages a slot; pages
    outside a slot's window are read-only within the block (shared
    prefix pages precede the write frontier) and pages inside it are
    its own. Idle slots' tables rest at the trash page, so their masked
    dummy writes land there, as does an active slot's discarded
    overshoot past its allocation. A window clamped at the lane's end
    rewrites the last page with its own content."""
    lanes = gather_lanes(phys, table)
    lanes, out, lps = _decode_program(model, block, cap, lanes, toks, pos,
                                      active, eos, packed, generators, allow,
                                      need_lp, fault)
    page = phys[0].max_len
    limit = table.shape[1] * page - 1
    for w in range((block - 1) // page + 2):
        pos_w = torch.clamp(pos + w * page, 0, limit)
        phys = scatter_written_pages(phys, lanes, table, pos_w)
    return phys, out, lps


class ServeEngine:
    """Long-lived continuous-batching engine over one decoder model.

    >>> eng = ServeEngine(model, ServeConfig(n_slots=4))
    >>> reqs = [eng.submit(p, max_new_tokens=64) for p in prompts]
    >>> eng.run()              # step() until queue and slots drain
    >>> reqs[0].tokens         # per-request generated ids

    The model carries its own parameters (the reference passes `params`
    beside a stateless module) and must live on `device` (default
    ``cuda``; raises when there is none). `detokenize` (token ids ->
    text) is needed only by requests with stop STRINGS.

    The engine is single-threaded: one thread calls `step()` (the HTTP
    front door's `EngineLoop`), and other threads reach `submit` and
    `cancel` through that loop's lock.
    """

    def __init__(self, model, config: ServeConfig | None = None, *,
                 device: str | torch.device | None = None, detokenize=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, the engine was "
                             f"asked to serve on {self.device}")
        cfg = config or ServeConfig()
        limit = getattr(model, "max_positions", None)
        if limit is not None and cfg.max_len > limit:
            raise ValueError(
                f"max_len {cfg.max_len} exceeds the model's max positions {limit}"
            )
        for knob in ("decode_block", "bucket", "sample_cap"):
            if getattr(cfg, knob) < 1:
                raise ValueError(f"{knob} must be >= 1, got {getattr(cfg, knob)}")
        if cfg.prefill_chunk is not None and cfg.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {cfg.prefill_chunk}")
        if cfg.prefix_sched and not cfg.prefix_cache:
            raise ValueError(
                "prefix_sched orders admission by cached-prefix match "
                "length, which needs prefix_cache=True: without the radix "
                "tree the knob would silently degrade to plain FIFO"
            )
        self.model = model
        self.config = cfg
        self.detokenize = detokenize
        self.metrics = ServeMetrics()
        # flight recorder and anomaly monitor: None when tracing is off, so
        # every hook below is one `is not None` branch. The recorder shares
        # the latency metrics' clock, so trace-summary's phase sums equal
        # the measured latencies.
        self.trace = None
        self._mon = None
        # the rolling retrospective, created before the monitor so every
        # dump can carry it (lazy imports: metrics.timeseries reads this
        # package's clock)
        self.timeseries = None
        if cfg.timeseries:
            from solvingpapers_tpu_torch.metrics.timeseries import TimeSeriesStore

            self.timeseries = TimeSeriesStore(
                capacity=cfg.timeseries_capacity,
                interval_s=cfg.timeseries_interval_s, clock=smetrics.now)
        if cfg.trace:
            from solvingpapers_tpu_torch.metrics.trace import (
                AnomalyMonitor,
                FlightRecorder,
            )

            self.trace = FlightRecorder(capacity=cfg.trace_capacity,
                                        clock=smetrics.now)
            if cfg.trace_dump_path:
                self._mon = AnomalyMonitor(
                    self.trace, cfg.trace_dump_path,
                    snapshot_fn=self.metrics.snapshot,
                    last_n=cfg.trace_dump_events,
                    slow_step_factor=cfg.trace_slow_step_factor,
                    reject_burst=cfg.trace_reject_burst,
                    timeseries_fn=(self.timeseries.doc
                                   if self.timeseries is not None else None))
        elif cfg.trace_dump_path:
            raise ValueError(
                "trace_dump_path dumps the flight recorder's last events on "
                "anomalies, which needs trace=True: without the ring a dump "
                "would hold nothing"
            )
        self._paged = cfg.paged
        if cfg.paged:
            page = cfg.page_size or cfg.prefix_page
            if cfg.prefix_cache and page != cfg.prefix_page:
                raise ValueError(
                    f"page_size {page} != prefix_page {cfg.prefix_page}: "
                    "zero-copy prefix sharing appends PHYSICAL page ids to "
                    "page tables, which needs tree edges and pool pages on "
                    "one granularity (set them equal, or leave page_size "
                    "None to inherit prefix_page)"
                )
            self.metrics.add_gauge_provider(weak_method(self._page_gauges, {}))
        elif cfg.page_size is not None or cfg.page_budget is not None:
            raise ValueError(
                "page_size/page_budget configure the paged pool and need "
                "paged=True: on the lane pool they would silently do "
                "nothing"
            )
        self.pool = self._make_pool()
        self.prefix_cache = self._make_prefix_cache()
        # SLO accounting: host-side, on the finish path; its gauges ride
        # the snapshot iff slo_targets is configured
        self._slo = None
        if cfg.slo_targets is not None:
            self._slo = SloTracker(cfg.slo_targets,
                                   burn_window=cfg.slo_burn_window)
            self.metrics.add_gauge_provider(weak_method(self._slo_gauges, {}))
        # the fault boundary is always armed (a real NaN forward or device
        # error needs no opt-in); the injection plane and the ladder
        # follow the None pattern
        if cfg.fault_max_retries < 0:
            raise ValueError(
                f"fault_max_retries must be >= 0, got {cfg.fault_max_retries}")
        if (cfg.fault_step_deadline_s is not None
                and not cfg.fault_step_deadline_s > 0):
            raise ValueError(
                "fault_step_deadline_s must be > 0 (or None to disarm the "
                f"watchdog), got {cfg.fault_step_deadline_s}")
        self._faults = FaultPlan.from_config(cfg.fault_plan)
        # per-slot logits-poison row: the last row of the decode block's
        # control transfer while a plan is armed, written by the decode
        # site's pokes and cleared after the dispatch it rides
        self._fault_row = np.zeros(cfg.n_slots, np.int64)
        self._health = "healthy"
        self._consec_failures = 0
        self._failed_since: float | None = None
        self._last_error: str | None = None
        self._recover_at = 0.0
        self._backoff = cfg.fault_recover_backoff_s
        # the pool's device memory is gone (a rebuild failed: a sticky
        # CUDA error, or the allocation itself): no device work until a
        # rebuild succeeds
        self._pool_lost = False
        self._ladder = None
        if cfg.degrade:
            if not 0.0 < cfg.degrade_free_page_frac < 1.0:
                raise ValueError("degrade_free_page_frac must be in (0, 1), "
                                 f"got {cfg.degrade_free_page_frac}")
            if not cfg.degrade_burn_threshold > 0:
                raise ValueError("degrade_burn_threshold must be > 0, got "
                                 f"{cfg.degrade_burn_threshold}")
            self._ladder = DegradationLadder(up_steps=cfg.degrade_up_steps,
                                             down_steps=cfg.degrade_down_steps)
            self.metrics.add_gauge_provider(weak_method(self._ladder_gauges, {}))
        # the write-ahead journal: None-pattern off; opening an existing
        # path loads it, and `recover()` replays it
        if cfg.journal_strict and cfg.journal_path is None:
            raise ValueError(
                "journal_strict escalates journal I/O failures, which needs "
                "journal_path set: without a journal the knob would silently "
                "do nothing"
            )
        self.journal = None
        self._journal_degraded = False
        self._recovered_total = 0
        # trace_id -> recovered Request: the front door's Last-Event-ID
        # surface after a restart (rebuilt by each recover())
        self._recovered: dict[str, Request] = {}
        if cfg.journal_path is not None:
            self.journal = Journal(
                cfg.journal_path, rotate_bytes=cfg.journal_rotate_bytes,
                rotate_finished=cfg.journal_rotate_finished)
            self.metrics.add_gauge_provider(weak_method(self._journal_gauges, {}))
        self.scheduler = FIFOScheduler(
            max_waiting=cfg.max_waiting,
            decode_priority=cfg.decode_priority,
            max_prefills_per_step=cfg.max_prefills_per_step,
            max_wait_steps=cfg.max_wait_steps,
            prefer_cached=cfg.prefix_sched,
            prefix_lookup=(weak_method(self._match_len, 0)
                           if cfg.prefix_cache else None),
            can_admit=(weak_method(self._can_admit, False)
                       if cfg.paged else None),
            trace=self.trace,
        )
        self._slot_req: list[Request | None] = [None] * cfg.n_slots
        # host-side numpy mirrors of per-slot decode state, shipped to the
        # device once per decode block
        self._toks = np.zeros(cfg.n_slots, np.int64)
        self._pos = np.zeros(cfg.n_slots, np.int64)
        # slot-major SamplingParams mirrors; free lanes rest at the greedy
        # row so an idle or all-greedy batch takes the argmax-only path
        self._samp_f = np.tile(
            np.asarray(GREEDY_ROW, np.float32)[:, None], (1, cfg.n_slots)
        )
        self._top_k = np.zeros(cfg.n_slots, np.int64)
        self._seed = np.full(cfg.n_slots, -1, np.int64)
        # grammar allow-lists, slot-major (-1 = unconstrained), refreshed
        # from each constrained request's stepper before every call
        self._allow = np.full((cfg.n_slots, cfg.sample_cap), -1, np.int64)
        self._need_lp = np.zeros(cfg.n_slots, bool)
        self._rng_step = 0  # engine call counter: the unseeded chain's step word
        self._step_idx = 0  # step() calls (the /metrics staleness rider)
        self._last_emit = np.zeros(cfg.n_slots)
        # deadline-bearing requests in the waiting queue: step() scans the
        # queue for expiries only while this is nonzero
        self._waiting_deadlines = 0
        self.profile = (None if cfg.profile_dir is None else ProfileWindow(
            cfg.profile_dir, cfg.profile_steps, self.device, "serve"))
        # device-waited program seconds of the current step (tracing only)
        self._dev_s = 0.0
        # the status endpoint LAST: its handler threads read engine state,
        # which must all exist before a probe can arrive. Its providers
        # hold the engine weakly, like the gauge providers; `close()`
        # stops the server.
        self.status = None
        if cfg.status_port is not None:
            from solvingpapers_tpu_torch.metrics.http import StatusServer

            self.status = StatusServer(
                weak_method(self.statusz, {}),
                weak_method(self._prom_metrics, (0, {})),
                host=cfg.status_host, port=cfg.status_port,
                health_fn=weak_method(self._health_state, "unhealthy"),
                timeseries_fn=(self.timeseries.doc
                               if self.timeseries is not None else None))

    # ------------------------------------------------------------- submit

    def submit(self, prompt, max_new_tokens: int = 64, eos_id=_UNSET,
               params: SamplingParams | None = None,
               deadline_s: float | None = None, grammar=None,
               stream_cb=None, trace_id: str | None = None) -> Request:
        """Enqueue one request; returns its live handle immediately.

        `params` attaches per-request SamplingParams (default greedy;
        ``params.max_tokens`` overrides `max_new_tokens`). `deadline_s`
        is a relative deadline: a request still waiting or decoding
        `deadline_s` seconds after submit finishes "timeout" at the next
        iteration or block boundary. `grammar` constrains decoding (one
        `serve.grammar.JsonStepper` per request — it is stateful): every
        draw is restricted to its allowed ids and the stream finishes
        ("stop") when the grammar accepts a complete document, so a
        grammar request carries no EOS (the engine default is dropped;
        an explicit `eos_id` raises). `stream_cb(request, n_new,
        finished)` is called on the engine thread after every token
        append and at finish.

        Bad inputs raise `ValueError` here, host-side: empty, non-integer
        or non-1-D prompts, ids outside the vocabulary (a CUDA embedding
        gather out of range kills the process), budgets < 1, top_k above
        `sample_cap`, prompt + budget beyond the engine capacity,
        non-positive deadlines, stop strings without a `detokenize`
        callable, a grammar alongside an explicit eos_id, and a budget
        too small for the grammar's shortest complete document, and an
        SLO class (`params.slo`) the engine does not track. A full
        waiting queue, an unhealthy (draining) engine, or a degradation
        rung that sheds the request's SLO class returns the request
        ``rejected`` (`reject_reason` None, "unhealthy" or
        "shed:<class>").

        `trace_id` is the request's durable identity (the HTTP front door
        passes its X-Request-Id): it keys the journal record and the
        Last-Event-ID resume surface. With the journal on and no id (or
        the id of a still-live journal entry), one is minted.
        """
        arr = np.asarray(prompt)
        if arr.size < 1:
            raise ValueError("prompt must have at least one token")
        if arr.dtype.kind not in "iu":
            raise ValueError(
                f"prompt must be integer token ids, got dtype {arr.dtype}"
            )
        if arr.ndim != 1:
            raise ValueError(
                f"prompt must be 1-D (one request's token ids), got shape "
                f"{arr.shape} — batch by submitting one request per row"
            )
        vocab = self.model.cfg.vocab_size
        if arr.min() < 0 or arr.max() >= vocab:
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        prompt = arr.astype(np.int64)
        params = params or SamplingParams()
        if params.max_tokens is not None:
            max_new_tokens = params.max_tokens
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if params.stop and self.detokenize is None:
            raise ValueError(
                "params.stop (stop strings) needs the engine constructed "
                "with a `detokenize` callable (token ids -> text); "
                "stop_token_ids work without one"
            )
        if params.top_k > self.config.sample_cap:
            raise ValueError(
                f"top_k {params.top_k} exceeds ServeConfig.sample_cap "
                f"{self.config.sample_cap}"
            )
        if params.slo is not None:
            if self._slo is None:
                raise ValueError(
                    "params.slo tags the request's SLO class, which needs "
                    "ServeConfig.slo_targets configured: without the tracker "
                    "the tag would silently account to nothing"
                )
            if params.slo not in self._slo.targets:
                raise ValueError(
                    f"unknown SLO class {params.slo!r}: ServeConfig."
                    f"slo_targets defines {sorted(self._slo.targets)}"
                )
        total = prompt.size + max_new_tokens
        limit = getattr(self.model, "max_positions", None)
        cap = min(self.config.max_len, limit or self.config.max_len)
        if total > cap:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"= {total} exceeds the engine capacity {cap} "
                "(min of ServeConfig.max_len and the model's max positions)"
            )
        if grammar is not None:
            if eos_id is not _UNSET and eos_id is not None:
                raise ValueError(
                    "a grammar-constrained request cannot carry an eos_id: "
                    "EOS is only legal at a complete document, where the "
                    "grammar finishes the stream itself"
                )
            eos_id = None  # the engine default must not leak in either
            min_close = getattr(grammar, "min_close", 0)
            if max_new_tokens < min_close:
                raise ValueError(
                    f"max_new_tokens {max_new_tokens} cannot complete the "
                    f"grammar's shortest document ({min_close} tokens) — "
                    "the constrained stream would be cut mid-structure"
                )
        req = Request(
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            eos_id=self.config.eos_id if eos_id is _UNSET else eos_id,
            params=params,
            grammar=grammar,
            stream_cb=stream_cb,
        )
        req.trace_id = trace_id
        if deadline_s is not None:
            req.deadline = req.submit_time + deadline_s
        tr = self.trace
        # an unhealthy engine is draining and books no work; past its
        # backoff the next submission re-arms it
        if self._health == "unhealthy" and not (
                smetrics.now() >= self._recover_at and self._recover()):
            req.state = REJECTED
            req.reject_reason = "unhealthy"
            self.metrics.record_reject()
            if tr is not None:
                tr.instant("reject", "request", "queue", req=req.id,
                           ts=req.submit_time, reason="unhealthy")
            return req
        # the degradation ladder sheds admissions by SLO class (batch
        # first); the front door answers 503 with a jittered Retry-After
        if self._ladder is not None:
            cls = req.params.slo or "standard"
            if cls in self._ladder.shed_classes():
                req.state = REJECTED
                req.reject_reason = f"shed:{cls}"
                self.metrics.record_reject()
                self.metrics.record_shed(cls)
                if tr is not None:
                    tr.instant("shed", "engine", "queue", req=req.id,
                               ts=req.submit_time, slo=cls,
                               rung=self._ladder.rung)
                return req
        if not self.scheduler.submit(req):
            self.metrics.record_reject()
            if tr is not None:
                tr.instant("reject", "request", "queue", req=req.id,
                           ts=req.submit_time, prompt_len=prompt.size)
                if self._mon is not None:
                    self._mon.observe_reject()
            return req
        if req.deadline is not None:
            self._waiting_deadlines += 1
        # journaled AFTER acceptance: the write-ahead contract is that
        # accepted work survives
        self._journal_submit(req)
        if tr is not None:
            rid = {} if req.trace_id is None else {"rid": req.trace_id}
            tr.instant("submit", "request", "queue", req=req.id,
                       ts=req.submit_time, prompt_len=prompt.size, **rid)
            if self._mon is not None:
                self._mon.observe_accept()
        return req

    def replay_submit(self, prompt, max_new_tokens: int = 64, *,
                      eos_id=_UNSET, params: SamplingParams | None = None,
                      committed=()) -> Request:
        """Shadow-traffic submission for the replay harness
        (serve/replay.py): `submit`'s validation and admission without
        the side effects a re-serve must not have. No deadline is armed;
        no journal record is written (the engine must be journal-off:
        shadow traffic in a live journal would replay itself at the next
        recovery); the recorded `params.max_tokens` never overrides the
        harness's budget (replay budgets to the recorded stream's length,
        so comparisons stay prefix-aligned); and an SLO class this engine
        does not track is dropped, not refused (`_entry_request`'s rule).

        `committed` pre-loads recorded tokens through the
        preemption-resume path: admission re-prefills prompt +
        committed[:-1], discards the resampled token, and the next draw
        lands at sample index ``len(committed)``, so with
        ``max_new_tokens = len(committed) + 1`` the engine produces
        exactly one token, comparable with the recorded token at that
        offset (the teacher-forced cut). Raises `ValueError` for a
        rejected submission (size `max_waiting` to the corpus)."""
        if self.journal is not None:
            raise ValueError(
                "replay_submit needs a journal-off engine: shadow traffic "
                "must not write journal records (build the replay engine "
                "from serve.replay.sanitize_config)")
        params = params or SamplingParams()
        if params.max_tokens is not None:
            params = dataclasses.replace(params, max_tokens=None)
        if params.slo is not None and (
                self._slo is None or params.slo not in self._slo.targets):
            params = dataclasses.replace(params, slo=None)
        committed = [int(t) for t in committed]
        if committed and len(committed) >= max_new_tokens:
            raise ValueError(
                f"committed prefix ({len(committed)} tokens) must leave "
                f"budget to generate (max_new_tokens {max_new_tokens})")
        req = self.submit(prompt, max_new_tokens, eos_id=eos_id, params=params)
        if req.state == REJECTED:
            raise ValueError(
                f"replay submission rejected ({req.reject_reason or 'queue full'}): "
                "size the replay config's max_waiting to the corpus")
        if committed:
            # the request is queued and cannot be admitted before the
            # owner's next step(): the safe window to pre-load it
            req.tokens = committed
            if params.logprobs:
                req.logprobs = [None] * len(committed)
        return req

    def cancel(self, req: Request) -> None:
        """A WAITING request leaves the queue and finishes "cancelled" at
        once; an ACTIVE one keeps its lane until the next block boundary,
        where that block's output is discarded. Finished/rejected
        requests are a no-op."""
        if req.state == WAITING:
            if self.scheduler.remove(req):
                if req.deadline is not None:
                    self._waiting_deadlines -= 1
                self._finish_unadmitted(req, "cancelled", smetrics.now())
        elif req.state == ACTIVE:
            req.cancelled = True

    def force_drain(self, reason: str = "cancelled") -> list[Request]:
        """Finish every in-flight and queued request host-side, with no
        device work (so it cannot hang on a wedged device): the bounded
        shutdown's backstop and the unhealthy drain (`reason="error"`).
        Slots and pages return through the ordinary finish paths."""
        now = smetrics.now()
        finished: list[Request] = []
        for req in [r for r in self._slot_req if r is not None]:
            self._finish(req, reason, now)
            self._notify(req, 0)
            finished.append(req)
        for req in list(self.scheduler.queue):
            self.scheduler.remove(req)
            self._finish_unadmitted(req, reason, now)
            finished.append(req)
        self._waiting_deadlines = 0
        return finished

    def close(self, drain_s: float = 0.0) -> None:
        """Bounded shutdown: step for up to `drain_s` seconds of graceful
        drain, then `force_drain` whatever is still in flight (the front
        door's `EngineLoop.close` drains first), make the journal's last
        records durable, close the profiler window and stop the status
        endpoint. Idempotent; the engine stays usable."""
        deadline = smetrics.now() + drain_s
        while (self.has_work() and self._health != "unhealthy"
               and smetrics.now() < deadline):
            self.step()
        if self.has_work():
            self.force_drain("cancelled")
        if self.journal is not None and self.journal.dirty:
            self._journal_op(self.journal.sync)
        self.stop_profile()
        if self.status is not None:
            self.status.close()
            self.status = None

    def stop_profile(self) -> None:
        """Close a still-open profiler window and write its trace
        (callers that step the engine themselves and stop before
        `profile_steps[1]`)."""
        if self.profile is not None:
            self.profile.close()

    def statusz(self) -> dict:
        """The /statusz document from host-side mirrors only: the engine's
        shape and queue, every slot's request and position, the metrics
        snapshot, the health state machine, and (present iff enabled) the
        journal, the page pool, the SLO classes, the prefix cache and the
        time series' sparklines."""
        pool = self.pool
        d = {
            "engine": {
                "n_slots": self.config.n_slots,
                "n_free": pool.n_free,
                "occupancy": pool.occupancy,
                "queue_depth": len(self.scheduler),
                "step": self._step_idx,
                "max_len": self.config.max_len,
                "decode_block": self.config.decode_block,
            },
            "slots": [
                {"slot": i, "req": None if r is None else r.id,
                 "position": int(pool.positions[i])}
                for i, r in enumerate(self._slot_req)
            ],
            "metrics": self.metrics.snapshot(),
        }
        m = self.metrics
        d["health"] = {
            "state": self.health,
            "consecutive_failures": self._consec_failures,
            "last_error": self._last_error,
            "quarantines": m.quarantines,
            "retries": m.engine_retries,
            "unhealthy_episodes": m.engine_unhealthy,
            "watchdog_stalls": m.watchdog_stalls,
        }
        if self._faults is not None:
            d["health"]["fault_plan"] = self._faults.stats()
        if self._ladder is not None:
            d["health"]["ladder"] = self._ladder.stats()
        if self.journal is not None:
            d["journal"] = {
                **self.journal.stats(),
                "strict": self.config.journal_strict,
                "degraded": self._journal_degraded,
                "recovered_requests": self._recovered_total,
            }
        if self._paged:
            d["kv_pages"] = {
                "page_size": pool.page_size,
                "page_budget": pool.page_budget,
                "pages_free": pool.pages_free,
                "pages_active": pool.pages_active,
                "fragmentation": pool.fragmentation,
                "per_slot_pages": pool.n_alloc.tolist(),
            }
        if self._slo is not None:
            d["slo"] = self._slo.statusz()
        if self.prefix_cache is not None:
            d["prefix_cache"] = {
                "bytes_held": self.prefix_cache.bytes_held,
                "evictions": self.prefix_cache.evictions,
            }
        if self.timeseries is not None and len(self.timeseries):
            # the human rendering of the retrospective (right edge = now);
            # the raw rows are /timeseriesz
            d["timeseries"] = {
                "interval_s": self.timeseries.interval_s,
                "windows": len(self.timeseries),
                "sparklines": self.timeseries.sparklines(),
            }
        return d

    def _prom_metrics(self) -> tuple[int, dict]:
        """(step, metric set) of the status endpoint's /metrics."""
        return self._step_idx, self.metrics.prom_snapshot()

    # --------------------------------------------------------------- step

    def has_work(self) -> bool:
        return bool(len(self.scheduler)) or self.pool.n_active > 0

    @torch.no_grad()
    def step(self) -> list[Request]:
        """One engine iteration: admit + prefill, then one decode block.
        Returns the requests that FINISHED this iteration.

        Supervised (the fault boundary): an exception escaping the
        iteration — a CUDA error, an out-of-memory error, an injected
        fault — is classified (`serve.faults.classify_failure`) and
        answered with a pool rebuild and a requeue (active streams resume
        by recompute, token-exactly: the preemption argument); after
        `fault_max_retries` consecutive failures the engine drains to
        `unhealthy` (every request finishes "error", /healthz answers
        503) and re-arms after a backoff. Non-finite logits never raise:
        the guard pins them to a slot, which `_quarantine` contains. The
        watchdog counts steps over `fault_step_deadline_s`; the ladder,
        when armed, re-evaluates its signals after every step; the time
        series samples when its interval has passed.
        """
        if self._health == "unhealthy":
            now = smetrics.now()
            if now < self._recover_at or not self._recover():
                # draining: no device work until the backoff elapses (a
                # tight external drive loop must not busy-spin)
                time.sleep(max(0.0, min(0.005, self._recover_at - now)))
                self._step_idx += 1
                self._timeseries_tick()
                return []
        t0 = smetrics.now()
        try:
            if self._pool_lost:
                raise RuntimeError("the KV pool's device memory was lost in "
                                   "a failed rebuild")
            finished = self._step_inner()
        except Exception as exc:  # noqa: BLE001 — the fault boundary
            # no watchdog check here: the boundary's own rebuild and
            # backoff are not a wedged step, and the failure is counted
            finished = self._systemic_failure(exc)
        else:
            ddl = self.config.fault_step_deadline_s
            if ddl is not None:
                dur = smetrics.now() - t0
                if dur > ddl:
                    self._watchdog_fire(dur)
            if self._failed_since is not None:
                self._note_recovery()  # the first clean step of an episode
        if self._ladder is not None:
            self._ladder_step()
        self._timeseries_tick()
        return finished

    def _timeseries_tick(self) -> None:
        """Sample one window of load gauges and per-window counter deltas
        once `timeseries_interval_s` has passed. It rides `step()` (no
        timer thread), so an idle engine stops producing windows: the gap
        in the ring is the record of the idle stretch."""
        ts = self.timeseries
        if ts is None or not ts.due():
            return
        snap = self.metrics.snapshot()
        pool = self.pool
        gauges = {
            "occupancy": round(pool.occupancy, 4),
            "queue_depth": float(len(self.scheduler)),
            "n_free": float(pool.n_free),
        }
        if self._paged:
            gauges["pages_free"] = float(pool.pages_free)
        cumulative = {k: float(snap[k]) for k in (
            "serve/tokens_out", "serve/tokens_prefilled",
            "serve/requests_finished", "serve/requests_rejected",
            "serve/steps") if k in snap}
        # count and sum increments a window: a windowed mean latency
        # without percentiles
        for name, h in self.metrics._latencies():
            cumulative[f"serve/{name}_count"] = float(len(h))
            cumulative[f"serve/{name}_sum"] = float(h.sum)
        ts.sample(gauges, cumulative)

    def _step_inner(self) -> list[Request]:
        if self.profile is not None and not self.profile.done:
            self.profile.tick(self._step_idx)
        tr = self.trace
        t_step = smetrics.now() if tr is not None else 0.0
        finished: list[Request] = []
        now = smetrics.now()
        if self._waiting_deadlines > 0:
            expired = [r for r in self.scheduler.queue
                       if r.deadline is not None and now >= r.deadline]
            for req in expired:
                self.scheduler.remove(req)
                self._waiting_deadlines -= 1
                self._finish_unadmitted(req, "timeout", now)
                finished.append(req)
        if self._paged:
            self._unblock_head()
        picked = self.scheduler.pick(self.pool.n_free, self.pool.n_active)
        at = -1
        try:
            for at, req in enumerate(picked):
                if req.deadline is not None:
                    self._waiting_deadlines -= 1  # left the queue via pick
                if self._admit(req):
                    finished.append(req)  # prefill-only finish (eos/budget 1)
        except BaseException:
            # `pick` already popped this batch: put the not-yet-admitted
            # tail back at the head, in order, before the error propagates
            # (the tail never reached its deadline decrement above; the
            # request being admitted is in `_slot_req`, where the fault
            # boundary's rebuild finds it)
            for r in reversed(picked[at + 1:]):
                self.scheduler.requeue_front(r)
            raise
        n_admitted = len(picked)
        decode_slots = self.pool.n_active
        if decode_slots > 0:
            finished.extend(self._decode_block())
        self.scheduler.tick()
        self.metrics.record_step(self.pool.occupancy)
        # only steps that did work are traced and monitored: idle polls
        # would spam the ring and collapse the monitor's rolling median
        if tr is not None and (n_admitted or decode_slots or finished):
            now = smetrics.now()
            dur = now - t_step
            tr.complete(
                "step", "engine", "engine", ts=t_step, dur=dur,
                prefills=n_admitted, decode_slots=decode_slots,
                # host->device control transfers: the ids + the sampling
                # floats + top_k of each prefill, the packed state + the
                # sampling floats + top_k of a decode block
                transfers=3 * n_admitted + (3 if decode_slots else 0),
                device_s=round(self._dev_s, 6),
            )
            tr.counter("queue_depth", "engine", "engine", ts=now,
                       depth=len(self.scheduler))
            tr.counter("active_slots", "engine", "engine", ts=now,
                       active=self.pool.n_active)
            self._dev_s = 0.0
            if self._mon is not None and (n_admitted or decode_slots):
                self._mon.observe_step(dur)
        # the journal's batched durability point: ONE fsync a step over
        # every record the step appended (gated on dirty, so idle polls
        # never poke the fault plane's journal site)
        if self.journal is not None and self.journal.dirty:
            self._journal_op(self.journal.sync)
        self._step_idx += 1
        return finished

    def run(self, max_steps: int | None = None) -> None:
        """Drive step() until queue and slots drain (or `max_steps`)."""
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return
        self.stop_profile()

    # ------------------------------------------------- fault boundary

    @property
    def health(self) -> str:
        """The /healthz state machine: "healthy", "degraded" (a ladder
        rung > 0: still serving, a load balancer keeps it) or
        "unhealthy" (draining after persistent failures; /healthz answers
        503). It reports readiness: once the recovery backoff elapses the
        engine is ready again (the next submission or step re-arms it),
        so /healthz returns to 200 then."""
        if self._health == "unhealthy" and smetrics.now() < self._recover_at:
            return "unhealthy"
        if self._ladder is not None and self._ladder.rung > 0:
            return "degraded"
        return "healthy"

    def _health_state(self) -> str:
        return self.health

    @property
    def degradation_rung(self) -> int:
        """The ladder's rung (0 = normal, and 0 with the ladder off)."""
        return self._ladder.rung if self._ladder is not None else 0

    def _poke_site(self, site: str) -> int:
        """The fault plane's hook at a named site (one branch when it is
        off): ``stall`` sleeps here, ``xla_error`` / ``oom`` / ``io_error``
        raise an `InjectedFault` the boundary classifies like the real
        thing, and logits poison is returned as the prefill's code or
        written to the decode block's fault row."""
        if self._faults is None:
            return 0
        code = 0
        for spec in self._faults.poke(site):
            self.metrics.record_fault_injected()
            if self.trace is not None:
                self.trace.instant("fault_injected", "engine", "engine",
                                   site=site, kind=spec.kind, slot=spec.slot)
            if spec.kind == "stall":
                time.sleep(spec.stall_s)
            elif spec.kind in ("xla_error", "oom", "io_error"):
                raise InjectedFault(spec.kind, site)
            elif spec.kind in ("nan", "inf"):
                k = FAULT_NAN if spec.kind == "nan" else FAULT_INF
                if site == "prefill":
                    code = k
                else:
                    self._fault_row[spec.slot % self.config.n_slots] = k
            # socket_reset belongs to the front door's sse_write site
        return code

    def _systemic_failure(self, exc: Exception) -> list[Request]:
        """A step escaped with `exc`: rebuild the pool and requeue (the
        step's device outcome is unknown), at most `fault_max_retries`
        times in a row, then drain to `unhealthy`. A rebuild that raises
        (a sticky CUDA error leaves the context unusable) counts as one
        more failure, so the loop ends within the retry budget."""
        # the traceback's frames hold the failed program's tensors (a
        # gathered lane view is a pool's worth): free them before the
        # rebuild allocates
        traceback.clear_frames(exc.__traceback__)
        while True:
            kind = classify_failure(exc)
            err = f"{type(exc).__name__}: {exc}"
            exc = None
            now = smetrics.now()
            self._consec_failures += 1
            self._last_error = err
            if self._failed_since is None:
                self._failed_since = now
            if self._consec_failures <= self.config.fault_max_retries:
                # counted when a retry is granted; the failure that
                # exhausts the budget is the unhealthy transition below
                self.metrics.record_engine_retry()
            if self.trace is not None:
                self.trace.instant("engine_fault", "engine", "engine", ts=now,
                                   kind=kind, error=err[:200],
                                   failures=self._consec_failures)
                if self._mon is not None:
                    self._mon.dump("engine_fault", failure_kind=kind,
                                   error=err[:500],
                                   consecutive=self._consec_failures)
            if self._consec_failures > self.config.fault_max_retries:
                return self._go_unhealthy(err)
            try:
                self._rebuild_pool(requeue=True)
            except Exception as again:  # noqa: BLE001 — counted above
                traceback.clear_frames(again.__traceback__)
                exc = again
            time.sleep(min(self.config.fault_retry_backoff_s
                           * 2 ** (self._consec_failures - 1), 2.0))
            if exc is None:
                return []

    def _go_unhealthy(self, err: str) -> list[Request]:
        """Retries exhausted: every in-flight and queued request finishes
        "error" host-side (each client gets its terminal event; slots and
        pages reclaim leak-free), the pool is rebuilt so recovery starts
        from fresh buffers (a failed rebuild is retried at recovery), and
        /healthz reports 503 until the backoff elapses."""
        self._health = "unhealthy"
        now = smetrics.now()
        self._recover_at = now + self._backoff
        # doubles across consecutive unhealthy episodes; a clean step
        # resets it (`_note_recovery`)
        self._backoff = min(self._backoff * 2, 30.0)
        self.metrics.record_engine_unhealthy()
        if self.trace is not None:
            self.trace.instant("unhealthy", "engine", "engine", ts=now,
                               error=err[:200],
                               recover_after_s=round(self._recover_at - now, 3))
        finished = self.force_drain("error")
        try:
            self._rebuild_pool(requeue=False)
        except Exception as exc:  # noqa: BLE001 — `_recover` retries it
            traceback.clear_frames(exc.__traceback__)
        return finished

    def _recover(self) -> bool:
        """Re-arm an unhealthy engine: rebuild the pool if its last
        rebuild failed, else a host-side state flip. False (and another
        unhealthy episode, with a doubled backoff) when the rebuild fails
        again."""
        if self._pool_lost:
            try:
                self._rebuild_pool(requeue=False)
            except Exception as exc:  # noqa: BLE001 — still unusable
                traceback.clear_frames(exc.__traceback__)
                self._go_unhealthy(f"{type(exc).__name__}: {exc}")
                return False
        self._health = "healthy"
        self._consec_failures = 0
        if self.trace is not None:
            self.trace.instant("recovered", "engine", "engine",
                               ts=smetrics.now())
        return True

    def _note_recovery(self) -> None:
        """The first clean step after a failure episode: stamp the
        recovery time (first failure -> first clean step)."""
        now = smetrics.now()
        if self._failed_since is not None:
            self.metrics.record_recovery(now - self._failed_since)
            if self.trace is not None:
                self.trace.instant(
                    "fault_recovered", "engine", "engine", ts=now,
                    recovery_s=round(now - self._failed_since, 4))
        self._failed_since = None
        self._consec_failures = 0
        self._backoff = self.config.fault_recover_backoff_s

    def _make_pool(self):
        cfg = self.config
        if self._paged:
            return PagedKVPool(self.model, cfg.n_slots, cfg.max_len,
                               cfg.page_size or cfg.prefix_page,
                               page_budget=cfg.page_budget)
        return KVSlotPool(self.model, cfg.n_slots, cfg.max_len)

    def _make_prefix_cache(self):
        cfg = self.config
        if not cfg.prefix_cache:
            return None
        return PrefixCache(page=cfg.prefix_page, max_bytes=cfg.prefix_cache_bytes,
                           pool=self.pool if self._paged else None,
                           trace=self.trace)

    def _rebuild_pool(self, requeue: bool) -> None:
        """Replace the pool after a systemic failure (the failed step may
        have written part of a block into it). With `requeue`, every
        active stream returns to the queue head, oldest first, and
        resumes by recompute, token-exactly (the preemption argument).
        The prefix cache is dropped whole (its lane segments or page ids
        belong to the old pool).

        Every reference to the old pool's device memory is dropped BEFORE
        the new pool is allocated — the pool, the tree (lane segments;
        the paged tree holds page ids into the pool), the gathered lanes
        (cleared from the failure's traceback by the caller), the gauge
        providers (weak) — so after a real out-of-memory error the peak
        does not rise by a second pool. If the allocation raises (a
        sticky CUDA error, or memory still short), the engine keeps the
        old pool's host bookkeeping, reset, without its device memory,
        and refuses device work until a rebuild succeeds."""
        cfg = self.config
        if requeue:
            active = [r for r in self._slot_req if r is not None]
            active.sort(key=lambda r: r.admit_time or 0.0, reverse=True)
            for req in active:  # youngest first: the oldest ends at the head
                if self._paged and req.slot is not None:
                    req.pages_held = max(req.pages_held,
                                         int(self.pool.n_alloc[req.slot]))
                req.slot = None
                self._requeue(req)
        self._slot_req = [None] * cfg.n_slots
        self._toks[:] = 0
        self._pos[:] = 0
        self._samp_f[:] = np.asarray(GREEDY_ROW, np.float32)[:, None]
        self._allow[:] = -1
        self._top_k[:] = 0
        self._seed[:] = -1
        self._need_lp[:] = False
        self._fault_row[:] = 0
        old = self.pool
        self.prefix_cache = None
        # the old pool object keeps only host bookkeeping from here on
        if self._paged:
            old.phys = None
        else:
            old.caches = None
        self.pool = None
        try:
            self.pool = self._make_pool()
        except BaseException:
            for slot in range(old.n_slots):
                if not old._free_mask[slot]:
                    old.release(slot)
            self.pool = old
            self._pool_lost = True
            raise
        self._pool_lost = False
        del old
        self.prefix_cache = self._make_prefix_cache()
        if self.prefix_cache is not None:
            self.metrics.record_prefix_state(0, self.prefix_cache.evictions)

    def _watchdog_fire(self, dur_s: float) -> None:
        """A step exceeded the absolute deadline: count it, stamp a trace
        instant and (with the dumper armed) dump the recorder's tail."""
        self.metrics.record_watchdog_stall(dur_s)
        if self.trace is not None:
            ddl = self.config.fault_step_deadline_s
            self.trace.instant("watchdog_stall", "engine", "engine",
                               step_s=round(dur_s, 4), deadline_s=ddl)
            if self._mon is not None:
                self._mon.dump("watchdog_stall", step_s=round(dur_s, 4),
                               deadline_s=ddl)

    def _quarantine(self, req: Request, now: float) -> Request:
        """Contain a slot whose logits went non-finite: the block's tokens
        are discarded, the slot's storage is scrubbed to zero before its
        release (`_scrub_slot`), and the request finishes "error". Every
        other stream, computed from its own lane in the same call,
        continues byte-identically."""
        slot = req.slot
        self.metrics.record_quarantine()
        if self.trace is not None:
            self.trace.instant("quarantine", "engine", f"slot{slot}",
                               req=req.id, ts=now, tokens=len(req.tokens))
            if self._mon is not None:
                self._mon.dump("quarantine", req=req.id, slot=slot)
        self._scrub_slot(slot)
        self._finish(req, "error", now)
        self._notify(req, 0)
        return req

    def _scrub_slot(self, slot: int) -> None:
        """Zero a poisoned slot's device state before its storage is
        reused: masked attention gives a stale finite value probability
        0, but ``0 * NaN`` is NaN (the dense decode's ``softmax(scores) @
        v`` and a flash tile's P·V alike). The lane pool zeroes the lane;
        the paged pool zeroes the slot's own pages (refcount 1) — shared
        prefix pages hold KV written before the poisoned step and other
        holders read them — and the trash page, where the slot's masked
        overshoot lands and which every idle slot's table points at."""
        if self._paged:
            pool = self.pool
            n = int(pool.n_alloc[slot])
            own = [int(p) for p in pool.table[slot, :n] if pool.refcount[p] == 1]
            scrub_pages(pool.phys, own + [TRASH_PAGE])
        else:
            scrub_lane(self.pool.caches, slot)

    def _ladder_step(self) -> None:
        """One degradation-ladder evaluation a step: gather the pressure
        signals (pages, SLO burn; no `hbm` reason until the port has a
        memory ledger), move at most one rung, and apply the rung's
        effects: from rung 1 shed up to 4 prefix-cache leaves a step;
        rungs 3 and 4 shed admissions in `submit`."""
        cfg = self.config
        reasons = []
        if self._paged and (self.pool.pages_free
                            < cfg.degrade_free_page_frac * self.pool.page_budget):
            reasons.append("pages")
        if self._slo is not None:
            for cls in self._slo.targets:
                if self._slo.burn_rate(cls) > cfg.degrade_burn_threshold:
                    reasons.append(f"burn:{cls}")
                    break
        new = self._ladder.observe(bool(reasons), reasons)
        if new is not None:
            self.metrics.record_degrade_transition()
            if self.trace is not None:
                self.trace.instant("degrade", "engine", "engine", rung=new,
                                   name=self._ladder.name,
                                   reasons=",".join(reasons) or "clear")
        pc = self.prefix_cache
        if self._ladder.rung >= 1 and pc is not None:
            shed = 0
            while shed < 4 and pc.evict_one():
                shed += 1
            if shed:
                self.metrics.record_prefix_state(pc.bytes_held, pc.evictions)

    def _slo_gauges(self) -> dict[str, float]:
        return self._slo.gauges(self.metrics.elapsed_s)

    def _ladder_gauges(self) -> dict[str, float]:
        return {"serve/degradation_rung": float(self._ladder.rung)}

    # ----------------------------------------------- write-ahead journal

    def _journal_op(self, fn, *args) -> None:
        """One journal operation inside the durability-failure boundary:
        the fault plane's ``journal_write`` site pokes first (an
        ``io_error`` raises where a real disk failure would), and an I/O
        failure degrades the engine to journal-off with ONE warning and
        the serve/journal_degraded gauge, unless `journal_strict` lets it
        propagate."""
        if self.journal is None or self._journal_degraded:
            return
        try:
            self._poke_site("journal_write")
            fn(*args)
        except (JournalError, OSError, InjectedFault) as exc:
            if isinstance(exc, InjectedFault) and exc.kind != "io_error":
                raise
            if self.config.journal_strict:
                raise
            self._journal_degraded = True
            warnings.warn(
                f"write-ahead journal failed ({type(exc).__name__}: {exc}); "
                "degrading to journal-off: serving continues, crash recovery "
                "and stream resumption are LOST from here (set "
                "ServeConfig.journal_strict to fail loudly instead)",
                stacklevel=2)
            if self.trace is not None:
                self.trace.instant("journal_degraded", "engine", "engine",
                                   error=str(exc)[:200])

    def _journal_submit(self, req: Request) -> None:
        if self.journal is None:
            return
        if req.trace_id is None or self.journal.is_live(req.trace_id):
            # addressable after a restart, and a re-used live id must not
            # merge two streams' commits into one record
            req.trace_id = uuid.uuid4().hex
        # a grammar stepper is host state the journal cannot replay: the
        # request is journaled, flagged, and finished "error" at recovery
        self._journal_op(
            self.journal.append_submit, req.trace_id, req.prompt,
            req.max_new_tokens, req.eos_id, dataclasses.asdict(req.params),
            req.submit_time, req.grammar is not None,
            None if req.deadline is None
            else max(req.deadline - req.submit_time, 1e-3))

    def _journal_commit(self, req: Request, tokens) -> None:
        if self.journal is not None and len(tokens):
            self._journal_op(self.journal.append_commit, req.trace_id, tokens)

    def _journal_finish(self, req: Request) -> None:
        if self.journal is not None:
            self._journal_op(self.journal.append_finish, req.trace_id,
                             req.finish_reason or "unknown", {
                                 "prompt_tokens": int(req.prompt.size),
                                 "completion_tokens": len(req.tokens)})

    def _journal_gauges(self) -> dict[str, float]:
        s = self.journal.stats()
        return {
            "serve/journal_records": float(s["records"]),
            "serve/journal_bytes": float(s["bytes_written"]),
            "serve/journal_rotations": float(s["rotations"]),
            "serve/journal_fsync_s": s["fsync_s"],
            "serve/journal_live": float(s["live"]),
            "serve/journal_degraded": float(self._journal_degraded),
            "serve/recovered_requests": float(self._recovered_total),
        }

    def _entry_request(self, e) -> tuple[Request | None, str | None]:
        """One live journal entry as a resumable WAITING `Request` with
        its committed tokens (its deadline re-armed relative to now:
        monotonic clocks do not cross a restart), or FINISHED with its
        stop reason when the committed stream already satisfies one (the
        crash fell between the last commit and its finish record).
        ``(None, reason)`` for an entry this engine cannot resume
        token-exactly: a grammar request, unparseable params, a prompt
        beyond the capacity, stop strings without `detokenize`. An SLO
        class this engine does not track is dropped (accounting, not
        semantics), as is the reference's `kv_exact` (a no-op on an
        unquantized pool, the only pool the port has)."""
        limit = getattr(self.model, "max_positions", None)
        cap = min(self.config.max_len, limit or self.config.max_len)
        err = None
        params = None
        if e.grammar:
            err = "grammar stepper state is not journaled"
        else:
            try:
                params = journaled_params(e.params)
            except (TypeError, ValueError) as exc:
                err = f"unreplayable params: {exc}"
        if err is None:
            if len(e.prompt) < 1 or len(e.prompt) + e.max_new_tokens > cap:
                err = f"beyond this engine's capacity {cap}"
            elif params.stop and self.detokenize is None:
                err = "stop strings need a detokenize callable"
            elif params.slo is not None and (
                    self._slo is None or params.slo not in self._slo.targets):
                params = dataclasses.replace(params, slo=None)
        if err is not None:
            return None, err
        req = Request(prompt=np.asarray(e.prompt, np.int64),
                      max_new_tokens=e.max_new_tokens, eos_id=e.eos_id,
                      params=params)
        req.trace_id = e.rid
        req.tokens = [int(t) for t in e.tokens]
        if params.logprobs:
            # the journal keeps token ids only: the committed prefix's
            # logprobs are unknown (null on the wire)
            req.logprobs = [None] * len(req.tokens)
        if e.deadline_s is not None:
            req.deadline = req.submit_time + e.deadline_s
        reason = None
        if req.tokens:
            reason = self._stop_reason(req, req.tokens[-1], req.remaining)
            if (reason is None and params.stop
                    and self._stop_string_at(req, [], 0) is not None):
                # commits are written after stop-string truncation, so a
                # match here means the stream was complete at the crash
                reason = "stop"
        if reason is not None:
            req.state = FINISHED
            req.finish_reason = reason
            req.finish_time = smetrics.now()
        return req, None

    def adopt(self, entry) -> Request:
        """Adopt a live journal entry from ANOTHER replica's journal: the
        fleet router's stream-migration primitive (serve/fleet.py
        `FleetRouter.drain`). The drained replica force-finishes the
        stream "migrated"; this engine continues it through the
        preemption-resume path `recover()` uses (re-prefill prompt +
        committed tokens, discard the resampled token), token-exact for
        greedy and seeded streams in float32, in bfloat16 up to the
        near-ties `recover()` names. Call with this engine's step lock
        held (the `EngineLoop` lock): adoption touches the queue and the
        journal the engine thread owns.

        The request is journaled here (a submit and its committed prefix,
        so a crash after the migration recovers the stream on this
        engine; its journal submit re-keys `trace_id` when this journal
        already holds a live entry of that id: read the id back from the
        returned request), registered in the recovered set (so a
        Last-Event-ID reconnect resolves as after a restart) and queued
        at the FRONT (it predates everything waiting; adopt several
        newest-first so the oldest ends at the head). An entry whose
        committed stream already meets a finish condition comes back
        FINISHED, journaled through to its finish record.

        Raises `ValueError` for an entry this engine cannot resume
        token-exactly (`_entry_request`); nothing is queued then."""
        req, err = self._entry_request(entry)
        if err is not None:
            raise ValueError(
                f"journal entry {entry.rid} cannot be adopted ({err})")
        self._journal_submit(req)
        self._journal_commit(req, req.tokens)
        if req.done:
            self._journal_finish(req)
        else:
            # past max_waiting, like a preemption's requeue: the stream
            # was admitted once already, on the drained peer
            self._requeue(req)
        self._recovered[req.trace_id] = req
        self._recovered_total += 1
        if self.trace is not None:
            self.trace.instant("journal_adopt", "engine", "engine",
                               rid=req.trace_id, committed=len(req.tokens),
                               done=req.done)
        return req

    def recover(self) -> list[Request]:
        """Replay the journal's unfinished entries through the
        preemption-resume machinery: each becomes a WAITING request with
        its committed tokens; admission re-prefills prompt +
        committed[:-1], discards the resampled token and decodes on —
        token-exact against an uninterrupted run for greedy and seeded
        streams in float32 (in bfloat16, up to near-ties within bf16
        rounding: the re-prefill runs the flash forward over positions
        the first run decoded). Call once, before the first step.

        Entries that cannot resume token-exactly (`_entry_request`)
        finish "error" in the journal; an entry whose committed stream
        already satisfies a stop condition is finished with that reason.
        Returns the requests requeued (oldest first); the journal is then
        compacted to that live set."""
        if self.journal is None:
            raise ValueError("recover() replays the write-ahead journal, "
                             "which needs ServeConfig.journal_path set")
        resumed: list[Request] = []
        for e in self.journal.live_entries():
            usage = {"prompt_tokens": len(e.prompt),
                     "completion_tokens": len(e.tokens)}
            req, err = self._entry_request(e)
            if err is not None:
                warnings.warn(f"journal entry {e.rid} cannot be recovered "
                              f"({err}); finishing it \"error\"", stacklevel=2)
                self._journal_op(self.journal.append_finish, e.rid, "error",
                                 usage)
                continue
            if req.done:
                self._journal_op(self.journal.append_finish, e.rid,
                                 req.finish_reason, usage)
                continue
            resumed.append(req)
        for req in reversed(resumed):  # FIFO order survives the crash
            self._requeue(req)
        self._recovered = {r.trace_id: r for r in resumed}
        self._recovered_total = len(resumed)
        self._journal_op(self.journal.compact)
        self._journal_op(self.journal.sync)
        if self.trace is not None:
            self.trace.instant("journal_recover", "engine", "engine",
                               resumed=len(resumed))
        return resumed

    # ------------------------------------------------------------ private

    def _bucketed(self, length: int, start: int = 0) -> int:
        b = self.config.bucket
        padded = -(-length // b) * b
        limit = getattr(self.model, "max_positions", None)
        cap = min(self.config.max_len, limit or self.config.max_len) - start
        return max(length, min(padded, cap))

    def _prefill_shape(self, length: int,
                       start: int = 0) -> tuple[int, int | None]:
        """(padded length, chunk) of one prefill of `length` tokens from
        position `start`: bucketed, then cut into `prefill_chunk` pieces
        (2048 automatically above 4096 tokens, as `infer.generate` does);
        chunk None is one piece."""
        padded = self._bucketed(length, start)
        chunk = self.config.prefill_chunk
        if chunk is None and padded > 4096:
            chunk = 2048
        if chunk is not None and chunk >= padded:
            chunk = None
        return padded, chunk

    def _packed(self, cols) -> PackedSampling:
        dev = self.device
        f = torch.as_tensor(self._samp_f[:, cols], device=dev)
        return PackedSampling(temperature=f[0], top_p=f[1], min_p=f[2],
                              top_k=torch.as_tensor(self._top_k[cols], device=dev))

    def _admit(self, req: Request) -> bool:
        """Prefill `req` into a free lane; True if it finished already.

        With the prefix cache on, the longest cached page-aligned prefix
        of the prompt is reused (spliced into the lane, or its page ids
        appended to the slot's table on the paged pool), only the
        uncovered suffix is prefilled from position `matched`, and the
        prompt's page-aligned prefix then goes back to the tree (a copy,
        or page references).

        A request with tokens already emitted is a PREEMPTED one being
        resumed (paged pool): the prefill recomputes the KV of prompt +
        emitted tokens but the newest (whose KV is written when it is fed
        back), its sampled token is discarded (the stream holds it), and
        decode continues where it stopped.
        """
        slot = self.pool.acquire()
        if slot is None:
            raise RuntimeError("scheduler admitted beyond free slots")
        now = smetrics.now()
        resumed = bool(req.tokens)
        req.state = ACTIVE
        req.slot = slot
        req.admit_time = now
        self._slot_req[slot] = req
        if resumed:
            seq = np.concatenate([req.prompt,
                                  np.asarray(req.tokens[:-1], np.int64)])
        else:
            seq = req.prompt
        length = int(seq.size)
        matched = 0
        pc = self.prefix_cache
        tr = self.trace
        if pc is not None and length > 1:
            match = pc.match(seq[:length - 1])
            matched = match.length
            if matched:
                self._poke_site("prefix_splice")
                pc.pin(match)
                t_sp = smetrics.now() if tr is not None else 0.0
                offset = 0
                for node in match.nodes:
                    if self._paged:  # zero-copy: page ids into the table
                        self.pool.append_shared(slot, node.pages)
                    else:
                        self.pool.splice_prefix(slot, node.segment, offset)
                        offset += node.length
                pc.unpin(match)
                if tr is not None:
                    # the splice's copies are queued on the device, not
                    # waited for: the span is their host dispatch time
                    name = "share" if self._paged else "splice"
                    tr.complete(name, "prefix", f"slot{slot}", ts=t_sp,
                                dur=smetrics.now() - t_sp, req=req.id,
                                matched=matched, pages=matched // pc.page)
        suffix = length - matched
        padded, chunk = self._prefill_shape(suffix, matched)
        if self._paged and not self._ensure_pages(slot, matched + padded):
            # even with the tree and every other stream shed, the pool
            # cannot cover this prefill: hand the slot back, retry later
            self._slot_req[slot] = None
            self.pool.release(slot)
            req.slot = None
            self._requeue(req)
            return False
        if not resumed:
            self.metrics.record_admit(req, now)
        if pc is not None and length > 1:
            self.metrics.record_prefix_lookup(matched)
        samp_row, top_k, seed = encode_params(req.params)
        self._samp_f[:, slot] = samp_row
        self._top_k[slot] = top_k
        self._seed[slot] = seed
        self._need_lp[slot] = req.params.logprobs
        # the grammar's allow-list for the FIRST sampled token (a resumed
        # request discards that sample, but the list must be well formed)
        constrained = req.grammar is not None
        self._allow[slot] = self._grammar_allow(req) if constrained else -1
        # the fault plane's prefill site (a stall or synthetic error acts
        # here; nan / inf poison this prefill's logits through its code)
        pf_fault = self._poke_site("prefill")
        # one transfer carries the suffix ids, paged the table row, a
        # constrained request's allow-list and, while a fault plan is
        # armed, the poison code (last)
        parts = [np.zeros(padded, np.int64)]
        parts[0][:suffix] = seq[matched:]
        if self._paged:
            parts.append(self.pool.table[slot])
        if constrained:
            parts.append(self._allow[slot])
        armed = self._faults is not None
        if armed:
            parts.append(np.asarray([pf_fault], np.int64))
        ids = torch.as_tensor(np.concatenate(parts), device=self.device)
        table_end = padded + (self.pool.pages_per_lane if self._paged else 0)
        allow_end = table_end + (self.config.sample_cap if constrained else 0)
        allow = ids[None, table_end:allow_end] if constrained else None
        fault = ids[-1] if armed else None
        generator = (None if req.params.greedy else request_generator(
            self.config.seed, self._rng_step, slot, seed, 0, self.device))
        self._rng_step += 1
        args = (self.model, padded, chunk, matched, self.config.sample_cap)
        sample = (self._packed([slot]), generator, allow, req.params.logprobs,
                  fault)
        t_pf = smetrics.now() if tr is not None else 0.0
        with scope(self.profile, "serve/prefill"):
            if self._paged:
                self.pool.phys, head, logprob = _paged_prefill_program(
                    *args, self.pool.phys, ids[:padded], ids[padded:table_end],
                    suffix, *sample)
            else:
                self.pool.caches, head, logprob = _prefill_program(
                    *args, self.pool.caches, ids[:padded], slot, suffix,
                    *sample)
            # one read, the token and the finite flag together; it waits
            # for the device, so the clock readings after it are
            # device-true
            first, ok = head.tolist()
        if tr is not None:
            t_pf1 = smetrics.now()
            self._dev_s += t_pf1 - t_pf
            tr.complete("prefill_program", "engine", f"slot{slot}", ts=t_pf,
                        dur=t_pf1 - t_pf, req=req.id, padded=padded,
                        suffix=suffix, chunk=chunk or 0)
        if not ok:
            # poisoned prefill: quarantined BEFORE the prefix-cache insert
            # below, so a non-finite lane never enters the tree
            self._quarantine(req, smetrics.now())
            return True
        if pc is not None:
            # hand the prefilled span to the tree while [0, length) is
            # pristine: the slot's decode writes land at positions >=
            # length
            page = pc.page
            aligned = (length - 1) // page * page
            if aligned > matched:  # on a full hit there is nothing new
                extract = (self.pool.share_range if self._paged
                           else self.pool.extract_prefix)
                pc.insert(seq[:aligned], lambda off, n: extract(slot, off, n))
            self.metrics.record_prefix_state(pc.bytes_held, pc.evictions)
        now = smetrics.now()
        if resumed:
            # recompute complete: the sampled token is discarded and
            # decode resumes at the preempted position
            self.metrics.record_recompute_tokens(suffix)
            self._last_emit[slot] = now
            self.pool.positions[slot] = length
            self._toks[slot] = req.tokens[-1]
            self._pos[slot] = length
            if tr is not None:
                tr.instant("resume", "request", f"slot{slot}", req=req.id,
                           ts=now, recomputed=suffix, tokens=len(req.tokens))
            return False
        req.first_token_time = now
        req.tokens.append(first)
        if req.grammar is not None:
            req.grammar.advance(first)
        if req.params.logprobs:
            req.logprobs.append(float(logprob))
        # the first token is a one-token commit at the admission boundary
        self._journal_commit(req, (first,))
        self.metrics.record_first_token(req, now, prefilled=suffix)
        if tr is not None:
            # lifecycle spans from the request's own timestamps: queue +
            # prefill partition TTFT exactly
            tr.complete("queue", "request", "queue", ts=req.submit_time,
                        dur=req.admit_time - req.submit_time, req=req.id)
            tr.complete("prefill", "request", f"slot{slot}",
                        ts=req.admit_time, dur=now - req.admit_time,
                        req=req.id, prefilled=suffix, matched=matched)
        self._last_emit[slot] = now
        self.pool.positions[slot] = length
        self._toks[slot] = first
        self._pos[slot] = length
        reason = self._stop_reason(req, first, req.remaining)
        if req.grammar is not None and req.grammar.done:
            reason = "stop"  # a complete document beats a length finish
        if reason != "eos" and self._stop_string_at(req, [], 0) is not None:
            reason = "stop"  # the first token alone completed a match
        if reason is not None:
            self._finish(req, reason, now)
        self._notify(req, 1)
        return reason is not None

    def _stop_reason(self, req: Request, tok: int,
                     remaining: int) -> str | None:
        """Why token `tok`, after which `remaining` tokens of the budget
        are left, ends `req`'s stream — "eos", "stop" (stop token-id
        set), "length", or None. Token-level checks only; stop STRINGS
        are matched once per block by `_stop_string_at`."""
        if req.eos_id is not None and tok == req.eos_id:
            return "eos"
        if req.params.stop_token_ids and tok in req.params.stop_token_ids:
            return "stop"
        if remaining == 0:
            return "length"
        return None

    def _stop_string_at(self, req: Request, new: list[int],
                        start: int) -> int | None:
        """Earliest token index >= `start` of the stream `req.tokens +
        new` whose text completes a stop-string match, or None. One full
        decode per block (matches may span block boundaries because the
        whole generated stream is searched); the per-prefix walk that
        finds the completing token runs only on a hit, at most once in a
        request's life. A full re-decode rather than a window: a
        caller's `detokenize` need not be prefix-stable (merges can
        rewrite text at token boundaries, tokens may decode to nothing)."""
        if not req.params.stop:
            return None
        tokens = req.tokens + new
        text = self.detokenize(tokens)
        if not any(s in text for s in req.params.stop):
            return None
        for k in range(start, len(tokens)):
            prefix = self.detokenize(tokens[:k + 1])
            if any(s in prefix for s in req.params.stop):
                return k
        # the match only shows with the full stream: the last token made it
        return len(tokens) - 1

    def _notify(self, req: Request, n_new: int) -> None:
        """Fire the request's streaming hook (engine thread): `n_new`
        tokens were appended (0 at a tokenless cancel/timeout finish)."""
        cb = req.stream_cb
        if cb is not None:
            cb(req, n_new, req.state == FINISHED)

    def _grammar_allow(self, req: Request) -> np.ndarray:
        """The request's allowed-token list as a (sample_cap,) row. The
        grammar's contract is a list never empty before the document
        completes (and completion finishes the request at once), so an
        empty one is a stepper bug: fail loudly rather than decode
        unconstrained."""
        ids = req.grammar.allowed(req.remaining)
        if not ids:
            raise RuntimeError(
                f"grammar for request {req.id} returned an empty allow-list "
                f"mid-generation (budget {req.remaining})"
            )
        return encode_allow(ids, self.config.sample_cap).astype(np.int64)

    def _requeue(self, req: Request) -> None:
        """Back to the head of the queue (a bailed admission or a
        preemption), its deadline counted as waiting again."""
        self.scheduler.requeue_front(req)
        if req.deadline is not None:
            self._waiting_deadlines += 1

    def _decode_block(self) -> list[Request]:
        cfg = self.config
        block, n, cap = cfg.decode_block, cfg.n_slots, cfg.sample_cap
        if self._paged:
            self._cover_decode(block)
            if self.pool.n_active == 0:
                return []  # page exhaustion preempted every stream
        samp_idx = np.zeros(n, np.int64)
        stochastic = np.zeros(n, bool)
        constrained = False
        for slot, r in enumerate(self._slot_req):
            if r is not None:
                # sample index of this block's first draw (index 0 was
                # the prefill's)
                samp_idx[slot] = len(r.tokens)
                stochastic[slot] = not r.params.greedy
                if r.grammar is not None:
                    # the stepper advanced with the last accepted token:
                    # refresh the list (only the block's FIRST draw counts)
                    self._allow[slot] = self._grammar_allow(r)
                    constrained = True
        need_lp = bool(self._need_lp.any())
        # the fault plane's decode site (a stall or synthetic error acts
        # here; nan / inf write the fault row this block carries)
        self._poke_site("decode")
        armed = self._faults is not None
        # the block's int control values go to the device in ONE transfer:
        # rows toks, pos, active, eos, then (paged) the page tables, then
        # (with a constrained slot) the allow-lists, then (with a fault
        # plan armed) the fault row
        pages = self.pool.pages_per_lane if self._paged else 0
        rows = 4 + pages + (cap if constrained else 0)
        state = np.zeros((rows + armed, n), np.int64)
        state[0] = self._toks
        state[1] = self._pos
        state[3] = -1
        for slot, r in enumerate(self._slot_req):
            if r is not None:
                state[2, slot] = 1
                if r.eos_id is not None:
                    state[3, slot] = r.eos_id
        if self._paged:
            state[4:4 + pages] = self.pool.table.T
        if constrained:
            state[4 + pages:rows] = self._allow.T
        if armed:
            state[rows] = self._fault_row
            self._fault_row[:] = 0  # one-shot: this dispatch only
        step_tag = self._rng_step
        self._rng_step += 1
        dev = self.device

        def generators(t):
            return [request_generator(cfg.seed, step_tag, s, int(self._seed[s]),
                                      int(samp_idx[s]) + t, dev)
                    if stochastic[s] else None for s in range(n)]

        t0 = smetrics.now()
        state = torch.as_tensor(state, device=dev)
        allow = state[4 + pages:rows].T if constrained else None
        ctl = (state[0], state[1], state[2].bool(), state[3],
               self._packed(slice(None)), generators, allow, need_lp,
               state[rows] if armed else None)
        with scope(self.profile, "serve/decode_block"):
            if self._paged:
                self.pool.phys, out, lps = _paged_decode_program(
                    self.model, block, cap, self.pool.phys,
                    state[4:4 + pages].T, *ctl)
            else:
                self.pool.caches, out, lps = _decode_program(
                    self.model, block, cap, self.pool.caches, *ctl)
            # the fault plane's scatter site: after the dispatch, before
            # the read where a device error would surface
            self._poke_site("scatter")
            # (block + 1, n_slots): the tokens (overshoot cut below), then
            # the per-slot finite flags
            out = out.cpu().numpy()
            lps = None if lps is None else lps.cpu().numpy()
        finite, out = out[-1], out[:-1]
        now = smetrics.now()
        self.metrics.record_decode_block(now - t0)
        tr = self.trace
        if tr is not None:
            self._dev_s += now - t0
        finished: list[Request] = []
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            if tr is not None:
                # one call advances every lane: each active slot's span
                # shares its wall time
                tr.complete("decode_block", "engine", f"slot{slot}", ts=t0,
                            dur=now - t0, req=req.id, block=block)
            if not finite[slot]:
                # the guard pinned a non-finite forward to this slot: its
                # block is garbage; every other slot's walk proceeds
                finished.append(self._quarantine(req, now))
                continue
            if req.cancelled or (req.deadline is not None
                                 and now >= req.deadline):
                # lifecycle kill at the block boundary: the block's output
                # is discarded and the lane frees for the next pick
                self._finish(req, "cancelled" if req.cancelled else "timeout",
                             now)
                finished.append(req)
                self._notify(req, 0)
                continue
            reason = None
            base = len(req.tokens)
            # the block's tokens gather here and reach `req.tokens` only
            # once the stop checks have cut them: a handler thread that
            # streams `req.tokens` never sees a token that a stop string
            # truncates. A constrained slot keeps only the block's FIRST
            # draw: its allow-list is stale after one advance, and the
            # tail is discarded like post-EOS overshoot (its stale writes
            # in the slot's own lane are overwritten before they are
            # attended)
            new, new_lps = [], []
            span = 1 if req.grammar is not None else block
            for i in range(span):
                t = int(out[i, slot])
                new.append(t)
                if req.grammar is not None:
                    req.grammar.advance(t)
                if req.params.logprobs:
                    new_lps.append(float(lps[i, slot]))
                reason = self._stop_reason(
                    req, t, req.max_new_tokens - base - len(new))
                if req.grammar is not None and req.grammar.done:
                    reason = "stop"  # a complete document ends the stream
                if reason is not None:
                    break  # the tail of the block is discarded overshoot
            k = self._stop_string_at(req, new, base)
            if k is not None:
                # a stop string completed at token k: it wins over a
                # token-level reason that fired later in the block (and
                # over "length" at the same token), truncating the rest
                last = base + len(new) - 1
                if reason is None or k < last or reason == "length":
                    del new[k + 1 - base:]
                    del new_lps[k + 1 - base:]
                    reason = "stop"
            # logprobs first: a reader that sees token i finds its logprob
            req.logprobs.extend(new_lps)
            req.tokens.extend(new)
            appended = len(new)
            # ONE commit record a request a block, from the tokens the host
            # already holds
            self._journal_commit(req, new)
            self.metrics.record_tokens(appended, now - self._last_emit[slot],
                                       now)
            self._last_emit[slot] = now
            self.pool.positions[slot] += appended
            if reason is not None:
                self._finish(req, reason, now)
                finished.append(req)
            elif req.grammar is not None:
                # the mirror advances by the ONE accepted token; the
                # device's later writes land past it and are overwritten
                self._toks[slot] = out[0, slot]
                self._pos[slot] += 1
            else:
                # mirror the device carry: the slot ran the full block
                self._toks[slot] = out[-1, slot]
                self._pos[slot] += block
            self._notify(req, appended)
        return finished

    def _finish(self, req: Request, reason: str, now: float) -> None:
        req.state = FINISHED
        req.finish_reason = reason
        req.finish_time = now
        tr = self.trace
        if req.first_token_time is None:
            # finished before its first token (quarantined or drained mid
            # admission): a zero-width prefill phase keeps the traced
            # three-span partition whole
            req.first_token_time = now
            if tr is not None:
                admit = req.admit_time or now
                tr.complete("queue", "request", "queue", ts=req.submit_time,
                            dur=admit - req.submit_time, req=req.id)
                tr.complete("prefill", "request", f"slot{req.slot}", ts=admit,
                            dur=now - admit, req=req.id)
        if self._paged:
            # streams only grow, so the count at finish is the peak
            req.pages_held = max(req.pages_held,
                                 int(self.pool.n_alloc[req.slot]))
        self._journal_finish(req)
        self.metrics.record_finish(req, now)
        if self._slo is not None:
            req.slo_result = self._slo.observe(req, now)
        if tr is not None:
            # first token -> finish; with queue + prefill, the spans
            # partition finish_time - submit_time exactly
            tr.complete("decode", "request", f"slot{req.slot}",
                        ts=req.first_token_time, dur=now - req.first_token_time,
                        req=req.id, tokens=len(req.tokens))
            tr.instant("finish", "request", f"slot{req.slot}", req=req.id,
                       ts=now, reason=reason)
            if self._mon is not None:
                self._mon.observe_finish(reason)
        self._vacate(req.slot)

    def _finish_unadmitted(self, req: Request, reason: str,
                           now: float) -> None:
        """Finish a request cancelled, timed out or drained in the waiting
        queue (never admitted, or a preempted or requeued stream waiting
        to resume)."""
        req.state = FINISHED
        req.finish_reason = reason
        req.finish_time = now
        self._journal_finish(req)
        self.metrics.record_finish(req, now)
        if self._slo is not None:
            req.slo_result = self._slo.observe(req, now)
        tr = self.trace
        if tr is not None:
            if req.first_token_time is None:
                # its whole life was queue time
                tr.complete("queue", "request", "queue", ts=req.submit_time,
                            dur=now - req.submit_time, req=req.id)
            else:
                # preempted mid-stream: queue and prefill spans exist from
                # its first admission; close it with the decode phase
                tr.complete("decode", "request", "queue",
                            ts=req.first_token_time,
                            dur=now - req.first_token_time, req=req.id,
                            tokens=len(req.tokens))
            tr.instant("finish", "request", "queue", req=req.id, ts=now,
                       reason=reason)
            if self._mon is not None:
                self._mon.observe_finish(reason)
        self._notify(req, 0)

    def _vacate(self, slot: int) -> None:
        """Free `slot` and park it at position 0 with greedy, unconstrained
        sampling rows: its masked dummy writes land in lane position 0
        (overwritten by the next prefill) or the trash page, and an
        all-greedy resting state keeps idle batches on the argmax-only
        path."""
        self._slot_req[slot] = None
        self._toks[slot] = 0
        self._pos[slot] = 0
        self._samp_f[:, slot] = GREEDY_ROW
        self._top_k[slot] = 0
        self._seed[slot] = -1
        self._allow[slot] = -1
        self._need_lp[slot] = False
        self.pool.release(slot)

    # -------------------------------------------------- prefix, pages

    def _match_len(self, prompt: np.ndarray) -> int:
        """Cached page-aligned prefix length of `prompt` (read-only: the
        scheduler's admission lookup). Capped at len - 1: the suffix
        prefill must produce at least one logits row to sample from."""
        if self.prefix_cache is None or prompt.size < 2:
            return 0
        return self.prefix_cache.peek(prompt[:prompt.size - 1])

    def _page_gauges(self) -> dict[str, float]:
        pool = self.pool
        return {
            "serve/pages_free": float(pool.pages_free),
            "serve/pages_active": float(pool.pages_active),
            "serve/page_fragmentation": float(pool.fragmentation),
        }

    def _page_need(self, req: Request) -> int:
        """Pages a waiting request needs to start: prefill coverage of its
        (resume-aware) sequence net of the cached prefix, plus one decode
        block's reservation. An ESTIMATE (the cached prefix can change
        between gate and admit, and one iteration's picks share one free
        count); `_ensure_pages`' reclaim absorbs over-admission."""
        pool = self.pool
        seq = (np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int64)])
               if req.tokens else req.prompt)
        matched = 0
        if self.prefix_cache is not None and seq.size > 1:
            matched = self.prefix_cache.peek(seq[:seq.size - 1])
        padded = self._bucketed(int(seq.size) - matched, start=matched)
        need = min(matched + padded + self.config.decode_block,
                   self.config.max_len)
        return pool.pages_for(need) - matched // pool.page_size

    def _can_admit(self, req: Request) -> bool:
        """The scheduler's gate beyond free slots: free pages must cover
        the request's prompt + a decode reservation."""
        return self.pool.pages_free >= self._page_need(req)

    def _unblock_head(self) -> None:
        """Shed prefix-tree references for a page-starved queue head
        before the scheduler picks, with the pool IDLE. Without this the
        engine can livelock: the tree's references persist after every
        stream drains, and reclaim otherwise only runs inside `_admit`
        and `_cover_decode`, which a closed gate keeps from running.
        While streams are active their own release unblocks the head."""
        pc = self.prefix_cache
        if not self.scheduler.queue or self.pool.n_active > 0 or pc is None:
            return
        head = self.scheduler.queue[0]
        shed = False
        while not self._can_admit(head) and pc.evict_one():
            shed = True
        if shed:
            self.metrics.record_prefix_state(pc.bytes_held, pc.evictions)

    def _ensure_pages(self, slot: int, n_tokens: int) -> bool:
        """Grow `slot`'s page table to cover `n_tokens`, reclaiming under
        pressure (tree leaves first, then the youngest other stream).
        False only when nothing else is left to reclaim."""
        while not self.pool.ensure(slot, n_tokens):
            if not self._reclaim_one(protect={slot}):
                return False
        return True

    def _reclaim_one(self, protect: set) -> bool:
        """Free page capacity by one unit: evict one prefix-tree leaf
        (dropping cache never hurts correctness) or, with the tree spent,
        preempt the YOUNGEST active request not in `protect` (it has the
        least sunk prefill work). False when nothing is left. A tree
        eviction may free no page (a slot still shares it): callers loop,
        and each call removes a node or a stream, so the loop ends."""
        pc = self.prefix_cache
        if pc is not None and pc.evict_one():
            self.metrics.record_prefix_state(pc.bytes_held, pc.evictions)
            return True
        victim = None
        for r in self._slot_req:
            if r is None or r.slot in protect:
                continue
            if victim is None or r.admit_time > victim.admit_time:
                victim = r
        if victim is None:
            return False
        self._preempt(victim)
        return True

    def _preempt(self, req: Request) -> None:
        """Evict an ACTIVE stream on page exhaustion, at a block boundary:
        its pages free at once (shared ones survive under the tree's
        references, often making its resume a prefix hit) and it returns
        to the HEAD of the queue, to be recomputed by `_admit`'s resume
        path when pages free up."""
        slot = req.slot
        self.metrics.record_preemption()
        req.pages_held = max(req.pages_held, int(self.pool.n_alloc[slot]))
        self._vacate(slot)
        req.slot = None
        self._requeue(req)

    def _cover_decode(self, block: int) -> None:
        """Before a decode block every surviving slot must own pages for
        its next `block` writes (overshoot past a finished stream's
        coverage lands in the trash page and is discarded, but real
        tokens' writes must be owned). Oldest streams are covered first
        and reclaim preempts youngest first, so under exhaustion the pool
        serves fewer, older streams and corrupts none."""
        active = sorted((r for r in self._slot_req if r is not None),
                        key=lambda r: r.admit_time)
        covered: set[int] = set()
        for req in active:
            if req.slot is None:
                continue  # preempted by an earlier slot's reclaim
            slot = req.slot
            covered.add(slot)
            target = min(int(self._pos[slot]) + block, self.config.max_len)
            ok = self.pool.ensure(slot, target)
            while not ok and self._reclaim_one(protect=covered):
                ok = self.pool.ensure(slot, target)
            if not ok:  # nothing reclaimable is left: this stream yields
                self._preempt(req)
                covered.discard(slot)


__all__ = ["ServeConfig", "ServeEngine"]
