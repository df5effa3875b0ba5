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

Quantized KV storage (`ServeConfig.kv_quant`, serve/kv_pool.py
`QuantStore`): either pool holds int8 codes and f32 absmax scales. Each
program dequantizes the lanes it reads into a fresh compute-dtype view,
runs the same forwards on it, and requantizes only the blocks or pages it
wrote. A `kv_exact` request reads and writes a full-precision sidecar
lane instead, in the same calls as quantized slots, and stays
byte-identical to the unquantized engine. Every quantized branch is taken
only when the pool holds a `QuantStore`: the unquantized paths are the
same code as without the knob.

Speculative decoding (`ServeConfig.speculative`, serve/spec.py): the
decode step becomes `spec_rounds` draft-verify rounds, each one forward
over a ``1 + spec_k`` chunk a slot (the cached-decode attention with its
per-query ``kv_index <= position`` mask), the n-gram drafter's history
riding the step's one control transfer. Greedy streams stay
token-identical to spec-off serving; the lane pool's rounds write in
place (a chunk at the lane's end clamps per column, `infer.cache`), the
paged pool scatters back only each slot's device-committed window, and
the quantized pools requantize it with the rejected tail kept at its
old codes. A host-side controller drops the engine to the plain block
while drafts keep rejecting.

The MTP drafter (`speculative="mtp"`, a DeepSeek-V3 model with
`mtp_heads`, lane pool only): the rounds' chunk forward also returns the
post-norm hiddens, and the model's MTP heads (at most 2, chained as in
`infer/speculative.py`) redraft each slot's next round from them over
their own latent lanes (``max_len + k + 1`` rows a slot, one pool a
head). Admission is the heads' bootstrap: the prompt's prefill fills
the head lanes beside the main lane and returns the first round's
drafts. The drafts of the last round carry over to the next call. The
heads route each slot's tokens as a batch-1 forward would
(`row_routing`), so MoE capacity never couples two requests.

Not in this slice (kept by the reference, listed in ROADMAP.md): the
compile observatory (A8).
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
from solvingpapers_tpu_torch.infer.cache import LatentCache
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
    QuantStore,
    extract_lane,
    gather_lane,
    gather_lanes,
    quant_gather_lane,
    quant_gather_lanes,
    quant_lane_view,
    quant_lanes_view,
    quant_pool_bytes,
    quant_scatter_lane_pages,
    quant_scatter_window_pages,
    quant_scatter_written_pages,
    quant_store_exact_lanes,
    quant_store_lane,
    quant_store_written,
    scatter_lane_pages,
    scatter_window_pages,
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
    draw_keys,
    encode_params,
    fused_sample,
    request_seed,
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
from solvingpapers_tpu_torch.serve.spec import (
    DRAFTERS,
    SpecController,
    ngram_drafts,
    spec_verify,
)


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
    """Engine shape/policy knobs (the reference's, without its
    compile-observatory knobs).

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

    Quantized KV storage (serve/kv_pool.py `QuantStore`): `kv_quant`
    None keeps exact storage; "int8" holds either pool as symmetric int8
    codes with f32 absmax scales, about half the bf16 bytes (a quarter of
    float32), so about twice the slots or context in the same memory.
    Quality is measured, not exact: `cli serve-bench --kv-quant int8`
    reports the greedy agreement with the exact pool. `kv_quant_block`
    is the lane pool's scale granularity (one scale per slot, block of
    tokens and head; it must divide `max_len`, and `prefix_page` when the
    lane pool's prefix cache is on); the paged pool always scales per
    (page, head), so scales ride the page tables. The prefix cache keeps
    int8 segments or pages. `kv_exact_lanes` books that many
    full-precision sidecar lanes (and a trash lane) for requests with
    `SamplingParams.kv_exact`: they serve byte-identical to the
    unquantized engine, in the same decode blocks as quantized traffic,
    bypass the prefix cache and hold no pages; 0 books none, and then a
    kv_exact submission is refused.

    Speculative decoding (serve/spec.py): `speculative` None is off;
    "ngram" turns each decode step into `spec_rounds` (None =
    `decode_block`) draft-verify rounds: the prompt-lookup drafter
    proposes up to `spec_k` tokens a slot from its own history (tail
    n-grams up to `spec_ngram` long), one forward verifies the whole ``1
    + spec_k`` window, and each round commits 1 to ``spec_k + 1`` tokens
    a slot. Greedy streams stay token-identical to spec-off serving;
    stochastic ones keep their distribution, and a seeded stream its
    tokens. Grammar-constrained slots draft nothing and keep one token a
    step. `spec_min_rate` (accepted drafts a round; None = ``max(1,
    spec_k / 4)``) and `spec_probe_every` configure the adaptive
    controller (`SpecController`), which drops the engine to plain
    blocks while acceptance stays below the rate, probing again after a
    backoff. "mtp" drafts with a DeepSeek-V3 model's
    multi-token-prediction heads (k = min(spec_k, mtp_heads, 2)) on the
    lane pool, without the prefix cache or kv_quant (`check_drafter`).

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
    `degrade_down_steps` clear ones: shed prefix-cache leaves, hold
    speculation (the controller's `hold`), shed batch admissions, then
    standard ones. The reference's third pressure
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
    kv_quant: str | None = None
    kv_quant_block: int = 16
    kv_exact_lanes: int = 0
    speculative: str | None = None
    spec_k: int = 4
    spec_rounds: int | None = None
    spec_ngram: int = 3
    spec_min_rate: float | None = None
    spec_probe_every: int = 8
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

    def __post_init__(self):
        if self.speculative is None:
            return
        if self.speculative not in DRAFTERS:
            raise ValueError(
                f"speculative must be one of {DRAFTERS} (or None), "
                f"got {self.speculative!r}")


def check_drafter(model_cfg, cfg: ServeConfig) -> None:
    """Raise the reference's ValueError when `cfg`'s MTP drafter cannot
    serve a model of config `model_cfg`: kv_quant, no heads, the paged
    pool, the prefix cache (in the reference's order). Other drafters
    pass. The engine calls it; so do `cli serve` / `replay` and the
    door's replay, before anything is built."""
    if cfg.speculative != "mtp":
        return
    if cfg.kv_quant is not None:
        raise ValueError(
            "kv_quant with speculative='mtp' is unsupported: the MTP "
            "drafter's head-cache lanes are a latent pool of their "
            "own that the quantized store does not cover yet — use "
            "speculative='ngram' (either pool) or drop kv_quant")
    if getattr(model_cfg, "mtp_heads", 0) < 1:
        raise ValueError(
            "speculative='mtp' drafts with the model's "
            "trained multi-token-prediction heads, which "
            "this model does not have (mtp_heads == 0) — "
            "use speculative='ngram' for model-free drafting")
    if cfg.paged:
        raise ValueError(
            "speculative='mtp' serves over the lane pool: "
            "the MTP head cache is a per-slot lane pool of "
            "its own (paged main-pool support is a "
            "follow-on) — drop paged or use 'ngram'")
    if cfg.prefix_cache:
        raise ValueError(
            "speculative='mtp' cannot reuse cached prefixes: "
            "a spliced prefix carries no hidden states for "
            "the MTP head cache — drop prefix_cache or use "
            "'ngram'")


_UNSET = object()


def journaled_params(recorded: dict) -> SamplingParams:
    """A journal record's SamplingParams (either package's, the stop
    fields back as tuples; `kv_exact` is kept, so a recovered, adopted
    or replayed exact stream stays on full-precision storage); raises
    TypeError or ValueError for a record it cannot rebuild."""
    p = dict(recorded)
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


def _prefill_lane(model, padded, chunk, start, lane, prompt, length,
                  hidden=False):
    """Chunked-prefill core: run `prompt` ((padded,) ids, right-padded)
    through the batch-1 `lane` from position `start`; returns the lane
    and the logits row of the LAST REAL token (index `length - 1`, taken
    from whichever chunk holds it), and with `hidden` the (1, padded, D)
    post-norm hiddens too (the MTP heads' input)."""
    step = chunk or padded
    last = None
    hs = []
    for cs in range(0, padded, step):
        ce = min(cs + step, padded)
        positions = torch.arange(start + cs, start + ce, device=prompt.device)[None]
        logits, lane = model(prompt[None, cs:ce], positions=positions,
                             caches=lane, attend_len=start + ce,
                             **({"return_hidden": True} if hidden else {}))
        if hidden:
            logits, h = logits
            hs.append(h)
        if cs <= length - 1 < ce:
            last = logits[0, length - 1 - cs]
    if hidden:
        return lane, last, torch.cat(hs, dim=1)
    return lane, last


def _prefill_program(model, padded, chunk, start, cap, caches, prompt, slot,
                     length, packed, key, allow=None, need_lp=False,
                     fault=None, eidx=0):
    """Prefill one request into lane `slot` and sample its first token
    (sample index 0 of its chain); returns the caches, the (2,) head
    [token, finite flag] (one host read gives both) and the token's
    logprob (None without `need_lp`).

    `start` is the prefix-cache match length: `prompt` is the UNCOVERED
    SUFFIX ((padded,) ids), lane positions [0, start) already hold the
    spliced prefix, and positions and `attend_len` shift by `start` (0
    is a full prefill). `allow` is the request's (1, cap) grammar
    allow-list for the first token, or None. `fault` is the fault plane's
    0-d poison code on the device, or None with the plane off.

    Quantized pools (`caches` a `QuantStore`): the lane is dequantized out
    of the slot's codes and scale rows (a kv_exact slot, `eidx` > 0,
    reads its exact sidecar lane instead), and the store requantizes only
    the written span [start, start + padded), with the pad positions past
    the real tokens zeroed: spliced prefix blocks below `start` keep their
    producer's codes."""
    quant = isinstance(caches, QuantStore)
    lane = (quant_lane_view(caches, slot, eidx) if quant
            else extract_lane(caches, slot))
    lane, last = _prefill_lane(model, padded, chunk, start, lane, prompt,
                               length)
    head, lp = _sample_first(last, cap, packed, key, allow, need_lp,
                             fault)
    if quant:
        caches = quant_store_lane(caches, lane, slot, eidx, start,
                                  start + padded, hi=start + length)
    else:
        caches = store_lane(caches, lane, slot)
    return caches, head, lp


def _mtp_prefill_program(model, padded, chunk, cap, k, caches, mtp, prompt,
                         slot, length, packed, key, allow=None,
                         need_lp=False, fault=None):
    """MTP-engine admission: `_prefill_program`'s contract (lane pool,
    a full prefill: the MTP engine has no prefix cache, since a spliced
    prefix has no hiddens for the head lanes) plus the heads' bootstrap,
    as `infer.speculative.generate_speculative` prefills: head 1's lane
    over columns [0, padded - 1), where the next-token stream is the
    prompt (pad columns hold garbage that the rounds write over before
    any real query attends it), then its advance at column ``length -
    1`` with the first sampled token, which drafts the token after it;
    with k == 2 head 2 likewise on head 1's layer outputs. `mtp` is the
    list of head lane pools, written in place. Returns (caches, head,
    logprob, drafts (k,))."""
    from solvingpapers_tpu_torch.models.deepseekv3 import mtp_head_apply

    lane = extract_lane(caches, slot)
    lane, last, h_all = _prefill_lane(model, padded, chunk, 0, lane, prompt,
                                      length, hidden=True)
    caches = store_lane(caches, lane, slot)
    head, lp = _sample_first(last, cap, packed, key, allow, need_lp, fault)
    dev = prompt.device
    step = chunk or padded

    def cols(a, b):
        return torch.arange(a, b, device=dev)[None]

    m1 = extract_lane([mtp[0]], slot)[0]
    y1s = []
    for cs in range(0, padded - 1, step):
        ce = min(cs + step, padded - 1)
        _, y1, m1, _ = mtp_head_apply(model, h_all[:, cs:ce],
                                      prompt[None, cs + 1:ce + 1],
                                      cols(cs, ce), cache=m1, attend_len=ce)
        y1s.append(y1)
    # the bootstrap: the last real token's hidden and the sampled first
    # token draft position length + 1
    g, y1_last, m1, _ = mtp_head_apply(model, h_all[:, length - 1:length],
                                       head[None, :1],
                                       cols(length - 1, length), cache=m1)
    drafts = [torch.argmax(g[0, -1])]
    if k == 2:
        m2 = extract_lane([mtp[1]], slot)[0]
        y1_all = torch.cat(y1s, dim=1)  # (1, padded - 1, D)
        for cs in range(0, padded - 2, step):
            ce = min(cs + step, padded - 2)
            _, _, m2, _ = mtp_head_apply(model, y1_all[:, cs:ce],
                                         prompt[None, cs + 2:ce + 2],
                                         cols(cs, ce), cache=m2,
                                         attend_len=ce, head=2)
        pos_a = min(max(length - 2, 0), padded - 2)
        y_pair = torch.cat([y1_all[:, pos_a:pos_a + 1], y1_last], dim=1)
        g2, _, m2, _ = mtp_head_apply(
            model, y_pair, torch.stack([head[0], drafts[0]])[None],
            cols(pos_a, pos_a + 2), cache=m2, head=2)
        drafts.append(torch.argmax(g2[0, -1]))
    return caches, head, lp, torch.stack(drafts)


def _sample_first(last, cap, packed, key, allow, need_lp, fault):
    """The prefill's first draw from the last real token's logits, with
    the fault poison applied first and the finite guard read beside the
    token: ((2,) [token, ok], logprob or None)."""
    if fault is not None:
        last = _inject_fault(last, fault)
    ok, last = _finite_ok(last)
    first, lp = fused_sample(last[None], packed, key, cap=cap,
                             allow=allow, need_lp=need_lp)
    return (torch.stack([first[0], ok.to(first.dtype)]),
            None if lp is None else lp[0])


def _paged_prefill_program(model, padded, chunk, start, cap, phys, prompt,
                           row, length, packed, key, allow=None,
                           need_lp=False, fault=None, eidx=0):
    """Paged-pool prefill: `_prefill_program`'s contract over a lane
    GATHERED from the slot's page-table `row`, with only the pages the
    prefill may have written going back. On a prefix hit pages [0,
    start // page) hold shared prefix KV the gather reads; the scatter
    starts at ``start // page``, so shared pages are read, never
    written.

    Quantized pools: the gather dequantizes the int8 pages through their
    per-(page, head) scale rows, a kv_exact slot's view is its exact
    sidecar lane (its table rests at the trash page: exact streams own no
    pages), and the scatter requantizes only the written pages, pads
    zeroed."""
    quant = isinstance(phys, QuantStore)
    lane = (quant_gather_lane(phys, row, eidx) if quant
            else gather_lane(phys, row))
    lane, last = _prefill_lane(model, padded, chunk, start, lane, prompt,
                               length)
    head, lp = _sample_first(last, cap, packed, key, allow, need_lp,
                             fault)
    if quant:
        page = phys.q[0].max_len
        phys = quant_scatter_lane_pages(phys, lane, row, start // page, eidx,
                                        hi=start + length)
    else:
        page = phys[0].max_len
        phys = scatter_lane_pages(phys, lane, row, start // page)
    return phys, head, lp


def pooled_decode_kwargs(model) -> dict:
    """Keyword arguments of a forward over the whole pool: per-row
    routing for a model that routes tokens (see the module's docstring)."""
    return {"row_routing": True} if getattr(model, "routes_tokens", False) else {}


def _decode_program(model, block, cap, caches, toks, pos, active, eos, packed,
                    keys, allow=None, need_lp=False, fault=None,
                    eidx=None):
    """Advance every slot `block` tokens; inactive slots run masked.

    toks/pos/eos are (S,) int64 and active (S,) bool device tensors;
    `keys` is the (block, S) int64 draw keys of every step (greedy slots'
    ignored; None when no slot is stochastic); `allow` is the (S, cap)
    grammar allow-lists (all -1 = unconstrained; None = no constrained
    slot), the same at every step
    (a constrained slot keeps only the block's first token). EOS padding
    is sticky: a slot whose previous token was its EOS emits EOS again,
    as `generate` pads. `fault` is the fault plane's (S,) poison row, or
    None with the plane off.

    Returns the caches, a (block + 1, S) int64 tensor — the emitted
    tokens, then each slot's finite-logits flag over the whole block (the
    guard rides the token copy the host makes anyway) — and, with
    `need_lp`, the tokens' (block, S) logprobs (else None).

    Quantized pools: the block runs on the DEQUANTIZED (S, max_len, ...)
    view of the whole pool (kv_exact slots, by `eidx` the host's per-slot
    exact-lane row, on their exact lanes), so reads within the block are
    full precision and quantization happens at the block boundary: the
    store requantizes only the blocks each slot's write window [pos, pos
    + block) touched.
    """
    if isinstance(caches, QuantStore):
        lanes, out, lps = _decode_program(
            model, block, cap, quant_lanes_view(caches, eidx), toks, pos,
            active, eos, packed, keys, allow, need_lp, fault)
        return quant_store_written(caches, lanes, pos, block, eidx), out, lps
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
        nxt, lp = fused_sample(logits, packed, None if keys is None else keys[t],
                               cap=cap,
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
                          eos, packed, keys, allow=None, need_lp=False,
                          fault=None, eidx=None):
    """Paged-pool decode block: `_decode_program` over the lanes gathered
    once from the (S, pages_per_lane) page `table`, then only each slot's
    write window goes back. The block writes positions [pos, pos +
    block), at most ``(block - 1) // page + 2`` pages a slot; pages
    outside a slot's window are read-only within the block (shared
    prefix pages precede the write frontier) and pages inside it are
    its own. Idle slots' tables rest at the trash page, so their masked
    dummy writes land there, as does an active slot's discarded
    overshoot past its allocation. A window clamped at the lane's end
    rewrites the last page with its own content.

    Quantized pools: the gather dequantizes (kv_exact slots read their
    exact lanes), only [pos, pos + block) of each touched page takes the
    block's values while the rest re-encodes from its own f32 codes, and
    the kv_exact slots' lanes go back to their exact lanes."""
    quant = isinstance(phys, QuantStore)
    lanes = (quant_gather_lanes(phys, table, eidx) if quant
             else gather_lanes(phys, table))
    lanes, out, lps = _decode_program(model, block, cap, lanes, toks, pos,
                                      active, eos, packed, keys, allow,
                                      need_lp, fault)
    page = (phys.q if quant else phys)[0].max_len
    limit = table.shape[1] * page - 1
    for w in range((block - 1) // page + 2):
        pos_w = torch.clamp(pos + w * page, 0, limit)
        if quant:
            phys = quant_scatter_written_pages(phys, lanes, table, pos_w,
                                               lo=pos, hi=pos + block)
        else:
            phys = scatter_written_pages(phys, lanes, table, pos_w)
    if quant:
        phys = quant_store_exact_lanes(phys, lanes, eidx)
    return phys, out, lps


def _spec_rounds(model, k, rounds, cap, max_len, nmax, lanes, toks, pos,
                 active, spec_ok, hist, hlen, packed, keys, allow=None,
                 need_lp=False, fault=None, mtp=None):
    """The draft-verify rounds both speculative programs share, so the
    commit semantics cannot drift between pools (the reference's
    `_spec_rounds_scan`, its scan a Python loop over batched tensors).

    Each round: `ngram_drafts` proposes up to `k` tokens per slot from
    the (S, H) history `hist` (`hlen` live), slots with a zero gate
    (`spec_ok`: grammar-constrained and idle slots) propose none; ONE
    forward over the (S, 1 + k) chunk at positions ``min(p + [0, k],
    max_len - 1)`` (the cached-decode branch: per-query ``kv_index <=
    position`` masking makes the chunk causal, and the KV written for
    rejected drafts is overwritten by the next round's chunk before
    anything attends it); the fault row and the finite guard; then
    `spec_verify`, with each slot's draw keys (`keys`, (S, rounds x (k +
    1)) from the call's first sample index, or None with no stochastic
    slot) gathered at its running commit count. `commits` are zeroed on
    inactive slots; tokens, positions, history and the count advance by
    the committed number. A slot's position freezes at ``max_len - 1`` once its stream overshoots
    the lane (the host has finished such a stream already).

    Returns ``(lanes, out (rounds, S, k+1), commits (rounds, S), proposed
    (rounds, S), logprobs (rounds, S, k+1) or None, finite (S,))``: the
    host keeps ``out[r, s, :commits[r, s]]`` round by round.

    The MTP drafter (`mtp`, the head lane pools): `hist` is then the (S,
    k) drafts of the first round (the admission bootstrap or the previous
    call's last drafts) and every slot proposes all k. The chunk forward
    also returns the hiddens, and after the verify each head advances its
    lane over the chunk's columns: head 1's next-token stream is the
    verified row ``out`` (columns past the cut are written over by the
    next round before they are attended), its fresh draft is its argmax
    at the newest committed column; with k == 2 head 2 runs on head 1's
    layer outputs with head 1's fresh draft at that column. Returns a
    seventh value, the (S, k) drafts of the next round (None without
    `mtp`)."""
    if mtp is not None:
        from solvingpapers_tpu_torch.models.deepseekv3 import mtp_head_apply
    dev = toks.device
    s_n = toks.shape[0]
    ar = torch.arange(k + 1, device=dev)
    rows = torch.arange(s_n, device=dev)[:, None]
    kw = pooled_decode_kwargs(model)
    cnt = torch.zeros_like(pos)
    ok = torch.ones_like(active)
    outs, commits_r, proposed, lps = [], [], [], []
    drafts = hist if mtp is not None else None
    for _ in range(rounds):
        if mtp is None:
            ds, avail = ngram_drafts(hist, hlen, k=k, nmax=nmax)
        else:
            ds, avail = drafts, torch.full_like(toks, k)
        avail = torch.where(spec_ok & active, avail, torch.zeros_like(avail))
        chunk = torch.cat([toks[:, None], ds], dim=1)
        poss = torch.clamp(pos[:, None] + ar, max=max_len - 1)
        if mtp is None:
            logits, lanes = model(chunk, positions=poss, caches=lanes, **kw)
        else:
            (logits, hs), lanes = model(chunk, positions=poss, caches=lanes,
                                        return_hidden=True, **kw)
        if fault is not None:
            logits = _inject_fault(logits, fault[:, None])
        step_ok, logits = _finite_ok(logits)
        ok = ok & step_ok.all(dim=1)
        kr = None if keys is None else keys[rows, cnt[:, None] + ar]
        out, commits, lp = spec_verify(logits, ds, avail, packed, kr, cap=cap,
                                       allow=allow, need_lp=need_lp)
        commits = torch.where(active, commits, torch.zeros_like(commits))
        cut = torch.clamp(commits - 1, min=0)
        nxt = torch.gather(out, 1, cut[:, None])[:, 0]
        toks = torch.where(active, nxt, toks)
        if mtp is None:
            hist[rows, hlen[:, None] + ar] = out
            hlen = torch.clamp(hlen + commits, max=max_len)
        else:
            g1, y1, _, _ = mtp_head_apply(model, hs, out, poss, cache=mtp[0],
                                          **kw)
            d1 = torch.argmax(g1[rows[:, 0], cut], dim=-1)
            drafts = d1[:, None]
            if k == 2:
                nxt2 = torch.cat([out[:, 1:], out[:, -1:]], dim=1)
                nxt2 = torch.where(ar[None] == cut[:, None], d1[:, None], nxt2)
                g2, _, _, _ = mtp_head_apply(model, y1, nxt2, poss,
                                             cache=mtp[1], head=2, **kw)
                drafts = torch.stack(
                    [d1, torch.argmax(g2[rows[:, 0], cut], dim=-1)], dim=1)
        pos = torch.clamp(pos + commits, max=max_len - 1)
        cnt = cnt + commits
        outs.append(out)
        commits_r.append(commits)
        proposed.append(avail)
        lps.append(lp)
    return (lanes, torch.stack(outs), torch.stack(commits_r),
            torch.stack(proposed), torch.stack(lps) if need_lp else None, ok,
            drafts)


def _spec_decode_program(model, k, rounds, cap, max_len, nmax, caches, toks,
                         pos, active, spec_ok, hist, hlen, packed, keys,
                         allow=None, need_lp=False, fault=None, eidx=None):
    """Lane-pool speculative decode block: `rounds` n-gram draft-verify
    rounds (`_spec_rounds`) on the pool's lanes, in place. Returns the
    caches and `_spec_rounds`' outputs less its lanes.

    Quantized pools: the rounds run on the dequantized view (kv_exact
    slots on their exact lanes) and the store requantizes each slot's
    written window bounded by the DEVICE-committed count
    (``hi = pos0 + max(total, 1)``): draft positions past it hold
    rejected draws, whose outliers would coarsen the whole block's scale
    for the committed tokens sharing it, so they keep their old codes
    (`tail_garbage`)."""
    quant = isinstance(caches, QuantStore)
    lanes = quant_lanes_view(caches, eidx) if quant else caches
    lanes, out, commits, proposed, lps, ok, _ = _spec_rounds(
        model, k, rounds, cap, max_len, nmax, lanes, toks, pos, active,
        spec_ok, hist, hlen, packed, keys, allow, need_lp, fault)
    if quant:
        total = commits.sum(dim=0)
        caches = quant_store_written(caches, lanes, pos, rounds * (k + 1),
                                     eidx, hi=pos + torch.clamp(total, min=1),
                                     tail_garbage=True)
    else:
        caches = lanes
    return caches, out, commits, proposed, lps, ok


def _paged_spec_decode_program(model, k, rounds, cap, max_len, nmax, phys,
                               table, toks, pos, active, spec_ok, hist, hlen,
                               packed, keys, allow=None, need_lp=False,
                               fault=None, eidx=None):
    """Paged-pool speculative decode block: `_spec_decode_program`'s
    rounds on the lanes gathered once from the page `table`, then only
    each slot's DEVICE-committed window [pos0, last] goes back
    (`scatter_window_pages`): rejected-draft garbage past it never
    reaches the physical pool, so shared prefix pages stay immutable.
    The window is bounded by the device's commit count, which can exceed
    what the host keeps (a grammar slot keeps round 0 only; EOS and stop
    strings truncate): those tail positions hold stale-draw KV that is
    sound only because it lies past the slot's attend window and is
    rewritten before it is ever attended, so no page past a slot's
    host-accepted length is shared or snapshot.

    Quantized pools: the gather dequantizes, the window's pages
    requantize with the rejected tail kept at its old codes
    (`quant_scatter_window_pages`), and the kv_exact slots' lanes go back
    to their exact lanes."""
    quant = isinstance(phys, QuantStore)
    lanes = (quant_gather_lanes(phys, table, eidx) if quant
             else gather_lanes(phys, table))
    lanes, out, commits, proposed, lps, ok, _ = _spec_rounds(
        model, k, rounds, cap, max_len, nmax, lanes, toks, pos, active,
        spec_ok, hist, hlen, packed, keys, allow, need_lp, fault)
    total = commits.sum(dim=0)
    last = torch.clamp(pos + torch.clamp(total, min=1) - 1, max=max_len - 1)
    span = rounds * (k + 1)
    if quant:
        phys = quant_scatter_window_pages(phys, lanes, table, pos, last, span)
        phys = quant_store_exact_lanes(phys, lanes, eidx)
    else:
        phys = scatter_window_pages(phys, lanes, table, pos, last, span)
    return phys, out, commits, proposed, lps, ok


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
        # quantized KV storage: int8 codes and scales in the pool; kv_exact
        # requests ride full-precision sidecar lanes in the same calls
        self._quant = cfg.kv_quant is not None
        if cfg.kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be 'int8' or None, got {cfg.kv_quant!r}")
        if cfg.kv_quant_block < 1:
            raise ValueError(f"kv_quant_block must be >= 1, got {cfg.kv_quant_block}")
        if cfg.kv_exact_lanes < 0:
            raise ValueError(f"kv_exact_lanes must be >= 0, got {cfg.kv_exact_lanes}")
        if cfg.kv_exact_lanes and not self._quant:
            raise ValueError(
                "kv_exact_lanes books full-precision sidecar lanes for "
                "kv_exact requests inside a QUANTIZED pool, which needs "
                "kv_quant set: an unquantized pool is exact everywhere "
                "already, so the knob would silently do nothing")
        if (self._quant and cfg.prefix_cache and not cfg.paged
                and cfg.prefix_page % cfg.kv_quant_block):
            raise ValueError(
                f"prefix_page {cfg.prefix_page} is not a multiple of "
                f"kv_quant_block {cfg.kv_quant_block}: quantized lane "
                "segments carry whole scale rows, so splice offsets (page "
                "multiples) must be block-aligned")
        # the exact-lane sidecar's bookkeeping: each slot's lane index (0 =
        # quantized) and a LIFO free list of lanes [1, kv_exact_lanes]
        self._eidx = np.zeros(cfg.n_slots, np.int64)
        self._exact_free = list(range(cfg.kv_exact_lanes, 0, -1))
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
        if self._quant:
            # present iff the pool is quantized, as the paged gauges are
            self.metrics.add_gauge_provider(weak_method(self._kv_quant_gauges, {}))
        self.prefix_cache = self._make_prefix_cache()
        # speculative decoding (serve/spec.py): draft-verify rounds in the
        # decode step, with the host-side controller that falls back to
        # the plain block while drafts keep rejecting
        self._spec = cfg.speculative
        self._spec_ctl = None
        self._mtp_pool = None
        if cfg.speculative is None:
            if cfg.spec_rounds is not None:
                raise ValueError(
                    "spec_rounds configures the speculative decode block "
                    "and needs speculative set: without a drafter it "
                    "would silently do nothing")
        else:
            if cfg.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {cfg.spec_k}")
            if cfg.spec_rounds is not None and cfg.spec_rounds < 1:
                raise ValueError(
                    f"spec_rounds must be >= 1, got {cfg.spec_rounds}")
            self._spec_rounds = cfg.spec_rounds or cfg.decode_block
            if cfg.speculative == "mtp":
                check_drafter(getattr(model, "cfg", None), cfg)
                self._spec_k = min(cfg.spec_k, model.cfg.mtp_heads, 2)
                self._mtp_pool = self._make_mtp_pool()
                # each slot's first drafts of the next spec call
                self._next_drafts = np.zeros((cfg.n_slots, self._spec_k),
                                             np.int64)
            else:
                if cfg.spec_ngram < 1:
                    raise ValueError(
                        f"spec_ngram must be >= 1, got {cfg.spec_ngram}")
                self._spec_k = cfg.spec_k
            min_rate = cfg.spec_min_rate
            if min_rate is None:
                min_rate = max(1.0, self._spec_k / 4)
            self._spec_ctl = SpecController(min_rate=min_rate,
                                            probe_every=cfg.spec_probe_every)
            self.metrics.add_gauge_provider(weak_method(self._spec_gauges, {}))
        # the scheduler's anti-starvation clock in delivered-token block
        # equivalents: a speculative step can deliver many blocks' worth
        # (see FIFOScheduler.tick); plain steps leave it at 1
        self._tick_weight = 1.0
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
                       if cfg.paged or cfg.kv_exact_lanes else None),
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
        callable, a grammar alongside an explicit eos_id, a budget too
        small for the grammar's shortest complete document, an SLO class
        (`params.slo`) the engine does not track, and `params.kv_exact` on
        a quantized engine with no exact lanes. A full
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
        if params.kv_exact and self._quant and not self.config.kv_exact_lanes:
            raise ValueError(
                "kv_exact requests need full-precision sidecar lanes on a "
                "quantized pool: construct the engine with "
                "ServeConfig.kv_exact_lanes >= 1 (on an unquantized engine "
                "kv_exact is a no-op and always accepted)")
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
        journal, the page pool, the quantized pool's bytes and exact
        lanes, speculation, the SLO classes, the prefix cache and the time
        series' sparklines."""
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
        store = pool.phys if self._paged else pool.caches
        if self._quant and store is not None:  # None: lost in a rebuild
            pool_bytes, scale_bytes, exact_bytes, base_bytes = \
                quant_pool_bytes(store)
            d["kv_quant"] = {
                "mode": self.config.kv_quant,
                "quant_block": pool.quant_block,
                "kv_pool_bytes": pool_bytes + exact_bytes,
                "quant_bytes": pool_bytes,
                "scale_bytes": scale_bytes,
                "exact_bytes": exact_bytes,
                "baseline_bytes": base_bytes,
                "bytes_ratio": round(pool_bytes / base_bytes, 4),
                "exact_lanes": pool.exact_lanes,
                "exact_lanes_free": len(self._exact_free),
                "exact_slots": [i for i, e in enumerate(self._eidx) if e],
            }
        if self._spec is not None:
            d["spec"] = {
                "drafter": self._spec,
                "k": self._spec_k,
                "rounds": self._spec_rounds,
                "steps": m.spec_steps,
                "drafts_proposed": m.spec_proposed,
                "drafts_accepted": m.spec_accepted,
                "acceptance_rate": round(
                    m.spec_accepted / m.spec_proposed, 4
                ) if m.spec_proposed else 0.0,
                "tokens_per_step": round(
                    m.spec_tokens / m.spec_steps, 2
                ) if m.spec_steps else 0.0,
                **self._spec_ctl.stats(),
            }
            if self._mtp_pool is not None:
                d["spec"]["mtp_cache_bytes"] = self._mtp_bytes()
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
        self.scheduler.tick(self._tick_weight)
        self._tick_weight = 1.0
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
                               page_budget=cfg.page_budget, quant=cfg.kv_quant,
                               exact_lanes=cfg.kv_exact_lanes)
        return KVSlotPool(self.model, cfg.n_slots, cfg.max_len,
                          quant=cfg.kv_quant, quant_block=cfg.kv_quant_block,
                          exact_lanes=cfg.kv_exact_lanes)

    def _make_mtp_pool(self) -> list:
        """The MTP drafter's head lanes: one latent pool a head, ``max_len
        + k + 1`` rows a slot (the slack the reference's decode programs
        give every lane), in the compute dtype."""
        mcfg = self.model.cfg
        return [LatentCache.init(self.config.n_slots,
                                 self.config.max_len + self._spec_k + 1,
                                 mcfg.latent_dim + mcfg.rope_dim,
                                 mcfg.compute_dtype, device=self.device)
                for _ in range(self._spec_k)]

    def _mtp_bytes(self) -> int:
        return sum(c.c.numel() * c.c.element_size() for c in self._mtp_pool)

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
        belong to the old pool), and so are the exact lanes' assignments
        (the new pool's sidecar is fresh).

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
        # the new pool's exact sidecar is fresh: every lane is free
        self._eidx[:] = 0
        self._exact_free = list(range(cfg.kv_exact_lanes, 0, -1))
        old = self.pool
        self.prefix_cache = None
        if self._mtp_pool is not None:
            self._mtp_pool = []
            self._next_drafts[:] = 0
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
        if self._mtp_pool is not None:
            self._mtp_pool = self._make_mtp_pool()
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
        overshoot lands and which every idle slot's table points at. A
        quantized pool zeroes codes and scale rows, and a kv_exact slot's
        exact lane too."""
        eidx = int(self._eidx[slot])
        if self._paged:
            pool = self.pool
            n = int(pool.n_alloc[slot])
            own = [int(p) for p in pool.table[slot, :n] if pool.refcount[p] == 1]
            scrub_pages(pool.phys, own + [TRASH_PAGE], eidx)
        else:
            scrub_lane(self.pool.caches, slot, eidx)
            if self._mtp_pool is not None:
                scrub_lane(self._mtp_pool, slot)

    def _ladder_step(self) -> None:
        """One degradation-ladder evaluation a step: gather the pressure
        signals (pages, SLO burn; no `hbm` reason until the port has a
        memory ledger), move at most one rung, and apply the rung's
        effects: from rung 1 shed up to 4 prefix-cache leaves a step;
        from rung 2 hold speculation (plain blocks, the controller's
        adaptive state untouched); rungs 3 and 4 shed admissions in
        `submit`."""
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
        if self._ladder.rung >= 2 and self._spec_ctl is not None:
            self._spec_ctl.hold(2)

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
        semantics). A `kv_exact` entry keeps its flag: on a quantized
        engine it resumes on an exact lane, and one with no exact lanes
        cannot take it (the reference's reason)."""
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
            elif (params.kv_exact and self._quant
                  and not self.config.kv_exact_lanes):
                err = "kv_exact needs exact sidecar lanes"
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
        # kv_exact streams bypass the (quantized) prefix cache: a spliced
        # int8 prefix would break their byte-exactness, and their sidecar
        # lanes own no segment or page the tree could share
        exact = self._quant and req.params.kv_exact
        pc = None if exact else self.prefix_cache
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
        if ((self._paged and not exact
             and not self._ensure_pages(slot, matched + padded))
                or (exact and not self._exact_free)):
            # even with the tree and every other stream shed, the pool
            # cannot cover this prefill, or the gate's estimate of the free
            # exact lanes went stale (several exact picks in one step):
            # hand the slot back, retry later
            self._slot_req[slot] = None
            self.pool.release(slot)
            req.slot = None
            self._requeue(req)
            return False
        eidx = 0
        if exact:
            eidx = self._exact_free.pop()
            self._eidx[slot] = eidx
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
        # constrained request's allow-list, a stochastic request's draw
        # key (sample index 0 of its chain) and, while a fault plan is
        # armed, the poison code (last)
        parts = [np.zeros(padded, np.int64)]
        parts[0][:suffix] = seq[matched:]
        if self._paged:
            parts.append(self.pool.table[slot])
        if constrained:
            parts.append(self._allow[slot])
        stochastic = not req.params.greedy
        if stochastic:
            parts.append(np.asarray([request_seed(
                self.config.seed, self._rng_step, slot, seed, 0)], np.int64))
        self._rng_step += 1
        armed = self._faults is not None
        if armed:
            parts.append(np.asarray([pf_fault], np.int64))
        ids = torch.as_tensor(np.concatenate(parts), device=self.device)
        table_end = padded + (self.pool.pages_per_lane if self._paged else 0)
        allow_end = table_end + (self.config.sample_cap if constrained else 0)
        allow = ids[None, table_end:allow_end] if constrained else None
        key = ids[allow_end:allow_end + 1] if stochastic else None
        fault = ids[-1] if armed else None
        args = (self.model, padded, chunk, matched, self.config.sample_cap)
        sample = (self._packed([slot]), key, allow, req.params.logprobs,
                  fault)
        t_pf = smetrics.now() if tr is not None else 0.0
        with scope(self.profile, "serve/prefill"):
            if self._paged:
                self.pool.phys, head, logprob = _paged_prefill_program(
                    *args, self.pool.phys, ids[:padded], ids[padded:table_end],
                    suffix, *sample, eidx=eidx)
            elif self._mtp_pool is not None:
                # admission is the heads' bootstrap: their lanes fill
                # beside the main lane and the first drafts come back with
                # the first token (matched is 0: no prefix cache)
                self.pool.caches, head, logprob, drafts = _mtp_prefill_program(
                    self.model, padded, chunk, self.config.sample_cap,
                    self._spec_k, self.pool.caches, self._mtp_pool,
                    ids[:padded], slot, suffix, *sample)
                head = torch.cat([head, drafts])
            else:
                self.pool.caches, head, logprob = _prefill_program(
                    *args, self.pool.caches, ids[:padded], slot, suffix,
                    *sample, eidx=eidx)
            # one read, the token and the finite flag together (and the
            # MTP drafts); it waits for the device, so the clock readings
            # after it are device-true
            first, ok, *drafts = head.tolist()
            if self._mtp_pool is not None:
                self._next_drafts[slot] = drafts
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

    def _spec_gauges(self) -> dict[str, float]:
        """Speculation gauges riding every metrics snapshot (registered
        iff `speculative`)."""
        m = self.metrics
        rate = (m.spec_accepted / m.spec_proposed) if m.spec_proposed else 0.0
        per_step = (m.spec_tokens / m.spec_steps) if m.spec_steps else 0.0
        out = {
            "serve/spec_acceptance_rate": rate,
            "serve/spec_tokens_per_step": per_step,
            "serve/spec_drafts_rejected": float(m.spec_proposed
                                                - m.spec_accepted),
        }
        if self._mtp_pool is not None:
            # the MTP drafter's head lanes: a pool beside the KV pool
            out["serve/mtp_cache_bytes"] = float(self._mtp_bytes())
        return out

    def _spec_block(self, probe: bool = False) -> list[Request]:
        """One speculative decode step: `spec_rounds` draft-verify rounds
        in one program call, committing a variable number of tokens a
        slot. The host walk mirrors `_decode_block`'s, token by token
        (append, grammar advance, logprobs, stop checks), so EOS, budget,
        stop strings, cancel and timeout behave as in the plain block;
        only the token source changed. Grammar-constrained slots keep ONE
        token a step (their allow-list is stale after one draw): they
        ride the same call draft-free and the host takes round 0's first
        commit. `probe` runs the controller's short measurement block
        (two rounds) instead of the full one.

        One transfer carries the control rows, the stochastic slots' draw
        keys for every sample index the call can commit (`draw_keys`; the
        rounds gather them by their device-side commit counts, so no
        round reads back) and every slot's history (the drafter's corpus);
        one host read takes the tokens, commit counts, draft counts and
        finite flags together (logprobs a second, only when a slot asked
        for them)."""
        cfg = self.config
        k = self._spec_k
        rounds = min(2, self._spec_rounds) if probe else self._spec_rounds
        span = rounds * (k + 1)
        n, cap = cfg.n_slots, cfg.sample_cap
        if self._paged:
            # cover the worst-case committed window (every round sweeps);
            # reclaim preempts youngest first under pressure, as usual
            self._cover_decode(min(span, cfg.max_len))
            if self.pool.n_active == 0:
                return []
        # the fault plane's decode site: the speculative block IS the
        # decode dispatch
        self._poke_site("decode")
        armed = self._faults is not None
        mtp = self._mtp_pool is not None
        # the history is padded by k + 1 so a round's window write at
        # hlen <= max_len always fits; the MTP drafter reads its first
        # drafts there instead
        width = k if mtp else cfg.max_len + k + 1
        samp0 = np.zeros(n, np.int64)
        stochastic = np.zeros(n, bool)
        constrained = False
        pages = self.pool.pages_per_lane if self._paged else 0
        for slot, r in enumerate(self._slot_req):
            if r is not None:
                samp0[slot] = len(r.tokens)
                stochastic[slot] = not r.params.greedy
                constrained = constrained or r.grammar is not None
        # rows: toks, pos, active, spec gate, hist length, then (paged) the
        # page tables, (constrained) the allow-lists, (stochastic) the
        # draw keys, (armed) the fault row, then the history, one column a
        # slot
        lists = 5 + pages + (cap if constrained else 0)
        rows = lists + (span if stochastic.any() else 0)
        state = np.zeros((rows + armed + width, n), np.int64)
        state[0] = self._toks
        state[1] = self._pos
        for slot, r in enumerate(self._slot_req):
            if r is None:
                continue
            state[2, slot] = 1
            if r.grammar is not None:
                # constrained slots never draft (gate 0) and refresh their
                # allow-list as the plain block does
                self._allow[slot] = self._grammar_allow(r)
            else:
                state[3, slot] = 1
            if mtp:
                continue
            seq = np.concatenate([r.prompt, np.asarray(r.tokens, np.int64)])
            m = min(int(seq.size), cfg.max_len)
            state[rows + armed:rows + armed + m, slot] = seq[:m]
            state[4, slot] = m
        if mtp:
            state[rows + armed:] = self._next_drafts.T
        if self._paged:
            state[5:5 + pages] = self.pool.table.T
        if constrained:
            state[5 + pages:lists] = self._allow.T
        if stochastic.any():
            state[lists:rows] = draw_keys(cfg.seed, self._rng_step, self._seed,
                                          samp0, stochastic, span)
        if armed:
            state[rows] = self._fault_row
            self._fault_row[:] = 0  # one-shot: this dispatch only
        need_lp = bool(self._need_lp.any())
        self._rng_step += 1
        dev = self.device
        t0 = smetrics.now()
        state = torch.as_tensor(state, device=dev)
        hist = state[rows + armed:].T.contiguous()
        ctl = (state[0], state[1], state[2].bool(), state[3].bool(), hist,
               state[4], self._packed(slice(None)),
               state[lists:rows].T if stochastic.any() else None,
               state[5 + pages:lists].T if constrained else None, need_lp,
               state[rows] if armed else None)
        eidx = self._eidx if self._quant else None
        statics = (self.model, k, rounds, cap, cfg.max_len, cfg.spec_ngram)
        nxt = None
        with scope(self.profile, "serve/spec_block"):
            if self._paged:
                self.pool.phys, out, commits, proposed, lps, ok = \
                    _paged_spec_decode_program(
                        *statics, self.pool.phys, state[5:5 + pages].T, *ctl,
                        eidx=eidx)
            elif mtp:
                # the rounds on the lanes in place, drafted by the heads:
                # ctl's history rows hold the first drafts here
                self.pool.caches, out, commits, proposed, lps, ok, nxt = \
                    _spec_rounds(*statics[:5], 0, self.pool.caches, *ctl,
                                 mtp=self._mtp_pool)
            else:
                self.pool.caches, out, commits, proposed, lps, ok = \
                    _spec_decode_program(*statics, self.pool.caches, *ctl,
                                         eidx=eidx)
            # the fault plane's scatter site: after the dispatch, before
            # the read where a device error would surface
            self._poke_site("scatter")
            # ONE read: (rounds, S, k + 1) tokens, then the commit and draft
            # counts, then the finite flags
            packed_out = torch.cat([out.transpose(1, 2).reshape(-1, n),
                                    commits, proposed, ok.long()[None]]
                                   + ([] if nxt is None else [nxt.T])
                                   ).cpu().numpy()
            lps = None if lps is None else lps.cpu().numpy()
        if nxt is not None:
            self._next_drafts = packed_out[-k:].T.copy()
            packed_out = packed_out[:-k]
        out = packed_out[:rounds * (k + 1)].reshape(rounds, k + 1, n)
        commits = packed_out[rounds * (k + 1):rounds * (k + 2)]
        proposed = packed_out[rounds * (k + 2):rounds * (k + 3)]
        finite = packed_out[-1]
        now = smetrics.now()
        self.metrics.record_decode_block(now - t0)
        tr = self.trace
        if tr is not None:
            self._dev_s += now - t0
        finished: list[Request] = []
        tot_prop = tot_acc = tot_rounds = delivered = max_appended = 0
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            if tr is not None:
                tr.complete("spec_block", "engine", f"slot{slot}", ts=t0,
                            dur=now - t0, req=req.id, rounds=rounds, k=k)
            if not finite[slot]:
                finished.append(self._quarantine(req, now))
                continue
            if req.cancelled or (req.deadline is not None
                                 and now >= req.deadline):
                self._finish(req, "cancelled" if req.cancelled else "timeout",
                             now)
                finished.append(req)
                self._notify(req, 0)
                continue
            reason = None
            base = len(req.tokens)
            grammar1 = req.grammar is not None
            new, new_lps = [], []
            for r in range(rounds):
                c = int(commits[r, slot])
                if not grammar1:
                    tot_prop += int(proposed[r, slot])
                    tot_acc += max(c - 1, 0)
                    tot_rounds += 1
                    # the request's own acceptance fact (engine-wide rates
                    # hide a single adversarial stream)
                    req.spec_proposed += int(proposed[r, slot])
                    req.spec_accepted += max(c - 1, 0)
                # a grammar slot keeps round 0's first commit only: later
                # draws went through a stale list (overshoot)
                take = c if not grammar1 else (1 if r == 0 else 0)
                for j in range(take):
                    t = int(out[r, j, slot])
                    new.append(t)
                    if grammar1:
                        req.grammar.advance(t)
                    if req.params.logprobs:
                        new_lps.append(float(lps[r, slot, j]))
                    reason = self._stop_reason(
                        req, t, req.max_new_tokens - base - len(new))
                    if grammar1 and req.grammar.done:
                        reason = "stop"
                    if reason is not None:
                        break
                if reason is not None:
                    break
            kk = self._stop_string_at(req, new, base)
            if kk is not None:
                last = base + len(new) - 1
                if reason is None or kk < last or reason == "length":
                    del new[kk + 1 - base:]
                    del new_lps[kk + 1 - base:]
                    reason = "stop"
            req.logprobs.extend(new_lps)
            req.tokens.extend(new)
            appended = len(new)
            # one commit record a request a call: the rounds' variable
            # commit counts are invisible to the journal
            self._journal_commit(req, new)
            self.metrics.record_tokens(appended, now - self._last_emit[slot],
                                       now)
            self._last_emit[slot] = now
            self.pool.positions[slot] += appended
            delivered += appended
            max_appended = max(max_appended, appended)
            if reason is not None:
                self._finish(req, reason, now)
                finished.append(req)
            else:
                # an unfinished slot kept every commit, so the mirrors
                # track the device carry exactly
                self._toks[slot] = new[-1]
                self._pos[slot] += appended
            self._notify(req, appended)
        self.metrics.record_spec_step(tot_prop, tot_acc, delivered)
        if tot_rounds:
            self._spec_ctl.observe(tot_acc, tot_rounds)
        self._tick_weight = max(1.0, max_appended / cfg.decode_block)
        return finished

    def _decode_block(self) -> list[Request]:
        if self._spec_ctl is not None:
            decision = self._spec_ctl.decide()
            if decision != "off":
                return self._spec_block(probe=decision == "probe")
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
        # (with a constrained slot) the allow-lists, then (with a
        # stochastic slot) every step's draw keys, then (with a fault plan
        # armed) the fault row
        pages = self.pool.pages_per_lane if self._paged else 0
        lists = 4 + pages + (cap if constrained else 0)
        rows = lists + (block if stochastic.any() else 0)
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
            state[4 + pages:lists] = self._allow.T
        if stochastic.any():
            state[lists:rows] = draw_keys(cfg.seed, self._rng_step, self._seed,
                                          samp_idx, stochastic, block)
        if armed:
            state[rows] = self._fault_row
            self._fault_row[:] = 0  # one-shot: this dispatch only
        self._rng_step += 1
        dev = self.device
        t0 = smetrics.now()
        state = torch.as_tensor(state, device=dev)
        allow = state[4 + pages:lists].T if constrained else None
        ctl = (state[0], state[1], state[2].bool(), state[3],
               self._packed(slice(None)),
               state[lists:rows] if stochastic.any() else None, allow, need_lp,
               state[rows] if armed else None)
        # quantized pools: the exact-lane row (host ints: selecting the
        # kv_exact slots reads nothing back from the device)
        eidx = self._eidx if self._quant else None
        with scope(self.profile, "serve/decode_block"):
            if self._paged:
                self.pool.phys, out, lps = _paged_decode_program(
                    self.model, block, cap, self.pool.phys,
                    state[4:4 + pages].T, *ctl, eidx=eidx)
            else:
                self.pool.caches, out, lps = _decode_program(
                    self.model, block, cap, self.pool.caches, *ctl, eidx=eidx)
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
        if self._eidx[slot]:
            # the exact lane goes back (the pools' stale-data contract: the
            # next exact prefill overwrites it before anything reads it)
            self._exact_free.append(int(self._eidx[slot]))
            self._eidx[slot] = 0
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

    def _kv_quant_gauges(self) -> dict[str, float]:
        """The quantized pool's byte gauges (registered iff `kv_quant`),
        analytic shape sums, never a device read."""
        pool = self.pool
        store = pool.phys if self._paged else pool.caches
        if store is None:  # the pool's device memory was lost in a rebuild
            return {}
        pool_bytes, scale_bytes, _, base_bytes = quant_pool_bytes(store)
        out = {
            # resident bytes a bookable cache position costs (codes and
            # scales; the exact lanes are a fixed surcharge of their own)
            "serve/kv_bytes_per_token": pool_bytes / pool.token_capacity,
            "serve/kv_quant_scale_bytes": float(scale_bytes),
            "serve/kv_quant_bytes_saved": float(base_bytes - pool_bytes),
        }
        if pool.exact_lanes:
            out["serve/kv_quant_exact_lanes_free"] = float(len(self._exact_free))
            out["serve/kv_quant_exact_active"] = float(
                pool.exact_lanes - len(self._exact_free))
        return out

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
        """The scheduler's gate beyond free slots: on the paged pool free
        pages must cover the request's prompt + a decode reservation; a
        kv_exact request on a quantized pool needs a free exact lane
        instead (it holds no pages)."""
        if self._quant and req.params.kv_exact:
            return bool(self._exact_free)
        if self._paged:
            return self.pool.pages_free >= self._page_need(req)
        return True

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
        if self._quant and head.params.kv_exact:
            return  # blocked on exact lanes, not pages: the tree cannot help
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
            if self._quant and r.params.kv_exact:
                continue  # exact streams hold no pages: nothing to free
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
            if self._quant and req.params.kv_exact:
                continue  # exact streams write sidecar lanes, not pages
            target = min(int(self._pos[slot]) + block, self.config.max_len)
            ok = self.pool.ensure(slot, target)
            while not ok and self._reclaim_one(protect=covered):
                ok = self.pool.ensure(slot, target)
            if not ok:  # nothing reclaimable is left: this stream yields
                self._preempt(req)
                covered.discard(slot)


__all__ = ["ServeConfig", "ServeEngine"]
