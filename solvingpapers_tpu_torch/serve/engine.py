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

Not in this slice (kept by the reference, listed in ROADMAP.md): the
quantized pools, speculative decoding, the fault boundary, journal,
replay, fleet, SLO accounting and tracing.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from solvingpapers_tpu_torch.device import resolve_device
from solvingpapers_tpu_torch.metrics.profile import ProfileWindow, scope
from solvingpapers_tpu_torch.serve import metrics as smetrics
from solvingpapers_tpu_torch.serve.grammar import encode_allow
from solvingpapers_tpu_torch.serve.kv_pool import (
    KVSlotPool,
    PagedKVPool,
    extract_lane,
    gather_lane,
    gather_lanes,
    scatter_lane_pages,
    scatter_written_pages,
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
    WAITING,
    FIFOScheduler,
    Request,
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
    """Engine shape/policy knobs (the reference's, without its quantized,
    speculative, fault, tracing and SLO knobs).

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


_UNSET = object()


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
                     length, packed, generator, allow=None, need_lp=False):
    """Prefill one request into lane `slot` and sample its first token
    (sample index 0 of its chain); returns the caches, the token and its
    logprob (None without `need_lp`).

    `start` is the prefix-cache match length: `prompt` is the UNCOVERED
    SUFFIX ((padded,) ids), lane positions [0, start) already hold the
    spliced prefix, and positions and `attend_len` shift by `start` (0
    is a full prefill). `allow` is the request's (1, cap) grammar
    allow-list for the first token, or None."""
    lane = extract_lane(caches, slot)
    lane, last = _prefill_lane(model, padded, chunk, start, lane, prompt,
                               length)
    first, lp = fused_sample(last[None], packed, [generator], cap=cap,
                             allow=allow, need_lp=need_lp)
    caches = store_lane(caches, lane, slot)
    return caches, first[0], None if lp is None else lp[0]


def _paged_prefill_program(model, padded, chunk, start, cap, phys, prompt,
                           row, length, packed, generator, allow=None,
                           need_lp=False):
    """Paged-pool prefill: `_prefill_program`'s contract over a lane
    GATHERED from the slot's page-table `row`, with only the pages the
    prefill may have written going back. On a prefix hit pages [0,
    start // page) hold shared prefix KV the gather reads; the scatter
    starts at ``start // page``, so shared pages are read, never
    written."""
    lane = gather_lane(phys, row)
    lane, last = _prefill_lane(model, padded, chunk, start, lane, prompt,
                               length)
    first, lp = fused_sample(last[None], packed, [generator], cap=cap,
                             allow=allow, need_lp=need_lp)
    page = phys[0].max_len
    phys = scatter_lane_pages(phys, lane, row, start // page)
    return phys, first[0], None if lp is None else lp[0]


def pooled_decode_kwargs(model) -> dict:
    """Keyword arguments of a forward over the whole pool: per-row
    routing for a model that routes tokens (see the module's docstring)."""
    return {"row_routing": True} if getattr(model, "routes_tokens", False) else {}


def _decode_program(model, block, cap, caches, toks, pos, active, eos, packed,
                    generators, allow=None, need_lp=False):
    """Advance every slot `block` tokens; inactive slots run masked.

    toks/pos/eos are (S,) int64 and active (S,) bool device tensors;
    `generators(t)` gives step t's per-slot generators (None for greedy
    slots); `allow` is the (S, cap) grammar allow-lists (all -1 =
    unconstrained; None = no constrained slot), the same at every step
    (a constrained slot keeps only the block's first token). EOS padding
    is sticky: a slot whose previous token was its EOS emits EOS again,
    as `generate` pads. Returns the caches, the (block, S) emitted tokens
    and, with `need_lp`, their (block, S) logprobs (else None).
    """
    out, lps = [], []
    kw = pooled_decode_kwargs(model)
    for t in range(block):
        logits, caches = model(toks[:, None], positions=pos[:, None],
                               caches=caches, **kw)
        nxt, lp = fused_sample(logits[:, 0], packed, generators(t), cap=cap,
                               allow=allow, need_lp=need_lp)
        hit_eos = (eos >= 0) & (toks == eos)
        nxt = torch.where(hit_eos, eos, nxt)
        nxt = torch.where(active, nxt, toks)
        pos = torch.where(active, pos + 1, pos)
        out.append(nxt)
        lps.append(lp)
        toks = nxt
    return caches, torch.stack(out), torch.stack(lps) if need_lp else None


def _paged_decode_program(model, block, cap, phys, table, toks, pos, active,
                          eos, packed, generators, allow=None, need_lp=False):
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
                                      need_lp)
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
            self.pool = PagedKVPool(model, cfg.n_slots, cfg.max_len, page,
                                    page_budget=cfg.page_budget)
            self.metrics.add_gauge_provider(weak_method(self._page_gauges, {}))
        else:
            if cfg.page_size is not None or cfg.page_budget is not None:
                raise ValueError(
                    "page_size/page_budget configure the paged pool and need "
                    "paged=True: on the lane pool they would silently do "
                    "nothing"
                )
            self.pool = KVSlotPool(model, cfg.n_slots, cfg.max_len)
        self.prefix_cache = (
            PrefixCache(page=cfg.prefix_page, max_bytes=cfg.prefix_cache_bytes,
                        pool=self.pool if cfg.paged else None)
            if cfg.prefix_cache else None
        )
        self.scheduler = FIFOScheduler(
            max_waiting=cfg.max_waiting,
            decode_priority=cfg.decode_priority,
            max_prefills_per_step=cfg.max_prefills_per_step,
            max_wait_steps=cfg.max_wait_steps,
            prefer_cached=cfg.prefix_sched,
            prefix_lookup=(weak_method(self._match_len, 0)
                           if self.prefix_cache else None),
            can_admit=(weak_method(self._can_admit, False)
                       if cfg.paged else None),
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

    # ------------------------------------------------------------- submit

    def submit(self, prompt, max_new_tokens: int = 64, eos_id=_UNSET,
               params: SamplingParams | None = None,
               deadline_s: float | None = None, grammar=None,
               stream_cb=None) -> Request:
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
        too small for the grammar's shortest complete document. A full
        waiting queue returns the request ``rejected``.
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
        if deadline_s is not None:
            req.deadline = req.submit_time + deadline_s
        if not self.scheduler.submit(req):
            self.metrics.record_reject()
        elif req.deadline is not None:
            self._waiting_deadlines += 1
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
        device work (so it cannot hang): the bounded shutdown's backstop.
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

    def close(self) -> None:
        """Shutdown's last step: `force_drain` whatever is still in flight
        (the front door's `EngineLoop.close` drains gracefully first) and
        close the profiler window. Idempotent; the engine stays usable."""
        if self.has_work():
            self.force_drain("cancelled")
        self.stop_profile()

    def stop_profile(self) -> None:
        """Close a still-open profiler window and write its trace
        (callers that step the engine themselves and stop before
        `profile_steps[1]`)."""
        if self.profile is not None:
            self.profile.close()

    def statusz(self) -> dict:
        """The /statusz document from host-side mirrors only: the engine's
        shape and queue, every slot's request and position, the metrics
        snapshot, and (present iff enabled) the page pool and the prefix
        cache."""
        d = {
            "engine": {
                "n_slots": self.config.n_slots,
                "n_free": self.pool.n_free,
                "occupancy": self.pool.occupancy,
                "queue_depth": len(self.scheduler),
                "step": self._step_idx,
                "max_len": self.config.max_len,
                "decode_block": self.config.decode_block,
            },
            "slots": [
                {"slot": i, "req": None if r is None else r.id,
                 "position": int(self.pool.positions[i])}
                for i, r in enumerate(self._slot_req)
            ],
            "metrics": self.metrics.snapshot(),
        }
        if self._paged:
            d["kv_pages"] = {
                "page_size": self.pool.page_size,
                "page_budget": self.pool.page_budget,
                "pages_free": self.pool.pages_free,
                "pages_active": self.pool.pages_active,
                "fragmentation": self.pool.fragmentation,
                "per_slot_pages": self.pool.n_alloc.tolist(),
            }
        if self.prefix_cache is not None:
            d["prefix_cache"] = {
                "bytes_held": self.prefix_cache.bytes_held,
                "evictions": self.prefix_cache.evictions,
            }
        return d

    # --------------------------------------------------------------- step

    def has_work(self) -> bool:
        return bool(len(self.scheduler)) or self.pool.n_active > 0

    @torch.no_grad()
    def step(self) -> list[Request]:
        """One engine iteration: admit + prefill, then one decode block.
        Returns the requests that FINISHED this iteration."""
        return self._step_inner()

    def _step_inner(self) -> list[Request]:
        if self.profile is not None and not self.profile.done:
            self.profile.tick(self._step_idx)
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
            # (the tail never reached its deadline decrement above)
            for r in reversed(picked[at + 1:]):
                self.scheduler.requeue_front(r)
            raise
        if self.pool.n_active > 0:
            finished.extend(self._decode_block())
        self.scheduler.tick()
        self.metrics.record_step(self.pool.occupancy)
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
        if pc is not None and length > 1:
            match = pc.match(seq[:length - 1])
            matched = match.length
            if matched:
                pc.pin(match)
                offset = 0
                for node in match.nodes:
                    if self._paged:  # zero-copy: page ids into the table
                        self.pool.append_shared(slot, node.pages)
                    else:
                        self.pool.splice_prefix(slot, node.segment, offset)
                        offset += node.length
                pc.unpin(match)
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
        # one transfer carries the suffix ids, paged the table row, and a
        # constrained request's allow-list
        parts = [np.zeros(padded, np.int64)]
        parts[0][:suffix] = seq[matched:]
        if self._paged:
            parts.append(self.pool.table[slot])
        if constrained:
            parts.append(self._allow[slot])
        ids = torch.as_tensor(np.concatenate(parts), device=self.device)
        table_end = padded + (self.pool.pages_per_lane if self._paged else 0)
        allow = ids[None, table_end:] if constrained else None
        generator = (None if req.params.greedy else request_generator(
            self.config.seed, self._rng_step, slot, seed, 0, self.device))
        self._rng_step += 1
        args = (self.model, padded, chunk, matched, self.config.sample_cap)
        sample = (self._packed([slot]), generator, allow, req.params.logprobs)
        with scope(self.profile, "serve/prefill"):
            if self._paged:
                self.pool.phys, first, logprob = _paged_prefill_program(
                    *args, self.pool.phys, ids[:padded], ids[padded:table_end],
                    suffix, *sample)
            else:
                self.pool.caches, first, logprob = _prefill_program(
                    *args, self.pool.caches, ids[:padded], slot, suffix,
                    *sample)
            first = int(first)  # waits for the device: `now` is device-true
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
            return False
        req.first_token_time = now
        req.tokens.append(first)
        if req.grammar is not None:
            req.grammar.advance(first)
        if req.params.logprobs:
            req.logprobs.append(float(logprob))
        self.metrics.record_first_token(req, now, prefilled=suffix)
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
        # the block's int control values go to the device in ONE transfer:
        # rows toks, pos, active, eos, then (paged) the page tables, then
        # (with a constrained slot) the allow-lists
        pages = self.pool.pages_per_lane if self._paged else 0
        state = np.zeros((4 + pages + (cap if constrained else 0), n), np.int64)
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
            state[4 + pages:] = self._allow.T
        step_tag = self._rng_step
        self._rng_step += 1
        dev = self.device

        def generators(t):
            return [request_generator(cfg.seed, step_tag, s, int(self._seed[s]),
                                      int(samp_idx[s]) + t, dev)
                    if stochastic[s] else None for s in range(n)]

        t0 = smetrics.now()
        state = torch.as_tensor(state, device=dev)
        allow = state[4 + pages:].T if constrained else None
        ctl = (state[0], state[1], state[2].bool(), state[3],
               self._packed(slice(None)), generators, allow, need_lp)
        with scope(self.profile, "serve/decode_block"):
            if self._paged:
                self.pool.phys, out, lps = _paged_decode_program(
                    self.model, block, cap, self.pool.phys,
                    state[4:4 + pages].T, *ctl)
            else:
                self.pool.caches, out, lps = _decode_program(
                    self.model, block, cap, self.pool.caches, *ctl)
            out = out.cpu().numpy()  # (block, n_slots); overshoot cut below
            lps = None if lps is None else lps.cpu().numpy()
        now = smetrics.now()
        self.metrics.record_decode_block(now - t0)
        finished: list[Request] = []
        for slot, req in enumerate(self._slot_req):
            if req is None:
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
        if req.first_token_time is None:
            req.first_token_time = now  # force-drained mid-admission
        if self._paged:
            # streams only grow, so the count at finish is the peak
            req.pages_held = max(req.pages_held,
                                 int(self.pool.n_alloc[req.slot]))
        self.metrics.record_finish(req, now)
        self._vacate(req.slot)

    def _finish_unadmitted(self, req: Request, reason: str,
                           now: float) -> None:
        """Finish a request cancelled or timed out in the waiting queue
        (never admitted, or a preempted stream waiting to resume)."""
        req.state = FINISHED
        req.finish_reason = reason
        req.finish_time = now
        self.metrics.record_finish(req, now)
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
