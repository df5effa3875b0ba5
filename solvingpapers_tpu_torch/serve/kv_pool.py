"""KV cache pools for the serving engine (port of
`solvingpapers_tpu/serve/kv_pool.py`): the contiguous lane pool
(`KVSlotPool`, with the prefix cache's splice and extract), the
block-paged pool (`PagedKVPool`, second half of this module), and the
quantized store both can hold instead of plain caches (`QuantStore`,
`ServeConfig.kv_quant`).

Layout: the pool is the model's own per-layer cache list with batch =
n_slots — slot s is batch row s of every tensor of every layer's cache
(the (n_slots, max_len, n_kv, head_dim) k/v of a `KVCache`, the
(n_slots, max_len, latent) rows of MLA's `LatentCache`), one contiguous
`max_len` lane per slot. Lanes are carved field by field from any cache
dataclass, as the reference carves its pytrees.

Stale data is harmless by construction, as in the reference: a freed
lane is not cleared; the next prefill overwrites positions
[0, prompt_len) before anything reads them, and decode attention masks
with ``kv_index <= position``, so stale slots past the position get
probability 0. Idle slots in a decode block write their dummy k/v into
their own lane's position 0, which the next prefill overwrites.

Prefix reuse (`serve/prefix_cache.py`): `splice_prefix` copies a cached
batch-1 segment into a lane's leading positions before the suffix
prefill (the lane owns its copy, so evicting the tree's node can never
corrupt an in-flight stream), and `extract_prefix` snapshots a freshly
prefilled prompt span out as a detached copy for the tree to keep.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from solvingpapers_tpu_torch.ops.quant import (
    dequantize,
    dequantize_tree,
    quantize,
    scale_shape,
)


def _tensors(cache) -> dict:
    """{field name: tensor} of one layer's cache dataclass."""
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)}


def extract_lane(caches: list, slot: int) -> list:
    """Slot `slot`'s batch-1 lane as VIEWS of the pooled caches (any
    cache dataclass: `KVCache`, `LatentCache`): a cached forward on the
    lane writes straight into the pool."""
    return [dataclasses.replace(c, **{name: t[slot:slot + 1]
                                      for name, t in _tensors(c).items()})
            for c in caches]


def store_lane(caches: list, lane: list, slot: int) -> list:
    """Write a batch-1 lane back into the pool at `slot`. A lane from
    `extract_lane` already IS the pool's storage and is not copied; any
    other lane is copied in. Dtypes must match exactly (no silent cast)."""
    for c, l in zip(caches, lane):
        lane_ts = _tensors(l)
        for name, pool_t in _tensors(c).items():
            lane_t = lane_ts[name]
            if lane_t.dtype != pool_t.dtype:
                raise TypeError(
                    f"store_lane: lane dtype {lane_t.dtype} != pool dtype "
                    f"{pool_t.dtype}; implicit casts are not performed"
                )
            dst = pool_t[slot:slot + 1]
            if lane_t.data_ptr() != dst.data_ptr():
                dst.copy_(lane_t)
    return caches


def scrub_lane(caches, slot: int, eidx: int = 0) -> None:
    """Zero slot `slot`'s lane in every tensor of every layer's cache, in
    place: the quarantine of a poisoned slot. Masked attention gives a
    stale FINITE value probability 0, but ``0 * NaN`` is NaN, so a
    non-finite value left in the lane would reach its next occupant. On a
    `QuantStore` the slot's codes and scale rows are zeroed, and so is
    exact lane `eidx` (0, the trash lane, is harmless to clear)."""
    if isinstance(caches, QuantStore):
        for t in _leaves(caches.q) + _leaves(caches.scale):
            t[slot].zero_()
        if caches.exact is not None:
            for t in _leaves(caches.exact):
                t[int(eidx)].zero_()
        return
    for c in caches:
        for t in _tensors(c).values():
            t[slot].zero_()


# ======================================================================
# Quantized storage (`ServeConfig.kv_quant`, ops/quant.py)
# ======================================================================
#
# Both pools can hold their cache bytes as symmetric int8 with per-block
# absmax scales instead of the model's compute dtype: a `QuantStore`
# replaces the plain cache list as the pool's device payload. The
# serving programs DEQUANTIZE ON READ (the view and gather helpers below
# materialize the familiar compute-dtype lane view, a fresh tensor, so
# the models serve unmodified and write into it in place) and QUANTIZE ON
# WRITE (the store and scatter helpers requantize exactly the blocks or
# pages the program wrote; untouched blocks are never rewritten, and
# within a touched block committed positions outside the written window
# re-encode from their own f32-dequantized codes rather than from the
# lossy compute-dtype lane view, so old entries cannot drift step to step
# on any compute dtype; see ops/quant.py).
#
# Exact traffic shares the store: `exact` is a small sidecar lane pool in
# the ORIGINAL dtype, ``kv_exact_lanes + 1`` lanes, lane 0 a trash lane
# (the paged pool's trash page, mirrored). A slot serving a
# `SamplingParams.kv_exact` request carries a nonzero exact-lane index:
# its reads take that full-precision lane instead of the dequantized view
# (per slot, so one batch mixes exact and quantized slots), and its
# writes land in both stores (the int8 shadow is harmless; the exact lane
# is authoritative). The reference writes every quantized slot's lane
# into trash lane 0 as well, so that one compiled program serves every
# mix; nothing ever reads lane 0, and the port, which compiles no
# program, skips those writes. Exact streams are byte-identical to the
# unquantized engine's because every value the model reads for them is.
#
# The exact-lane indices (`eidx`, `eidx_row`) are host integers (the
# engine's numpy mirror), so selecting the exact slots costs no device
# read.


@dataclasses.dataclass
class QuantStore:
    """Quantized pool payload: the int8 per-layer cache list `q`, its f32
    scale list `scale` (the same cache dataclasses, `ops.quant.scale_shape`
    tensors), the optional exact-lane sidecar `exact` (a plain cache list
    of ``exact_lanes + 1`` lanes), the time-block length `block` the scales
    tile, and the compute `dtype` the dequantized views take."""

    q: list
    scale: list
    exact: list | None
    block: int
    dtype: torch.dtype


@dataclasses.dataclass
class QuantSegment:
    """Quantized prefix-cache segment (lane pools): the batch-1 int8 and
    scale slices `extract_prefix` snapshots and `splice_prefix` writes
    back. Cached prefixes stay quantized at rest, so the radix tree's byte
    budget holds about twice the tokens."""

    q: list
    scale: list
    block: int

    @property
    def length(self) -> int:
        return next(iter(_tensors(self.q[0]).values())).shape[1]

    @property
    def nbytes(self) -> int:
        return cache_bytes(self.q) + cache_bytes(self.scale)

    def time_slice(self, start: int, end: int) -> "QuantSegment":
        """Token-axis sub-segment [start, end) as a copy; the bounds must
        be block multiples (they are page multiples, and the engine holds
        page % block == 0)."""
        if start % self.block or end % self.block:
            raise ValueError(
                f"quantized segment slice [{start}, {end}) is not aligned "
                f"to the quant block {self.block}")
        b = self.block
        return QuantSegment(q=_time_slice(self.q, start, end),
                            scale=_time_slice(self.scale, start // b, end // b),
                            block=b)


def _time_slice(caches: list, start: int, end: int) -> list:
    """Time span [start, end) of every tensor of a cache list, as copies."""
    return [dataclasses.replace(c, **{name: t[:, start:end].clone()
                                      for name, t in _tensors(c).items()})
            for c in caches]


def _leaves(caches: list) -> list:
    """Every tensor of a per-layer cache list, layer by layer, field by
    field (the order both lists of a store share)."""
    return [t for c in caches for t in _tensors(c).values()]


def _rebuild(caches: list, tensors) -> list:
    """`caches`' dataclasses holding `tensors` (in `_leaves` order)."""
    it = iter(tensors)
    return [dataclasses.replace(c, **{name: next(it) for name in _tensors(c)})
            for c in caches]


def _leaf_dtype(caches: list) -> torch.dtype:
    """The single compute dtype of a cache list (the dequantized views
    take one dtype)."""
    dtypes = {t.dtype for t in _leaves(caches)}
    if len(dtypes) != 1:
        raise ValueError(
            f"kv_quant needs a single cache dtype, got {sorted(map(str, dtypes))}")
    return dtypes.pop()


def make_quant_store(model, batch: int, time: int, block: int,
                     exact_lanes: int = 0,
                     exact_time: int | None = None) -> QuantStore:
    """A pool's quantized payload: int8 zeros and zero scales shaped like
    ``model.init_caches(batch, time)``, plus the exact-lane sidecar
    (``exact_lanes + 1`` full-precision lanes of `exact_time`; lane 0 is
    the trash lane). Zero scales dequantize to exact zeros, so a fresh
    quantized pool reads back as a fresh plain one. The shapes come from a
    one-block probe of `init_caches`: the full-precision pool is never
    allocated, not even for a moment."""
    probe = model.init_caches(1, block)
    dtype = _leaf_dtype(probe)
    dev = _leaves(probe)[0].device

    def full(t, dt, shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    q = _rebuild(probe, [full(t, torch.int8, (batch, time) + tuple(t.shape[2:]))
                         for t in _leaves(probe)])
    scale = _rebuild(probe, [
        full(t, torch.float32,
             scale_shape((batch, time) + tuple(t.shape[2:]), block))
        for t in _leaves(probe)])
    exact = None
    if exact_lanes > 0:
        exact = model.init_caches(exact_lanes + 1, exact_time or time)
    return QuantStore(q=q, scale=scale, exact=exact, block=block, dtype=dtype)


def quant_pool_bytes(store: QuantStore) -> tuple[int, int, int, int]:
    """(payload + scale bytes, scale bytes, exact sidecar bytes, baseline
    bytes): the analytic byte split the kv_quant gauges report.
    `baseline` is what the same pool would hold unquantized (the int8
    element count times the compute dtype's width)."""
    itemsize = torch.empty((), dtype=store.dtype).element_size()
    q_bytes = sum(t.numel() for t in _leaves(store.q))
    s_bytes = cache_bytes(store.scale)
    e_bytes = 0 if store.exact is None else cache_bytes(store.exact)
    return q_bytes + s_bytes, s_bytes, e_bytes, q_bytes * itemsize


# ------------------------------------------------------------ read helpers


def _exact_select1(lane: list, store: QuantStore, eidx: int) -> list:
    """Batch-1 exact override: a kv_exact slot (eidx > 0) reads its exact
    lane, as VIEWS of the sidecar (the model's in-place writes land there
    directly); eidx 0 keeps the dequantized view."""
    if store.exact is None or not eidx:
        return lane
    return extract_lane(store.exact, int(eidx))


def _exact_slots(eidx_row, device) -> tuple:
    """(slot index tensor, exact-lane index tensor) of the kv_exact slots
    of a host row, or None when there is none (or no row)."""
    if eidx_row is None:
        return None
    row = np.asarray(eidx_row)
    slots = np.flatnonzero(row)
    if not slots.size:
        return None
    return (torch.as_tensor(slots, dtype=torch.long, device=device),
            torch.as_tensor(row[slots], dtype=torch.long, device=device))


def _exact_select(lanes: list, store: QuantStore, eidx_row) -> list:
    """Batched exact override for the (S, ...) lane view, in place on the
    fresh view: kv_exact slots take their exact lanes."""
    if store.exact is None:
        return lanes
    sel = _exact_slots(eidx_row, _leaves(lanes)[0].device)
    if sel is None:
        return lanes
    slots, lanes_idx = sel
    for a, ex in zip(_leaves(lanes), _leaves(store.exact)):
        a[slots] = ex[lanes_idx]
    return lanes


def quant_lane_view(store: QuantStore, slot: int, eidx: int = 0) -> list:
    """Batch-1 compute-dtype lane view of a quantized LANE pool slot:
    `extract_lane` + dequantize + the exact override."""
    lane = dequantize_tree(extract_lane(store.q, slot),
                           extract_lane(store.scale, slot), store.dtype)
    return _exact_select1(lane, store, eidx)


def quant_lanes_view(store: QuantStore, eidx_row) -> list:
    """All-slot (S, max_len, ...) view of a quantized lane pool: what the
    decode block runs on."""
    lanes = dequantize_tree(store.q, store.scale, store.dtype)
    return _exact_select(lanes, store, eidx_row)


def _gather_dequant(qt: torch.Tensor, st: torch.Tensor, table: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    pages = qt[table].to(torch.float32)  # (S, PPL, page, ...)
    sc = st[table][..., None]            # (S, PPL, 1[, H], 1)
    x = (pages * sc).to(dtype)
    s, ppl, page = x.shape[:3]
    return x.reshape((s, ppl * page) + tuple(x.shape[3:]))


def quant_gather_lanes(store: QuantStore, table: torch.Tensor, eidx_row) -> list:
    """(S, max_len, ...) view of a quantized PAGE pool through the (S,
    pages_per_lane) page table: the int8 pages and their per-page scale
    rows gathered through the same table, dequantized, with the exact
    override."""
    lanes = _rebuild(store.q, [
        _gather_dequant(qt, st, table, store.dtype)
        for qt, st in zip(_leaves(store.q), _leaves(store.scale))])
    return _exact_select(lanes, store, eidx_row)


def quant_gather_lane(store: QuantStore, row: torch.Tensor, eidx: int = 0) -> list:
    """Batch-1 lane view of a quantized page pool slot through its page-
    table `row`, with the exact override."""
    lane = _rebuild(store.q, [
        _gather_dequant(qt, st, row[None], store.dtype)
        for qt, st in zip(_leaves(store.q), _leaves(store.scale))])
    return _exact_select1(lane, store, eidx)


# ----------------------------------------------------------- write helpers


def _zero_past(x: torch.Tensor, t0: int, hi) -> torch.Tensor:
    """`x` (B, T, ...) covering positions [t0, t0 + T) with positions >=
    `hi` zeroed: right-padding must never widen a block's absmax (zeros
    cannot)."""
    tcol = torch.arange(t0, t0 + x.shape[1], device=x.device)
    m = (tcol < hi).reshape((1, x.shape[1]) + (1,) * (x.ndim - 2))
    return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _store_exact(store: QuantStore, lane: list, eidx: int) -> None:
    if store.exact is not None and eidx:
        store_lane(store.exact, lane, int(eidx))


def quant_store_lane(store: QuantStore, lane: list, slot: int, eidx: int,
                     t0: int, t1: int, hi: int | None = None) -> QuantStore:
    """Quantize-on-write for a batch-1 lane (the lane prefill's store):
    requantize ONLY the written span [t0, t1) (`t0` block-aligned, since
    prefix-hit starts are page multiples and page % block == 0; `t1`
    rounds up to the block) into the slot's int8 and scale rows, and
    mirror the full-precision lane into exact lane `eidx` (a kv_exact
    slot). Blocks below `t0` hold spliced prefix codes the prefill never
    touched, and are not rewritten: that keeps the quantized prefix
    cache's contents stable under reuse. `hi` is the end of the REAL
    tokens: prompts are right-padded, and a pad activation sharing the
    tail block would inflate its absmax and coarsen the last committed
    tokens' codes, so positions past `hi` are zeroed before quantizing
    (they lie beyond `attend_len`, are never attended, and decode
    overwrites them)."""
    b = store.block
    t_max = _leaves(store.q)[0].shape[1]
    if t0 % b:
        raise ValueError(f"write start {t0} is not a multiple of the quant "
                         f"block {b}")
    t1 = min(-(-t1 // b) * b, t_max)
    for qt, st, lt in zip(_leaves(store.q), _leaves(store.scale), _leaves(lane)):
        span = lt[:, t0:t1]
        if hi is not None:
            span = _zero_past(span, t0, hi)
        qv, sv = quantize(span, b)
        qt[slot:slot + 1, t0:t1] = qv
        st[slot:slot + 1, t0 // b:t1 // b] = sv
    _store_exact(store, lane, eidx)
    return store


def quant_store_written(store: QuantStore, lanes: list, pos0: torch.Tensor,
                        span: int, eidx_row, hi: torch.Tensor | None = None,
                        tail_garbage: bool = False) -> QuantStore:
    """Quantize-on-write for the decode block's (S, max_len, ...) lane
    view: slot s wrote positions ``[pos0[s], pos0[s] + span)``, which
    touch at most ``(span - 1) // block + 2`` quant blocks; requantize
    exactly those and leave the rest of the payload as it was (a window
    clipped at the lane's end rewrites the same block with the same
    content). Within a rewritten block only the written positions take
    the lane view; the rest re-encode from their OWN f32-dequantized
    codes. That merge matters twice: on bf16 pools the lane view is a
    lossy cast, and requantizing committed entries through it would walk
    their codes step to step; and when the lane past a per-slot `hi`
    holds rejected-draft garbage (`tail_garbage=True`, the speculative
    write-back; `hi` is the committed end, default pos0 + span), leaving
    it out keeps a garbage outlier from widening the block's absmax for
    good. On f32 pools with a trustworthy tail the merge reproduces the
    lane bit for bit, so it is skipped. Each kv_exact slot's full lane
    goes to its exact lane."""
    b = store.block
    t_max = _leaves(store.q)[0].shape[1]
    nb = t_max // b
    n_slots = pos0.shape[0]
    dev = pos0.device
    rows = torch.arange(n_slots, device=dev)
    pos0 = pos0.to(torch.long)
    end = (pos0 + span) if hi is None else hi.to(torch.long)
    merge = tail_garbage or store.dtype != torch.float32
    offs = torch.arange(b, device=dev)
    for w in range((span - 1) // b + 2):
        bidx = torch.clamp(torch.div(pos0 + w * b, b, rounding_mode="floor"),
                           0, nb - 1)                         # (S,)
        tcol = bidx[:, None] * b + offs[None, :]              # (S, b)
        for qt, st, lt in zip(_leaves(store.q), _leaves(store.scale),
                              _leaves(lanes)):
            vals = lt[rows[:, None], tcol]                    # (S, b, ...)
            if merge:
                old = dequantize(qt[rows[:, None], tcol],
                                 st[rows, bidx][:, None], torch.float32)
                wr = (tcol >= pos0[:, None]) & (tcol < end[:, None])
                wr = wr.reshape(wr.shape + (1,) * (vals.ndim - 2))
                vals = torch.where(wr, vals.to(torch.float32), old)
            qv, sv = quantize(vals, b)                        # scale (S, 1[, H])
            qt[rows[:, None], tcol] = qv
            st[rows, bidx] = sv[:, 0]
    return quant_store_exact_lanes(store, lanes, eidx_row)


def quant_scatter_lane_pages(store: QuantStore, lane: list, row: torch.Tensor,
                             start_page: int, eidx: int = 0,
                             hi: int | None = None) -> QuantStore:
    """`scatter_lane_pages` for a quantized page pool (the paged
    prefill's write-back): quantize the batch-1 lane's pages
    [start_page:], one absmax scale row per (page, head), and scatter
    codes and scales to their physical ids; mirror the lane into exact
    lane `eidx`. `hi` zeroes the right-padding positions before
    quantizing, as `quant_store_lane` does."""
    ppl = row.shape[0]
    ids = row[start_page:]
    for qt, st, lt in zip(_leaves(store.q), _leaves(store.scale), _leaves(lane)):
        page = qt.shape[1]
        pages = lt.reshape((ppl, page) + tuple(lt.shape[2:]))[start_page:]
        if hi is not None:
            flat = pages.reshape((1, -1) + tuple(pages.shape[2:]))
            pages = _zero_past(flat, start_page * page, hi).reshape(pages.shape)
        qv, sv = quantize(pages, page)
        qt[ids] = qv
        st[ids] = sv
    _store_exact(store, lane, eidx)
    return store


def quant_scatter_written_pages(store: QuantStore, lanes: list,
                                table: torch.Tensor, pos: torch.Tensor,
                                lo: torch.Tensor | None = None,
                                hi: torch.Tensor | None = None,
                                tail_garbage: bool = False) -> QuantStore:
    """`scatter_written_pages` for a quantized page pool: take each slot's
    written page out of the compute-dtype lane view, quantize it (fresh
    per-(page, head) scales) and scatter codes and scale rows to the
    physical ids. `lo` / `hi` (per-slot logical positions, `hi`
    exclusive) bound the window the program wrote: positions outside it
    re-encode from their OWN f32-dequantized codes, on lossy compute
    dtypes (the bf16 drift `quant_store_written` describes) and, with
    `tail_garbage=True` (the speculative write-back), on every dtype. An
    f32 pool with a trustworthy tail skips the merge. Exact lanes are
    written once a program (`quant_store_exact_lanes`): this runs in a
    loop over page windows."""
    s, ppl = table.shape
    rows = torch.arange(s, device=table.device)
    merge = lo is not None and (tail_garbage or store.dtype != torch.float32)
    for qt, st, lt in zip(_leaves(store.q), _leaves(store.scale), _leaves(lanes)):
        page = qt.shape[1]
        pg = torch.clamp(pos.to(torch.long) // page, 0, ppl - 1)
        ids = table[rows, pg]
        pages = lt.reshape((s, ppl, page) + tuple(lt.shape[2:]))[rows, pg]
        if merge:
            tcol = pg[:, None] * page + torch.arange(page, device=pg.device)[None, :]
            old = dequantize(qt[ids], st[ids], torch.float32)
            wr = (tcol >= lo.to(torch.long)[:, None]) & (tcol < hi.to(torch.long)[:, None])
            wr = wr.reshape(wr.shape + (1,) * (pages.ndim - 2))
            pages = torch.where(wr, pages.to(torch.float32), old)
        qv, sv = quantize(pages, page)  # (S, page, ...), (S, 1[, H])
        qt[ids] = qv
        st[ids] = sv
    return store


def quant_scatter_window_pages(store: QuantStore, lanes: list,
                               table: torch.Tensor, start: torch.Tensor,
                               last: torch.Tensor, span: int) -> QuantStore:
    """The speculative decode's write-back on a quantized page pool: the
    clamped page walk of the reference's `scatter_window_pages` over the
    quantized payload. [start, last] is the committed window, whose
    positions take the lane's values; committed pages below `start` keep
    their own codes, and the stale tail past `last` keeps its old codes
    instead of rejected draws on every dtype (`tail_garbage`: a rejected
    outlier would otherwise coarsen the whole page's scale)."""
    page = _leaves(store.q)[0].shape[1]
    limit = table.shape[1] * page - 1
    last = torch.maximum(last, start)
    for w in range((span - 1) // page + 2):
        pos_w = torch.clamp(torch.minimum(start + w * page, last), 0, limit)
        store = quant_scatter_written_pages(store, lanes, table, pos_w,
                                            lo=start, hi=last + 1,
                                            tail_garbage=True)
    return store


def quant_store_exact_lanes(store: QuantStore, lanes: list,
                            eidx_row) -> QuantStore:
    """Write every kv_exact slot's full-precision lane view into its
    exact lane (the decode block's exact write-back)."""
    if store.exact is None:
        return store
    sel = _exact_slots(eidx_row, _leaves(lanes)[0].device)
    if sel is None:
        return store
    slots, lanes_idx = sel
    for ex, ln in zip(_leaves(store.exact), _leaves(lanes)):
        ex[lanes_idx] = ln[slots].to(ex.dtype)
    return store


class _SlotBook:
    """Slot bookkeeping shared by both pool layouts: a LIFO free list (the
    freshest slot is reused first) plus an O(1) membership mask for the
    double-release guard. Subclasses compose `_guard_release` and
    `_finish_release` around their own teardown."""

    def _init_slots(self, n_slots: int) -> None:
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.n_slots = n_slots
        self.positions = np.zeros(n_slots, np.int32)
        self._free = list(range(n_slots - 1, -1, -1))
        self._free_mask = np.ones(n_slots, bool)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.n_active / self.n_slots

    def acquire(self) -> int | None:
        """Claim a free slot (or None when all are taken)."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._free_mask[slot] = False
        self.positions[slot] = 0
        return slot

    def _guard_release(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        if self._free_mask[slot]:
            raise ValueError(f"slot {slot} is already free (double release)")

    def _finish_release(self, slot: int) -> None:
        self.positions[slot] = 0
        self._free.append(slot)
        self._free_mask[slot] = True


# device copies made by `KVSlotPool.splice_prefix` and `extract_prefix`,
# one a call, since the process started: the serving bench reads them
# around an arm (a paged engine shares prefix pages and makes none)
PREFIX_COPIES = {"splice": 0, "extract": 0}


class KVSlotPool(_SlotBook):
    """`n_slots` cache lanes + free-list bookkeeping.

    `caches` is the pooled per-layer cache list (batch = slot), updated in
    place by every forward. `positions[slot]` is the lane's fill level:
    prompt plus every emitted token except the newest (a sampled token's
    KV is written when it is fed back)."""

    def __init__(self, model, n_slots: int, max_len: int,
                 quant: str | None = None, quant_block: int = 16,
                 exact_lanes: int = 0):
        self._init_slots(n_slots)
        self.max_len = max_len
        self.quant = quant
        self.quant_block = quant_block
        self.exact_lanes = exact_lanes if quant else 0
        if quant:
            if max_len % quant_block:
                raise ValueError(
                    f"max_len {max_len} is not a multiple of the quant block "
                    f"{quant_block}: scale rows must tile the lane")
            self.caches = make_quant_store(model, n_slots, max_len,
                                           quant_block, exact_lanes=exact_lanes)
        else:
            self.caches = model.init_caches(n_slots, max_len)

    @property
    def nbytes(self) -> int:
        """Device bytes of every lane of the pool (quantized: int8 codes,
        scale rows and the exact lanes)."""
        if self.quant:
            pool_bytes, _, exact_bytes, _ = quant_pool_bytes(self.caches)
            return pool_bytes + exact_bytes
        return cache_bytes(self.caches)

    @property
    def token_capacity(self) -> int:
        """Cache positions the pool books: every lane's full length."""
        return self.n_slots * self.max_len

    def release(self, slot: int) -> None:
        """Return a lane to the pool; it is immediately reusable."""
        self._guard_release(slot)
        self._finish_release(slot)

    # --------------------------------------------------- prefix segments

    def _check_quant_span(self, offset: int, length: int, op: str) -> None:
        b = self.quant_block
        if offset % b or length % b:
            raise ValueError(
                f"{op}: span [{offset}, {offset + length}) is not aligned to "
                f"the quant block {b}: quantized segments carry whole scale "
                "rows")

    def splice_prefix(self, slot: int, segment, offset: int = 0) -> None:
        """Copy a cached batch-1 prefix `segment` into lane `slot` at time
        offset `offset` (the lane owns the copy). Runs before the suffix
        prefill that continues at ``offset + segment length``. A quantized
        pool splices `QuantSegment`s only: their codes land at `offset`
        and their scale rows at ``offset // quant_block``, so the spliced
        bytes are the producer's (no dequantize and requantize)."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        if self.quant:
            if not isinstance(segment, QuantSegment):
                raise TypeError(
                    "a quantized pool splices QuantSegment payloads, got a "
                    f"{type(segment).__name__}: the prefix cache and the pool "
                    "must agree on kv_quant")
            length = segment.length
        else:
            length = segment_length(segment)
        if offset < 0 or offset + length > self.max_len:
            raise ValueError(
                f"segment span [{offset}, {offset + length}) exceeds the "
                f"lane capacity {self.max_len}"
            )
        if self.quant:
            self._check_quant_span(offset, length, "splice_prefix")
            b = self.quant_block
            pairs = [(self.caches.q, segment.q, offset, length),
                     (self.caches.scale, segment.scale, offset // b, length // b)]
        else:
            pairs = [(self.caches, segment, offset, length)]
        for pool, seg, off, n in pairs:
            for pool_t, seg_t in zip(_leaves(pool), _leaves(seg)):
                if seg_t.dtype != pool_t.dtype:
                    raise TypeError(
                        f"splice_prefix: segment dtype {seg_t.dtype} != pool "
                        f"dtype {pool_t.dtype}; implicit casts are not "
                        "performed"
                    )
                pool_t[slot:slot + 1, off:off + n].copy_(seg_t)
        PREFIX_COPIES["splice"] += 1

    def extract_prefix(self, slot: int, offset: int, length: int) -> list:
        """Lane `slot`'s span [offset, offset + length) as an independent
        batch-1 segment: a copy, so the next prefill into the lane (or
        its release) leaves the segment as it was."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        if offset < 0 or length < 1 or offset + length > self.max_len:
            raise ValueError(
                f"extract span [{offset}, {offset + length}) exceeds the "
                f"lane capacity {self.max_len}"
            )
        PREFIX_COPIES["extract"] += 1
        if self.quant:
            # the int8 span and its scale rows: half the copy (and tree
            # budget) bytes of a bf16 segment
            self._check_quant_span(offset, length, "extract_prefix")
            b = self.quant_block
            return QuantSegment(
                q=_time_slice(extract_lane(self.caches.q, slot), offset,
                              offset + length),
                scale=_time_slice(extract_lane(self.caches.scale, slot),
                                  offset // b, (offset + length) // b),
                block=b)
        return _time_slice(extract_lane(self.caches, slot), offset,
                           offset + length)


def cache_bytes(caches: list) -> int:
    """Device bytes held by every tensor of a per-layer cache list."""
    return sum(t.numel() * t.element_size()
               for c in caches for t in _tensors(c).values())


def segment_length(segment: list) -> int:
    """Time length (axis 1) of a batch-1 segment of per-layer caches."""
    return next(iter(_tensors(segment[0]).values())).shape[1]


# ======================================================================
# Paged pool: block-paged cache lanes + refcounted zero-copy sharing
# ======================================================================
#
# The lane pool above books `max_len` positions per engine slot: memory
# reserved for the worst case, the slot count tied to the longest
# sequence, and every prefix hit paying a device copy (splice).
# `PagedKVPool` is the paged layout instead: ONE physical pool of fixed-
# size KV blocks ("pages"), carved from `model.init_caches(n_pages,
# page_size)` so the batch dimension IS the page id, plus a host-side
# per-slot page table mapping logical page index -> physical page id.
# The engine's paged programs translate logical -> physical with a
# gather (`gather_lanes`) that materializes the familiar (S, max_len,
# ...) lane view, run the models UNMODIFIED on it, and scatter only the
# written page(s) back, so every family serves paged with no model
# change.
#
# Sharing: the radix prefix cache holds PHYSICAL PAGE IDS with refcounts
# instead of snapshot copies. A prefix hit is a host-side page-table
# append + incref (no device copy), and inserting a freshly prefilled
# prompt is an incref of the slot's own fully-filled pages. Sound because
# cached pages are never rewritten by their producer: the engine caches
# prompt positions [0, aligned) with aligned <= len(prompt) - 1 page-
# aligned, the owning slot's later writes land at positions >=
# len(prompt), in pages strictly AFTER every cached one; decode scatters
# only the pages of its write window and prefill only the pages >= the
# (page-aligned) match length. A shared page is immutable while anything
# references it.
#
# Page 0 is a reserved TRASH page, never allocated: page-table entries
# beyond a slot's allocation (and every entry of an idle slot) point at
# it, so gathers always read valid (finite, masked-away) memory and
# masked dummy writes or discarded overshoot land there. The stale-data
# contract is the lane pool's, per page.
#
# The helpers below are plain tensor ops over every field of every
# layer's cache (the reference's are traced jnp). Their scatters write
# with `index_put_`, whose winner among duplicate indices is undefined on
# CUDA: duplicates only ever hit the trash page, where garbage overwrites
# garbage.


def gather_lanes(phys: list, table: torch.Tensor) -> list:
    """Logical lane view of the physical pool: `table` is the (S,
    pages_per_lane) page-table block (a long tensor on the pool's
    device); returns fresh (S, max_len, ...) caches, one gather per
    field."""
    s, ppl = table.shape

    def g(t):
        pages = t[table]  # (S, PPL, page, ...)
        return pages.reshape((s, ppl * t.shape[1]) + t.shape[2:])

    return [dataclasses.replace(c, **{name: g(t) for name, t in _tensors(c).items()})
            for c in phys]


def gather_lane(phys: list, row: torch.Tensor) -> list:
    """Batch-1 lane view of one slot: `row` is its (pages_per_lane,) page-
    table row."""
    return gather_lanes(phys, row[None])


def scatter_lane_pages(phys: list, lane: list, row: torch.Tensor,
                       start_page: int) -> list:
    """Write a batch-1 lane's pages [start_page:] back to the pool at
    ``row[start_page:]``, in place. Pages below `start_page` are left
    alone: on a prefix hit they are shared pages the prefill never wrote,
    and not rewriting them is what makes the hit zero-copy. Unallocated
    tail entries point at the trash page."""
    ppl = row.shape[0]
    ids = row[start_page:]
    for p, l in zip(phys, lane):
        lane_ts = _tensors(l)
        for name, p_t in _tensors(p).items():
            pages = lane_ts[name].reshape((ppl, p_t.shape[1]) + p_t.shape[2:])
            p_t[ids] = pages[start_page:]
    return phys


def scatter_written_pages(phys: list, lanes: list, table: torch.Tensor,
                          pos: torch.Tensor) -> list:
    """Per-slot single-page write-back, in place: slot s wrote position
    ``pos[s]`` of its gathered lane, so its page ``pos[s] // page`` (clamped
    into the lane) goes to its physical id. Active slots' write pages are
    owned by them alone (shared pages precede the write frontier), so the
    ids collide only on the trash page."""
    s, ppl = table.shape
    rows = torch.arange(s, device=table.device)
    for p, l in zip(phys, lanes):
        lane_ts = _tensors(l)
        for name, p_t in _tensors(p).items():
            page = p_t.shape[1]
            pg = torch.clamp(pos.to(torch.long) // page, 0, ppl - 1)
            ids = table[rows, pg]
            pages = lane_ts[name].reshape((s, ppl, page) + p_t.shape[2:])
            p_t[ids] = pages[rows, pg]
    return phys


def scatter_window_pages(phys: list, lanes: list, table: torch.Tensor,
                         start: torch.Tensor, last: torch.Tensor,
                         span: int) -> list:
    """The speculative decode block's write-back, in place: slot s
    committed positions ``[start[s], last[s]]`` of its gathered lane view
    (``last`` the final committed position), so only the pages of that
    window go to the pool; rejected-draft garbage past it never reaches
    the physical pool. `span` is the static bound of the window in tokens
    (rounds x chunk width); the page walk advances in page steps clamped
    to ``last``, so trailing steps rewrite the last committed page with
    its own content. Slots with nothing committed (``last < start``, idle
    lanes) clamp to `start`, whose table entry rests at the trash page."""
    page = _leaves(phys)[0].shape[1]
    limit = table.shape[1] * page - 1
    last = torch.maximum(last, start)
    for w in range((span - 1) // page + 2):
        pos_w = torch.clamp(torch.minimum(start + w * page, last), 0, limit)
        phys = scatter_written_pages(phys, lanes, table, pos_w)
    return phys


TRASH_PAGE = 0  # physical page 0: reserved write sink, never allocated


def scrub_pages(phys, page_ids, eidx: int = 0) -> None:
    """Zero physical pages `page_ids` in every tensor of every layer's
    cache, in place (the paged twin of `scrub_lane`). The engine passes a
    poisoned slot's own pages (refcount 1) and the trash page: shared
    prefix pages hold KV written before the poisoned step, while the
    slot's masked overshoot lands in the trash page, which every idle
    slot's table points at. On a `QuantStore` the pages' codes and scale
    rows are zeroed, and so is exact lane `eidx`."""
    if isinstance(phys, QuantStore):
        if phys.exact is not None:
            for t in _leaves(phys.exact):
                t[int(eidx)].zero_()
        tensors = _leaves(phys.q) + _leaves(phys.scale)
    else:
        tensors = _leaves(phys)
    if not len(page_ids):
        return
    idx = torch.as_tensor(list(page_ids), dtype=torch.long,
                          device=tensors[0].device)
    for t in tensors:
        t.index_fill_(0, idx, 0)


class PagedKVPool(_SlotBook):
    """Block-paged KV pool: `page_budget` allocatable fixed-size pages +
    per-slot page tables + refcounts (host-side bookkeeping; the device
    side is the gather/scatter helpers above).

    `phys` is the physical cache list, ``model.init_caches(page_budget +
    1, page_size)`` (batch = page id, page 0 the trash page), and is
    never reallocated: `nbytes` is constant for the pool's lifetime.
    `table` is the (n_slots, pages_per_lane) int64 page-table mirror the
    engine ships to the device with its other control values; entries
    [0, n_alloc[slot]) are live (refcounted), the rest rest at the trash
    page.

    Refcounts: a freshly `ensure`d page starts at 1; every further holder
    (a slot appending shared prefix pages with `append_shared`, the radix
    tree taking a reference with `share_range`) increfs; `release` and
    `decref` decrement, and a page returns to the free list at zero. The
    tree and the slots are symmetric holders: either can outlive the
    other.

    `positions[slot]` keeps the lane pool's fill-level meaning.
    """

    def __init__(self, model, n_slots: int, max_len: int, page_size: int,
                 page_budget: int | None = None, quant: str | None = None,
                 exact_lanes: int = 0):
        self._init_slots(n_slots)
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_len % page_size:
            raise ValueError(
                f"max_len {max_len} is not a multiple of page_size "
                f"{page_size}: page tables need whole pages per lane"
            )
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_lane = max_len // page_size
        if page_budget is None:
            # lane-pool-equivalent capacity: every slot can hold a full
            # lane at once
            page_budget = n_slots * self.pages_per_lane
        if page_budget < self.pages_per_lane:
            raise ValueError(
                f"page_budget {page_budget} cannot cover even one full "
                f"lane ({self.pages_per_lane} pages): a single max-length "
                "request could never be scheduled"
            )
        self.page_budget = page_budget
        self.n_pages = page_budget + 1  # + the trash page
        self.quant = quant
        self.quant_block = page_size  # one scale row per (page, head)
        self.exact_lanes = exact_lanes if quant else 0
        if quant:
            # exact lanes are LANE-shaped (max_len): a kv_exact stream owns
            # no pages, its table row rests at the trash page
            self.phys = make_quant_store(model, self.n_pages, page_size,
                                         page_size, exact_lanes=exact_lanes,
                                         exact_time=max_len)
        else:
            self.phys = model.init_caches(self.n_pages, page_size)
        self.table = np.full((n_slots, self.pages_per_lane), TRASH_PAGE,
                             np.int64)
        self.n_alloc = np.zeros(n_slots, np.int64)
        self.refcount = np.zeros(self.n_pages, np.int64)
        self.refcount[TRASH_PAGE] = 1  # permanently held, never freed
        # LIFO free list: recently freed pages are reused first
        self._free_pages = list(range(self.n_pages - 1, TRASH_PAGE, -1))

    # ------------------------------------------------------------ gauges

    @property
    def nbytes(self) -> int:
        """Device bytes of the physical pool, constant by construction
        (quantized: codes, scale rows and the exact lanes)."""
        if self.quant:
            pool_bytes, _, exact_bytes, _ = quant_pool_bytes(self.phys)
            return pool_bytes + exact_bytes
        return cache_bytes(self.phys)

    @property
    def page_nbytes(self) -> int:
        """Device bytes one page holds across every cache field: what a
        radix-tree page reference costs in the prefix cache's budget
        (quantized: its codes and scale rows; the exact lanes are no
        page's)."""
        if self.quant:
            return quant_pool_bytes(self.phys)[0] // self.n_pages
        return self.nbytes // self.n_pages

    @property
    def token_capacity(self) -> int:
        """Allocatable cache positions: every budgeted page, trash
        excluded."""
        return self.page_budget * self.page_size

    @property
    def pages_free(self) -> int:
        return len(self._free_pages)

    @property
    def pages_active(self) -> int:
        return self.page_budget - len(self._free_pages)

    @property
    def fragmentation(self) -> float:
        """Internal fragmentation: the fraction of slot-allocated page
        capacity not (yet) holding live KV (decode reservations and
        trailing-page slack); 0.0 with nothing allocated."""
        alloc_tokens = int(self.n_alloc.sum()) * self.page_size
        if alloc_tokens == 0:
            return 0.0
        used = int(np.minimum(self.positions,
                              self.n_alloc * self.page_size).sum())
        return 1.0 - used / alloc_tokens

    # ------------------------------------------------------------- slots
    #
    # acquire() is the shared _SlotBook one: pages are not reserved at
    # acquire; `append_shared` and `ensure` fill the table as the
    # request's footprint becomes known.

    def release(self, slot: int) -> None:
        """Free a slot: decref every table entry it holds (owned pages free
        at once, shared ones survive under their other holders) and park
        the row at the trash page."""
        self._guard_release(slot)
        n = int(self.n_alloc[slot])
        self.decref(self.table[slot, :n].tolist())
        self.table[slot, :n] = TRASH_PAGE
        self.n_alloc[slot] = 0
        self._finish_release(slot)

    # ------------------------------------------------------------- pages

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to cover token positions [0, n_tokens)."""
        return -(-n_tokens // self.page_size)

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow `slot`'s table to cover positions [0, n_tokens) with
        freshly owned pages. False when the free list runs dry: the
        allocation KEEPS what it got (the caller reclaims, by prefix-tree
        eviction and then preemption, and retries). Shared prefix pages
        must be appended first: `ensure` only extends the tail."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        target = self.pages_for(min(n_tokens, self.max_len))
        while int(self.n_alloc[slot]) < target:
            if not self._free_pages:
                return False
            pid = self._free_pages.pop()
            self.refcount[pid] = 1
            self.table[slot, self.n_alloc[slot]] = pid
            self.n_alloc[slot] += 1
        return True

    def append_shared(self, slot: int, page_ids) -> None:
        """Zero-copy prefix hit: extend `slot`'s page table with already
        populated shared pages (incref'd; the radix tree keeps its own
        references). Precedes any `ensure` for the slot: shared prefix
        pages are the lane's leading pages."""
        if not page_ids:
            return
        n = int(self.n_alloc[slot])
        if n + len(page_ids) > self.pages_per_lane:
            raise ValueError(
                f"shared append of {len(page_ids)} pages at table offset "
                f"{n} exceeds the lane capacity {self.pages_per_lane}"
            )
        for pid in page_ids:
            if not TRASH_PAGE < pid < self.n_pages:
                raise ValueError(f"page id {pid} out of range")
        self.incref(page_ids)
        self.table[slot, n:n + len(page_ids)] = page_ids
        self.n_alloc[slot] += len(page_ids)

    def share_range(self, slot: int, offset: int, length: int) -> list[int]:
        """Take references on the pages covering `slot`'s token span
        [offset, offset + length), a page-aligned span: the prefix
        cache's insert path (the lane pool's `extract_prefix`, without the
        device copy). The returned ids are INCREF'D: the caller owns one
        reference a page and drops them with `decref`."""
        if offset % self.page_size or length % self.page_size:
            raise ValueError(
                f"share span [{offset}, {offset + length}) is not "
                f"page-aligned (page_size {self.page_size})"
            )
        if length < 1:
            raise ValueError(f"length must be >= 1, got {length}")
        first = offset // self.page_size
        last = (offset + length) // self.page_size
        if last > int(self.n_alloc[slot]):
            raise ValueError(
                f"share span [{offset}, {offset + length}) exceeds slot "
                f"{slot}'s allocated coverage "
                f"{int(self.n_alloc[slot]) * self.page_size}"
            )
        ids = self.table[slot, first:last].tolist()
        self.incref(ids)
        return ids

    def incref(self, page_ids) -> None:
        """Take one reference an id, element by element (a numpy fancy-
        index ``+= 1`` would under-count duplicate ids)."""
        for pid in page_ids:
            if self.refcount[pid] < 1:
                raise ValueError(f"page {pid} is free: cannot incref")
        for pid in page_ids:
            self.refcount[pid] += 1

    def decref(self, page_ids) -> None:
        """Drop one reference an id; pages reaching zero return to the
        free list (LIFO). Over-release raises: a negative count would
        mean a page was freed while someone still held it."""
        for pid in page_ids:
            if pid == TRASH_PAGE:
                raise ValueError("the trash page is never released")
            if self.refcount[pid] < 1:
                raise ValueError(
                    f"page {pid} over-released (refcount already 0)"
                )
            self.refcount[pid] -= 1
            if self.refcount[pid] == 0:
                self._free_pages.append(pid)
