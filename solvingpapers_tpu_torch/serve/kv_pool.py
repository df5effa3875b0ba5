"""KV cache pools for the serving engine (port of
`solvingpapers_tpu/serve/kv_pool.py` without its quantized store): the
contiguous lane pool (`KVSlotPool`, with the prefix cache's splice and
extract) and the block-paged pool (`PagedKVPool`, second half of this
module).

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


def scrub_lane(caches: list, slot: int) -> None:
    """Zero slot `slot`'s lane in every tensor of every layer's cache, in
    place: the quarantine of a poisoned slot. Masked attention gives a
    stale FINITE value probability 0, but ``0 * NaN`` is NaN, so a
    non-finite value left in the lane would reach its next occupant."""
    for c in caches:
        for t in _tensors(c).values():
            t[slot].zero_()


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

    def __init__(self, model, n_slots: int, max_len: int):
        self._init_slots(n_slots)
        self.max_len = max_len
        self.caches = model.init_caches(n_slots, max_len)

    @property
    def nbytes(self) -> int:
        """Device bytes of every lane of the pool."""
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

    def splice_prefix(self, slot: int, segment: list, offset: int = 0) -> None:
        """Copy a cached batch-1 prefix `segment` into lane `slot` at time
        offset `offset` (the lane owns the copy). Runs before the suffix
        prefill that continues at ``offset + segment length``."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        length = segment_length(segment)
        if offset < 0 or offset + length > self.max_len:
            raise ValueError(
                f"segment span [{offset}, {offset + length}) exceeds the "
                f"lane capacity {self.max_len}"
            )
        for c, seg in zip(self.caches, segment):
            seg_ts = _tensors(seg)
            for name, pool_t in _tensors(c).items():
                seg_t = seg_ts[name]
                if seg_t.dtype != pool_t.dtype:
                    raise TypeError(
                        f"splice_prefix: segment dtype {seg_t.dtype} != pool "
                        f"dtype {pool_t.dtype}; implicit casts are not "
                        "performed"
                    )
                pool_t[slot:slot + 1, offset:offset + length].copy_(seg_t)
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
        return [dataclasses.replace(c, **{
                    name: t[slot:slot + 1, offset:offset + length].clone()
                    for name, t in _tensors(c).items()})
                for c in self.caches]


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


TRASH_PAGE = 0  # physical page 0: reserved write sink, never allocated


def scrub_pages(phys: list, page_ids) -> None:
    """Zero physical pages `page_ids` in every tensor of every layer's
    cache, in place (the paged twin of `scrub_lane`). The engine passes a
    poisoned slot's own pages (refcount 1) and the trash page: shared
    prefix pages hold KV written before the poisoned step, while the
    slot's masked overshoot lands in the trash page, which every idle
    slot's table points at."""
    if not len(page_ids):
        return
    dev = next(iter(_tensors(phys[0]).values())).device
    idx = torch.as_tensor(list(page_ids), dtype=torch.long, device=dev)
    for p in phys:
        for t in _tensors(p).values():
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
                 page_budget: int | None = None):
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
        """Device bytes of the physical pool, constant by construction."""
        return cache_bytes(self.phys)

    @property
    def page_nbytes(self) -> int:
        """Device bytes one page holds across every cache field: what a
        radix-tree page reference costs in the prefix cache's budget."""
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
