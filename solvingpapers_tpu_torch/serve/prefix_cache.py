"""Host-side radix tree over token-id prefixes with device-resident KV
segments: cross-request prefix reuse for the serving engine (port of
`solvingpapers_tpu/serve/prefix_cache.py`).

A radix tree keyed by token ids whose nodes own batch-1 KV/latent
segments (per-layer cache lists as `model.init_caches(1, seg_len)` would
make them, sliced along the time axis), so a new request's matched
prefix is SPLICED into its lane (`KVSlotPool.splice_prefix`) instead of
prefilled: the RadixAttention idea (SGLang), on a lane-granular pool.

Exactness: cached K/V for a token at absolute position p depends only on
the token ids at positions <= p, so a segment produced by an earlier
request with the same prefix is the computation the lane would have run
itself. The engine never caches a prompt's final token (the suffix
prefill must produce at least one logits row to sample from).

Page granularity: all edges and match lengths are multiples of `page`,
so node splits are aligned and never cut a segment at an arbitrary
offset mid-walk.

Quantized lane pools (`ServeConfig.kv_quant`): segments are
`QuantSegment`s, int8 codes and their scale rows, kept quantized at rest
(about half a bf16 segment's budget for the same tokens); their slices
cut codes and scale rows together, at page multiples that the engine
holds to be quant-block multiples.

Memory: with the lane pool, segments are COPIES (snapshotted out of a
lane after prefill by `extract_fn`), accounted against `max_bytes`; LRU
leaves are evicted once the budget is exceeded. `refcount` pins a
matched path while its splice is in flight: a pinned node (or any
ancestor of one; `_split` keeps the invariant) is never evicted.

Paged pools (`PrefixCache(pool=PagedKVPool)`): nodes hold PHYSICAL PAGE
IDS with refcounts instead of device copies. `extract_fn` then returns
incref'd page ids (`PagedKVPool.share_range`, a host-side refcount bump),
a hit appends those ids to the acquiring slot's page table
(`append_shared`, no copy either), splits are list splits, and eviction
decrefs (the page frees only when no slot still references it, so
eviction can never corrupt an in-flight stream). `max_bytes` then bounds
how much of the fixed physical pool the tree may keep pinned away from
the allocator.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np

from solvingpapers_tpu_torch.serve.kv_pool import (
    QuantSegment,
    _time_slice,
    cache_bytes,
)
from solvingpapers_tpu_torch.serve.kv_pool import segment_length as _plain_length


def segment_bytes(segment) -> int:
    """Device bytes held by a batch-1 segment (a per-layer cache list; a
    `QuantSegment` counts its int8 codes and scale rows)."""
    if isinstance(segment, QuantSegment):
        return segment.nbytes
    return cache_bytes(segment)


def segment_length(segment) -> int:
    """Time-axis length of a batch-1 segment."""
    if isinstance(segment, QuantSegment):
        return segment.length
    return _plain_length(segment)


def slice_segment(segment, start: int, end: int):
    """Time-axis sub-segment [start, end) as a copy (static bounds). A
    quantized segment slices codes and scale rows together (the bounds
    are page multiples, pages are quant-block multiples)."""
    if isinstance(segment, QuantSegment):
        return segment.time_slice(start, end)
    return _time_slice(segment, start, end)


class _Segment:
    """Lane-pool node payload: an OWNED batch-1 device segment (a copy
    snapshotted out of a lane). Released by garbage collection: nothing
    else references its tensors."""

    __slots__ = ("segment",)

    def __init__(self, segment):
        self.segment = segment

    @property
    def nbytes(self) -> int:
        return segment_bytes(self.segment)

    def split(self, k: int):
        """(upper payload of tokens [0, k), lower of [k, n)): both halves
        are independent copies of their spans."""
        n = segment_length(self.segment)
        return (_Segment(slice_segment(self.segment, 0, k)),
                _Segment(slice_segment(self.segment, k, n)))

    def release(self) -> None:
        pass  # dropping the reference frees the device buffers


class _PageRun:
    """Paged-pool node payload: a run of REFERENCED physical page ids
    (one tree-held refcount each, taken by `PagedKVPool.share_range`).
    Zero device bytes of its own: `nbytes` is the pool bytes the run
    keeps pinned, which is what the LRU budget accounts."""

    __slots__ = ("pages", "pool")

    def __init__(self, pages: list, pool):
        self.pages = list(pages)
        self.pool = pool

    @property
    def nbytes(self) -> int:
        return len(self.pages) * self.pool.page_nbytes

    def split(self, k: int):
        """List split at the page boundary: no device work, no refcount
        change; the run's references are distributed, not duplicated
        (each half releases only its own ids)."""
        kp = k // self.pool.page_size
        return (_PageRun(self.pages[:kp], self.pool),
                _PageRun(self.pages[kp:], self.pool))

    def release(self) -> None:
        self.pool.decref(self.pages)
        self.pages = []


class _Node:
    """One radix edge: `tokens` (page-multiple id array) + the payload
    holding their KV (`_Segment` copy or `_PageRun` references), rooted
    at absolute prefix offset = sum of ancestor edge lengths.

    `children` is keyed by the child edge's FIRST PAGE (`tokens[:page]`
    as bytes), not its first token: matches only ever advance in whole
    pages, so the next page is the exact lookup unit — and siblings that
    diverge mid-page (different pages, same first token) can coexist,
    which single-token keys would force into collision.

    `parent` is held weakly (a node lives while its parent's `children`
    holds it): parent and child links would otherwise form cycles that
    keep a dropped tree's device payloads, and for the paged pool the
    pool itself, allocated until a full collection."""

    __slots__ = ("tokens", "payload", "children", "_parent", "refcount",
                 "stamp", "nbytes", "__weakref__")

    def __init__(self, tokens: np.ndarray, payload, parent: "_Node | None"):
        self.tokens = tokens
        self.payload = payload
        self.children: dict[bytes, _Node] = {}
        self.parent = parent
        self.refcount = 0
        self.stamp = 0
        self.nbytes = 0 if payload is None else payload.nbytes

    @property
    def parent(self) -> "_Node | None":
        return None if self._parent is None else self._parent()

    @parent.setter
    def parent(self, node: "_Node | None") -> None:
        self._parent = None if node is None else weakref.ref(node)

    @property
    def length(self) -> int:
        return int(self.tokens.size)

    @property
    def segment(self) -> object:
        """The device segment (lane-pool payloads) — what the engine
        splices; kept as the node's public face for that path."""
        return self.payload.segment

    @property
    def pages(self) -> list:
        """The physical page ids (paged-pool payloads) — what the engine
        appends to a hitting slot's page table."""
        return self.payload.pages


@dataclasses.dataclass
class PrefixMatch:
    """Result of `PrefixCache.match`: the root->leaf node path covering
    `length` tokens (edge lengths sum to `length`). Pin protects the path
    from EVICTION only; `nodes`' identities/segments are only valid until
    the next match/insert (either can split an edge and re-slice its
    segment) — splice immediately after matching, as the engine does."""

    nodes: list
    length: int


class PrefixCache:
    """Radix tree + LRU byte-budget eviction + refcount pinning.

    `pool=None` (lane pools): nodes own segment copies and `extract_fn`
    returns batch-1 segment pytrees. With a `PagedKVPool` bound, nodes
    hold refcounted page-id runs and `extract_fn` must return incref'd
    page ids (the engine binds `pool.share_range`); `page` must then
    equal the pool's `page_size` so tree edges and physical pages stay
    aligned (splits never have to cut a page)."""

    def __init__(self, page: int = 16, max_bytes: int = 64 << 20,
                 pool=None, trace=None):
        if page < 1:
            raise ValueError(f"page must be >= 1, got {page}")
        if max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        if pool is not None and pool.page_size != page:
            raise ValueError(
                f"tree page {page} != pool page_size {pool.page_size}: "
                "page-id sharing needs tree edges aligned to physical "
                "pages"
            )
        self.page = page
        self.max_bytes = max_bytes
        self.pool = pool
        # the engine's metrics.trace.FlightRecorder, or None (tracing off)
        self.trace = trace
        self.root = _Node(np.zeros(0, np.int32), None, None)
        self.evictions = 0
        self.bytes_held = 0
        self._clock = 0

    # ------------------------------------------------------------ queries

    @property
    def n_nodes(self) -> int:
        return sum(1 for _ in self._walk()) - 1  # exclude root

    def stats(self) -> dict:
        """Host-side snapshot of the tree's shape and byte accounting."""
        return {
            "nodes": self.n_nodes,
            "bytes_held": self.bytes_held,
            "max_bytes": self.max_bytes,
            "evictions": self.evictions,
            "page": self.page,
        }

    def _walk(self):
        stack = [self.root]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _key(self, tokens: np.ndarray, i: int = 0) -> bytes:
        return tokens[i:i + self.page].tobytes()

    def _common(self, edge: np.ndarray, tokens: np.ndarray, i: int) -> int:
        n = min(edge.size, tokens.size - i)
        neq = np.flatnonzero(edge[:n] != tokens[i:i + n])
        return n if neq.size == 0 else int(neq[0])

    def peek(self, tokens) -> int:
        """Read-only match length (page-aligned); no LRU touch, no splits.
        What the prefix-aware scheduler calls per queued request."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        node, i = self.root, 0
        while tokens.size - i >= self.page:
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            common = self._common(child.tokens, tokens, i)
            if common == child.tokens.size:
                i += common
                node = child
                continue
            i += common // self.page * self.page
            break
        return i

    def match(self, tokens, _trace: bool = True) -> PrefixMatch:
        """Longest page-aligned cached prefix of `tokens`.

        Touches the matched path's LRU stamps and splits a partially
        matched edge at the page-aligned common length, so every returned
        node is usable whole — splice `match.nodes` in order at offsets
        accumulating each node's `length`.
        """
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        node, i, path = self.root, 0, []
        while tokens.size - i >= self.page:
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            common = self._common(child.tokens, tokens, i)
            if common == child.tokens.size:
                path.append(child)
                i += common
                node = child
                continue
            aligned = common // self.page * self.page
            if aligned > 0:
                path.append(self._split(child, aligned))
                i += aligned
            break
        stamp = self._tick()
        for nd in path:
            nd.stamp = stamp
        if self.trace is not None and _trace:
            # insert()'s own re-match passes _trace=False: the trace's
            # lookups are the admission-time ones only
            self.trace.instant(
                "prefix_lookup", "prefix", "prefix",
                matched=i, pages=i // self.page,
                hit=int(i > 0), prompt_len=int(tokens.size),
            )
        return PrefixMatch(nodes=path, length=i)

    # ---------------------------------------------------------- mutation

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _split(self, node: _Node, k: int) -> _Node:
        """Split `node`'s edge at page-aligned k: a new upper node takes
        tokens[:k]; `node` (keeping its children, segment tail, and its
        own refcount) becomes the lower part. Returns the upper node.
        The upper needs no refcount of its own: eviction only ever takes
        CHILDLESS leaves, and the pinned lower is its child — so a pinned
        path stays eviction-safe across splits without the upper carrying
        a count that no `unpin` would ever drop."""
        assert 0 < k < node.tokens.size and k % self.page == 0
        old_bytes = node.nbytes
        up_payload, lo_payload = node.payload.split(k)
        upper = _Node(node.tokens[:k].copy(), up_payload, node.parent)
        upper.stamp = node.stamp
        node.parent.children[self._key(upper.tokens)] = upper
        node.payload = lo_payload
        node.tokens = node.tokens[k:].copy()
        node.nbytes = lo_payload.nbytes
        node.parent = upper
        upper.children[self._key(node.tokens)] = node
        self.bytes_held += upper.nbytes + node.nbytes - old_bytes
        return upper

    def pin(self, match: PrefixMatch) -> None:
        """Protect every node on the matched path from eviction until
        `unpin` — call immediately after `match`, before any other tree
        mutation can restructure the path."""
        for node in match.nodes:
            node.refcount += 1

    def unpin(self, match: PrefixMatch) -> None:
        for node in match.nodes:
            node.refcount -= 1

    def insert(self, tokens, extract_fn) -> int:
        """Cache `tokens` (length must be a page multiple); the portion
        not already in the tree is captured via ``extract_fn(offset,
        length)`` (offset/length in token positions within the prompt).
        With a lane pool that returns a snapshot segment (the engine
        binds `KVSlotPool.extract_prefix`, a device copy); with a paged
        pool it returns incref'd page ids (`PagedKVPool.share_range`, no
        device work; insert lengths are page multiples by contract, so no
        partial page is ever shared). Returns the number of NEW tokens cached.
        May evict LRU leaves to respect `max_bytes`.
        """
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size % self.page:
            raise ValueError(
                f"insert length {tokens.size} is not a multiple of the "
                f"page size {self.page}"
            )
        if tokens.size == 0:
            return 0
        m = self.match(tokens, _trace=False)
        rem = tokens[m.length:]
        if rem.size == 0:
            return 0
        parent = m.nodes[-1] if m.nodes else self.root
        # page-keyed children make a collision structurally impossible: an
        # existing child with rem's first page would have matched (and the
        # match advanced past it). Defensive first-come-wins regardless —
        # overwriting would orphan a subtree and leak its byte accounting.
        if self._key(rem) in parent.children:
            return 0
        raw = extract_fn(m.length, int(rem.size))
        payload = (_PageRun(raw, self.pool) if self.pool is not None
                   else _Segment(raw))
        node = _Node(rem.copy(), payload, parent)
        node.stamp = self._tick()
        parent.children[self._key(rem)] = node
        self.bytes_held += node.nbytes
        if self.trace is not None:
            self.trace.instant(
                "prefix_snapshot", "prefix", "prefix",
                new_tokens=int(rem.size), pages=int(rem.size) // self.page,
                nbytes=node.nbytes, held=self.bytes_held,
            )
        self._evict_to_budget()
        return int(rem.size)

    def evict_one(self) -> bool:
        """Evict the LRU unpinned childless leaf unconditionally (the
        paged engine's page-pressure reclaim: shedding tree references
        is always preferable to preempting a live request). False when
        everything left is pinned or interior — the tree cannot help."""
        victim = None
        for node in self._walk():
            if node is self.root or node.children or node.refcount > 0:
                continue
            if victim is None or node.stamp < victim.stamp:
                victim = node
        if victim is None:
            return False
        del victim.parent.children[self._key(victim.tokens)]
        self.bytes_held -= victim.nbytes
        self.evictions += 1
        freed = victim.nbytes
        victim.payload.release()
        if self.trace is not None:
            self.trace.instant(
                "prefix_evict", "prefix", "prefix",
                tokens=victim.length, freed=freed, held=self.bytes_held,
            )
        return True

    def _evict_to_budget(self) -> None:
        """Drop LRU unpinned leaves until under budget. Interior nodes
        become evictable once their children go; pinned nodes never do."""
        while self.bytes_held > self.max_bytes:
            if not self.evict_one():
                return  # everything left is pinned or interior
