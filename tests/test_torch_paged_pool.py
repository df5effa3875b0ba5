"""The port's paged KV pool (`solvingpapers_tpu_torch/serve/kv_pool.py`
`PagedKVPool` and its gather/scatter helpers) and the paged engine paths
of `serve/engine.py`, against the JAX package's.

Three contracts, as the reference's `tests/test_paged_pool.py` holds
them. Allocator: page tables, refcounted sharing and the free list
balance under any interleaving of acquire / ensure / share / release (a
randomized soak against a shadow refcount model): no leaked page, the
free list exactly the zero-refcount pages, and the physical pool never
grows. Helpers: `gather_lanes`, `gather_lane`, `scatter_lane_pages` and
`scatter_written_pages` equal the JAX functions bit for bit on the same
numpy pools and tables (float32 `KVCache` and `LatentCache` layers); no
non-trash page id repeats inside one scatter (asserted on the host,
since `index_put_` on CUDA picks an undefined winner among duplicates).
Engine: greedy streams through the paged pool are token-exact with the
port's and the JAX package's `generate`, across a preemption by
recompute too; a seeded stream survives its preemption; more slots run
than lane-equivalent memory would seat; tree-hoarded pages never
livelock admission; a prefix hit appends the tree's physical pages to
the slot's table.

Model: LLaMA-3, 2 layers, dim 64, 4 q / 2 kv heads, vocab 256, float32,
`use_flash` (the JAX flash kernel in interpret mode), on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu.infer import generate as jgenerate
from solvingpapers_tpu.infer.cache import KVCache as JKVCache
from solvingpapers_tpu.infer.cache import LatentCache as JLatentCache
from solvingpapers_tpu.models.llama3 import Llama as JLlama
from solvingpapers_tpu.models.llama3 import LlamaConfig as JLlamaConfig
from solvingpapers_tpu.serve import kv_pool as jkv
from solvingpapers_tpu_torch.convert import flax_to_torch
from solvingpapers_tpu_torch.infer import KVCache, LatentCache, generate
from solvingpapers_tpu_torch.models import Llama, LlamaConfig
from solvingpapers_tpu_torch.serve import (
    TRASH_PAGE,
    KVSlotPool,
    PagedKVPool,
    SamplingParams,
    ServeConfig,
    ServeEngine,
    gather_lane,
    gather_lanes,
    scatter_lane_pages,
    scatter_written_pages,
)

VOCAB = 256
TINY = dict(vocab_size=VOCAB, max_seq_len=64, dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2, dtype="float32", use_flash=True)


class _CacheOnly:
    """Just enough of a model to build a physical pool (one KVCache
    layer)."""

    def init_caches(self, batch, max_len, dtype=None):
        return [KVCache.init(batch, max_len, 2, 4, torch.float32)]


# --------------------------------------------------------- allocator units


def test_allocator_acquire_ensure_release_roundtrip():
    pool = PagedKVPool(_CacheOnly(), n_slots=2, max_len=16, page_size=4,
                       page_budget=6)
    nbytes0 = pool.nbytes
    assert pool.pages_free == 6 and pool.pages_active == 0
    s = pool.acquire()
    assert pool.ensure(s, 10)  # 3 pages
    assert pool.n_alloc[s] == 3 and pool.pages_free == 3
    assert pool.ensure(s, 10)  # idempotent
    assert pool.n_alloc[s] == 3
    assert pool.table[s, 3] == TRASH_PAGE  # beyond the allocation
    pool.release(s)
    assert pool.pages_free == 6
    assert (pool.refcount[1:] == 0).all()
    assert pool.nbytes == nbytes0
    with pytest.raises(ValueError, match="double release"):
        pool.release(s)


def test_allocator_exhaustion_keeps_partial_and_reports_false():
    pool = PagedKVPool(_CacheOnly(), n_slots=2, max_len=16, page_size=4,
                       page_budget=4)
    a, b = pool.acquire(), pool.acquire()
    assert pool.ensure(a, 12)  # 3 of 4 pages
    assert not pool.ensure(b, 8)  # needs 2, 1 free: the partial is kept
    assert pool.n_alloc[b] == 1 and pool.pages_free == 0
    pool.release(a)
    assert pool.ensure(b, 8)  # the retry succeeds after the reclaim
    pool.release(b)
    assert pool.pages_free == 4


def test_shared_pages_survive_owner_release():
    """A page shared with the tree outlives its producing slot and frees
    only when the LAST holder drops it."""
    pool = PagedKVPool(_CacheOnly(), n_slots=2, max_len=16, page_size=4,
                       page_budget=6)
    s = pool.acquire()
    assert pool.ensure(s, 16)
    tree_refs = pool.share_range(s, 0, 8)  # the "radix tree" holds 2 pages
    assert (pool.refcount[tree_refs] == 2).all()
    pool.release(s)
    assert (pool.refcount[tree_refs] == 1).all()
    assert pool.pages_free == 4
    s2 = pool.acquire()
    pool.append_shared(s2, tree_refs)  # a second slot reuses them, no copy
    assert pool.table[s2, :2].tolist() == tree_refs
    pool.release(s2)
    pool.decref(tree_refs)
    assert pool.pages_free == 6
    with pytest.raises(ValueError, match="over-released"):
        pool.decref(tree_refs)
    with pytest.raises(ValueError, match="trash page"):
        pool.decref([TRASH_PAGE])


def test_share_range_validates_alignment_and_coverage():
    pool = PagedKVPool(_CacheOnly(), n_slots=1, max_len=16, page_size=4,
                       page_budget=4)
    s = pool.acquire()
    pool.ensure(s, 8)
    with pytest.raises(ValueError, match="page-aligned"):
        pool.share_range(s, 2, 4)
    with pytest.raises(ValueError, match="exceeds slot"):
        pool.share_range(s, 0, 12)
    with pytest.raises(ValueError, match="cannot cover even one"):
        PagedKVPool(_CacheOnly(), n_slots=1, max_len=16, page_size=4,
                    page_budget=3)
    with pytest.raises(ValueError, match="not a multiple"):
        PagedKVPool(_CacheOnly(), n_slots=1, max_len=10, page_size=4)


def test_randomized_soak_refcounts_balance_and_pool_never_grows():
    """Randomized acquire / ensure / prefix-share / decref / release
    against a shadow model: after every op each page's refcount is its
    slot-table references plus tree holds, the free list is exactly the
    zero-refcount pages, and the physical pool's bytes never change."""
    rng = np.random.default_rng(0)
    pool = PagedKVPool(_CacheOnly(), n_slots=4, max_len=32, page_size=4,
                       page_budget=20)
    nbytes0 = pool.nbytes
    tree_holds: list[list[int]] = []
    active: list[int] = []

    def check():
        shadow = np.zeros(pool.n_pages, np.int64)
        shadow[TRASH_PAGE] = 1
        for s in range(pool.n_slots):
            for pid in pool.table[s, :pool.n_alloc[s]]:
                shadow[pid] += 1
        for run in tree_holds:
            for pid in run:
                shadow[pid] += 1
        np.testing.assert_array_equal(shadow, pool.refcount)
        free = set(pool._free_pages)
        zero = {p for p in range(1, pool.n_pages) if pool.refcount[p] == 0}
        assert free == zero, "free list != zero-refcount pages"
        assert len(free) == len(pool._free_pages), "duplicate free entries"
        assert pool.nbytes == nbytes0, "physical pool grew"

    for _ in range(400):
        op = rng.integers(0, 5)
        if op == 0 and len(active) < pool.n_slots:
            s = pool.acquire()
            active.append(s)
            pool.ensure(s, int(rng.integers(1, 33)))
        elif op == 1 and active:
            s = active[int(rng.integers(len(active)))]
            pool.ensure(s, int(rng.integers(1, 33)))
        elif op == 2 and active:
            s = active[int(rng.integers(len(active)))]
            covered = int(pool.n_alloc[s])
            if covered >= 1:
                pages = int(rng.integers(1, covered + 1))
                off = int(rng.integers(0, covered - pages + 1))
                tree_holds.append(pool.share_range(
                    s, off * pool.page_size, pages * pool.page_size))
        elif op == 3 and tree_holds:
            pool.decref(tree_holds.pop(int(rng.integers(len(tree_holds)))))
        elif op == 4 and active:
            pool.release(active.pop(int(rng.integers(len(active)))))
        check()
    while active:
        pool.release(active.pop())
    while tree_holds:
        pool.decref(tree_holds.pop())
    check()
    assert pool.pages_free == pool.page_budget, "pages leaked"


# ------------------------------------------- gather / scatter against JAX

N_PAGES, PAGE, PPL = 9, 4, 4


def _pools(seed):
    """The same float32 pool as port caches and JAX caches: a KVCache
    layer (2 kv heads of 3) and a LatentCache layer (rows of 5)."""
    r = np.random.default_rng(seed)
    k, v = (r.standard_normal((N_PAGES, PAGE, 2, 3)).astype(np.float32)
            for _ in range(2))
    c = r.standard_normal((N_PAGES, PAGE, 5)).astype(np.float32)
    port = [KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy())),
            LatentCache(c=torch.from_numpy(c.copy()))]
    ref = [JKVCache(k=jnp.asarray(k), v=jnp.asarray(v)),
           JLatentCache(c=jnp.asarray(c))]
    return port, ref


def _fields(port, ref):
    for p, j in zip(port, ref):
        names = ("k", "v") if isinstance(p, KVCache) else ("c",)
        for name in names:
            yield name, getattr(p, name), getattr(j, name)


def _assert_equal(port, ref):
    for name, p, j in _fields(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=name)


def _no_duplicate_pages(ids):
    """A scatter's ids may repeat only the trash page."""
    real = [i for i in np.asarray(ids).ravel().tolist() if i != TRASH_PAGE]
    assert len(real) == len(set(real)), f"page ids repeat in one scatter: {ids}"


# three slots' tables: an allocation of 3, one of 1 past a shared page, an
# idle row; unallocated entries at the trash page
TABLE = np.array([[3, 7, 1, 0], [5, 2, 0, 0], [0, 0, 0, 0]], np.int64)


def test_gather_lanes_and_gather_lane_equal_jax():
    port, ref = _pools(0)
    got = gather_lanes(port, torch.from_numpy(TABLE))
    want = jkv.gather_lanes(ref, jnp.asarray(TABLE, jnp.int32))
    _assert_equal(got, want)
    assert got[0].k.shape == (3, PPL * PAGE, 2, 3)
    for s in range(3):
        _assert_equal(gather_lane(port, torch.from_numpy(TABLE[s])),
                      jkv.gather_lane(ref, jnp.asarray(TABLE[s], jnp.int32)))


@pytest.mark.parametrize("start_page", [0, 1, 2])
def test_scatter_lane_pages_equals_jax(start_page):
    port, ref = _pools(1)
    row = np.array([6, 4, 8, 0], np.int64)  # the tail entry is trash
    _no_duplicate_pages(row[start_page:])
    r = np.random.default_rng(2)
    lane_np = [r.standard_normal((1, PPL * PAGE) + shape).astype(np.float32)
               for shape in ((2, 3), (2, 3), (5,))]
    lane = [KVCache(k=torch.from_numpy(lane_np[0]), v=torch.from_numpy(lane_np[1])),
            LatentCache(c=torch.from_numpy(lane_np[2]))]
    jlane = [JKVCache(k=jnp.asarray(lane_np[0]), v=jnp.asarray(lane_np[1])),
             JLatentCache(c=jnp.asarray(lane_np[2]))]
    got = scatter_lane_pages(port, lane, torch.from_numpy(row), start_page)
    want = jkv.scatter_lane_pages(ref, jlane, jnp.asarray(row, jnp.int32),
                                  start_page)
    _assert_equal(got, want)
    # pages below start_page are untouched: a shared prefix is read only
    for name, p, j in _fields(_pools(1)[0], ref):
        for pid in row[:start_page]:
            np.testing.assert_array_equal(
                getattr(got[0 if name in "kv" else 1], name)[pid].numpy(),
                p[pid].numpy())


@pytest.mark.parametrize("pos", [[0, 1, 9], [5, 7, 0], [15, 4, 3], [-2, 99, 6]],
                         ids=["first_pages", "second_pages", "last_page",
                              "clamped"])
def test_scatter_written_pages_equals_jax(pos):
    port, ref = _pools(3)
    pos = np.asarray(pos, np.int64)
    ids = TABLE[np.arange(3), np.clip(pos // PAGE, 0, PPL - 1)]
    _no_duplicate_pages(ids)
    lanes = gather_lanes(port, torch.from_numpy(TABLE))
    jlanes = jkv.gather_lanes(ref, jnp.asarray(TABLE, jnp.int32))
    r = np.random.default_rng(4)
    for (name, p, j), lane in zip(_fields(lanes, jlanes), (0, 0, 1)):
        new = r.standard_normal(p.shape).astype(np.float32)
        p.copy_(torch.from_numpy(new))
        jlanes[lane] = jlanes[lane].replace(**{name: jnp.asarray(new)})
    got = scatter_written_pages(port, lanes, torch.from_numpy(TABLE),
                                torch.from_numpy(pos))
    want = jkv.scatter_written_pages(ref, jlanes, jnp.asarray(TABLE, jnp.int32),
                                     jnp.asarray(pos, jnp.int32))
    _assert_equal(got, want)


def test_extracted_prefix_is_a_copy_and_splices_back():
    """`extract_prefix` detaches: the next prefill into the lane leaves
    the segment as it was; `splice_prefix` writes it back at an offset."""
    pool = KVSlotPool(_CacheOnly(), n_slots=2, max_len=16)
    s = pool.acquire()
    pool.caches[0].k[s].copy_(torch.arange(16 * 8, dtype=torch.float32).view(16, 2, 4))
    seg = pool.extract_prefix(s, 4, 8)
    before = seg[0].k.clone()
    pool.caches[0].k[s].fill_(-1.0)
    assert torch.equal(seg[0].k, before)
    other = pool.acquire()
    pool.splice_prefix(other, seg, offset=8)
    assert torch.equal(pool.caches[0].k[other, 8:16], before[0])
    with pytest.raises(ValueError, match="capacity"):
        pool.splice_prefix(other, seg, offset=12)
    with pytest.raises(TypeError, match="dtype"):
        pool.splice_prefix(other, [KVCache(k=seg[0].k.double(), v=seg[0].v)])


# ------------------------------------------------------- engine integration


@pytest.fixture(scope="module")
def pair():
    jm = JLlama(JLlamaConfig(**TINY))
    params = jax.jit(jm.init)({"params": jax.random.key(0)},
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = Llama(LlamaConfig(**TINY), device="cpu").eval()
    tm.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _prompts(n, seed, lo, hi):
    r = np.random.default_rng(seed)
    return [r.integers(0, VOCAB, size=int(r.integers(lo, hi))) for _ in range(n)]


def _port_stream(tm, prompt, max_new):
    out = generate(tm, torch.from_numpy(prompt)[None], max_new_tokens=max_new,
                   device="cpu")
    return out[0, len(prompt):].tolist()


def _jax_stream(jm, params, prompt, max_new):
    out = jgenerate(jm, params, jnp.asarray(prompt, jnp.int32)[None],
                    jax.random.key(0), max_new_tokens=max_new)
    return np.asarray(out[0, len(prompt):]).tolist()


def assert_no_leaks(eng):
    """Drained engine: every slot free; the tree evicted, every page back
    on the free list and only the trash page's permanent hold left."""
    pool = eng.pool
    assert pool.n_active == 0 and pool._free_mask.all()
    assert sorted(pool._free) == list(range(pool.n_slots))
    assert all(r is None for r in eng._slot_req)
    if eng.prefix_cache is not None:
        while eng.prefix_cache.evict_one():
            pass
    assert pool.pages_free == pool.page_budget, "pages leaked"
    assert int(pool.refcount.sum()) == 1
    assert set(pool._free_pages) == {p for p in range(1, pool.n_pages)
                                     if pool.refcount[p] == 0}


SEEDED = SamplingParams(temperature=0.8, top_p=0.9, seed=5)


@torch.no_grad()
def test_preemption_recompute_streams_token_exact(pair):
    """A page budget too small for three whole streams forces a
    preemption mid-stream; the evicted request resumes by recompute and
    every greedy stream is token-exact with both packages' `generate`.
    The youngest stream, the one preempted, samples with a seed: its
    stream equals the same request's on the lane pool."""
    jm, params, tm = pair
    prompts = _prompts(3, seed=5, lo=8, hi=9)
    sampling = [None, None, SEEDED]
    eng = ServeEngine(tm, ServeConfig(
        n_slots=3, max_len=32, decode_block=4, bucket=8, paged=True,
        page_size=4, page_budget=10, max_prefills_per_step=3), device="cpu")
    handles = [eng.submit(p, max_new_tokens=12, params=sp)
               for p, sp in zip(prompts, sampling)]
    eng.run()
    lane = ServeEngine(tm, ServeConfig(n_slots=3, max_len=32, decode_block=4,
                                       bucket=8, max_prefills_per_step=3),
                       device="cpu")
    lane_seeded = lane.submit(prompts[2], max_new_tokens=12, params=SEEDED)
    lane.run()
    for p, h in zip(prompts[:2], handles):
        assert h.done and h.finish_reason == "length"
        assert h.tokens == _port_stream(tm, p, 12), "preemption corrupted a stream"
        assert h.tokens == _jax_stream(jm, params, p, 12)
    assert handles[2].tokens == lane_seeded.tokens
    snap = eng.metrics.snapshot()
    assert snap["serve/preemptions"] >= 1, "the budget never forced a preemption"
    assert snap["serve/recompute_tokens"] > 0
    assert handles[2].pages_held >= 3
    assert_no_leaks(eng)


@torch.no_grad()
def test_more_slots_than_lane_equivalent_memory(pair):
    """At the bytes of a 3-slot lane pool the paged engine runs 6 slots at
    once: short streams book pages, not worst-case lanes."""
    _, _, tm = pair
    page_size, max_len = 8, 64
    lane_equiv = 3 * (max_len // page_size)
    eng = ServeEngine(tm, ServeConfig(
        n_slots=6, max_len=max_len, decode_block=4, bucket=8, paged=True,
        page_size=page_size, page_budget=lane_equiv,
        max_prefills_per_step=6, decode_priority=False), device="cpu")
    lane_pool = KVSlotPool(tm, n_slots=3, max_len=max_len)
    assert eng.pool.nbytes == lane_pool.nbytes + eng.pool.page_nbytes
    prompts = _prompts(6, seed=9, lo=6, hi=12)
    handles = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.step()  # one admission wave fills every slot
    assert eng.pool.n_active == 6, "the paged pool could not seat 2x the slots"
    eng.run()
    for p, h in zip(prompts, handles):
        assert h.tokens == _port_stream(tm, p, 6)
    assert_no_leaks(eng)


@torch.no_grad()
def test_tree_hoarded_pages_never_livelock_admission(pair):
    """With a budget of one lane the tree's references can pin most of
    the pool after every stream drains; a new request with no cached
    prefix is still admitted: the idle engine sheds tree leaves for the
    page-starved head."""
    _, _, tm = pair
    r = np.random.default_rng(13)
    eng = ServeEngine(tm, ServeConfig(
        n_slots=2, max_len=32, decode_block=4, bucket=8, paged=True,
        prefix_cache=True, prefix_page=4, page_budget=8), device="cpu")
    a = r.integers(0, VOCAB, size=12)
    h0 = eng.submit(a, max_new_tokens=4)
    eng.run()
    assert h0.done
    assert eng.pool.pages_free < 8, "the tree holds no page: vacuous"
    b = r.integers(0, VOCAB, size=20)
    h1 = eng.submit(b, max_new_tokens=4)
    for _ in range(50):  # bounded: a livelocked engine would spin here
        if not eng.has_work():
            break
        eng.step()
    assert h1.done, "the page-starved head was never admitted"
    assert h1.tokens == _port_stream(tm, b, 4)
    assert eng.metrics.snapshot()["serve/prefix_evictions"] >= 1
    assert_no_leaks(eng)


@torch.no_grad()
def test_prefix_hit_appends_the_trees_pages(pair):
    """A hit on the paged pool is a page-table append: the second
    request's leading table entries ARE the pages the first request's
    prefill wrote (refcounted by the tree and the slot), not copies."""
    _, _, tm = pair
    r = np.random.default_rng(17)
    stem = r.integers(0, VOCAB, size=12)
    eng = ServeEngine(tm, ServeConfig(
        n_slots=2, max_len=32, decode_block=4, bucket=8, paged=True,
        prefix_cache=True, prefix_page=4), device="cpu")
    first = eng.submit(np.concatenate([stem, r.integers(0, VOCAB, 3)]),
                       max_new_tokens=4)
    eng.run()
    node = eng.prefix_cache.match(stem).nodes[0]
    cached = list(node.pages)
    assert len(cached) == 3 and first.done
    second = eng.submit(np.concatenate([stem, r.integers(0, VOCAB, 5)]),
                        max_new_tokens=12)
    eng.step()
    assert second.state == "active"
    assert eng.pool.table[second.slot, :3].tolist() == cached
    assert (eng.pool.refcount[cached] == 2).all()
    eng.run()
    assert second.tokens == _port_stream(tm, second.prompt, 12)
    assert_no_leaks(eng)


def test_paged_engine_validates_config(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="paged=True"):
        ServeEngine(tm, ServeConfig(n_slots=1, max_len=32, page_size=8),
                    device="cpu")
    with pytest.raises(ValueError, match="paged=True"):
        ServeEngine(tm, ServeConfig(n_slots=1, max_len=32, page_budget=8),
                    device="cpu")
    with pytest.raises(ValueError, match="not a multiple"):
        ServeEngine(tm, ServeConfig(n_slots=1, max_len=30, paged=True,
                                    page_size=8), device="cpu")
    with pytest.raises(ValueError, match="prefix_page"):
        ServeEngine(tm, ServeConfig(n_slots=1, max_len=32, paged=True,
                                    page_size=8, prefix_cache=True,
                                    prefix_page=4), device="cpu")
    with pytest.raises(ValueError, match="cannot cover"):
        ServeEngine(tm, ServeConfig(n_slots=1, max_len=32, paged=True,
                                    page_size=8, page_budget=3), device="cpu")
    with pytest.raises(ValueError, match="prefix_cache=True"):
        ServeEngine(tm, ServeConfig(n_slots=1, max_len=32, prefix_sched=True),
                    device="cpu")


def test_paged_engine_needs_a_device_without_cuda(pair, monkeypatch):
    """With no device named the engine runs on the card; without one it
    raises rather than serving from the host."""
    _, _, tm = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tm, ServeConfig(n_slots=1, max_len=32, paged=True,
                                    page_size=8, prefix_cache=True,
                                    prefix_page=8))
