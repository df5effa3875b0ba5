"""The port's radix prefix cache (`solvingpapers_tpu_torch/serve/
prefix_cache.py`) and the engine's prefix paths, against the JAX
package's.

Tree mechanics, as the reference's `tests/test_prefix_cache.py` holds
them: page-aligned matching, edge splits, LRU eviction under a byte
budget, refcount pinning (a pinned path survives any pressure), and the
scheduler's shortest-uncovered-suffix order under the wait budget. A
seeded sequence of insert, match, peek, pin and evict runs against the
JAX `PrefixCache` and the port's: match lengths, node counts, bytes held
and evictions agree after every op (on copied segments, and on a paged
pool's page ids, whose refcounts agree too).

Engine exactness: greedy streams with the cache on equal those with it
off, the port's `generate` and the JAX package's `generate`, for GPT,
LLaMA-3 (`use_flash`, the JAX flash kernel in interpret mode) and
DeepSeek-V3 (dense MLA, at capacity factor E / k, where no MoE pair
drops however a prompt is cut), on the lane and the paged pool; the
cache-on runs must hit. LRU churn under a tight byte budget never
corrupts a stream. Float32 on the CPU; streams token-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu.infer import generate as jgenerate
from solvingpapers_tpu.serve.kv_pool import PagedKVPool as JPagedKVPool
from solvingpapers_tpu.serve.prefix_cache import PrefixCache as JPrefixCache
from solvingpapers_tpu_torch.convert import flax_to_torch
from solvingpapers_tpu_torch.infer import KVCache, generate
from solvingpapers_tpu_torch.serve import (
    FIFOScheduler,
    PagedKVPool,
    PrefixCache,
    Request,
    ServeConfig,
    ServeEngine,
)
from solvingpapers_tpu_torch.serve.prefix_cache import segment_bytes
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)


# ------------------------------------------------------------- tree units


def _seg(length, fill=0.0, dtype=torch.bfloat16):
    """A fake batch-1 segment: one layer, k and v of (1, length, 2, 4)."""
    return [KVCache(k=torch.full((1, length, 2, 4), float(fill), dtype=dtype),
                    v=torch.full((1, length, 2, 4), float(fill), dtype=dtype))]


def _seg_len(seg):
    return seg[0].k.shape[1]


def test_match_miss_then_hit_after_insert():
    pc = PrefixCache(page=4, max_bytes=1 << 20)
    tokens = np.arange(12, dtype=np.int32)
    assert pc.match(tokens).length == 0
    new = pc.insert(tokens, lambda off, n: _seg(n, fill=off))
    assert new == 12 and pc.n_nodes == 1
    m = pc.match(tokens)
    assert m.length == 12 and len(m.nodes) == 1
    assert _seg_len(m.nodes[0].segment) == 12
    assert pc.bytes_held == segment_bytes(m.nodes[0].segment)


def test_partial_match_splits_at_page_boundary():
    pc = PrefixCache(page=4, max_bytes=1 << 20)
    pc.insert(np.arange(12, dtype=np.int32), lambda off, n: _seg(n))
    # diverges at token 6: common prefix 6, page-aligned match 4
    probe = np.concatenate([np.arange(6), [99, 99]]).astype(np.int32)
    m = pc.match(probe[:8])
    assert m.length == 4 and [n.length for n in m.nodes] == [4]
    assert pc.n_nodes == 2  # the 12-token edge is now 4 + 8 under it
    full = pc.match(np.arange(12, dtype=np.int32))
    assert m.nodes[0] is full.nodes[0]
    assert [n.length for n in full.nodes] == [4, 8]
    assert _seg_len(full.nodes[0].segment) == 4
    assert _seg_len(full.nodes[1].segment) == 8


def test_sub_page_common_prefix_is_a_miss():
    pc = PrefixCache(page=8, max_bytes=1 << 20)
    pc.insert(np.arange(8, dtype=np.int32), lambda off, n: _seg(n))
    probe = np.concatenate([np.arange(5), [99, 99, 99]]).astype(np.int32)
    assert pc.match(probe).length == 0
    assert pc.n_nodes == 1  # no split happened


def test_peek_is_readonly():
    pc = PrefixCache(page=4, max_bytes=1 << 20)
    pc.insert(np.arange(12, dtype=np.int32), lambda off, n: _seg(n))
    probe = np.concatenate([np.arange(6), [99]]).astype(np.int32)
    assert pc.peek(probe) == 4
    assert pc.n_nodes == 1, "peek must not split edges"
    assert pc.peek(np.arange(12, dtype=np.int32)) == 12


def test_insert_rejects_unaligned_length():
    pc = PrefixCache(page=8, max_bytes=1 << 20)
    with pytest.raises(ValueError, match="not a multiple"):
        pc.insert(np.arange(10, dtype=np.int32), lambda off, n: _seg(n))


def test_insert_extracts_only_the_uncached_tail():
    pc = PrefixCache(page=4, max_bytes=1 << 20)
    calls = []

    def extract(off, n):
        calls.append((off, n))
        return _seg(n)

    pc.insert(np.arange(8, dtype=np.int32), extract)
    pc.insert(np.arange(16, dtype=np.int32), extract)  # 8 cached, 8 new
    assert calls == [(0, 8), (8, 8)]
    assert pc.insert(np.arange(16, dtype=np.int32), extract) == 0
    assert calls == [(0, 8), (8, 8)]


def test_subpage_divergence_caches_both_stems_as_siblings():
    """Two stems sharing 4 of 16 tokens start with the same token but
    different first PAGES: page-keyed children hold both side by side."""
    pc = PrefixCache(page=16, max_bytes=1 << 20)
    a = np.arange(64, dtype=np.int32)
    pc.insert(a, lambda off, n: _seg(n))
    held = pc.bytes_held
    b = np.concatenate([a[:4], np.full(60, 99)]).astype(np.int32)
    assert pc.insert(b, lambda off, n: _seg(n)) == 64
    assert pc.peek(a) == 64, "the existing stem was clobbered"
    assert pc.peek(b) == 64
    assert pc.bytes_held == 2 * held and pc.n_nodes == 2


def test_subpage_divergence_past_aligned_split_branches_lower():
    """Divergence at token 20 with page 16: the edge splits at 16 and the
    remainders become siblings under the split-off upper."""
    pc = PrefixCache(page=16, max_bytes=1 << 20)
    a = np.arange(64, dtype=np.int32)
    pc.insert(a, lambda off, n: _seg(n))
    b = np.concatenate([a[:20], np.full(44, 99)]).astype(np.int32)
    assert pc.insert(b, lambda off, n: _seg(n)) == 48
    assert pc.peek(a) == 64 and pc.peek(b) == 64
    assert pc.n_nodes == 3  # shared upper [0, 16) + two 48-token branches
    ma, mb = pc.match(a), pc.match(b)
    assert ma.nodes[0] is mb.nodes[0] and ma.nodes[1] is not mb.nodes[1]
    assert _seg_len(mb.nodes[1].segment) == 48


def test_split_segments_are_copies():
    """A split's halves own their spans: writing the lower half leaves
    the upper as it was."""
    pc = PrefixCache(page=4, max_bytes=1 << 20)
    pc.insert(np.arange(12, dtype=np.int32), lambda off, n: _seg(n, fill=1.0))
    pc.match(np.concatenate([np.arange(6), [99, 99]]).astype(np.int32))
    upper, lower = pc.match(np.arange(12, dtype=np.int32)).nodes
    lower.segment[0].k.fill_(7.0)
    assert (upper.segment[0].k == 1.0).all()


def test_lru_eviction_respects_budget():
    one = segment_bytes(_seg(8))
    pc = PrefixCache(page=8, max_bytes=2 * one)
    rng = np.random.default_rng(0)
    branches = [rng.integers(100, 200, size=8).astype(np.int32)
                for _ in range(4)]
    for b in branches:
        pc.insert(b, lambda off, n: _seg(n))
    assert pc.bytes_held <= pc.max_bytes
    assert pc.evictions == 2 and pc.n_nodes == 2
    assert pc.match(branches[0]).length == 0
    assert pc.match(branches[3]).length == 8


def test_match_refreshes_lru_order():
    one = segment_bytes(_seg(8))
    pc = PrefixCache(page=8, max_bytes=2 * one)
    a = np.arange(100, 108, dtype=np.int32)
    b = np.arange(200, 208, dtype=np.int32)
    pc.insert(a, lambda off, n: _seg(n))
    pc.insert(b, lambda off, n: _seg(n))
    pc.match(a)  # a is now the most recently used
    pc.insert(np.arange(300, 308, dtype=np.int32), lambda off, n: _seg(n))
    assert pc.match(a).length == 8
    assert pc.match(b).length == 0  # b was the LRU victim


def test_pinned_path_survives_eviction_pressure():
    pc = PrefixCache(page=8, max_bytes=segment_bytes(_seg(8)))  # one node
    a = np.arange(100, 108, dtype=np.int32)
    pc.insert(a, lambda off, n: _seg(n))
    m = pc.match(a)
    pc.pin(m)
    pc.insert(np.arange(200, 208, dtype=np.int32), lambda off, n: _seg(n))
    assert pc.match(a).length == 8, "a pinned node was evicted"
    pc.unpin(m)
    pc.insert(np.arange(300, 308, dtype=np.int32), lambda off, n: _seg(n))
    assert pc.match(a).length == 0, "the unpinned LRU node should go now"


def test_split_preserves_pin_protection_and_unpin_balances():
    pc = PrefixCache(page=4, max_bytes=1 << 20)
    tokens = np.arange(12, dtype=np.int32)
    pc.insert(tokens, lambda off, n: _seg(n))
    m = pc.match(tokens)
    pc.pin(m)
    pc.match(np.concatenate([np.arange(6), [99, 99]]).astype(np.int32))
    upper, lower = pc.match(tokens).nodes
    assert upper.refcount == 0 and lower.refcount == 1
    pc.max_bytes = 0
    pc._evict_to_budget()
    assert pc.match(tokens).length == 12, "a pinned path evicted after a split"
    pc.unpin(m)
    assert upper.refcount == 0 and lower.refcount == 0
    pc._evict_to_budget()
    assert pc.n_nodes == 0 and pc.bytes_held == 0


def test_evicting_leaf_exposes_parent():
    pc = PrefixCache(page=4, max_bytes=8 * segment_bytes(_seg(4)))
    pc.insert(np.arange(12, dtype=np.int32), lambda off, n: _seg(n))
    probe = np.concatenate([np.arange(4), [50, 50, 50, 50]]).astype(np.int32)
    pc.insert(probe, lambda off, n: _seg(n))  # splits: 3 nodes
    assert pc.n_nodes == 3
    pc.max_bytes = 0
    pc._evict_to_budget()
    assert pc.n_nodes == 0 and pc.bytes_held == 0 and pc.evictions == 3


def test_tree_validates_its_arguments():
    with pytest.raises(ValueError, match="page"):
        PrefixCache(page=0)
    with pytest.raises(ValueError, match="max_bytes"):
        PrefixCache(max_bytes=-1)

    class _Model:
        def init_caches(self, batch, max_len, dtype=None):
            return [KVCache.init(batch, max_len, 1, 2, torch.float32)]

    with pytest.raises(ValueError, match="page_size"):
        PrefixCache(page=4, pool=PagedKVPool(_Model(), 1, 16, 8))


# --------------------------------------------------- scheduler integration


def _req(prompt):
    return Request(prompt=np.asarray(prompt, np.int64), max_new_tokens=4,
                   eos_id=None)


def test_scheduler_prefers_shortest_uncovered_suffix():
    cached = {8: 0, 16: 12, 24: 24}  # prompt len -> match len
    sched = FIFOScheduler(decode_priority=False, prefer_cached=True,
                          prefix_lookup=lambda p: cached[p.size])
    reqs = [_req(np.arange(n)) for n in (8, 16, 24)]
    for r in reqs:
        sched.submit(r)
    # uncovered suffixes 8, 4, 0: admitted in the reverse of FIFO order
    assert sched.pick(n_free=2, n_active=0) == [reqs[2], reqs[1]]
    assert list(sched.queue) == [reqs[0]]


def test_scheduler_wait_budget_beats_prefix_preference():
    sched = FIFOScheduler(decode_priority=False, prefer_cached=True,
                          max_wait_steps=2,
                          prefix_lookup=lambda p: 0 if p.size == 8 else p.size)
    starved = _req(np.arange(8))  # nothing cached: the longest suffix
    sched.submit(starved)
    for _ in range(3):
        sched.tick()  # past the wait budget now
    fresh = _req(np.arange(16))  # all cached: the shortest suffix
    sched.submit(fresh)
    assert sched.pick(n_free=1, n_active=0) == [starved]


def test_scheduler_page_gate_blocks_at_the_head():
    """A gate that rejects the head admits nothing behind it (strict
    head-of-line), in FIFO and in preference order alike."""
    for prefer in (False, True):
        # preferred, the 12-token prompt (11 cached) goes first too
        sched = FIFOScheduler(decode_priority=False, prefer_cached=prefer,
                              prefix_lookup=lambda p: 11 if p.size == 12 else 0,
                              can_admit=lambda r: r.prompt.size < 10)
        reqs = [_req(np.arange(n)) for n in (12, 4, 4)]
        for r in reqs:
            sched.submit(r)
        assert sched.pick(n_free=3, n_active=0) == []
        assert list(sched.queue) == reqs
        sched.can_admit = lambda r: True
        assert sched.pick(n_free=3, n_active=0) == reqs


# ------------------------------------------ the tree against the reference


class _JModel:
    def init_caches(self, batch, max_len, dtype=None):
        from solvingpapers_tpu.infer.cache import KVCache as JKVCache

        return [JKVCache.init(batch, max_len, 2, 4, jnp.float32)]


class _TModel:
    def init_caches(self, batch, max_len, dtype=None):
        return [KVCache.init(batch, max_len, 2, 4, torch.float32)]


def _jseg(n):
    return [{"k": jnp.zeros((1, n, 2, 4), jnp.bfloat16),
             "v": jnp.zeros((1, n, 2, 4), jnp.bfloat16)}]


@pytest.mark.parametrize("paged", [False, True], ids=["segments", "pages"])
def test_seeded_op_sequence_matches_the_reference_tree(paged):
    """Seeded inserts (stems with random tails, so edges split), matches,
    peeks, pins and LRU evictions under a budget of ~3 segments: both
    trees report the same match lengths, node counts, bytes held and
    evictions after every op. Paged, both trees hold page ids of their
    pools (one slot covering the whole lane lends them), and the pools'
    refcounts and free lists agree too."""
    rng = np.random.default_rng(7)
    page, max_len = 4, 64
    if paged:
        jpool, tpool = (P(M(), 1, max_len, page, page_budget=16)
                        for P, M in ((JPagedKVPool, _JModel), (PagedKVPool, _TModel)))
        for pool in (jpool, tpool):
            slot = pool.acquire()
            assert pool.ensure(slot, max_len)
        jext = lambda off, n: jpool.share_range(0, off, n)  # noqa: E731
        text = lambda off, n: tpool.share_range(0, off, n)  # noqa: E731
        budget = 6 * tpool.page_nbytes
        assert jpool.page_nbytes == tpool.page_nbytes
    else:
        jpool = tpool = None
        jext, text = (lambda off, n: _jseg(n)), (lambda off, n: _seg(n))
        budget = 3 * segment_bytes(_seg(16))
    jt = JPrefixCache(page=page, max_bytes=budget, pool=jpool)
    tt = PrefixCache(page=page, max_bytes=budget, pool=tpool)
    stems = [rng.integers(0, 50, size=int(rng.integers(4, 24))) for _ in range(3)]
    pins = []
    for step in range(120):
        op = rng.integers(0, 5)
        stem = stems[int(rng.integers(len(stems)))]
        seq = np.concatenate([stem, rng.integers(0, 50, size=int(rng.integers(0, 20)))])
        seq = seq.astype(np.int32)
        if op == 0:
            aligned = seq[:seq.size // page * page]
            assert jt.insert(aligned, jext) == tt.insert(aligned, text), step
        elif op == 1:
            jm, tm = jt.match(seq), tt.match(seq)
            assert jm.length == tm.length, step
            assert [n.length for n in jm.nodes] == [n.length for n in tm.nodes]
            if paged:
                assert [n.pages for n in jm.nodes] == [n.pages for n in tm.nodes]
            if rng.integers(0, 3) == 0:
                jt.pin(jm)
                tt.pin(tm)
                pins.append((jm, tm))
        elif op == 2:
            assert jt.peek(seq) == tt.peek(seq), step
        elif op == 3 and pins:
            jm, tm = pins.pop(int(rng.integers(len(pins))))
            jt.unpin(jm)
            tt.unpin(tm)
        elif op == 4:
            assert jt.evict_one() == tt.evict_one(), step
        assert (jt.n_nodes, jt.bytes_held, jt.evictions) == (
            tt.n_nodes, tt.bytes_held, tt.evictions), step
        assert jt.stats() == tt.stats()
        if paged:
            np.testing.assert_array_equal(np.asarray(jpool.refcount),
                                          tpool.refcount)
            assert list(jpool._free_pages) == list(tpool._free_pages)
    assert jt.evictions > 0, "the budget never forced an eviction"


# ------------------------------------------------------ engine exactness

V = 64
_SPECS = {
    "gpt": ("solvingpapers_tpu.models.gpt", "GPT", "GPTConfig",
            "solvingpapers_tpu_torch.models.gpt", "GPT", "GPTConfig",
            dict(vocab_size=V, block_size=64, dim=32, n_layers=2, n_heads=2,
                 dropout=0.0, dtype="float32")),
    "llama3": ("solvingpapers_tpu.models.llama3", "Llama", "LlamaConfig",
               "solvingpapers_tpu_torch.models.llama3", "Llama", "LlamaConfig",
               dict(vocab_size=V, max_seq_len=64, dim=32, n_layers=2,
                    n_heads=4, n_kv_heads=2, dtype="float32", use_flash=True)),
    # capacity factor E / k: every expert can take every token, so the
    # suffix prefill's routing equals the whole prompt's
    "deepseekv3": ("solvingpapers_tpu.models.deepseekv3", "DeepSeekV3",
                   "DeepSeekV3Config", "solvingpapers_tpu_torch.models.deepseekv3",
                   "DeepSeekV3", "DeepSeekV3Config",
                   dict(vocab_size=V, block_size=64, dim=32, n_layers=2,
                        n_heads=4, latent_dim=8, rope_dim=8, n_experts=4,
                        top_experts=2, capacity_factor=2.0, dropout=0.0,
                        attn_dropout=0.0, dtype="float32")),
}


def _family(name):
    """(JAX model, its variables, extra variables, the port's model) on
    one set of weights; DeepSeek-V3 with N(0, 0.3) routing biases."""
    import importlib

    jmod, jcls, jcfg, tmod, tcls, tcfg, kw = _SPECS[name]
    jm_ = importlib.import_module(jmod)
    tm_ = importlib.import_module(tmod)
    jm = getattr(jm_, jcls)(getattr(jm_, jcfg)(**kw))
    variables = jax.jit(jm.init)({"params": jax.random.key(len(name))},
                                 jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    extra = None
    if "moe_state" in variables:
        r = np.random.default_rng(1)
        extra = {"moe_state": jax.tree.map(
            lambda b: (r.standard_normal(b.shape) * 0.3).astype(np.float32),
            variables["moe_state"])}
    tm = getattr(tm_, tcls)(getattr(tm_, tcfg)(**kw), device="cpu").eval()
    tm.load_state_dict(flax_to_torch(params, extra))
    return jm, params, extra, tm


def _shared_prefix_prompts(n, n_stems=2, stem_len=14, tail_len=5, seed=0):
    r = np.random.default_rng(seed)
    stems = [r.integers(0, V, size=stem_len) for _ in range(n_stems)]
    return [np.concatenate([stems[i % n_stems], r.integers(0, V, size=tail_len)])
            for i in range(n)]


@pytest.fixture(scope="module")
def families():
    return {}


def _streams(families, name, prompts, new):
    """(the family's port model, its port-generate streams, its JAX-
    generate streams), built once per module."""
    if name not in families:
        jm, params, extra, tm = _family(name)
        with torch.no_grad():
            port = [generate(tm, torch.from_numpy(p)[None], max_new_tokens=new,
                             device="cpu")[0, len(p):].tolist() for p in prompts]
        ref = [np.asarray(jgenerate(
            jm, params, jnp.asarray(p, jnp.int32)[None], jax.random.key(0),
            max_new_tokens=new, extra_variables=extra)[0, len(p):]).tolist()
               for p in prompts]
        families[name] = tm, port, ref
    return families[name]


@pytest.mark.parametrize("family", sorted(_SPECS))
@torch.no_grad()
def test_streams_token_exact_with_cache_on_off_all_families(families, family):
    """Greedy streams: cache on == cache off == the port's `generate` ==
    the JAX package's `generate`, over shared-prefix traffic, on both
    pool layouts (one test a family, so each worker builds a family's
    references once); the cache-on runs hit (a splice on the lane pool, a
    page-table append on the paged pool)."""
    prompts = _shared_prefix_prompts(6, seed=11)
    tm, port, ref = _streams(families, family, prompts, 6)
    assert port == ref, f"{family}: the port's generate differs from JAX's"
    for paged in (False, True):
        streams = {}
        for on in (True, False):
            eng = ServeEngine(tm, ServeConfig(
                n_slots=2, max_len=32, decode_block=4, bucket=8,
                prefix_cache=on, prefix_page=4, paged=paged), device="cpu")
            handles = [eng.submit(p, max_new_tokens=6) for p in prompts]
            eng.run()
            streams[on] = [h.tokens for h in handles]
            if on:
                snap = eng.metrics.snapshot()
                assert snap["serve/prefix_hits"] >= 4, "shared stems never hit"
                assert snap["serve/tokens_prefilled_saved"] >= 4 * 12
                assert snap["serve/tokens_prefilled"] == (
                    sum(p.size for p in prompts)
                    - snap["serve/prefix_cached_tokens"])
            if paged:
                while eng.prefix_cache is not None and eng.prefix_cache.evict_one():
                    pass
                assert eng.pool.pages_free == eng.pool.page_budget
        assert streams[True] == streams[False], f"{family}, paged={paged}"
        assert streams[True] == port, (
            f"{family}, paged={paged}: a cached stream diverged")


@torch.no_grad()
def test_eviction_churn_never_corrupts_streams(families):
    """A byte budget of two 12-token segments forces constant LRU churn
    over three stems; every stream stays token-exact (lanes own their
    spliced copies)."""
    tm, _, _ = _streams(families, "llama3", _shared_prefix_prompts(6, seed=11), 6)
    prompts = _shared_prefix_prompts(10, n_stems=3, seed=23)
    seg_bytes = segment_bytes(ServeEngine(
        tm, ServeConfig(n_slots=1, max_len=32), device="cpu"
    ).pool.extract_prefix(0, 0, 12))
    eng = ServeEngine(tm, ServeConfig(
        n_slots=2, max_len=32, decode_block=4, bucket=8, prefix_cache=True,
        prefix_page=4, prefix_cache_bytes=2 * seg_bytes), device="cpu")
    handles = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run()
    assert eng.prefix_cache.evictions > 0, "the budget never forced an eviction"
    assert eng.prefix_cache.bytes_held <= eng.prefix_cache.max_bytes
    for p, h in zip(prompts, handles):
        assert h.tokens == generate(tm, torch.from_numpy(p)[None],
                                    max_new_tokens=6, device="cpu")[0, len(p):].tolist()
    assert eng.metrics.snapshot()["serve/prefix_evictions"] > 0
