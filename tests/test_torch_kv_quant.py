"""The port's quantized KV pool (`serve/kv_pool.py` `QuantStore`, the
engine's `kv_quant` paths) against the JAX package's.

Write sites: from one reference store carried over by
`convert.quant_store_from_reference` and the same lane values, every
store and scatter helper (`quant_store_lane`, `quant_store_written`,
`quant_scatter_lane_pages`, `quant_scatter_written_pages`,
`quant_scatter_window_pages`, `quant_store_exact_lanes`), the scrubs and
the quantized splice and extract give int8 codes and scales byte-equal to
the reference's, float32 and bfloat16 lane views alike, and the read
helpers the same views. The exact sidecar's lanes 1.. are compared; trash
lane 0 is written by the reference only (nothing reads it).

Engines: float32 greedy streams of the port's quantized engine equal the
reference's token for token on both pools, with pool codes after prefill
at most one code apart on at most 0.1 % of entries (the packages' f32 k/v
differ by ulps). The port-only behaviour mirrors the reference's
`tests/test_kv_quant.py`; the cross-plane cases (journal recovery,
`adopt`, quarantine, replay, CLI, bench) close the slice. Model: the
registry's gpt_tiny (2 layers, dim 64, float32) in both packages on one
set of weights (`durability_models.gpt_tiny_pair`), and a toy DeepSeek-V3
for its latent lanes.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu.ops import quant as jq
from solvingpapers_tpu.serve import kv_pool as jkv
from solvingpapers_tpu_torch.convert import (
    quant_segment_from_reference,
    quant_store_from_reference,
)
from solvingpapers_tpu_torch.serve import kv_pool as tkv
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)

RNG_SEED = 7


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    """The reference's `fn` under `jax.jit` (`static` its static
    arguments), where an eager call compiles each of its ops on its own.
    Only for what both sides share (the reference stores) and for the
    read helpers: the write sites stay eager, as the port is held to
    their eager arithmetic (under `jit`, XLA rounds some scales one ulp
    apart)."""
    return jax.jit(fn, static_argnames=static)


def _np_store(store):
    return jax.tree.map(np.asarray, store)


def _port_store(jstore):
    return quant_store_from_reference(_np_store(jstore))


def _ref_store(kind, n, t, block, dtype, exact_lanes=0, exact_time=None,
               seed=RNG_SEED, magnitude=3.0):
    """A reference QuantStore holding the codes of random values: `kind`
    "kv" (2 layers of KVCache, 2 heads of 8) or "latent" (LatentCache of
    12 channels)."""
    from solvingpapers_tpu.infer.cache import KVCache, LatentCache

    rng = np.random.default_rng(seed)

    def vals(shape):
        return jnp.asarray(rng.normal(0, magnitude, size=shape), jnp.float32)

    if kind == "kv":
        base = [KVCache(k=vals((n, t, 2, 8)), v=vals((n, t, 2, 8)))
                for _ in range(2)]
    else:
        base = [LatentCache(c=vals((n, t, 12))) for _ in range(2)]
    q, s = _jit(jq.quantize_tree, "block")(base, block)
    exact = None
    if exact_lanes:
        et = exact_time or t
        if kind == "kv":
            exact = [KVCache(k=vals((exact_lanes + 1, et, 2, 8)).astype(dtype),
                             v=vals((exact_lanes + 1, et, 2, 8)).astype(dtype))
                     for _ in range(2)]
        else:
            exact = [LatentCache(c=vals((exact_lanes + 1, et, 12)).astype(dtype))
                     for _ in range(2)]
    return jkv.QuantStore(q=q, scale=s, exact=exact, block=block, dtype=dtype)


def _lanes_like(kind, n, t, dtype, seed):
    """(reference lanes, port lanes) of the same random compute-dtype
    values, (n, t, ...)."""
    from solvingpapers_tpu.infer.cache import KVCache, LatentCache

    rng = np.random.default_rng(seed)
    shapes = ((n, t, 2, 8),) if kind == "kv" else ((n, t, 12),)
    if kind == "kv":
        j = [KVCache(k=jnp.asarray(rng.normal(0, 3, size=shapes[0]), dtype),
                     v=jnp.asarray(rng.normal(0, 3, size=shapes[0]), dtype))
             for _ in range(2)]
    else:
        j = [LatentCache(c=jnp.asarray(rng.normal(0, 3, size=shapes[0]), dtype))
             for _ in range(2)]
    from solvingpapers_tpu_torch.convert import _caches

    return j, _caches(jax.tree.map(np.asarray, j), "cpu")


def _leaves_np(caches):
    out = []
    for c in caches:
        for f in dataclasses.fields(c):
            a = getattr(c, f.name)
            if isinstance(a, torch.Tensor):
                a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
            else:
                a = np.asarray(a)
                if a.dtype.name == "bfloat16":
                    a = a.astype(np.float32)
            out.append(a)
    return out


def _assert_store_equal(port, ref, exact=True):
    for got, want in zip(_leaves_np(port.q), _leaves_np(ref.q)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(_leaves_np(port.scale), _leaves_np(ref.scale)):
        assert got.tobytes() == want.tobytes()
    if exact and ref.exact is not None:
        for got, want in zip(_leaves_np(port.exact), _leaves_np(ref.exact)):
            np.testing.assert_array_equal(got[1:], want[1:])


def _assert_lanes_equal(port, ref):
    for got, want in zip(_leaves_np(port), _leaves_np(ref)):
        np.testing.assert_array_equal(got, want)


DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]
KINDS = ["kv", "latent"]


# ------------------------------------------------------------ read helpers


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,jdt,tdt", DTYPES, ids=[d[0] for d in DTYPES])
def test_views_equal_the_reference(kind, name, jdt, tdt):
    js = _ref_store(kind, 3, 32, 8, jdt, exact_lanes=2)
    ps = _port_store(js)
    eidx_row = np.array([0, 2, 0], np.int32)
    _assert_lanes_equal(tkv.quant_lanes_view(ps, eidx_row),
                        _jit(jkv.quant_lanes_view)(js, jnp.asarray(eidx_row)))
    for slot, e in ((0, 0), (1, 1)):
        _assert_lanes_equal(tkv.quant_lane_view(ps, slot, e),
                            _jit(jkv.quant_lane_view)(js, slot, jnp.int32(e)))
    # page layout: 5 pages of 8, 2 slots of 2 logical pages, exact lanes 16
    jp = _ref_store(kind, 5, 8, 8, jdt, exact_lanes=2, exact_time=16)
    pp = _port_store(jp)
    table = np.array([[1, 3], [0, 0]], np.int64)
    row_e = np.array([0, 2], np.int32)
    _assert_lanes_equal(tkv.quant_gather_lanes(pp, torch.from_numpy(table), row_e),
                        _jit(jkv.quant_gather_lanes)(jp, jnp.asarray(table), jnp.asarray(row_e)))
    _assert_lanes_equal(tkv.quant_gather_lane(pp, torch.from_numpy(table[0]), 0),
                        _jit(jkv.quant_gather_lane)(jp, jnp.asarray(table[0]), jnp.int32(0)))


# ----------------------------------------------------------- write sites


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,jdt,tdt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("t0,t1,hi,eidx", [(0, 20, 13, 0), (8, 32, 27, 2),
                                           (16, 24, None, 1)],
                         ids=["padded-prefill", "suffix-after-hit", "no-hi"])
def test_quant_store_lane_byte_equal(kind, name, jdt, tdt, t0, t1, hi, eidx):
    js = _ref_store(kind, 3, 32, 8, jdt, exact_lanes=2)
    ps = _port_store(js)
    jl, tl = _lanes_like(kind, 1, 32, jdt, seed=11)
    jout = jkv.quant_store_lane(js, jl, 1, jnp.int32(eidx), t0, t1,
                                hi=None if hi is None else jnp.int32(hi))
    pout = tkv.quant_store_lane(ps, tl, 1, eidx, t0, t1, hi=hi)
    _assert_store_equal(pout, _np_store(jout))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,jdt,tdt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("tail_garbage", [False, True], ids=["decode", "spec"])
def test_quant_store_written_byte_equal(kind, name, jdt, tdt, tail_garbage):
    js = _ref_store(kind, 3, 32, 8, jdt, exact_lanes=2)
    ps = _port_store(js)
    # the lanes a decode block leaves: the dequantized view with a written
    # window per slot (one window clipped at the lane's end)
    view = _jit(jkv.quant_lanes_view)(js, jnp.zeros(3, jnp.int32))
    jl, _ = _lanes_like(kind, 3, 32, jdt, seed=12)
    pos0 = np.array([5, 12, 29], np.int64)
    span = 6
    t = np.arange(32)
    win = (t[None] >= pos0[:, None]) & (t[None] < pos0[:, None] + span)

    def mix(a, b):
        m = jnp.asarray(win.reshape(win.shape + (1,) * (a.ndim - 2)))
        return jnp.where(m, b, a)

    lanes = jax.tree.map(mix, view, jl)
    from solvingpapers_tpu_torch.convert import _caches

    tl = _caches(jax.tree.map(np.asarray, lanes), "cpu")
    eidx = np.array([0, 1, 2], np.int32)
    hi = pos0 + 3 if tail_garbage else None
    jout = jkv.quant_store_written(
        js, lanes, jnp.asarray(pos0, jnp.int32), span, jnp.asarray(eidx),
        hi=None if hi is None else jnp.asarray(hi, jnp.int32),
        tail_garbage=tail_garbage)
    pout = tkv.quant_store_written(
        ps, tl, torch.from_numpy(pos0), span, eidx,
        hi=None if hi is None else torch.from_numpy(hi),
        tail_garbage=tail_garbage)
    _assert_store_equal(pout, _np_store(jout))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,jdt,tdt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("start_page,hi,eidx", [(0, 13, 0), (1, 20, 1),
                                                (2, None, 0)],
                         ids=["full", "after-hit", "no-hi"])
def test_quant_scatter_lane_pages_byte_equal(kind, name, jdt, tdt, start_page,
                                             hi, eidx):
    js = _ref_store(kind, 6, 8, 8, jdt, exact_lanes=1, exact_time=32)
    ps = _port_store(js)
    row = np.array([2, 4, 1, 0], np.int64)
    jl, tl = _lanes_like(kind, 1, 32, jdt, seed=13)
    jout = jkv.quant_scatter_lane_pages(js, jl, jnp.asarray(row), start_page,
                                        jnp.int32(eidx),
                                        hi=None if hi is None else jnp.int32(hi))
    pout = tkv.quant_scatter_lane_pages(ps, tl, torch.from_numpy(row),
                                        start_page, eidx, hi=hi)
    # the trash page takes one copy of the tail: compare the real pages
    _assert_store_equal(_drop_trash(pout), _drop_trash(_np_store(jout)))


def _drop_trash(store):
    def cut(caches):
        return [dataclasses.replace(c, **{f.name: getattr(c, f.name)[1:]
                                          for f in dataclasses.fields(c)})
                for c in caches]
    return dataclasses.replace(store, q=cut(store.q), scale=cut(store.scale))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,jdt,tdt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("mode", ["decode", "window", "spec-window"])
def test_quant_scatter_pages_byte_equal(kind, name, jdt, tdt, mode):
    js = _ref_store(kind, 8, 8, 8, jdt, exact_lanes=2, exact_time=24)
    ps = _port_store(js)
    table = np.array([[1, 2, 3], [4, 5, 6]], np.int64)
    view = _jit(jkv.quant_gather_lanes)(js, jnp.asarray(table), jnp.zeros(2, jnp.int32))
    jl, _ = _lanes_like(kind, 2, 24, jdt, seed=14)
    pos0 = np.array([6, 13], np.int64)
    span = 5
    t = np.arange(24)
    win = (t[None] >= pos0[:, None]) & (t[None] < pos0[:, None] + span)
    lanes = jax.tree.map(
        lambda a, b: jnp.where(jnp.asarray(win.reshape(win.shape + (1,) * (a.ndim - 2))),
                               b, a), view, jl)
    from solvingpapers_tpu_torch.convert import _caches

    tl = _caches(jax.tree.map(np.asarray, lanes), "cpu")
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    if mode == "decode":
        jout, pout = js, ps
        for w in range((span - 1) // 8 + 2):
            pw = np.clip(pos0 + w * 8, 0, 23)
            jout = jkv.quant_scatter_written_pages(
                jout, lanes, jt, jnp.asarray(pw, jnp.int32),
                lo=jnp.asarray(pos0, jnp.int32),
                hi=jnp.asarray(pos0 + span, jnp.int32))
            pout = tkv.quant_scatter_written_pages(
                pout, tl, tt, torch.from_numpy(pw), lo=torch.from_numpy(pos0),
                hi=torch.from_numpy(pos0 + span))
        eidx = np.array([2, 0], np.int32)
        jout = jkv.quant_store_exact_lanes(jout, lanes, jnp.asarray(eidx))
        pout = tkv.quant_store_exact_lanes(pout, tl, eidx)
    else:
        last = pos0 + (2 if mode == "spec-window" else span - 1)
        jout = jkv.quant_scatter_window_pages(
            js, lanes, jt, jnp.asarray(pos0, jnp.int32),
            jnp.asarray(last, jnp.int32), span)
        pout = tkv.quant_scatter_window_pages(
            ps, tl, tt, torch.from_numpy(pos0), torch.from_numpy(last), span)
    _assert_store_equal(pout, _np_store(jout))


@pytest.mark.parametrize("kind", KINDS)
def test_scrubs_splice_and_extract_byte_equal(kind):
    js = _ref_store(kind, 3, 32, 8, jnp.float32, exact_lanes=2)
    ps = _port_store(js)
    jout = jkv.scrub_lane_program(js, jnp.int32(1), jnp.int32(2))
    tkv.scrub_lane(ps, 1, 2)
    _assert_store_equal(ps, _np_store(jout))
    # quantized segments: extract a span, splice it into another slot
    ctl = jnp.asarray([0, 8], jnp.int32)
    jseg = jkv._quant_extract_program(jout, ctl, 16)
    pool = tkv.KVSlotPool.__new__(tkv.KVSlotPool)
    pool._init_slots(3)
    pool.max_len, pool.quant, pool.quant_block, pool.caches = 32, "int8", 8, ps
    pseg = pool.extract_prefix(0, 8, 16)
    conv = quant_segment_from_reference(_np_store(jseg))
    assert pseg.nbytes == conv.nbytes and pseg.length == 16
    for a, b in zip(_leaves_np(pseg.q) + _leaves_np(pseg.scale),
                    _leaves_np(conv.q) + _leaves_np(conv.scale)):
        assert a.tobytes() == b.tobytes()
    jout = jkv._quant_splice_program(jout, jseg, jnp.asarray([2, 16], jnp.int32))
    pool.splice_prefix(2, pseg, 16)
    _assert_store_equal(ps, _np_store(jout))
    # paged scrub: listed pages and the exact lane
    jp = _ref_store(kind, 5, 8, 8, jnp.float32, exact_lanes=1, exact_time=16)
    pp = _port_store(jp)
    jout = jkv.scrub_pages_program(jp, jnp.asarray([3, 0, 0], jnp.int32),
                                   jnp.int32(1))
    tkv.scrub_pages(pp, [3, 0], 1)
    _assert_store_equal(pp, _np_store(jout))


# ======================================================================
# Engines
# ======================================================================

from durability_models import (  # noqa: E402
    VOCAB,
    gpt_tiny_pair,
    port_dsv3,
    port_model,
)
from solvingpapers_tpu_torch.serve import (  # noqa: E402
    SamplingParams,
    ServeConfig,
    ServeEngine,
)

QBASE = dict(n_slots=3, max_len=64, decode_block=4, bucket=16)
POOLS = [{}, dict(paged=True, page_size=16)]
POOL_IDS = ["lane", "paged"]


def _prompts(n, seed=0, lo=5, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=int(rng.integers(lo, hi))).astype(np.int64)
            for _ in range(n)]


def _run(cfg, prompts, max_new=10, params_for=None, model=None):
    eng = ServeEngine(model or port_model(), cfg, device="cpu")
    hs = [eng.submit(p, max_new_tokens=max_new,
                     params=params_for(i) if params_for else None)
          for i, p in enumerate(prompts)]
    eng.run()
    assert all(h.done for h in hs)
    return eng, [list(h.tokens) for h in hs]


def _agreement(ref, got):
    total = sum(len(r) for r in ref)
    return sum(int(a == b) for r, g in zip(ref, got) for a, b in zip(r, g)) / total


def _jax_run(cfg_kw, prompts, max_new=10):
    from solvingpapers_tpu.serve.engine import ServeConfig as JServeConfig
    from solvingpapers_tpu.serve.engine import ServeEngine as JServeEngine

    jm, params, _ = gpt_tiny_pair()
    eng = JServeEngine(jm, params, JServeConfig(**cfg_kw))
    hs = [eng.submit(np.asarray(p, np.int32), max_new_tokens=max_new)
          for p in prompts]
    eng.run()
    return eng, [list(map(int, h.tokens)) for h in hs]


@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
def test_quantized_streams_equal_the_reference_engine(pool):
    """Float32 greedy streams of the port's quantized engine equal the
    reference's quantized engine's token for token, and the codes the
    prefills leave differ by at most one on at most 0.1 % of entries (the
    packages' f32 k/v differ by ulps; under `jit` the reference also
    multiplies by the reciprocal of 127)."""
    _, _, tm = gpt_tiny_pair()
    prompts = _prompts(5, seed=21)
    kw = dict(QBASE, kv_quant="int8", kv_quant_block=16, **pool)
    jeng, want = _jax_run(kw, prompts)
    _, got = _run(ServeConfig(**kw), prompts, model=tm)
    assert got == want
    # codes after one prefill-only request on each engine
    kw1 = dict(kw, n_slots=1)
    jeng, _ = _jax_run(kw1, prompts[:1], max_new=1)
    teng, _ = _run(ServeConfig(**kw1), prompts[:1], max_new=1, model=tm)
    jstore = _np_store(jeng.pool.phys if pool else jeng.pool.caches)
    tstore = teng.pool.phys if pool else teng.pool.caches
    n = bad = 0
    for got_q, want_q in zip(_leaves_np(tstore.q), _leaves_np(jstore.q)):
        diff = np.abs(got_q.astype(np.int32) - want_q.astype(np.int32))
        assert diff.max() <= 1
        n += diff.size
        bad += int((diff > 0).sum())
    assert bad <= 0.001 * n
    for got_s, want_s in zip(_leaves_np(tstore.scale), _leaves_np(jstore.scale)):
        np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=0)


@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
def test_kv_exact_streams_byte_identical_in_mixed_batch(pool):
    """kv_exact rows of a mixed batch equal the unquantized engine's,
    quantized rows the all-quantized engine's: one engine, both service
    levels, in the same decode blocks."""
    prompts = _prompts(6, seed=2)
    _, ref = _run(ServeConfig(**QBASE, **pool), prompts)
    _, quant = _run(ServeConfig(**QBASE, kv_quant="int8", **pool), prompts)
    eng, mixed = _run(
        ServeConfig(**QBASE, kv_quant="int8", kv_exact_lanes=2, **pool), prompts,
        params_for=lambda i: SamplingParams(kv_exact=i % 2 == 0))
    for i in range(len(prompts)):
        assert mixed[i] == (ref[i] if i % 2 == 0 else quant[i]), i
    assert sorted(eng._exact_free) == [1, 2] and not eng._eidx.any()
    if pool:
        assert eng.pool.pages_free == eng.pool.page_budget


@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
def test_quant_prefix_cache_streams_exact_vs_cache_off(pool):
    """Cached int8 segments or pages splice back bitwise, so quantized
    greedy streams are token-exact with the prefix cache on or off; a
    kv_exact request neither reads nor feeds the tree."""
    rng = np.random.default_rng(4)
    stem = rng.integers(0, VOCAB, size=32)
    prompts = [np.concatenate([stem, rng.integers(0, VOCAB, size=5)])
               for _ in range(6)]
    qcfg = ServeConfig(**QBASE, kv_quant="int8", **pool)
    _, off = _run(qcfg, prompts, max_new=6)
    eng, on = _run(dataclasses.replace(qcfg, prefix_cache=True, prefix_page=16),
                   prompts, max_new=6)
    assert on == off
    assert eng.metrics.snapshot()["serve/prefix_hit_rate"] > 0.5
    _, ref = _run(ServeConfig(**QBASE, **pool), prompts, max_new=6)
    eng, got = _run(
        dataclasses.replace(qcfg, prefix_cache=True, prefix_page=16,
                            kv_exact_lanes=3),
        prompts, max_new=6, params_for=lambda i: SamplingParams(kv_exact=True))
    assert got == ref
    assert "serve/prefix_lookups" not in eng.metrics.snapshot()
    assert eng.prefix_cache.n_nodes == 0


def test_exact_lane_exhaustion_serializes_and_release_on_cancel():
    prompts = _prompts(5, seed=9)
    eng, got = _run(ServeConfig(**QBASE, kv_quant="int8", kv_exact_lanes=1),
                    prompts, params_for=lambda i: SamplingParams(kv_exact=True))
    _, ref = _run(ServeConfig(**QBASE), prompts)
    assert got == ref
    assert eng._exact_free == [1] and not eng._eidx.any()
    eng = ServeEngine(port_model(), ServeConfig(**QBASE, kv_quant="int8",
                                                kv_exact_lanes=1), device="cpu")
    req = eng.submit(_prompts(1, seed=10)[0], max_new_tokens=32,
                     params=SamplingParams(kv_exact=True))
    eng.step()
    assert eng._exact_free == []
    assert eng.statusz()["kv_quant"]["exact_slots"] == [req.slot]
    eng.cancel(req)
    eng.step()
    assert req.finish_reason == "cancelled" and eng._exact_free == [1]


@pytest.mark.parametrize("case", ["bad-mode", "lanes-unquantized", "block-0",
                                  "block-negative", "max-len", "prefix-page",
                                  "exact-without-lanes", "exact-unquantized"])
def test_config_validation(case):
    m = port_model()
    bad = {
        "bad-mode": (dict(kv_quant="fp8"), "kv_quant must be"),
        "lanes-unquantized": (dict(kv_exact_lanes=2), "kv_exact_lanes"),
        "block-0": (dict(kv_quant="int8", kv_quant_block=0), "kv_quant_block must be"),
        # -16 divides 64: only the sign check catches it
        "block-negative": (dict(kv_quant="int8", kv_quant_block=-16),
                           "kv_quant_block must be"),
        "max-len": (dict(kv_quant="int8", max_len=60), "not a multiple of the quant"),
        "prefix-page": (dict(kv_quant="int8", prefix_cache=True, prefix_page=24,
                             kv_quant_block=16), "prefix_page"),
    }
    if case in bad:
        kw, match = bad[case]
        with pytest.raises(ValueError, match=match):
            ServeEngine(m, ServeConfig(**{**QBASE, **kw}), device="cpu")
    elif case == "exact-without-lanes":
        eng = ServeEngine(m, ServeConfig(**QBASE, kv_quant="int8"), device="cpu")
        with pytest.raises(ValueError, match="kv_exact requests need"):
            eng.submit(np.arange(4), params=SamplingParams(kv_exact=True))
    else:  # kv_exact on an unquantized engine is a documented no-op
        eng = ServeEngine(m, ServeConfig(**QBASE), device="cpu")
        req = eng.submit(np.arange(4), max_new_tokens=2,
                         params=SamplingParams(kv_exact=True))
        eng.run()
        assert req.done


@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
def test_gauges_and_statusz_keys_equal_the_reference(pool):
    """The quantized pool's gauges and /statusz section carry the
    reference's keys and its analytic byte values."""
    prompts = _prompts(2, seed=7)
    kw = dict(QBASE, kv_quant="int8", kv_exact_lanes=1, **pool)
    jeng, _ = _jax_run(kw, prompts)
    eng, _ = _run(ServeConfig(**kw), prompts, model=gpt_tiny_pair()[2])
    snap, jsnap = eng.metrics.snapshot(), jeng.metrics.snapshot()
    keys = {k for k in jsnap if k.startswith(("serve/kv_quant", "serve/kv_bytes"))}
    assert keys == {k for k in snap if k.startswith(("serve/kv_quant", "serve/kv_bytes"))}
    assert len(keys) == 5
    for k in keys:
        assert snap[k] == pytest.approx(jsnap[k])
    doc, jdoc = eng.statusz()["kv_quant"], jeng.statusz()["kv_quant"]
    assert doc == jdoc
    store = eng.pool.phys if pool else eng.pool.caches
    pool_bytes, _, exact_bytes, base = tkv.quant_pool_bytes(store)
    assert eng.pool.nbytes == pool_bytes + exact_bytes
    assert pool_bytes <= 0.6 * base


def test_quant_pool_bytes_pinned_analytically():
    m = port_model()
    cfg = m.cfg
    n_slots, max_len, qb = 4, 64, 16
    plain = tkv.KVSlotPool(m, n_slots, max_len)
    pool = tkv.KVSlotPool(m, n_slots, max_len, quant="int8", quant_block=qb,
                          exact_lanes=2)
    leaf = n_slots * max_len * cfg.n_heads * cfg.head_dim
    expect_q = 2 * cfg.n_layers * leaf
    expect_s = 2 * cfg.n_layers * n_slots * (max_len // qb) * cfg.n_heads * 4
    expect_e = 2 * cfg.n_layers * 3 * max_len * cfg.n_heads * cfg.head_dim * 4
    assert tkv.quant_pool_bytes(pool.caches) == (expect_q + expect_s, expect_s,
                                                 expect_e, plain.nbytes)
    assert pool.nbytes == expect_q + expect_s + expect_e
    pplain = tkv.PagedKVPool(m, n_slots, max_len, 16)
    ppool = tkv.PagedKVPool(m, n_slots, max_len, 16, quant="int8")
    qp, _, ep, basep = tkv.quant_pool_bytes(ppool.phys)
    assert ep == 0 and basep == pplain.nbytes == ppool.n_pages * 16 * 2 * 2 * 64 * 4
    assert ppool.nbytes == qp and ppool.page_nbytes == qp // ppool.n_pages
    assert qp <= 0.6 * pplain.nbytes


@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
def test_deepseekv3_latent_lanes_quantize(pool):
    """MLA's 3-D latent lanes take one scale per (slot, time block) and
    serve through both pools; kv_exact streams are exact."""
    m = port_dsv3()
    prompts = _prompts(3, seed=4, lo=5, hi=14)
    base = dict(n_slots=2, max_len=32, decode_block=2, bucket=8, **pool)
    _, ref = _run(ServeConfig(**base), prompts, max_new=6, model=m)
    eng, got = _run(ServeConfig(**base, kv_quant="int8", kv_quant_block=16),
                    prompts, max_new=6, model=m)
    store = eng.pool.phys if pool else eng.pool.caches
    assert store.scale[0].c.ndim == 2
    assert _agreement(ref, got) >= 0.8
    _, exact = _run(ServeConfig(**base, kv_quant="int8", kv_quant_block=16,
                                kv_exact_lanes=2),
                    prompts, max_new=6, model=m,
                    params_for=lambda i: SamplingParams(kv_exact=True))
    assert exact == ref


@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
def test_prefill_pads_never_reach_quant_codes(pool):
    """Prompts pad right to the bucket; the pad positions' codes stay zero
    (the prefill stores zero them under `hi`, and decode rewrites of the
    block re-encode them from those zero codes)."""
    eng = ServeEngine(port_model(), ServeConfig(
        n_slots=1, max_len=64, decode_block=4, bucket=16, kv_quant="int8",
        kv_quant_block=16, **pool), device="cpu")
    h = eng.submit(np.arange(1, 11), max_new_tokens=2)
    pid = None
    while not h.done:
        eng.step()
        if pool and pid is None and eng.pool.table[0, 0] != 0:
            pid = int(eng.pool.table[0, 0])
    store = eng.pool.phys if pool else eng.pool.caches
    row = pid if pool else 0
    for q in tkv._leaves(store.q):
        assert not q[row, 14:16].any()


def test_bf16_decode_leaves_committed_codes_byte_equal():
    """No drift: in bfloat16, the codes and scales of every block
    committed before a decode stay byte-equal through it, on both pools
    (the stores re-encode committed positions from their own f32 codes,
    never from the bf16 lane view)."""
    from solvingpapers_tpu_torch.configs import get_config
    from solvingpapers_tpu_torch.models import GPT, init_params_for

    cfg = dataclasses.replace(get_config("gpt_tiny").model, dtype="bfloat16")
    m = GPT(cfg, device="cpu")
    m.load_state_dict(init_params_for(cfg)(cfg, torch.Generator().manual_seed(0)))
    m.eval()
    for pool in POOLS:
        eng = ServeEngine(m, ServeConfig(n_slots=1, max_len=64, decode_block=4,
                                         bucket=16, kv_quant="int8",
                                         kv_quant_block=16, **pool), device="cpu")
        h = eng.submit(np.arange(1, 34) % VOCAB, max_new_tokens=28)
        eng.step()  # prefill and the first block: positions [0, 37)
        store = eng.pool.phys if pool else eng.pool.caches
        rows = torch.as_tensor(eng.pool.table[0, :2].copy()) if pool else None

        def committed():
            if pool:  # pages 0-1 of the lane: positions [0, 32)
                return [t[rows].clone() for t in tkv._leaves(store.q) + tkv._leaves(store.scale)]
            return ([t[0, :32].clone() for t in tkv._leaves(store.q)]
                    + [t[0, :2].clone() for t in tkv._leaves(store.scale)])

        before = committed()
        while not h.done:
            eng.step()
        for a, b in zip(before, committed()):
            assert torch.equal(a, b)


def test_written_stores_keep_committed_codes_bf16():
    """The reference's planted-absmax case on the port's helpers: on a
    bf16 pool, a store that rewrites a block (or page) leaves the codes
    of its committed positions byte-equal when the write does not move
    the absmax, and a second identical store is idempotent."""
    from solvingpapers_tpu_torch.infer import KVCache
    from solvingpapers_tpu_torch.ops.quant import dequantize, quantize

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(-93.7, 93.7, size=(2, 32, 2, 8)).astype(np.float32))
    x[0, 9] = 93.7
    x[1, 17] = 93.7
    q0, s0 = quantize(x, 8)
    store = tkv.QuantStore(q=[KVCache(k=q0.clone(), v=q0.clone())],
                           scale=[KVCache(k=s0.clone(), v=s0.clone())],
                           exact=None, block=8, dtype=torch.bfloat16)
    lane = dequantize(q0, s0, torch.bfloat16)
    pos0 = torch.tensor([12, 20])
    new = torch.from_numpy(rng.uniform(-50, 50, size=(2, 4, 2, 8)).astype(np.float32))
    for s in range(2):
        lane[s, int(pos0[s]):int(pos0[s]) + 4] = new[s].to(torch.bfloat16)
    lanes = [KVCache(k=lane, v=lane.clone())]
    out = tkv.quant_store_written(store, lanes, pos0, 4, np.zeros(2, np.int64))
    for s in range(2):
        lo = int(pos0[s])
        assert torch.equal(out.q[0].k[s, :lo], q0[s, :lo]), s
    assert not torch.equal(out.q[0].k[0, 12:16], q0[0, 12:16])
    again = [t.clone() for t in tkv._leaves(out.q)]
    tkv.quant_store_written(out, lanes, pos0, 4, np.zeros(2, np.int64))
    assert all(torch.equal(a, b) for a, b in zip(again, tkv._leaves(out.q)))
    # paged: the same through the lo / hi window merge
    px = torch.from_numpy(rng.uniform(-93.7, 93.7, size=(5, 8, 2, 8)).astype(np.float32))
    px[2, 1] = 93.7
    pq0, ps0 = quantize(px, 8)
    pstore = tkv.QuantStore(q=[KVCache(k=pq0.clone(), v=pq0.clone())],
                            scale=[KVCache(k=ps0.clone(), v=ps0.clone())],
                            exact=None, block=8, dtype=torch.bfloat16)
    table = torch.tensor([[1, 2, 3]])
    g = dequantize(pq0, ps0, torch.bfloat16)[table[0]].reshape(1, 24, 2, 8)
    g[0, 12:16] = new[0].to(torch.bfloat16)
    pos = torch.tensor([12])
    pout = tkv.quant_scatter_written_pages(pstore, [KVCache(k=g, v=g.clone())],
                                           table, pos, lo=pos, hi=pos + 4)
    assert torch.equal(pout.q[0].k[2, :4], pq0[2, :4])
    assert not torch.equal(pout.q[0].k[2, 4:], pq0[2, 4:])
    assert torch.equal(pout.q[0].k[1], pq0[1]) and torch.equal(pout.q[0].k[3], pq0[3])


def test_quant_pool_rejects_plain_segment_splice():
    m = port_model()
    plain = tkv.KVSlotPool(m, 2, 64)
    pool = tkv.KVSlotPool(m, 2, 64, quant="int8", quant_block=16)
    with pytest.raises(TypeError, match="QuantSegment"):
        pool.splice_prefix(0, plain.extract_prefix(0, 0, 16))
    qseg = pool.extract_prefix(0, 0, 16)
    assert isinstance(qseg, tkv.QuantSegment)
    with pytest.raises(ValueError, match="not aligned"):
        pool.splice_prefix(0, qseg, offset=8)


# ------------------------------------------------------------ cross-plane

from durability_models import drive, no_leaks, port_engine  # noqa: E402
from durability_models import prompts as dprompts  # noqa: E402


@pytest.mark.parametrize("pool", [{}, dict(paged=True, page_size=8)],
                         ids=POOL_IDS)
def test_recovery_of_a_quantized_engine_is_token_exact(tmp_path, pool):
    """A kv_quant engine killed after step k and recovered from its
    journal gives the uninterrupted quantized run's streams (greedy and
    seeded), and leaks nothing."""
    ps = dprompts(4, seed=11)
    kw = dict(kv_quant="int8", kv_quant_block=8, **pool)

    def params_for(i):
        return SamplingParams(temperature=0.8, seed=i) if i % 3 == 0 else None

    ref_eng = port_engine(**kw)
    ref = [ref_eng.submit(p, 10, params=params_for(i)) for i, p in enumerate(ps)]
    drive(ref_eng, [], 10)
    for k in (1, 3):
        path = str(tmp_path / f"j{k}.jsonl")
        eng = port_engine(journal_path=path, **kw)
        hs = [eng.submit(p, 10, params=params_for(i)) for i, p in enumerate(ps)]
        for _ in range(k):
            eng.step()
        del eng  # the crash
        eng2 = port_engine(journal_path=path, **kw)
        resumed = {r.trace_id: r for r in eng2.recover()}
        drive(eng2, [], 10)
        got = [resumed[h.trace_id].tokens if h.trace_id in resumed else h.tokens
               for h in hs]
        assert got == [r.tokens for r in ref], k
        assert no_leaks(eng2)


def _kv_exact_entry(tmp_path, max_new=24):
    """A journaled kv_exact request on a quantized engine with an exact
    lane, killed mid-stream: (journal path, the unquantized engine's
    stream of the same prompt)."""
    p = dprompts(1, seed=5)[0]
    path = str(tmp_path / "x.jsonl")
    eng = port_engine(journal_path=path, kv_quant="int8", kv_exact_lanes=1)
    eng.submit(p, max_new, params=SamplingParams(kv_exact=True))
    eng.step()
    eng.step()
    del eng
    want = drive(port_engine(), [p], max_new)[0].tokens
    return path, want


def test_journaled_kv_exact_request_keeps_its_exact_lane_through_recover(tmp_path):
    """The recovered kv_exact stream resumes on an exact lane, not on int8
    storage, and equals the unquantized engine's; an engine without exact
    lanes finishes the entry "error" with the reference's reason."""
    path, want = _kv_exact_entry(tmp_path)
    eng = port_engine(journal_path=path, kv_quant="int8", kv_exact_lanes=1)
    (req,) = eng.recover()
    assert req.params.kv_exact
    eng.step()
    assert eng._eidx[req.slot] == 1
    drive(eng, [], 24)
    assert req.tokens == want and eng._exact_free == [1]
    (tmp_path / "b").mkdir()
    path2, _ = _kv_exact_entry(tmp_path / "b")
    eng = port_engine(journal_path=path2, kv_quant="int8")
    with pytest.warns(UserWarning, match="kv_exact needs exact sidecar lanes"):
        assert eng.recover() == []


def test_adopted_and_replayed_kv_exact_entries_keep_their_flag(tmp_path):
    """`adopt` (the fleet's migration) and the replay harness's screen
    follow the same rule: an exact lane when the engine has one, the
    reference's refusal when it has none."""
    from solvingpapers_tpu_torch.serve.journal import read_entries
    from solvingpapers_tpu_torch.serve.replay import ReplayHarness

    path, want = _kv_exact_entry(tmp_path)
    (entry,) = [e for e in read_entries(path) if not e.finished]
    eng = port_engine(journal_path=str(tmp_path / "peer.jsonl"),
                      kv_quant="int8", kv_exact_lanes=1)
    req = eng.adopt(entry)
    assert req.params.kv_exact
    drive(eng, [], 24)
    assert req.tokens == want
    bare = port_engine(journal_path=str(tmp_path / "bare.jsonl"), kv_quant="int8")
    with pytest.raises(ValueError, match="kv_exact needs exact sidecar lanes"):
        bare.adopt(entry)
    # replay: the finished stream of the peer's journal
    entries = read_entries(str(tmp_path / "peer.jsonl"))
    harness = ReplayHarness(port_model())
    cfg = ServeConfig(**{**dict(n_slots=3, max_len=48, decode_block=4, bucket=8)})
    skip = harness.run(entries, dataclasses.replace(cfg, kv_quant="int8"),
                       cut_stride=0)
    assert [s["reason"] for s in skip["skipped"]] == ["kv_exact needs exact sidecar lanes"]
    exact = harness.run(entries, dataclasses.replace(cfg, kv_quant="int8",
                                                     kv_exact_lanes=1),
                        cut_stride=0)
    assert exact["byte_exact_rate"] == 1.0 and exact["candidate"]["kv_quant"] == "int8"


@pytest.mark.parametrize("pool", [{}, dict(paged=True, page_size=4)], ids=POOL_IDS)
def test_quarantine_on_a_quantized_pool_scrubs_codes_scales_and_exact_lane(pool):
    """A NaN decode quarantines its slot: codes and scale rows scrubbed
    (a NaN scale would dequantize the whole block to NaN for the next
    occupant), the exact lanes free again, and a fresh stream through the
    scrubbed slot runs clean."""
    ps = dprompts(3, seed=21)
    eng = port_engine(fault_plan=[dict(site="decode", kind="nan", visit=1, slot=0)],
                      kv_quant="int8", kv_quant_block=4, kv_exact_lanes=1, **pool)
    hs = drive(eng, ps, 10)
    assert sum(h.finish_reason == "error" for h in hs) == 1
    store = eng.pool.phys if pool else eng.pool.caches
    for t in tkv._leaves(store.q) + tkv._leaves(store.scale):
        assert torch.isfinite(t.float()).all()
    h = drive(eng, [ps[0]], 10)[0]
    assert h.finish_reason == "length" and len(h.tokens) == 10
    assert no_leaks(eng) and eng._exact_free == [1]


def test_replay_with_an_int8_candidate(tmp_path):
    """A journal of the exact engine replayed through a kv_quant=int8
    candidate: every stream compared, the candidate named in the report,
    agreement graded."""
    from solvingpapers_tpu_torch.serve.journal import read_entries
    from solvingpapers_tpu_torch.serve.replay import ReplayHarness, apply_overrides

    path = str(tmp_path / "j.jsonl")
    drive(port_engine(journal_path=path), dprompts(4, seed=3), 10)
    cfg = ServeConfig(n_slots=3, max_len=48, decode_block=4, bucket=8)
    cand = apply_overrides(cfg, {"kv_quant": "int8", "kv_quant_block": "8"})
    report = ReplayHarness(port_model()).run(read_entries(path), cand, cut_stride=4)
    assert report["candidate"]["kv_quant"] == "int8"
    assert report["streams_compared"] == 4 and not report["skipped"]
    assert 0.0 <= report["agreement_rate_greedy"] <= 1.0


@pytest.mark.parametrize("argv", [
    ["serve", "--kv-quant", "int8", "--kv-quant-block", "8", "--kv-exact-lanes", "2"],
    ["replay", "--journal", "j.jsonl", "--kv-quant", "int8", "--kv-exact-lanes=1"],
    ["serve-bench", "--kv-quant", "int8", "--kv-quant-block", "8",
     "--quant-train-steps", "3"],
], ids=["serve", "replay", "serve-bench"])
def test_cli_accepts_the_quantized_pool_flags(argv):
    from solvingpapers_tpu_torch import cli

    args = cli.build_parser().parse_args([argv[0], "--config", "gpt_tiny", *argv[1:]])
    assert args.kv_quant == "int8"
    if argv[0] == "serve":
        import types

        cfg = cli._serve_config(args, types.SimpleNamespace(max_positions=128))
        assert (cfg.kv_quant, cfg.kv_quant_block, cfg.kv_exact_lanes) == ("int8", 8, 2)
    elif argv[0] == "replay":
        assert args.kv_exact_lanes == 1
    else:
        assert (args.kv_quant_block, args.quant_train_steps) == (8, 3)


def test_cli_serve_bench_kv_quant_runs(capsys):
    from solvingpapers_tpu_torch import cli

    rc = cli.main(["serve-bench", "--config", "gpt_tiny", "--device", "cpu",
                   "--kv-quant", "int8", "--requests", "4", "--slots", "2",
                   "--max-new-tokens", "8", "--decode-block", "4",
                   "--prompt-lens", "8", "16", "--quant-train-steps", "2",
                   "--reps", "1"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    line = json.loads(out)
    assert rc == 0 and line["metric"] == "serve_quant_slots_at_equal_hbm"
    assert line["detail"]["kv_dtype"] == "int8"
