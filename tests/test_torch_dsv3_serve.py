"""The port's cached DeepSeek-V3 — the latent cache, cached MLA, `generate`
and the lane-pool `ServeEngine` — vs the JAX package's, on the same
weights.

A tiny model (dim 64, 2 layers, 4 heads, latent 8, decoupled RoPE 8,
4 experts top-2 with a shared expert, vocab 256, float32, dropout 0)
is initialised in JAX with random routing biases and carried across
with `convert.flax_to_torch`. Both packages run the same numpy-made
prompts:

* the cached prefill in chunks of 4, 8 and the whole prompt equals the
  port's uncached forward and JAX's cached `apply` at the same chunks
  (logits and latent cache rows), with `use_flash` on — the port's
  plain flash version on the CPU, JAX's flash path on the CPU — and off;
  a decode step's logits likewise;
* greedy `generate` equals JAX's `generate` token for token, chunked
  and not;
* `ServeEngine` over latent lanes: staggered requests on 2 slots give
  the per-request greedy streams of the port's and JAX's `generate`;
* the MoE rule of the pooled decode: at 16 slots, 8 experts top-2 and
  capacity factor 2 (a pooled capacity of 8 for 16 tokens), a routing
  bias that sends every token to one expert still gives the streams of
  batch-1 `generate`, and a pooled dispatch does not;
* `rows` dispatch equals each row dispatched alone, drops included;
  lanes of latent caches are views.

Tolerances: float32 logits within 1e-5 (relative and absolute), as
`tests/test_torch_deepseekv3.py` holds the uncached forward; cache rows
within 1e-5; greedy streams token-exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu.infer import generate as jgenerate
from solvingpapers_tpu.infer.cache import LatentCache as JLatentCache
from solvingpapers_tpu.infer.cache import update_latent_cache as j_update
from solvingpapers_tpu.models.deepseekv3 import DeepSeekV3 as JDeepSeekV3
from solvingpapers_tpu.models.deepseekv3 import DeepSeekV3Config as JConfig
from solvingpapers_tpu_torch import ops
from solvingpapers_tpu_torch.convert import flax_to_torch
from solvingpapers_tpu_torch.infer import LatentCache, generate, update_latent_cache
from solvingpapers_tpu_torch.models import DeepSeekV3, DeepSeekV3Config
from solvingpapers_tpu_torch.serve import (
    KVSlotPool,
    ServeConfig,
    ServeEngine,
    extract_lane,
    store_lane,
)
from solvingpapers_tpu_torch.serve import engine as tengine
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)


TOL = 1e-5
VOCAB = 256
TINY = dict(vocab_size=VOCAB, block_size=64, dim=64, n_layers=2, n_heads=4,
            latent_dim=8, rope_dim=8, n_experts=4, top_experts=2,
            dtype="float32", use_flash=True, dropout=0.0, attn_dropout=0.0,
            pe_scale=0.02)
# dsv3_long's routing: 8 experts, top 2, capacity factor 2
ROUTED = dict(TINY, n_experts=8, capacity_factor=2.0)
NEW = 8


def _close(t, j, tol=TOL, msg=""):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol,
                               err_msg=msg)


def _pair(bias=None, expert_scale=1.0, **kw):
    """(JAX model, its variables, the port's model) on the same weights;
    routing biases N(0, 0.3) from a numpy seed, or `bias(e)` per layer;
    the routed experts' w1, w2 and w3 times `expert_scale`."""
    cfg = {**TINY, **kw}
    jm = JDeepSeekV3(JConfig(**cfg))
    # the same parameters and routing state, bit for bit, from the dense
    # twin: init's forward through the interpret-mode flash kernel takes
    # 20x as long and only its sown metrics differ
    variables = JDeepSeekV3(JConfig(**{**cfg, "use_flash": False})).init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 8), jnp.int32))

    def scaled(path, w):
        w = np.asarray(w)
        return w * expert_scale if path[-1].key in ("w1", "w2", "w3") else w

    params = jax.tree_util.tree_map_with_path(scaled, variables["params"])
    r = np.random.default_rng(1)
    moe_state = jax.tree.map(
        lambda b: (np.asarray(bias(b.shape[0]), np.float32) if bias else
                   np.asarray(r.standard_normal(b.shape) * 0.3, np.float32)),
        variables["moe_state"])
    tm = DeepSeekV3(DeepSeekV3Config(**cfg), device="cpu").eval()
    tm.load_state_dict(flax_to_torch(params, {"moe_state": moe_state}))
    return jm, {"params": params, "moe_state": moe_state}, tm


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def pairs():
    return {flash: _pair(use_flash=flash) for flash in (True, False)}


def _prompt(seed, b=2, s=17):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, s))


def _port_prefill(tm, toks, chunk, max_len=32):
    b, s = toks.shape
    caches = tm.init_caches(b, max_len)
    step = chunk or s
    logits = []
    for start in range(0, s, step):
        end = min(start + step, s)
        pos = torch.arange(start, end).expand(b, end - start)
        out, caches = tm(torch.from_numpy(toks[:, start:end]), positions=pos,
                         caches=caches, attend_len=end)
        logits.append(out)
    return torch.cat(logits, 1), caches


_APPLY = {}


def _apply(jm):
    """`jm.apply` under `jax.jit`, one a model: the reference's forward as
    the JAX package runs it, compiled once a shape, where an eager call
    runs the interpret-mode flash kernel's grid op by op (seconds a call)."""
    if id(jm) not in _APPLY:
        _APPLY[id(jm)] = (jm, jax.jit(jm.apply, static_argnames=(
            "deterministic", "attend_len")))
    return _APPLY[id(jm)][1]


def _jax_prefill(jm, variables, toks, chunk, max_len=32):
    b, s = toks.shape
    caches = jm.init_caches(b, max_len)
    step = chunk or s
    logits = []
    for start in range(0, s, step):
        end = min(start + step, s)
        pos = jnp.broadcast_to(jnp.arange(start, end), (b, end - start))
        out, caches = _apply(jm)(variables, jnp.asarray(toks[:, start:end]),
                                 positions=pos, caches=caches,
                                 deterministic=True, attend_len=end)
        logits.append(np.asarray(out))
    return np.concatenate(logits, 1), caches


# ------------------------------------------------------------ the cache


@pytest.mark.parametrize("index", [0, 5, 30, -3], ids=str)
def test_latent_cache_writes_like_dynamic_update_slice(index):
    """An int offset writes every row where JAX's `update_latent_cache`
    does, clamped at the end; per-row offsets write each row at its own."""
    r = np.random.default_rng(0)
    new = r.standard_normal((2, 4, 16)).astype(np.float32)
    cache = update_latent_cache(LatentCache.init(2, 32, 16, torch.float32),
                                torch.from_numpy(new), index)
    want = j_update(JLatentCache.init(2, 32, 16, jnp.float32),
                    jnp.asarray(new), index)
    np.testing.assert_array_equal(cache.c.numpy(), np.asarray(want.c))
    rows = update_latent_cache(LatentCache.init(2, 32, 16, torch.float32),
                               torch.from_numpy(new[:, :1]),
                               torch.tensor([3, 40]))
    assert torch.equal(rows.c[0, 3], torch.from_numpy(new[0, 0]))
    assert torch.equal(rows.c[1, 31], torch.from_numpy(new[1, 0]))  # clamped
    assert rows.c.abs().sum() == rows.c[0, 3].abs().sum() + rows.c[1, 31].abs().sum()


def test_init_caches_shape_dtype_and_device():
    tm = DeepSeekV3(DeepSeekV3Config(**{**TINY, "dtype": "bfloat16"}),
                    device="cpu")
    caches = tm.init_caches(3, 40)
    assert len(caches) == 2
    assert all(isinstance(c, LatentCache) and c.c.shape == (3, 40, 16)
               and c.c.dtype == torch.bfloat16 for c in caches)
    assert tm.init_caches(1, 8, torch.float32)[0].c.dtype == torch.float32


# ------------------------------------------------ prefill, decode, generate


@pytest.mark.parametrize("chunk", [4, 8, None], ids=["chunk4", "chunk8", "whole"])
@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "dense"])
def test_cached_prefill_matches_uncached_and_jax(pairs, use_flash, chunk):
    jm, variables, tm = pairs[use_flash]
    toks = _prompt(2)
    logits, caches = _port_prefill(tm, toks, chunk)
    full, _ = tm(torch.from_numpy(toks))
    _close(logits, full.numpy(), msg="cached prefill vs the uncached forward")
    jlogits, jcaches = _jax_prefill(jm, variables, toks, chunk)
    _close(logits, jlogits, msg="cached prefill vs JAX")
    for c, jc in zip(caches, jcaches):
        _close(c.c, jc.c, msg="latent cache rows")


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "dense"])
def test_decode_step_matches_jax(pairs, use_flash):
    """After an 8-token chunked prefill of 17 tokens, one decode step at
    position 17 (each row at its own position in the port) gives JAX's
    logits and cache rows."""
    jm, variables, tm = pairs[use_flash]
    toks = _prompt(3)
    _, caches = _port_prefill(tm, toks, 8)
    _, jcaches = _jax_prefill(jm, variables, toks, 8)
    nxt = np.array([[5], [77]])
    logits, caches = tm(torch.from_numpy(nxt), positions=torch.full((2, 1), 17),
                        caches=caches)
    jlogits, jcaches = _apply(jm)(variables, jnp.asarray(nxt),
                                  positions=jnp.full((2, 1), 17),
                                  caches=jcaches, deterministic=True)
    _close(logits, jlogits)
    for c, jc in zip(caches, jcaches):
        _close(c.c, jc.c)


@pytest.mark.parametrize("chunk", [None, 8], ids=["one-shot", "chunk8"])
@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "dense"])
def test_generate_matches_jax_generate(pairs, use_flash, chunk):
    jm, variables, tm = pairs[use_flash]
    toks = _prompt(4)
    out = generate(tm, torch.from_numpy(toks), max_new_tokens=NEW,
                   prefill_chunk=chunk, device="cpu")
    jout = jgenerate(jm, variables["params"], jnp.asarray(toks, jnp.int32),
                     jax.random.key(0), max_new_tokens=NEW,
                     extra_variables={"moe_state": variables["moe_state"]},
                     prefill_chunk=chunk)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_cached_forward_refuses_training_mode_with_dropout(pairs):
    _, _, tm = pairs[True]
    model = DeepSeekV3(DeepSeekV3Config(**{**TINY, "dropout": 0.1}),
                       device="cpu")
    model.load_state_dict(tm.state_dict())
    with pytest.raises(ValueError, match="eval mode"):
        generate(model.train(), torch.zeros(1, 4, dtype=torch.long),
                 max_new_tokens=2, device="cpu")
    out = generate(model.eval(), torch.zeros(1, 4, dtype=torch.long),
                   max_new_tokens=2, device="cpu")
    assert out.shape == (1, 6)


# ------------------------------------------------------------------ serving


def _port_stream(tm, prompt, max_new):
    out = generate(tm, torch.from_numpy(prompt)[None], max_new_tokens=max_new,
                   device="cpu")
    return out[0, len(prompt):].tolist()


def _jax_stream(jm, variables, prompt, max_new):
    out = jgenerate(jm, variables["params"], jnp.asarray(prompt, jnp.int32)[None],
                    jax.random.key(0), max_new_tokens=max_new,
                    extra_variables={"moe_state": variables["moe_state"]})
    return np.asarray(out[0, len(prompt):]).tolist()


def test_engine_streams_match_port_and_jax_generate(pairs):
    """2 slots, 5 staggered requests, prompts bucketed to 8 and prefilled
    in chunks of 8: each greedy stream equals the port's and JAX's
    batch-1 `generate`."""
    jm, variables, tm = pairs[True]
    eng = ServeEngine(tm, ServeConfig(n_slots=2, max_len=64, decode_block=4,
                                      bucket=8, prefill_chunk=8), device="cpu")
    r = np.random.default_rng(5)
    prompts = [r.integers(0, VOCAB, int(n)) for n in (5, 13, 9, 20, 3)]
    handles = [eng.submit(p, max_new_tokens=NEW) for p in prompts[:2]]
    eng.step()
    handles += [eng.submit(p, max_new_tokens=NEW) for p in prompts[2:]]
    eng.run()
    for p, h in zip(prompts, handles):
        assert h.done and h.finish_reason == "length"
        assert h.tokens == _port_stream(tm, p, NEW), f"len {len(p)} vs port"
        assert h.tokens == _jax_stream(jm, variables, p, NEW), (
            f"len {len(p)} vs the JAX package")
    assert eng.pool.n_active == 0


HOT = 3  # the expert every token picks


def _skewed():
    # every layer's bias sends every token to expert HOT (its second
    # expert still follows the gate), which then carries nearly all the
    # weight; experts scaled up 4x (64x their output) so that a dropped
    # pair moves the residual stream by O(1); one layer is enough for that
    return _pair(bias=lambda e: np.where(np.arange(e) == HOT, 10.0, 0.0),
                 expert_scale=4.0, **{**ROUTED, "n_layers": 1})


def test_sixteen_slots_route_each_row_as_batch_one():
    """16 slots with `dsv3_long`'s routing and every token sent to one
    expert: a pooled dispatch would give that expert a capacity of 8 for
    the 16 decode tokens and drop half of them; per-row routing drops
    none, as each slot's batch-1 forward under the reference's `vmap`.
    Prompts of at most 8 tokens keep every prefill under its capacity
    of 8, so prefill drops nothing either. Every stream equals batch-1
    `generate` (the port's and, for a few, JAX's); with the per-row rule
    switched off, streams differ."""
    jm, variables, tm = _skewed()
    r = np.random.default_rng(7)
    prompts = [r.integers(0, VOCAB, int(r.integers(2, 9))) for _ in range(16)]

    # the ops agree on what pooled routing would drop
    x = torch.from_numpy(r.standard_normal((16, 64)).astype(np.float32))
    gate = tm.layers[0].moe.gate(x) + tm.layers[0].moe.routing_bias
    probs = ops.moe.topk_gate_probs(gate, 2)
    assert (probs[:, HOT] > 0.99).all()
    pooled_cap = ops.moe.expert_capacity(16, 8, 2, 2.0)
    assert pooled_cap == 8
    assert ops.moe.dispatch_drop_fraction(probs, pooled_cap).item() == 0.25
    row_cap = ops.moe.expert_capacity(1, 8, 2, 2.0)
    assert ops.moe.dispatch_drop_fraction(probs, row_cap, rows=16).item() == 0

    def run():
        eng = ServeEngine(tm, ServeConfig(n_slots=16, max_len=32,
                                          decode_block=4, bucket=8),
                          device="cpu")
        handles = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
        eng.run()
        return [h.tokens for h in handles]

    want = [_port_stream(tm, p, NEW) for p in prompts]
    assert run() == want
    for p, w in list(zip(prompts, want))[:3]:
        assert w == _jax_stream(jm, variables, p, NEW)

    pooled = tengine.pooled_decode_kwargs
    tengine.pooled_decode_kwargs = lambda model: {}
    try:
        assert run() != want
    finally:
        tengine.pooled_decode_kwargs = pooled


def test_pooled_decode_kwargs_name_row_routing_only_for_routed_models():
    tm = DeepSeekV3(DeepSeekV3Config(**TINY), device="cpu")
    assert tengine.pooled_decode_kwargs(tm) == {"row_routing": True}
    assert tengine.pooled_decode_kwargs(torch.nn.Linear(2, 2)) == {}


@pytest.mark.parametrize("s,cf", [(1, 2.0), (12, 0.5), (20, 1.0)])
def test_rows_dispatch_equals_each_row_alone(s, cf):
    """`rows` dispatch over R rows of S tokens equals each row's own
    dispatch at capacity expert_capacity(S), drops included (S 12 at
    capacity factor 0.5 and S 20 at 1.0 overflow a capacity of 8)."""
    r = np.random.default_rng(s)
    rows, e, d = 5, 4, 6
    x = torch.from_numpy(r.standard_normal((rows * s, d)).astype(np.float32))
    logits = torch.from_numpy(r.standard_normal((rows * s, e)).astype(np.float32))
    logits[:, 1] += 2.0  # a hot expert: rows overflow it
    probs = ops.moe.topk_gate_probs(logits, 2)
    w = torch.from_numpy(r.standard_normal((e, d, d)).astype(np.float32))

    def expert_fn(xe):
        return torch.bmm(xe, w)

    cap = ops.moe.expert_capacity(s, e, 2, cf)
    got = ops.moe.moe_dispatch_combine(x, probs, expert_fn, cap, rows=rows)
    want = torch.cat([ops.moe.moe_dispatch_combine(
        x[i * s:(i + 1) * s], probs[i * s:(i + 1) * s], expert_fn, cap)
        for i in range(rows)])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    drops = [ops.moe.dispatch_drop_fraction(probs[i * s:(i + 1) * s], cap)
             for i in range(rows)]
    np.testing.assert_allclose(
        ops.moe.dispatch_drop_fraction(probs, cap, rows=rows).item(),
        float(sum(d * 2 * s for d in drops) / (2 * s * rows)), rtol=1e-6)
    if s > cap:
        assert max(drops) > 0
    with pytest.raises(ValueError, match="equal rows"):
        ops.moe.moe_dispatch_combine(x[:-1], probs[:-1], expert_fn, cap,
                                     rows=rows)


def test_latent_lanes_are_views(pairs):
    _, _, tm = pairs[True]
    pool = KVSlotPool(tm, n_slots=3, max_len=16)
    assert all(isinstance(c, LatentCache) for c in pool.caches)
    s = pool.acquire()
    lane = extract_lane(pool.caches, s)
    assert lane[0].c.shape == (1, 16, 16)
    assert lane[0].c.data_ptr() == pool.caches[0].c[s:s + 1].data_ptr()
    lane[1].c.fill_(2.0)
    assert (pool.caches[1].c[s] == 2.0).all()
    assert (pool.caches[1].c.sum() == pool.caches[1].c[s].sum())
    store_lane(pool.caches, lane, s)  # a view: nothing to copy
    other = [dataclasses.replace(c, c=c.c.clone() + 1) for c in lane]
    store_lane(pool.caches, other, s)
    assert (pool.caches[1].c[s] == 3.0).all()
    with pytest.raises(TypeError, match="dtype"):
        store_lane(pool.caches, [LatentCache(c=c.c.double()) for c in lane], s)
