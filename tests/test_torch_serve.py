"""The port's serving engine (lane and paged pools) vs one-shot generation.

The contract, as for the JAX package's engine: iteration-level
scheduling over a slot pool is invisible in the tokens. Every greedy
stream equals a per-request one-shot greedy `generate` — the JAX
package's, on the same weights carried across with `convert.py`, and
the port's own — however requests interleave, which lane they land in,
how prompts are bucketed and how prefill is chunked. Seeded sampled
streams repeat run to run (the two packages' generators differ, so
sampled tokens are never compared across them). A lane freed by an
early EOS is re-acquired by a queued request while others still decode.

Model: `use_flash=True` LLaMA-3, 2 layers, dim 64, 4 q / 2 kv heads,
vocab 256, float32, on the CPU (the JAX flash kernel in interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu.infer import generate as jgenerate
from solvingpapers_tpu.models.llama3 import Llama as JLlama
from solvingpapers_tpu.models.llama3 import LlamaConfig as JLlamaConfig
from solvingpapers_tpu_torch.convert import flax_to_torch
from solvingpapers_tpu_torch.infer import generate
from solvingpapers_tpu_torch.models import Llama, LlamaConfig
from solvingpapers_tpu_torch.serve import (
    FIFOScheduler,
    KVSlotPool,
    Request,
    SamplingParams,
    ServeConfig,
    ServeEngine,
    extract_lane,
    store_lane,
)

TINY = dict(vocab_size=256, max_seq_len=64, dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2, dtype="float32", use_flash=True)
NEW = 10


@pytest.fixture(scope="module")
def pair():
    jm = JLlama(JLlamaConfig(**TINY))
    params = jm.init({"params": jax.random.key(0)},
                     jnp.zeros((1, 8), jnp.int32))["params"]
    tm = Llama(LlamaConfig(**TINY), device="cpu")
    tm.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _prompts(n, seed, lo=5, hi=21):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, size=int(r.integers(lo, hi))) for _ in range(n)]


def _port_stream(tm, prompt, max_new, eos_id=None):
    out = generate(tm, torch.from_numpy(prompt)[None], max_new_tokens=max_new,
                   eos_id=eos_id, device="cpu")
    gen = out[0, len(prompt):].tolist()
    if eos_id is not None and eos_id in gen:
        gen = gen[:gen.index(eos_id) + 1]
    return gen


_JAX_STREAMS = {}


def _jax_stream(jm, params, prompt, max_new):
    key = (prompt.tobytes(), max_new)  # one model per module: memoized
    if key not in _JAX_STREAMS:
        out = jgenerate(jm, params, jnp.asarray(prompt, jnp.int32)[None],
                        jax.random.key(0), max_new_tokens=max_new)
        _JAX_STREAMS[key] = np.asarray(out[0, len(prompt):]).tolist()
    return _JAX_STREAMS[key]


def _engine(tm, **kw):
    cfg = dict(n_slots=3, max_len=64, decode_block=4, bucket=8,
               prefill_chunk=8)
    cfg.update(kw)
    return ServeEngine(tm, ServeConfig(**cfg), device="cpu")


@pytest.mark.parametrize("paged", [False, True], ids=["lane", "paged"])
def test_staggered_requests_match_jax_and_port_generate(pair, paged):
    """3 slots, 6 requests in two staggered waves, bucketed to 8 and
    prefilled in chunks of 8 (so the last real token's logits often sit
    in a non-final chunk): every greedy stream is token-exact vs the JAX
    package's `generate` on the same weights and vs the port's, on the
    lane pool and on the paged pool (pages of 8)."""
    jm, params, tm = pair
    eng = _engine(tm, **(dict(paged=True, page_size=8) if paged else {}))
    prompts = _prompts(6, seed=1)
    handles = [eng.submit(p, max_new_tokens=NEW) for p in prompts[:3]]
    for _ in range(2):  # the first wave is mid-flight when the second comes
        eng.step()
    handles += [eng.submit(p, max_new_tokens=NEW) for p in prompts[3:]]
    eng.run()
    for p, h in zip(prompts, handles):
        assert h.done and h.finish_reason == "length"
        port = _port_stream(tm, p, NEW)
        assert h.tokens == port, f"request {h.id} (len {len(p)}) vs port"
        assert h.tokens == _jax_stream(jm, params, p, NEW), (
            f"request {h.id} (len {len(p)}) vs the JAX package")
    snap = eng.metrics.snapshot()
    assert snap["serve/requests_finished"] == 6
    assert snap["serve/tokens_out"] == 6 * NEW
    assert snap["serve/tokens_prefilled"] == sum(len(p) for p in prompts)
    assert 0 < snap["serve/slot_occupancy"] <= 1
    assert snap["serve/finish_length"] == 6
    assert len(eng.metrics.ttft) == 6 and len(eng.metrics.itl) == 6 * (NEW - 1)
    assert eng.pool.n_active == 0 and eng.pool.n_free == 3
    if paged:
        assert snap["serve/pages_free"] == eng.pool.page_budget


def test_port_generate_chunking_is_invisible(pair):
    """`generate`'s chunked prefill (chunk 8 over a 21-token prompt)
    gives the unchunked stream."""
    _, _, tm = pair
    p = _prompts(1, seed=2, lo=21, hi=22)[0]
    whole = generate(tm, torch.from_numpy(p)[None], max_new_tokens=6,
                     device="cpu")
    chunked = generate(tm, torch.from_numpy(p)[None], max_new_tokens=6,
                       prefill_chunk=8, device="cpu")
    assert torch.equal(whole, chunked)


SEEDED = SamplingParams(temperature=0.8, top_p=0.9, seed=7)


def test_mixed_greedy_and_seeded_batch_keeps_greedy_exact(pair):
    """Seeded sampled rows in the same decode batch leave the greedy
    rows' streams untouched."""
    _, _, tm = pair
    eng = _engine(tm, n_slots=4)
    prompts = _prompts(4, seed=3)
    params = [None, SEEDED, None, SamplingParams(temperature=1.2, top_k=5,
                                                 min_p=0.05, seed=3)]
    handles = [eng.submit(p, max_new_tokens=NEW, params=sp)
               for p, sp in zip(prompts, params)]
    eng.run()
    for p, sp, h in zip(prompts, params, handles):
        assert h.finish_reason == "length" and len(h.tokens) == NEW
        assert all(0 <= t < 256 for t in h.tokens)
        if sp is None:
            assert h.tokens == _port_stream(tm, p, NEW)


def test_seeded_streams_repeat_run_to_run(pair):
    """A seeded request's stream depends on its seed and sample index
    only: it repeats in a fresh engine even when it lands in another
    lane next to other traffic."""
    _, _, tm = pair
    prompts = _prompts(3, seed=4)
    eng = _engine(tm)
    a = [eng.submit(p, max_new_tokens=NEW, params=SEEDED) for p in prompts]
    eng.run()
    eng2 = _engine(tm)
    filler = eng2.submit(_prompts(1, seed=5)[0], max_new_tokens=NEW)
    b = [eng2.submit(p, max_new_tokens=NEW, params=SEEDED)
         for p in reversed(prompts)][::-1]
    eng2.run()
    assert filler.finish_reason == "length"
    for x, y in zip(a, b):
        assert x.tokens == y.tokens
    # a different seed draws a different stream somewhere
    eng3 = _engine(tm)
    c = [eng3.submit(p, max_new_tokens=NEW,
                     params=SamplingParams(temperature=0.8, top_p=0.9, seed=8))
         for p in prompts]
    eng3.run()
    assert [h.tokens for h in c] != [h.tokens for h in a]


def _eos_for(stream):
    """An EOS id that the stream emits early: the first token, after the
    first, that does not occur earlier in it (a random-init model may
    repeat one token, so `stream[2]` need not be new). Falls back to the
    first token, which ends the request at its prefill."""
    for i in range(1, len(stream)):
        if stream[i] not in stream[:i]:
            return stream[i], i
    return stream[0], 0


def test_early_eos_frees_slot_for_queued_request(pair):
    _, _, tm = pair
    prompts = _prompts(4, seed=6, lo=6, hi=12)
    ref0 = _port_stream(tm, prompts[0], 16)
    eos, at = _eos_for(ref0)
    eng = _engine(tm, n_slots=2, decode_block=2)
    h0 = eng.submit(prompts[0], max_new_tokens=16, eos_id=eos)
    rest = [eng.submit(p, max_new_tokens=16) for p in prompts[1:]]
    eng.run()
    assert h0.finish_reason == "eos"
    assert h0.tokens == ref0[:at + 1]
    assert h0.tokens == _port_stream(tm, prompts[0], 16, eos_id=eos)
    for p, h in zip(prompts[1:], rest):
        assert h.finish_reason == "length"
        assert h.tokens == _port_stream(tm, p, 16)
    reused = [h for h in rest
              if h.slot == h0.slot and h.admit_time >= h0.finish_time]
    assert reused, "freed slot was never re-acquired"
    still_decoding = [h for h in rest
                      if h.admit_time < reused[0].admit_time
                      and h.finish_time > reused[0].admit_time]
    assert still_decoding, "pool had drained before the slot was reused"


def test_generate_pads_with_eos_after_it(pair):
    _, _, tm = pair
    p = _prompts(1, seed=6, lo=6, hi=12)[0]
    ref = _port_stream(tm, p, 16)
    eos, at = _eos_for(ref)
    out = generate(tm, torch.from_numpy(p)[None], max_new_tokens=16,
                   eos_id=eos, device="cpu")[0, len(p):].tolist()
    assert out[:at + 1] == ref[:at + 1]
    assert out[at:] == [eos] * (16 - at)


def test_cancel_waiting_and_active(pair):
    _, _, tm = pair
    eng = _engine(tm, n_slots=1)
    a, b = (eng.submit(p, max_new_tokens=NEW) for p in _prompts(2, seed=7))
    eng.cancel(b)
    assert b.done and b.finish_reason == "cancelled"
    eng.step()
    eng.cancel(a)
    eng.run()
    assert a.finish_reason == "cancelled" and len(a.tokens) < NEW
    assert eng.pool.n_free == 1
    assert eng.metrics.finish_reasons == {"cancelled": 2}


@pytest.mark.parametrize("prompt,kw,match", [
    ([], {}, "at least one token"),
    ([1.5, 2.0], {}, "integer"),
    ([[1, 2]], {}, "1-D"),
    ([1, 256], {}, r"\[0, 256\)"),
    ([1, 2], {"max_new_tokens": 0}, ">= 1"),
    ([1] * 60, {"max_new_tokens": 10}, "capacity"),
    ([1, 2], {"params": SamplingParams(temperature=1.0, top_k=100)},
     "sample_cap"),
])
def test_submit_validates_on_the_host(pair, prompt, kw, match):
    _, _, tm = pair
    eng = _engine(tm)
    with pytest.raises(ValueError, match=match):
        eng.submit(np.asarray(prompt), **kw)


@pytest.mark.parametrize("kw", [
    dict(temperature=-1.0), dict(top_p=0.0), dict(min_p=1.5),
    dict(top_k=-1), dict(seed=2**31), dict(max_tokens=0),
])
def test_sampling_params_validate(kw):
    with pytest.raises(ValueError):
        SamplingParams(**kw)


def test_full_queue_rejects():
    sched = FIFOScheduler(max_waiting=2)
    reqs = [Request(prompt=np.ones(3, np.int64), max_new_tokens=4, eos_id=None)
            for _ in range(3)]
    assert [sched.submit(r) for r in reqs] == [True, True, False]
    assert reqs[2].state == "rejected" and len(sched) == 2


def test_decode_priority_and_wait_budget():
    sched = FIFOScheduler(max_waiting=8, decode_priority=True,
                          max_prefills_per_step=1, max_wait_steps=2)
    for _ in range(4):
        sched.submit(Request(prompt=np.ones(3, np.int64), max_new_tokens=4,
                             eos_id=None))
    # slots decoding: one prefill per iteration
    assert len(sched.pick(n_free=3, n_active=1)) == 1
    # idle pool: fill every free slot
    assert len(sched.pick(n_free=2, n_active=0)) == 2
    # past its wait budget the head overrides decode priority
    sched.submit(Request(prompt=np.ones(3, np.int64), max_new_tokens=4,
                         eos_id=None))
    for _ in range(3):
        sched.tick()
    assert len(sched.pick(n_free=3, n_active=2)) == 2


def test_slot_pool_lanes_are_views_and_release_guards(pair):
    _, _, tm = pair
    pool = KVSlotPool(tm, n_slots=2, max_len=16)
    s = pool.acquire()
    lane = extract_lane(pool.caches, s)
    lane[0].k.fill_(3.0)
    assert (pool.caches[0].k[s] == 3.0).all()
    store_lane(pool.caches, lane, s)  # a view: nothing to copy
    other = [type(c)(k=c.k.clone() + 1, v=c.v.clone()) for c in lane]
    store_lane(pool.caches, other, s)
    assert (pool.caches[0].k[s] == 4.0).all()
    with pytest.raises(TypeError, match="dtype"):
        store_lane(pool.caches, [type(c)(k=c.k.double(), v=c.v) for c in lane], s)
    pool.release(s)
    with pytest.raises(ValueError, match="double release"):
        pool.release(s)
    assert pool.acquire() == s  # LIFO: the freshest slot first
