"""n-gram speculative serving on the port (`solvingpapers_tpu_torch/serve/
spec.py` and the engine's speculative blocks) against the JAX package.

The contract, as the reference's: speculation changes how many forwards
a stream takes, never its tokens or its distribution.

* `ngram_drafts` equals the JAX function (under `vmap`) exactly;
  `spec_verify`'s greedy rows equal JAX's argmaxes, commit counts and
  logprobs; the stochastic branch's committed token is distributed as
  the truncated distribution, as JAX's is (total variation under 0.05 at
  4000 draws, about 2.5 x the sampling noise); `SpecController` makes
  JAX's decisions on the same observations;
* greedy spec-on streams equal the JAX spec engine's and the port's
  spec-off streams for GPT, LLaMA-3 and DeepSeek-V3 (its latent lanes,
  and at a capacity where the chunk's per-row routing drops pairs), on
  the lane and the paged pool, through a paged preemption, with the
  prefix cache, and on the quantized pools against the quantized
  spec-off engine;
* a seeded stochastic stream is the same with speculation on or off,
  through a preemption and run to run (each committed index takes the
  plain sampler's draw); a grammar slot stays constrained; adversarial
  traffic drops to plain blocks; the scheduler's tick counts delivered
  tokens; a chunk at the lane's end and the paged write-back leave
  committed KV alone.

Models: the reference's `tests/test_spec.py` toy sizes (vocab 64), dense
attention, float32, their JAX weights carried across by `convert.py`;
the JAX spec engine of each family runs once (`_jax_streams`). The tests
that hold the port against itself serve `durability_models.port_model`
(gpt_tiny, the port's own initialisation: no JAX).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu.serve import ServeConfig as JServeConfig
from solvingpapers_tpu.serve import ServeEngine as JServeEngine
from solvingpapers_tpu.serve import kv_pool as jkv
from solvingpapers_tpu.serve import spec as jspec
from solvingpapers_tpu.serve.sampling import PackedSampling as JPacked
from solvingpapers_tpu_torch.convert import flax_to_torch
from solvingpapers_tpu_torch.infer.cache import KVCache, update_kv_cache
from solvingpapers_tpu_torch.serve import (
    FIFOScheduler,
    Request,
    SamplingParams,
    ServeConfig,
    ServeEngine,
    kv_pool,
)
from solvingpapers_tpu_torch.serve.sampling import (
    PackedSampling,
    _splitmix64,
    capped_support,
    draw_keys,
    noise_bits,
    request_seed,
)
from solvingpapers_tpu_torch.serve.spec import (
    SpecController,
    ngram_drafts,
    spec_verify,
)
from durability_models import port_model
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)

VOCAB = 64
NEW = 10
# spec_min_rate 0: after the cold-start probe every step speculates
# (untrained models reject most drafts, and the controller would hold
# otherwise); rounds 2 == the probe's, so probe and full blocks match
SPEC = dict(speculative="ngram", spec_k=4, spec_rounds=2, spec_min_rate=0.0)
BASE = dict(n_slots=2, max_len=48, decode_block=4, bucket=8)

_GPT = dict(vocab_size=VOCAB, block_size=64, dim=32, n_layers=2, n_heads=2,
            dropout=0.0, dtype="float32")
_LLAMA = dict(vocab_size=VOCAB, max_seq_len=64, dim=32, n_layers=2,
              n_heads=4, n_kv_heads=2, dropout=0.0, dtype="float32")
_DSV3 = dict(vocab_size=VOCAB, block_size=96, dim=32, n_layers=1, n_heads=2,
             latent_dim=8, rope_dim=8, pe_scale=0.02, n_experts=2,
             top_experts=2, dropout=0.0, attn_dropout=0.0, dtype="float32")


@functools.lru_cache(maxsize=None)
def _family(name):
    """(JAX model, its variables, extra variables, the port's model in
    eval mode) on one set of weights, built once a process."""
    if name == "gpt":
        from solvingpapers_tpu.models.gpt import GPT as J, GPTConfig as JC
        from solvingpapers_tpu_torch.models import GPT as T, GPTConfig as TC

        cfg = _GPT
    elif name == "llama3":
        from solvingpapers_tpu.models.llama3 import Llama as J
        from solvingpapers_tpu.models.llama3 import LlamaConfig as JC
        from solvingpapers_tpu_torch.models import Llama as T
        from solvingpapers_tpu_torch.models import LlamaConfig as TC

        cfg = _LLAMA
    else:
        from solvingpapers_tpu.models.deepseekv3 import DeepSeekV3 as J
        from solvingpapers_tpu.models.deepseekv3 import DeepSeekV3Config as JC
        from solvingpapers_tpu_torch.models import DeepSeekV3 as T
        from solvingpapers_tpu_torch.models import DeepSeekV3Config as TC

        # half capacity: the spec chunks' per-row routing drops (see `_spec`)
        cfg = dict(_DSV3, capacity_factor=0.5)
    jm = J(JC(**cfg))
    variables = jax.jit(jm.init)({"params": jax.random.key(3)},
                                 jnp.zeros((1, 8), jnp.int32))
    variables = jax.tree.map(np.asarray, variables)
    params = variables["params"]
    extra = ({"moe_state": variables["moe_state"]} if "moe_state" in variables
             else None)
    tm = T(TC(**cfg), device="cpu")
    tm.load_state_dict(flax_to_torch(params, extra))
    return jm, params, extra, tm.eval()


def _prompts(n, seed, lo=5, hi=16):
    """`n` random prompts, the first two of them periodic (their greedy
    continuations tend to repeat, so drafts get accepted)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i < 2:
            period = rng.integers(0, VOCAB, size=int(rng.integers(2, 4)))
            out.append(np.tile(period, 6)[:int(rng.integers(lo, hi))])
        else:
            out.append(rng.integers(0, VOCAB, size=int(rng.integers(lo, hi))))
    return [p.astype(np.int32) for p in out]


PROMPTS = _prompts(4, seed=4, hi=9)
_JAX = {}


def _spec(name):
    """The spec knobs of a family's engines: DeepSeek-V3 drafts 9 tokens,
    so each slot's 10-token chunk routes 10 pairs to each of its 2
    experts against a per-row capacity of 8 (half capacity, 8-aligned):
    pairs drop. A batch-wide dispatch of the 2 slots would meet 16."""
    return dict(SPEC, spec_k=9) if name == "deepseekv3" else SPEC


def _jax_streams(name):
    """The JAX spec engine's greedy streams of PROMPTS (lane pool)."""
    if name not in _JAX:
        jm, params, extra, _ = _family(name)
        eng = JServeEngine(jm, params, JServeConfig(**BASE, **_spec(name)),
                           extra_variables=extra)
        hs = [eng.submit(p, max_new_tokens=NEW) for p in PROMPTS]
        eng.run()
        assert eng.metrics.spec_steps > 0
        _JAX[name] = [list(h.tokens) for h in hs]
    return _JAX[name]


def _run(model, prompts=PROMPTS, new=NEW, params=None, **kw):
    """An engine of BASE updated by `kw`, every prompt submitted at once,
    run to the end: (engine, streams). `params(i)` gives request i's
    SamplingParams."""
    eng = ServeEngine(model, ServeConfig(**{**BASE, **kw}), device="cpu")
    hs = [eng.submit(p, max_new_tokens=new,
                     params=None if params is None else params(i))
          for i, p in enumerate(prompts)]
    eng.run()
    assert all(h.done for h in hs)
    return eng, [list(h.tokens) for h in hs]


# ------------------------------------------------------------- functions


@pytest.mark.parametrize("nmax", [1, 2, 3])
def test_ngram_drafts_equal_jax(nmax):
    """Batched drafts and draft counts equal the reference's per-slot
    function under `vmap`, on histories over a small vocab (many
    matches), every live length from 0 to the buffer's width."""
    rng = np.random.default_rng(nmax)
    hist = rng.integers(0, 5, size=(25, 24)).astype(np.int32)
    length = np.arange(25, dtype=np.int32)
    want_d, want_a = jax.jit(jax.vmap(
        lambda h, m: jspec.ngram_drafts(h, m, k=4, nmax=nmax)
    ))(jnp.asarray(hist), jnp.asarray(length))
    got_d, got_a = ngram_drafts(torch.from_numpy(hist), torch.from_numpy(length),
                                k=4, nmax=nmax)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert (got_a > 0).sum() > 5  # the lookup found continuations


def _jpacked(temperature, top_p=1.0, min_p=0.0, top_k=0, need_lp=0):
    n = len(temperature)
    return JPacked(temperature=jnp.asarray(temperature, jnp.float32),
                   top_p=jnp.full(n, top_p, jnp.float32),
                   min_p=jnp.full(n, min_p, jnp.float32),
                   top_k=jnp.full(n, top_k, jnp.int32),
                   need_lp=jnp.full(n, need_lp, jnp.int32))


def _packed(temperature, top_p=1.0, min_p=0.0, top_k=0):
    n = len(temperature)
    return PackedSampling(
        temperature=torch.tensor(temperature, dtype=torch.float32),
        top_p=torch.full((n,), top_p), min_p=torch.full((n,), min_p),
        top_k=torch.full((n,), top_k, dtype=torch.long))


def test_spec_verify_greedy_rows_equal_jax():
    """On shared logits the greedy branch commits JAX's argmax rows with
    JAX's commit counts (drafts built to accept 0 to k tokens), and the
    logprobs agree; without `need_lp` none are computed."""
    rng = np.random.default_rng(5)
    s_n, k = 6, 3
    logits = rng.standard_normal((s_n, k + 1, 32)).astype(np.float32)
    am = logits.argmax(-1)
    drafts = rng.integers(0, 32, size=(s_n, k))
    for s in range(s_n):  # slot s's first s % (k + 1) drafts are argmaxes
        drafts[s, :s % (k + 1)] = am[s, :s % (k + 1)]
    avail = np.asarray([3, 3, 3, 3, 1, 0])
    keys = jnp.stack([jax.random.split(jax.random.key(6), k + 1)] * s_n)
    out, commits, lps = jax.jit(functools.partial(jspec.spec_verify, cap=16))(
        jnp.asarray(logits), jnp.asarray(drafts, jnp.int32),
        jnp.asarray(avail, jnp.int32), _jpacked([0.0] * s_n, need_lp=1), keys)
    got, got_c, got_lp = spec_verify(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.from_numpy(avail), _packed([0.0] * s_n), None, cap=16,
        need_lp=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(out))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(commits))
    assert got_c.tolist() == [1, 2, 3, 4, 1, 1]
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(lps), atol=1e-5)
    assert spec_verify(torch.from_numpy(logits), torch.from_numpy(drafts),
                       torch.from_numpy(avail), _packed([0.0] * s_n),
                       cap=16)[2] is None


@functools.partial(jax.jit, static_argnames=("cap",))
def _jax_first_tokens(logits, drafts, packed, keysets, cap=16):
    """The reference's committed token at the first chunk position, one
    draw a key of `keysets` (every draft available), compiled once a
    process for the three draft kinds."""
    big_l = logits.shape[1]

    def one(kk):
        keys = jax.vmap(lambda i: jax.random.fold_in(kk, i))(
            jnp.arange(big_l))[None, :]
        o, _, _ = jspec.spec_verify(logits, drafts,
                                    jnp.asarray([big_l - 1]), packed, keys,
                                    cap=cap)
        return o[0, 0]

    return jax.vmap(one)(keysets)


@pytest.mark.parametrize("draft_kind", ["likely", "unlikely", "mixed"])
def test_spec_verify_stochastic_distribution_matches_jax(draft_kind):
    """The committed token at the first chunk position (verified or
    redrawn) is distributed as the truncated distribution whatever the
    draft, for the port and for JAX: each empirical histogram of 4000
    draws within total variation 0.05 of the exact distribution and of
    the other's (the sampling noise alone gives about 0.02)."""
    vocab, cap, n, big_l = 32, 16, 4000, 3
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal(vocab) * 2.0).astype(np.float32)
    knobs = dict(top_p=0.85, min_p=0.02, top_k=12)
    order = np.argsort(-logits)
    draft = {"likely": int(order[0]), "unlikely": int(order[-1]),
             "mixed": int(order[3])}[draft_kind]
    # the exact truncated distribution fused_sample draws from
    masked, top_idx = capped_support(torch.from_numpy(logits)[None],
                                     _packed([0.9], **knobs), cap=cap)
    exact = np.zeros(vocab)
    exact[top_idx[0].numpy()] = torch.softmax(masked[0], -1).numpy()

    lg = torch.from_numpy(np.broadcast_to(logits, (n, big_l, vocab)).copy())
    keys = torch.from_numpy(np.random.default_rng(2).integers(
        0, 2**63 - 1, size=(n, big_l), dtype=np.int64))
    out, commits, _ = spec_verify(lg, torch.full((n, 2), draft),
                                  torch.full((n,), 2),
                                  _packed([0.9] * n, **knobs), keys, cap=cap)
    port = np.bincount(out[:, 0].numpy(), minlength=vocab) / n

    jlg = jnp.broadcast_to(jnp.asarray(logits), (1, big_l, vocab))
    ref = np.bincount(np.asarray(_jax_first_tokens(
        jlg, jnp.asarray([[draft, draft]]), _jpacked([0.9], **knobs),
        jax.random.split(jax.random.key(3), n))), minlength=vocab) / n
    tv = lambda a, b: 0.5 * float(np.abs(a - b).sum())  # noqa: E731
    assert tv(port, exact) < 0.05, (draft_kind, tv(port, exact))
    assert tv(ref, exact) < 0.05, (draft_kind, tv(ref, exact))
    assert tv(port, ref) < 0.05, (draft_kind, tv(port, ref))
    # acceptance is the event "the row's draw is the draft"
    acc = (commits > 1).float().mean().item()
    assert abs(acc - exact[draft]) < 0.05


def test_draw_noise_is_a_hash_of_key_and_token_id():
    """The device-side noise bits equal the host's splitmix64 of ``key ^
    (id * 0xD1B54A32D192ED03)``, int64 products wrapping as on the host;
    a draw's keys are `request_seed`'s, zero for greedy slots."""
    rng = np.random.default_rng(9)
    keys = [request_seed(0, 3, s, 7 if s else -1, i) for s in range(2)
            for i in range(4)]
    ids = rng.integers(0, 50257, size=16)
    got = noise_bits(torch.tensor(keys)[:, None], torch.from_numpy(ids)[None])
    m64 = (1 << 64) - 1
    for r, key in enumerate(keys):
        for c, i in enumerate(ids):
            want = _splitmix64(key ^ ((int(i) * 0xD1B54A32D192ED03) & m64))
            assert int(got[r, c]) & m64 == want
    k = draw_keys(0, 3, [7, -1, 9], [5, 0, 2], [True, False, True], 4)
    assert k.shape == (4, 3) and not k[:, 1].any()
    assert k[1, 0] == request_seed(0, 3, 0, 7, 6)
    # a seeded key is independent of the engine call and the slot
    assert draw_keys(0, 8, [0, 7], [0, 5], [False, True], 2)[1, 1] == k[1, 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_spec_controller_decides_as_jax(seed):
    """Probes, holds with doubling backoff, external holds and recovery:
    the same sequence of decisions and stats as the reference's class on
    the same observations."""
    rng = np.random.default_rng(seed)
    a = SpecController(min_rate=1.0, probe_every=3, decay=0.5)
    b = jspec.SpecController(min_rate=1.0, probe_every=3, decay=0.5)
    for step in range(200):
        da, db = a.decide(), b.decide()
        assert da == db, step
        if step % 37 == 5:
            a.hold(4)
            b.hold(4)
        if da != "off":
            rounds = 2 if da == "probe" else 6
            acc = int(rng.integers(0, 3 * rounds)) if rng.random() < 0.5 else 0
            a.observe(acc, rounds)
            b.observe(acc, rounds)
        assert a.stats() == b.stats()
    assert a.probes > 3 and a.fallback_steps > 10


# ---------------------------------------------------- greedy exactness


@pytest.mark.parametrize("family", ["gpt", "llama3", "deepseekv3"])
def test_greedy_streams_equal_jax_spec_engine_and_spec_off(family):
    """Greedy spec-on streams, on the lane and the paged pool, equal the
    JAX spec engine's and the port's spec-off engine's, with drafts
    accepted and rejected. DeepSeek-V3 serves its latent lanes at half
    capacity: each chunk row drops (token, expert) pairs, and per-row
    routing keeps the reference's batch-1 capacity of one slot's chunk.
    Both pools run in one case, so the JAX engine runs once a family."""
    tm = _family(family)[3]
    want = _jax_streams(family)
    for kw in ({}, dict(paged=True, page_size=8)):
        eng, on = _run(tm, **_spec(family), **kw)
        _, off = _run(tm, **kw)
        assert on == want, kw
        assert on == off, kw
        assert eng.metrics.spec_steps > 0 and eng.metrics.spec_accepted > 0
        assert eng.metrics.snapshot()["serve/spec_tokens_per_step"] > 0
    if family == "deepseekv3":
        from solvingpapers_tpu_torch import ops

        # the chunk's per-row capacity binds: 8 slots an expert for the
        # 10 pairs of one row, where the pool's 2 rows would meet 16
        assert ops.moe.expert_capacity(10, 2, 2, 0.5) == 8
        assert ops.moe.expert_capacity(20, 2, 2, 0.5) == 16


def test_preemption_keeps_greedy_and_seeded_streams():
    """A page budget too small for the load preempts mid-stream: greedy
    spec-on streams equal spec-off, and a seeded stochastic stream equals
    the same stream served without preemption, spec on or off (each
    committed index takes the plain sampler's draw of its seed)."""
    tm = port_model()
    prompts = _prompts(4, seed=9, lo=8, hi=12)

    def params(i):
        return (None if i % 2 else
                SamplingParams(temperature=0.9, top_p=0.95, seed=40 + i))

    kw = dict(n_slots=4, paged=True, page_size=8)
    eng, tight = _run(tm, prompts, 16, params, page_budget=9, **kw, **SPEC)
    assert eng.metrics.preemptions > 0
    _, roomy = _run(tm, prompts, 16, params, **kw, **SPEC)
    _, off = _run(tm, prompts, 16, params, **kw)
    assert tight == roomy == off


@pytest.mark.parametrize("paged", [False, True], ids=["lane", "paged"])
def test_prefix_cache_with_speculation(paged):
    """Shared-stem streams with the prefix cache (splice on the lane pool,
    page sharing on the paged pool) and speculation equal a cache-off
    spec-off engine's, and the cache hits."""
    tm = port_model()
    rng = np.random.default_rng(17)
    stem = rng.integers(0, VOCAB, size=16)
    prompts = [np.concatenate([stem, rng.integers(0, VOCAB, size=6)])
               for _ in range(4)]
    kw = dict(paged=True, page_size=8) if paged else {}
    eng, on = _run(tm, prompts, prefix_cache=True, prefix_page=8, **kw, **SPEC)
    _, off = _run(tm, prompts)
    assert on == off
    assert eng.metrics.prefix_hits > 0


@pytest.mark.parametrize("paged", [False, True], ids=["lane", "paged"])
def test_quant_speculative_ngram_matches_plain_quant(paged):
    """Speculation is lossless relative to its engine's storage: int8
    spec-on greedy streams equal int8 spec-off ones (the window's
    requantization keeps the rejected tail out of every scale), and a
    kv_exact stream equals the unquantized spec-off engine's."""
    tm = port_model()
    prompts = _prompts(4, seed=6, lo=8, hi=20)
    kw = (dict(paged=True, page_size=16) if paged else {}) | dict(
        kv_quant="int8", max_len=64, kv_exact_lanes=1)
    exact = [SamplingParams(kv_exact=i == 1) for i in range(4)]
    _, plain = _run(tm, prompts, 24, exact.__getitem__, **kw)
    eng, spec = _run(tm, prompts, 24, exact.__getitem__, **kw,
                     **{**SPEC, "spec_k": 3})
    _, unquant = _run(tm, prompts, 24, max_len=64)
    assert spec == plain
    assert spec[1] == unquant[1]
    assert eng.metrics.spec_accepted > 0


# ----------------------------------------------------- host-side contracts


def test_eos_mid_chunk_truncates_exactly():
    """An EOS committed inside a chunk ends the stream at the EOS (kept)
    and drops the chunk's overshoot. The EOS id is one that first occurs
    mid-stream of the spec-off greedy stream, so the stream must stop
    there (the reference's test picks an id that may occur earlier)."""
    tm = port_model()
    prompt = PROMPTS[0]
    _, (ref,) = _run(tm, [prompt], 16)
    i = next(i for i in range(2, len(ref)) if ref[i] not in ref[:i])
    eng, (got,) = _run(tm, [prompt], 16, eos_id=ref[i], **SPEC)
    assert got == ref[:i + 1]
    assert eng.metrics.spec_steps > 0


def test_seeded_streams_repeat_and_greedy_stays_exact_in_a_mix():
    """A seeded stochastic request repeats across two spec-on engines and
    equals its spec-off stream; a greedy request sharing those blocks
    equals spec-off; logprobs come back finite, one a token."""
    tm = port_model()
    mix = (None, SamplingParams(temperature=1.2, top_p=0.9, seed=7),
           SamplingParams(temperature=0.8, top_k=8, seed=11, logprobs=True))
    prompts = PROMPTS[:3]
    eng_a, a = _run(tm, prompts, params=mix.__getitem__, **SPEC)
    _, b = _run(tm, prompts, params=mix.__getitem__, **SPEC)
    _, off = _run(tm, prompts, params=mix.__getitem__)
    assert a == b == off
    assert eng_a.metrics.spec_steps > 0
    eng = ServeEngine(tm, ServeConfig(**BASE, **SPEC), device="cpu")
    h = eng.submit(prompts[2], max_new_tokens=NEW, params=mix[2])
    eng.run()
    assert len(h.logprobs) == len(h.tokens)
    assert all(np.isfinite(lp) and lp <= 0 for lp in h.logprobs)


def test_grammar_slot_stays_constrained():
    """A grammar-constrained request in a speculative engine drafts
    nothing, keeps one token a step and completes a parseable JSON
    document; a greedy neighbour stays exact."""
    from solvingpapers_tpu_torch.serve import JsonStepper

    tm = port_model()
    table = list('{}[]":,-.0123456789 \nabcdefghijklmnopqrstuvwxyz'
                 "ABCDEFGHIJKLMNOP\\")[:VOCAB]
    eng = ServeEngine(tm, ServeConfig(**{**BASE, "max_len": 64}, **SPEC),
                      device="cpu",
                      detokenize=lambda ids: "".join(table[i] for i in ids))
    g = eng.submit(PROMPTS[2], max_new_tokens=40, grammar=JsonStepper(table))
    plain = eng.submit(PROMPTS[0], max_new_tokens=NEW)
    eng.run()
    assert g.finish_reason == "stop"
    json.loads("".join(table[t] for t in g.tokens))
    assert g.spec_proposed == 0
    assert plain.tokens == _run(tm, [PROMPTS[0]])[1][0]


def test_adversarial_traffic_falls_back_and_reports():
    """High-temperature random streams defeat the drafter: the controller
    holds (plain blocks), every stream finishes, and the status section,
    the gauges and the request facts say so."""
    tm = port_model()
    prompts = _prompts(6, seed=13)[2:]
    eng, _ = _run(tm, prompts, 24,
                  lambda i: SamplingParams(temperature=2.0, seed=100 + i),
                  speculative="ngram", spec_k=4, spec_rounds=4,
                  spec_min_rate=0.5, spec_probe_every=4)
    st = eng.statusz()["spec"]
    assert st["fallback_steps"] > 0 and st["probes"] >= 1
    assert st["drafter"] == "ngram" and st["k"] == 4 and st["rounds"] == 4
    snap = eng.metrics.snapshot()
    assert {"serve/spec_acceptance_rate", "serve/spec_tokens_per_step",
            "serve/spec_drafts_rejected"} <= set(snap)
    off = ServeEngine(tm, ServeConfig(**BASE), device="cpu")
    assert "spec" not in off.statusz()
    assert "serve/spec_acceptance_rate" not in off.metrics.snapshot()


def test_config_validation_and_mtp_refusal():
    tm = port_model()
    cases = [(dict(spec_rounds=4), "spec_rounds"),
             (dict(speculative="oracle"), "speculative must be one of"),
             (dict(speculative="mtp"), "mtp_heads == 0"),
             (dict(speculative="ngram", spec_k=0), "spec_k"),
             (dict(speculative="ngram", spec_ngram=0), "spec_ngram")]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            ServeEngine(tm, ServeConfig(**BASE, **kw), device="cpu")
    eng = ServeEngine(tm, ServeConfig(**BASE, speculative="ngram", spec_k=8),
                      device="cpu")
    # the reference's default rate: max(1, k / 4) accepted drafts a round
    assert eng._spec_ctl.min_rate == 2.0 and eng._spec_rounds == 4


def test_ladder_rung_two_holds_speculation():
    tm = port_model()
    eng = ServeEngine(tm, ServeConfig(**BASE, **SPEC, degrade=True),
                      device="cpu")
    eng._ladder.rung = 2
    eng._ladder_step()
    assert eng._spec_ctl.decide() == "off"


# ------------------------------------------------------ scheduler fairness


def _req():
    return Request(prompt=np.arange(4), max_new_tokens=4, eos_id=None)


def test_scheduler_tick_weight_counts_delivered_blocks():
    """The anti-starvation budget is a delivered-token quantum: weight 3
    trips the override after 2 steps where weight 1 needs 5; sub-1
    weights clamp to 1."""
    plain = FIFOScheduler(decode_priority=True, max_prefills_per_step=1,
                          max_wait_steps=4)
    plain.submit(_req())
    for _ in range(5):
        plain.tick()
    assert len(plain.pick(n_free=2, n_active=4)) == 1
    spec = FIFOScheduler(decode_priority=True, max_prefills_per_step=1,
                         max_wait_steps=4)
    spec.submit(_req())
    for _ in range(2):
        spec.tick(weight=3.0)
    assert spec.queue[0].waited_steps == pytest.approx(6.0)
    assert len(spec.pick(n_free=2, n_active=4)) == 1
    clamp = FIFOScheduler(max_wait_steps=4)
    clamp.submit(_req())
    clamp.tick(weight=0.25)
    assert clamp.queue[0].waited_steps == pytest.approx(1.0)


def test_engine_passes_the_delivered_weight():
    """With drafts accepting, one step delivers more than a block, and a
    waiting request ages by more than one unit a step."""
    tm = port_model()
    prompt = np.tile(np.asarray([3, 9]), 8)
    eng = ServeEngine(tm, ServeConfig(n_slots=1, max_len=64, decode_block=2,
                                      bucket=8, **SPEC), device="cpu")
    h1 = eng.submit(prompt, max_new_tokens=24)
    waiter = eng.submit(PROMPTS[2], max_new_tokens=4)
    eng.step()  # admit h1
    eng.step()  # the first spec block
    assert eng.metrics.spec_accepted > 0
    assert waiter.waited_steps > 2.0
    eng.run()
    assert h1.done and waiter.done
    assert h1.tokens == _run(tm, [prompt], 24)[1][0]


# ------------------------------------------------------ the pools' KV


def test_a_chunk_at_the_lane_end_leaves_committed_kv_alone():
    """A (1 + k)-wide write starting two slots before the lane's end keeps
    every position before its start: the columns past the end collapse
    onto the last slot instead of the start clamping left. A one-token
    write clamps its start as `dynamic_update_slice` does."""
    k0 = torch.randn(2, 12, 2, 4)
    new = torch.randn(2, 5, 2, 4)
    c = update_kv_cache(KVCache(k=k0.clone(), v=k0.clone()), new, new,
                        torch.tensor([10, 3]))
    assert torch.equal(c.k[0, :10], k0[0, :10])
    assert torch.equal(c.k[0, 10], new[0, 0])
    assert torch.equal(c.k[1, 3:8], new[1])
    assert torch.equal(c.k[1, :3], k0[1, :3]) and torch.equal(c.k[1, 8:], k0[1, 8:])
    one = update_kv_cache(KVCache(k=k0.clone(), v=k0.clone()), new[:, :1],
                          new[:, :1], torch.tensor([14, 2]))
    assert torch.equal(one.k[0, 11], new[0, 0])


def test_engine_chunk_at_the_lane_end_keeps_streams_exact():
    """Streams that run to the lane's last position with drafts in flight
    (prompt + budget = max_len) equal spec-off streams."""
    tm = port_model()
    prompts = [np.tile(np.asarray([5, 6, 7]), 4)[:10], PROMPTS[2][:10]]
    _, on = _run(tm, prompts, 38, **SPEC)
    _, off = _run(tm, prompts, 38)
    assert on == off


def test_scatter_window_pages_equals_jax_and_spares_other_pages():
    """Only each slot's committed window [start, last] reaches the
    physical pool (the reference's function on the same inputs), and
    pages outside it keep their content."""
    rng = np.random.default_rng(3)
    page, ppl, n_pages = 4, 4, 12
    phys = rng.standard_normal((n_pages, page, 2, 3)).astype(np.float32)
    lanes = rng.standard_normal((3, ppl * page, 2, 3)).astype(np.float32)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 0], [8, 9, 10, 11]])
    start, last = np.asarray([2, 5, 9]), np.asarray([9, 4, 15])
    from solvingpapers_tpu.infer.cache import KVCache as JC

    want = jkv.scatter_window_pages(
        [JC(k=jnp.asarray(phys), v=jnp.asarray(phys))],
        [JC(k=jnp.asarray(lanes), v=jnp.asarray(lanes))], jnp.asarray(table),
        jnp.asarray(start), jnp.asarray(last), 12)
    got = kv_pool.scatter_window_pages(
        [KVCache(k=torch.from_numpy(phys.copy()), v=torch.from_numpy(phys.copy()))],
        [KVCache(k=torch.from_numpy(lanes), v=torch.from_numpy(lanes))],
        torch.from_numpy(table), torch.from_numpy(start), torch.from_numpy(last),
        12)
    np.testing.assert_array_equal(got[0].k.numpy(), np.asarray(want[0].k))
    # slot 0's window [2, 9] is pages 0-2 (ids 1-3); id 4 stays
    assert np.array_equal(got[0].k[4].numpy(), phys[4])
    assert np.array_equal(got[0].k[3].numpy(), lanes[0, 8:12])


# ------------------------------------------------------------ replay


def test_replay_of_a_speculative_candidate_is_byte_exact(tmp_path):
    """A journal recorded without speculation replays byte-exact through
    an n-gram speculative candidate (greedy and seeded streams)."""
    from solvingpapers_tpu_torch.serve.replay import ReplayHarness, apply_overrides

    tm = port_model()
    path = str(tmp_path / "j.jsonl")
    cfg = ServeConfig(**BASE, journal_path=path)
    eng = ServeEngine(tm, cfg, device="cpu")
    for i, p in enumerate(PROMPTS):
        eng.submit(p, max_new_tokens=NEW, params=None if i % 2 else
                   SamplingParams(temperature=0.9, seed=i))
    eng.run()
    eng.close()
    cand = apply_overrides(dataclasses.replace(cfg, journal_path=None),
                           {"speculative": "ngram", "spec_k": "3",
                            "spec_rounds": "2", "spec_min_rate": "0"})
    h = ReplayHarness(tm)
    report = h.run(h.load(path), cand, cut_stride=4)
    assert report["candidate"]["speculative"] == "ngram"
    assert report["streams_compared"] == len(PROMPTS)
    assert report["byte_exact_rate"] == 1.0


def test_request_facts_carry_the_spec_acceptance():
    """`GET /v1/requests/<id>` of a speculative engine's request carries
    its `spec` facts (drafter, drafts proposed and accepted, rate), as
    the reference's debug timeline does; a spec-off engine's has none."""
    import urllib.request

    from solvingpapers_tpu_torch.serve import ApiServer

    prompt = np.tile([3, 9, 17], 5).tolist()
    for spec in (True, False):
        eng = ServeEngine(port_model(), ServeConfig(
            **BASE, api_port=0, **(SPEC if spec else {})), device="cpu")
        srv = ApiServer(eng, decode=lambda ids: "".join(chr(65 + i % 26)
                                                        for i in ids))
        try:
            req = urllib.request.Request(
                srv.url("/v1/completions"), method="POST",
                data=json.dumps({"prompt": prompt, "max_tokens": 12,
                                 "temperature": 0}).encode(),
                headers={"Content-Type": "application/json",
                         "X-Request-Id": "spec-1"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200
            with urllib.request.urlopen(srv.url("/v1/requests/spec-1"),
                                        timeout=60) as r:
                facts = json.loads(r.read())["facts"]
        finally:
            srv.close()
        if not spec:
            assert "spec" not in facts
            continue
        got = facts["spec"]
        assert got["drafter"] == "ngram" and got["proposed"] > 0
        assert 0 <= got["accepted"] <= got["proposed"]
        assert got["rate"] == round(got["accepted"] / got["proposed"], 4)
