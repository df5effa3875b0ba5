"""Grammar-constrained JSON decoding in the port (`serve/grammar.py`, the
sampler's allow-list, the engine's constrained slots).

Against the JAX package: `JsonStepper.allowed` equals the reference's
along seeded random walks, over a single-character table and over a
multi-character one, under random budgets; `encode_allow` packs the same
rows; `fused_sample` with an allow-list and logprobs gives the
reference's tokens and logprobs on the same logits.

On the port: through the engine, on the lane and the paged pool, a
constrained greedy stream parses, finishes "stop" inside its budget,
advances one token a decode block, and repeats run to run, while an
unconstrained request in the same batch stays token-exact with
`generate`; submit refuses a grammar with an explicit EOS and a budget
below the grammar's shortest document.
"""

import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu.serve import sampling as jsampling
from solvingpapers_tpu.serve.grammar import JsonStepper as JJsonStepper
from solvingpapers_tpu.serve.grammar import encode_allow as jencode_allow
from solvingpapers_tpu_torch.infer import generate
from solvingpapers_tpu_torch.models import GPT, GPTConfig, init_params_for
from solvingpapers_tpu_torch.serve import JsonStepper, ServeConfig, ServeEngine
from solvingpapers_tpu_torch.serve.grammar import encode_allow
from solvingpapers_tpu_torch.serve.sampling import PackedSampling, fused_sample
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)

ALPHABET = '{}[]":,-.0123456789 \nabcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOP\\'
TABLE = list(ALPHABET[:64])
# merge-y tokens: whole keys, closers glued to separators, a token that
# would complete the document and keep writing, an empty entry
MULTI = TABLE[:40] + ['"ab"', '":', '},', '"}', "}{", "true", "nul", "12.",
                      ' "', "", '\\u00', "e-", "]}"]
CFG = GPTConfig(vocab_size=64, block_size=64, dim=32, n_layers=2, n_heads=2,
                dropout=0.0)


@pytest.fixture(scope="module")
def model():
    m = GPT(CFG, device="cpu")
    m.load_state_dict(init_params_for(CFG)(CFG, torch.Generator().manual_seed(0)))
    return m.eval()


@pytest.mark.parametrize("table", [TABLE, MULTI], ids=["chars", "multichar"])
@pytest.mark.parametrize("seed", range(3))
def test_allowed_equals_the_reference_along_random_walks(table, seed):
    rng = random.Random(seed)
    ours, theirs = JsonStepper(table), JJsonStepper(table)
    assert ours.min_close == theirs.min_close
    budget = rng.randint(2, 60)
    out = []
    while not ours.done:
        b = budget - len(out)
        a = ours.allowed(b)
        assert a == theirs.allowed(b) and a, (seed, "".join(out))
        assert ours.allowed(None) == theirs.allowed(None)
        tid = rng.choice(a)
        ours.advance(tid)
        theirs.advance(tid)
        out.append(table[tid])
        assert (ours.mode, ours.min_close, ours.done) == (
            theirs.mode, theirs.min_close, theirs.done)
    assert theirs.done and ours.allowed(5) == [] == theirs.allowed(5)
    json.loads("".join(out))


def test_encode_allow_and_vocab_check_match_the_reference():
    for ids, cap in (([5, 9, 2], 2), ([5], 4), ([], 3)):
        assert encode_allow(ids, cap).tolist() == jencode_allow(ids, cap).tolist()
    for grammar in (JsonStepper, JJsonStepper):
        with pytest.raises(ValueError, match="cannot express"):
            grammar(list("abc"))


def test_fused_sample_allow_and_logprobs_match_the_reference():
    """Greedy rows, constrained and not, with logprobs: the same tokens
    and logprobs as the reference's sampler on the same logits."""
    rng = np.random.default_rng(0)
    s, v, cap = 4, 64, 8
    logits = rng.standard_normal((s, v)).astype(np.float32) * 3
    allow = np.full((s, cap), -1, np.int64)
    allow[1, :3] = [7, 40, 2]
    allow[3, :5] = [63, 0, 11, 12, 13]
    packed = PackedSampling(temperature=torch.zeros(s), top_p=torch.ones(s),
                            min_p=torch.zeros(s),
                            top_k=torch.zeros(s, dtype=torch.int64))
    toks, lps = fused_sample(torch.from_numpy(logits), packed, None,
                             cap=cap, allow=torch.from_numpy(allow),
                             need_lp=True)
    jpacked = jsampling.PackedSampling(
        temperature=jnp.zeros(s), top_p=jnp.ones(s), min_p=jnp.zeros(s),
        top_k=jnp.zeros(s, jnp.int32), need_lp=jnp.ones(s, jnp.int32))
    keys = jax.random.split(jax.random.key(0), s)
    jtoks, jlps = jsampling.fused_sample(jnp.asarray(logits), jpacked, keys,
                                         cap=cap, allow=jnp.asarray(allow, jnp.int32))
    assert toks.tolist() == np.asarray(jtoks).tolist()
    np.testing.assert_allclose(lps.numpy(), np.asarray(jlps), atol=1e-5)
    assert toks[1] in (7, 40, 2) and toks[3] in (63, 0, 11, 12, 13)
    # without a constraint or logprobs: argmax only, no logprob
    toks, lps = fused_sample(torch.from_numpy(logits), packed, None)
    assert toks.tolist() == logits.argmax(-1).tolist() and lps is None


@pytest.mark.parametrize("paged", [False, True], ids=["lane", "paged"])
def test_engine_json_mode_one_token_a_block(model, paged):
    streams = []
    for _ in range(2):
        eng = ServeEngine(model, ServeConfig(
            n_slots=4, max_len=64, decode_block=4, bucket=8, paged=paged,
            page_size=8 if paged else None), device="cpu")
        h = eng.submit(np.arange(5), max_new_tokens=24,
                       grammar=JsonStepper(TABLE))
        plain = eng.submit(np.arange(3), max_new_tokens=12)
        seen = []
        while eng.has_work():
            eng.step()
            seen.append(len(h.tokens))
        json.loads("".join(TABLE[t] for t in h.tokens))
        assert h.finish_reason == "stop" and len(h.tokens) <= 24
        # one token at admission, then one a block
        assert all(b - a <= 1 for a, b in zip(seen, seen[1:])), seen
        assert plain.finish_reason == "length"
        ref = generate(model, torch.arange(3)[None], max_new_tokens=12,
                       device="cpu")
        assert plain.tokens == ref[0, 3:].tolist()
        streams.append(h.tokens)
    assert streams[0] == streams[1], "constrained greedy stream not pinned"


def test_submit_refuses_grammar_with_eos_or_short_budget(model):
    eng = ServeEngine(model, ServeConfig(n_slots=2, max_len=64, decode_block=4,
                                         bucket=8, eos_id=0), device="cpu")
    with pytest.raises(ValueError, match="complete document"):
        eng.submit(np.arange(4), max_new_tokens=16, eos_id=3,
                   grammar=JsonStepper(TABLE))
    with pytest.raises(ValueError, match="shortest document"):
        eng.submit(np.arange(4), max_new_tokens=1, grammar=JsonStepper(TABLE))
    h = eng.submit(np.arange(5), max_new_tokens=24, grammar=JsonStepper(TABLE))
    assert h.eos_id is None  # the engine default does not leak in
