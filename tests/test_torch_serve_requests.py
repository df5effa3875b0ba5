"""The port's engine request contracts (`serve/engine.py`), on the lane
and the paged pool: stop token ids and stop strings (matched on the
host, across decode-block boundaries, the matching token kept, finish
reason "stop"), logprobs (the chosen token's log-softmax under the raw
logits, one per token), deadlines (in the queue and at a block
boundary, "timeout"), the streaming hook, cancellation, the bounded
close, and submit's host-side refusals. Greedy streams stay token-exact
with `generate` beside all of them. The logprobs of the same weights
under the JAX package's engine agree within 1e-4.

Model: GPT, vocab 64, dim 32, 2 layers, float32, on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu.models.gpt import GPT as JGPT
from solvingpapers_tpu.models.gpt import GPTConfig as JGPTConfig
from solvingpapers_tpu.serve import SamplingParams as JSamplingParams
from solvingpapers_tpu.serve import ServeConfig as JServeConfig
from solvingpapers_tpu.serve import ServeEngine as JServeEngine
from solvingpapers_tpu_torch.convert import flax_to_torch
from solvingpapers_tpu_torch.infer import generate
from solvingpapers_tpu_torch.models import GPT, GPTConfig
from solvingpapers_tpu_torch.serve import SamplingParams, ServeConfig, ServeEngine
from solvingpapers_tpu_torch.serve import metrics as smetrics
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)

TINY = dict(vocab_size=64, block_size=64, dim=32, n_layers=2, n_heads=2,
            dropout=0.0, dtype="float32")
CHARS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,;:"


def detok(ids):
    return "".join(CHARS[int(i)] for i in ids)


@pytest.fixture(scope="module")
def pair():
    jm = JGPT(JGPTConfig(**TINY))
    params = jm.init({"params": jax.random.key(3)},
                     jnp.zeros((1, 8), jnp.int32))["params"]
    tm = GPT(GPTConfig(**TINY), device="cpu")
    tm.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    return jm, params, tm.eval()


def _engine(model, paged, **kw):
    cfg = dict(n_slots=3, max_len=64, decode_block=4, bucket=8, paged=paged,
               page_size=8 if paged else None)
    cfg.update(kw)
    return ServeEngine(model, ServeConfig(**cfg), device="cpu", detokenize=detok)


def _greedy(model, prompt, n):
    out = generate(model, torch.as_tensor(prompt)[None], max_new_tokens=n,
                   device="cpu")
    return out[0, len(prompt):].tolist()


PROMPTS = [np.array([3, 14, 15, 9, 26]), np.array([5, 35, 8, 9, 7, 9, 3, 2]),
           np.array([38, 46, 26])]
pools = pytest.mark.parametrize("paged", [False, True], ids=["lane", "paged"])


@pools
def test_stop_ids_stop_strings_and_logprobs(pair, paged):
    _, _, model = pair
    full = [_greedy(model, p, 16) for p in PROMPTS]
    eng = _engine(model, paged)
    calls = []
    # request 0 stops on the id at stream index 5 (or at its first
    # appearance, where that comes earlier); request 1 on a string that
    # spans the first block boundary (tokens 3 and 4); request 2 runs to
    # its budget with logprobs
    sid = full[0][5]
    stop = detok(full[1][3:5])
    reqs = [
        eng.submit(PROMPTS[0], 16, params=SamplingParams(stop_token_ids=sid)),
        eng.submit(PROMPTS[1], 16, params=SamplingParams(stop=stop),
                   stream_cb=lambda r, n, f: calls.append((n, f))),
        eng.submit(PROMPTS[2], 16, params=SamplingParams(logprobs=True)),
    ]
    eng.run()
    k = full[0].index(sid)
    assert reqs[0].tokens == full[0][:k + 1] and reqs[0].finish_reason == "stop"
    text = detok(full[1])
    end = text.index(stop) + len(stop)
    assert reqs[1].tokens == full[1][:end] and reqs[1].finish_reason == "stop"
    assert sum(n for n, _ in calls) == len(reqs[1].tokens)
    assert calls[-1][1] and not any(f for _, f in calls[:-1])
    assert reqs[2].tokens == full[2] and reqs[2].finish_reason == "length"
    # logprobs: the log-softmax of the raw logits at each chosen token
    seq = torch.as_tensor(np.concatenate([PROMPTS[2], full[2]]))[None]
    logits, _ = model(seq)
    lp = torch.log_softmax(logits[0, len(PROMPTS[2]) - 1:-1].float(), -1)
    want = lp.gather(-1, torch.as_tensor(full[2])[:, None])[:, 0]
    np.testing.assert_allclose(reqs[2].logprobs, want.detach().numpy(), atol=1e-4)
    assert reqs[0].logprobs == [] and reqs[1].logprobs == []


class _GrowOnly(list):
    """A token list that refuses to lose an entry: a streaming handler
    reads `req.tokens` on another thread, so a token once appended must
    stay."""

    def __delitem__(self, i):
        raise AssertionError(f"tokens {i} left the stream")

    def pop(self, *a):
        raise AssertionError("a token left the stream")


@pools
def test_stop_string_cut_mid_block_never_reaches_the_stream(pair, paged):
    """A stop string that completes inside a decode block cuts the
    block's tail before any of it is appended: the request's token list
    only grows, and ends at the match."""
    _, _, model = pair
    full = _greedy(model, PROMPTS[1], 12)
    text = detok(full)
    # the first two-token string whose first match ends mid-block (the
    # prefill gives token 0; decode blocks of 4 give tokens 1-4, 5-8)
    stop, end = next((s, text.index(s) + 2) for s in
                     (text[j:j + 2] for j in range(1, 10))
                     if (text.index(s) + 1) % 4 != 0)
    eng = _engine(model, paged)
    req = eng.submit(PROMPTS[1], 12, params=SamplingParams(stop=stop,
                                                           logprobs=True))
    req.tokens = _GrowOnly(req.tokens)
    eng.run()
    assert req.finish_reason == "stop" and req.tokens == full[:end]
    assert len(req.logprobs) == end


def test_logprobs_match_the_jax_engine(pair):
    jm, params, model = pair
    jeng = JServeEngine(jm, params, JServeConfig(n_slots=2, max_len=64,
                                                 decode_block=4, bucket=8))
    eng = _engine(model, False, n_slots=2)
    got = []
    for e, sp in ((jeng, JSamplingParams(logprobs=True)),
                  (eng, SamplingParams(logprobs=True))):
        hs = [e.submit(p, 10, params=sp) for p in PROMPTS[:2]]
        e.run()
        got.append([(h.tokens, h.logprobs) for h in hs])
    for (jt, jl), (t, lp) in zip(*got):
        assert t == jt
        np.testing.assert_allclose(lp, jl, atol=1e-4)


@pools
def test_deadlines_expire_in_the_queue_and_at_a_block_boundary(pair, paged,
                                                              monkeypatch):
    """On the engine's clock (a fake one here): a queued request past its
    deadline leaves the queue, an active one finishes at the next block
    boundary with its tokens so far."""
    _, _, model = pair
    clock = [1000.0]
    monkeypatch.setattr(smetrics, "now", lambda: clock[0])
    eng = _engine(model, paged, n_slots=1)
    first = eng.submit(PROMPTS[0], 40, deadline_s=10)
    waiting = eng.submit(PROMPTS[1], 8, deadline_s=5)
    eng.step()
    assert first.state == "active" and waiting.state == "waiting"
    clock[0] += 6  # past the waiting request's deadline only
    eng.step()
    assert waiting.finish_reason == "timeout" and waiting.tokens == []
    assert first.state == "active" and len(first.tokens) == 9
    clock[0] += 5  # past the active request's deadline
    eng.step()
    assert first.finish_reason == "timeout" and len(first.tokens) == 9
    assert eng._waiting_deadlines == 0 and eng.pool.n_active == 0
    if paged:
        assert eng.pool.pages_free == eng.pool.page_budget
    with pytest.raises(ValueError, match="deadline_s"):
        eng.submit(PROMPTS[0], 4, deadline_s=0)


@pools
def test_cancel_close_and_submit_refusals(pair, paged):
    _, _, model = pair
    eng = _engine(model, paged, n_slots=1)
    done = []
    active = eng.submit(PROMPTS[0], 40, stream_cb=lambda r, n, f: done.append(f))
    queued = eng.submit(PROMPTS[1], 8, stream_cb=lambda r, n, f: done.append(f))
    eng.step()
    eng.cancel(queued)
    assert queued.finish_reason == "cancelled" and done[-1]
    eng.close()  # no drain time: the active stream is finished host-side
    assert active.finish_reason == "cancelled" and not eng.has_work()
    assert eng.pool.n_active == 0
    st = eng.statusz()
    assert st["engine"]["queue_depth"] == 0 and len(st["slots"]) == 1
    assert ("kv_pages" in st) == paged
    no_detok = ServeEngine(model, ServeConfig(n_slots=1, max_len=64, bucket=8),
                           device="cpu")
    with pytest.raises(ValueError, match="detokenize"):
        no_detok.submit(PROMPTS[0], 4, params=SamplingParams(stop="ab"))
    with pytest.raises(ValueError, match="stop_token_ids"):
        SamplingParams(stop_token_ids=(1.5,))
    with pytest.raises(ValueError, match="non-empty"):
        SamplingParams(stop=("",))
    assert SamplingParams(stop="ab").stop == ("ab",)
