"""DeepSeek-V3's multi-token prediction on the port: the MTP heads,
`mtp_loss`, the objective's MTP term, `noisy_topk`, MTP speculative
decoding (`infer.generate_speculative`, `cli sample --speculative`) and
the serving engine's MTP drafter.

One tiny JAX DeepSeek-V3 with 2 MTP heads (`tests/test_torch_deepseekv3.py`'s
shapes: dim 64, 2 layers, 4 heads, latent 8, decoupled RoPE 8, 4
experts top-2, vocab 256, block 64, float32, dropout 0) is built once
for the module by an eager `init` (a worker that has initialised that
file's model has compiled its ops already), its routing biases (the MTP
layers' included) set to N(0, 0.3), and carried across with
`convert.flax_to_torch`. Held against the JAX package at 1e-5 (routing
biases 1e-7, as `tests/test_torch_deepseekv3.py`), in one test
(`test_heads_match_reference`, so that one worker builds the reference):

* `convert` covers every `mtp_*` parameter and routing bias;
* the `return_mtp` logits (main and per head) with `use_flash` off and
  on (the port's flash path on the CPU is its plain version; the JAX
  side is its dense path, which its own tests hold to its Pallas
  kernel); `return_hidden`, and the two refused together;
* `ops.mtp_loss` and one training forward of `dsv3_loss_fn`: loss,
  `mtp_loss`, the `moe_*` metrics, every gradient and every new routing
  bias, the MTP layers' included;
* a cached `mtp_head_apply` chain of 2 heads (prefill, then a 2-column
  decode advance), logits and layer outputs;
* `noisy_topk`: the noise scale equals the reference's softplus of the
  same `noise` kernel (1e-5); the noise itself (another generator) is
  checked by its distribution and its seed.

Held inside the port (on the port's own initialization), by the
reference's own equalities: `generate_speculative` equals greedy
`generate` for 1 and 2 drafts,
also at the block's end, and one JAX `generate_speculative` run gives
the same tokens and stats; the MTP engine's greedy streams equal
spec-off at `spec_k` 1 and 2 with a routing bias that would overflow a
pooled MoE dispatch (the heads route per row); its refusals carry the
reference's messages; `cli sample --speculative` prints the `--greedy`
text.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu import ops as jops
from solvingpapers_tpu.infer import generate_speculative as jgenerate_speculative
from solvingpapers_tpu.infer.cache import LatentCache as JLatentCache
from solvingpapers_tpu.models.deepseekv3 import DeepSeekV3 as JDeepSeekV3
from solvingpapers_tpu.models.deepseekv3 import DeepSeekV3Config as JConfig
from solvingpapers_tpu.models.deepseekv3 import MoELayer as JMoELayer
from solvingpapers_tpu.models.deepseekv3 import mtp_head_apply as j_mtp_head_apply
from solvingpapers_tpu.train.objectives import dsv3_loss_fn as j_dsv3_loss_fn
from solvingpapers_tpu_torch import cli, ops
from solvingpapers_tpu_torch.convert import flax_to_torch
from solvingpapers_tpu_torch.infer import (
    LatentCache,
    generate,
    generate_speculative,
)
from solvingpapers_tpu_torch.models import DeepSeekV3, DeepSeekV3Config
from solvingpapers_tpu_torch.models.deepseekv3 import init_params, mtp_head_apply
from solvingpapers_tpu_torch.serve import ServeConfig, ServeEngine
from solvingpapers_tpu_torch.serve.sampling import SamplingParams
from solvingpapers_tpu_torch.train.objectives import dsv3_loss_fn
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
BIAS_TOL = 1e-7
VOCAB = 256
DIM = 64
TINY = dict(vocab_size=VOCAB, block_size=64, dim=DIM, n_layers=2, n_heads=4,
            latent_dim=8, rope_dim=8, n_experts=4, top_experts=2,
            dtype="float32", dropout=0.0, attn_dropout=0.0, pe_scale=0.02,
            mtp_heads=2, use_flash=False)
BATCH, SEQ = 2, 16


def _close(t, j, tol=TOL, msg=""):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol,
                               err_msg=msg)


def _tokens(seed, b=BATCH, s=SEQ):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, s))


def _reference():
    """The JAX model, its params and routing state (numpy)."""
    jm = JDeepSeekV3(JConfig(**TINY))
    variables = jm.init({"params": jax.random.key(0)},
                        jnp.zeros((1, 8), jnp.int32), return_mtp=True)
    params = jax.tree.map(np.asarray, variables["params"])
    r = np.random.default_rng(1)
    moe_state = jax.tree.map(
        lambda b: np.asarray(r.standard_normal(b.shape) * 0.3, np.float32),
        variables["moe_state"])
    return jm, params, moe_state


def _port(ref, **kw):
    _, params, moe_state = ref
    model = DeepSeekV3(DeepSeekV3Config(**{**TINY, **kw}), device="cpu",
                       param_dtype=torch.float32)
    model.load_state_dict(flax_to_torch(params, {"moe_state": moe_state}))
    return model


def _check_convert_and_forwards(ref):
    """`convert` covers every `mtp_*` parameter and routing bias; the
    `return_mtp` logits (main and per head) with `use_flash` off and on,
    and `return_hidden`, equal the reference's on one batch; the two
    returns are refused together by both packages."""
    jm, params, moe_state = ref
    sd = flax_to_torch(params, {"moe_state": moe_state})
    model = DeepSeekV3(DeepSeekV3Config(**TINY), device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    for k in (1, 2):
        assert {f"mtp_norm_{n}_{k}.{w}" for n in "he" for w in ("weight", "bias")
                } <= set(sd)
        np.testing.assert_array_equal(sd[f"mtp_merge_{k}.weight"].numpy(),
                                      params[f"mtp_merge_{k}"]["kernel"].T)
        np.testing.assert_array_equal(
            sd[f"mtp_layer_{k}.moe.routing_bias"].numpy(),
            moe_state[f"mtp_layer_{k}"]["moe"]["routing_bias"])

    toks = _tokens(3)
    v = {"params": params, "moe_state": moe_state}

    def both(t):  # one compiled program for the two returns
        (logits, mtp), _ = jm.apply(v, t, return_mtp=True)
        (_, hidden), _ = jm.apply(v, t, return_hidden=True)
        return logits, mtp, hidden

    jlogits, jmtp, jhidden = jax.jit(both)(toks)
    x = torch.from_numpy(toks)
    for use_flash in (False, True):
        model = _port(ref, use_flash=use_flash).eval()
        with torch.no_grad():
            (logits, mtp), _ = model(x, return_mtp=True)
            (logits2, hidden), _ = model(x, return_hidden=True)
        assert mtp.shape == (BATCH, SEQ, 2, VOCAB)
        _close(logits, jlogits, msg=f"use_flash={use_flash}")
        _close(mtp, jmtp, msg=f"use_flash={use_flash}")
        _close(logits2, jlogits)
        _close(hidden, jhidden)
    msg = "return_hidden and return_mtp are mutually exclusive"
    with pytest.raises(ValueError, match=msg):
        model(x, return_hidden=True, return_mtp=True)
    with pytest.raises(ValueError, match=msg):
        jm.apply(v, toks, return_hidden=True, return_mtp=True)


def _check_mtp_loss():
    """Head k at position i predicts token i + k + 1: the flat mean over
    valid targets, -1 ignored; a mismatched stream raises; the
    context-parallel sum names A7."""
    r = np.random.default_rng(4)
    logits = r.standard_normal((2, 5, 3, 11)).astype(np.float32)
    toks = r.integers(0, 11, (2, 8))
    toks[0, -2:] = -1
    got = ops.mtp_loss(torch.from_numpy(logits), torch.from_numpy(toks), 3,
                       ignore_index=-1)
    want = jops.mtp_loss(jnp.asarray(logits), jnp.asarray(toks), 3,
                         ignore_index=-1)
    _close(got, want)
    with pytest.raises(ValueError, match="T\\+K=8"):
        ops.mtp_loss(torch.from_numpy(logits), torch.from_numpy(toks[:, :7]), 3)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        ops.mtp_loss(torch.from_numpy(logits), torch.from_numpy(toks), 3,
                     axis_names=("context",))


def _check_training_forward(ref):
    """One training forward of `dsv3_loss_fn` with the MTP term: loss,
    `mtp_loss`, the `moe_*` metrics over all four MoE layers, the grad of
    every parameter and every new routing bias (MTP layers' included)."""
    jm, params, moe_state = ref
    toks = _tokens(6, s=SEQ + 1)
    batch = {"x": toks[:, :-1], "y": toks[:, 1:]}

    def jloss(p):
        loss, aux, ms = j_dsv3_loss_fn(jm, p, batch, jax.random.key(0),
                                       {"moe_state": moe_state}, True)
        return loss, (aux, ms)

    (jl, (jaux, jms)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    model = _port(ref).train()
    loss, aux, new_state = dsv3_loss_fn(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, 123)
    _close(loss, jl)
    assert set(aux) == set(jaux)
    for k in jaux:
        _close(aux[k], jaux[k], msg=k)
    loss.backward()
    want = flax_to_torch(jax.tree.map(np.asarray, jg))
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want)
    for k, g in grads.items():
        _close(g, want[k], msg=k)
    want_bias = flax_to_torch({}, jax.tree.map(np.asarray, jms))
    assert set(new_state) == set(want_bias) and len(new_state) == 4
    for k, b in new_state.items():
        _close(b, want_bias[k], tol=BIAS_TOL, msg=k)


def _check_cached_head_chain(ref):
    """Head 1 prefills its latent cache over 6 columns, then advances 2
    columns in decode mode; head 2 does the same on head 1's layer
    outputs: logits, layer outputs and cache rows equal the reference's
    `mtp_head_apply`."""
    _, params, moe_state = ref
    jcfg = JConfig(**TINY)
    r = np.random.default_rng(8)
    h = r.standard_normal((1, 8, DIM)).astype(np.float32)
    nxt = r.integers(0, VOCAB, (1, 8))
    width = TINY["latent_dim"] + TINY["rope_dim"]

    def jchain(h, nxt):
        outs = []
        y = h
        for head in (1, 2):
            c = JLatentCache.init(1, 12, width, jnp.float32)
            g, y6, c, _ = j_mtp_head_apply(
                jcfg, params, moe_state, y[:, :6], nxt[:, :6],
                jnp.arange(6)[None], cache=c, attend_len=6, head=head)
            g2, y2, c, _ = j_mtp_head_apply(
                jcfg, params, moe_state, y[:, 6:8], nxt[:, 6:8],
                jnp.arange(6, 8)[None], cache=c, head=head)
            outs += [g, g2, c.c]
            y = jnp.concatenate([y6, y2], axis=1)
        return outs

    want = jax.jit(jchain)(h, nxt)
    model = _port(ref).eval()
    got = []
    y = torch.from_numpy(h)
    t_nxt = torch.from_numpy(nxt)
    with torch.no_grad():
        for head in (1, 2):
            c = LatentCache.init(1, 12, width, torch.float32)
            g, y6, c, st = mtp_head_apply(model, y[:, :6], t_nxt[:, :6],
                                          torch.arange(6)[None], cache=c,
                                          attend_len=6, head=head)
            assert st is None  # deterministic
            g2, y2, c, _ = mtp_head_apply(model, y[:, 6:8], t_nxt[:, 6:8],
                                          torch.arange(6, 8)[None], cache=c,
                                          head=head)
            got += [g, g2, c.c]
            y = torch.cat([y6, y2], dim=1)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, msg=f"output {i}")


def test_noisy_topk_scale_matches_and_noise_is_standard_normal(monkeypatch):
    """The noise scale is the reference's softplus of the same `noise`
    kernel, within 1e-5 (XLA's float32 exp and log1p and torch's differ
    in the last bit, so bit equality is out of reach). In training the
    gate logits gain scale x N(0, 1) from a generator of the layer's seed
    (same seed, same noise; another seed, other noise); eval adds none."""
    cfg = dict(TINY, noisy_topk=True, n_layers=1, mtp_heads=0)
    x = np.random.default_rng(2).standard_normal((4, 128, DIM)).astype(np.float32)
    # the reference layer's parameters by name and shape (no computation)
    shapes = jax.eval_shape(JMoELayer(JConfig(**cfg)).init, jax.random.key(3), x)
    r = np.random.default_rng(3)
    jp = jax.tree.map(lambda a: (r.standard_normal(a.shape) * 0.1).astype(
        np.float32), shapes["params"])
    model = DeepSeekV3(DeepSeekV3Config(**cfg), device="cpu")
    sd = flax_to_torch({"layer_0": {"moe": jp}})
    moe = model.layers[0].moe
    assert set(sd) == {f"layers.0.moe.{k}" for k, _ in moe.named_parameters()}
    moe.load_state_dict({k.removeprefix("layers.0.moe."): v
                         for k, v in sd.items()}, strict=False)
    xt = torch.from_numpy(x.reshape(-1, DIM))
    scale = moe.noise_scale(xt)
    _close(scale, jax.nn.softplus(x.reshape(-1, DIM) @ jp["noise"]["kernel"]))

    seen = []
    real = ops.moe.topk_gate_probs
    monkeypatch.setattr(ops.moe, "topk_gate_probs",
                        lambda logits, k: seen.append(logits) or real(logits, k))
    gate = moe.gate(xt).detach()
    with torch.no_grad():
        moe(torch.from_numpy(x), True)
        for seed in (5, 5, 6):
            moe(torch.from_numpy(x), False, seed=seed)
    assert torch.equal(seen[0], gate)  # eval: no noise
    z = [((s - gate) / scale.detach()) for s in seen[1:]]
    assert torch.equal(z[0], z[1]) and not torch.equal(z[0], z[2])
    flat = z[0].flatten()  # 512 x 4 draws
    assert abs(float(flat.mean())) < 0.1 and abs(float(flat.std()) - 1) < 0.1


def test_heads_match_reference():
    """The checks against the JAX package, in one test so that one
    worker builds the reference model: `convert` and the forwards,
    `mtp_loss`, a training forward's loss, grads and routing biases, a
    cached 2-head chain, and one `generate_speculative` run."""
    ref = _reference()
    _check_convert_and_forwards(ref)
    _check_mtp_loss()
    _check_training_forward(ref)
    _check_cached_head_chain(ref)
    _check_generate_speculative(ref)


# ------------------------------------------------- speculative decoding


def _own(**kw):
    """The port's model from its own initializers (seed 0): the tests held
    inside the port need no JAX weights."""
    cfg = DeepSeekV3Config(**{**TINY, **kw})
    model = DeepSeekV3(cfg, device="cpu").eval()
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    return model


@pytest.fixture(scope="module")
def port_model():
    return _own()


@pytest.mark.parametrize("n_drafts", [1, 2])
def test_generate_speculative_equals_generate(port_model, n_drafts):
    """Greedy output equals `generate` token for token (untrained drafts
    mostly reject: the all-reject path must be exact too); each forward
    commits 1 + its accepted drafts."""
    prompt = torch.from_numpy(_tokens(11, b=1, s=9))
    for new in (5, 16):
        plain = generate(port_model, prompt, max_new_tokens=new, device="cpu")
        spec, stats = generate_speculative(port_model, prompt,
                                           max_new_tokens=new,
                                           n_drafts=n_drafts, device="cpu")
        assert torch.equal(spec, plain), new
        f, a = stats["forwards"], stats["accepted"]
        assert new <= f + a + 1 <= new + n_drafts and 0 <= a <= n_drafts * f


def test_generate_speculative_at_the_block_end_and_bad_inputs(port_model):
    """s0 + new + n_drafts - 1 == block_size decodes exactly (the chunk
    writes past the last position land in the caches' slack); one more
    raises, as do a batch of 2, too few heads and a short prompt."""
    s0 = 16
    new = TINY["block_size"] - s0 - 1
    prompt = torch.from_numpy(_tokens(2, b=1, s=s0))
    plain = generate(port_model, prompt, max_new_tokens=new, device="cpu")
    spec, _ = generate_speculative(port_model, prompt, max_new_tokens=new,
                                   n_drafts=2, prefill_chunk=5, device="cpu")
    assert torch.equal(spec, plain)
    with pytest.raises(ValueError, match="max positions"):
        generate_speculative(port_model, prompt, max_new_tokens=new + 1,
                             n_drafts=2, device="cpu")
    with pytest.raises(ValueError, match="batch 1"):
        generate_speculative(port_model, prompt.repeat(2, 1), device="cpu")
    with pytest.raises(ValueError, match="at least 3 tokens"):
        generate_speculative(port_model, prompt[:, :2], n_drafts=2,
                             device="cpu")
    one_head = DeepSeekV3(DeepSeekV3Config(**{**TINY, "mtp_heads": 1}),
                          device="cpu")
    with pytest.raises(ValueError, match="mtp_heads >= 2"):
        generate_speculative(one_head, prompt, n_drafts=2, device="cpu")


def _check_generate_speculative(ref):
    """One JAX `generate_speculative` run (2 drafts, 6 new tokens): the
    same tokens, forwards and accepted drafts."""
    jm, params, moe_state = ref
    prompt = _tokens(13, b=1, s=7)
    jtoks, jstats = jgenerate_speculative(
        jm, params, jnp.asarray(prompt, jnp.int32), max_new_tokens=6,
        extra_variables={"moe_state": moe_state}, n_drafts=2)
    toks, stats = generate_speculative(_port(ref).eval(),
                                       torch.from_numpy(prompt),
                                       max_new_tokens=6, n_drafts=2,
                                       device="cpu")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks)[:, :13])
    assert stats == {k: int(v) for k, v in jstats.items()}


# ---------------------------------------------------- the MTP drafter


@pytest.fixture(scope="module")
def skewed():
    """The port's model with every routing bias sending tokens to expert
    0 and a capacity factor of 0.5: a pooled dispatch of 8 slots' chunks
    (up to 24 tokens for 8 slots) drops, a row's (at most 3) cannot."""
    model = _own(capacity_factor=0.5)
    for name, buf in model.named_buffers():
        if name.endswith("routing_bias"):
            buf.copy_(torch.tensor([8.0, 0, 0, 0]))
    return model


def _serve(model, prompts, **kw):
    eng = ServeEngine(model, ServeConfig(n_slots=8, max_len=40, decode_block=4,
                                         bucket=8, **kw), device="cpu")
    hs = [eng.submit(p, max_new_tokens=20) for p in prompts]
    hs.append(eng.submit(prompts[0], max_new_tokens=12,
                         params=SamplingParams(temperature=1.0, seed=3)))
    with torch.no_grad():
        eng.run()
    return [h.tokens for h in hs], eng


@pytest.mark.parametrize("spec_k", [1, 2])
def test_mtp_engine_streams_equal_spec_off(skewed, spec_k):
    """Greedy streams (and a seeded one) equal spec-off's; /statusz names
    the drafter, k clamps to min(spec_k, heads, 2), the head lanes' bytes
    ride the gauges; a quarantine-style scrub and a rebuild reset them."""
    # every token to expert 0: 8 slots' (1 + k)-token chunks overflow a
    # pooled capacity, a row's never do
    assert (ops.moe.expert_capacity(8 * (1 + spec_k), 4, 2, 0.5)
            < 8 * (1 + spec_k))
    r = np.random.default_rng(5)
    prompts = [r.integers(0, VOCAB, n) for n in (3, 5, 9, 14, 17)]
    off, _ = _serve(skewed, prompts)
    # spec_k 4 clamps to the model's 2 heads
    on, eng = _serve(skewed, prompts, speculative="mtp",
                     spec_k=1 if spec_k == 1 else 4, spec_min_rate=0.0)
    assert on == off
    st = eng.statusz()["spec"]
    assert st["drafter"] == "mtp" and st["k"] == spec_k
    assert st["steps"] > 0 and st["drafts_proposed"] > 0
    width = TINY["latent_dim"] + TINY["rope_dim"]
    nbytes = spec_k * 8 * (40 + spec_k + 1) * width * 4
    assert st["mtp_cache_bytes"] == nbytes
    assert eng.metrics.snapshot()["serve/mtp_cache_bytes"] == nbytes
    eng._mtp_pool[0].c.fill_(1.0)
    eng._scrub_slot(3)
    assert not eng._mtp_pool[0].c[3].any() and eng._mtp_pool[0].c[2].all()
    eng._rebuild_pool(requeue=False)
    assert all(not c.c.any() for c in eng._mtp_pool)
    assert len(eng._mtp_pool) == spec_k


@pytest.mark.parametrize("kw,match", [
    (dict(), "(mtp_heads == 0)"),
    (dict(paged=True), "serves over the lane pool"),
    (dict(prefix_cache=True), "cannot reuse cached prefixes"),
    (dict(kv_quant="int8"), "kv_quant with speculative='mtp' is unsupported"),
])
def test_mtp_engine_refusals_carry_the_reference_messages(port_model, kw,
                                                          match):
    from durability_models import port_model as gpt_model

    model = gpt_model() if not kw else port_model
    with pytest.raises(ValueError, match=match.replace("(", r"\(").replace(
            ")", r"\)")):
        ServeEngine(model, ServeConfig(n_slots=2, max_len=32, **kw,
                                       speculative="mtp"), device="cpu")


def test_cli_sample_speculative_prints_the_greedy_text(tmp_path, capsys,
                                                       monkeypatch):
    """`cli sample --speculative` (1 and 2 drafts) prints exactly the
    `--greedy` text from the same checkpoint-less seed, with its
    `[speculative]` line on stderr; a sampled decode is refused."""
    from solvingpapers_tpu_torch.configs import registry

    def tiny():
        return registry.RunConfig(
            name="dsv3_mtp_clitest", model_family="deepseekv3",
            model=DeepSeekV3Config(**{**TINY, "vocab_size": 64}),
            data={"kind": "char", "path": None, "block_size": 32})

    monkeypatch.setitem(registry._REGISTRY, "dsv3_mtp_clitest", tiny)
    corpus = tmp_path / "c.txt"
    corpus.write_text("abcdefgh " * 400)
    common = ["sample", "--config", "dsv3_mtp_clitest", "--device", "cpu",
              "--data-path", str(corpus), "--prompt", "abcab",
              "--max-new-tokens", "12", "--seed", "3"]
    assert cli.main(common + ["--greedy"]) == 0
    plain = capsys.readouterr().out
    for drafts in ("1", "2"):
        assert cli.main(common + ["--greedy", "--speculative",
                                  "--spec-drafts", drafts]) == 0
        cap = capsys.readouterr()
        assert cap.out == plain
        assert "[speculative] forwards=" in cap.err
    assert cli.main(common + ["--speculative"]) == 2
    assert "pass --greedy" in capsys.readouterr().err
