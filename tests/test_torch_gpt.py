"""The port's GPT vs the JAX package's, on the same weights and inputs.

* logits: a model initialised in JAX, carried across with
  `convert.flax_to_torch`, runs the same numpy-made tokens in both
  packages (float32, deterministic) at `gpt_tiny`'s shape and at a
  2-layer, 1-head model of head width 256 (`gpt_shakespeare`'s width):
  within 1e-5 of the largest logit;
* `Trainer`: from converted params and identical batches, one and three
  steps of the port's trainer match the JAX `Trainer`'s (single-device
  mesh, `gpt_tiny` at dropout 0, its AdamW and an SGD): train_loss,
  grad_norm and lr within 1e-5, every updated param within 1e-5 of the
  largest param (under AdamW but for the key biases, whose exact
  gradient is 0);
* `scan_steps`: a window of 5 steps is bit-identical to 5 single steps,
  with dropout 0.1 active (the same batches, step seeds and optimizer
  state); a cadence that is not a multiple of the window raises the
  reference's error;
* greedy `generate` (prefill with `attend_len`, then cached decode) is
  token-exact against the reference's `infer/decode.py::generate`;
* the registry's GPT, Markov and Shakespeare configs carry the
  reference's fields, and the factory resizes the vocab to the corpus as
  the reference's does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu.configs import factory as jfactory
from solvingpapers_tpu.configs import registry as jreg
from solvingpapers_tpu.infer.decode import generate as j_generate
from solvingpapers_tpu.models.gpt import GPT as JGPT
from solvingpapers_tpu.models.gpt import GPTConfig as JGPTConfig
from solvingpapers_tpu.sharding import MeshConfig, create_mesh
from solvingpapers_tpu.train.engine import Trainer as JTrainer
from solvingpapers_tpu_torch.configs import factory, get_config
from solvingpapers_tpu_torch.convert import flax_to_torch
from solvingpapers_tpu_torch.data import lm_batch_iterator
from solvingpapers_tpu_torch.infer.decode import generate
from solvingpapers_tpu_torch.models import GPT, GPTConfig
from solvingpapers_tpu_torch.train import OptimizerConfig, TrainConfig, Trainer
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)


TOL = 1e-5
TINY = dict(vocab_size=64, block_size=64, dim=64, n_layers=2, n_heads=2,
            dropout=0.0)
WIDE = dict(vocab_size=65, block_size=64, dim=256, n_layers=2, n_heads=1,
            dropout=0.1)
SEQ, BATCH, STEPS = 32, 2, 3


def _numpy(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _pair(kw, seed=0):
    """(jax model, numpy params, port model in eval mode) on one set of
    weights."""
    jm = JGPT(JGPTConfig(**kw))
    params = jm.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    model = GPT(GPTConfig(**kw), device="cpu")
    model.load_state_dict(flax_to_torch(_numpy(params)))
    return jm, _numpy(params), model.eval()


@pytest.mark.parametrize("kw", [TINY, WIDE], ids=["gpt_tiny", "head_dim_256"])
def test_logits_match_jax(kw):
    jm, params, model = _pair(kw)
    toks = np.random.default_rng(1).integers(0, kw["vocab_size"], (2, 48))
    want, _ = jm.apply({"params": params}, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(toks))
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()


def test_positions_past_the_table_raise():
    _, _, model = _pair(TINY)
    with pytest.raises(ValueError, match="max positions"):
        model(torch.zeros(1, TINY["block_size"] + 1, dtype=torch.long))


# --------------------------------------------------------------- trainer


def _batches(seed, n, vocab=TINY["vocab_size"]):
    r = np.random.default_rng(seed)
    return [{"x": r.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
             "y": r.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)}
            for _ in range(n)]


@pytest.fixture(scope="module", params=["adamw", "sgd"])
def jax_run(request):
    """The JAX Trainer's run on `gpt_tiny` (dropout 0) with its AdamW or
    `llama3_shakespeare`'s SGD: initial params and per-step metrics and
    params."""
    run = jreg.get_config("gpt_tiny")
    optimizer = (run.train.optimizer if request.param == "adamw" else
                 jreg.get_config("llama3_shakespeare").train.optimizer)
    train = dataclasses.replace(run.train, mesh=MeshConfig(data=1),
                                batch_size=BATCH, optimizer=optimizer)
    trainer = JTrainer(JGPT(run.model), train,
                       mesh=create_mesh(MeshConfig(data=1), jax.devices()[:1]))
    batches = _batches(0, STEPS)
    state = trainer.init_state(batches[0])
    params0 = _numpy(state.params)
    trainer._build_steps()
    metrics, params = [], []
    for b in batches:
        state, m = trainer._train_step(state, b)
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
        params.append(_numpy(state.params))
    return dict(optimizer=optimizer, batches=batches,
                params0=params0, metrics=metrics, params=params)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_trainer_steps_match_jax_trainer(jax_run, n_steps):
    run = get_config("gpt_tiny")
    train = dataclasses.replace(
        run.train, batch_size=BATCH,
        optimizer=OptimizerConfig(**dataclasses.asdict(jax_run["optimizer"])))
    trainer = Trainer(GPT(run.model, device="cpu", param_dtype=torch.float32),
                      train, device="cpu")
    state = trainer.init_state()
    trainer.model.load_state_dict(flax_to_torch(jax_run["params0"]))
    for i in range(n_steps):
        m = trainer.train_step(state, jax_run["batches"][i])
        want = jax_run["metrics"][i]
        for key in ("train_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), want[key], rtol=TOL,
                                       atol=TOL, err_msg=f"{key} step {i}")
    ref = flax_to_torch(jax_run["params"][n_steps - 1])
    got = trainer.model.state_dict()
    assert set(got) == set(ref)
    scale = max(float(v.abs().max()) for v in ref.values())
    for k in ref:
        if jax_run["optimizer"].name == "adamw" and k.endswith("attn.k.bias"):
            # its exact gradient is 0 (a shift of every key leaves the
            # softmax as it is), so AdamW's update g / sqrt(v) is the sign
            # of each package's rounding noise, of the lr's size
            continue
        assert float((got[k] - ref[k]).abs().max()) <= TOL * scale, k


def _scan_trainer(scan_steps, **overrides):
    cfg = GPTConfig(vocab_size=32, block_size=16, dim=32, n_layers=2,
                    n_heads=2, dropout=0.1)
    train = TrainConfig(**{
        **dict(steps=5, batch_size=2, log_every=5, eval_every=0,
               scan_steps=scan_steps, tokens_per_step=2 * 16,
               optimizer=OptimizerConfig(max_lr=1e-2, warmup_steps=2,
                                         total_steps=5)),
        **overrides})
    return Trainer(GPT(cfg, device="cpu", param_dtype=torch.float32), train,
                   device="cpu")


def _flat(tree) -> list:
    """The tensors and numbers of a nested state dict, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


class _Rows:
    def __init__(self):
        self.rows = []

    def write(self, step, metrics):
        self.rows.append((step, dict(metrics)))

    def close(self):
        pass


def test_scan_window_is_bit_identical_to_single_steps():
    """`scan_steps=5` runs one window of 5 steps; the params, optimizer
    state, step count and last logged loss equal 5 single steps' exactly,
    with dropout 0.1 drawing every step's masks."""
    toks = np.random.default_rng(3).integers(0, 32, 4000)
    states, rows = [], []
    for k in (1, 5):
        trainer = _scan_trainer(k)
        writer = _Rows()
        states.append(trainer.fit(lm_batch_iterator(toks, 2, 16, seed=0),
                                  writer=writer))
        rows.append(writer.rows)
    a, b = states
    assert a.step == b.step == 5
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    opt_a, opt_b = _flat(a.optimizer.state_dict()), _flat(b.optimizer.state_dict())
    assert len(opt_a) == len(opt_b)
    for x, y in zip(opt_a, opt_b):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
    assert [s for s, _ in rows[0]] == [5] and [s for s, _ in rows[1]] == [5]
    assert rows[0][0][1]["train_loss"] == rows[1][0][1]["train_loss"]


@pytest.mark.parametrize("cadence", ["log_every", "eval_every", "ckpt_every"])
def test_cadence_off_the_window_raises(cadence):
    trainer = _scan_trainer(5, **{cadence: 3})
    toks = np.arange(400) % 32
    with pytest.raises(ValueError, match=f"{cadence}=3 must be a multiple of "
                                         "scan_steps=5: the host only sees "
                                         "window boundaries"):
        trainer.fit(lm_batch_iterator(toks, 2, 16, seed=0))


# -------------------------------------------------------------- generate


@pytest.mark.parametrize("kw", [TINY, WIDE], ids=["gpt_tiny", "head_dim_256"])
def test_greedy_generate_matches_jax(kw):
    jm, params, model = _pair(kw, seed=2)
    prompt = np.random.default_rng(4).integers(0, kw["vocab_size"], (2, 7))
    want = j_generate(jm, params, jnp.asarray(prompt, jnp.int32),
                      jax.random.key(0), max_new_tokens=20)
    got = generate(model, torch.from_numpy(prompt), max_new_tokens=20,
                   device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------ registry, factory

CONFIGS = ["gpt_tiny", "gpt_tiny_long", "gpt_shakespeare", "gpt_markov",
           "llama3_markov", "dsv3_markov", "llama3_shakespeare"]


@pytest.mark.parametrize("name", CONFIGS)
def test_registry_carries_the_reference_fields(name):
    ours, ref = get_config(name), jreg.get_config(name)
    assert ours.model_family == ref.model_family
    assert ours.data == ref.data
    mine, theirs = dataclasses.asdict(ours.model), dataclasses.asdict(ref.model)
    assert mine == {k: theirs[k] for k in mine}
    # a field the port does not carry holds the reference's default
    defaults = dataclasses.asdict(type(ref.model)())
    assert all(theirs[k] == defaults[k] for k in set(theirs) - set(mine))
    assert dataclasses.asdict(ours.train.optimizer) == dataclasses.asdict(
        ref.train.optimizer)
    for f in ("steps", "batch_size", "log_every", "eval_every", "eval_batches",
              "ckpt_every", "seed", "tokens_per_step", "scan_steps"):
        assert getattr(ours.train, f) == getattr(ref.train, f), f
    assert ours.train.unported() == []


@pytest.mark.parametrize("name,n_chars", [("gpt_tiny", None),
                                          ("gpt_markov", 20_000),
                                          ("llama3_markov", 20_000),
                                          ("dsv3_markov", 20_000),
                                          ("llama3_shakespeare", None)])
def test_factory_resizes_the_vocab_to_the_corpus(name, n_chars):
    """The factory's char and Markov branches build the reference's
    corpus and tokenizer and resize the model's vocab to it (a Markov
    corpus cut to `n_chars` to keep the CPU run short)."""
    ours, ref = get_config(name), jreg.get_config(name)
    if n_chars:
        data = {**ours.data, "n_chars": n_chars}
        ours = dataclasses.replace(ours, data=data)
        ref = dataclasses.replace(ref, data=data)
    jcfg, _, jtok, _, _ = jfactory.build_char_lm_run(ref)
    cfg, model, tok, train_iter, _ = factory.build_char_lm_run(ours, device="cpu")
    assert cfg.model.vocab_size == jcfg.model.vocab_size == jtok.vocab_size
    assert model.tok_emb.weight.shape[0] == cfg.model.vocab_size
    assert tok.chars == jtok.chars
    assert next(train_iter)["x"].shape == (ours.train.batch_size,
                                           ours.data["block_size"])
