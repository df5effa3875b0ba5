"""The port's training slice vs the JAX package's, on the same inputs.

* `warmup_cosine` equals optax's schedules, both branches;
* `make_optimizer` updates equal optax's chains on the same numpy
  params and grads (AdamW, SGD, Adam; with and without a clip, and a
  clip that fires);
* `cross_entropy` and its gradient equal the reference's, chunked and
  unchunked, with and without `ignore_index`;
* token files: the same file reads the same in both packages, and the
  memmap `lm_batch_iterator` yields identical batches;
* `Trainer`: from converted params and identical batches, one and three
  steps of the port's trainer match the JAX `Trainer` (single-device
  mesh, the dense twin of `llama3_long_smoke`: 2 layers, dim 64, 4 q /
  2 kv heads, float32, flash attention — the JAX kernels in interpret
  mode, the port's plain versions on the CPU) for AdamW (the registry's)
  and SGD (`llama3_shakespeare`'s): train_loss, grad_norm, lr and every
  updated param within 1e-5; `evaluate` likewise;
* a checkpoint round trip resumes exactly; a 40-step CPU fit's loss
  falls; the options the port does not run raise.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from solvingpapers_tpu.configs import registry as jreg
from solvingpapers_tpu.data import batches as jbatches
from solvingpapers_tpu.data import tokens as jtokens
from solvingpapers_tpu.models.llama3 import Llama as JLlama
from solvingpapers_tpu.ops.losses import cross_entropy as j_cross_entropy
from solvingpapers_tpu.sharding import MeshConfig, create_mesh
from solvingpapers_tpu.train import optim as joptim
from solvingpapers_tpu.train.engine import Trainer as JTrainer
from solvingpapers_tpu_torch.configs import dense_twin, get_config
from solvingpapers_tpu_torch.configs import factory
from solvingpapers_tpu_torch.convert import flax_to_torch
from solvingpapers_tpu_torch.data import (
    lm_batch_iterator,
    load_token_file,
    random_crop_batch,
    sliding_window_split,
    split_train_val,
    token_file_max_id,
)
from solvingpapers_tpu_torch.metrics import (
    JSONLWriter,
    MultiWriter,
    active_param_count,
    chip_peak_flops,
    transformer_flops_per_token,
)
from solvingpapers_tpu_torch.models import Llama, LlamaConfig
from solvingpapers_tpu_torch.ops import cross_entropy
from solvingpapers_tpu_torch.ops import losses as tlosses
from solvingpapers_tpu_torch.train import (
    OptimizerConfig,
    TrainConfig,
    Trainer,
    make_optimizer,
    warmup_cosine,
)
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)


TOL = 1e-5
SEQ, BATCH, STEPS = 32, 2, 3
SGD = jreg.get_config("llama3_shakespeare").train.optimizer


# ------------------------------------------------------------- schedules


@pytest.mark.parametrize("warmup,total,ratio", [(5, 20, 0.1), (0, 30, 1.0),
                                                (0, 12, 0.1), (10, 10, 0.5)])
def test_warmup_cosine_matches_optax(warmup, total, ratio):
    ours = warmup_cosine(3e-4, warmup, total, ratio)
    ref = joptim.warmup_cosine(3e-4, warmup, total, ratio)
    for step in range(total + 5):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-12)
    if warmup:
        assert ours(0) == 0.0


# ------------------------------------------------------------- optimizer


def _tree(seed):
    r = np.random.default_rng(seed)
    return {"w": r.standard_normal((6, 5)).astype(np.float32),
            "b": r.standard_normal(5).astype(np.float32),
            "norm": np.ones(3, np.float32)}


@pytest.mark.parametrize("name,clip", [("adamw", 1.0), ("adamw", 0.0),
                                       ("adamw", 0.05), ("sgd", 0.0),
                                       ("sgd", 0.05), ("adam", 1.0),
                                       ("adam", 0.05)])
def test_optimizer_updates_match_optax(name, clip):
    """Three updates from the same params and grads: the port's params
    and unclipped grad norms equal optax's (clip 0.05 fires every step,
    1.0 never does at these grads)."""
    cfg = OptimizerConfig(name=name, max_lr=1e-2, warmup_steps=1,
                          total_steps=10, grad_clip=clip, weight_decay=0.1)
    jcfg = joptim.OptimizerConfig(**dataclasses.asdict(cfg))
    tx, _ = joptim.make_optimizer(jcfg)
    jparams = jax.tree.map(jnp.asarray, _tree(0))
    jstate = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in _tree(0).items()}
    opt, schedule = make_optimizer(cfg, params.values())
    for step in range(3):
        grads = {k: 0.1 * v for k, v in _tree(step + 1).items()}
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k].copy())
        norm, lr = opt.step(step)
        jg = jax.tree.map(jnp.asarray, grads)
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)),
                                   rtol=1e-6)
        assert lr == schedule(step)
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=TOL,
                                       atol=1e-7, err_msg=f"{name} {k} {step}")


def test_accumulation_and_unknown_optimizers_raise():
    """Accumulation is ported (`tests/test_torch_accum.py`); an
    accum_steps below 1 and an unknown optimizer raise."""
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="accum_steps"):
        make_optimizer(OptimizerConfig(accum_steps=0), p)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(OptimizerConfig(name="lion"), p)


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("ignore", [None, -100])
@pytest.mark.parametrize("chunk", [None, 16])
def test_cross_entropy_and_grad_match_reference(ignore, chunk):
    r = np.random.default_rng(0)
    logits = r.standard_normal((2, 37, 50)).astype(np.float32)
    labels = r.integers(0, 50, (2, 37))
    if ignore is not None:
        labels[0, :5] = ignore
    t = torch.from_numpy(logits).requires_grad_()
    loss = cross_entropy(t, torch.from_numpy(labels), ignore_index=ignore,
                         chunk_size=chunk)
    loss.backward()
    jloss, jgrad = jax.value_and_grad(
        lambda x: j_cross_entropy(x, jnp.asarray(labels), ignore_index=ignore,
                                  chunk_size=chunk))(jnp.asarray(logits))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=TOL,
                               atol=1e-8)


def test_cross_entropy_auto_chunks_past_the_threshold(monkeypatch):
    """"auto" takes the chunked path once logits exceed the element
    threshold (here lowered to the test's size), with the same value."""
    logits = torch.randn(3, 40, 30, dtype=torch.float64).float()
    labels = torch.randint(0, 30, (3, 40))
    one_pass = cross_entropy(logits, labels, chunk_size=None)
    calls = []
    real = tlosses.checkpoint
    monkeypatch.setattr(tlosses, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(tlosses, "_AUTO_CHUNK_ELEMENTS", 1000)
    monkeypatch.setattr(tlosses, "_AUTO_CHUNK_ROWS", 50)
    auto = cross_entropy(logits, labels)
    assert len(calls) == 3  # 120 rows in chunks of 50
    torch.testing.assert_close(auto, one_pass, rtol=1e-6, atol=0)


# ------------------------------------------------------------------ data


def test_token_files_and_memmap_batches_match_reference(tmp_path):
    class Tok:
        vocab_size = 300

        def encode(self, text):
            return [ord(c) % 300 for c in text]

    text = "".join(chr(32 + i % 90) for i in range(5000))
    path = str(tmp_path / "toks.bin")
    jtokens.tokenize_to_file(text, Tok(), path)
    toks = load_token_file(path)
    assert isinstance(toks, np.memmap) and toks.dtype == np.uint16
    np.testing.assert_array_equal(toks, jtokens.load_token_file(path))
    assert token_file_max_id(path, toks) == jtokens.token_file_max_id(path, toks)
    train, val = split_train_val(toks)
    assert len(val) == 500 and len(train) == 4500
    ours = lm_batch_iterator(train, 4, 64, seed=3)
    ref = jbatches.lm_batch_iterator(jtokens.load_token_file(path)[:4500], 4,
                                     64, seed=3)
    for _ in range(3):
        a, b = next(ours), next(ref)
        for key in ("x", "y"):
            assert a[key].dtype == torch.int32
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))


def test_in_memory_batches_and_explicit_crops():
    toks = np.arange(1000) % 97
    starts = torch.tensor([0, 5, 900])
    x, y = random_crop_batch(torch.as_tensor(toks), starts, 8)
    np.testing.assert_array_equal(x.numpy()[1], toks[5:13])
    np.testing.assert_array_equal(y.numpy()[2], toks[901:909])
    a = next(lm_batch_iterator(toks, 3, 16, seed=1))
    b = next(lm_batch_iterator(toks, 3, 16, seed=1))
    assert torch.equal(a["x"], b["x"]) and a["x"].shape == (3, 16)
    assert torch.equal(a["x"][:, 1:], a["y"][:, :-1])
    sx, sy = sliding_window_split(toks[:50], 8, stride=4)
    rx, ry = jbatches.sliding_window_split(toks[:50], 8, stride=4)
    np.testing.assert_array_equal(sx, rx)
    np.testing.assert_array_equal(sy, ry)
    with pytest.raises(ValueError, match="too short"):
        next(lm_batch_iterator(toks[:10], 2, 16))


# --------------------------------------------------------------- trainer


def _batches(seed, n, vocab=256):
    r = np.random.default_rng(seed)
    return [{"x": r.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
             "y": r.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)}
            for _ in range(n)]


def _copy(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module", params=["adamw", "sgd"])
def jax_run(request):
    """The JAX Trainer's run on the dense twin of `llama3_long_smoke`:
    initial params, per-step metrics and params, an evaluation."""
    run = jreg.get_config("llama3_long_smoke")
    optimizer = run.train.optimizer if request.param == "adamw" else SGD
    train = dataclasses.replace(run.train, context_parallel=False,
                                mesh=MeshConfig(data=1), batch_size=BATCH,
                                optimizer=optimizer)
    model = JLlama(dataclasses.replace(run.model, context_parallel=False))
    trainer = JTrainer(model, train,
                       mesh=create_mesh(MeshConfig(data=1), jax.devices()[:1]))
    batches = _batches(0, STEPS + 2)
    state = trainer.init_state(batches[0])
    params0 = _copy(state.params)
    trainer._build_steps()
    metrics, params = [], []
    for b in batches[:STEPS]:
        state, m = trainer._train_step(state, b)
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
        params.append(_copy(state.params))
    val = trainer.evaluate(state, iter(batches[STEPS:]))
    return dict(name=request.param, optimizer=optimizer, batches=batches,
                params0=params0, metrics=metrics, params=params, val=val)


def _port_trainer(jax_optimizer):
    run = dense_twin(get_config("llama3_long_smoke"))
    train = dataclasses.replace(
        run.train, batch_size=BATCH,
        optimizer=OptimizerConfig(**dataclasses.asdict(jax_optimizer)))
    model = Llama(run.model, device="cpu", param_dtype=torch.float32)
    return Trainer(model, train, device="cpu")


@pytest.mark.parametrize("n_steps", [1, 3])
def test_trainer_steps_match_jax_trainer(jax_run, n_steps):
    trainer = _port_trainer(jax_run["optimizer"])
    state = trainer.init_state()
    trainer.model.load_state_dict(flax_to_torch(jax_run["params0"]))
    for i in range(n_steps):
        m = trainer.train_step(state, jax_run["batches"][i])
        want = jax_run["metrics"][i]
        assert set(m) == set(want)
        for key in ("train_loss", "grad_norm", "lr", "train_perplexity"):
            np.testing.assert_allclose(float(m[key]), want[key], rtol=TOL,
                                       atol=TOL, err_msg=f"{key} step {i}")
    assert state.step == n_steps
    ref = flax_to_torch(jax_run["params"][n_steps - 1])
    got = trainer.model.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)
    if n_steps == STEPS:
        val = trainer.evaluate(state, iter(jax_run["batches"][STEPS:]))
        assert set(val) == set(jax_run["val"])
        for k, v in val.items():
            np.testing.assert_allclose(v, jax_run["val"][k], rtol=TOL)


def _tiny_trainer(tmp_path=None, **train_kw):
    cfg = LlamaConfig(vocab_size=64, max_seq_len=32, dim=32, n_layers=1,
                      n_heads=2, n_kv_heads=1, use_flash=True)
    train = TrainConfig(batch_size=4, log_every=10, eval_every=20,
                        eval_batches=2, tokens_per_step=4 * 16,
                        optimizer=OptimizerConfig(max_lr=1e-2, warmup_steps=5,
                                                  total_steps=40),
                        **train_kw)
    return Trainer(Llama(cfg, device="cpu", param_dtype=torch.float32), train,
                   device="cpu")


def test_fit_loss_falls_and_logs_the_metrics(tmp_path):
    """40 steps on a periodic token stream: the loss falls from about
    ln(64) (a random init's) to well below it, and keeps falling; log
    rows carry the timing metrics (no MFU: the CPU has no
    peak), eval rows the val metrics."""
    toks = np.tile(np.arange(40) % 13 + 3, 200)
    trainer = _tiny_trainer(steps=40, flops_per_token=1e6)
    log = str(tmp_path / "m.jsonl")
    writer = MultiWriter(JSONLWriter(log))
    with pytest.warns(UserWarning, match="no peak known"):
        trainer.fit(lm_batch_iterator(toks, 4, 16, seed=0),
                    lambda: lm_batch_iterator(toks, 4, 16, seed=9),
                    writer=writer)
    writer.close()
    rows = [json.loads(line) for line in open(log)]
    train_rows = [r for r in rows if "train_loss" in r]
    assert [r["step"] for r in train_rows] == [10, 20, 30, 40]
    assert train_rows[-1]["train_loss"] < train_rows[0]["train_loss"]
    assert train_rows[-1]["train_loss"] < math.log(64) - 2.0
    assert all(r["step_time_s"] > 0 and r["tokens_per_sec"] > 0
               and "mfu" not in r for r in train_rows)
    assert train_rows[-1]["tokens"] == 40 * 64
    val_rows = [r for r in rows if "val_loss" in r]
    assert [r["step"] for r in val_rows] == [20, 40]
    assert math.isclose(val_rows[-1]["val_perplexity"],
                        math.exp(val_rows[-1]["val_loss"]), rel_tol=0.2)


def test_checkpoint_round_trip_resumes_exactly(tmp_path):
    """fit to step 4 with checkpoints, then a fresh trainer resumes from
    the newest one and trains to step 6: its params equal an unbroken
    6-step run's."""
    toks = np.arange(3000) % 61
    batches = list(_take(lm_batch_iterator(toks, 4, 16, seed=2), 6))
    ckpt = dict(checkpoint_dir=str(tmp_path / "ck"), ckpt_every=2, keep_n=2)
    first = _tiny_trainer(steps=4, **ckpt)
    first.fit(iter(batches[:4]), writer=MultiWriter())
    resumed = _tiny_trainer(steps=6, seed=5, **ckpt)  # other init: overwritten
    state = resumed.fit(iter(batches[4:]), writer=MultiWriter())
    assert state.step == 6
    unbroken = _tiny_trainer(steps=6)
    unbroken.fit(iter(batches), writer=MultiWriter())
    for (k, a), b in zip(resumed.model.state_dict().items(),
                         unbroken.model.state_dict().values()):
        assert torch.equal(a, b), k
    saved = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert saved == ["step_4.pt", "step_6.pt"]  # keep_n = 2


def _take(it, n):
    for _ in range(n):
        yield next(it)


# ------------------------------------------------------- what is refused


@pytest.mark.parametrize("option", [
    dict(mesh={"data": -1, "context": 4}), dict(context_parallel=True),
    dict(pipeline_parallel=True), dict(xla_obs=True),
    dict(mesh_obs=True), dict(trace_path="t.json"), dict(status_port=0)])
def test_trainer_refuses_unported_options(option):
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        _tiny_trainer(**option)


@pytest.mark.parametrize("field,match", [
    pytest.param("dropout", "not ported", id="dropout-B4")])
def test_training_with_dropout_or_remat_raises(field, match):
    """LLaMA's block dropout is not ported: training with it raises.
    (remat trains now: test_llama_remat_grads_equal_no_remat.)"""
    cfg = LlamaConfig(vocab_size=64, max_seq_len=32, dim=32, n_layers=1,
                      n_heads=2, n_kv_heads=1, **{field: 0.1})
    model = Llama(cfg, device="cpu")
    tokens = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match=match):
        model(tokens)
    with torch.no_grad():  # serving such a config is fine
        assert model.eval()(tokens)[0].shape == (1, 8, 64)


@pytest.mark.parametrize("use_flash", [True, False])
def test_llama_remat_grads_equal_no_remat(use_flash):
    """remat=True recomputes each block in the backward
    (`maybe_remat`): loss and every gradient equal the plain run's
    exactly (the same ops run on the same inputs)."""
    cfg = LlamaConfig(vocab_size=64, max_seq_len=32, dim=32, n_layers=2,
                      n_heads=2, n_kv_heads=1, use_flash=use_flash)
    weights = Llama(cfg, device="cpu").state_dict()
    gen = torch.Generator().manual_seed(0)
    for k, v in weights.items():
        v.copy_(torch.randn(v.shape, generator=gen) * 0.1)
    tokens = torch.randint(0, 64, (2, 16), generator=gen)
    grads = []
    for remat in (False, True):
        model = Llama(dataclasses.replace(cfg, remat=remat), device="cpu",
                      param_dtype=torch.float32)
        model.load_state_dict(weights)
        loss = cross_entropy(model(tokens)[0], tokens)
        loss.backward()
        grads.append([loss.detach()] + [p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_trainer_refuses_a_model_on_another_device():
    model = Llama(LlamaConfig(vocab_size=64, max_seq_len=32, dim=32,
                              n_layers=1, n_heads=2, n_kv_heads=1), device="cpu")
    with pytest.raises(ValueError, match="model lives on"):
        Trainer(model, TrainConfig(), device="meta")


# ----------------------------------------------------- configs, metrics


@pytest.mark.parametrize("name", ["llama3_long", "llama3_long_smoke",
                                  "llama3_shakespeare"])
def test_registry_carries_the_reference_train_and_data_values(name):
    ours, ref = get_config(name), jreg.get_config(name)
    assert ours.data == ref.data
    assert dataclasses.asdict(ours.train.optimizer) == dataclasses.asdict(
        ref.train.optimizer)
    for f in ("steps", "batch_size", "log_every", "eval_every", "eval_batches",
              "ckpt_every", "seed", "tokens_per_step", "context_parallel"):
        assert getattr(ours.train, f) == getattr(ref.train, f), f
    assert (ours.train.mesh is None) == (ref.train.mesh == MeshConfig())
    twin = dense_twin(ours)
    assert twin.train.unported() == [] and not twin.model.context_parallel


def test_factory_builds_a_token_file_run_and_refuses_other_kinds(tmp_path):
    path = str(tmp_path / "t.bin")
    ids = (np.arange(4000) * 7 % 250).astype(np.uint16)
    ids.tofile(path)
    with open(path + ".meta", "w") as f:
        f.write(f"uint16\nmax_id={int(ids.max())}\n")
    run = dataclasses.replace(
        dense_twin(get_config("llama3_long_smoke")),
        data={"kind": "tokens", "path": path, "block_size": 32})
    cfg, model, tok, train_iter, eval_fn = factory.build_char_lm_run(
        run, device="cpu")
    assert model.tok_emb.weight.dtype == torch.float32
    assert tok.decode(tok.encode("3 4 5")) == "3 4 5"
    batch = next(train_iter)
    assert batch["x"].shape == (run.train.batch_size, 32)
    assert next(eval_fn())["y"].dtype == torch.int32
    assert factory.loss_fn_for(cfg) is not None
    bad = dataclasses.replace(run, data={"kind": "images"})
    with pytest.raises(ValueError, match="unknown data kind"):
        factory.build_char_lm_run(bad, device="cpu")
    big = dataclasses.replace(run, model=dataclasses.replace(run.model,
                                                             vocab_size=100))
    with pytest.raises(ValueError, match="holds id"):
        factory.build_char_lm_run(big, device="cpu")


@pytest.mark.parametrize("card,peak", [("NVIDIA H100 80GB HBM3", 989e12),
                                       ("NVIDIA H100 PCIe", 756e12),
                                       ("NVIDIA A100-SXM4-80GB", math.nan)])
def test_chip_peak_flops_reads_the_card_name(monkeypatch, card, peak):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: card)
    if math.isnan(peak):
        with pytest.warns(UserWarning, match="no peak known"):
            assert math.isnan(chip_peak_flops("cuda:0"))
    else:
        assert chip_peak_flops("cuda:0") == peak


def test_flops_per_token_and_param_count():
    cfg = dense_twin(get_config("llama3_long")).model
    model = Llama(dataclasses.replace(cfg, n_layers=1, vocab_size=1000),
                  device="meta")
    n = active_param_count(model)
    assert n == active_param_count(dict(model.state_dict()))
    # 287.5 M parameters at full depth and vocab, 3.34 GFLOP a token at 8192
    full = 2 * 50257 * 1024 + 1024 + 16 * (
        2 * 1024 + 1024 * (1024 + 2 * 512) + 1024 * 1024 + 3 * 1024 * 2730)
    assert round(full / 1e6, 1) == 287.5
    assert round(transformer_flops_per_token(full, 16, 1024, 8192) / 1e9,
                 2) == 3.34
