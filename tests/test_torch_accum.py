"""Gradient accumulation (`OptimizerConfig.accum_steps`) and `fit`'s
callbacks: the port against the JAX package's ``optax.MultiSteps``.

* the optimizer alone: k = 2 and 3 calls a window over the same numpy
  params and grads, AdamW, SGD and Adam, a clip that fires on the mean:
  params, unclipped micro-step grad norms and logged lrs equal optax's
  after every call;
* `Trainer` against the JAX `Trainer` (single-device mesh, the dense
  twin of `llama3_long_smoke` as in `tests/test_torch_train.py`), k = 2
  and 3, AdamW and SGD, grad clip 0.05 (it fires): train_loss,
  grad_norm, lr, perplexity and every param after each of 2k + 1 steps
  (so after 2k, two whole windows, and 2k + 1, a partial one);
* DeepSeek-V3 (the tiny model of `tests/test_torch_deepseekv3.py`),
  k = 2: the routing biases move every micro-step and equal the JAX
  Trainer's after each one, with the loss and the params;
* a checkpoint taken inside a window resumes it exactly;
* `fit(callbacks=...)` calls each hook at its cadence.

Tolerances: those of `tests/test_torch_train.py` and
`tests/test_torch_deepseekv3.py` — 1e-5, and 1e-7 for the routing
biases (they move by exactly +-rate a step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from solvingpapers_tpu.configs import registry as jreg
from solvingpapers_tpu.models.deepseekv3 import DeepSeekV3 as JDeepSeekV3
from solvingpapers_tpu.models.deepseekv3 import DeepSeekV3Config as JConfig
from solvingpapers_tpu.models.llama3 import Llama as JLlama
from solvingpapers_tpu.sharding import MeshConfig, create_mesh
from solvingpapers_tpu.train import optim as joptim
from solvingpapers_tpu.train.engine import Trainer as JTrainer
from solvingpapers_tpu.train.objectives import dsv3_init_fn
from solvingpapers_tpu.train.objectives import dsv3_loss_fn as j_dsv3_loss_fn
from solvingpapers_tpu_torch.configs import dense_twin, get_config
from solvingpapers_tpu_torch.convert import flax_to_torch
from solvingpapers_tpu_torch.data import lm_batch_iterator
from solvingpapers_tpu_torch.metrics import MultiWriter
from solvingpapers_tpu_torch.models import DeepSeekV3, DeepSeekV3Config, Llama, LlamaConfig
from solvingpapers_tpu_torch.train import (
    OptimizerConfig,
    TrainConfig,
    Trainer,
    make_optimizer,
)
from solvingpapers_tpu_torch.train.objectives import dsv3_loss_fn
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)


TOL = 1e-5
BIAS_TOL = 1e-7
SEQ, BATCH = 32, 2
CLIP = 0.05
LLAMA_ADAMW = jreg.get_config("llama3_long_smoke").train.optimizer
# llama3_shakespeare's SGD at a constant lr of 1, so its updates stand
# well above the tolerance
SGD = dataclasses.replace(jreg.get_config("llama3_shakespeare").train.optimizer,
                          max_lr=1.0)


# ------------------------------------------------------------- optimizer


def _tree(seed):
    r = np.random.default_rng(seed)
    return {"w": r.standard_normal((6, 5)).astype(np.float32),
            "b": r.standard_normal(5).astype(np.float32)}


@pytest.mark.parametrize("name", ["adamw", "sgd", "adam"])
@pytest.mark.parametrize("k", [2, 3])
def test_optimizer_accumulates_like_multisteps(name, k):
    """2k + 1 calls from the same params and grads: after every call the
    params equal optax.MultiSteps', the returned norm is the call's own
    unclipped one and the lr the schedule at the call count."""
    cfg = OptimizerConfig(name=name, max_lr=1e-1, warmup_steps=2,
                          total_steps=10, grad_clip=CLIP, weight_decay=0.1,
                          accum_steps=k)
    tx, _ = joptim.make_optimizer(joptim.OptimizerConfig(**dataclasses.asdict(cfg)))
    jparams = jax.tree.map(jnp.asarray, _tree(0))
    jstate = tx.init(jparams)
    # optax's update under jit: eagerly, every op of the MultiSteps update
    # compiles on its own (seconds a case)
    update = jax.jit(tx.update)
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in _tree(0).items()}
    opt, schedule = make_optimizer(cfg, params.values())
    for step in range(2 * k + 1):
        grads = _tree(step + 1)
        for n, p in params.items():
            p.grad = torch.from_numpy(grads[n].copy())
        norm, lr = opt.step(step)
        jg = jax.tree.map(jnp.asarray, grads)
        updates, jstate = update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)),
                                   rtol=1e-6)
        assert lr == schedule(step)
        assert opt.updates == (step + 1) // k
        for n, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[n]),
                                       rtol=TOL, atol=1e-7,
                                       err_msg=f"{name} k{k} {n} call {step}")


def test_accumulation_state_round_trips():
    """A state dict taken mid-window carries the partial mean, the call
    and update counts; another accum setting refuses it."""
    cfg = OptimizerConfig(name="sgd", max_lr=0.1, accum_steps=3)
    p = [torch.nn.Parameter(torch.zeros(4))]
    opt, _ = make_optimizer(cfg, p)
    p[0].grad = torch.ones(4)
    opt.step(0)
    state = opt.state_dict()
    q = [torch.nn.Parameter(torch.zeros(4))]
    other, _ = make_optimizer(cfg, q)
    other.load_state_dict(state)
    assert (other.mini_step, other.updates) == (1, 0)
    assert torch.equal(other.acc[0], torch.ones(4))
    plain, _ = make_optimizer(dataclasses.replace(cfg, accum_steps=1), q)
    with pytest.raises(ValueError, match="accum_steps"):
        plain.load_state_dict(state)


# --------------------------------------------------------------- trainer


def _batches(seed, n, vocab=256):
    r = np.random.default_rng(seed)
    return [{"x": r.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
             "y": r.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)}
            for _ in range(n)]


def _copy(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _jax_steps(trainer, state, batches, with_bias=False):
    trainer._build_steps()
    metrics, params, biases = [], [], []
    for b in batches:
        state, m = trainer._train_step(state, b)
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
        params.append(_copy(state.params))
        if with_bias:
            biases.append(_copy(state.model_state["moe_state"]))
    return metrics, params, biases


@pytest.fixture(scope="module",
                params=[("adamw", 2), ("adamw", 3), ("sgd", 2), ("sgd", 3)],
                ids=lambda p: f"{p[0]}-k{p[1]}")
def jax_run(request):
    """The JAX Trainer over 2k + 1 steps of the dense twin of
    `llama3_long_smoke`, cut to one layer, with accum_steps k and a clip
    that fires."""
    name, k = request.param
    base = LLAMA_ADAMW if name == "adamw" else SGD
    optimizer = dataclasses.replace(base, accum_steps=k, grad_clip=CLIP)
    run = jreg.get_config("llama3_long_smoke")
    train = dataclasses.replace(run.train, context_parallel=False,
                                mesh=MeshConfig(data=1), batch_size=BATCH,
                                optimizer=optimizer)
    model = JLlama(dataclasses.replace(run.model, context_parallel=False,
                                       n_layers=1))
    trainer = JTrainer(model, train,
                       mesh=create_mesh(MeshConfig(data=1), jax.devices()[:1]))
    batches = _batches(k, 2 * k + 1)
    state = trainer.init_state(batches[0])
    params0 = _copy(state.params)
    metrics, params, _ = _jax_steps(trainer, state, batches)
    return dict(k=k, optimizer=optimizer, batches=batches, params0=params0,
                metrics=metrics, params=params)


def _check_params(got: dict, ref: dict, what: str, bias_tol=BIAS_TOL):
    assert set(got) == set(ref)
    for name in ref:
        tol = bias_tol if name.endswith("routing_bias") else TOL
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                   rtol=tol, atol=tol, err_msg=f"{name} {what}")


def test_trainer_accumulates_like_the_jax_trainer(jax_run):
    """Every metric of every step and the params after it equal the JAX
    Trainer's: unchanged between updates, moved at each k-th step (the
    first update, at the warmup's lr 0, moves nothing), the last window
    partial."""
    run = dense_twin(get_config("llama3_long_smoke"))
    train = dataclasses.replace(
        run.train, batch_size=BATCH,
        optimizer=OptimizerConfig(**dataclasses.asdict(jax_run["optimizer"])))
    model = dataclasses.replace(run.model, n_layers=1)
    trainer = Trainer(Llama(model, device="cpu", param_dtype=torch.float32),
                      train, device="cpu")
    state = trainer.init_state()
    trainer.model.load_state_dict(flax_to_torch(jax_run["params0"]))
    k = jax_run["k"]
    for i, batch in enumerate(jax_run["batches"]):
        before = {n: t.clone() for n, t in trainer.model.state_dict().items()}
        m = trainer.train_step(state, batch)
        want = jax_run["metrics"][i]
        assert set(m) == set(want)
        for key in want:
            np.testing.assert_allclose(float(m[key]), want[key], rtol=TOL,
                                       atol=TOL, err_msg=f"{key} step {i}")
        got = trainer.model.state_dict()
        _check_params(got, flax_to_torch(jax_run["params"][i]), f"step {i}")
        if (i + 1) % k:  # a call inside a window leaves every param as it was
            assert all(torch.equal(before[n], got[n]) for n in got), f"step {i}"
    assert state.optimizer.updates == 2 and state.optimizer.mini_step == 1


@pytest.fixture(scope="module")
def dsv3_run():
    """The JAX Trainer over 3 steps of the tiny DeepSeek-V3 (random routing
    biases) with dsv3_long's AdamW at accum_steps 2: a micro step that
    only accumulates, one that applies the update, and one after it."""
    cfg = JConfig(vocab_size=256, block_size=64, dim=64, n_layers=2, n_heads=4,
                  latent_dim=8, rope_dim=8, n_experts=4, top_experts=2,
                  dtype="float32", use_flash=True, dropout=0.0,
                  attn_dropout=0.0, pe_scale=0.02)
    run = jreg.get_config("dsv3_long")
    optimizer = dataclasses.replace(run.train.optimizer, accum_steps=2)
    train = dataclasses.replace(run.train, mesh=MeshConfig(data=1),
                                batch_size=BATCH, optimizer=optimizer)
    trainer = JTrainer(JDeepSeekV3(cfg), train, loss_fn=j_dsv3_loss_fn,
                       init_fn=dsv3_init_fn,
                       mesh=create_mesh(MeshConfig(data=1), jax.devices()[:1]))
    batches = _batches(11, 3)
    state = trainer.init_state(batches[0])
    r = np.random.default_rng(7)
    ms0 = jax.tree.map(
        lambda b: np.asarray(r.standard_normal(b.shape) * 0.3, np.float32),
        state.model_state["moe_state"])
    state = state.replace(model_state={"moe_state": ms0})
    params0 = _copy(state.params)
    metrics, params, biases = _jax_steps(trainer, state, batches, True)
    return dict(cfg=cfg, optimizer=optimizer, batches=batches, params0=params0,
                ms0=ms0, metrics=metrics, params=params, biases=biases)


def test_dsv3_routing_biases_move_every_micro_step(dsv3_run):
    run = get_config("dsv3_long")
    train = dataclasses.replace(
        run.train, batch_size=BATCH,
        optimizer=OptimizerConfig(**dataclasses.asdict(dsv3_run["optimizer"])))
    cfg = DeepSeekV3Config(**dataclasses.asdict(dsv3_run["cfg"]))
    model = DeepSeekV3(cfg, device="cpu", param_dtype=torch.float32)
    trainer = Trainer(model, train, loss_fn=dsv3_loss_fn, device="cpu")
    state = trainer.init_state()
    model.load_state_dict(flax_to_torch(dsv3_run["params0"],
                                        {"moe_state": dsv3_run["ms0"]}))
    biases = [layer.moe.routing_bias.clone() for layer in model.layers]
    for i, batch in enumerate(dsv3_run["batches"]):
        m = trainer.train_step(state, batch)
        for key in ("train_loss", "grad_norm", "lr", "train_moe_bias_norm"):
            np.testing.assert_allclose(float(m[key]), dsv3_run["metrics"][i][key],
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{key} step {i}")
        _check_params(model.state_dict(),
                      flax_to_torch(dsv3_run["params"][i],
                                    {"moe_state": dsv3_run["biases"][i]}),
                      f"step {i}")
        for j, layer in enumerate(model.layers):
            new = layer.moe.routing_bias
            assert not torch.equal(new, biases[j]), \
                f"layer {j}'s bias held still at step {i}"
            biases[j] = new.clone()


def _tiny_trainer(tmp_path=None, **train_kw):
    cfg = LlamaConfig(vocab_size=64, max_seq_len=32, dim=32, n_layers=1,
                      n_heads=2, n_kv_heads=1, use_flash=True)
    optimizer = OptimizerConfig(max_lr=1e-2, warmup_steps=2, total_steps=12,
                                accum_steps=train_kw.pop("accum_steps", 1))
    train = TrainConfig(**{"batch_size": 4, "log_every": 2, "eval_every": 0,
                           "optimizer": optimizer, **train_kw})
    return Trainer(Llama(cfg, device="cpu", param_dtype=torch.float32), train,
                   device="cpu")


def _take(it, n):
    return [next(it) for _ in range(n)]


def test_checkpoint_inside_a_window_resumes_it_exactly(tmp_path):
    """accum_steps 3, a checkpoint at step 4 (one call into the second
    window): a fresh trainer resumed from it to step 7 equals an
    unbroken 7-step run."""
    batches = _take(lm_batch_iterator(np.arange(3000) % 61, 4, 16, seed=2), 7)
    ckpt = dict(checkpoint_dir=str(tmp_path / "ck"), ckpt_every=4)
    _tiny_trainer(steps=4, accum_steps=3, **ckpt).fit(iter(batches[:4]),
                                                      writer=MultiWriter())
    resumed = _tiny_trainer(steps=7, accum_steps=3, seed=5, **ckpt)
    state = resumed.fit(iter(batches[4:]), writer=MultiWriter())
    assert state.step == 7 and state.optimizer.updates == 2
    unbroken = _tiny_trainer(steps=7, accum_steps=3)
    unbroken.fit(iter(batches), writer=MultiWriter())
    for (n, a), b in zip(resumed.model.state_dict().items(),
                         unbroken.model.state_dict().values()):
        assert torch.equal(a, b), n


def test_fit_calls_its_callbacks_at_their_cadence():
    batches = lm_batch_iterator(np.arange(3000) % 61, 4, 16, seed=3)
    calls = []
    trainer = _tiny_trainer(steps=7)
    state = trainer.fit(batches, writer=MultiWriter(), callbacks=[
        (3, lambda st, step: calls.append(("a", step, st.step))),
        (2, lambda st, step: calls.append(("b", step, st.step))),
        (0, lambda st, step: calls.append(("never", step)))])
    assert calls == [("b", 2, 2), ("a", 3, 3), ("b", 4, 4), ("a", 6, 6),
                     ("b", 6, 6)]
    assert state.step == 7
    windowed = _tiny_trainer(steps=4, scan_steps=2)
    with pytest.raises(ValueError, match=r"callbacks\[0\].every=3"):
        windowed.fit(batches, writer=MultiWriter(),
                     callbacks=[(3, lambda st, step: None)])
