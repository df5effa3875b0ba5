"""The port's DeepSeek-V3 (MLA + MoE) vs the JAX package's, on the same
weights, and the port's own dropout and remat contracts.

A tiny model (dim 64, 2 layers, 4 heads, latent 8, decoupled RoPE 8, 4
experts top-2 with a shared expert, vocab 256, float32, dropout 0) is
initialised in JAX, given random routing biases (so the bias steers
routing), and carried across with `convert.flax_to_torch`. Both sides
run the same numpy-made tokens:

* MLA alone, with `use_flash` on (the JAX Pallas kernel in interpret
  mode, the port's plain flash versions) and off, outputs and grads;
* the MoE layer in training mode, for both `moe_impl` values and a
  capacity that drops pairs: output, new routing bias and stats;
* whole-model logits at eval;
* 1- and 3-step `Trainer` runs against the JAX `Trainer` on a
  single-device mesh (`dsv3_loss_fn`, `dsv3_init_fn`), SGD and AdamW,
  both `moe_impl` values: train metrics (`moe_*` included), every
  updated param and the routing bias after each step; `evaluate`;
* the balance-loss term.

Tolerances: float32 everywhere, 1e-5 (relative and absolute; summation
orders differ in the attention and the expert products); the routing
bias moves by exactly +-rate a step, so it is compared at 1e-7.

At dropout > 0 nothing can be compared with JAX (its masks come from
its own generator), so the port is held to itself: flash and dense MLA
apply one mask at one seed, the dense MLA's one-pass probability
dropout equals its old two-pass form bit for bit, remat recomputes the
same masks (equal grads) and the routing bias is updated once a step.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu.configs import registry as jreg
from solvingpapers_tpu.metrics.mfu import active_param_count as j_active
from solvingpapers_tpu.models.deepseekv3 import MLA as JMLA
from solvingpapers_tpu.models.deepseekv3 import DeepSeekV3 as JDeepSeekV3
from solvingpapers_tpu.models.deepseekv3 import DeepSeekV3Config as JConfig
from solvingpapers_tpu.models.deepseekv3 import MoELayer as JMoELayer
from solvingpapers_tpu.sharding import MeshConfig, create_mesh
from solvingpapers_tpu.train.engine import Trainer as JTrainer
from solvingpapers_tpu.train.objectives import dsv3_init_fn
from solvingpapers_tpu.train.objectives import dsv3_loss_fn as j_dsv3_loss_fn
from solvingpapers_tpu_torch.configs import factory, get_config
from solvingpapers_tpu_torch.convert import flax_to_torch
from solvingpapers_tpu_torch.metrics import active_param_count
from solvingpapers_tpu_torch.models import DeepSeekV3, DeepSeekV3Config
from solvingpapers_tpu_torch.models import deepseekv3 as tds
from solvingpapers_tpu_torch.train import OptimizerConfig, TrainConfig, Trainer
from solvingpapers_tpu_torch.train.objectives import dsv3_loss_fn

TOL = 1e-5
BIAS_TOL = 1e-7
SEQ, BATCH, STEPS = 32, 2, 3
TINY = dict(vocab_size=256, block_size=64, dim=64, n_layers=2, n_heads=4,
            latent_dim=8, rope_dim=8, n_experts=4, top_experts=2,
            dtype="float32", use_flash=True, dropout=0.0, attn_dropout=0.0,
            pe_scale=0.02)
SGD = jreg.get_config("llama3_shakespeare").train.optimizer
ADAMW = jreg.get_config("dsv3_long").train.optimizer


def _close(t, j, tol=TOL, msg=""):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol,
                               err_msg=msg)


def _tokens(seed, b=BATCH, s=SEQ):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, s))


def _random_bias(moe_state, seed):
    """The moe_state with every routing bias replaced by N(0, 0.3) values
    (numpy seed), so the bias changes which experts are picked."""
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda b: np.asarray(r.standard_normal(b.shape) * 0.3, np.float32),
        moe_state)


def _jax_model(**kw):
    cfg = JConfig(**{**TINY, **kw})
    model = JDeepSeekV3(cfg)
    variables = model.init({"params": jax.random.key(0)},
                           jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    moe_state = _random_bias(variables["moe_state"], 1)
    return cfg, model, params, moe_state


def _port_model(params, moe_state, **kw):
    model = DeepSeekV3(DeepSeekV3Config(**{**TINY, **kw}), device="cpu",
                       param_dtype=torch.float32)
    model.load_state_dict(flax_to_torch(params, {"moe_state": moe_state}))
    return model


@pytest.fixture(scope="module")
def weights():
    _, _, params, moe_state = _jax_model()
    return params, moe_state


def test_convert_covers_every_parameter_and_bias(weights):
    params, moe_state = weights
    sd = flax_to_torch(params, {"moe_state": moe_state})
    model = DeepSeekV3(DeepSeekV3Config(**TINY), device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    np.testing.assert_array_equal(
        sd["layers.1.moe.routing_bias"].numpy(),
        moe_state["layer_1"]["moe"]["routing_bias"])
    # einsum weights keep their Flax layouts; Dense kernels are transposed
    np.testing.assert_array_equal(sd["layers.0.mla.w_q"].numpy(),
                                  params["layer_0"]["mla"]["w_q"])
    np.testing.assert_array_equal(sd["layers.0.moe.gate.weight"].numpy(),
                                  params["layer_0"]["moe"]["gate"]["kernel"].T)


# --------------------------------------------------------------------- MLA


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "dense"])
@pytest.mark.parametrize("rope_dim", [8, 0], ids=["rope", "norope"])
def test_mla_matches_reference(use_flash, rope_dim):
    """MLA's output and its grads (input and every weight) equal the
    reference's; under use_flash both run their flash kernels' CPU forms
    (absorbed-query MLA as MQA over cat(latent, k_rope), head dim L + R)."""
    cfg, _, params, moe_state = _jax_model(use_flash=use_flash,
                                           rope_dim=rope_dim)
    p = params["layer_0"]["mla"]
    x = np.random.default_rng(2).standard_normal((BATCH, SEQ, 64)).astype(np.float32)
    cot = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ), (BATCH, SEQ))

    def jloss(pp, xx):
        out, _ = JMLA(cfg).apply({"params": pp}, xx, jnp.asarray(pos))
        return jnp.sum(out * cot), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(p, jnp.asarray(x))
    model = _port_model(params, moe_state, use_flash=use_flash,
                        rope_dim=rope_dim)
    mla = model.layers[0].mla
    xt = torch.from_numpy(x).requires_grad_()
    out = mla(xt, torch.from_numpy(pos.copy()), None, True)
    _close(out, jout)
    names = [n for n, _ in mla.named_parameters()]
    grads = torch.autograd.grad(out, [xt, *mla.parameters()],
                                torch.from_numpy(cot))
    _close(grads[0], jgx, msg="dx")
    for name, g in zip(names, grads[1:]):
        # "w_q" is a raw einsum weight; "w_dkv.weight" a transposed kernel
        mod, _, attr = name.rpartition(".")
        want = np.asarray(jgp[mod]["kernel"]).T if mod else np.asarray(jgp[attr])
        _close(g, want, msg=name)
    assert len(names) == (7 if rope_dim else 5)


# --------------------------------------------------------------------- MoE


@pytest.mark.parametrize("moe_impl,cf", [("dispatch", 2.0), ("dispatch", 0.5),
                                         ("dense", 2.0)],
                         ids=["dispatch", "dispatch-drops", "dense"])
def test_moe_layer_matches_reference(moe_impl, cf):
    """The MoE layer in training mode: output, the new routing bias and
    every sown stat equal the reference's (the port returns the new bias
    for the trainer to install; its buffer is left as it was)."""
    cfg, _, params, moe_state = _jax_model(moe_impl=moe_impl, capacity_factor=cf)
    x = np.random.default_rng(4).standard_normal((BATCH, SEQ, 64)).astype(np.float32)
    jout, mutated = JMoELayer(cfg).apply(
        {"params": params["layer_0"]["moe"],
         "moe_state": moe_state["layer_0"]["moe"]},
        jnp.asarray(x), deterministic=False,
        mutable=["moe_state", "moe_metrics"], rngs={"dropout": jax.random.key(0)})
    jstats = mutated["moe_metrics"]["stats"][0]
    model = _port_model(params, moe_state, moe_impl=moe_impl, capacity_factor=cf)
    moe = model.layers[0].moe
    before = moe.routing_bias.clone()
    out, stats = moe(torch.from_numpy(x), deterministic=False)
    _close(out, jout)
    assert torch.equal(moe.routing_bias, before)
    _close(stats["new_bias"], mutated["moe_state"]["routing_bias"], BIAS_TOL)
    for key in ("load_entropy", "load_max_fraction", "drop_fraction",
                "bias_norm", "ci"):
        _close(stats[key], jstats[key], msg=key)
    if cf == 0.5:
        assert stats["drop_fraction"].item() > 0.0
    assert moe(torch.from_numpy(x), deterministic=True)[1] is None


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("use_flash,moe_impl,rope_dim", [
    (True, "dispatch", 8), (False, "dispatch", 8), (True, "dense", 0)])
def test_eval_logits_match_reference(use_flash, moe_impl, rope_dim):
    kw = dict(use_flash=use_flash, moe_impl=moe_impl, rope_dim=rope_dim)
    _, jm, params, moe_state = _jax_model(**kw)
    toks = _tokens(5)
    jlogits, _ = jm.apply({"params": params, "moe_state": moe_state},
                          jnp.asarray(toks))
    model = _port_model(params, moe_state, **kw).eval()
    logits, caches = model(torch.from_numpy(toks))
    assert caches is None and logits.shape == (BATCH, SEQ, 256)
    _close(logits, jlogits)


def test_balance_loss_matches_reference():
    """With balance_loss_weight > 0 the loss adds weight times the mean
    per-layer balance loss, and its gradient reaches the gate."""
    kw = dict(balance_loss_weight=0.01)
    cfg, jm, params, moe_state = _jax_model(**kw)
    toks = _tokens(6)
    batch = {"x": toks[:, :-1], "y": toks[:, 1:]}

    def jloss(p):
        loss, aux, _ = j_dsv3_loss_fn(jm, p, batch, jax.random.key(0),
                                      {"moe_state": moe_state}, True)
        return loss, aux

    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    model = _port_model(params, moe_state, **kw).train()
    loss, aux, new_state = dsv3_loss_fn(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, 123)
    _close(loss, jl)
    _close(aux["balance_loss"], jaux["balance_loss"])
    loss.backward()
    _close(model.layers[1].moe.gate.weight.grad,
           np.asarray(jg["layer_1"]["moe"]["gate"]["kernel"]).T)
    assert set(new_state) == {f"layers.{i}.moe.routing_bias" for i in range(2)}


# ----------------------------------------------------------------- trainer


def _batches(seed, n):
    r = np.random.default_rng(seed)
    return [{"x": r.integers(0, 256, (BATCH, SEQ)).astype(np.int32),
             "y": r.integers(0, 256, (BATCH, SEQ)).astype(np.int32)}
            for _ in range(n)]


def _copy(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module", params=[("sgd", "dispatch"), ("sgd", "dense"),
                                        ("adamw", "dispatch")],
                ids=lambda p: "-".join(p))
def jax_run(request):
    """The JAX Trainer's run of the tiny model (dsv3_long's train
    settings, single-device mesh): initial params and routing state,
    per-step metrics, params and routing biases, an evaluation."""
    opt_name, moe_impl = request.param
    optimizer = ADAMW if opt_name == "adamw" else SGD
    cfg = JConfig(**{**TINY, "moe_impl": moe_impl})
    run = jreg.get_config("dsv3_long")
    train = dataclasses.replace(run.train, mesh=MeshConfig(data=1),
                                batch_size=BATCH, optimizer=optimizer)
    trainer = JTrainer(JDeepSeekV3(cfg), train, loss_fn=j_dsv3_loss_fn,
                       init_fn=dsv3_init_fn,
                       mesh=create_mesh(MeshConfig(data=1), jax.devices()[:1]))
    batches = _batches(0, STEPS + 2)
    state = trainer.init_state(batches[0])
    state = state.replace(model_state={
        "moe_state": _random_bias(state.model_state["moe_state"], 7)})
    params0, ms0 = _copy(state.params), _copy(state.model_state["moe_state"])
    trainer._build_steps()
    metrics, params, biases = [], [], []
    for b in batches[:STEPS]:
        state, m = trainer._train_step(state, b)
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
        params.append(_copy(state.params))
        biases.append(_copy(state.model_state["moe_state"]))
    val = trainer.evaluate(state, iter(batches[STEPS:]))
    return dict(optimizer=optimizer, moe_impl=moe_impl, batches=batches,
                params0=params0, ms0=ms0, metrics=metrics, params=params,
                biases=biases, val=val)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_trainer_steps_match_jax_trainer(jax_run, n_steps):
    """Loss, grad norm, lr, perplexity and the moe_* metrics of every step,
    the updated params and the routing biases after it, equal the JAX
    Trainer's; the bias moves once a step, after the optimizer step."""
    run = get_config("dsv3_long")
    train = dataclasses.replace(
        run.train, batch_size=BATCH,
        optimizer=OptimizerConfig(**dataclasses.asdict(jax_run["optimizer"])))
    model = DeepSeekV3(DeepSeekV3Config(**{**TINY, "moe_impl": jax_run["moe_impl"]}),
                       device="cpu", param_dtype=torch.float32)
    trainer = Trainer(model, train, loss_fn=dsv3_loss_fn, device="cpu")
    state = trainer.init_state()
    model.load_state_dict(flax_to_torch(jax_run["params0"],
                                        {"moe_state": jax_run["ms0"]}))
    for i in range(n_steps):
        m = trainer.train_step(state, jax_run["batches"][i])
        want = jax_run["metrics"][i]
        assert set(m) == set(want)
        for key in want:
            np.testing.assert_allclose(float(m[key]), want[key], rtol=TOL,
                                       atol=TOL, err_msg=f"{key} step {i}")
        ref = flax_to_torch(jax_run["params"][i],
                            {"moe_state": jax_run["biases"][i]})
        got = model.state_dict()
        assert set(got) == set(ref)
        for k in ref:
            tol = BIAS_TOL if k.endswith("routing_bias") else TOL
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=tol,
                                       atol=tol, err_msg=f"{k} step {i}")
    assert state.step == n_steps
    if n_steps == STEPS:
        val = trainer.evaluate(state, iter(jax_run["batches"][STEPS:]))
        assert set(val) == set(jax_run["val"])
        for k, v in val.items():
            np.testing.assert_allclose(v, jax_run["val"][k], rtol=TOL)


# ------------------------------------------------- dropout, inside the port


def _dropout_model(weights, **kw):
    params, moe_state = weights
    return _port_model(params, moe_state,
                       **{"dropout": 0.1, "attn_dropout": 0.1, **kw}).train()


def _loss_and_grads(model, toks, seed):
    loss, _, new_state = dsv3_loss_fn(
        model, {"x": torch.from_numpy(toks[:, :-1]),
                "y": torch.from_numpy(toks[:, 1:])}, seed)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), grads, new_state


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "dense"])
def test_remat_recomputes_the_same_masks(weights, use_flash):
    """At dropout > 0, remat on and off give equal loss, grads and new
    routing biases at one seed: the recomputed layers redraw the forward's
    masks (seeds are arguments, not generator state) and route with the
    bias the forward used."""
    toks = _tokens(8, s=SEQ + 1)
    runs = [_loss_and_grads(_dropout_model(weights, remat=r, use_flash=use_flash),
                            toks, 77) for r in (False, True)]
    (l0, g0, s0), (l1, g1, s1) = runs
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    for k in s0:
        assert torch.equal(s0[k], s1[k])
    # the dropout is live: another seed gives another loss
    assert _loss_and_grads(_dropout_model(weights), toks, 78)[0] != l0


def test_flash_and_dense_mla_apply_one_mask(weights):
    """use_flash on and off compute the same function at the same seed:
    the flash versions and the dense MLA draw the same keep mask."""
    toks = _tokens(9, s=SEQ + 1)
    lf, gf, _ = _loss_and_grads(_dropout_model(weights, use_flash=True), toks, 5)
    ld, gd, _ = _loss_and_grads(_dropout_model(weights, use_flash=False), toks, 5)
    _close(lf, ld.numpy())
    for a, b in zip(gf, gd):
        _close(a, b.numpy())


def test_dense_mla_dropout_equals_the_old_two_pass_form(weights, monkeypatch):
    """The dense MLA's probability dropout, one pass of `dropout`, gives
    the loss and grads of its old form (the keep mask drawn whole, then
    ``probs * keep / (1 - rate)``) bit for bit."""
    toks = _tokens(10, s=SEQ + 1)
    new_loss, new_grads, _ = _loss_and_grads(
        _dropout_model(weights, use_flash=False), toks, 5)
    tdr = importlib.import_module("solvingpapers_tpu_torch.kernels.dropout")

    def old_form(x, rate, seed):
        if x.dim() != 4:  # the residual dropouts stay as they are
            return tdr.dropout(x, rate, seed)
        b, n, s, t = x.shape
        keep = tdr.dropout_keep_reference(seed, rate, b * n, s, t).view(x.shape)
        return x * keep / (1.0 - rate)

    monkeypatch.setattr(tds, "dropout", old_form)
    old_loss, old_grads, _ = _loss_and_grads(
        _dropout_model(weights, use_flash=False), toks, 5)
    assert torch.equal(new_loss, old_loss)
    for a, b in zip(new_grads, old_grads):
        assert torch.equal(a, b)


def test_trainer_updates_the_bias_once_a_step_under_remat(weights):
    """One remat'd train step from a zero bias moves every bias element by
    exactly 0 or +-rate (updated once, not per recomputation), equal to
    the step without remat; eval mode neither needs a seed nor drops."""
    params, moe_state = weights
    zero = jax.tree.map(np.zeros_like, moe_state)
    out = []
    for remat in (False, True):
        model = _port_model(params, zero, dropout=0.1, attn_dropout=0.1,
                            remat=remat)
        trainer = Trainer(model, TrainConfig(
            batch_size=BATCH, optimizer=OptimizerConfig(**dataclasses.asdict(SGD))),
            loss_fn=dsv3_loss_fn, device="cpu")
        state = trainer.init_state()
        model.load_state_dict(flax_to_torch(params, {"moe_state": zero}))
        m = trainer.train_step(state, _batches(3, 1)[0])
        out.append(({k: v.clone() for k, v in model.state_dict().items()},
                    float(m["train_loss"])))
    (sd0, l0), (sd1, l1) = out
    assert l0 == l1
    rate = DeepSeekV3Config().aux_free_bias_update_rate
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
        if k.endswith("routing_bias"):
            levels = torch.tensor([-rate, 0.0, rate])
            assert torch.isin(sd1[k], levels).all() and sd1[k].abs().sum() > 0
    toks = torch.from_numpy(_tokens(10))
    model.eval()
    assert torch.equal(model(toks)[0], model(toks)[0])


def test_training_forward_needs_a_seed_when_dropout_is_on(weights):
    model = _dropout_model(weights)
    toks = torch.from_numpy(_tokens(11))
    with pytest.raises(ValueError, match="dropout_seed"):
        model(toks)
    a = model(toks, dropout_seed=1)[0]
    assert torch.equal(a, model(toks, dropout_seed=1)[0])
    assert not torch.equal(a, model.eval()(toks)[0])


# ------------------------------------------------- config, init, refusals


def test_dsv3_long_matches_the_reference_registry():
    got, want = get_config("dsv3_long"), jreg.get_config("dsv3_long")
    assert got.model_family == want.model_family == "deepseekv3"
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)
    assert got.model.use_flash and got.model.remat
    assert (got.model.attn_dropout, got.model.dropout) == (0.1, 0.1)
    assert dataclasses.asdict(got.train.optimizer) == dataclasses.asdict(
        want.train.optimizer)
    for f in ("steps", "batch_size", "log_every", "eval_every", "eval_batches",
              "ckpt_every", "tokens_per_step"):
        assert getattr(got.train, f) == getattr(want.train, f), f
    assert got.data == want.data
    assert factory.loss_fn_for(got) is dsv3_loss_fn


def test_factory_builds_the_model_and_init_dispatches_on_the_family():
    run = dataclasses.replace(get_config("dsv3_long"),
                              model=DeepSeekV3Config(**TINY))
    model = factory.build_model(run, device="cpu", param_dtype=torch.float32)
    assert isinstance(model, DeepSeekV3)
    state = Trainer(model, TrainConfig(), loss_fn=dsv3_loss_fn,
                    device="cpu").init_state()
    sd = state.model.state_dict()
    assert all(not v.any() for k, v in sd.items() if k.endswith("routing_bias"))
    # Flax's initializers: normal(0.02) einsum weights, lecun-normal Dense
    assert abs(sd["layers.0.moe.w1"].std().item() - 0.02) < 2e-3
    assert abs(sd["tok_emb.weight"].std().item() - 0.02) < 1e-3
    lecun = (1 / 64) ** 0.5
    assert abs(sd["layers.0.mla.w_dkv.weight"].std().item() - lecun) < 0.25 * lecun
    assert set(sd) == set(tds.init_params(model.cfg, torch.Generator()))


def test_active_param_count_matches_reference(weights):
    params, _ = weights
    model = DeepSeekV3(DeepSeekV3Config(**TINY), device="cpu")
    sd = flax_to_torch(params)
    for k, e in ((None, None), (2, 4)):
        want = j_active(params, k, e)
        assert active_param_count(model, k, e) == want
        assert active_param_count(sd, k, e) == want
    assert active_param_count(model, 2, 4) < active_param_count(model)


@pytest.mark.parametrize("kw,match", [
    (dict(mtp_heads=1), "multi-token"), (dict(noisy_topk=True), "noisy"),
    (dict(context_parallel=True), "parallelism"),
    (dict(ep_impl="all_to_all"), "parallelism")])
def test_unported_options_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        DeepSeekV3(DeepSeekV3Config(**{**TINY, **kw}), device="cpu")


def test_caches_raise(weights):
    model = _port_model(*weights).eval()
    with pytest.raises(NotImplementedError, match="latent cache"):
        model(torch.zeros(1, 4, dtype=torch.long), caches=[None, None])
