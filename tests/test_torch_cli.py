"""The port's command line (`solvingpapers_tpu_torch.cli`) on the CPU,
and the registry it reads.

* `get_config(name, **overrides)` equals the JAX package's field for
  field (an overridden `steps` moves the schedule's horizon with it);
  `dsv3_tinystories` is registered as the reference registers it;
* `list` prints the port's registry;
* the chain `train -> eval -> sample -> export` with ``--device cpu``
  at `gpt_tiny` and at a small DeepSeek-V3 config this file registers
  (dropout on, so sampling during training runs the model in eval
  mode), 2 steps: `train` writes its JSONL rows, a checkpoint and a
  text sample; `eval` prints the reference's JSON keys; `sample
  --greedy` prints what `generate` gives on the restored weights;
  `export` writes the checkpoint's model state, read back by
  `load_params`;
* refused commands and configs exit 2 and name their ROADMAP items;
  the default device raises without a card;
* `serve --replicas 2 --journal` serves a fleet behind one port (both
  replicas answer, a journal each, the merged /metrics, the fleet
  /statusz, the stitched trace for `trace-summary --fleet`), and `replay`
  exits 0 on a journal of the same weights, 2 through its divergence gate
  on a copy with one committed token changed, and 2 naming A5 for a
  quantized candidate.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from solvingpapers_tpu import cli as jcli
from solvingpapers_tpu.configs import registry as jreg
from solvingpapers_tpu_torch import cli
from solvingpapers_tpu_torch.checkpoint import CheckpointManager, load_params
from solvingpapers_tpu_torch.configs import factory, get_config, list_configs
from solvingpapers_tpu_torch.configs import registry
from solvingpapers_tpu_torch.infer import generate
from solvingpapers_tpu_torch.models import DeepSeekV3Config
from solvingpapers_tpu_torch.train import OptimizerConfig, TrainConfig
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)


DSV3_CLI = "dsv3_cli_tiny"


@pytest.fixture(autouse=True)
def _small_dsv3(monkeypatch):
    """A DeepSeek-V3 run small enough for the CPU: dim 64, 2 layers,
    latent 8, RoPE 8, 4 experts top-2, dropout 0.1, on the char corpus."""

    def run():
        return registry.RunConfig(
            name=DSV3_CLI, model_family="deepseekv3",
            model=DeepSeekV3Config(block_size=64, dim=64, n_layers=2,
                                   n_heads=4, latent_dim=8, rope_dim=8,
                                   n_experts=4, top_experts=2, pe_scale=0.02,
                                   balance_loss_weight=1e-2),
            train=TrainConfig(steps=10, batch_size=4, log_every=1,
                              eval_every=5, eval_batches=2,
                              optimizer=OptimizerConfig(max_lr=1e-3,
                                                        warmup_steps=2,
                                                        total_steps=10),
                              tokens_per_step=4 * 64),
            data={"kind": "char", "path": None, "block_size": 64})

    monkeypatch.setitem(registry._REGISTRY, DSV3_CLI, run)


# ---------------------------------------------------------------- registry


def _common_train(port, ref) -> dict:
    """The train fields both packages' TrainConfig have, side by side."""
    names = ({f.name for f in dataclasses.fields(port)}
             & {f.name for f in dataclasses.fields(ref)}) - {"optimizer", "mesh"}
    return {n: (getattr(port, n), getattr(ref, n)) for n in sorted(names)}


@pytest.mark.parametrize("name", ["gpt_tiny", "gpt_shakespeare",
                                  "dsv3_tinystories", "dsv3_long"])
@pytest.mark.parametrize("overrides", [
    {}, {"steps": 7}, {"steps": 30, "checkpoint_dir": "ck", "ckpt_every": 5},
    {"batch_size": 3, "notes": "x"}], ids=["none", "steps", "ckpt", "rest"])
def test_get_config_overrides_match_the_reference(name, overrides):
    got, want = get_config(name, **overrides), jreg.get_config(name, **overrides)
    for field, (a, b) in _common_train(got.train, want.train).items():
        assert a == b, field
    assert dataclasses.asdict(got.train.optimizer) == dataclasses.asdict(
        want.train.optimizer)
    assert (got.name, got.model_family, got.data, got.notes) == (
        want.name, want.model_family, want.data, want.notes)
    if "steps" in overrides:
        assert got.train.optimizer.total_steps == overrides["steps"]


def test_dsv3_tinystories_matches_the_reference_registry():
    got, want = get_config("dsv3_tinystories"), jreg.get_config("dsv3_tinystories")
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)
    assert (got.model.capacity_factor, got.model.balance_loss_weight,
            got.model.pe_scale) == (4.0, 1e-2, 0.02)
    assert got.train.batch_size * got.data["block_size"] == 16 * 256
    assert factory.loss_fn_for(got).__name__ == "dsv3_loss_fn"


# ---------------------------------------------------------------- commands


def _run(capsys, *argv) -> tuple[int, str, str]:
    rc = cli.main(list(argv))
    out, err = capsys.readouterr()
    return rc, out, err


def test_list_prints_the_registry(capsys):
    rc, out, _ = _run(capsys, "list")
    assert rc == 0
    assert out.split() == list_configs()
    assert {"gpt_tiny", "gpt_shakespeare", "dsv3_tinystories"} <= set(out.split())


@pytest.mark.parametrize("config", ["gpt_tiny", DSV3_CLI])
def test_train_eval_sample_export_chain(capsys, tmp_path, config):
    ck, jsonl, art = tmp_path / "ck", tmp_path / "m.jsonl", tmp_path / "art"
    common = ["--config", config, "--device", "cpu"]
    rc, out, _ = _run(capsys, "train", *common, "--steps", "2",
                      "--checkpoint-dir", str(ck), "--jsonl", str(jsonl),
                      "--artifacts-dir", str(art))
    assert rc == 0
    rows = [json.loads(line) for line in open(jsonl)]
    assert [r["step"] for r in rows if "train_loss" in r][-1] == 2
    assert all(np.isfinite(r["train_loss"]) for r in rows if "train_loss" in r)
    assert CheckpointManager(str(ck)).all_steps() == [2]
    assert os.listdir(art) == ["generated_2.txt"]
    assert f"[sample] wrote {art}/generated_2.txt" in out
    assert len(open(art / "generated_2.txt").read()) > 1

    rc, out, _ = _run(capsys, "eval", *common, "--checkpoint-dir", str(ck))
    assert rc == 0
    metrics = json.loads(out.strip().splitlines()[-1])
    assert set(metrics) == {"val_loss", "val_perplexity"}
    assert np.isclose(metrics["val_perplexity"], np.exp(metrics["val_loss"]),
                      rtol=0.2)

    rc, out, _ = _run(capsys, "sample", *common, "--checkpoint-dir", str(ck),
                      "--greedy", "--max-new-tokens", "12", "--prompt", "The ")
    assert rc == 0
    cfg, model, tok, _, _ = factory.build_char_lm_run(
        get_config(config), device="cpu", param_dtype=None)
    state = torch.load(ck / "step_2.pt", weights_only=True)
    model.load_state_dict(state["model"])
    want = generate(model.eval(), torch.from_numpy(tok.encode("The "))[None].long(),
                    max_new_tokens=12, device="cpu")
    assert out.rstrip("\n") == tok.decode(want[0].tolist())

    weights = tmp_path / "w.pt"
    rc, out, _ = _run(capsys, "export", *common, "--checkpoint-dir", str(ck),
                      "--out", str(weights))
    assert rc == 0 and f"exported params to {weights}" in out
    exported = load_params(str(weights))
    assert set(exported) == set(state["model"])
    for name, t in state["model"].items():
        assert torch.equal(exported[name], t), name
    if config == DSV3_CLI:
        assert "layers.0.moe.routing_bias" in exported


def test_eval_prints_the_reference_keys(capsys):
    rc = jcli.main(["eval", "--config", "gpt_tiny"])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    rc, out, _ = _run(capsys, "eval", "--config", "gpt_tiny", "--device", "cpu")
    assert rc == 0 and set(json.loads(out.strip())) == set(ref)


def test_missing_checkpoints_and_export_without_one(capsys, tmp_path):
    nowhere = str(tmp_path / "none")
    for cmd in ("eval", "sample", "export"):
        extra = {"eval": [], "sample": ["--max-new-tokens", "8"],
                 "export": ["--out", str(tmp_path / "w.pt")]}[cmd]
        rc, _, err = _run(capsys, cmd, "--config", "gpt_tiny", "--device", "cpu",
                          "--checkpoint-dir", nowhere, *extra)
        assert rc == 1 and "no checkpoint found" in err
    assert not os.path.exists(nowhere)
    rc, _, err = _run(capsys, "export", "--config", "gpt_tiny", "--device",
                      "cpu", "--out", str(tmp_path / "w.pt"))
    assert rc == 2 and "requires --checkpoint-dir" in err


@pytest.mark.parametrize("argv,item", [
    (["replay", "--config", "gpt_tiny", "--journal", "j.jsonl",
      "--kv-quant", "int8"], "A5"),
    (["replay", "--config", "gpt_tiny", "--journal", "j.jsonl",
      "--speculative", "ngram"], "A5"),
    (["replay", "--config", "gpt_tiny", "--journal", "j.jsonl",
      "--kv-exact-lanes=2"], "A5"),
    (["serve", "--config", "gpt_tiny", "--speculative", "ngram"], "A5"),
    (["serve-bench", "--config", "gpt_tiny", "--spec-k", "4"], "A5"),
    (["serve-bench", "--config", "gpt_tiny", "--quant-train-steps", "3"], "A5"),
    (["serve-bench", "--config", "gpt_tiny", "--obs-hlo-dir", "d"], "A8"),
    (["serve-bench", "--config", "gpt_tiny", "--obs"], "A8"),
    (["kernel-bench"], "A5"),
    (["sample", "--config", "gpt_tiny", "--device", "cpu", "--speculative",
      "--greedy"], "A5"),
    (["train", "--config", "vit_mnist", "--device", "cpu"], "A6"),
    (["serve", "--config", "gpt_tiny", "--kv-quant=int8"], "A5"),
])
def test_refused_commands_exit_2_naming_their_roadmap_item(capsys, argv, item):
    rc, out, err = _run(capsys, *argv)
    assert rc == 2 and not out
    assert f"ROADMAP {item}" in err


def test_serve_flags_set_the_front_door_knobs():
    """`cli serve`'s front-door flags reach the ServeConfig; left out,
    each takes ServeConfig's default."""
    from solvingpapers_tpu_torch.serve import ServeConfig

    model = types.SimpleNamespace(max_positions=128)
    args = cli.build_parser().parse_args([
        "serve", "--config", "gpt_tiny", "--port", "0", "--host", "0.0.0.0",
        "--max-connections", "3", "--drain-timeout", "0.5", "--no-json-mode",
        "--max-waiting", "7"])
    got = cli._serve_config(args, model)
    assert (got.api_port, got.api_host, got.api_max_connections,
            got.drain_timeout_s, got.json_mode, got.max_waiting) == (
        0, "0.0.0.0", 3, 0.5, False, 7)
    got = cli._serve_config(
        cli.build_parser().parse_args(["serve", "--config", "gpt_tiny"]), model)
    for name in ("api_host", "api_max_connections", "drain_timeout_s",
                 "json_mode", "max_waiting"):
        assert getattr(got, name) == getattr(ServeConfig(), name), name


def test_serve_durability_flags_set_their_knobs():
    """`cli serve`'s flags of the durability and observability planes
    reach the ServeConfig; serve-bench and trace-summary take theirs."""
    from solvingpapers_tpu_torch.serve.slo import DEFAULT_SLO_TARGETS

    model = types.SimpleNamespace(max_positions=128)
    args = cli.build_parser().parse_args([
        "serve", "--config", "gpt_tiny", "--trace", "--trace-out", "t.json",
        "--slo", "--degrade", "--step-deadline", "2.5", "--journal", "j.jsonl",
        "--journal-strict", "--timeseries-interval", "0.5",
        "--timeseries-capacity", "7"])
    got = cli._serve_config(args, model)
    assert (got.trace, got.slo_targets, got.degrade, got.fault_step_deadline_s,
            got.journal_path, got.journal_strict, got.timeseries,
            got.timeseries_interval_s, got.timeseries_capacity) == (
        True, DEFAULT_SLO_TARGETS, True, 2.5, "j.jsonl", True, True, 0.5, 7)
    assert args.trace_out == "t.json"
    off = cli._serve_config(cli.build_parser().parse_args(
        ["serve", "--config", "gpt_tiny", "--timeseries-interval", "0"]), model)
    assert (off.timeseries, off.trace, off.slo_targets, off.journal_path) == (
        False, False, None, None)
    bench = cli.build_parser().parse_args([
        "serve-bench", "--config", "gpt_tiny", "--trace", "--trace-out", "o.json",
        "--trace-dump", "d.jsonl", "--status-port", "0", "--status-hold-s", "1",
        "--slo"])
    assert (bench.trace, bench.trace_out, bench.trace_dump, bench.status_port,
            bench.status_hold_s, bench.slo) == (True, "o.json", "d.jsonl", 0,
                                                1.0, True)
    assert cli.build_parser().parse_args(["trace-summary", "t.json",
                                          "--top", "3"]).top == 3


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--config", "gpt_tiny", "--steps", "1"])


# ------------------------------------------------------ fleet and replay


def test_serve_replicas_serves_a_fleet_behind_one_port(tmp_path, monkeypatch,
                                                       capsys):
    """`serve --replicas 2 --journal PATH --trace --trace-out`: concurrent
    SSE clients reach both replicas (X-Replica-Id), each journals to
    PATH.rN, /metrics' merged counts are the labelled ones' sum, /statusz
    has the fleet section, and SIGINT writes the stitched fleet trace."""
    import signal
    import threading
    import urllib.request

    from solvingpapers_tpu_torch import serve

    servers = []

    class Recorded(serve.ApiServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(serve, "ApiServer", Recorded)
    journal, trace = str(tmp_path / "j.jsonl"), str(tmp_path / "t.json")
    seen, errors = {}, []

    def post(i):
        body = json.dumps({"prompt": "ab" * (i + 1), "max_tokens": 16,
                           "temperature": 0, "stream": True}).encode()
        req = urllib.request.Request(servers[0].url("/v1/completions"),
                                     data=body, method="POST", headers={
                                         "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            seen[i] = r.headers["X-Replica-Id"]
            assert r.read().endswith(b"data: [DONE]\n\n")

    def drive():
        try:
            while not servers:
                time.sleep(0.01)
            clients = [threading.Thread(target=post, args=(i,)) for i in range(6)]
            for c in clients:
                c.start()
            for c in clients:
                c.join()
            with urllib.request.urlopen(servers[0].url("/statusz")) as r:
                seen["fleet"] = json.loads(r.read())["fleet"]
            with urllib.request.urlopen(servers[0].url("/metrics")) as r:
                seen["metrics"] = r.read().decode().splitlines()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
        finally:
            os.kill(os.getpid(), signal.SIGINT)

    import time

    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    t = threading.Thread(target=drive)
    t.start()
    try:
        rc = cli.main(["serve", "--config", "gpt_tiny", "--device", "cpu",
                       "--port", "0", "--replicas", "2", "--slots", "2",
                       "--journal", journal, "--trace", "--trace-out", trace])
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
        t.join()
    assert rc == 0 and not errors, errors
    assert {seen[i] for i in range(6)} == {"r0", "r1"}
    assert sorted(seen["fleet"]["replicas"]) == ["r0", "r1"]
    assert seen["fleet"]["routing"]["routed"] == 6
    lines = seen["metrics"]
    merged = sum(float(ln.rsplit(" ", 1)[1]) for ln in lines
                 if ln.startswith("serve_ttft_s_count "))
    labelled = sum(float(ln.rsplit(" ", 1)[1]) for ln in lines
                   if ln.startswith("serve_ttft_s_count{"))
    assert merged == labelled == 6
    assert os.path.exists(journal + ".r0") and os.path.exists(journal + ".r1")
    assert not os.path.exists(journal)
    capsys.readouterr()
    assert cli.main(["trace-summary", trace, "--fleet"]) == 0
    assert "fleet: 3 sections (router, r0, r1)" in capsys.readouterr().out


@pytest.fixture(scope="module")
def recorded_journal(tmp_path_factory):
    """A journal of greedy and seeded streams served on `cli replay`'s
    model (gpt_tiny, random weights from seed 0) at its engine defaults."""
    from solvingpapers_tpu_torch.serve import SamplingParams, ServeConfig, ServeEngine

    path = str(tmp_path_factory.mktemp("replay") / "j.jsonl")
    args = cli.build_parser().parse_args([
        "replay", "--config", "gpt_tiny", "--device", "cpu", "--journal", path])
    _, model, *_ = cli._serve_model(args, torch.device("cpu"))
    eng = ServeEngine(model, ServeConfig(n_slots=8, max_len=64, decode_block=8,
                                         bucket=32, journal_path=path),
                      device="cpu")
    rng = np.random.default_rng(0)
    for i in range(4):
        eng.submit(rng.integers(0, 50, 10), max_new_tokens=12,
                   params=SamplingParams(temperature=0.9, seed=i) if i % 2
                   else None)
    eng.run()
    eng.close()
    return path


@pytest.mark.parametrize("case", ["identical", "altered", "quant_override"])
def test_replay_gates_on_divergence(capsys, tmp_path, recorded_journal, case):
    path = recorded_journal
    if case == "altered":
        lines = open(path).read().splitlines()
        k = next(i for i, ln in enumerate(lines) if '"commit"' in ln)
        rec = json.loads(lines[k])
        rec["tokens"][0] = (rec["tokens"][0] + 1) % 50
        lines[k] = json.dumps(rec)
        path = str(tmp_path / "altered.jsonl")
        open(path, "w").write("\n".join(lines) + "\n")
    extra = (["--config-overrides", "kv_quant=int8"]
             if case == "quant_override" else [])
    rc, out, err = _run(capsys, "replay", "--config", "gpt_tiny", "--device",
                        "cpu", "--journal", path, "--cut-stride", "4", *extra)
    if case == "identical":
        report = json.loads(out.strip().splitlines()[-1])
        assert rc == 0 and report["byte_exact_rate"] == 1.0
        assert report["streams_compared"] == 4 and report["agreement_rate"] == 1.0
    elif case == "altered":
        report = json.loads(out.strip().splitlines()[-1])
        assert rc == 2 and "DIVERGENCE GATE FAILED" in err
        assert report["byte_exact_rate"] == 0.75
        assert report["diverged"][0]["first_divergence"] == 0
    else:
        assert rc == 2 and "ROADMAP A5" in err and not out
