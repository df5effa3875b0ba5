"""The port's command line (port of `solvingpapers_tpu/cli.py`: the LM
commands) — ``python -m solvingpapers_tpu_torch.cli <cmd>``:

    cli list
    cli train  --config gpt_shakespeare [--steps N] [--data-path f.txt]
               [--checkpoint-dir ckpts] [--ckpt-every N] [--jsonl m.jsonl]
               [--artifacts-dir out]
    cli sample --config gpt_shakespeare [--checkpoint-dir ckpts]
               [--prompt "ROMEO:" | --prompt-file f.txt] [--prefill-chunk N]
               [--max-new-tokens 200] [--top-k 50] [--temperature 1.0]
               [--greedy] [--seed 0]
    cli eval   --config gpt_shakespeare [--checkpoint-dir ckpts]
    cli export --config gpt_shakespeare --checkpoint-dir ckpts --out w.pt
    cli serve  --config dsv3_long [--port 8000] [--host 127.0.0.1]
               [--checkpoint-dir ckpts] [--slots 8] [--max-len N]
               [--decode-block 8] [--bucket 32] [--sample-cap 64]
               [--max-waiting 256] [--paged] [--no-json-mode] [--seed 0]
               [--trace [--trace-out t.json]] [--slo] [--degrade]
               [--step-deadline S] [--journal j.jsonl [--journal-strict]]
               [--timeseries-interval 1.0] [--timeseries-capacity 120]
               [--replicas N]
    cli replay --config dsv3_long --journal j.jsonl [--config-overrides
               K=V ...] [--byte-exact-min 1.0] [--agreement-min 0]
               [--cut-stride 8] [--max-cuts 512] [--max-requests N]
               [--pace] [--out r.json] [the engine flags of serve]
    cli serve-bench --config llama3_shakespeare [--shared-prefix |
               --sampling | --paged | --http | --slo | --chaos | --journal
               | --replay | --fleet] [--requests N] [--slots 8]
               [--max-new-tokens N] [--prompt-lens 16 32 48 64]
               [--skip-sequential] [--trace [--trace-out
               t.json] [--trace-dump d.jsonl]] [--status-port 0
               [--status-hold-s S]] [--out f.jsonl [--append]]
    cli trace-summary t.json [--top 5] [--fleet]

Every command runs on ``--device cuda`` (the default; it raises when
there is no card) or ``--device cpu``; the reference's `--platform` and
`--virtual-devices` select JAX backends and have no counterpart.

A context-parallel config runs as its dense twin on the one card
(`configs.registry.dense_twin`), as the reference samples it. `train
--artifacts-dir` samples 200 tokens (top-k 50) into
``generated_{step}.txt`` every `eval_every` steps (else `log_every`), as
the reference does, and once more after the last step when that is not
such a step, so a short run leaves a sample too. `export` writes the
checkpoint's model state: the parameters and the buffers a model needs
to reproduce its outputs (DeepSeek-V3's routing biases), where the
reference exports the parameters alone.

`serve` answers the OpenAI-compatible HTTP surface (`serve/api.py`)
from one `ServeEngine`; the model comes from `_serve_model`: the run's
tokenizer (a BPE config trains its byte BPE through the native library
at startup), weights from `--checkpoint-dir` or random from `--seed`,
and a token table over the full vocab. `--journal PATH` journals every
stream (serve/journal.py); an existing file is replayed at startup
(`ServeEngine.recover`), before the front door opens, so a killed
server's in-flight streams resume and SSE clients reconnect with
Last-Event-ID. `--trace` turns the flight recorder on and `--trace-out`
writes its Chrome trace at shutdown; `--slo` accounts requests under
`DEFAULT_SLO_TARGETS`; `--degrade` arms the degradation ladder;
`--step-deadline` the step watchdog; `--timeseries-interval 0` turns the
time series off. `--replicas N` serves a fleet of N engines on the one
model behind the same port (serve/fleet.py: prefix-affinity and
SLO-aware routing, the merged /metrics, the fleet /statusz), each
journaling to PATH.rN and recovering it before the door opens, and
`--trace-out` then writes the stitched fleet trace. SIGINT / SIGTERM
shut it down in order: drain streams, close the engines, stop the HTTP
threads.

`replay` re-serves a journal's finished streams on a fresh engine of the
model `serve` builds (same --config, --seed, --checkpoint-dir), shaped
by the engine flags and `--config-overrides` (serve/replay.py), prints
the divergence report, and exits 2 past its gate (`--byte-exact-min`,
`--agreement-min`).

`serve-bench` runs one workload of `serve/bench.py` a run — Poisson
(engine against sequential `generate`, the default), `--shared-prefix`,
`--sampling`, `--paged`, `--http`, `--slo`, `--chaos`, `--journal`,
`--replay` or `--fleet` — on random weights, and
prints one JSON line with a provenance stamp (written to `--out` too when
given). Beyond the reference's flags it takes `--max-seq-len` (the
model's position budget, which the prefix stems stretch to) and `--reps`
(the ABBA pairs of the paged, HTTP, SLO, chaos, journal and fleet
workloads); without
`--prompt-lens`, the default cycle 16 32 48 64 keeps the lengths that
fit the model's positions with the new tokens (gpt_tiny's 64 at 4 new
tokens: 16 32 48). `--trace` adds a traced arm to the Poisson, prefix
and sampling workloads (`trace_overhead_pct`); `--status-port` keeps a
status endpoint up for the run (`--status-hold-s` past its end).

`trace-summary` rebuilds per-request timelines from a flight-recorder
export (`metrics/trace.py`); `--fleet` requires a stitched fleet export
and prints its fleet section.

Not ported, refused with their ROADMAP items: `kernel-bench`, `sample
--speculative` and the flags of the quantized pool and speculative
decoding (A5: of `serve`, `serve-bench` and `replay`, whose `--replay`
workload also leaves out the reference's int8 candidate arm), and the
compile observatory's (A8); image, KD and Gemma configs (A6) and
pipeline ones (A7) are not registered.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys

import numpy as np
import torch

# the reference's commands the port refuses, with the ROADMAP item that
# brings each
UNPORTED = {
    "kernel-bench": "A5 (serve/kernel_bench.py)",
}


class Refused(Exception):
    """A request the port does not run; main prints it and exits 2."""


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", required=True)
    p.add_argument("--data-path", default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default cuda; raises when there is "
                        "no card)")


def _device(args) -> torch.device:
    from solvingpapers_tpu_torch.device import resolve_device

    return resolve_device(None if args.device == "cuda" else args.device)


def _config(args, **overrides):
    """The run of `--config` with `overrides`, as its dense twin, with
    `--data-path` applied."""
    from solvingpapers_tpu_torch.configs import dense_twin, get_config, list_configs

    if args.config not in list_configs():
        raise Refused(
            f"config {args.config!r} is not registered in the port (image, "
            "KD and Gemma configs come with ROADMAP A6, pipeline-parallel "
            f"ones with A7); the port registers: {', '.join(list_configs())}")
    cfg = dense_twin(get_config(args.config, **overrides))
    if args.data_path:
        cfg = dataclasses.replace(cfg, data={**cfg.data, "path": args.data_path})
    return cfg


def _lm_run(args, device, **overrides):
    """(cfg, model, tokenizer, train_iter, eval_iter_fn) of the run, the
    model in the training layout (float32 master weights)."""
    from solvingpapers_tpu_torch.configs.factory import build_char_lm_run

    return build_char_lm_run(_config(args, **overrides), device=device)


def cmd_list(_args) -> int:
    from solvingpapers_tpu_torch.configs import list_configs

    for name in list_configs():
        print(name)
    return 0


def _sampler(greedy: bool, k: int, temperature: float):
    from solvingpapers_tpu_torch import ops

    if greedy:
        return ops.sample_greedy
    return functools.partial(ops.sample_top_k, k=k, temperature=temperature)


def cmd_train(args) -> int:
    from solvingpapers_tpu_torch.configs.factory import loss_fn_for
    from solvingpapers_tpu_torch.infer import generate
    from solvingpapers_tpu_torch.metrics import (
        ConsoleWriter,
        JSONLWriter,
        MultiWriter,
        save_text_sample,
    )
    from solvingpapers_tpu_torch.train import Trainer

    device = _device(args)
    overrides = {}
    if args.steps is not None:
        overrides["steps"] = args.steps  # the schedule's horizon follows
    if args.checkpoint_dir:
        overrides["checkpoint_dir"] = args.checkpoint_dir
        overrides["ckpt_every"] = args.ckpt_every
    cfg, model, tok, train_iter, eval_iter_fn = _lm_run(args, device,
                                                        **overrides)
    writer = ConsoleWriter()  # fit() gates the cadence by log_every
    if args.jsonl:
        writer = MultiWriter(writer, JSONLWriter(args.jsonl))
    trainer = Trainer(model, cfg.train, loss_fn=loss_fn_for(cfg), device=device)

    callbacks, every, sample_cb = None, 0, None
    prompt = tok.encode("\n") if args.artifacts_dir else None
    if prompt is not None and len(prompt) == 0:
        print("[sample] disabled: the tokenizer yields an empty prompt",
              file=sys.stderr)
    elif prompt is not None:
        sampler = _sampler(False, 50, 1.0)

        def sample_cb(state, step):
            # deepseekv3 cell 54: sample and save generated_{step}.txt
            ids = torch.as_tensor(np.asarray(prompt), device=device)[None].long()
            limit = getattr(model, "max_positions", None) or 1_000_000
            gen = torch.Generator(device=device).manual_seed(step)
            model.eval()
            try:
                out = generate(model, ids, max_new_tokens=min(200, limit - ids.shape[1]),
                               sampler=sampler, generator=gen, device=device)
            finally:
                model.train()
            path = save_text_sample(tok.decode(out[0].tolist()),
                                    args.artifacts_dir, step)
            print(f"[sample] wrote {path}", flush=True)

        every = cfg.train.eval_every or cfg.train.log_every
        callbacks = [(every, sample_cb)]
    try:
        state = trainer.fit(train_iter, eval_iter_fn, writer=writer,
                            callbacks=callbacks)
        if sample_cb is not None and (every <= 0 or state.step % every):
            sample_cb(state, state.step)
    finally:
        writer.close()
    return 0


def _prompt_ids(args, tok, limit) -> np.ndarray | None:
    """The prompt's ids, cut to its last tokens when prompt + new tokens
    would pass the model's positions (a multiple of 128 kept where one
    fits, as the reference keeps its flash prefill chunks aligned);
    None when no prompt fits."""
    if args.prompt_file:
        with open(args.prompt_file, "r", encoding="utf-8") as f:
            text = f.read()
    else:
        text = args.prompt or "\n"
    ids = tok.encode(text)
    if limit is not None and len(ids) + args.max_new_tokens > limit:
        keep = (limit - args.max_new_tokens) // 128 * 128
        if keep <= 0:
            keep = limit - args.max_new_tokens
        if keep <= 0:
            print(f"[sample] max-new-tokens {args.max_new_tokens} >= model "
                  f"max positions {limit}: no room for a prompt",
                  file=sys.stderr)
            return None
        print(f"[sample] prompt of {len(ids)} tokens truncated to its last "
              f"{keep} (model max positions {limit} - {args.max_new_tokens} "
              "new)", file=sys.stderr)
        ids = ids[-keep:]
    return ids


def _serve_model(args, device):
    """Build the serving model as `cli serve` does: the run of `--config`
    as its dense twin with its tokenizer (a BPE config trains its byte
    BPE at startup, through the native library), weights from
    `--checkpoint-dir` or random from `--seed`, in eval mode, and a token
    table over the FULL model vocab (the tokenizer's ids decode as
    themselves, spare ids become missing JSON structural characters, so
    json_object mode is expressible). Returns (cfg, model, tok, table,
    encode, decode, info) — info holds the tokenizer's facts — or an int
    exit code."""
    import time

    from solvingpapers_tpu_torch.checkpoint import restore_for_inference
    from solvingpapers_tpu_torch.configs.factory import build_char_lm_run
    from solvingpapers_tpu_torch.data import ByteBPETokenizer
    from solvingpapers_tpu_torch.models import init_params_for
    from solvingpapers_tpu_torch.serve.openai import extend_token_table

    t0 = time.perf_counter()
    cfg, model, tok, _, _ = build_char_lm_run(_config(args), device=device,
                                              param_dtype=None)
    info = {"tokenizer": type(tok).__name__, "vocab": int(tok.vocab_size),
            "data_s": time.perf_counter() - t0}
    if isinstance(tok, ByteBPETokenizer):
        info.update(trained_native=tok.trained_native,
                    encodes_native=tok.encodes_native,
                    train_s=tok.train_seconds)
    model.eval()
    if args.checkpoint_dir:
        if restore_for_inference(model, args.checkpoint_dir) is None:
            print(f"no checkpoint found in {args.checkpoint_dir}",
                  file=sys.stderr)
            return 1
    else:
        print("[serve] no --checkpoint-dir: serving RANDOM-INIT params from "
              f"--seed {args.seed} (an endpoint and latency demo, not a "
              "language model)", file=sys.stderr)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model.load_state_dict(init_params_for(cfg.model)(cfg.model, gen))
    vocab = cfg.model.vocab_size
    table = []
    for i in range(vocab):
        try:
            table.append(tok.decode([i]))
        except (KeyError, IndexError):
            table.append(None)
    table = extend_token_table(table, vocab)
    if isinstance(tok, ByteBPETokenizer):
        def encode(s: str):
            return [int(i) for i in tok.encode(s)]
    else:
        stoi = {}
        for i, t in enumerate(table):
            if t is not None and len(t) == 1 and t not in stoi:
                stoi[t] = i

        def encode(s: str):
            return [stoi[c] for c in s]

    def decode(ids):
        return "".join(table[int(i)] or "" for i in ids)

    return cfg, model, tok, table, encode, decode, info


def _serve_config(args, model):
    """The `ServeConfig` of `cli serve`'s flags for `model` (max_len
    defaults to min(512, the model's max positions))."""
    from solvingpapers_tpu_torch.serve import ServeConfig
    from solvingpapers_tpu_torch.serve.slo import DEFAULT_SLO_TARGETS

    limit = getattr(model, "max_positions", None) or 512
    max_len = args.max_len or min(512, limit)
    return ServeConfig(
        n_slots=args.slots, max_len=max_len, decode_block=args.decode_block,
        bucket=min(args.bucket, max_len), sample_cap=args.sample_cap,
        paged=args.paged, api_port=args.port, api_host=args.host,
        api_max_connections=args.max_connections,
        json_mode=not args.no_json_mode,
        drain_timeout_s=args.drain_timeout, max_waiting=args.max_waiting,
        trace=args.trace,
        slo_targets=DEFAULT_SLO_TARGETS if args.slo else None,
        degrade=args.degrade, fault_step_deadline_s=args.step_deadline,
        journal_path=args.journal, journal_strict=args.journal_strict,
        timeseries=args.timeseries_interval > 0,
        timeseries_interval_s=args.timeseries_interval or 1.0,
        timeseries_capacity=args.timeseries_capacity)


# `serve` flags of the reference that the port refuses, with their items
SERVE_UNPORTED = {
    "--kv-quant": "A5 (the quantized KV pool)",
    "--kv-quant-block": "A5 (the quantized KV pool)",
    "--kv-exact-lanes": "A5 (the quantized KV pool)",
    "--speculative": "A5 (speculative decoding)",
    "--spec-k": "A5 (speculative decoding)",
    "--spec-rounds": "A5 (speculative decoding)",
}


def cmd_serve(args) -> int:
    """Serve a model over the OpenAI-compatible HTTP front door
    (`serve/api.py`): POST /v1/completions and /v1/chat/completions (SSE
    streaming, json_object mode) and GET /v1/models /healthz /metrics
    /statusz on one port, printed to stderr. SIGINT / SIGTERM shut down
    in order: drain active streams, close the engine, stop the HTTP
    threads."""
    import signal
    import threading

    from solvingpapers_tpu_torch.serve import ApiServer, ServeEngine

    device = _device(args)
    built = _serve_model(args, device)
    if isinstance(built, int):
        return built
    cfg, model, _, table, encode, decode, info = built
    print("[serve] tokenizer " + json.dumps(info), file=sys.stderr, flush=True)
    serve_cfg = _serve_config(args, model)
    n_replicas = max(1, args.replicas)
    engines = []
    for i in range(n_replicas):
        rep_cfg = serve_cfg
        if serve_cfg.journal_path and n_replicas > 1:
            # each replica journals to its own file: one shared file would
            # interleave the records of independent engines
            rep_cfg = dataclasses.replace(
                serve_cfg, journal_path=f"{serve_cfg.journal_path}.r{i}")
        # the replicas share the one model, and so one copy of its weights
        eng = ServeEngine(model, rep_cfg, device=device, detokenize=decode)
        if rep_cfg.journal_path:
            # crash-safe warm restart: the journal's unfinished entries are
            # requeued BEFORE the front door starts stepping
            resumed = eng.recover()
            print(f"[serve] journal {rep_cfg.journal_path}: recovered "
                  f"{len(resumed)} in-flight request(s)", file=sys.stderr,
                  flush=True)
        engines.append(eng)
    router = None
    fleet_note = ""
    if n_replicas > 1:
        from solvingpapers_tpu_torch.serve.fleet import FleetRouter

        router = FleetRouter(engines)
        server = ApiServer(encode=encode, decode=decode, token_table=table,
                           model_name=args.config, router=router)
        fleet_note = f" — a fleet of {n_replicas} replicas"
    else:
        server = ApiServer(engines[0], encode=encode, decode=decode,
                           token_table=table, model_name=args.config)
    print(f"[serve] {args.config} on http://{server.host}:{server.port} — "
          "POST /v1/completions /v1/chat/completions /v1/replay, GET "
          "/v1/models /v1/requests/<id> /v1/replay/<id> /healthz /metrics "
          f"/statusz /timeseriesz{fleet_note}", file=sys.stderr, flush=True)
    stop = threading.Event()

    def _sig(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    try:
        while not stop.wait(0.5):
            pass
    finally:
        print("[serve] shutting down: draining streams, closing engine",
              file=sys.stderr, flush=True)
        server.close()
        if args.trace_out:
            # written after close, so the drain's spans are in the file; a
            # fleet writes the stitched export (router and every replica)
            if engines[0].trace is None:
                print("[serve] --trace-out skipped: tracing is off (pass "
                      "--trace)", file=sys.stderr)
            elif router is not None:
                router.export_chrome_fleet(args.trace_out)
                print(f"[serve] fleet trace -> {args.trace_out}",
                      file=sys.stderr)
            else:
                engines[0].trace.export_chrome(args.trace_out)
                print(f"[serve] trace -> {args.trace_out}", file=sys.stderr)
    return 0


def cmd_replay(args) -> int:
    """Replay a request journal against a candidate serving config and gate
    on the divergence report (serve/replay.py): journal real traffic,
    replay it under the proposed knobs, ship only if the streams still
    match. The model is built as `cli serve` builds it (same --config,
    --seed and --checkpoint-dir, so the same weights); the engine flags
    and --config-overrides shape the candidate; with overrides the
    un-overridden config is re-served too, for paired deltas. Prints the
    report as one JSON line.

    Exit codes: 0 the gate passed; 2 divergence beyond --byte-exact-min or
    --agreement-min (the canary signal); 1 an operational failure (an
    unreadable journal, nothing comparable)."""
    from solvingpapers_tpu_torch.serve.engine import ServeConfig
    from solvingpapers_tpu_torch.serve.journal import JournalError
    from solvingpapers_tpu_torch.serve.replay import ReplayHarness, apply_overrides

    device = _device(args)
    built = _serve_model(args, device)
    if isinstance(built, int):
        return built
    _, model, _, _, _, decode, _ = built
    limit = getattr(model, "max_positions", None) or 512
    max_len = args.max_len or min(512, limit)
    base_cfg = ServeConfig(
        n_slots=args.slots, max_len=max_len, decode_block=args.decode_block,
        bucket=min(args.bucket, max_len), sample_cap=args.sample_cap,
        paged=args.paged, max_waiting=args.max_waiting)
    overrides = {}
    for kv in args.config_overrides or []:
        if "=" not in kv:
            print(f"[replay] --config-overrides takes KEY=VALUE pairs, got "
                  f"{kv!r}", file=sys.stderr)
            return 2
        k, v = kv.split("=", 1)
        overrides[k] = v
    try:
        candidate = apply_overrides(base_cfg, overrides)
    except (ValueError, TypeError) as e:
        print(f"[replay] {e}", file=sys.stderr)
        return 2
    harness = ReplayHarness(model, detokenize=decode)
    try:
        entries = harness.load(args.journal)
    except FileNotFoundError:
        print(f"[replay] journal not found: {args.journal}", file=sys.stderr)
        return 1
    except JournalError as e:
        print(f"[replay] {e}", file=sys.stderr)
        return 1
    print(f"[replay] {args.journal}: {len(entries)} journaled request(s)",
          file=sys.stderr)
    report = harness.run(
        entries, candidate, baseline=base_cfg if overrides else None,
        cut_stride=args.cut_stride, max_cuts=args.max_cuts,
        max_requests=args.max_requests, pace=args.pace,
        journal_path=args.journal)
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
        print(f"[replay] wrote {args.out}", file=sys.stderr)
    if report["streams_compared"] == 0:
        print("[replay] no byte-comparable streams (greedy or seeded) in the "
              "journal: the gate is undecidable", file=sys.stderr)
        return 1
    bex = report["byte_exact_rate"]
    agr = report["agreement_rate"]
    print(f"[replay] byte_exact_rate={bex} agreement_rate={agr} "
          f"compared={report['streams_compared']} "
          f"skipped={len(report['skipped'])} wall={report['replay_wall_s']}s",
          file=sys.stderr)
    failed = []
    if bex < args.byte_exact_min:
        failed.append(f"byte_exact_rate {bex} < {args.byte_exact_min}")
    if args.agreement_min and (agr is None or agr < args.agreement_min):
        failed.append(f"agreement_rate {agr} < {args.agreement_min}")
    if failed:
        for d in report["diverged"][:8]:
            print(f"[replay] diverged: {json.dumps(d)}", file=sys.stderr)
        print(f"[replay] DIVERGENCE GATE FAILED: {'; '.join(failed)}",
              file=sys.stderr)
        return 2
    return 0


# `serve-bench` flags of the reference that the port refuses, with their
# items
BENCH_UNPORTED = {
    "--speculative": "A5 (speculative decoding)",
    "--spec-k": "A5 (speculative decoding)",
    "--spec-rounds": "A5 (speculative decoding)",
    "--spec-train-steps": "A5 (speculative decoding)",
    "--kv-quant": "A5 (the quantized KV pool)",
    "--kv-quant-block": "A5 (the quantized KV pool)",
    "--quant-train-steps": "A5 (the quantized KV pool)",
    "--obs": "A8 (the compile and memory observatory)",
    "--obs-hlo-dir": "A8 (the compile and memory observatory)",
}

# `replay` flags of the reference that the port refuses: a candidate of
# the quantized pool or of speculative decoding cannot be built yet
REPLAY_UNPORTED = {
    "--kv-quant": "A5 (the quantized KV pool)",
    "--kv-quant-block": "A5 (the quantized KV pool)",
    "--kv-exact-lanes": "A5 (the quantized KV pool)",
    "--speculative": "A5 (speculative decoding)",
    "--spec-k": "A5 (speculative decoding)",
    "--spec-rounds": "A5 (speculative decoding)",
}


def _bench_config(args):
    """`--config` as a RunConfig, its position budget cut to
    `--max-seq-len` when given (LLaMA's `max_seq_len`, GPT's and
    DeepSeek-V3's `block_size`)."""
    cfg = _config(args)
    if args.max_seq_len is None:
        return cfg
    field = "max_seq_len" if hasattr(cfg.model, "max_seq_len") else "block_size"
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, **{field: args.max_seq_len}))


def cmd_serve_bench(args) -> int:
    """One serving workload (serve/bench.py): continuous batching against
    sequential one-shot generate on a Poisson arrival stream, or with
    --shared-prefix the prefix cache on against off over K shared system
    prompts, with --sampling a per-request SamplingParams mix against
    all-greedy, with --paged the paged KV pool against the lane pool
    (throughput, equal-bytes capacity, page-sharing prefix TTFT), with
    --http SSE clients through the front door against direct submit;
    prints the result as one JSON line and writes it to --out when
    given."""
    if args.checkpoint_dir or args.data_path:
        print("serve-bench benchmarks scheduling throughput on random-init "
              "params; --checkpoint-dir/--data-path are not consumed",
              file=sys.stderr)
        return 2
    if sum((args.shared_prefix, args.sampling, args.paged, args.http,
            args.slo, args.chaos, args.journal, args.fleet, args.replay)) > 1:
        print("--shared-prefix, --sampling, --paged, --http, --slo, --chaos, "
              "--journal, --fleet and --replay are separate workloads; pick "
              "one per run", file=sys.stderr)
        return 2
    from solvingpapers_tpu_torch.serve.bench import (
        bench_provenance,
        run_chaos_bench,
        run_fleet_bench,
        run_http_bench,
        run_journal_bench,
        run_paged_bench,
        run_prefix_bench,
        run_replay_bench,
        run_sampling_bench,
        run_serve_bench,
        run_slo_bench,
    )

    device = _device(args)
    config = _bench_config(args)
    # shared flags with per-workload defaults (None sentinel, so an
    # explicit value always wins)
    max_new = args.max_new_tokens
    if max_new is None:
        max_new = 4 if args.shared_prefix else 64
    decode_block = args.decode_block
    if decode_block is None:
        decode_block = 4 if args.shared_prefix else 16
    n_requests = args.requests
    if n_requests is None:
        n_requests = 48 if args.shared_prefix or args.chaos else 32
    n_slots = args.slots
    if n_slots is None:
        n_slots = 4 if args.chaos else 8
    mean_ia = args.mean_interarrival
    if mean_ia is None:
        mean_ia = 0.15 if args.chaos else 0.001
    common = dict(config=config, n_requests=n_requests, n_slots=n_slots,
                  max_new=max_new, decode_block=decode_block,
                  mean_interarrival_s=mean_ia, seed=args.seed, device=device)
    prompt_lens = args.prompt_lens
    if prompt_lens is None:
        # the default cycle, cut to the lengths that fit the model's
        # position budget with the new tokens (a small config's)
        limit = getattr(config.model, "max_seq_len",
                        getattr(config.model, "block_size", None))
        prompt_lens = [n for n in (16, 32, 48, 64)
                       if limit is None or n + max_new <= limit]
        if len(prompt_lens) < 4:
            print(f"[serve-bench] default prompt lengths cut to {prompt_lens}: "
                  f"the model's max positions are {limit}", file=sys.stderr)
        if not prompt_lens:
            return 2
    prompt_lens = tuple(prompt_lens)
    reps = {} if args.reps is None else {"reps": args.reps}
    common.update(status_port=args.status_port,
                  status_hold_s=args.status_hold_s)
    # the traced arm rides the Poisson, prefix and sampling workloads
    traced = dict(trace=args.trace,
                  trace_out=args.trace_out if args.trace else None,
                  trace_dump=args.trace_dump if args.trace else None)
    if args.replay:
        # all up front: no arrivals; its own budget and block defaults
        replay_common = {k: v for k, v in common.items()
                         if k not in ("mean_interarrival_s", "max_new",
                                      "decode_block")}
        result = run_replay_bench(
            prompt_lens=prompt_lens, max_new=args.max_new_tokens or 48,
            decode_block=args.decode_block or 8,
            train_steps=args.replay_train_steps, page_size=args.page_size,
            **replay_common)
    elif args.chaos:
        result = run_chaos_bench(
            prompt_lens=prompt_lens, stall_s=args.chaos_stall, **reps,
            **{**common, "max_new": args.max_new_tokens or 48,
               "decode_block": args.decode_block or 8})
    elif args.fleet:
        result = run_fleet_bench(
            prompt_lens=prompt_lens, n_replicas=args.fleet_replicas,
            trace_out=args.trace_out if args.trace else None, **reps,
            **common)
    elif args.journal:
        result = run_journal_bench(prompt_lens=prompt_lens,
                                   kill_step=args.journal_kill_step, **reps,
                                   **common)
    elif args.http:
        result = run_http_bench(prompt_lens=prompt_lens, **reps, **common)
    elif args.slo:
        result = run_slo_bench(prompt_lens=prompt_lens, **reps, **common)
    elif args.paged:
        result = run_paged_bench(
            prompt_lens=prompt_lens, n_prefixes=args.n_prefixes,
            prefix_requests=args.prefix_requests, suffix_len=args.suffix_len,
            page_size=args.page_size, **reps, **common)
    elif args.sampling:
        result = run_sampling_bench(prompt_lens=prompt_lens, **traced,
                                    **common)
    elif args.shared_prefix:
        result = run_prefix_bench(
            n_prefixes=args.n_prefixes, prefix_len=args.prefix_len,
            suffix_len=args.suffix_len, prefix_page=args.prefix_page,
            **traced, **common)
    else:
        result = run_serve_bench(prompt_lens=prompt_lens,
                                 skip_sequential=args.skip_sequential,
                                 **traced, **common)
    # one clock reading per run, stamped here, the one place results are
    # written
    import time

    result = {**bench_provenance(timestamp=time.time()), **result}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a" if args.append else "w") as f:
            f.write(line + "\n")
        verb = "appended to" if args.append else "wrote"
        print(f"[serve-bench] {verb} {args.out}", file=sys.stderr)
    return 0


def cmd_trace_summary(args) -> int:
    """Rebuild per-request timelines from a Chrome trace-event JSON the
    flight recorder exported (`serve --trace --trace-out`, `serve-bench
    --trace`, `engine.trace.export_chrome`) and print the phase breakdown
    and the slowest requests (metrics/trace.py)."""
    import os

    from solvingpapers_tpu_torch.metrics.trace import (
        format_summary,
        summarize_trace,
    )

    if not os.path.exists(args.trace):
        print(f"no trace file at {args.trace}", file=sys.stderr)
        return 2
    try:
        summary = summarize_trace(args.trace)
    except json.JSONDecodeError as e:
        # a truncated export (a run killed mid-write) or a non-JSON file
        # is an input error, not a traceback: say what and where
        print(f"{args.trace} is not valid JSON (truncated export?): {e.msg} "
              f"at line {e.lineno} column {e.colno}", file=sys.stderr)
        return 2
    except (ValueError, TypeError, AttributeError, KeyError) as e:
        if isinstance(e, ValueError) and "partial fleet export" in str(e):
            # the stitcher's own diagnosis: a sliced fleet file must not
            # pass for a generic parse failure
            print(f"{args.trace}: {e}", file=sys.stderr)
            return 2
        print(f"{args.trace} does not parse as a Chrome trace-event JSON "
              f"({type(e).__name__}: {e}) — expected the flight recorder's "
              "export format", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"cannot read {args.trace}: {e}", file=sys.stderr)
        return 2
    if args.fleet and "fleet" not in summary:
        print(f"{args.trace} holds no fleet events: --fleet expects the "
              "stitched export (FleetRouter.export_chrome_fleet, `serve "
              "--replicas N --trace --trace-out`, or `serve-bench --fleet "
              "--trace --trace-out`); this looks like a single-engine trace, "
              "so rerun without --fleet", file=sys.stderr)
        return 2
    if summary["n_requests"] or summary["rejected"]:
        print(format_summary(summary, top=args.top))
        return 0
    print(f"{args.trace} holds no request lifecycle events "
          "(ServeConfig(trace=True)) — was it exported by the flight "
          "recorder?", file=sys.stderr)
    return 1


def cmd_sample(args) -> int:
    from solvingpapers_tpu_torch.checkpoint import restore_for_inference
    from solvingpapers_tpu_torch.configs.factory import build_char_lm_run
    from solvingpapers_tpu_torch.infer import generate
    from solvingpapers_tpu_torch.models import init_params_for

    if args.speculative:
        raise Refused("sample --speculative is not ported yet (ROADMAP A5: "
                      "MTP and n-gram drafters)")
    device = _device(args)
    # the sampling layout: weights stored in the compute dtype
    cfg, model, tok, _, _ = build_char_lm_run(_config(args), device=device,
                                              param_dtype=None)
    model.eval()
    ids = _prompt_ids(args, tok, getattr(model, "max_positions", None))
    if ids is None:
        return 2
    if args.checkpoint_dir:
        if restore_for_inference(model, args.checkpoint_dir) is None:
            print(f"no checkpoint found in {args.checkpoint_dir}",
                  file=sys.stderr)
            return 1
    else:  # a random model from --seed, as the reference's init
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model.load_state_dict(init_params_for(cfg.model)(cfg.model, gen))
    prompt = torch.as_tensor(np.asarray(ids), device=device)[None].long()
    out = generate(model, prompt, max_new_tokens=args.max_new_tokens,
                   sampler=_sampler(args.greedy, args.top_k, args.temperature),
                   generator=torch.Generator(device=device).manual_seed(args.seed),
                   prefill_chunk=args.prefill_chunk, device=device)
    print(tok.decode(out[0].tolist()))
    return 0


def _restored_trainer(args, device):
    """(trainer, state, eval_iter_fn) with the newest checkpoint of
    `--checkpoint-dir` restored (fresh parameters without one); the
    state is None when the directory holds no checkpoint."""
    from solvingpapers_tpu_torch.checkpoint import restore_for_inference
    from solvingpapers_tpu_torch.configs.factory import loss_fn_for
    from solvingpapers_tpu_torch.train import Trainer

    cfg, model, _, _, eval_iter_fn = _lm_run(args, device)
    trainer = Trainer(model, cfg.train, loss_fn=loss_fn_for(cfg), device=device)
    state = trainer.init_state()
    if args.checkpoint_dir and restore_for_inference(
            model, args.checkpoint_dir) is None:
        print(f"no checkpoint found in {args.checkpoint_dir}", file=sys.stderr)
        state = None
    return trainer, state, eval_iter_fn


def cmd_eval(args) -> int:
    """The held-out loss (gpt cell 14 / dsv3 cell 48's estimate_loss)
    over `eval_batches` batches, printed as one JSON object."""
    trainer, state, eval_iter_fn = _restored_trainer(args, _device(args))
    if state is None:
        return 1
    metrics = trainer.evaluate(state, eval_iter_fn())
    print(json.dumps({k: round(float(v), 6) for k, v in metrics.items()}))
    return 0


def cmd_export(args) -> int:
    """The newest checkpoint's model state (parameters and buffers) to
    `--out`, for `checkpoint.load_params`."""
    from solvingpapers_tpu_torch.checkpoint import export_params

    if not args.checkpoint_dir:
        print("export requires --checkpoint-dir", file=sys.stderr)
        return 2
    trainer, state, _ = _restored_trainer(args, _device(args))
    if state is None:
        return 1
    export_params(args.out, trainer.model.state_dict())
    print(f"exported params to {args.out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The command line's parser (every command and its flags)."""
    parser = argparse.ArgumentParser(prog="solvingpapers_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list")

    p_train = sub.add_parser("train")
    _add_common(p_train)
    p_train.add_argument("--steps", type=int, default=None)
    p_train.add_argument("--ckpt-every", type=int, default=1000)
    p_train.add_argument("--jsonl", default=None)
    p_train.add_argument("--artifacts-dir", default=None,
                         help="write generated_{step}.txt samples here")

    p_sample = sub.add_parser("sample")
    _add_common(p_sample)
    p_sample.add_argument("--prompt", default=None)
    p_sample.add_argument("--prompt-file", default=None,
                          help="read the prompt text from a file")
    p_sample.add_argument("--prefill-chunk", type=int, default=None,
                          help="prefill the prompt in chunks of this many "
                               "tokens (default: 2048 past 4096 tokens)")
    p_sample.add_argument("--max-new-tokens", type=int, default=200)
    p_sample.add_argument("--top-k", type=int, default=50)
    p_sample.add_argument("--temperature", type=float, default=1.0)
    p_sample.add_argument("--greedy", action="store_true")
    p_sample.add_argument("--speculative", action="store_true",
                          help="not ported (ROADMAP A5)")
    p_sample.add_argument("--seed", type=int, default=0)

    p_eval = sub.add_parser("eval")
    _add_common(p_eval)

    p_export = sub.add_parser("export")
    _add_common(p_export)
    p_export.add_argument("--out", required=True)

    p_srv = sub.add_parser("serve")
    _add_common(p_srv)
    p_srv.add_argument("--port", type=int, default=8000,
                       help="API port (0 = ephemeral, printed to stderr)")
    p_srv.add_argument("--host", default="127.0.0.1",
                       help="bind address (loopback by default — front "
                            "with a real proxy to expose it)")
    p_srv.add_argument("--slots", type=int, default=8)
    p_srv.add_argument("--max-len", type=int, default=None,
                       help="engine sequence capacity (default: min(512, "
                            "model max positions))")
    p_srv.add_argument("--decode-block", type=int, default=8)
    p_srv.add_argument("--bucket", type=int, default=32)
    p_srv.add_argument("--sample-cap", type=int, default=64)
    p_srv.add_argument("--max-waiting", type=int, default=256)
    p_srv.add_argument("--paged", action="store_true",
                       help="serve over the paged KV pool")
    p_srv.add_argument("--no-json-mode", action="store_true",
                       help="reject response_format json_object instead of "
                            "grammar-constraining the decode")
    p_srv.add_argument("--max-connections", type=int, default=64,
                       help="concurrent streams before a new one gets 503")
    p_srv.add_argument("--drain-timeout", type=float, default=10.0,
                       help="seconds shutdown waits for active streams "
                            "before it cancels them")
    p_srv.add_argument("--seed", type=int, default=0,
                       help="random weights from this seed when no "
                            "--checkpoint-dir is given")
    p_srv.add_argument("--slo", action="store_true",
                       help="account every request under an SLO class "
                            "(serve/slo.py DEFAULT_SLO_TARGETS: interactive, "
                            "standard, batch; a request tags one with the "
                            "'slo' body field, default standard): "
                            "attainment, burn rate and goodput on /metrics "
                            "and /statusz")
    p_srv.add_argument("--degrade", action="store_true",
                       help="arm the degradation ladder (serve/faults.py): "
                            "under page exhaustion or SLO burn the engine "
                            "sheds prefix-cache leaves, then admissions by "
                            "class (batch first) with a jittered "
                            "Retry-After; pair with --slo for the burn "
                            "signal")
    p_srv.add_argument("--step-deadline", type=float, default=None,
                       help="watchdog: count engine steps over this many "
                            "seconds (serve/watchdog_stalls)")
    p_srv.add_argument("--journal", default=None, metavar="PATH",
                       help="request write-ahead journal "
                            "(ServeConfig.journal_path): an existing file is "
                            "replayed at startup, so a killed server's "
                            "in-flight streams resume and SSE clients "
                            "reconnect with Last-Event-ID")
    p_srv.add_argument("--journal-strict", action="store_true",
                       help="[--journal] a journal I/O failure stops "
                            "serving instead of degrading to journal-off")
    p_srv.add_argument("--replicas", type=int, default=1,
                       help="serve a FLEET of N engine replicas on one model "
                            "behind one port (serve/fleet.py FleetRouter): "
                            "prefix-affinity and SLO-aware routing, merged "
                            "/metrics, a fleet /statusz; with --journal each "
                            "replica journals to PATH.rN, and a drain can "
                            "migrate live streams between replicas")
    p_srv.add_argument("--trace", action="store_true",
                       help="flight recorder on (ServeConfig.trace): HTTP "
                            "spans join the engine's lifecycle spans per "
                            "request")
    p_srv.add_argument("--trace-out", default=None, metavar="PATH",
                       help="[--trace] write the Chrome trace-event JSON "
                            "here at shutdown (feed `cli trace-summary`); "
                            "with --replicas > 1 the stitched fleet export "
                            "(`cli trace-summary --fleet`)")
    p_srv.add_argument("--timeseries-interval", type=float, default=1.0,
                       help="time-series sample interval in seconds (0 "
                            "turns the store and /timeseriesz off)")
    p_srv.add_argument("--timeseries-capacity", type=int, default=120,
                       help="time-series ring capacity in windows")

    p_bench = sub.add_parser("serve-bench")
    _add_common(p_bench)
    p_bench.add_argument("--requests", type=int, default=None,
                         help="default 32 (48 with --shared-prefix)")
    p_bench.add_argument("--slots", type=int, default=None,
                         help="default 8 (4 with --chaos, whose ladder needs "
                              "queueing)")
    p_bench.add_argument("--max-new-tokens", type=int, default=None,
                         help="default 64 (4 with --shared-prefix, whose "
                              "TTFT story is prefill-bound)")
    p_bench.add_argument("--decode-block", type=int, default=None,
                         help="default 16 (4 with --shared-prefix)")
    p_bench.add_argument("--prompt-lens", type=int, nargs="+", default=None,
                         help="prompt-length cycle; default 16 32 48 64")
    p_bench.add_argument("--mean-interarrival", type=float, default=None,
                         help="Poisson arrival mean gap in seconds; default "
                              "0.001 (0.15 with --chaos: shedding shows only "
                              "while arrivals keep coming)")
    p_bench.add_argument("--seed", type=int, default=0)
    p_bench.add_argument("--skip-sequential", action="store_true",
                         help="only run the engine arm")
    p_bench.add_argument("--shared-prefix", action="store_true",
                         help="shared-prefix workload instead: N requests "
                              "over K distinct system prompts, prefix cache "
                              "on vs off (run_prefix_bench)")
    p_bench.add_argument("--sampling", action="store_true",
                         help="sampling workload instead: the Poisson trace "
                              "all-greedy vs a per-request temperature/top-p"
                              "/top-k/min-p mix (run_sampling_bench)")
    p_bench.add_argument("--http", action="store_true",
                         help="HTTP soak instead: the Poisson trace as N "
                              "concurrent SSE clients through the front "
                              "door, ABBA-paired against direct submit "
                              "(run_http_bench)")
    p_bench.add_argument("--paged", action="store_true",
                         help="paged-pool workload instead: paged vs lane "
                              "pool on the Poisson trace, a capacity arm at "
                              "equal pool bytes (2x slots) and a "
                              "shared-prefix arm with page sharing "
                              "(run_paged_bench)")
    p_bench.add_argument("--page-size", type=int, default=16,
                         help="[--paged] tokens per KV page")
    p_bench.add_argument("--prefix-requests", type=int, default=None,
                         help="[--paged] requests of the shared-prefix "
                              "sub-arm (default 48)")
    p_bench.add_argument("--n-prefixes", type=int, default=4,
                         help="[--shared-prefix, --paged] distinct system "
                              "prompts K")
    p_bench.add_argument("--prefix-len", type=int, default=None,
                         help="[--shared-prefix] shared stem length "
                              "(default: stretch to the model's position "
                              "budget, page-aligned)")
    p_bench.add_argument("--suffix-len", type=int, default=8,
                         help="[--shared-prefix, --paged] unique tail length")
    p_bench.add_argument("--prefix-page", type=int, default=16,
                         help="[--shared-prefix] radix-tree page size")
    p_bench.add_argument("--max-seq-len", type=int, default=None,
                         help="cut the model's position budget to this many "
                              "positions (the prefix stems stretch to it)")
    p_bench.add_argument("--reps", type=int, default=None,
                         help="[--paged, --http, --slo] ABBA pairs (default "
                              "2); [--chaos, --journal, --fleet] ABBA pairs of "
                              "the overhead arms (default 4)")
    p_bench.add_argument("--slo", action="store_true",
                         help="SLO workload instead: the Poisson trace with "
                              "requests tagged interactive / standard / "
                              "batch through an slo_targets engine, "
                              "ABBA-paired against the plain engine "
                              "(run_slo_bench)")
    p_bench.add_argument("--chaos", action="store_true",
                         help="fault-tolerance soak instead: one seeded fault "
                              "schedule (NaN and Inf slot poisons, a device "
                              "error and an OOM, a step stall, a journal I/O "
                              "error) over the Poisson trace through a "
                              "fault-free reference, a ladder-off arm "
                              "(streams_survived, survivor token-exactness, "
                              "zero leaks) and a ladder-on arm (goodput), "
                              "plus fault_overhead_pct (run_chaos_bench)")
    p_bench.add_argument("--chaos-stall", type=float, default=0.75,
                         help="[--chaos] injected step-stall seconds (the "
                              "watchdog's deadline is set below it)")
    p_bench.add_argument("--journal", action="store_true",
                         help="durability workload instead: ABBA-paired "
                              "journal-on against journal-off req/s "
                              "(journal_overhead_pct) and a kill-and-recover "
                              "arm: abandon the engine mid-decode, recover the "
                              "journal on a fresh one, recovered_token_exact "
                              "(run_journal_bench)")
    p_bench.add_argument("--journal-kill-step", type=int, default=None,
                         help="[--journal] engine step at which the "
                              "kill-and-recover arm abandons its engine "
                              "(default: after a third of the requests "
                              "finish)")
    p_bench.add_argument("--replay", action="store_true",
                         help="replay workload instead: journal a greedy and "
                              "seeded workload on a briefly trained model on "
                              "both pools and replay each through "
                              "serve/replay.py at the identical config: "
                              "replay_byte_exact, the never-flip gate "
                              "(run_replay_bench; the int8 candidate arm "
                              "waits for ROADMAP A5)")
    p_bench.add_argument("--replay-train-steps", type=int, default=150,
                         help="[--replay] brief training steps before "
                              "journaling (0 = random init)")
    p_bench.add_argument("--fleet", action="store_true",
                         help="fleet workload instead: router_overhead_pct "
                              "(a one-replica FleetRouter against the bare "
                              "engine), fleet_trace_overhead_pct, and a "
                              "mid-decode drain of replica r0 whose streams "
                              "its peers adopt: migrated_token_exact, "
                              "fleet_token_exact, zero leaks on every replica "
                              "(run_fleet_bench)")
    p_bench.add_argument("--fleet-replicas", type=int, default=2,
                         help="[--fleet] replicas of the drain arm")
    p_bench.add_argument("--trace", action="store_true",
                         help="[Poisson, --shared-prefix, --sampling] add a "
                              "traced arm, ABBA-paired against the untraced "
                              "one (trace_overhead_pct); [--fleet] write the "
                              "drain arm's stitched fleet trace to "
                              "--trace-out")
    p_bench.add_argument("--trace-out", default="serve_trace.json",
                         help="[--trace] write the traced arm's Chrome trace "
                              "here (feed `cli trace-summary`)")
    p_bench.add_argument("--trace-dump", default=None,
                         help="[--trace] anomaly-dump JSONL path "
                              "(ServeConfig.trace_dump_path)")
    p_bench.add_argument("--status-port", type=int, default=None,
                         help="serve /healthz /metrics /statusz "
                              "/timeseriesz from the probe engine for the "
                              "run (0 = ephemeral, printed to stderr)")
    p_bench.add_argument("--status-hold-s", type=float, default=0.0,
                         help="[--status-port] keep the endpoint up this "
                              "many seconds after the arms finish")
    p_bench.add_argument("--out", default=None,
                         help="also write the JSON result here")
    p_bench.add_argument("--append", action="store_true",
                         help="append to --out instead of overwriting "
                              "(JSON lines: one result per run)")

    p_tsum = sub.add_parser("trace-summary")
    p_tsum.add_argument("trace", help="Chrome trace-event JSON exported by "
                                      "the flight recorder")
    p_tsum.add_argument("--top", type=int, default=5,
                        help="how many slowest requests to print")
    p_tsum.add_argument("--fleet", action="store_true",
                        help="require the stitched fleet section: exit 2 "
                             "when the trace holds no fleet events (a "
                             "single-engine export), or when its manifest "
                             "declares replicas the file is missing")

    p_rep = sub.add_parser(
        "replay",
        help="replay a request journal against a candidate config and gate "
             "on stream divergence (serve/replay.py): exit 0 = match, 2 = "
             "divergence beyond the thresholds, 1 = operational failure")
    _add_common(p_rep)
    p_rep.add_argument("--journal", required=True, metavar="PATH",
                       help="journal to replay: the live file a `cli serve "
                            "--journal` wrote (a rotation mid-read is "
                            "tolerated) or a copy")
    p_rep.add_argument("--config-overrides", nargs="*", default=None,
                       metavar="KEY=VALUE",
                       help="ServeConfig fields of the CANDIDATE (e.g. "
                            "paged=true decode_block=16); values parse as "
                            "JSON, else stay strings; with overrides the "
                            "un-overridden config is re-served too, for "
                            "paired deltas")
    p_rep.add_argument("--out", default=None,
                       help="also write the report JSON here")
    p_rep.add_argument("--byte-exact-min", type=float, default=1.0,
                       help="exit 2 if byte_exact_rate over the greedy and "
                            "seeded streams falls below this (default 1.0: "
                            "an identical config must match exactly)")
    p_rep.add_argument("--agreement-min", type=float, default=0.0,
                       help="exit 2 if the teacher-forced agreement_rate "
                            "falls below this (0 turns the check off)")
    p_rep.add_argument("--max-requests", type=int, default=None,
                       help="replay only the first N journaled requests")
    p_rep.add_argument("--cut-stride", type=int, default=8,
                       help="token stride of the teacher-forced agreement "
                            "cuts (0 turns the agreement pass off)")
    p_rep.add_argument("--max-cuts", type=int, default=512,
                       help="total agreement-cut budget (the overflow is "
                            "reported as cuts_dropped)")
    p_rep.add_argument("--pace", action="store_true",
                       help="re-serve at the recorded arrival offsets "
                            "instead of all up front")
    p_rep.add_argument("--slots", type=int, default=8)
    p_rep.add_argument("--max-len", type=int, default=None,
                       help="engine sequence capacity (default: min(512, "
                            "model max positions)); match the recording "
                            "server's")
    p_rep.add_argument("--decode-block", type=int, default=8)
    p_rep.add_argument("--bucket", type=int, default=32)
    p_rep.add_argument("--sample-cap", type=int, default=64)
    p_rep.add_argument("--max-waiting", type=int, default=256)
    p_rep.add_argument("--paged", action="store_true")
    p_rep.add_argument("--seed", type=int, default=0,
                       help="model-init seed: must match the recording "
                            "server's for byte-exactness without a "
                            "checkpoint")

    for name in UNPORTED:
        sub.add_parser(name, help=f"not ported (ROADMAP {UNPORTED[name]})")

    return parser


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    prog = "solvingpapers_tpu_torch"
    if argv and argv[0] in UNPORTED:  # whatever flags follow
        print(f"{prog} {argv[0]}: not ported yet (ROADMAP "
              f"{UNPORTED[argv[0]]})", file=sys.stderr)
        return 2
    refused = {"serve": SERVE_UNPORTED, "serve-bench": BENCH_UNPORTED,
               "replay": REPLAY_UNPORTED}
    if argv and argv[0] in refused:
        for arg in argv[1:]:
            flag = arg.split("=", 1)[0]
            if flag in refused[argv[0]]:
                print(f"{prog} {argv[0]} {flag}: not ported yet (ROADMAP "
                      f"{refused[argv[0]][flag]})", file=sys.stderr)
                return 2
    parser = build_parser()
    args = parser.parse_args(argv)
    run = {"list": cmd_list, "train": cmd_train, "sample": cmd_sample,
           "eval": cmd_eval, "export": cmd_export, "serve": cmd_serve,
           "serve-bench": cmd_serve_bench, "replay": cmd_replay,
           "trace-summary": cmd_trace_summary}[args.cmd]
    try:
        return run(args)
    except (Refused, NotImplementedError) as e:
        print(f"{parser.prog} {args.cmd}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
