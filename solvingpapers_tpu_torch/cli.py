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
and a token table over the full vocab. SIGINT / SIGTERM shut it down in
order: drain streams, close the engine, stop the HTTP threads.

Not ported, refused with their ROADMAP items: `replay` and
`trace-summary` (A4), `serve-bench`, `kernel-bench` and `sample
--speculative` (A5), and the `serve` flags of the journal, fleet,
tracing, SLO and fault ladders (A4) and of the quantized pool and
speculative decoding (A5); image, KD and Gemma configs (A6) and pipeline
ones (A7) are not registered.
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
    "replay": "A4 (serve/replay.py)",
    "trace-summary": "A4 (metrics/trace.py)",
    "serve-bench": "A5 (serve/bench.py)",
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

    limit = getattr(model, "max_positions", None) or 512
    max_len = args.max_len or min(512, limit)
    return ServeConfig(
        n_slots=args.slots, max_len=max_len, decode_block=args.decode_block,
        bucket=min(args.bucket, max_len), sample_cap=args.sample_cap,
        paged=args.paged, api_port=args.port, api_host=args.host,
        api_max_connections=args.max_connections,
        json_mode=not args.no_json_mode,
        drain_timeout_s=args.drain_timeout, max_waiting=args.max_waiting)


# `serve` flags of the reference that the port refuses, with their items
SERVE_UNPORTED = {
    "--kv-quant": "A5 (the quantized KV pool)",
    "--kv-quant-block": "A5 (the quantized KV pool)",
    "--kv-exact-lanes": "A5 (the quantized KV pool)",
    "--speculative": "A5 (speculative decoding)",
    "--spec-k": "A5 (speculative decoding)",
    "--spec-rounds": "A5 (speculative decoding)",
    "--slo": "A4 (SLO accounting)",
    "--degrade": "A4 (the degradation ladder)",
    "--step-deadline": "A4 (the step watchdog)",
    "--journal": "A4 (the request journal)",
    "--journal-strict": "A4 (the request journal)",
    "--replicas": "A4 (fleet routing)",
    "--trace": "A4 (request tracing)",
    "--trace-out": "A4 (request tracing)",
    "--timeseries-interval": "A4 (the time-series store)",
    "--timeseries-capacity": "A4 (the time-series store)",
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
    engine = ServeEngine(model, _serve_config(args, model), device=device,
                         detokenize=decode)
    server = ApiServer(engine, encode=encode, decode=decode, token_table=table,
                       model_name=args.config)
    print(f"[serve] {args.config} on http://{server.host}:{server.port} — "
          "POST /v1/completions /v1/chat/completions, GET /v1/models "
          "/healthz /metrics /statusz", file=sys.stderr, flush=True)
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
    return 0


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
    if argv and argv[0] == "serve":
        for arg in argv[1:]:
            flag = arg.split("=", 1)[0]
            if flag in SERVE_UNPORTED:
                print(f"{prog} serve {flag}: not ported yet (ROADMAP "
                      f"{SERVE_UNPORTED[flag]})", file=sys.stderr)
                return 2
    parser = build_parser()
    args = parser.parse_args(argv)
    run = {"list": cmd_list, "train": cmd_train, "sample": cmd_sample,
           "eval": cmd_eval, "export": cmd_export, "serve": cmd_serve}[args.cmd]
    try:
        return run(args)
    except (Refused, NotImplementedError) as e:
        print(f"{parser.prog} {args.cmd}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
