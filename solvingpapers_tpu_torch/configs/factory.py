"""Build model / data / trainer objects from a RunConfig (port of the
GPT, LLaMA-3 and DeepSeek-V3 language-model part of
`solvingpapers_tpu/configs/factory.py`).

Corpora: a pre-tokenized token file (`data.kind == "tokens"`, with a
`.meta` sidecar), the Markov corpus (`source: "markov"`) and the char
corpus (`kind: "char"`: a local text file, else synthetic prose), the last
two with a char vocab the model is resized to. BPE corpora need the BPE
tokenizer (ROADMAP A3) and raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from solvingpapers_tpu_torch.configs.registry import RunConfig
from solvingpapers_tpu_torch.data import (
    CharTokenizer,
    lm_batch_iterator,
    load_char_corpus,
    load_token_file,
    markov_text,
    prefetch_batches,
    split_train_val,
    token_file_max_id,
)
from solvingpapers_tpu_torch.train import lm_loss_fn


def build_model(cfg: RunConfig, device=None, param_dtype=None):
    """The model of `cfg` on `device` (see `models.llama3.Llama` for
    `param_dtype`)."""
    if cfg.model_family == "llama3":
        from solvingpapers_tpu_torch.models.llama3 import Llama

        return Llama(cfg.model, device=device, param_dtype=param_dtype)
    if cfg.model_family == "deepseekv3":
        from solvingpapers_tpu_torch.models.deepseekv3 import DeepSeekV3

        return DeepSeekV3(cfg.model, device=device, param_dtype=param_dtype)
    if cfg.model_family == "gpt":
        from solvingpapers_tpu_torch.models.gpt import GPT

        return GPT(cfg.model, device=device, param_dtype=param_dtype)
    raise NotImplementedError(
        f"model family {cfg.model_family!r} is not ported yet (ROADMAP A2, A6)")


def loss_fn_for(cfg: RunConfig):
    """Objective for a RunConfig's family (the LM families only)."""
    if cfg.model_family in ("gpt", "llama3"):
        return lm_loss_fn
    if cfg.model_family == "deepseekv3":
        from solvingpapers_tpu_torch.train.objectives import dsv3_loss_fn

        return dsv3_loss_fn
    raise NotImplementedError(
        f"no objective ported for model family {cfg.model_family!r}")


class IdTokenizer:
    """Ids-only tokenizer of a token-file run: prompts are
    space-separated integer ids (the text tokenizer that wrote the file
    is not reconstructable)."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, s: str) -> np.ndarray:
        try:
            return np.asarray([int(t) for t in s.split()], np.int32)
        except ValueError:
            raise RuntimeError(
                "token-file runs carry no text tokenizer; prompts must be "
                f"space-separated integer ids, got {s!r}") from None

    def decode(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)


def build_char_lm_run(cfg: RunConfig, device=None):
    """Returns (cfg with the corpus's vocab, model, tokenizer, train_iter,
    eval_iter_fn) for an LM run; the model is built for training (float32
    master weights) on `device`."""
    data = cfg.data
    if data.get("kind") == "bpe":
        raise NotImplementedError(
            "data kind 'bpe' is not ported yet: the BPE tokenizer comes with "
            "ROADMAP A3; the port trains from token files (kind 'tokens') and "
            "the char and Markov corpora")
    if data.get("kind") == "tokens":
        path = data["path"]
        toks = load_token_file(path)
        max_id = token_file_max_id(path, toks)
        if max_id >= cfg.model.vocab_size:
            raise ValueError(
                f"token file {path} holds id {max_id} but model.vocab_size is "
                f"{cfg.model.vocab_size}; it must match the writing tokenizer")
        tok = IdTokenizer(cfg.model.vocab_size)
        train_toks, val_toks = split_train_val(toks)
    elif data.get("source") == "markov":
        # entropy-calibrated corpus: its chain's entropy rate is the
        # val-loss target (data.synthetic.markov_entropy_nats)
        text = markov_text(data)
        tok = CharTokenizer(text)
        train_toks, val_toks = split_train_val(tok.encode(text))
    elif data.get("kind") == "char":
        tok, train_toks, val_toks = load_char_corpus(path=data.get("path"))
    else:
        raise ValueError(f"unknown data kind {data.get('kind')!r}")
    block = data.get("block_size", 256)
    # the char vocab comes from the corpus; resize the model to match
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model,
                                       vocab_size=max(tok.vocab_size, 2)))
    model = build_model(cfg, device=device, param_dtype=torch.float32)
    bsz = cfg.train.batch_size
    train_iter = lm_batch_iterator(train_toks, bsz, block, seed=cfg.train.seed)
    if isinstance(train_toks, np.memmap):
        # host-side gathers overlap the device step
        train_iter = prefetch_batches(train_iter, depth=2)

    def eval_iter_fn():
        return lm_batch_iterator(val_toks, bsz, block, seed=10_000)

    return cfg, model, tok, train_iter, eval_iter_fn
