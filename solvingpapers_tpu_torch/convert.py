"""Carries weights from the JAX package to the port.

`flax_to_torch` takes a Flax `params` tree as a nested dict of NUMPY
arrays (a caller holding JAX arrays converts first, e.g.
``jax.tree.map(np.asarray, params)``; the port itself never imports
jax) and returns the port's state dict of float32 CPU tensors, ready for
``model.load_state_dict`` (which casts to the model's dtypes and moves
to its device).

Mapping (Flax path -> port name):

    tok_emb/embedding (V, D)             -> tok_emb.weight
    block_i/attn/q/kernel (D, N·H)       -> blocks.i.attn.q.weight (transposed)
    block_i/attn/kv/kernel (D, 2·Nkv·H)  -> blocks.i.attn.{k,v}.weight: split
                                            on the last axis, k first
    block_i/attn/qkv/kernel (D, 3·N·H)   -> blocks.i.attn.{q,k,v}.weight: MHA's
                                            fused projection, split in thirds
    block_i/attn/out/kernel              -> blocks.i.attn.out.weight
    block_i/{attn_norm,ffn_norm}/weight  -> blocks.i.{attn_norm,ffn_norm}.weight
    block_i/ffn/{gate,up,down}/kernel    -> blocks.i.ffn.{gate,up,down}.weight
    norm_f/weight                        -> norm_f.weight
    lm_head/kernel (D, V)                -> lm_head.weight

Every Dense `kernel` (in, out) becomes a `weight` (out, in); a Dense
`bias` keeps its shape and is split like its kernel.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_SPLITS = {"kv": ("k", "v"), "qkv": ("q", "k", "v")}


def _dense(prefix: str, node: dict, out: dict) -> None:
    out[prefix + ".weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(node["kernel"], np.float32).T)
    )
    if "bias" in node:
        out[prefix + ".bias"] = torch.from_numpy(np.asarray(node["bias"], np.float32))


def _split_dense(parent: str, names, node: dict, out: dict) -> None:
    kernel = np.asarray(node["kernel"], np.float32)
    parts = np.split(kernel, len(names), axis=-1)
    biases = (np.split(np.asarray(node["bias"], np.float32), len(names))
              if "bias" in node else [None] * len(names))
    for name, k, bias in zip(names, parts, biases):
        sub = {"kernel": k} if bias is None else {"kernel": k, "bias": bias}
        _dense(f"{parent}.{name}" if parent else name, sub, out)


def _walk(prefix: str, node: dict, out: dict) -> None:
    for key, child in node.items():
        name = re.sub(r"^block_(\d+)$", r"blocks.\1", key)
        path = f"{prefix}.{name}" if prefix else name
        if not hasattr(child, "items"):
            if key == "embedding":
                out[f"{prefix}.weight"] = torch.from_numpy(
                    np.asarray(child, np.float32).copy())
            elif key == "weight":  # norm scale
                out[path] = torch.from_numpy(np.asarray(child, np.float32).copy())
            else:
                raise KeyError(f"unmapped Flax param {path!r}")
        elif "kernel" in child:
            if key in _SPLITS:
                _split_dense(prefix, _SPLITS[key], child, out)
            else:
                _dense(path, child, out)
        else:
            _walk(path, child, out)


def flax_to_torch(params: dict) -> dict[str, torch.Tensor]:
    """Flax params (nested dict of numpy arrays) -> the port's state dict."""
    out: dict[str, torch.Tensor] = {}
    _walk("", params, out)
    return out
