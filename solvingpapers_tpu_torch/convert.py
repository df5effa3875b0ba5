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

GPT (its attention is MHA, so `qkv` above, with biases):

    pos_emb (block_size, D)              -> pos_emb
    block_i/{ln1,ln2}/{weight,bias}      -> blocks.i.{ln1,ln2}.{weight,bias}
    block_i/mlp/{fc,proj}/{kernel,bias}  -> blocks.i.mlp.{fc,proj}.{weight,bias}
    ln_f/{weight,bias}                   -> ln_f.{weight,bias}

DeepSeek-V3 (`layer_i` -> `layers.i`; the raw einsum weights keep their
Flax shapes):

    layer_i/{norm1,norm2}/weight         -> layers.i.{norm1,norm2}.weight
    layer_i/mla/{w_dkv,w_kr,out}/kernel  -> layers.i.mla.{...}.weight
    layer_i/mla/w_q (D, N, H), w_k and w_v (L, N, H), w_qr (D, N, R)
                                         -> layers.i.mla.{w_q,w_k,w_v,w_qr}
    layer_i/moe/gate/kernel (D, E)       -> layers.i.moe.gate.weight
    layer_i/moe/w1, w2 (E, D, H), w3 (E, H, D)
                                         -> layers.i.moe.{w1,w2,w3}
    layer_i/moe/shared_expert/{gate,up,down}/kernel
                                         -> layers.i.moe.shared_expert.{...}.weight
    layer_i/moe/noise/kernel (D, E)      -> layers.i.moe.noise.weight (noisy_topk)
    moe_state layer_i/moe/routing_bias (E,)
                                         -> layers.i.moe.routing_bias (buffer)

    Its MTP heads (k = 1..mtp_heads) keep their Flax names:
    mtp_norm_{h,e}_k/{weight,bias}       -> mtp_norm_{h,e}_k.{weight,bias}
    mtp_{merge,proj}_k/kernel            -> mtp_{merge,proj}_k.weight
    mtp_layer_k/...                      -> mtp_layer_k.... (a decoder layer,
                                            mapped as layer_i above, its
                                            moe_state routing bias included)

Every Dense `kernel` (in, out) becomes a `weight` (out, in); a Dense
`bias` keeps its shape and is split like its kernel.

Quantized KV state (`ServeConfig.kv_quant`): `quant_store_from_reference`
and `quant_segment_from_reference` carry the reference's `QuantStore` /
`QuantSegment` (their leaves as numpy arrays, e.g. ``jax.tree.map(
np.asarray, store)``) into the port's `serve.kv_pool` classes: each
layer's cache node becomes the port's cache class of the same name
(`KVCache` k/v, `LatentCache` c), tensors keep their dtype (bfloat16
included) and land on `device`.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

_SPLITS = {"kv": ("k", "v"), "qkv": ("q", "k", "v")}
# leaves that keep their Flax shape: the MLA and expert einsum weights, the
# MoE routing bias and GPT's position table
_RAW = {"w_q", "w_k", "w_v", "w_qr", "w1", "w2", "w3", "routing_bias", "pos_emb"}


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
        name = re.sub(r"^layer_(\d+)$", r"layers.\1", name)
        path = f"{prefix}.{name}" if prefix else name
        if not hasattr(child, "items"):
            if key == "embedding":
                out[f"{prefix}.weight"] = torch.from_numpy(
                    np.asarray(child, np.float32).copy())
            elif key in ("weight", "bias") or key in _RAW:  # norm, einsum weight
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


def flax_to_torch(params: dict, model_state: dict | None = None
                  ) -> dict[str, torch.Tensor]:
    """Flax params (nested dict of numpy arrays) -> the port's state dict.
    `model_state`: DeepSeek-V3's non-trainable state, the `moe_state`
    collection (or a dict holding it under "moe_state"), whose routing
    biases join the state dict as buffers."""
    out: dict[str, torch.Tensor] = {}
    _walk("", params, out)
    if model_state is not None:
        _walk("", model_state.get("moe_state", model_state), out)
    return out


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "int8": torch.int8}


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (ml_dtypes' bfloat16 included) as a torch tensor."""
    a = np.ascontiguousarray(a)
    name = a.dtype.name
    if name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _caches(nodes, device) -> list:
    from solvingpapers_tpu_torch.infer import cache as port_cache

    return [getattr(port_cache, type(n).__name__)(**{
                f.name: _tensor(getattr(n, f.name), device)
                for f in dataclasses.fields(n)})
            for n in nodes]


def quant_store_from_reference(store, device="cpu"):
    """A reference `QuantStore` (numpy leaves) as the port's."""
    from solvingpapers_tpu_torch.serve.kv_pool import QuantStore

    return QuantStore(
        q=_caches(store.q, device), scale=_caches(store.scale, device),
        exact=None if store.exact is None else _caches(store.exact, device),
        block=int(store.block), dtype=_TORCH_DTYPES[np.dtype(store.dtype).name])


def quant_segment_from_reference(segment, device="cpu"):
    """A reference `QuantSegment` (numpy leaves) as the port's."""
    from solvingpapers_tpu_torch.serve.kv_pool import QuantSegment

    return QuantSegment(q=_caches(segment.q, device),
                        scale=_caches(segment.scale, device),
                        block=int(segment.block))
