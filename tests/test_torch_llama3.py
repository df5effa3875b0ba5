"""The port's LLaMA-3 vs the JAX package's, on the same weights.

A tiny `use_flash=True` model (2 layers, dim 64, 4 q / 2 kv heads,
vocab 256, float32) is initialised in JAX, carried across with
`convert.flax_to_torch`, and both sides run the same numpy-made tokens
through the three non-context-parallel attention modes: the uncached
full forward (flash), the chunked cached prefill with `attend_len`
(flash, end-aligned) and the single-token cached decode (dense, masked
by position). The JAX flash kernel runs in interpret mode, as the JAX
package's own tests run it. Logits agree to rtol/atol 1e-4 (float32,
different summation orders compounded over two layers and a 256-way
head); cache contents to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu.infer.cache import KVCache as JKVCache
from solvingpapers_tpu.infer.cache import update_kv_cache as j_update
from solvingpapers_tpu.models.llama3 import Llama as JLlama
from solvingpapers_tpu.models.llama3 import LlamaConfig as JLlamaConfig
from solvingpapers_tpu_torch.configs import dense_twin, get_config, list_configs
from solvingpapers_tpu_torch.convert import flax_to_torch
from solvingpapers_tpu_torch.infer.cache import KVCache, update_kv_cache
from solvingpapers_tpu_torch.models import Llama, LlamaConfig, init_params
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)


TOL = 1e-4
TINY = dict(vocab_size=256, max_seq_len=64, dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2, dtype="float32", use_flash=True)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, torch model) sharing one set of weights."""
    jm = JLlama(JLlamaConfig(**TINY))
    params = jm.init({"params": jax.random.key(0)},
                     jnp.zeros((1, 8), jnp.int32))["params"]
    tm = Llama(LlamaConfig(**TINY), device="cpu")
    tm.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 256, size=(b, s))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def test_convert_covers_every_parameter(pair):
    _, params, tm = pair
    sd = flax_to_torch(jax.tree.map(np.asarray, params))
    assert set(sd) == set(tm.state_dict())
    # kv splits on its last axis, k first; kernels transpose to (out, in)
    kv = np.asarray(params["block_0"]["attn"]["kv"]["kernel"])
    np.testing.assert_array_equal(sd["blocks.0.attn.k.weight"].numpy(),
                                  kv[:, :32].T)
    np.testing.assert_array_equal(sd["blocks.0.attn.v.weight"].numpy(),
                                  kv[:, 32:].T)


def test_convert_splits_fused_mha_qkv():
    """MHA's fused `qkv` Dense (bias included) splits in thirds."""
    r = np.random.default_rng(0)
    kernel = r.standard_normal((8, 24)).astype(np.float32)
    bias = r.standard_normal(24).astype(np.float32)
    sd = flax_to_torch({"block_0": {"attn": {"qkv": {"kernel": kernel,
                                                     "bias": bias}}}})
    for i, name in enumerate("qkv"):
        np.testing.assert_array_equal(
            sd[f"blocks.0.attn.{name}.weight"].numpy(),
            kernel[:, 8 * i:8 * (i + 1)].T)
        np.testing.assert_array_equal(sd[f"blocks.0.attn.{name}.bias"].numpy(),
                                      bias[8 * i:8 * (i + 1)])


def test_convert_rejects_unknown_leaves():
    with pytest.raises(KeyError, match="unmapped"):
        flax_to_torch({"block_0": {"attn": {"scale": np.ones(3)}}})


def test_full_forward_logits(pair):
    jm, params, tm = pair
    toks = _tokens(1, 2, 24)
    jl, _ = jm.apply({"params": params}, jnp.asarray(toks))
    with torch.no_grad():
        tl, _ = tm(torch.from_numpy(toks))
    _close(tl, jl)


def test_chunked_cached_prefill_then_decode(pair):
    """Prefill 24 tokens in chunks [0, 10) and [10, 24) with attend_len
    10 and 24 (end-aligned flash), then two single-token decode steps:
    logits and cache contents match the JAX package at every call."""
    jm, params, tm = pair
    # jitted: the reference as the JAX package runs it, where an eager call
    # steps the interpret-mode flash kernel's grid op by op
    apply = jax.jit(jm.apply, static_argnames=("attend_len",))
    toks = _tokens(2, 2, 26)
    jc = jm.init_caches(2, 40)
    tc = tm.init_caches(2, 40)
    with torch.no_grad():
        for start, end in [(0, 10), (10, 24)]:
            pos = np.broadcast_to(np.arange(start, end), (2, end - start))
            jl, jc = apply({"params": params}, jnp.asarray(toks[:, start:end]),
                           positions=jnp.asarray(pos), caches=jc,
                           attend_len=end)
            tl, tc = tm(torch.from_numpy(toks[:, start:end]),
                        positions=torch.from_numpy(pos.copy()), caches=tc,
                        attend_len=end)
            _close(tl, jl)
        for pos in (24, 25):
            p = np.full((2, 1), pos)
            jl, jc = apply({"params": params}, jnp.asarray(toks[:, pos:pos + 1]),
                           positions=jnp.asarray(p), caches=jc)
            tl, tc = tm(torch.from_numpy(toks[:, pos:pos + 1]),
                        positions=torch.from_numpy(p), caches=tc)
            _close(tl, jl)
    for t, j in zip(tc, jc):
        _close(t.k[:, :26], j.k[:, :26], 1e-5)
        _close(t.v[:, :26], j.v[:, :26], 1e-5)


def test_decode_rows_at_their_own_positions(pair):
    """The serving decode runs one batch over slots at different
    positions: each row writes and attends at its own position, exactly
    as that row would alone (the reference gets this from vmap)."""
    _, _, tm = pair
    toks = _tokens(3, 2, 20)
    lens = [12, 7]
    caches = tm.init_caches(2, 32)
    singles = []
    with torch.no_grad():
        for row, n in enumerate(lens):
            lane = [KVCache(k=c.k[row:row + 1], v=c.v[row:row + 1]) for c in caches]
            tm(torch.from_numpy(toks[row:row + 1, :n]),
               positions=torch.arange(n)[None], caches=lane, attend_len=n)
            one = tm.init_caches(1, 32)
            tm(torch.from_numpy(toks[row:row + 1, :n]),
               positions=torch.arange(n)[None], caches=one, attend_len=n)
            lo, _ = tm(torch.from_numpy(toks[row:row + 1, n:n + 1]),
                       positions=torch.tensor([[n]]), caches=one)
            singles.append(lo[0, 0])
        batch_tok = torch.tensor([[toks[0, 12]], [toks[1, 7]]])
        bl, _ = tm(batch_tok, positions=torch.tensor([[12], [7]]), caches=caches)
    for row in range(2):
        np.testing.assert_allclose(bl[row, 0].numpy(), singles[row].numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("index", [0, 5, 9, 10, 14, 50, -3, -20])
def test_cache_write_clamps_like_dynamic_update_slice(index):
    """A write whose start would overrun the lane is clamped to
    [0, max_len - S], as `jax.lax.dynamic_update_slice` clamps it — a
    serving slot's discarded overshoot lands there, never out of range."""
    r = np.random.default_rng(4)
    k0 = r.standard_normal((2, 12, 2, 4)).astype(np.float32)
    v0 = r.standard_normal((2, 12, 2, 4)).astype(np.float32)
    kn = r.standard_normal((2, 3, 2, 4)).astype(np.float32)
    vn = r.standard_normal((2, 3, 2, 4)).astype(np.float32)
    j = j_update(JKVCache(k=jnp.asarray(k0), v=jnp.asarray(v0)),
                 jnp.asarray(kn), jnp.asarray(vn), index)
    t = update_kv_cache(KVCache(k=torch.from_numpy(k0.copy()),
                                v=torch.from_numpy(v0.copy())),
                        torch.from_numpy(kn), torch.from_numpy(vn), index)
    np.testing.assert_array_equal(t.k.numpy(), np.asarray(j.k))
    np.testing.assert_array_equal(t.v.numpy(), np.asarray(j.v))


def test_per_row_cache_write_clamps_each_row():
    """A (B,) tensor of starts clamps row by row, each row as the
    reference's vmapped batch-1 write would."""
    r = np.random.default_rng(5)
    k0 = r.standard_normal((3, 8, 1, 2)).astype(np.float32)
    kn = r.standard_normal((3, 1, 1, 2)).astype(np.float32)
    starts = np.asarray([2, 8, 11, -2])  # 8 and 11 overrun max_len 8
    k0 = np.concatenate([k0, k0[:1]])
    kn = np.concatenate([kn, kn[:1]])
    t = update_kv_cache(KVCache(k=torch.from_numpy(k0.copy()),
                                v=torch.from_numpy(k0.copy())),
                        torch.from_numpy(kn), torch.from_numpy(kn),
                        torch.from_numpy(starts))
    for row in range(4):
        j = jax.lax.dynamic_update_slice(jnp.asarray(k0[row:row + 1]),
                                         jnp.asarray(kn[row:row + 1]),
                                         (0, int(starts[row]), 0, 0))
        np.testing.assert_array_equal(t.k[row:row + 1].numpy(), np.asarray(j))


def test_bf16_forward_stays_near_float32(pair):
    """The bf16 model (weights rounded once at load, as Flax's
    `Dense(dtype=bf16)` rounds them at every call) tracks the float32
    logits within bf16 accuracy and returns bf16 logits."""
    _, params, tm = pair
    cfg = LlamaConfig(**{**TINY, "dtype": "bfloat16"})
    bm = Llama(cfg, device="cpu")
    bm.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    assert bm.lm_head.weight.dtype == torch.bfloat16
    assert bm.blocks[0].attn_norm.weight.dtype == torch.float32
    toks = torch.from_numpy(_tokens(6, 1, 16))
    with torch.no_grad():
        lb, _ = bm(toks)
        lf, _ = tm(toks)
    assert lb.dtype == torch.bfloat16
    err = (lb.float() - lf).abs().max().item()
    assert err < 0.05 * lf.abs().max().item()


def test_init_params_draws_flax_default_scales(pair):
    """`init_params` draws from the same distributions as a JAX init:
    per-tensor standard deviations agree within 15% at this size (the
    bits differ — the generators differ)."""
    _, params, _ = pair
    jsd = flax_to_torch(jax.tree.map(np.asarray, params))
    tsd = init_params(LlamaConfig(**TINY),
                      torch.Generator().manual_seed(0))
    assert set(tsd) == set(jsd)
    for name, j in jsd.items():
        t = tsd[name]
        assert t.shape == j.shape, name
        if name.endswith("norm.weight") or name == "norm_f.weight":
            assert torch.equal(t, torch.ones_like(t))
        else:
            assert t.std().item() == pytest.approx(j.std().item(), rel=0.15), name


def test_registry_entries_and_dense_twin():
    assert {"llama3_long", "llama3_long_smoke",
            "llama3_shakespeare"} <= set(list_configs())
    long = get_config("llama3_long").model
    assert (long.dim, long.n_layers, long.n_heads, long.n_kv_heads) == (1024, 16, 16, 8)
    assert long.head_dim == 64 and long.ffn_hidden == 2730
    assert long.use_flash and long.context_parallel
    assert long.vocab_size == 50257 and long.dtype == "bfloat16"
    twin = dense_twin(get_config("llama3_long")).model
    assert not twin.context_parallel and twin.use_flash
    with pytest.raises(NotImplementedError, match="dense twin"):
        Llama(LlamaConfig(**{**TINY, "context_parallel": True}), device="cpu")
    with pytest.raises(KeyError):
        get_config("nope")
