"""The port's int8 KV quantization (`solvingpapers_tpu_torch/ops/quant.py`)
against the JAX package's `ops/quant.py`.

Byte parity: on the same f32 input (numpy, seeded), `quantize` gives the
reference's int8 codes and f32 scales byte for byte, `dequantize` its
values in float32 and bfloat16, and the tree forms both over the port's
per-layer cache lists (`KVCache` 4-D, `LatentCache` 3-D). The JAX
functions run eagerly, as their own tests call them (under `jax.jit`, XLA
turns ``absmax / 127`` into a product with the reciprocal, one ulp off in
a few scales; the port keeps the division the reference's source
states).

Properties, the reference's `tests/test_quant.py` as parametrised cases:
the round-trip error within half a scale step, a block's absmax entry at
exactly +-127, requantizing a dequantized block a fixed point, all-zero
blocks exact, the scale shapes of the lane and page layouts, and the
symmetric code space (-128 never used).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from solvingpapers_tpu.infer.cache import KVCache as JKVCache
from solvingpapers_tpu.infer.cache import LatentCache as JLatentCache
from solvingpapers_tpu.ops import quant as jq
from solvingpapers_tpu_torch.infer import KVCache, LatentCache
from solvingpapers_tpu_torch.ops.quant import (
    dequantize,
    dequantize_tree,
    quantize,
    quantize_tree,
    scale_shape,
)
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)

LAYOUTS = [((2, 64, 4, 8), 16), ((3, 32, 12), 8), ((1, 48, 2, 16), 48),
           ((5, 16, 2, 8), 16)]
LAYOUT_IDS = ["kv-lane", "latent-lane", "kv-one-block", "kv-page"]


def _leaf(shape, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, scale, size=shape).astype(np.float32)


# ------------------------------------------------------------ byte parity


@pytest.mark.parametrize("shape,block", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("magnitude", [1e-3, 3.0, 93.7, 1e4])
def test_codes_and_scales_byte_equal_the_reference(shape, block, magnitude):
    x = _leaf(shape, seed=int(magnitude * 7) % 97, scale=magnitude)
    x[0, :block] = 0.0  # an all-zero block beside live ones
    jcodes, jscale = jq.quantize(jnp.asarray(x), block)
    q, s = quantize(torch.from_numpy(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jcodes))
    assert s.numpy().tobytes() == np.asarray(jscale).tobytes()


@pytest.mark.parametrize("shape,block", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_equals_the_reference(shape, block, dtype):
    x = _leaf(shape, seed=1)
    jcodes, jscale = jq.quantize(jnp.asarray(x), block)
    q, s = quantize(torch.from_numpy(x), block)
    want = np.asarray(jq.dequantize(jcodes, jscale, getattr(jnp, dtype))
                      .astype(jnp.float32))
    got = dequantize(q, s, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_tree_forms_equal_the_reference_over_cache_lists():
    k, v, c = _leaf((2, 32, 2, 8), 2), _leaf((2, 32, 2, 8), 3), _leaf((2, 32, 24), 4)
    jtree = [JKVCache(k=jnp.asarray(k), v=jnp.asarray(v)),
             JLatentCache(c=jnp.asarray(c))]
    tree = [KVCache(k=torch.from_numpy(k), v=torch.from_numpy(v)),
            LatentCache(c=torch.from_numpy(c))]
    jqt, jst = jq.quantize_tree(jtree, 16)
    qt, st = quantize_tree(tree, 16)
    assert isinstance(qt[0], KVCache) and isinstance(st[1], LatentCache)
    for name, li in (("k", 0), ("v", 0), ("c", 1)):
        np.testing.assert_array_equal(getattr(qt[li], name).numpy(),
                                      np.asarray(getattr(jqt[li], name)))
        assert (getattr(st[li], name).numpy().tobytes()
                == np.asarray(getattr(jst[li], name)).tobytes())
    assert st[0].k.shape == (2, 2, 2) and st[1].c.shape == (2, 2)
    jdeq = jq.dequantize_tree(jqt, jst, jnp.float32)
    deq = dequantize_tree(qt, st, torch.float32)
    for name, li in (("k", 0), ("v", 0), ("c", 1)):
        np.testing.assert_array_equal(getattr(deq[li], name).numpy(),
                                      np.asarray(getattr(jdeq[li], name)))


# ------------------------------------------------------------- properties


def _block_scales(s: np.ndarray, shape, block) -> np.ndarray:
    b, t = shape[0], shape[1]
    nb = t // block
    if len(shape) == 4:
        full = np.broadcast_to(s[:, :, None, :, None],
                               (b, nb, block, shape[2], shape[3]))
    else:
        full = np.broadcast_to(s[:, :, None, None], (b, nb, block, shape[2]))
    return full.reshape(shape)


@pytest.mark.parametrize("shape,block", LAYOUTS, ids=LAYOUT_IDS)
def test_roundtrip_error_bounded_by_half_scale(shape, block):
    x = _leaf(shape, seed=5)
    q, s = quantize(torch.from_numpy(x), block)
    err = np.abs(x - dequantize(q, s).numpy())
    sfull = _block_scales(s.numpy(), shape, block)
    assert np.all(err <= sfull / 2 + 1e-6 * sfull + 1e-12)


def test_absmax_entries_map_to_pm127_exactly():
    x = _leaf((2, 32, 2, 8), seed=2)
    block = 8
    q, s = quantize(torch.from_numpy(x), block)
    xs = np.abs(x.reshape(2, 4, block, 2, 8)).transpose(0, 1, 3, 2, 4).reshape(2, 4, 2, -1)
    qs = np.abs(q.numpy().reshape(2, 4, block, 2, 8)).transpose(0, 1, 3, 2, 4).reshape(2, 4, 2, -1)
    picked = np.take_along_axis(qs, np.argmax(xs, axis=-1)[..., None], axis=-1)
    assert np.all(picked == 127)
    np.testing.assert_allclose(s.numpy(), xs.max(axis=-1) / 127.0, rtol=1e-6)


@pytest.mark.parametrize("shape,block", LAYOUTS, ids=LAYOUT_IDS)
def test_requantize_of_dequantized_block_is_fixed_point(shape, block):
    q, s = quantize(torch.from_numpy(_leaf(shape, seed=3)), block)
    q2, s2 = quantize(dequantize(q, s, torch.float32), block)
    np.testing.assert_array_equal(q.numpy(), q2.numpy())
    np.testing.assert_allclose(s.numpy(), s2.numpy(), rtol=1e-6)


def test_all_zero_blocks_roundtrip_exactly():
    x = torch.zeros((2, 32, 3, 4))
    q, s = quantize(x, 16)
    assert not q.any() and not s.any()
    deq = dequantize(q, s)
    assert not deq.any() and torch.isfinite(deq).all()
    x[:, 16:] = torch.from_numpy(_leaf((2, 16, 3, 4), seed=4))
    q, s = quantize(x, 16)
    assert not dequantize(q, s)[:, :16].any()


@pytest.mark.parametrize("shape,block,want", [
    ((8, 128, 4, 32), 16, (8, 8, 4)),
    ((8, 128, 96), 16, (8, 8)),
    ((65, 16, 4, 32), 16, (65, 1, 4)),
    ((65, 16, 96), 16, (65, 1)),
], ids=["kv-lane", "latent-lane", "kv-page", "latent-page"])
def test_scale_shapes_pinned_for_lane_and_page_layouts(shape, block, want):
    assert scale_shape(shape, block) == want == jq.scale_shape(shape, block)
    _, s = quantize(torch.from_numpy(_leaf(shape)), block)
    assert tuple(s.shape) == want and s.dtype == torch.float32


@pytest.mark.parametrize("shape", [(8, 100, 4, 32), (8, 100)],
                         ids=["block-does-not-tile", "not-a-cache-leaf"])
def test_scale_shape_rejects_bad_layouts(shape):
    with pytest.raises(ValueError):
        scale_shape(shape, 16)


def test_code_space_is_symmetric_and_views_take_the_dtype():
    x = _leaf((2, 32, 2, 8), seed=5, scale=50.0)
    q, s = quantize(torch.from_numpy(x), 8)
    assert int(q.min()) >= -127 and int(q.max()) <= 127
    assert dequantize(q, s, torch.bfloat16).dtype == torch.bfloat16
