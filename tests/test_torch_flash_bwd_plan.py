"""The bf16 backward kernels' work split, walked on the CPU.

`kernels.flash_attention.bwd_plan` decides how the sm_90a dq and dk/dv
kernels split their work (blocks per kv tile, fold or split of the GQA
group) and the order their output tiles launch in, which the kernels
read from the plan's tile tables. `_blocks` walks those tables as the
kernels do (block index -> tile, head, split; loop bounds and causal
skips) and lists, block by block in launch order, the (q head, 64-row q
tile, 64-row kv tile) pairs each computes. At every shape of
`chip_smoke.py`'s backward cases and at both training paths' shapes:
every pair with a visible element is computed exactly once, no hidden
pair is computed, and blocks come heaviest first. The fold of
float32 per-head partials equals the JAX package's fold in `_flash_bwd`
(`x.reshape(b, n_kv, group, seq_k, d).sum(axis=2)`) exactly.
"""

import importlib
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

tfa = importlib.import_module("solvingpapers_tpu_torch.kernels.flash_attention")

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TILE = tfa.BWD_TILE
# chip_smoke's backward cases hold the LLaMA path shape (path_8192)
SHAPES = ([pytest.param(*c[1:8], id=c[0]) for c in chip_smoke.BWD_CASES]
          + [pytest.param(*chip_smoke.DSV3_PATH, True, id="dsv3_path")])


def _blocks(plan, kernel):
    """The blocks of `kernel` ("dq" or "dkv") in launch order, each as the
    list of ``(b * N + h, q tile, kv tile)`` triples of TILE-row tiles its
    consumers compute: block i takes the plan's tile ``tiles[i //
    per_tile]``, and its consumers the loop bounds and skips of
    csrc/flash_bwd.cu."""
    rows = tfa.BWD_BLOCK_ROWS
    shape = (plan.sq, plan.skv, plan.causal)
    blocks = []
    if kernel == "dq":
        per_tile = plan.b * plan.n
        for i in range(plan.dq_blocks):
            q0 = plan.dq_tiles[i // per_tile] * rows
            blocks.append([
                (i % per_tile, qc // TILE, kt)
                for qc in range(q0, q0 + rows, TILE)
                for kt in range(-(-tfa._kv_end(*shape, qc, TILE) // TILE))])
        return blocks
    per_tile = plan.b * plan.n_kv * plan.splits
    heads = plan.group // plan.splits
    for i in range(plan.dkv_blocks):
        bkv, split = divmod(i % per_tile, plan.splits)
        b, kvh = divmod(bkv, plan.n_kv)
        kv0 = plan.dkv_tiles[i // per_tile] * rows
        h0 = kvh * plan.group + split * heads
        blocks.append([
            (b * plan.n + h, q0 // TILE, kvc // TILE)
            for h in range(h0, h0 + heads)
            for kvc in range(kv0, min(kv0 + rows, plan.skv), TILE)
            for q0 in range(tfa._first_live_q(*shape, kvc), plan.sq, TILE)])
    return blocks


def _visible_pairs(b, sq, skv, n, causal):
    """(b * N + h, q tile, kv tile) with at least one visible element."""
    offset = skv - sq
    pairs = set()
    for qt in range(-(-sq // TILE)):
        last = min(sq, (qt + 1) * TILE) - 1
        kv_end = min(skv, last + offset + 1) if causal else skv
        for kt in range(-(-max(kv_end, 0) // TILE)):
            pairs.update((bh, qt, kt) for bh in range(b * n))
    return pairs


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("b,sq,skv,n,n_kv,d,causal", SHAPES)
def test_plan_covers_every_visible_tile_pair_once_heaviest_first(
        b, sq, skv, n, n_kv, d, causal, kernel):
    plan = tfa.bwd_plan(b, sq, skv, n, n_kv, causal)
    tiles = plan.dq_tiles if kernel == "dq" else plan.dkv_tiles
    assert sorted(tiles) == list(range(-(-(sq if kernel == "dq" else skv)
                                         // tfa.BWD_BLOCK_ROWS)))
    blocks = _blocks(plan, kernel)
    computed = [pair for block in blocks for pair in block]
    assert len(computed) == len(set(computed))  # nothing twice
    assert set(computed) == _visible_pairs(b, sq, skv, n, causal)
    weights = [len(block) for block in blocks]
    assert weights == sorted(weights, reverse=True)


@pytest.mark.parametrize("shape,splits", [
    (chip_smoke.BWD_PATH, 1),    # LLaMA: 64 kv tiles x 16 = 1024 blocks
    (chip_smoke.DSV3_PATH, 8),   # DeepSeek-V3: 128 blocks folded, 1024 split
    ((1, 1000, 1000, 8, 1, 128), 8),
    ((4, 2112, 2112, 16, 8, 64), 1),  # 17 x 32 = 544 >= 4 x 132
    ((1, 4096, 4096, 16, 8, 64), 2),  # 32 x 8 = 256: one head a block
])
def test_plan_splits_the_gqa_group_only_when_the_card_would_starve(shape,
                                                                  splits):
    b, sq, skv, n, n_kv, _ = shape
    plan = tfa.bwd_plan(b, sq, skv, n, n_kv, True)
    assert plan.splits == splits
    assert plan.group % plan.splits == 0
    assert (plan.splits == 1) == (plan.dkv_blocks // plan.splits
                                  >= tfa.BWD_WAVES * tfa.H100_SMS)


@pytest.mark.parametrize("b,skv,n,n_kv,d", [(1, 97, 8, 1, 128), (2, 64, 16, 8, 64),
                                            (2, 33, 4, 2, 16)])
def test_fold_of_per_head_partials_equals_the_jax_fold_exactly(b, skv, n, n_kv,
                                                              d):
    group = n // n_kv
    r = np.random.default_rng(3)
    # per q head float32 grads of the repeated kv, wide in magnitude so
    # that another summation order would round differently
    per_head = (r.standard_normal((b, n, skv, d))
                * np.exp(r.uniform(-8, 8, (b, n, skv, d)))).astype(np.float32)
    # the JAX package's fold (_flash_bwd): (b * N, Skv, D) -> (b * Nkv, Skv, D)
    want = np.asarray(jnp.asarray(per_head.reshape(b * n, skv, d)).reshape(
        b, n_kv, group, skv, d).sum(axis=2).reshape(b * n_kv, skv, d))
    # the port's: one partial per split (one q head each), (splits, B, Skv,
    # Nkv, D) as the dk/dv kernel writes them, folded by the wrapper
    parts = torch.from_numpy(np.ascontiguousarray(
        per_head.reshape(b, n_kv, group, skv, d).transpose(2, 0, 3, 1, 4)))
    got = tfa.fold_partials(parts)  # (B, Skv, Nkv, D)
    got = got.permute(0, 2, 1, 3).reshape(b * n_kv, skv, d).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
