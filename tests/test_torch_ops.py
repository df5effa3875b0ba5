"""Port ops vs the JAX package's ops on the same numpy inputs.

Float32 throughout; values agree to rtol 1e-5 / atol 1e-6 (the two
frameworks sum in different orders), and the sampling masks — which
tokens survive — must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu import ops as jops
from solvingpapers_tpu_torch import ops as tops
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)


RTOL, ATOL = 1e-5, 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("with_weight", [True, False])
def test_rms_norm(with_weight):
    r = _rng(1)
    x = r.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = r.standard_normal(64).astype(np.float32) if with_weight else None
    t = tops.rms_norm(torch.from_numpy(x),
                      None if w is None else torch.from_numpy(w))
    j = jops.rms_norm(jnp.asarray(x), None if w is None else jnp.asarray(w))
    _close(t, j)


def test_rms_norm_keeps_bf16_input_dtype():
    x = torch.randn(2, 8, 32).to(torch.bfloat16)
    assert tops.rms_norm(x, torch.ones(32)).dtype == torch.bfloat16


def test_silu():
    x = _rng(2).standard_normal((4, 33)).astype(np.float32) * 4
    _close(tops.silu(torch.from_numpy(x)), jops.silu(jnp.asarray(x)))


def test_rope_tables():
    tc, ts = tops.precompute_rope(32, 200, theta=10000.0)
    jc, js = jops.precompute_rope(32, 200, theta=10000.0)
    _close(tc, jc)
    _close(ts, js)


@pytest.mark.parametrize("explicit_positions", [False, True])
def test_apply_rope_interleaved(explicit_positions):
    r = _rng(3)
    x = r.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = r.integers(0, 120, size=(2, 7))
    tc, ts = tops.precompute_rope(32, 128)
    jc, js = jops.precompute_rope(32, 128)
    t = tops.apply_rope(torch.from_numpy(x), tc, ts,
                        torch.from_numpy(pos) if explicit_positions else None)
    j = jops.apply_rope(jnp.asarray(x), jc, js,
                        jnp.asarray(pos) if explicit_positions else None)
    _close(t, j)


def test_rope_pairs_are_interleaved_not_half_split():
    # position 1 rotates the pair (x0, x1) — the half-split convention
    # would pair (x0, x16) instead
    tc, ts = tops.precompute_rope(32, 4)
    x = torch.zeros(1, 2, 1, 32)
    x[0, 1, 0, 0] = 1.0
    out = tops.apply_rope(x, tc, ts)
    assert out[0, 1, 0, 1].item() == pytest.approx(np.sin(1.0), abs=1e-6)
    assert out[0, 1, 0, 16].item() == 0.0


def test_repeat_kv_and_causal_mask():
    x = _rng(4).standard_normal((2, 5, 2, 8)).astype(np.float32)
    _close(tops.repeat_kv(torch.from_numpy(x), 3),
           jops.repeat_kv(jnp.asarray(x), 3), rtol=0, atol=0)
    for q_len, kv_len in [(4, 4), (3, 9), (6, 2)]:
        np.testing.assert_array_equal(
            tops.causal_mask(q_len, kv_len).numpy(),
            np.asarray(jops.causal_mask(q_len, kv_len)),
        )


@pytest.mark.parametrize(
    "sq,skv,n,n_kv,causal,masked",
    [
        (6, 6, 4, 4, True, False),    # MHA causal
        (5, 11, 4, 2, True, False),   # GQA, end-aligned causal (Sq < Skv)
        (5, 5, 4, 1, False, False),   # MQA bidirectional
        (1, 16, 4, 2, False, True),   # decode: explicit position mask
    ],
)
def test_dot_product_attention(sq, skv, n, n_kv, causal, masked):
    r = _rng(5)
    q = r.standard_normal((2, sq, n, 16)).astype(np.float32)
    k = r.standard_normal((2, skv, n_kv, 16)).astype(np.float32)
    v = r.standard_normal((2, skv, n_kv, 16)).astype(np.float32)
    mask = None
    if masked:
        pos = np.asarray([[3], [11]])
        mask = np.arange(skv)[None, None, None, :] <= pos[:, None, :, None]
    t = tops.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), causal=causal)
    j = jops.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), causal=causal)
    _close(t, j)


def _logits(seed, rows=6, vocab=40):
    return _rng(seed).standard_normal((rows, vocab)).astype(np.float32) * 2


def _same_mask(t, j):
    t, j = t.numpy(), np.asarray(j)
    np.testing.assert_array_equal(np.isneginf(t), np.isneginf(j))
    keep = ~np.isneginf(j)
    np.testing.assert_array_equal(t[keep], j[keep])


def test_top_k_mask_per_row_and_disabled():
    x = _logits(6)
    k = np.asarray([[0], [1], [3], [7], [40], [50]])
    _same_mask(tops.top_k_mask(torch.from_numpy(x), torch.from_numpy(k)),
               jops.top_k_mask(jnp.asarray(x), jnp.asarray(k)))
    _same_mask(tops.top_k_mask(torch.from_numpy(x), 5),
               jops.top_k_mask(jnp.asarray(x), 5))


def test_top_p_mask_per_row():
    x = _logits(7)
    p = np.asarray([[1.0], [0.9], [0.5], [0.2], [0.05], [0.999]], np.float32)
    _same_mask(tops.top_p_mask(torch.from_numpy(x), torch.from_numpy(p)),
               jops.top_p_mask(jnp.asarray(x), jnp.asarray(p)))


def test_min_p_mask_per_row():
    x = _logits(8)
    mp = np.asarray([[0.0], [0.05], [0.1], [0.3], [0.9], [1.0]], np.float32)
    _same_mask(tops.min_p_mask(torch.from_numpy(x), torch.from_numpy(mp)),
               jops.min_p_mask(jnp.asarray(x), jnp.asarray(mp)))


def test_sample_greedy_takes_first_maximum():
    x = np.asarray([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0],
                    [-1.0, -2.0, -1.0, -3.0]], np.float32)
    np.testing.assert_array_equal(
        tops.sample_greedy(torch.from_numpy(x)).numpy(),
        np.asarray(jops.sample_greedy(jnp.asarray(x))),
    )
    assert tops.sample_greedy(torch.from_numpy(x)).tolist() == [1, 0, 0]
