"""What the bf16 flash forward decides in Python, walked on the CPU.

The sm_90a forward kernel reads q, k and v through TMA tensor maps built
from each tensor's own strides (`kernels.flash_attention.tma_strides`),
so the wrapper passes a tensor as it is whenever TMA can read it in place
and copies only one it cannot (`fwd_tma_inputs`). These tests check which
inputs pass and which are copied, and the (B, S, H) element strides the
kernel receives: a sequence slice of the serving cache (batch stride
max_len * Nkv * D; the kernel takes the slice's length as the S extent,
so TMA zero-fills past it), MLA's latent stream with one kv head, a
head-major q, a view whose rows start off 16-byte boundaries, and a
broadcast kv. The kernel that encodes the maps runs on the card
(`test_torch_kernels_cuda.py`).
"""

import importlib

import pytest
import torch

tfa = importlib.import_module("solvingpapers_tpu_torch.kernels.flash_attention")

BF16 = torch.bfloat16


def _contiguous_strides(b, s, h, d):
    """Element strides (B, S, H) of a contiguous (B, S, H, D) tensor."""
    return (s * h * d, h * d, d)


@pytest.mark.parametrize("batch,max_len,attend_len,n_kv,d", [
    (1, 4096, 2048, 8, 64),   # serving: the first 2048-token prefill chunk
    (1, 4096, 3000, 8, 64),   # a second chunk attends to 3000 positions
    (4, 4096, 128, 8, 64),    # the lane pool's four slots
    (2, 1000, 333, 2, 128),
])
def test_a_cache_slice_passes_as_it_is_with_its_own_strides(batch, max_len,
                                                             attend_len, n_kv,
                                                             d):
    cache = torch.zeros(batch, max_len, n_kv, d, dtype=BF16)
    k = cache[:, :attend_len]
    assert not k.is_contiguous() or batch == 1
    q = torch.zeros(batch, 64, 2 * n_kv, d, dtype=BF16)
    (q2, qs), (k2, ks), (v2, vs) = tfa.fwd_tma_inputs(q, k, k)
    assert q2 is q and k2 is k and v2 is k  # no copy
    assert ks == vs
    # one batch row is never stepped over: its stride is the slice's size
    batch_stride = max_len if batch > 1 else attend_len
    assert ks == (batch_stride * n_kv * d, n_kv * d, d)
    assert qs == _contiguous_strides(batch, 64, 2 * n_kv, d)


def test_mla_latent_stream_with_one_kv_head_passes_as_it_is():
    """MLA passes one (B, S, 1, L + R) view as k and v: its head axis has
    length 1, so its stride is never stepped over and the map takes a
    contiguous layout's instead (one row of D)."""
    latent = torch.zeros(1, 2048, 128, dtype=BF16)
    c_kv = latent[:, :, None, :]
    q = torch.zeros(1, 2048, 8, 128, dtype=BF16)
    (_, qs), (k2, ks), (v2, vs) = tfa.fwd_tma_inputs(q, c_kv, c_kv)
    assert k2 is c_kv and v2 is c_kv
    assert ks == vs == (2048 * 128, 128, 128)
    assert qs == _contiguous_strides(1, 2048, 8, 128)


@pytest.mark.parametrize("batch,max_len,attend_len", [
    (1, 8448, 8192),  # dsv3_long's last prefill chunk of an 8192-token prompt
    (1, 8448, 7000),  # attend_len no multiple of the tile
    (2, 8448, 2901),  # two lanes: the batch stride is the cache's
    (4, 8448, 129),
])
def test_a_latent_cache_slice_passes_as_it_is(batch, max_len, attend_len):
    """MLA's cached prefill passes ``c[:, :attend_len, None, :]`` of a
    `LatentCache` as both k and v: read in place, one kv head of D 128,
    the batch stride the cache's (a single row's is the slice's size)."""
    from solvingpapers_tpu_torch.infer import LatentCache

    cache = LatentCache.init(batch, max_len, 128, BF16)
    c_kv = cache.c[:, :attend_len, None, :]
    q = torch.zeros(batch, 2048, 8, 128, dtype=BF16)
    (_, qs), (k2, ks), (v2, vs) = tfa.fwd_tma_inputs(q, c_kv, c_kv)
    assert k2 is c_kv and v2 is c_kv  # no copy
    batch_stride = max_len if batch > 1 else attend_len
    assert ks == vs == (batch_stride * 128, 128, 128)
    assert qs == _contiguous_strides(batch, 2048, 8, 128)


def test_a_head_major_q_passes_as_it_is():
    """A (B, N, S, D) tensor viewed as (B, S, N, D): strides out of the
    usual order are still multiples of 16 bytes, so TMA reads it in
    place."""
    b, n, s, d = 2, 16, 300, 64
    q = torch.zeros(b, n, s, d, dtype=BF16).transpose(1, 2)
    assert tfa.tma_strides(q) == (n * s * d, d, s * d)


@pytest.mark.parametrize("case", ["base_off_16_bytes", "rows_off_16_bytes",
                                  "broadcast_kv"])
def test_what_tma_cannot_read_is_copied_contiguous(case):
    b, s, h, d = 1, 40, 4, 64
    if case == "base_off_16_bytes":
        x = torch.zeros(2 * s * h * d, dtype=BF16)[1:1 + s * h * d].view(b, s, h, d)
    elif case == "rows_off_16_bytes":
        x = torch.zeros(b, s, h, d + 4, dtype=BF16)[..., :d]  # 136-byte rows
    else:  # one kv head broadcast over h: stride 0 on an axis of length h
        x = torch.zeros(b, s, 1, d, dtype=BF16).expand(b, s, h, d)
    assert tfa.tma_strides(x) is None
    q = torch.zeros(b, s, h, d, dtype=BF16)
    (q2, _), (k2, ks), (v2, vs) = tfa.fwd_tma_inputs(q, x, x)
    assert q2 is q
    assert k2 is not x and k2.is_contiguous() and torch.equal(k2, x)
    assert v2 is not x and v2.is_contiguous()
    assert ks == vs == _contiguous_strides(b, s, h, d)


def test_an_axis_of_length_one_takes_a_valid_stride():
    """Size-1 axes may carry any stride in PyTorch (here 1 element, off
    16 bytes); the map replaces it, since TMA never steps over it."""
    x = torch.zeros(1, 8, 64, dtype=BF16).unsqueeze(0)  # (1, 1, 8, 64)
    x = x.as_strided((1, 1, 8, 64), (1, 1, 64, 1))
    assert tfa.tma_strides(x) == (8 * 64, 8 * 64, 64)


def test_strides_too_large_for_a_tensor_map_are_refused():
    """A tensor map's strides stay below 2**40 bytes: a view with a
    larger one (a meta tensor: no storage behind it) is copied instead."""
    x = torch.empty(64, dtype=BF16, device="meta").as_strided(
        (2, 1, 1, 64), (2**39, 64, 64, 1))  # 2**40 bytes
    assert tfa.tma_strides(x) is None
