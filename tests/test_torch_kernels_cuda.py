"""The port's hand-written kernels on the card, against their plain
versions on the same inputs.

These tests need an NVIDIA card (marker `cuda`) and skip elsewhere. The
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

(`--noconftest` skips `tests/conftest.py`, which sets up JAX's CPU mesh.)
Tolerances: bf16 inputs within 2e-2 on o and 1e-3 on lse of the float32
plain version, float32 within 1e-4.
"""

import importlib

import numpy as np
import pytest
import torch

tfa = importlib.import_module("solvingpapers_tpu_torch.kernels.flash_attention")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is CUDA C++ for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(seed, b, sq, skv, n, n_kv, d):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, sq, n, d)).astype(np.float32),
            r.standard_normal((b, skv, n_kv, d)).astype(np.float32),
            r.standard_normal((b, skv, n_kv, d)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,n,n_kv,d,causal,dtype", [
    (1, 128, 1152, 16, 8, 64, True, torch.bfloat16),
    (1, 2048, 2048, 16, 8, 64, True, torch.bfloat16),
    (2, 256, 384, 16, 8, 64, False, torch.bfloat16),
    (1, 96, 32, 4, 2, 128, True, torch.float32),
    (2, 37, 100, 4, 4, 64, False, torch.float32),
    (1, 37, 100, 4, 2, 64, True, torch.float32),
])
def test_flash_kernel_matches_reference(cuda_device, b, sq, skv, n, n_kv, d,
                                        causal, dtype):
    q, k, v = (torch.from_numpy(x).to(cuda_device, dtype)
               for x in _qkv(7, b, sq, skv, n, n_kv, d))
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    ro, rlse = tfa.flash_attention_reference(q.float(), k.float(), v.float(),
                                             causal=causal)
    o_tol, lse_tol = (2e-2, 1e-3) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    assert (o.float() - ro).abs().max().item() <= o_tol
    assert (lse - rlse).abs().max().item() <= lse_tol


@pytest.mark.cuda
def test_flash_kernel_reads_a_strided_cache_slice(cuda_device):
    """The prefill passes k/v as the first `attend_len` positions of the
    pooled cache (sequence-sliced, so batch-strided): the kernel reads
    them without a copy."""
    pool = torch.randn(3, 64, 2, 64, device=cuda_device)
    k = pool[:, :40]
    v = pool.flip(0)[:, :40]
    q = torch.randn(3, 16, 4, 64, device=cuda_device)
    assert not k.is_contiguous() and not v.is_contiguous()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = tfa.flash_attention_reference(q, k.contiguous(),
                                             v.contiguous(), causal=True)
    assert (o - ro).abs().max().item() <= 1e-4
    assert (lse - rlse).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_flash_kernel_copies_rows_off_16_byte_boundaries(cuda_device):
    """The bf16 kernel moves rows as 16-byte chunks: a view that starts
    off a 16-byte boundary is copied first, never read misaligned."""
    shape = (1, 40, 4, 64)
    flat = torch.randn(2 * 40 * 4 * 64, device=cuda_device, dtype=torch.bfloat16)
    q = flat[1:1 + 40 * 4 * 64].view(shape)
    assert q.data_ptr() % 16
    k = torch.randn(1, 40, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    o, lse = tfa.flash_attention_fwd(q, k, k, causal=True)
    ro, rlse = tfa.flash_attention_reference(q.float(), k.float(), k.float(),
                                             causal=True)
    assert (o.float() - ro).abs().max().item() <= 2e-2
    assert (lse - rlse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "head_dim", "stride", "device"])
def test_flash_kernel_rejects_what_it_does_not_take(cuda_device, bad):
    q = torch.randn(1, 8, 2, 64, device=cuda_device)
    k = torch.randn(1, 8, 2, 64, device=cuda_device)
    if bad == "dtype":
        q, k = q.half(), k.half()
    elif bad == "head_dim":
        q, k = q[..., :32], k[..., :32].contiguous()
        q = q.contiguous()
    elif bad == "stride":
        q = torch.randn(1, 8, 2, 128, device=cuda_device)[..., ::2]
        k = k.contiguous()
    elif bad == "device":
        k = k.cpu()
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, k, k, causal=True)
