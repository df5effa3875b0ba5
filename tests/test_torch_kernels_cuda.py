"""The port's hand-written kernels on the card, against their plain
versions on the same inputs.

These tests need an NVIDIA card (marker `cuda`) and skip elsewhere. The
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

(`--noconftest` skips `tests/conftest.py`, which sets up JAX's CPU mesh.)
Tolerances: forward, bf16 inputs within 2e-2 on o and 1e-3 on lse of the
float32 plain version, float32 within 1e-4; backward, relative to the
largest gradient, bf16 within 1e-2 and float32 within 2e-5 — with and
without in-kernel dropout (the plain versions draw the same mask). The
dropout mask kernel's bits equal the plain keep function's exactly, and
the dropout apply kernel's outputs (forward and backward) the plain
dropout's, bit for bit, at its timed shapes, ragged sizes and unaligned
bases, and at every bf16 input and every float32 sign and significand
(at a sweep of divisors) against IEEE division. float32 head dims 16
and 32 and the bf16 forward at scales <= 0 (through `positive_scale`)
are held to the same limits.
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
    (1, 1000, 1300, 16, 8, 64, True, torch.bfloat16),  # not multiples of 64
    (2, 700, 700, 16, 8, 64, True, torch.bfloat16),    # B 2, GQA group 2
    (2, 333, 515, 16, 2, 64, True, torch.bfloat16),    # B 2, GQA group 8
    (1, 1, 1000, 16, 8, 64, True, torch.bfloat16),     # Sq 1
    (2, 1, 77, 8, 1, 128, False, torch.bfloat16),
    (1, 300, 100, 8, 2, 128, True, torch.bfloat16),    # empty rows
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
def test_flash_bf16_kernel_reads_a_cache_slice_in_place(cuda_device):
    """bf16 prefill over a sequence slice of a batch-2 cache (Skv > Sq):
    the kernel's tensor maps take the slice's strides, so the call
    allocates o and lse only, never a copy of k or v; two calls are
    bit-identical."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    cache_k, cache_v = (torch.randn(2, 4096, 8, 64, generator=g,
                                    device=cuda_device).bfloat16()
                        for _ in range(2))
    k, v = cache_k[:, :3072], cache_v[:, :3072]
    q = torch.randn(2, 512, 16, 64, generator=g, device=cuda_device).bfloat16()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    allocated = torch.cuda.memory_allocated(cuda_device)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (torch.cuda.max_memory_allocated(cuda_device) - allocated
            < k.numel() * k.element_size())
    ro, rlse = tfa.flash_attention_reference(q.float(), k.float(), v.float(),
                                             causal=True)
    assert (o.float() - ro).abs().max().item() <= 2e-2
    assert (lse - rlse).abs().max().item() <= 1e-3
    o2, lse2 = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,skv,rate", [(1, 1000, 1000, 0.0), (2, 777, 901, 0.0),
                                          (1, 1000, 1000, 0.1)])
def test_flash_bf16_kernel_with_k_is_v_at_d128(cuda_device, b, s, skv, rate):
    """MLA's call: one (B, S, 1, 128) tensor as both k and v, 8 q heads,
    ragged; within the bf16 limits of the plain version, two calls
    bit-identical."""
    r = np.random.default_rng(9)
    q = torch.from_numpy(r.standard_normal((b, s, 8, 128)).astype(np.float32)
                         ).to(cuda_device, torch.bfloat16)
    c = torch.from_numpy(r.standard_normal((b, skv, 1, 128)).astype(np.float32)
                         ).to(cuda_device, torch.bfloat16)
    kw = dict(causal=True, dropout_rate=rate, dropout_seed=19)
    o, lse = tfa.flash_attention_fwd(q, c, c, **kw)
    ro, rlse = tfa.flash_attention_reference(q.float(), c.float(), c.float(),
                                             **kw)
    assert (o.float() - ro).abs().max().item() <= 2e-2
    assert (lse - rlse).abs().max().item() <= 1e-3
    o2, lse2 = tfa.flash_attention_fwd(q, c, c, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_flash_kernel_copies_rows_off_16_byte_boundaries(cuda_device):
    """The bf16 kernel reads rows through TMA, which takes 16-byte
    boundaries: a view that starts off one is copied first, never read
    misaligned."""
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
@pytest.mark.parametrize("bad", ["dtype", "bf16_head_dim_32", "f32_head_dim_24",
                                 "stride", "device"])
def test_flash_kernel_rejects_what_it_does_not_take(cuda_device, bad):
    q = torch.randn(1, 8, 2, 64, device=cuda_device)
    k = torch.randn(1, 8, 2, 64, device=cuda_device)
    if bad == "dtype":
        q, k = q.half(), k.half()
    elif bad == "bf16_head_dim_32":  # no bf16 wgmma kernel below 64 columns
        q, k = q[..., :32].bfloat16().contiguous(), k[..., :32].bfloat16().contiguous()
    elif bad == "f32_head_dim_24":  # not a built head dim
        q, k = q[..., :24].contiguous(), k[..., :24].contiguous()
    elif bad == "stride":
        q = torch.randn(1, 8, 2, 128, device=cuda_device)[..., ::2]
        k = k.contiguous()
    elif bad == "device":
        k = k.cpu()
    before = (tfa.flash_attention_fwd.launches, tfa.flash_attention_reference.calls)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, k, k, causal=True)
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_reference.calls) == before


# ---------------------------------------------------------------- backward

def _bwd_inputs(seed, b, sq, skv, n, n_kv, d, causal, dtype, device):
    """q, k, v, dO in `dtype` on the card, and lse, delta from the plain
    forward on the same (rounded) inputs, as the autograd path makes
    them."""
    r = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(x).to(device, dtype)
               for x in _qkv(seed, b, sq, skv, n, n_kv, d))
    do = torch.from_numpy(
        r.standard_normal((b, sq, n, d)).astype(np.float32)).to(device, dtype)
    o, lse = tfa.flash_attention_reference(q.float(), k.float(), v.float(),
                                           causal=causal)
    return q, k, v, do, lse, tfa.flash_delta(do, o)


def _rel_err(x, ref):
    return ((x.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,n,n_kv,d,causal,dtype", [
    (1, 512, 512, 16, 8, 64, True, torch.bfloat16),
    (2, 300, 100, 8, 2, 64, True, torch.bfloat16),   # empty rows
    (1, 100, 300, 4, 1, 64, True, torch.bfloat16),   # MQA, Sq < Skv
    (1, 200, 333, 4, 4, 128, False, torch.bfloat16),
    (1, 777, 777, 4, 2, 64, True, torch.bfloat16),
    (1, 256, 256, 4, 2, 64, True, torch.float32),
    (2, 150, 97, 4, 2, 128, True, torch.float32),    # empty rows
    (1, 37, 100, 4, 4, 64, False, torch.float32),
])
def test_flash_backward_kernels_match_reference(cuda_device, b, sq, skv, n,
                                                n_kv, d, causal, dtype):
    """dq and dk/dv kernels against the plain backward on the same
    inputs: max |kernel - plain| / max |plain| within 2e-5 for float32
    (CUDA-core f32 arithmetic) and 1e-2 for bf16 (outputs rounded to
    bf16, p and ds split into two bf16 parts): chip_smoke.py's limits,
    3x and 5x above the largest errors measured on an H100."""
    args = _bwd_inputs(11, b, sq, skv, n, n_kv, d, causal, dtype, cuda_device)
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    dq, dk, dv = tfa.flash_attention_bwd(*args, causal=causal)
    torch.cuda.synchronize()
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    q, k, v, do, lse, delta = args
    ref = tfa.flash_attention_bwd_reference(q.float(), k.float(), v.float(),
                                            do.float(), lse, delta,
                                            causal=causal)
    tol = 1e-2 if dtype == torch.bfloat16 else 2e-5
    for got, want in zip((dq, dk, dv), ref):
        assert torch.isfinite(got).all()
        assert _rel_err(got, want) <= tol


@pytest.mark.cuda
def test_flash_autograd_on_the_card_matches_dense_autograd(cuda_device):
    """float32 end to end: grads of the kernels' autograd function
    equal torch.autograd through the dense op, within 2e-5 relative."""
    q, k, v = (torch.from_numpy(x).to(cuda_device).requires_grad_()
               for x in _qkv(5, 2, 192, 192, 8, 2, 64))
    do = torch.randn(2, 192, 8, 64, device=cuda_device)
    g = torch.autograd.grad(tfa.flash_attention(q, k, v, causal=True),
                            (q, k, v), do)
    from solvingpapers_tpu_torch.ops import dot_product_attention

    ref = torch.autograd.grad(dot_product_attention(q, k, v, causal=True),
                              (q, k, v), do)
    for got, want in zip(g, ref):
        assert _rel_err(got, want) <= 2e-5


# ----------------------------------------------------------------- dropout

tdr = importlib.import_module("solvingpapers_tpu_torch.kernels.dropout")

DROPOUT_CASES = [
    # (b, sq, skv, n, n_kv, d, causal, dtype, rate)
    (1, 512, 512, 8, 1, 128, True, torch.bfloat16, 0.1),   # dsv3's heads
    (1, 300, 100, 4, 2, 64, True, torch.bfloat16, 0.5),    # empty rows
    (1, 37, 100, 4, 1, 128, True, torch.bfloat16, 0.1),    # ragged
    (2, 200, 333, 4, 4, 64, False, torch.bfloat16, 0.5),   # MHA, bidirectional
    (1, 777, 777, 4, 2, 64, True, torch.bfloat16, 0.1),
    (1, 256, 256, 8, 1, 128, True, torch.float32, 0.1),
    (2, 150, 97, 4, 2, 128, True, torch.float32, 0.5),     # empty rows
    (1, 37, 100, 4, 4, 64, False, torch.float32, 0.1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,skv,rate", [(8, 512, 512, 0.1), (3, 37, 100, 0.5),
                                            (1, 300, 777, 0.1)])
def test_dropout_mask_kernel_equals_the_plain_mask(cuda_device, bh, sq, skv,
                                                   rate):
    """The mask kernel's bits equal the plain keep function's: no
    element differs; another seed gives another mask."""
    before = tdr.dropout_mask.launches
    got = tdr.dropout_mask(1234567890123, rate, bh, sq, skv, cuda_device)
    torch.cuda.synchronize()
    assert tdr.dropout_mask.launches == before + 1
    want = tdr.dropout_keep_reference(1234567890123, rate, bh, sq, skv,
                                      device=cuda_device)
    assert got.dtype == torch.bool and got.shape == (bh, sq, skv)
    assert int((got != want).sum()) == 0
    other = tdr.dropout_mask(1234567890124, rate, bh, sq, skv, cuda_device)
    assert int((got != other).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,n,n_kv,d,causal,dtype,rate", DROPOUT_CASES)
def test_flash_dropout_kernels_match_reference(cuda_device, b, sq, skv, n,
                                               n_kv, d, causal, dtype, rate):
    """Forward, dq and dk/dv kernels with dropout against their plain
    versions at the same seed, within the dropout-free tolerances."""
    seed = 987654321
    q, k, v = (torch.from_numpy(x).to(cuda_device, dtype)
               for x in _qkv(13, b, sq, skv, n, n_kv, d))
    do = torch.randn(b, sq, n, d, device=cuda_device).to(dtype)
    kw = dict(causal=causal, dropout_rate=rate, dropout_seed=seed)
    o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    ro, rlse = tfa.flash_attention_reference(q.float(), k.float(), v.float(),
                                             **kw)
    o_tol, lse_tol = (2e-2, 1e-3) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    assert (o.float() - ro).abs().max().item() <= o_tol
    assert (lse - rlse).abs().max().item() <= lse_tol
    delta = tfa.flash_delta(do, ro.to(dtype))
    grads = tfa.flash_attention_bwd(q, k, v, do, rlse, delta, **kw)
    torch.cuda.synchronize()
    ref = tfa.flash_attention_bwd_reference(q.float(), k.float(), v.float(),
                                            do.float(), rlse, delta, **kw)
    tol = 1e-2 if dtype == torch.bfloat16 else 2e-5
    for got, want in zip(grads, ref):
        assert torch.isfinite(got).all()
        assert _rel_err(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_dropout_seeds_and_rate_zero(cuda_device, dtype):
    """Two launches at one seed are bit-identical, another seed differs,
    and rate 0 is the dropout-free kernel bit for bit."""
    q, k, v = (torch.from_numpy(x).to(cuda_device, dtype)
               for x in _qkv(3, 1, 256, 256, 8, 1, 128))
    a = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_rate=0.3,
                                dropout_seed=5)[0]
    b = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_rate=0.3,
                                dropout_seed=5)[0]
    c = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_rate=0.3,
                                dropout_seed=6)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    z = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_rate=0.0,
                                dropout_seed=5)
    plain = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert torch.equal(z[0], plain[0]) and torch.equal(z[1], plain[1])


@pytest.mark.cuda
def test_flash_dropout_linearity_identity_on_the_card(cuda_device):
    """o is linear in v at a fixed mask: <L(v + u) - L(v)> = <u, dL/dv>
    through the kernels, float32 (the dv kernel must redraw the forward's
    exact mask)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(1, 256, 8, 128, generator=g, device=cuda_device),
               torch.randn(1, 256, 1, 128, generator=g, device=cuda_device),
               torch.randn(1, 256, 1, 128, generator=g, device=cuda_device))
    w = torch.randn(1, 256, 8, 128, generator=g, device=cuda_device)
    u = torch.randn(v.shape, generator=g, device=cuda_device)

    def loss(vv):
        return (tfa.flash_attention(q, k, vv, causal=True, dropout_rate=0.3,
                                    dropout_seed=11) * w).sum()

    vg = v.clone().requires_grad_()
    (gv,) = torch.autograd.grad(loss(vg), vg)
    lhs = (loss(v + u) - loss(v)).item()
    rhs = (u * gv).sum().item()
    assert abs(lhs - rhs) <= 1e-4 * abs(rhs)


@pytest.mark.cuda
def test_flash_dropout_autograd_matches_dense_autograd(cuda_device):
    """float32: the kernels' autograd with dropout equals autograd through
    the dense op with the same mask (MQA; k and v one tensor, as MLA
    passes its latent stream)."""
    from solvingpapers_tpu_torch.ops import dot_product_attention

    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn(2, 192, 8, 128, generator=g, device=cuda_device)
    c = torch.randn(2, 192, 1, 128, generator=g, device=cuda_device)
    do = torch.randn(2, 192, 8, 128, generator=g, device=cuda_device)
    q, c = q.requires_grad_(), c.requires_grad_()
    got = torch.autograd.grad(
        tfa.flash_attention(q, c, c, causal=True, dropout_rate=0.1,
                            dropout_seed=42), (q, c), do)
    want = torch.autograd.grad(
        dot_product_attention(q, c, c, causal=True, dropout_rate=0.1,
                              dropout_seed=42, deterministic=False), (q, c), do)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= 2e-5


# ------------------------------------------- the bf16 backward's work split

def _chip_smoke():
    """`chip_smoke.py` (no JAX), for its exact read-out of the kernels'
    dropout masks."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,n,n_kv,d,rate,splits,folds", [
    # MQA at D 128, group 8, ragged: the plan splits the group, one q head
    # a block, float32 partials folded in head order
    (1, 1000, 8, 1, 128, 0.0, None, False),
    (1, 1000, 8, 1, 128, 0.1, None, False),
    # four q heads folded in a block, two partials
    (1, 1000, 8, 1, 128, 0.1, 2, False),
    # GQA group 2 at D 64 with 17 x 32 = 544 blocks: the in-block fold
    (4, 2112, 16, 8, 64, 0.0, None, True),
])
def test_flash_backward_split_and_fold_are_right_and_deterministic(
        cuda_device, b, s, n, n_kv, d, rate, splits, folds):
    """bf16 dq and dk/dv on both sides of the plan's split, against the
    plain backward (max |kernel - plain| / max |plain| within 1e-2), and
    a second call on the same inputs bit-identical (no atomics; the fold
    sums the partials in head order)."""
    plan = tfa.bwd_plan(b, s, s, n, n_kv, True,
                        sms=tfa._sm_count(cuda_device))
    assert (plan.splits == 1) == folds
    kw = dict(causal=True, dropout_rate=rate, dropout_seed=77)
    q, k, v = (torch.from_numpy(x).to(cuda_device, torch.bfloat16)
               for x in _qkv(21, b, s, s, n, n_kv, d))
    do = torch.randn(b, s, n, d, device=cuda_device).bfloat16()
    o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    delta = tfa.flash_delta(do, o)

    def grads():
        return (tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                *tfa._launch_dkv(q, k, v, do, lse, delta, splits, **kw))

    got, again = grads(), grads()
    torch.cuda.synchronize()
    ref = tfa.flash_attention_bwd_reference(q.float(), k.float(), v.float(),
                                            do.float(), lse, delta, **kw)
    for x, y, want in zip(got, again, ref):
        assert x.dtype == torch.bfloat16 and torch.isfinite(x).all()
        assert torch.equal(x, y)
        assert _rel_err(x, want) <= 1e-2


@pytest.mark.cuda
def test_flash_backward_split_path_redraws_the_mask_bit_for_bit(cuda_device):
    """MQA at D 128, group 8, S 1000, rate 0.1 (the dk/dv split path): the
    dq and dk/dv kernels' masks, read out exactly through their outputs,
    equal the plain keep function's on every visible element."""
    from solvingpapers_tpu_torch.ops.attention import causal_mask

    b, s, n, d, rate, seed = 1, 1000, 8, 128, 0.1, 20261017
    assert tfa.bwd_plan(b, s, s, n, 1, True,
                        sms=tfa._sm_count(cuda_device)).splits == 8
    got = _chip_smoke().kernel_masks(cuda_device, torch.bfloat16, b, s, n, d,
                                     rate, seed)
    want = (tdr.dropout_keep_reference(seed, rate, b * n, s, s,
                                       device=cuda_device)
            & causal_mask(s, s, device=cuda_device))
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert int((got[kernel] != want).sum()) == 0, kernel


# --------------------------------- float32 at head dims 16 and 32; any scale

@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,n,n_kv,d,causal,rate,kv", [
    (4, 256, 256, 4, 2, 16, True, 0.0, "own"),      # llama3_long_smoke's heads
    (2, 37, 100, 4, 2, 16, False, 0.0, "own"),      # ragged, bidirectional
    (1, 300, 100, 8, 1, 16, True, 0.1, "k_is_v"),   # MQA, k is v, empty rows
    (1, 777, 777, 4, 2, 32, True, 0.5, "own"),
    (2, 129, 129, 8, 1, 32, True, 0.1, "k_is_v"),
])
def test_flash_f32_small_head_dims_match_reference(cuda_device, b, sq, skv, n,
                                                   n_kv, d, causal, rate, kv):
    """The float32 forward, dq and dk/dv kernels at D 16 and 32 against the
    plain versions (o, lse within 1e-4; grads within 2e-5 of the largest),
    with and without dropout; two calls bit-identical."""
    q, k, v = (torch.from_numpy(x).to(cuda_device)
               for x in _qkv(31, b, sq, skv, n, n_kv, d))
    if kv == "k_is_v":
        v = k
    do = torch.randn(b, sq, n, d, device=cuda_device)
    kw = dict(causal=causal, dropout_rate=rate, dropout_seed=4242)
    before = (tfa.flash_attention_fwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    delta = tfa.flash_delta(do, o)
    grads = tfa.flash_attention_bwd(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == tuple(x + 1 for x in before)
    ro, rlse = tfa.flash_attention_reference(q, k, v, **kw)
    assert (o - ro).abs().max().item() <= 1e-4
    assert (lse - rlse).abs().max().item() <= 1e-4
    ref = tfa.flash_attention_bwd_reference(q, k, v, do, lse, delta, **kw)
    for got, want in zip(grads, ref):
        assert torch.isfinite(got).all() and _rel_err(got, want) <= 2e-5
    assert torch.equal(o, tfa.flash_attention_fwd(q, k, v, **kw)[0])
    for x, y in zip(grads, tfa.flash_attention_bwd(q, k, v, do, lse, delta, **kw)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [-0.125, 0.0])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_bf16_takes_any_scale(cuda_device, scale, rate):
    """bf16 at a scale <= 0 through `flash_attention` (the kernels run on
    `positive_scale`'s exact transform): o within 2e-2 of the plain
    version at the untransformed scale, grads within 1e-2 of the
    largest."""
    q, k, v = (torch.from_numpy(x).to(cuda_device, torch.bfloat16)
               for x in _qkv(33, 1, 300, 300, 8, 2, 64))
    do = torch.randn(1, 300, 8, 64, device=cuda_device).bfloat16()
    kw = dict(causal=True, scale=scale, dropout_rate=rate, dropout_seed=8)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(qg, kg, vg, **kw)
    grads = torch.autograd.grad(o, (qg, kg, vg), do)
    ro, rlse = tfa.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    assert (o.float() - ro).abs().max().item() <= 2e-2
    _, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    assert (lse - rlse).abs().max().item() <= 1e-3
    ref = tfa.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), do.float(), rlse,
        tfa.flash_delta(do.float(), ro), **kw)
    for got, want in zip(grads, ref):
        assert torch.isfinite(got).all()
        assert _rel_err(got, want) <= 1e-2  # dq at scale 0: exactly 0


# -------------------------------------------------- dropout mask and apply

@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,skv", [(1, 64, 1), (2, 33, 15), (3, 31, 17),
                                        (2, 17, 100), (1, 16384, 512)])
def test_dropout_mask_kernel_at_ragged_edges(cuda_device, bh, sq, skv):
    """Skv below, around and off 16, odd Sq, BH > 1: no element differs
    from the plain mask."""
    got = tdr.dropout_mask(99, 0.3, bh, sq, skv, cuda_device)
    want = tdr.dropout_keep_reference(99, 0.3, bh, sq, skv, device=cuda_device)
    assert int((got != want).sum()) == 0


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (1, 16384, 512), (128, 256, 256), (8, 2048, 1000),  # the timed shapes
    (2, 33, 15), (3, 31, 17), (1, 7, 1), (2, 2, 17, 100),
    (2, 9, 1), (3, 1, 15), (2, 9, 17), (2, 1, 1000), (1, 9, 1000),  # ragged
])
def test_dropout_apply_kernel_equals_plain_dropout(cuda_device, dtype, shape):
    """The apply kernel, forward and backward through `dropout`, equals the
    plain version bit for bit, and launches once each way."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    dy = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    xg = x.clone().requires_grad_()
    before = tdr.dropout_apply.launches
    y = tdr.dropout(xg, 0.1, 1234)
    (dx,) = torch.autograd.grad(y, xg, dy)
    torch.cuda.synchronize()
    assert tdr.dropout_apply.launches == before + 2
    assert torch.equal(_bits(y), _bits(tdr.dropout_apply_reference(x, 0.1, 1234)))
    assert torch.equal(_bits(dx), _bits(tdr.dropout_apply_reference(dy, 0.1, 1234)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("offset,shape", [(1, (3, 40, 24)), (1, (2, 33, 1000)),
                                          (3, (2, 33, 1000))])
def test_dropout_apply_kernel_reads_an_offset_view(cuda_device, dtype, offset,
                                                   shape):
    """A contiguous view that starts off 16 bytes goes to the kernel as is
    (no copy), so its element-wise path runs, and comes out right."""
    n = shape[0] * shape[1] * shape[2]
    flat = torch.randn(offset + n, device=cuda_device).to(dtype)
    x = flat[offset:].view(shape)
    assert x.data_ptr() % 16
    assert torch.equal(_bits(tdr.dropout_apply(x, 0.5, 3)),
                       _bits(tdr.dropout_apply_reference(x, 0.5, 3)))


def _chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    return chip_smoke


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.1, 0.5, 0.3])
def test_dropout_apply_kernel_divides_every_bf16_input_exactly(cuda_device, rate):
    """Every bf16 bit pattern, nearly all kept (threshold 0xFFFFFFFF through
    the C entry), against IEEE division by float32(1 - rate) on the card;
    NaNs compared as NaN (`chip_smoke.py` also runs every float32 input)."""
    x = torch.arange(-2**15, 2**15, dtype=torch.int32, device=cuda_device).to(
        torch.int16).view(torch.bfloat16).view(1, 256, 256)
    differ, kept = _chip_smoke().every_input_differing(
        x, tdr.apply_args(rate)[1], cuda_device)
    assert differ == 0 and kept > 65536 - 8


@pytest.mark.cuda
@pytest.mark.parametrize("divisor", [f"rate {r}" for r in (0.05, 0.2, 0.45, 0.7, 0.95)]
                         + ["bits 0x3f7fffff", "bits 0x35ffffff"])
def test_dropout_apply_kernel_divides_every_float32_significand_exactly(
        cuda_device, divisor):
    """Every float32 sign and significand at the exponent of 1 and at those
    where the quotient crosses the fast path's edges, against IEEE
    division by the divisor on the card: float32(1 - rate), or one with an
    all-ones significand. Within the fast path the quotient scales exactly
    with x's exponent, so this covers every float32 input of the divisor
    (`chip_smoke.py` sweeps more divisors)."""
    smoke = _chip_smoke()
    kind, value = divisor.split()
    d = (np.float32(1.0 - float(value)) if kind == "rate"
         else np.array([int(value, 16)], dtype=np.uint32).view(np.float32)[0])
    for e in smoke.sweep_bands(d):
        differ, _ = smoke.every_input_differing(
            smoke.significand_band(e, cuda_device), d, cuda_device)
        assert differ == 0, (float(d), e)
