"""The port's dropout keep function and the flash plain versions with
dropout, on the CPU (the kernels' counterparts are the `cuda`-marked
cases of tests/test_torch_kernels_cuda.py).

The reference's in-kernel dropout draws the TPU's hardware random bits,
which its interpret mode stubs out, so nothing here is compared with the
JAX package: the checks are the Philox known-answer vectors, the mask's
statistics and structure, and identities that hold only when the
forward and the backward apply one mask — the counterparts of
`tests/test_flash_dropout_tpu.py`. Tolerances: float32 plain versions
against float32 autograd through a dense replica, 1e-5 relative to the
largest value (summation order only); the linearity identity 1e-4
relative.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from solvingpapers_tpu_torch import kernels
from solvingpapers_tpu_torch.kernels import build
from solvingpapers_tpu_torch.ops import dot_product_attention

# the modules (the package's names `dropout` and `flash_attention` are
# the functions)
tdr = importlib.import_module("solvingpapers_tpu_torch.kernels.dropout")
tfa = importlib.import_module("solvingpapers_tpu_torch.kernels.flash_attention")
TOL = 1e-5


def _rel(x, ref):
    return ((x - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def _qkv(seed, b, sq, skv, n, n_kv, d):
    r = np.random.default_rng(seed)
    return (torch.from_numpy(r.standard_normal((b, sq, n, d)).astype(np.float32)),
            torch.from_numpy(r.standard_normal((b, skv, n_kv, d)).astype(np.float32)),
            torch.from_numpy(r.standard_normal((b, skv, n_kv, d)).astype(np.float32)))


# ---------------------------------------------------------------- Philox


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answer_vectors(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    got = tdr.philox4x32_10(*(torch.tensor(c) for c in ctr), *key)
    assert tuple(int(w) for w in got) == want


def test_threshold_is_the_reference_formula():
    for rate in (0.0, 0.1, 0.25, 0.5, 0.999):
        assert tdr.keep_threshold(rate) == min(int((1.0 - rate) * 4294967296.0),
                                               4294967295)
    for bad in (-0.1, 1.0, 2.0):
        with pytest.raises(ValueError, match="dropout rate"):
            tdr.keep_threshold(bad)


@pytest.mark.parametrize("bh,sq,skv", [(3, 37, 100), (1, 16, 16), (2, 8, 24)])
def test_mask_element_is_its_group_word(bh, sq, skv):
    """Every element of the vectorised mask is the word its definition
    names: Philox of counter (row & ~8, col & ~8, bh, 0) and key (seed
    low, seed high), word 2 * bit3(row) + bit3(col), below threshold."""
    seed, rate = 0x1234_5678_9ABC_DEF0, 0.3
    mask = tdr.dropout_keep_reference(seed, rate, bh, sq, skv, bh_start=5)
    thr = tdr.keep_threshold(rate)
    r, c, h = np.meshgrid(np.arange(sq), np.arange(skv), np.arange(bh),
                          indexing="ij")
    words = tdr.philox4x32_10(torch.from_numpy(r & ~8), torch.from_numpy(c & ~8),
                              torch.from_numpy(h + 5), torch.tensor(0),
                              seed & 0xFFFFFFFF, seed >> 32)
    pick = torch.from_numpy(((r >> 3) & 1) * 2 + ((c >> 3) & 1))
    word = torch.stack(words).gather(0, pick[None])[0]
    assert torch.equal(mask, (word < thr).permute(2, 0, 1))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_kept_fraction_determinism_and_independence(rate):
    """The kept fraction lies within 5 sigma of 1 - rate; a seed gives
    the same mask every time, another seed and another head give masks
    that agree only as often as independent draws would."""
    m = tdr.dropout_keep_reference(7, rate, 4, 256, 256)
    n = m.numel()
    sigma = math.sqrt(rate * (1 - rate) / n)
    assert abs(m.float().mean().item() - (1 - rate)) <= 5 * sigma
    assert torch.equal(m, tdr.dropout_keep_reference(7, rate, 4, 256, 256))
    other = tdr.dropout_keep_reference(8, rate, 4, 256, 256)
    # agreement of two independent Bernoulli(p) masks: p^2 + (1-p)^2
    p = 1 - rate
    agree = p * p + (1 - p) * (1 - p)
    s_agree = math.sqrt(agree * (1 - agree) / n)
    assert abs((m == other).float().mean().item() - agree) <= 5 * s_agree
    per_head = m.shape[1] * m.shape[2]
    s_head = math.sqrt(agree * (1 - agree) / per_head)
    for h in range(1, 4):
        frac = (m[0] == m[h]).float().mean().item()
        assert abs(frac - agree) <= 5 * s_head


def test_dropout_mask_on_the_cpu_is_the_plain_version():
    kernels.reset_counts()
    m = tdr.dropout_mask(3, 0.2, 2, 20, 30, "cpu")
    assert torch.equal(m, tdr.dropout_keep_reference(3, 0.2, 2, 20, 30))
    assert tdr.dropout_mask.launches == 0
    assert tdr.dropout_keep_reference.calls == 2
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        tdr.dropout_mask(3, 0.2, 2, 20, 30, "meta")


def test_residual_dropout_uses_the_keep_function():
    """`dropout` keeps element (b, s, d) iff keep(seed, b, s, d), scales
    kept values by 1 / (1 - rate) in x's dtype, and is the identity at
    rate 0; a recomputation redraws the same mask."""
    x = torch.randn(2, 40, 24)
    y = tdr.dropout(x, 0.25, 99)
    keep = tdr.dropout_keep_reference(99, 0.25, 2, 40, 24)
    assert torch.equal(y, torch.where(keep, x / 0.75, 0.0))
    assert torch.equal(y, tdr.dropout(x, 0.25, 99))
    assert tdr.dropout(x, 0.0, 99) is x
    xb = x.bfloat16()
    assert tdr.dropout(xb, 0.25, 99).dtype == torch.bfloat16


def test_mix_seed_separates_steps_and_layers():
    seeds = {tdr.mix_seed(s, i) for s in range(20) for i in range(20)}
    assert len(seeds) == 400 and all(0 <= s < 2**64 for s in seeds)
    assert tdr.mix_seed(5, 1, 2) == tdr.mix_seed(tdr.mix_seed(5, 1), 2)


# ------------------------------------------------------------ flash plain


def _dense_replica(q, k, v, keep, rate, causal, scale):
    """Dense attention with an explicit keep mask (B*N, Sq, Skv): the
    reference's dropped-attention function, built independently of the
    port's ops."""
    b, sq, n, d = q.shape
    group = n // k.shape[2]
    kr = k.repeat_interleave(group, dim=2)
    vr = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bqnd,bknd->bnqk", q * scale, kr)
    if causal:
        vis = torch.arange(kr.shape[1])[None, :] <= (
            torch.arange(sq)[:, None] + kr.shape[1] - sq)
        s = s.masked_fill(~vis, -(2.0**30))
    p = torch.softmax(s, dim=-1)
    p = p * keep.view(b, n, sq, -1) / (1 - rate)
    return torch.einsum("bnqk,bknd->bqnd", p, vr)


@pytest.mark.parametrize("b,sq,skv,n,n_kv,d,causal,rate", [
    (1, 64, 64, 2, 1, 16, True, 0.3),       # the reference test's MQA-like case
    (2, 37, 100, 4, 2, 16, True, 0.5),      # GQA, Sq < Skv, ragged
    (2, 40, 56, 4, 4, 8, False, 0.1),       # MHA, bidirectional
    (1, 50, 50, 8, 1, 32, True, 0.1),       # dsv3's MQA fold
])
def test_plain_flash_with_dropout_equals_dense_replica_with_extracted_mask(
        b, sq, skv, n, n_kv, d, causal, rate):
    """The counterpart of test_grads_match_dense_replica_with_extracted_mask:
    the plain flash forward and backward with dropout equal autograd
    through a dense replica built on the extracted keep mask."""
    q, k, v = (x.requires_grad_() for x in _qkv(0, b, sq, skv, n, n_kv, d))
    do = torch.randn(b, sq, n, d, generator=torch.Generator().manual_seed(1))
    seed, scale = 11, d**-0.5
    o = tfa.flash_attention(q, k, v, causal=causal, dropout_rate=rate,
                            dropout_seed=seed)
    got = torch.autograd.grad(o, (q, k, v), do)
    keep = tdr.dropout_keep_reference(seed, rate, b * n, sq, skv)
    assert 0.0 < keep.float().mean().item() < 1.0
    ref = _dense_replica(q, k, v, keep, rate, causal, scale)
    want = torch.autograd.grad(ref, (q, k, v), do)
    assert _rel(o, ref) <= TOL
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


def test_linearity_identity():
    """o is linear in v at a fixed mask, so <L(v + u) - L(v)> equals
    <u, dL/dv> exactly up to rounding — only if the dv backward redraws
    the forward's mask (test_dv_mask_consistency_via_linearity)."""
    q, k, v = _qkv(3, 1, 64, 64, 4, 2, 32)
    g = torch.Generator().manual_seed(4)
    w = torch.randn(q.shape, generator=g)
    u = torch.randn(v.shape, generator=g)

    def loss(vv):
        return (tfa.flash_attention(q, k, vv, causal=True, dropout_rate=0.3,
                                    dropout_seed=11) * w).sum()

    vg = v.clone().requires_grad_()
    (gv,) = torch.autograd.grad(loss(vg), vg)
    lhs = (loss(v + u) - loss(v)).item()
    rhs = (u * gv).sum().item()
    assert abs(lhs - rhs) <= 1e-4 * abs(rhs)
    # with another seed in the backward the identity would break: the
    # masks differ in about 2 * 0.3 * 0.7 of the elements
    other = (tfa.flash_attention(q, k, v + u, causal=True, dropout_rate=0.3,
                                 dropout_seed=12) * w).sum().item()
    assert abs(other - loss(v).item() - rhs) > 1e-2 * abs(rhs)


def test_rate_zero_is_the_dropout_free_path():
    q, k, v = _qkv(5, 2, 33, 47, 4, 2, 16)
    do = torch.randn(q.shape)
    o0, lse0 = tfa.flash_attention_fwd(q, k, v, causal=True)
    o1, lse1 = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_rate=0.0,
                                       dropout_seed=9)
    assert torch.equal(o0, o1) and torch.equal(lse0, lse1)
    delta = tfa.flash_delta(do, o0)
    g0 = tfa.flash_attention_bwd(q, k, v, do, lse0, delta, causal=True)
    g1 = tfa.flash_attention_bwd(q, k, v, do, lse0, delta, causal=True,
                                 dropout_rate=0.0, dropout_seed=9)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_dropout_keeps_the_undropped_lse_and_is_unbiased():
    """lse is the undropped softmax's; averaged over seeds the dropped
    output approaches the undropped one (no bias)."""
    q, k, v = _qkv(6, 1, 64, 64, 2, 2, 16)
    o_ref, lse_ref = tfa.flash_attention_fwd(q, k, v, causal=True)
    acc = torch.zeros_like(o_ref)
    for s in range(48):
        o, lse = tfa.flash_attention_fwd(q, k, v, causal=True,
                                         dropout_rate=0.25, dropout_seed=100 + s)
        assert torch.equal(lse, lse_ref)
        acc += o
    single = (tfa.flash_attention_fwd(q, k, v, causal=True, dropout_rate=0.25,
                                      dropout_seed=1)[0] - o_ref).abs().mean()
    mean = (acc / 48 - o_ref).abs().mean()
    assert mean < single / 3  # 1/sqrt(48) shrinks the spread ~7x


@pytest.mark.parametrize("causal", [True, False])
def test_dense_op_applies_the_same_mask(causal):
    """`dot_product_attention` with dropout equals the flash plain
    version at the same seed (the dense path and use_flash compute one
    function); it needs a seed when dropout is active."""
    q, k, v = _qkv(8, 2, 30, 30, 4, 1, 16)
    a = tfa.flash_attention(q, k, v, causal=causal, dropout_rate=0.2,
                            dropout_seed=3)
    b = dot_product_attention(q, k, v, causal=causal, dropout_rate=0.2,
                              dropout_seed=3, deterministic=False)
    assert _rel(a, b) <= TOL
    same = dot_product_attention(q, k, v, causal=causal, dropout_rate=0.2,
                                 dropout_seed=3)  # deterministic: no dropout
    assert torch.equal(same, dot_product_attention(q, k, v, causal=causal))
    with pytest.raises(ValueError, match="dropout_seed"):
        dot_product_attention(q, k, v, dropout_rate=0.2, deterministic=False)


# ----------------------------------------------------------------- build


def test_mask_library_is_listed_and_headers_enter_the_digest(tmp_path,
                                                             monkeypatch):
    """The mask kernel is built like the others, and a library's file
    name changes when a shared header (philox.cuh) changes, so an edited
    header is never served by a stale build."""
    assert build.LIBRARIES["dropout_mask"] == "dropout_mask.cu"
    for name in build.LIBRARIES.values():
        assert (build.CSRC / name).exists()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name) for name in build.LIBRARIES}
    with open(csrc / "philox.cuh", "a") as f:
        f.write("\n// edited\n")
    for name in build.LIBRARIES:
        assert build.library_path(name) != before[name]
