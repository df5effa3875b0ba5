"""The port's flash-attention forward vs the JAX package's.

`flash_attention_reference` (the plain version the CPU takes, and the
one the card's kernel is held against) must give the JAX Pallas
kernel's ``(o, lse)`` — run in interpret mode, as the JAX package's own
tests run it on the CPU — over the grid of `tests/test_flash_attention.py`:
causal and bidirectional, Sq == Skv, Sq < Skv (end-aligned), Sq > Skv
(empty rows give o = 0, lse = 0), MHA/GQA/MQA, ragged lengths and bf16
inputs, head dims 16 (`llama3_long_smoke`'s 4 q / 2 kv heads; MQA with
one tensor as k and v, as MLA passes it), 32 and 64, negative and zero
softmax scales (the bf16 kernels' exact input transform,
`positive_scale`). Tolerances: float32 rtol/atol 2e-5 on o and lse (the two
frameworks sum in different orders); bf16 inputs 1e-2 on o (one bf16
ulp near 1 is 2**-7 ~ 7.8e-3, and both round a float32 result) and
2e-5 on lse, which stays float32.

The kernel itself runs only on the card: `test_torch_kernels_cuda.py`.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu import ops as jops
from solvingpapers_tpu_torch import ops as tops
from solvingpapers_tpu_torch.kernels import build

# the modules, not the functions of the same name the packages export
jfa = importlib.import_module("solvingpapers_tpu.kernels.flash_attention")
tfa = importlib.import_module("solvingpapers_tpu_torch.kernels.flash_attention")

F32_TOL = 2e-5
BF16_O_TOL = 1e-2


def _qkv(seed, b, sq, skv, n, n_kv, d):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, sq, n, d)).astype(np.float32)
    k = r.standard_normal((b, skv, n_kv, d)).astype(np.float32)
    v = r.standard_normal((b, skv, n_kv, d)).astype(np.float32)
    return q, k, v


def _jax_fwd(q, k, v, causal, dtype=jnp.float32, scale=None):
    """The JAX kernel's (o, lse) in interpret mode: `flash_attention`'s
    own block choice and layout, through `_fwd` so lse comes back too."""
    q, k, v = (jnp.asarray(x, dtype) for x in (q, k, v))
    b, sq, n, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    block_q = jfa._pick_block_q(sq, jfa.auto_block(sq, None))
    block_k = jfa._pick_block(skv, jfa.auto_block(skv, None))
    q3 = q.transpose(0, 2, 1, 3).reshape(b * n, sq, d)
    k3 = k.transpose(0, 2, 1, 3).reshape(b * n_kv, skv, d)
    v3 = v.transpose(0, 2, 1, 3).reshape(b * n_kv, skv, d)
    seed = jnp.zeros((1,), jnp.int32)
    scale = d**-0.5 if scale is None else scale
    o3, lse = jfa._fwd(q3, k3, v3, seed, n, n_kv, scale, causal,
                       block_q, block_k, 0.0, True)
    o = o3.reshape(b, n, sq, d).transpose(0, 2, 1, 3)
    return np.asarray(o, np.float32), np.asarray(lse)


GRID = [
    # (b, sq, skv, n, n_kv, d, causal)
    pytest.param(2, 64, 64, 4, 4, 32, True, id="mha_causal"),
    pytest.param(2, 64, 64, 4, 4, 32, False, id="mha_bidir"),
    pytest.param(2, 64, 64, 4, 2, 32, True, id="gqa_causal"),
    pytest.param(1, 64, 64, 4, 1, 32, True, id="mqa_causal"),
    pytest.param(1, 32, 96, 4, 2, 32, True, id="sq_lt_skv_causal"),
    pytest.param(1, 32, 96, 2, 2, 32, False, id="sq_lt_skv_bidir"),
    pytest.param(1, 96, 32, 4, 2, 32, True, id="sq_gt_skv_empty_rows"),
    pytest.param(1, 37, 100, 4, 2, 64, True, id="ragged_37_100"),
    # llama3_long_smoke's heads: dim 64 over 4 q / 2 kv heads, D 16
    pytest.param(2, 64, 64, 4, 2, 16, True, id="llama3_long_smoke_d16"),
    pytest.param(1, 37, 100, 4, 2, 16, False, id="d16_ragged_bidir"),
    pytest.param(1, 48, 48, 4, 1, 16, True, id="d16_mqa"),
    pytest.param(1, 96, 32, 4, 2, 16, True, id="d16_empty_rows"),
]


@pytest.mark.parametrize("b,sq,skv,n,n_kv,d,causal", GRID)
def test_reference_matches_jax_kernel(b, sq, skv, n, n_kv, d, causal):
    q, k, v = _qkv(0, b, sq, skv, n, n_kv, d)
    o, lse = tfa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    jo, jlse = _jax_fwd(q, k, v, causal)
    assert o.shape == (b, sq, n, d) and lse.shape == (b * n, 1, sq)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), jo, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=F32_TOL, atol=F32_TOL)


def test_reference_matches_jax_kernel_with_k_is_v_at_d16():
    """MQA with one tensor as k and v (MLA's latent stream; the small
    DeepSeek-V3 config's latent 8 + RoPE 8 is D 16)."""
    q, c, _ = _qkv(8, 2, 40, 40, 4, 1, 16)
    o, lse = tfa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(c),
        causal=True)
    jo, jlse = _jax_fwd(q, c, c, True)
    np.testing.assert_allclose(o.numpy(), jo, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=F32_TOL, atol=F32_TOL)


def test_reference_matches_jax_kernel_bf16():
    q, k, v = _qkv(1, 1, 64, 96, 4, 2, 64)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o, lse = tfa.flash_attention_reference(tq, tk, tv, causal=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    # both sides see the same bf16-rounded inputs
    jo, jlse = _jax_fwd(tq.float().numpy(), tk.float().numpy(),
                        tv.float().numpy(), True, jnp.bfloat16)
    np.testing.assert_allclose(o.float().numpy(), jo, rtol=0, atol=BF16_O_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("b,sq,skv,n,n_kv,d,causal",
                         [p for p in GRID if "empty" not in p.id])
def test_reference_matches_dense_attention(b, sq, skv, n, n_kv, d, causal):
    """The kernel's plain version and the port's dense op agree wherever
    every row sees at least one key."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, b, sq, skv, n, n_kv, d))
    o, _ = tfa.flash_attention_reference(q, k, v, causal=causal)
    ref = tops.dot_product_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(o.numpy(), ref.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


def test_empty_rows_give_zero_output_and_lse():
    """Sq > Skv causal: the first Sq - Skv rows see no key; the kernel's
    guard gives o = 0 and lse = 0 there (not the dense path's uniform
    average over BIG_NEG), and visible rows match the dense op."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 96, 32, 2, 2, 32))
    o, lse = tfa.flash_attention_reference(q, k, v, causal=True)
    assert (o[:, :64] == 0).all() and (lse[:, :, :64] == 0).all()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    dense = tops.dot_product_attention(q, k, v, causal=True)
    np.testing.assert_allclose(o[:, 64:].numpy(), dense[:, 64:].numpy(),
                               rtol=F32_TOL, atol=F32_TOL)
    # the JAX package's public op agrees on the JAX side
    jo = jfa.flash_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                             jnp.asarray(v.numpy()), causal=True,
                             interpret=True)
    jd = jops.dot_product_attention(jnp.asarray(q.numpy()),
                                    jnp.asarray(k.numpy()),
                                    jnp.asarray(v.numpy()), causal=True)
    np.testing.assert_allclose(np.asarray(jo)[:, 64:], np.asarray(jd)[:, 64:],
                               rtol=F32_TOL, atol=F32_TOL)


def test_public_flash_attention_returns_o_of_the_pair():
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, 40, 40, 4, 2, 32))
    o = tfa.flash_attention(q, k, v, causal=True)
    o2, _ = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert torch.equal(o, o2)


def test_cpu_path_never_touches_the_cuda_library(monkeypatch):
    """On CPU tensors the wrapper computes the plain version: it never
    builds or loads the CUDA library and never counts a launch."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU path tried to build the kernel")

    monkeypatch.setattr(build, "ensure_built", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(tfa, "_lib", None)
    launches = tfa.flash_attention_fwd.launches
    calls = tfa.flash_attention_reference.calls
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 16, 16, 2, 2, 32))
    tfa.flash_attention_fwd(q, k, v, causal=True)
    assert tfa._lib is None
    assert tfa.flash_attention_fwd.launches == launches
    assert tfa.flash_attention_reference.calls == calls + 1


def test_non_cpu_non_cuda_tensors_raise_instead_of_falling_back():
    """Only CPU tensors take the plain version: tensors anywhere else
    (here the meta device) raise, they are never computed quietly."""
    q = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention_fwd(q, q, q, causal=True)


def test_dropout_raises():
    """Dropout runs in the kernels now; a rate outside [0, 1) raises."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 8, 8, 2, 2, 32))
    with pytest.raises(ValueError, match="dropout"):
        tfa.flash_attention_fwd(q, k, v, causal=True, dropout_rate=1.0)
    with pytest.raises(ValueError, match="dropout"):
        tfa.flash_attention(q, k, v, dropout_rate=-0.5)


@pytest.mark.parametrize("shapes,match", [
    (((1, 8, 3, 32), (1, 8, 2, 32)), "not a multiple"),
    (((1, 8, 2, 32), (1, 8, 2, 16)), "disagree"),
    (((8, 2, 32), (1, 8, 2, 32)), "BSNH"),
])
def test_bad_shapes_raise(shapes, match):
    qs, ks = shapes
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention_fwd(torch.zeros(qs), torch.zeros(ks),
                                torch.zeros(ks))


def test_row_alignment_check():
    """The bf16 kernel's wrapper copies a tensor whose rows do not all
    start on 16-byte boundaries (no tensor map reads it in place); the
    check looks at the base pointer and at the strides of every axis
    longer than one."""
    x = torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16)
    assert tfa.tma_strides(x) is not None
    assert tfa.tma_strides(x[:, 2:5]) is not None  # a sequence slice, as prefill
    assert tfa.tma_strides(x.view(-1)[1:1 + 8 * 4 * 64].view(1, 8, 4, 64)) is None
    y = torch.zeros(1, 8, 4, 68, dtype=torch.bfloat16)[..., :64]
    assert tfa.tma_strides(y) is None  # 136-byte rows


def test_library_path_follows_source_and_flags(monkeypatch):
    """A built library's name carries a hash of its source and nvcc
    flags, so an edited kernel is never served by a stale build."""
    p0 = build.library_path("flash_fwd")
    assert p0.parent == build.BUILD_DIR and p0.suffix == ".so"
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-DX"])
    assert build.library_path("flash_fwd") != p0


@pytest.mark.parametrize("dtype,d", [(torch.float32, 16), (torch.float32, 32),
                                     (torch.float32, 64), (torch.float32, 128),
                                     (torch.bfloat16, 64), (torch.bfloat16, 128)])
def test_kernel_check_takes_the_built_pairs(dtype, d):
    """The wrapper's check passes every (dtype, head_dim) pair the kernels
    are built for (meta tensors: nothing is computed)."""
    q = torch.empty(1, 8, 4, d, dtype=dtype, device="meta")
    k = torch.empty(1, 8, 2, d, dtype=dtype, device="meta")
    tfa._check_kernel_inputs(q, k, k)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 32), (torch.bfloat16, 16),
                                     (torch.float32, 24), (torch.float32, 256)])
def test_kernel_check_refuses_pairs_not_built(dtype, d):
    """Any other pair raises, naming the pair and the supported set; no
    plain version runs in its place."""
    q = torch.empty(1, 8, 4, d, dtype=dtype, device="meta")
    k = torch.empty(1, 8, 2, d, dtype=dtype, device="meta")
    name = str(dtype)[6:]
    with pytest.raises(ValueError) as err:
        tfa._check_kernel_inputs(q, k, k)
    msg = str(err.value)
    assert f"({name}, head_dim {d})" in msg
    assert "float32 at head_dim 16, 32, 64, 128" in msg
    assert "bfloat16 at head_dim 64, 128" in msg


@pytest.mark.parametrize("scale", [-0.125, 0.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_positive_scale_transform_is_exact(scale, dtype):
    """The plain version on `positive_scale`'s (q', scale') gives the same
    o and lse as on (q, scale) exactly, and dq through autograd of the
    transform equals the untransformed call's; `flash_attention` on bf16
    applies it (the path the card's kernels take) with the same result."""
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(9, 1, 40, 56, 4, 2, 64))
    do = torch.from_numpy(_qkv(10, 1, 40, 40, 4, 4, 64)[0]).to(dtype)
    qt, st = tfa.positive_scale(q, scale)
    assert st > 0
    o, lse = tfa.flash_attention_reference(q, k, v, causal=True, scale=scale)
    ot, lset = tfa.flash_attention_reference(qt, k, v, causal=True, scale=st)
    assert torch.equal(o, ot) and torch.equal(lse, lset)

    def grads(transform):
        qg = q.clone().requires_grad_()
        qq, ss = tfa.positive_scale(qg, scale) if transform else (qg, scale)
        out = tfa._Flash.apply(qq, k, v, True, ss, 0.0, 0)
        return out, torch.autograd.grad(out, qg, do)[0]

    (o0, dq0), (o1, dq1) = grads(False), grads(True)
    assert torch.equal(o0, o1) and torch.equal(dq0, dq1)
    qg = q.clone().requires_grad_()
    o2 = tfa.flash_attention(qg, k, v, causal=True, scale=scale)
    assert torch.equal(o2, o0)
    assert torch.equal(torch.autograd.grad(o2, qg, do)[0], dq0)


@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_transformed_call_matches_jax_kernel_at_any_scale(scale):
    """The transformed plain call against the JAX kernel at the same
    (untransformed) scale, float32, within F32_TOL."""
    q, k, v = _qkv(11, 1, 64, 64, 4, 2, 32)
    qt, st = tfa.positive_scale(torch.from_numpy(q), scale)
    o, lse = tfa.flash_attention_reference(qt, torch.from_numpy(k),
                                           torch.from_numpy(v), causal=True,
                                           scale=st)
    jo, jlse = _jax_fwd(q, k, v, True, scale=scale)
    np.testing.assert_allclose(o.numpy(), jo, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=F32_TOL, atol=F32_TOL)


def test_positive_scale_passes_a_positive_scale_through():
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    qt, st = tfa.positive_scale(q, 0.125)
    assert qt is q and st == 0.125
