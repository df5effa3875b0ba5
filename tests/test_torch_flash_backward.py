"""The port's flash-attention backward vs the JAX package's.

The port's differentiable `flash_attention` on CPU tensors (its plain
forward and plain backward, `flash_attention_bwd_reference` — the
functions the card's kernels are held against) must give the gradients
of `jax.vjp` through the JAX package's `flash_attention`, whose custom
VJP runs the Pallas dq and dk/dv kernels in interpret mode, as the JAX
package's own tests run them on the CPU. Grid: causal and
bidirectional; group 1, 2 and 4; Sq > Skv with empty rows; Sq < Skv;
odd lengths; head dims 16 (`llama3_long_smoke`'s 4 q / 2 kv heads, and
MQA with one tensor as k and v, as MLA passes it) and 32; negative and
zero scales through the bf16 kernels' input transform. Tolerance: 1e-5
absolute and relative, float32 (the two frameworks sum in different
orders).

The kernels themselves run only on the card: `test_torch_kernels_cuda.py`.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu_torch import ops as tops
from solvingpapers_tpu_torch.kernels import build
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)


jfa = importlib.import_module("solvingpapers_tpu.kernels.flash_attention")
tfa = importlib.import_module("solvingpapers_tpu_torch.kernels.flash_attention")

TOL = 1e-5


def _inputs(seed, b, sq, skv, n, n_kv, d):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, sq, n, d)).astype(np.float32),
            r.standard_normal((b, skv, n_kv, d)).astype(np.float32),
            r.standard_normal((b, skv, n_kv, d)).astype(np.float32),
            r.standard_normal((b, sq, n, d)).astype(np.float32))


@pytest.mark.parametrize("b,sq,skv,n,n_kv,d,causal", [
    pytest.param(2, 32, 32, 4, 4, 16, True, id="mha_causal"),
    pytest.param(1, 32, 48, 4, 2, 16, False, id="gqa2_bidir_sq_lt_skv"),
    pytest.param(1, 24, 40, 4, 1, 16, True, id="mqa_causal_sq_lt_skv"),
    pytest.param(1, 40, 16, 4, 2, 16, True, id="sq_gt_skv_empty_rows"),
    pytest.param(2, 37, 37, 4, 2, 32, True, id="odd_37"),
    pytest.param(1, 21, 29, 8, 2, 16, False, id="gqa4_odd_bidir"),
    pytest.param(2, 64, 64, 4, 2, 16, True, id="llama3_long_smoke_d16"),
])
def test_flash_grads_match_jax_vjp(b, sq, skv, n, n_kv, d, causal):
    q, k, v, do = _inputs(0, b, sq, skv, n, n_kv, d)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))

    jo, vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, causal=causal,
                                               interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=TOL, atol=TOL)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=TOL,
                                   atol=TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("b,s,n", [(1, 40, 4), (2, 33, 8)])
def test_flash_grads_with_k_is_v_match_jax_vjp_at_d16(b, s, n):
    """MQA with one tensor as k and v (MLA's latent stream): its gradient
    is dk + dv, against `jax.vjp` of the JAX package's flash with the same
    tensor passed twice."""
    q, c, _, do = _inputs(6, b, s, s, n, 1, 16)
    tq, tc = (torch.from_numpy(x).requires_grad_() for x in (q, c))
    o = tfa.flash_attention(tq, tc, tc, causal=True)
    grads = torch.autograd.grad(o, (tq, tc), torch.from_numpy(do))
    jo, vjp = jax.vjp(
        lambda q_, c_: jfa.flash_attention(q_, c_, c_, causal=True,
                                           interpret=True),
        jnp.asarray(q), jnp.asarray(c))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=TOL,
                               atol=TOL)
    for name, g, jg in zip(("q", "c"), grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=TOL,
                                   atol=TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_transformed_scale_grads_match_jax_vjp(scale):
    """The bf16 kernels' path at a scale <= 0 — `positive_scale` before
    the autograd function, whose forward and backward see (q', scale' >
    0) — run here through the plain versions in float32: o and every
    gradient match `jax.vjp` of the JAX package's flash at the
    untransformed scale."""
    q, k, v, do = _inputs(7, 1, 32, 48, 4, 2, 16)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    qt, st = tfa.positive_scale(tq, scale)
    o = tfa._Flash.apply(qt, tk, tv, True, st, 0.0, 0)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    jo, vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, causal=True,
                                               scale=scale, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=TOL,
                               atol=TOL)
    for name, g, jg in zip("qkv", grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=TOL,
                                   atol=TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("b,sq,skv,n,n_kv,causal", [
    (2, 24, 24, 4, 2, True), (1, 16, 40, 4, 1, True), (1, 19, 23, 2, 2, False),
])
def test_bwd_reference_matches_dense_autograd(b, sq, skv, n, n_kv, causal):
    """The plain backward, fed the plain forward's lse and delta, gives
    torch.autograd's gradients through the dense op (rows all see a
    key)."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, b, sq, skv, n, n_kv, 32))
    o, lse = tfa.flash_attention_reference(q, k, v, causal=causal)
    got = tfa.flash_attention_bwd_reference(q, k, v, do, lse,
                                            tfa.flash_delta(do, o),
                                            causal=causal)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(
        tops.dot_product_attention(qr, kr, vr, causal=causal), (qr, kr, vr), do)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)


def test_bwd_reference_keeps_dtypes_and_zeroes_empty_rows():
    """Outputs in the inputs' dtypes; rows that see no key (Sq > Skv,
    causal) get dq = 0 and give nothing to dk, dv."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(2, 1, 24, 8, 4, 2, 16))
    o, lse = tfa.flash_attention_reference(q, k, v, causal=True)
    dq, dk, dv = tfa.flash_attention_bwd_reference(
        q, k, v, do, lse, tfa.flash_delta(do, o), causal=True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert (dq[:, :16] == 0).all()
    # the same backward restricted to the visible rows gives the same dk, dv
    o2, lse2 = tfa.flash_attention_reference(q[:, 16:], k, v, causal=True)
    _, dk2, dv2 = tfa.flash_attention_bwd_reference(
        q[:, 16:], k, v, do[:, 16:], lse2, tfa.flash_delta(do[:, 16:], o2),
        causal=True)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_delta_is_the_row_sum_of_do_times_o():
    do = torch.randn(2, 5, 3, 8)
    o = torch.randn(2, 5, 3, 8)
    delta = tfa.flash_delta(do, o)
    assert delta.shape == (6, 1, 5) and delta.dtype == torch.float32
    assert torch.allclose(delta[4, 0, 2], (do[1, 2, 1] * o[1, 2, 1]).sum())


def test_cpu_backward_never_touches_the_cuda_library(monkeypatch):
    """A CPU forward and backward compute the plain versions: the
    backward library is never built or loaded and no kernel launch is
    counted."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU path tried to build a kernel")

    monkeypatch.setattr(build, "ensure_built", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(tfa, "_bwd_lib", None)
    counts = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches,
              tfa.flash_attention_bwd_reference.calls)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(3, 1, 8, 8, 2, 2, 16))
    q.requires_grad_()
    tfa.flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is not None and tfa._bwd_lib is None
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches,
            tfa.flash_attention_bwd_reference.calls) == (
        counts[0], counts[1], counts[2] + 1)


@pytest.mark.parametrize("wrapper", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_kernel_wrappers_refuse_cpu_and_meta_tensors(wrapper):
    """The kernels' wrappers never compute anything off the card."""
    fn = getattr(tfa, wrapper)
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(4, 1, 8, 8, 2, 2, 16))
    lse = delta = torch.zeros(2, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fn(q, k, v, do, lse, delta, causal=True)
    meta = [x.to("meta") for x in (q, k, v, do, lse, delta)]
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*meta, causal=True)


def test_backward_dropout_and_shape_errors_raise():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, 1, 8, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="dropout rate"):
        tfa.flash_attention_bwd(q, k, v, do, torch.zeros(2, 1, 8),
                                torch.zeros(2, 1, 8), dropout_rate=1.5)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd(q, k, v, do, torch.zeros(2, 8),
                                torch.zeros(2, 1, 8))
    with pytest.raises(ValueError, match="dO"):
        tfa.flash_attention_bwd(q, k, v, do[:, :4], torch.zeros(2, 1, 8),
                                torch.zeros(2, 1, 8))


def test_backward_library_is_listed_for_the_build():
    assert build.LIBRARIES["flash_bwd"] == "flash_bwd.cu"
    assert (build.CSRC / "flash_bwd.cu").exists()
