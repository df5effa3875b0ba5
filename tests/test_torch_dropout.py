"""The port's residual dropout (`kernels.dropout.dropout`, an autograd
function over the `dropout_apply` kernel) on its plain path, on the CPU.

The plain version must be bit for bit what `dropout` computed before it
had a kernel, ``torch.where(keep, x / (1 - rate), 0)`` and its autograd
gradient, in float32 and bf16; and, fed the same keep mask, bit for bit
Flax's `nn.Dropout` formula ``jnp.where(keep, x / (1 - rate), 0)`` in
float32, evaluated op by op as JAX does eagerly (an IEEE division; under
`jit` XLA multiplies by the reciprocal instead, one ulp off in places).
The kernel is held against this plain version on the card
(`test_torch_kernels_cuda.py`, `chip_smoke.py`). The dense attention's
probability dropout, now one pass of `dropout`, equals its old two-pass
form, and GPT's dropout sites draw distinct masks that a remat
recomputation redraws. No tolerance anywhere: every comparison is exact.
"""

import importlib
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu_torch import kernels
from solvingpapers_tpu_torch import ops as tops
from solvingpapers_tpu_torch.kernels import build
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)


tdr = importlib.import_module("solvingpapers_tpu_torch.kernels.dropout")

SEED = 0x243F6A8885A308D3


def _x(seed, shape, dtype=torch.float32):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(dtype)


def _old_form(x, rate, seed):
    """`dropout` as it was before the apply kernel: the keep mask, then
    ``x / (1 - rate)`` and `torch.where`, differentiated by autograd."""
    s, d = x.shape[-2], x.shape[-1]
    keep = tdr.dropout_keep_reference(seed, rate, x.numel() // (s * d), s, d
                                      ).view(x.shape)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,rate", [
    ((2, 40, 24), 0.1), ((1, 33, 17), 0.5), ((3, 2, 5, 16), 0.25),
])
def test_plain_dropout_equals_the_old_where_form(dtype, shape, rate):
    """Forward and backward of the autograd function equal the old form's
    bit for bit, and the backward is the forward's map on the gradient."""
    x = _x(1, shape, dtype)
    g = _x(2, shape, dtype)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    y = tdr.dropout(xa, rate, SEED)
    want = _old_form(xb, rate, SEED)
    assert y.dtype == dtype and torch.equal(y, want)
    (ga,) = torch.autograd.grad(y, xa, g)
    (gb,) = torch.autograd.grad(want, xb, g)
    assert torch.equal(ga, gb)
    assert torch.equal(ga, tdr.dropout_apply_reference(g, rate, SEED))


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_plain_dropout_equals_flax_formula_with_the_same_mask(rate):
    """float32: ``jnp.where(keep, x / (1 - rate), 0)`` with the port's
    keep mask fed in gives the port's output bit for bit."""
    x = _x(3, (2, 64, 48))
    keep = tdr.dropout_keep_reference(SEED, rate, 2, 64, 48)
    flax = jnp.where(jnp.asarray(keep.numpy()), jnp.asarray(x.numpy()) / (1 - rate),
                     jnp.zeros_like(jnp.asarray(x.numpy())))
    got = tdr.dropout(x, rate, SEED)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(flax).view(np.uint32))


def test_cpu_dropout_counts_plain_calls_and_never_builds(monkeypatch):
    """On the CPU `dropout` runs the plain version once forward and once
    backward, counted in `.calls`; the kernel library is never built or
    loaded and no launch is counted; rate 0 is the identity."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU path tried to build the kernel")

    monkeypatch.setattr(build, "ensure_built", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(tdr, "_lib", None)
    kernels.reset_counts()
    x = _x(4, (1, 16, 32)).requires_grad_()
    tdr.dropout(x, 0.3, 5).sum().backward()
    assert x.grad is not None and tdr._lib is None
    assert tdr.dropout_apply_reference.calls == 2
    assert tdr.dropout_apply.launches == 0
    assert tdr.dropout(x, 0.0, 5) is x
    with pytest.raises(ValueError, match="dropout rate"):
        tdr.dropout(x, 1.0, 5)


def test_apply_kernel_wrapper_refuses_what_it_does_not_take():
    """The kernel's wrapper never computes off the card, and takes float32
    and bf16 only."""
    with pytest.raises(ValueError, match="CUDA"):
        tdr.dropout_apply(torch.zeros(1, 4, 16), 0.1, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tdr.dropout_apply(torch.zeros(1, 4, 16, device="meta"), 0.1, 0)


def test_gradient_of_a_non_contiguous_input_is_right():
    """The backward takes the gradient in x's logical layout: a transposed
    input's gradient is the map of the incoming gradient, element by
    element."""
    base = _x(5, (1, 24, 40)).requires_grad_()
    x = base.transpose(1, 2)  # (1, 40, 24), not contiguous
    g = _x(6, (1, 40, 24))
    y = tdr.dropout(x, 0.2, 9)
    assert torch.equal(y, _old_form(x.detach().contiguous(), 0.2, 9))
    (gx,) = torch.autograd.grad(y, base, g)
    assert torch.equal(gx.transpose(1, 2),
                       tdr.dropout_apply_reference(g, 0.2, 9))


def test_region_limits_raise():
    with pytest.raises(ValueError, match="range"):
        tdr._check_region(65536, 16, 16)
    with pytest.raises(ValueError, match="range"):
        tdr._check_region(1, 2**20, 2**17)
    tdr._check_region(65535, 16384, 512)


# ------------------------------------------ the dense attention, and GPT


def _old_dense_attention(q, k, v, rate, seed):
    """`ops.dot_product_attention`'s causal path as it was before its
    dropout became one pass: the keep mask drawn whole, then ``probs *
    keep / (1 - rate)`` before the cast."""
    b, s, n, _ = q.shape
    scores = torch.einsum("bqnh,bknh->bnqk", q, k).float() * q.shape[-1] ** -0.5
    scores = scores.masked_fill(~tops.causal_mask(s, s), tops.BIG_NEG)
    probs = torch.softmax(scores, dim=-1)
    keep = tdr.dropout_keep_reference(seed, rate, b * n, s, s).view(b, n, s, s)
    probs = (probs * keep / (1.0 - rate)).to(v.dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_attention_dropout_equals_the_old_two_pass_form(dtype):
    """The one-pass probability dropout gives the old form's output and
    q, k, v gradients bit for bit (on the CPU both run the plain keep
    function)."""
    q, k, v, g = (_x(10 + i, (2, 24, 2, 16), dtype) for i in range(4))
    grads = []
    for fn in (lambda *t: tops.dot_product_attention(
                   *t, causal=True, dropout_rate=0.2, dropout_seed=SEED,
                   deterministic=False),
               lambda *t: _old_dense_attention(*t, 0.2, SEED)):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ts)
        grads.append([out] + list(torch.autograd.grad(out, ts, g)))
    for new, old in zip(*grads):
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        assert torch.equal(new.detach().view(bits), old.detach().view(bits))


def test_gpt_dropout_sites_draw_distinct_masks_and_remat_redraws_them(monkeypatch):
    """In training, GPT draws dropout at the embedding and, per block, at
    the attention probabilities, the attention output and the MLP: each
    from its own seed, so their masks differ. Under remat the backward's
    recomputation draws the forward's seeds again, and the loss and every
    gradient equal the run without remat bit for bit."""
    from solvingpapers_tpu_torch.models.gpt import GPT, GPTConfig
    from solvingpapers_tpu_torch.ops import cross_entropy

    calls = []
    apply = tdr._apply

    def recording(x, rate, seed):
        calls.append((tuple(x.shape), seed, None))
        return apply(x, rate, seed)

    monkeypatch.setattr(tdr, "_apply", recording)
    cfg = GPTConfig(vocab_size=32, block_size=16, dim=32, n_layers=2, n_heads=2,
                    dropout=0.1)
    gen = torch.Generator().manual_seed(0)
    weights = {k: torch.randn(v.shape, generator=gen) * 0.1
               for k, v in GPT(cfg, device="cpu").state_dict().items()}
    tokens = torch.randint(0, 32, (2, 16), generator=gen)
    results, seeds = [], []
    for remat in (False, True):
        model = GPT(GPTConfig(**{**cfg.__dict__, "remat": remat}), device="cpu",
                    param_dtype=torch.float32)
        model.load_state_dict(weights)
        calls.clear()
        loss = cross_entropy(model(tokens, dropout_seed=123)[0], tokens)
        forward = list(calls)
        loss.backward()
        results.append([loss.detach()] + [p.grad for p in model.parameters()])
        seeds.append((forward, calls[len(forward):]))
    (fwd, bwd), (rfwd, rbwd) = seeds
    # embedding + 3 sites a block, each its own seed
    assert len(fwd) == 1 + 3 * cfg.n_layers
    assert len({s for _, s, _ in fwd}) == len(fwd)
    masks = [tdr.dropout_keep_reference(s, 0.1, *(shape[0] * (shape[1] if len(shape) == 4
                                                             else 1),) + shape[-2:])
             for shape, s, _ in fwd]
    for i in range(len(masks)):
        for j in range(i):
            if masks[i].shape == masks[j].shape:
                assert not torch.equal(masks[i], masks[j])
    assert sorted(s for _, s, _ in rfwd) == sorted(s for _, s, _ in fwd)
    # the backward applies each site's map again at its seed; under remat
    # it also recomputes each block (up to the last saved tensor it needs,
    # so a block's last dropout may be left out), with the forward's seeds
    assert Counter(s for _, s, _ in bwd) == Counter(s for _, s, _ in fwd)
    recomputed = Counter(s for _, s, _ in rbwd) - Counter(s for _, s, _ in bwd)
    sites = [s for _, s, _ in fwd[1:]]
    assert set(recomputed) <= set(sites) and all(n == 1 for n in recomputed.values())
    for layer in range(cfg.n_layers):
        assert set(sites[3 * layer:3 * layer + 3]) & set(recomputed), layer
    for a, b in zip(*results):
        assert torch.equal(a, b)
