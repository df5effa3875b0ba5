"""The port's residual dropout (`kernels.dropout.dropout`, an autograd
function over the `dropout_apply` kernel) on its plain path, on the CPU.

The plain version must be bit for bit what `dropout` computed before it
had a kernel, ``torch.where(keep, x / (1 - rate), 0)`` and its autograd
gradient, in float32 and bf16; and, fed the same keep mask, bit for bit
Flax's `nn.Dropout` formula ``jnp.where(keep, x / (1 - rate), 0)`` in
float32, evaluated op by op as JAX does eagerly (an IEEE division; under
`jit` XLA multiplies by the reciprocal instead, one ulp off in places).
The kernel is held against this plain version on the card
(`test_torch_kernels_cuda.py`, `chip_smoke.py`). No tolerance anywhere:
every comparison is exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu_torch import kernels
from solvingpapers_tpu_torch.kernels import build

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
