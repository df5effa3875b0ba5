"""The port's MoE routing and dispatch (`ops/moe.py`) vs the JAX
package's, on the same numpy-made inputs.

Every ported function is held against its reference: the top-k gate
(with ties at the k-th logit, where the reference selects every tied
entry), the aux-free bias update, the expert load, the capacity rule,
the slot assignment, the capacity-slot dispatch/combine (with a
capacity small enough to drop pairs, and the sentinel slot), the drop
fraction, the balance stats and the dense combine. The port moves rows
by index gathers where the reference multiplies by a one-hot (T, E, C)
tensor; a slot holds at most one token, so the two agree exactly up to
float32 summation order. Tolerances: float32 1e-6 (routing, stats) and
1e-5 (expert outputs through three matmuls); bfloat16 combine within
one bf16 ulp of the largest output (2**-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solvingpapers_tpu.ops import moe as jmoe
from solvingpapers_tpu.ops.activations import swish as j_swish
from solvingpapers_tpu_torch import ops
from solvingpapers_tpu_torch.ops import moe as tmoe
from test_torch_threads import _one_torch_thread  # noqa: F401 (autouse)


F32_TOL, EXPERT_TOL = 1e-6, 1e-5


def _close(t, j, tol=F32_TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def _logits(seed, t, e, ties=False):
    """(T, E) float32 gate logits; with `ties`, every third row has a tie
    for the top and every third row three entries tied at its second
    largest value (so top-2 selects more than two there)."""
    x = np.random.default_rng(seed).standard_normal((t, e)).astype(np.float32)
    if ties:
        x[::3, 1] = x[::3, 0]  # a tie for the top
        srt = np.sort(x[1::3], axis=1)[:, ::-1]
        x[1::3, :3] = srt[:, 1:2]  # three entries tied at the 2nd largest
    return x


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_topk_gate_probs_match_reference(k, ties):
    x = _logits(0, 48, 8, ties)
    got = tmoe.topk_gate_probs(torch.from_numpy(x), k)
    want = jmoe.topk_gate_probs(jnp.asarray(x), k)
    assert got.dtype == torch.float32
    _close(got, want)
    assert torch.equal(got > 0, torch.from_numpy(np.asarray(want) > 0))
    if ties and k == 2:
        # the tie rule selects more than k in the tied rows
        assert int((got > 0).sum(-1).max()) > 2


def test_topk_gate_probs_from_bf16_logits():
    x = _logits(1, 32, 8)
    got = tmoe.topk_gate_probs(torch.from_numpy(x).bfloat16(), 2)
    want = jmoe.topk_gate_probs(jnp.asarray(x, jnp.bfloat16), 2)
    _close(got, want)


def _probs(seed, t, e, k=2, ties=False):
    x = _logits(seed, t, e, ties)
    return (tmoe.topk_gate_probs(torch.from_numpy(x), k),
            jmoe.topk_gate_probs(jnp.asarray(x), k))


def test_expert_load_and_bias_update_match_reference():
    tp, jp = _probs(2, 64, 8)
    _close(tmoe.expert_load(tp), jmoe.expert_load(jp))
    bias = np.random.default_rng(3).standard_normal(8).astype(np.float32) * 1e-3
    got = tmoe.aux_free_bias_update(tp, torch.from_numpy(bias), 0.001)
    want = jmoe.aux_free_bias_update(jp, jnp.asarray(bias), 0.001)
    _close(got, want)
    ci = tmoe.expert_load(tp)
    assert torch.equal(got, tmoe.aux_free_bias_update(tp, torch.from_numpy(bias),
                                                      0.001, ci=ci))
    # an overloaded expert moves down, a starved one up
    skew = torch.zeros(40, 4)
    skew[:30, 0], skew[30:, 1], skew[30:, 2] = 1.0, 0.5, 0.5
    new = tmoe.aux_free_bias_update(skew, torch.zeros(4), 0.001)
    assert new[0] < 0 < new[3]


@pytest.mark.parametrize("t,e,k,cf", [(16384, 8, 2, 2.0), (64, 4, 2, 1.0),
                                      (10, 8, 2, 0.5), (3, 4, 1, 1.25)])
def test_expert_capacity_matches_reference(t, e, k, cf):
    assert tmoe.expert_capacity(t, e, k, cf) == jmoe.expert_capacity(t, e, k, cf)


@pytest.mark.parametrize("capacity", [8, 16, 64])
def test_dispatch_slots_match_reference(capacity):
    tp, jp = _probs(4, 64, 4, ties=True)
    got = tmoe._dispatch_slots(tp, capacity)
    want = jmoe._dispatch_slots(jp, capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _experts(seed, e, d, h):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32) * 0.2
            for s in ((e, d, h), (e, d, h), (e, h, d))]


def _expert_fns(w, backend):
    if backend == "jax":
        w1, w2, w3 = (jnp.asarray(x) for x in w)

        def f(xe):
            a = jnp.einsum("ecd,edh->ech", xe, w1.astype(xe.dtype))
            g = jnp.einsum("ecd,edh->ech", xe, w2.astype(xe.dtype))
            return jnp.einsum("ech,ehd->ecd", j_swish(a) * g, w3.astype(xe.dtype))

        def f_all(xt):
            a = jnp.einsum("td,edh->eth", xt, w1.astype(xt.dtype))
            g = jnp.einsum("td,edh->eth", xt, w2.astype(xt.dtype))
            return jnp.einsum("eth,ehd->etd", j_swish(a) * g, w3.astype(xt.dtype))

        return f, f_all
    w1, w2, w3 = (torch.from_numpy(x) for x in w)

    def f(xe):
        a, g = torch.bmm(xe, w1.to(xe.dtype)), torch.bmm(xe, w2.to(xe.dtype))
        return torch.bmm(ops.swish(a) * g, w3.to(xe.dtype))

    def f_all(xt):
        a, g = torch.matmul(xt, w1.to(xt.dtype)), torch.matmul(xt, w2.to(xt.dtype))
        return torch.matmul(ops.swish(a) * g, w3.to(xt.dtype))

    return f, f_all


@pytest.mark.parametrize("capacity", [8, 24, 64], ids=["drops", "some", "ample"])
def test_dispatch_combine_matches_reference(capacity):
    """Capacity-slot MoE equals the reference's one-hot einsums, dropping
    the same (token, expert) pairs; the drop fraction agrees too."""
    t, e, d, h = 64, 4, 16, 24
    tp, jp = _probs(5, t, e, ties=True)
    x = np.random.default_rng(6).standard_normal((t, d)).astype(np.float32)
    w = _experts(7, e, d, h)
    tf, _ = _expert_fns(w, "torch")
    jf, _ = _expert_fns(w, "jax")
    got = tmoe.moe_dispatch_combine(torch.from_numpy(x), tp, tf, capacity)
    want = jmoe.moe_dispatch_combine(jnp.asarray(x), jp, jf, capacity)
    _close(got, want, EXPERT_TOL)
    drop = tmoe.dispatch_drop_fraction(tp, capacity)
    _close(drop, jmoe.dispatch_drop_fraction(jp, capacity))
    if capacity == 8:
        assert drop.item() > 0.3  # the case drops pairs
    if capacity == 64:
        assert drop.item() == 0.0


def test_dispatch_combine_bf16_and_its_gradient():
    """bf16 inputs: the combine weights are cast to bf16 before weighting,
    as the reference does; the output agrees within one bf16 ulp of its
    largest value. The float32 gradient through the gathers equals the
    reference's gradient through the one-hot einsums."""
    t, e, d, h = 48, 4, 16, 24
    tp, jp = _probs(8, t, e)
    x = np.random.default_rng(9).standard_normal((t, d)).astype(np.float32)
    w = _experts(10, e, d, h)
    tf, _ = _expert_fns(w, "torch")
    jf, _ = _expert_fns(w, "jax")
    got = tmoe.moe_dispatch_combine(torch.from_numpy(x).bfloat16(), tp, tf, 16)
    want = np.asarray(jmoe.moe_dispatch_combine(jnp.asarray(x, jnp.bfloat16), jp,
                                                jf, 16), np.float32)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2.0**-8 * np.abs(want).max()

    xt = torch.from_numpy(x).requires_grad_()
    pt = tp.clone().requires_grad_()
    out = tmoe.moe_dispatch_combine(xt, pt, tf, 16)
    cot = np.random.default_rng(11).standard_normal((t, d)).astype(np.float32)
    gx, gp = torch.autograd.grad(out, (xt, pt), torch.from_numpy(cot))
    jgx, jgp = jax.grad(
        lambda xx, pp: jnp.sum(jmoe.moe_dispatch_combine(xx, pp, jf, 16) * cot),
        argnums=(0, 1))(jnp.asarray(x), jp)
    _close(gx, jgx, EXPERT_TOL)
    _close(gp, jgp, EXPERT_TOL)


def test_dense_combine_matches_reference():
    t, e, d, h = 32, 4, 16, 24
    tp, jp = _probs(12, t, e)
    x = np.random.default_rng(13).standard_normal((t, d)).astype(np.float32)
    w = _experts(14, e, d, h)
    _, tf_all = _expert_fns(w, "torch")
    _, jf_all = _expert_fns(w, "jax")
    got = tmoe.moe_dense_combine(torch.from_numpy(x), tp, tf_all)
    _close(got, jmoe.moe_dense_combine(jnp.asarray(x), jp, jf_all), EXPERT_TOL)
    # with capacity for every pair, dispatch equals the dense path
    tf, _ = _expert_fns(w, "torch")
    _close(tmoe.moe_dispatch_combine(torch.from_numpy(x), tp, tf, t), got,
           EXPERT_TOL)


@pytest.mark.parametrize("skew", [False, True], ids=["random", "collapsed"])
def test_load_balance_stats_match_reference(skew):
    tp, jp = _probs(15, 64, 8)
    if skew:
        tp = torch.zeros(64, 8)
        tp[:, 3] = 1.0
        jp = jnp.asarray(tp.numpy())
    got = tmoe.load_balance_stats(tp)
    want = jmoe.load_balance_stats(jp)
    assert set(got) == set(want)
    for key in got:
        _close(got[key], want[key])
    if skew:
        assert got["load_max_fraction"].item() == 1.0
        assert got["load_entropy"].item() < 1e-6
