"""Token samplers (port of `solvingpapers_tpu/ops/sampling.py`: the
truncation masks the serving sampler shares, greedy argmax and
temperature + top-k sampling).

The `*_mask` helpers accept per-row cutoffs (`k`/`p`/`min_p` may be
tensors broadcastable against ``logits[..., :1]``), so every slot of a
batched decode step can carry different sampling params; disabled
values (k <= 0, p >= 1, min_p <= 0) keep every token.
"""

from __future__ import annotations

import torch


def _as_tensor(x, like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=like.device)


def top_k_mask(logits: torch.Tensor, k) -> torch.Tensor:
    """Mask all but the `k` largest logits per row to -inf. ``k <= 0``
    disables the mask for that row; ties at the k-th value are all kept."""
    k = _as_tensor(k, logits, torch.int64)
    vocab = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    idx = (k - 1).clamp(0, vocab - 1).expand(logits.shape[:-1] + (1,))
    thresh = torch.gather(sorted_desc, -1, idx)
    keep = (logits >= thresh) | (k <= 0)
    return torch.where(keep, logits, torch.full_like(logits, -torch.inf))


def top_p_mask(logits: torch.Tensor, p) -> torch.Tensor:
    """Nucleus mask: keep the smallest prefix of descending-probability
    tokens whose cumulative mass reaches `p` (the token that crosses `p`
    is kept); mask the rest to -inf. ``p >= 1`` keeps every token with
    nonzero probability."""
    probs = torch.softmax(logits, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sorted_probs, dim=-1)
    # token i (sorted) is kept iff the mass BEFORE it is < p
    keep_sorted = (cum - sorted_probs) < _as_tensor(p, logits, logits.dtype)
    kth = keep_sorted.sum(dim=-1, keepdim=True) - 1
    thresh = torch.gather(sorted_probs, -1, kth)
    return torch.where(probs >= thresh, logits,
                       torch.full_like(logits, -torch.inf))


def min_p_mask(logits: torch.Tensor, min_p) -> torch.Tensor:
    """Keep tokens whose probability is >= ``min_p * max probability``;
    ``min_p <= 0`` disables. The argmax is always kept."""
    probs = torch.softmax(logits, dim=-1)
    thresh = _as_tensor(min_p, logits, logits.dtype) * probs.amax(
        dim=-1, keepdim=True
    )
    return torch.where(probs >= thresh, logits,
                       torch.full_like(logits, -torch.inf))


def allowed_logits(logits: torch.Tensor, allow: torch.Tensor):
    """Gather `logits` at the `allow` token ids; -1 pads gather index 0
    but land at -inf, so padded entries are never chosen.

    `allow` is (..., A) integer token ids with -1 padding — the serving
    engine's grammar-constrained allow-list (`serve/grammar.py`).
    Returns ``(vals, idx)``: the gathered (-inf-padded) logit row over
    the allowed support and the (clamped) gather ids — the (values,
    indices) shape `torch.topk` gives, so `serve.sampling.fused_sample`
    swaps one for the other per row and every truncation mask applies
    unchanged."""
    idx = allow.clamp(0, logits.shape[-1] - 1).long()
    vals = torch.gather(logits, -1, idx)
    return torch.where(allow >= 0, vals, torch.full_like(vals, -torch.inf)), idx


def sample_greedy(logits: torch.Tensor, generator=None) -> torch.Tensor:
    """Argmax over the last axis; the FIRST maximal index wins, as with
    `jnp.argmax`. `generator` is accepted (ignored) for API uniformity."""
    del generator
    return torch.argmax(logits, dim=-1)


def sample_top_k(logits: torch.Tensor, generator: torch.Generator | None = None,
                 *, k: int = 50, temperature: float = 1.0) -> torch.Tensor:
    """Temperature + top-k sampling: float32 logits over `temperature`,
    every logit below the k-th largest of its row masked to -inf (ties at
    the k-th value kept, as the reference's threshold keeps them), one
    categorical draw per row from `generator`. The reference draws with
    `jax.random.categorical`; the same distribution, other bits."""
    logits = logits.float() / temperature
    kth = torch.topk(logits, min(k, logits.shape[-1]), dim=-1).values[..., -1:]
    masked = torch.where(logits >= kth, logits, -torch.inf)
    probs = torch.softmax(masked, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(
        probs.shape[:-1])
