"""Mixture-of-Experts routing and dispatch (port of the single-device part
of `solvingpapers_tpu/ops/moe.py`).

The reference routes tokens to per-expert capacity slots through a
one-hot (T, E, C) tensor and three einsums. At DeepSeek-V3's training
shape (T 16384, E 8, C 8192) that tensor alone is 1.07e9 elements, so
the port computes the same slots — the same token-order cumsum, the same
capacity rule for dropped pairs — and moves the rows with an index
gather into the slots and an `index_add` back to the tokens instead:
each slot holds at most one token, so they equal the one-hot products
exactly. No step reads a count back to the host.

`rows > 1` ranks the (token, expert) pairs within each of `rows` equal
groups of tokens against a capacity per group: what each group would
meet as its own forward (the serving engine's pooled decode, one group
a slot). The kept pairs then fill one shared set of slots per expert,
``rows * min(capacity, T / rows)`` wide, which holds every pair a
group can keep.

The sliced and all-to-all expert-parallel forms need a mesh (ROADMAP
A7) and are not ported.
"""

from __future__ import annotations

import torch

from solvingpapers_tpu_torch.ops.attention import BIG_NEG


def topk_gate_probs(gate_logits: torch.Tensor, k: int) -> torch.Tensor:
    """(T, E) logits -> (T, E) float32 probs: softmax over the entries at
    or above the k-th largest logit of each row, zero elsewhere. A tie at
    the k-th value selects every tied entry, as the reference does."""
    logits32 = gate_logits.float()
    kth = torch.topk(logits32, k, dim=-1).values[..., -1:]
    masked = torch.where(logits32 >= kth, logits32, BIG_NEG)
    return torch.softmax(masked, dim=-1)


def expert_load(probs: torch.Tensor) -> torch.Tensor:
    """(E,) routed probability mass per expert, detached."""
    return probs.detach().float().sum(0)


def aux_free_bias_update(probs: torch.Tensor, bias: torch.Tensor, rate: float,
                         ci: torch.Tensor | None = None) -> torch.Tensor:
    """The new routing bias ``bias + rate * sign(mean(c) - c)``, c the
    per-expert load (`ci` when given). Pure: the caller installs it."""
    if ci is None:
        ci = expert_load(probs)
    return bias + rate * torch.sign(ci.mean() - ci).to(bias.dtype)


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Per-expert slot count for dispatch: ceil(T*k/E * cf), 8-aligned."""
    c = int(n_tokens * top_k / n_experts * capacity_factor)
    return max(8, -(-c // 8) * 8)


def _column_rank(sel: torch.Tensor) -> torch.Tensor:
    """(..., T, E) bool -> the running count of True down each expert's
    column, minus 1, scanned along a contiguous axis: a scan down the
    token axis of a (T, E) tensor has only E independent columns to
    spread over the card."""
    return sel.transpose(-1, -2).to(torch.int32).contiguous().cumsum(
        dim=-1).transpose(-1, -2) - 1


def _slots_per_expert(t: int, capacity: int, rows: int) -> int:
    """Width of each expert's slot queue: `capacity`, or with `rows`
    groups every pair the groups can keep."""
    return capacity if rows == 1 else rows * min(capacity, t // rows)


def _dispatch_slots(probs: torch.Tensor, capacity: int, rows: int = 1):
    """Slot assignment shared by dispatch and the drop metric: sel = routed
    (token, expert) pairs, pos = slot index within the expert's queue
    (ordered by token id), keep = pairs inside capacity (per group of
    tokens with `rows` > 1)."""
    sel = probs > 0.0
    if rows == 1:
        pos = _column_rank(sel)  # (T, E)
        return sel, pos, sel & (pos < capacity)
    t, e = sel.shape
    if t % rows:
        raise ValueError(f"{t} tokens do not split into {rows} equal rows")
    keep = sel & (_column_rank(sel.view(rows, t // rows, e)).reshape(t, e)
                  < capacity)
    return sel, _column_rank(keep), keep


def _slot_sources(probs: torch.Tensor, capacity: int, rows: int = 1):
    """(src, filled) over the E * width slots (`_slots_per_expert`),
    expert-major: filled[s] says whether a kept pair occupies slot s,
    src[s] is its token. An empty slot gets a row of its own (s mod T),
    read and weighted 0: a row shared by every empty slot would take all
    their gradient adds in the backward, one after another."""
    t, e = probs.shape
    width = _slots_per_expert(t, capacity, rows)
    n = e * width
    _, pos, keep = _dispatch_slots(probs, capacity, rows)
    experts = torch.arange(e, device=probs.device)[None, :]
    slot = torch.where(keep, experts * width + pos, n)  # n: dropped
    tokens = torch.arange(t, device=probs.device)[:, None].expand(t, e)
    slot_token = torch.full((n + 1,), t, dtype=torch.long, device=probs.device)
    slot_token.scatter_(0, slot.reshape(-1), tokens.reshape(-1))
    filled = slot_token[:n] < t
    spread = torch.arange(n, device=probs.device) % t
    return torch.where(filled, slot_token[:n], spread), filled


def moe_dispatch_combine(x: torch.Tensor, probs: torch.Tensor, expert_fn,
                         capacity: int, rows: int = 1) -> torch.Tensor:
    """Capacity-slot MoE: route (T, D) tokens to (E, C, D) slots, run
    `expert_fn((E, C, D)) -> (E, C, D)`, combine back weighted by probs
    cast to x's dtype (the reference's rounding), summed in float32.
    Pairs past an expert's capacity (per group of T / `rows` tokens) are
    dropped for that expert; empty slots hold zero rows, as the
    reference's one-hot product gives."""
    t, e = probs.shape
    width = _slots_per_expert(t, capacity, rows)
    n = e * width
    src, filled = _slot_sources(probs, capacity, rows)
    mask = filled.to(x.dtype)
    xe = x.index_select(0, src) * mask[:, None]
    ye = expert_fn(xe.view(e, width, x.shape[1])).reshape(n, -1)
    expert = torch.arange(n, device=x.device) // width
    w = probs.to(x.dtype).reshape(-1).index_select(0, src * e + expert) * mask
    out = torch.zeros(t, ye.shape[1], dtype=torch.float32, device=x.device)
    return out.index_add(0, src, ye.float() * w.float()[:, None]).to(x.dtype)


def dispatch_drop_fraction(probs: torch.Tensor, capacity: int,
                           rows: int = 1) -> torch.Tensor:
    """Fraction of routed (token, expert) pairs that `moe_dispatch_combine`
    drops at this capacity and `rows` (the same slot assignment),
    detached."""
    sel, _, keep = _dispatch_slots(probs.detach(), capacity, rows)
    kept = keep.float().sum()
    routed = sel.float().sum()
    return (routed - kept) / torch.clamp(routed, min=1.0)


def load_balance_stats(probs: torch.Tensor,
                       ci: torch.Tensor | None = None) -> dict:
    """load_entropy (normalized to [0, 1]; 1 = balanced) and
    load_max_fraction (1/E = balanced, 1 = collapsed) of the routed load,
    detached; `ci`: precomputed load."""
    if ci is None:
        ci = expert_load(probs)
    e = probs.shape[-1]
    load = ci / torch.clamp(ci.sum(), min=1e-9)
    entropy = -(load * torch.log(load + 1e-9)).sum() / torch.log(
        torch.tensor(float(e), device=load.device))
    return {"load_entropy": entropy, "load_max_fraction": load.max()}


def moe_dense_combine(x: torch.Tensor, probs: torch.Tensor,
                      expert_fn_all) -> torch.Tensor:
    """Drop-free path: every expert on every token,
    `expert_fn_all((T, D)) -> (E, T, D)`, combined by probs in x's dtype."""
    ye = expert_fn_all(x)
    return torch.einsum("te,etd->td", probs.to(x.dtype), ye)
