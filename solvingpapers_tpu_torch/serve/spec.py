"""Speculative decoding for the serving engine: per-slot draft-and-verify
with lossless verification (port of `solvingpapers_tpu/serve/spec.py`:
the n-gram drafter here; the MTP drafter's head rounds live in the
engine, `serve/engine.py` `_spec_rounds`).

The plain decode block advances every slot ONE token per forward. A
speculative block turns each forward into a DRAFT-AND-VERIFY round: a
cheap drafter proposes up to `k` next tokens per slot, one chunked
forward computes the model's distributions at all ``1 + k`` positions,
and the drafts are verified against them, committing between 1 and
``k + 1`` tokens per forward with the output distribution unchanged:

* greedy slots accept a draft iff it equals its row's argmax, so every
  committed token IS the model's argmax given its prefix: the stream is
  token-identical to plain greedy decoding;
* stochastic slots draw each row from the request's truncated
  distribution (`capped_support`, shared with `fused_sample`) and accept
  the draft iff the draw equals it. Accepting iff the draw equals the
  draft accepts with probability ``p(d)``; after a rejection the row's
  draw is a draw of ``p`` conditioned on differing from the draft, which
  is the residual ``p`` with the draft removed and renormalized; after a
  clean sweep the bonus row is a full draw. These are the reference's
  three branches (accept with probability p(d), residual redraw at the
  cut, bonus draw), realized with ONE Gumbel-max draw per committed
  index instead of a uniform and a categorical, keyed by (seed,
  committed index) exactly as the plain block's draw of that index
  (`serve.sampling.draw_keys`, `gumbel_pick`). So the committed token at
  every index is the plain sampler's: a seeded stream is the same with
  speculation on or off, whatever the rounds, the drafts or the
  controller did, and through a paged preemption (whose resume prefill
  discards its own draw and decode goes on at the next index).

`ngram_drafts` is the model-free prompt-lookup self-drafter: the most
recent earlier occurrence of the stream's trailing n-gram in its own
history (prompt + committed tokens) proposes the tokens that followed
it. It runs as tensor ops batched over the slots on the device, inside
the block's rounds, because round r+1's drafts depend on round r's
device-side commits.

`SpecController` is the host-side adaptive policy (the reference's,
unchanged): speculation pays only while drafts get accepted, so an
engine whose acceptance falls under `min_rate` drops to the plain block
for a hold that doubles on each failed probe.
"""

from __future__ import annotations

import torch

from solvingpapers_tpu_torch.serve.sampling import (
    PackedSampling,
    capped_support,
    gumbel_pick,
)

DRAFTERS = ("ngram", "mtp")


# ---------------------------------------------------------------- drafting


def ngram_drafts(hist: torch.Tensor, length: torch.Tensor, *, k: int,
                 nmax: int = 3):
    """Prompt-lookup drafts for every slot at once.

    `hist` is the (S, H) token history (prompt plus every committed
    token, garbage beyond `length`) and `length` the (S,) live counts.
    Tries tail n-grams from `nmax` down to 1: the first n whose trailing
    n-gram ``hist[length-n:length]`` recurs earlier wins, and the
    proposal is the (up to) `k` tokens that FOLLOWED its most recent
    earlier occurrence. Returns ``(drafts (S, k) long, avail (S,) long)``
    with ``avail`` the usable draft count (0 = nothing to propose).

    Matches must end strictly before the final n-gram (``j + n <=
    length - 1``), so the trivial self-match never proposes, and drafts
    are clipped to committed history. Element for element the
    reference's per-slot function under `vmap`.
    """
    hist = hist.long()
    length = length.long()
    s_n, big = hist.shape
    idx = torch.arange(big, device=hist.device)
    best_start = torch.zeros(s_n, dtype=torch.long, device=hist.device)
    found = torch.zeros(s_n, dtype=torch.bool, device=hist.device)
    # longest n-gram first; ties at one n break toward the most recent
    for n in range(nmax, 0, -1):
        match = torch.ones((s_n, big), dtype=torch.bool, device=hist.device)
        for t in range(n):
            key_t = torch.gather(
                hist, 1, torch.clamp(length - n + t, 0, big - 1)[:, None])
            match = match & (torch.roll(hist, -t, dims=1) == key_t)
        match = match & (idx[None, :] + n <= (length - 1)[:, None])
        j = torch.where(match, idx[None, :], -1).max(dim=1).values
        hit = (j >= 0) & (length > n)
        take = hit & ~found
        best_start = torch.where(take, j + n, best_start)
        found = found | hit
    start = torch.clamp(best_start, 0, big - 1)
    cols = torch.clamp(start[:, None] + torch.arange(k, device=hist.device),
                       0, big - 1)
    drafts = torch.gather(hist, 1, cols)
    avail = torch.where(found, torch.clamp(length - start, 0, k),
                        torch.zeros_like(length))
    return drafts, avail


# ------------------------------------------------------------ verification


def spec_verify(logits: torch.Tensor, drafts: torch.Tensor,
                avail: torch.Tensor, packed: PackedSampling,
                keys: torch.Tensor | None = None, *, cap: int,
                allow: torch.Tensor | None = None, need_lp: bool = False):
    """Verify one round of drafts and emit the committed-token matrix.

    ``logits`` is (S, L, V) with ``L = k + 1``: row i is the model's
    distribution for the i-th position of the commit window (row j
    verifies draft j; row ``a``, the first rejection or ``avail``, gives
    the correction or bonus token). ``drafts`` (S, k) and ``avail`` (S,)
    come from the drafter (avail 0 = no draft). ``keys`` are the rows'
    (S, L) draw keys (row i of slot s: its draw of committed index
    ``count + i``; `serve.sampling.draw_keys`), None when every slot is
    greedy. `allow` is the (S, cap)
    grammar allow-list; it constrains ROW 0 ONLY (such slots ride with
    avail 0). Returns ``(out (S, L) long, commits (S,) long, logprobs
    (S, L) f32 or None)``: the host keeps ``out[s, :commits[s]]``;
    logprobs (the log-softmax of the raw logits at `out`) come back only
    with `need_lp`.

    With every slot greedy and none constrained (the host knows: `keys`
    and `allow` are None) the branch is argmax and a cumulative product
    only: no selection, no masking, no draw. Otherwise each row's token
    is the draw `fused_sample` would make from it (greedy rows: their
    argmax, inside the allow-list on a constrained row 0), and a draft is
    accepted iff it equals its row's token (see the module's docstring
    for why that is the reference's rejection sampling).
    """
    s_n, big_l, vocab = logits.shape
    k = big_l - 1
    logits32 = logits.float()
    within = (torch.arange(k, device=logits.device)[None, :]
              < avail[:, None])
    tok = torch.argmax(logits32, dim=-1)  # (S, L)
    if keys is not None or allow is not None:
        cap = min(cap, vocab)
        flat = logits32.reshape(s_n * big_l, vocab)
        knobs = PackedSampling(*(x.repeat_interleave(big_l) for x in packed))
        allow_rows = None
        if allow is not None:
            if allow.shape[-1] > cap:
                allow = allow[:, :cap]
            elif allow.shape[-1] < cap:
                allow = torch.nn.functional.pad(
                    allow, (0, cap - allow.shape[-1]), value=-1)
            # the grammar mask constrains row 0 only: rows >= 1 of a
            # constrained slot are discarded overshoot (avail 0)
            allow_rows = torch.full((s_n, big_l, cap), -1, dtype=allow.dtype,
                                    device=allow.device)
            allow_rows[:, 0] = allow
            allow_rows = allow_rows.reshape(s_n * big_l, cap)
        masked, top_idx = capped_support(flat, knobs, cap=cap, allow=allow_rows)
        masked = masked.reshape(s_n, big_l, cap)
        top_idx = top_idx.reshape(s_n, big_l, cap)
        if allow is not None:
            # greedy under a constraint = argmax over the allowed domain
            dom = torch.gather(top_idx[:, 0], -1,
                               torch.argmax(masked[:, 0], -1, keepdim=True))[:, 0]
            tok[:, 0] = torch.where(allow[:, 0] >= 0, dom, tok[:, 0])
        if keys is not None:
            drawn = gumbel_pick(masked, top_idx, keys)
            tok = torch.where((packed.temperature <= 0.0)[:, None], tok, drawn)
    acc = (tok[:, :k] == drafts) & within
    commits = torch.cumprod(acc.long(), dim=1).sum(dim=1) + 1
    lps = None
    if need_lp:
        chosen = torch.gather(logits32, -1, tok[..., None])[..., 0]
        lps = chosen - torch.logsumexp(logits32, dim=-1)
    return tok, commits, lps


# ------------------------------------------------------- adaptive control


class SpecController:
    """Host-side adaptive speculation policy (one per engine).

    Speculation pays for itself only while drafts get accepted: each
    round forwards ``1 + k`` positions to commit ``1 + accepted``. The
    controller runs a three-state loop:

    * ``probe`` (the cold-start state): the next spec step runs only a
      couple of rounds, a cheap acceptance measurement. Acceptance at or
      above `min_rate` (accepted drafts per round) promotes to ``full``;
      below it the engine drops to plain blocks for a hold.
    * ``full``: full `spec_rounds` blocks, with an EMA of per-round
      acceptance; the EMA sinking under `min_rate` demotes to a hold.
    * hold: plain blocks for `probe_every` steps, DOUBLING on every
      failed probe (capped at ``probe_every x max_hold_mult``).

    The acceptance EMA resets on demotion, so a probe is judged on its
    own evidence.
    """

    def __init__(self, min_rate: float = 1.0, probe_every: int = 8,
                 decay: float = 0.7, max_hold_mult: int = 16):
        if probe_every < 1:
            raise ValueError(f"probe_every must be >= 1, got {probe_every}")
        self.min_rate = min_rate
        self.probe_every = probe_every
        self.decay = decay
        self.max_hold = probe_every * max_hold_mult
        self.ema: float | None = None
        self._mode = "probe"  # cold start: measure before committing
        self._hold = 0
        self._hold_len = probe_every
        self.fallback_steps = 0
        self.probes = 0

    def decide(self) -> str:
        """Called once per decode step: "full" = full spec block,
        "probe" = short measurement block, "off" = plain block."""
        if self._hold > 0:
            self._hold -= 1
            self.fallback_steps += 1
            return "off"
        if self._mode == "probe":
            self.probes += 1
            return "probe"
        return "full"

    def hold(self, steps: int) -> None:
        """External hold (the degradation ladder's rung 2): force plain
        blocks for at least `steps` upcoming decode steps without
        touching the acceptance EMA or the backoff schedule."""
        if steps > 0:
            self._hold = max(self._hold, steps)

    def observe(self, accepted: int, rounds: int) -> None:
        """Feed one spec call's outcome (accepted drafts over `rounds`
        draft-verify rounds across the drafting slots)."""
        if rounds <= 0:
            return
        rate = accepted / rounds
        self.ema = rate if self.ema is None else (
            self.decay * self.ema + (1.0 - self.decay) * rate)
        if self.ema >= self.min_rate:
            self._mode = "full"
            self._hold_len = self.probe_every  # recovered: reset backoff
        else:
            self._mode = "probe"
            self._hold = self._hold_len
            self._hold_len = min(self._hold_len * 2, self.max_hold)
            self.ema = None  # the next probe is judged fresh

    def stats(self) -> dict:
        return {
            "acceptance_ema": (round(self.ema, 4)
                               if self.ema is not None else None),
            "mode": "hold" if self._hold > 0 else self._mode,
            "fallback_steps": self.fallback_steps,
            "probes": self.probes,
        }


__all__ = ["DRAFTERS", "SpecController", "ngram_drafts", "spec_verify"]
