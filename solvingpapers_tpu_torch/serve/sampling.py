"""Per-request sampling for the serving engine (port of
`solvingpapers_tpu/serve/sampling.py`, without the grammar allow path,
logprobs, stop sets and SLO tags, which are later slices).

* `SamplingParams` — the per-request knobs, validated at construction so
  a bad request fails at `submit`;
* `encode_params` — one request's knobs packed into the engine's
  slot-major mirrors (float row + top_k + seed);
* `fused_sample` — one sampler over the whole slot axis: greedy rows take
  ``argmax`` of the raw logits; stochastic rows draw inside the top
  `cap` logits after temperature scaling and the shared
  `ops.top_k_mask` / `top_p_mask` / `min_p_mask` truncations.

Randomness. The reference folds ``(seed, sample index)`` — or, for an
unseeded request, ``(engine step, slot, sample index)`` — into the
engine's base key with `jax.random.fold_in`. Here the same words are
hashed (splitmix64) into the seed of a counter-based `torch.Generator`
per draw, with the same contract: a seeded request's stream depends
only on its seed and the sample index (not on its slot, its neighbours
or how many engine steps ran first), so it repeats run to run; an
unseeded one draws fresh entropy per (step, slot, sample index). The
two packages' generators differ, so sampled tokens never match across
packages — only greedy streams are compared across them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from solvingpapers_tpu_torch import ops

# lead words separating the seeded chain from the engine-step chain (see
# the reference: an untagged step chain would alias seed=s after enough
# engine iterations)
_SEED_TAG = 0x5EED
_STEP_TAG = 0x57E9
_M64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling and termination knobs.

    temperature  0.0 = greedy argmax (token-exact with greedy `generate`);
                 > 0 scales logits before sampling.
    top_k        keep only the k most likely tokens (0 = off).
    top_p        nucleus: keep the smallest set with mass >= top_p (1 = off).
    min_p        drop tokens below ``min_p * max probability`` (0 = off).
    seed         rng seed for a reproducible stream (None = engine entropy).
    max_tokens   generation budget; overrides `submit`'s max_new_tokens.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    seed: int | None = None
    max_tokens: int | None = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy), got {self.temperature}"
            )
        if not 0 < self.top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if not 0 <= self.min_p <= 1:
            raise ValueError(f"min_p must be in [0, 1], got {self.min_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {self.top_k}")
        if self.seed is not None and not 0 <= self.seed < 2**31:
            # the seed rides an int32 mirror where -1 means "unseeded"
            raise ValueError(f"seed must be None or in [0, 2**31), got {self.seed}")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingParams()

# slot-major float mirror rows: temperature, top_p, min_p — the greedy /
# disabled resting state of a free lane
GREEDY_ROW = (0.0, 1.0, 0.0)


def encode_params(p: SamplingParams):
    """One request's knobs -> ((temperature, top_p, min_p), top_k, seed);
    seed -1 means unseeded."""
    seed = -1 if p.seed is None else int(p.seed)
    return (p.temperature, p.top_p, p.min_p), int(p.top_k), seed


class PackedSampling(NamedTuple):
    """Slot-major view of every slot's params, as (S,) device tensors."""

    temperature: torch.Tensor  # f32; 0 => greedy
    top_p: torch.Tensor        # f32; 1 => off
    min_p: torch.Tensor        # f32; 0 => off
    top_k: torch.Tensor        # int64; 0 => off


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def request_seed(base: int, step_tag: int, slot: int, seed: int,
                 samp_idx: int) -> int:
    """The generator seed of one draw. ``seed >= 0``: a function of
    (base, seed, sample index) only — reproducible across runs and slot
    assignments. ``seed < 0``: of (base, engine step, slot, sample index)."""
    words = ((base, _SEED_TAG, seed, samp_idx) if seed >= 0
             else (base, _STEP_TAG, step_tag, slot, samp_idx))
    h = 0
    for w in words:
        h = _splitmix64(h ^ (w & _M64))
    return h >> 1  # non-negative, inside manual_seed's range


def request_generator(base: int, step_tag: int, slot: int, seed: int,
                      samp_idx: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(request_seed(base, step_tag, slot, seed, samp_idx))
    return g


def capped_support(logits32: torch.Tensor, packed: PackedSampling, *, cap: int):
    """The bounded-support truncation: one top-`cap` selection, then
    temperature scaling (greedy rows scale by 1 — their token comes from
    argmax; the scale only keeps the row finite) and the shared top-k /
    top-p / min-p masks. Returns ``(masked, top_idx)``."""
    top_vals, top_idx = torch.topk(logits32, cap, dim=-1)
    temp = torch.where(packed.temperature <= 0.0,
                       torch.ones_like(packed.temperature),
                       packed.temperature)[:, None]
    scaled = top_vals / temp
    masked = ops.top_k_mask(scaled, packed.top_k[:, None])
    masked = ops.top_p_mask(masked, packed.top_p[:, None])
    masked = ops.min_p_mask(masked, packed.min_p[:, None])
    return masked, top_idx


def fused_sample(logits: torch.Tensor, packed: PackedSampling,
                 generators, *, cap: int = 64) -> torch.Tensor:
    """Sample one token per slot; returns (S,) int64.

    `logits` is (S, vocab); `generators` holds one `torch.Generator` per
    STOCHASTIC slot and None for greedy ones — the host knows which rows
    are greedy, so an all-greedy batch is argmax only, with no selection
    and no masking. Stochastic rows draw by Gumbel-max over the masked
    top-`cap` support (the same categorical the reference draws) and map
    back through the gathered vocab ids.
    """
    logits32 = logits.float()
    greedy_tok = torch.argmax(logits32, dim=-1)
    if all(g is None for g in generators):
        return greedy_tok
    cap = min(cap, logits.shape[-1])
    masked, top_idx = capped_support(logits32, packed, cap=cap)
    tiny = torch.finfo(torch.float32).tiny
    noise = torch.zeros_like(masked)
    for row, g in enumerate(generators):
        if g is not None:
            u = torch.rand(cap, generator=g, device=logits.device).clamp_min(tiny)
            noise[row] = -torch.log(-torch.log(u))
    sel = torch.argmax(masked + noise, dim=-1, keepdim=True)
    drawn = torch.gather(top_idx, -1, sel)[:, 0]
    return torch.where(packed.temperature <= 0.0, greedy_tok, drawn)
