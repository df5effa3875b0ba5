"""Per-request sampling for the serving engine (port of
`solvingpapers_tpu/serve/sampling.py`).

* `SamplingParams` — the per-request knobs, validated at construction so
  a bad request fails at `submit`;
* `encode_params` — one request's knobs packed into the engine's
  slot-major mirrors (float row + top_k + seed);
* `fused_sample` — one sampler over the whole slot axis: greedy rows take
  ``argmax`` of the raw logits; stochastic rows draw inside the top
  `cap` logits after temperature scaling and the shared
  `ops.top_k_mask` / `top_p_mask` / `min_p_mask` truncations; a
  grammar-constrained row (its allow-list, `serve/grammar.py`) draws or
  takes its argmax inside its allowed ids instead; and the chosen
  token's log-softmax under the RAW logits comes back for the requests
  that asked for logprobs (the model's own distribution, independent of
  temperature and truncation, well defined for greedy rows too).

Randomness. The reference folds ``(seed, sample index)`` — or, for an
unseeded request, ``(engine step, slot, sample index)`` — into the
engine's base key with `jax.random.fold_in`. Here the same words are
hashed (splitmix64, on the host) into a 63-bit key per draw
(`request_seed`), with the same contract: a seeded request's stream
depends only on its seed and the sample index (not on its slot, its
neighbours or how many engine steps ran first), so it repeats run to
run; an unseeded one draws fresh entropy per (step, slot, sample index).
A draw's Gumbel noise is a function of its key and each candidate's
TOKEN ID (`draw_noise`, the same integer hash on the device), never of
the candidate's rank: near-equal logits that two computations of the
same distribution rank in another order (a decode step against a
speculative chunk, a batch of another shape) still meet the same noise,
so the same draw picks the same token unless the decision itself is a
near-tie. The two packages' draws differ, so sampled tokens never match
across packages — only greedy streams are compared across them.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import NamedTuple

import numpy as np
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
    stop_token_ids  finishing token ids beyond the request's `eos_id`,
                 matched on the host; the matching token is kept in the
                 stream, finish reason "stop".
    stop         stop strings, matched on the host against the decoded
                 generated text (the engine needs a `detokenize`
                 callable); the stream ends at the token that completes
                 the first match, finish reason "stop". A match may span
                 decode-block boundaries.
    logprobs     when True, the chosen token's log-softmax under the
                 model's raw logits goes into `Request.logprobs`, one
                 entry per generated token.
    kv_exact     escape hatch from `ServeConfig.kv_quant`: the request
                 serves from a full-precision sidecar lane of the
                 quantized pool, in the same decode blocks as quantized
                 slots, byte-identical to unquantized serving; needs
                 `ServeConfig.kv_exact_lanes` >= 1 (`submit` checks) and
                 bypasses the quantized prefix cache. A no-op on an
                 unquantized engine (everything is exact there).
    slo          SLO class the request's latency is accounted under
                 (serve/slo.py: "interactive" / "standard" / "batch" in
                 the default tier set; any class `ServeConfig.slo_targets`
                 defines). None = "standard" when the engine tracks SLOs;
                 the engine's `submit` checks that the class exists (and
                 that slo_targets is configured at all).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    seed: int | None = None
    max_tokens: int | None = None
    stop_token_ids: tuple[int, ...] = ()
    stop: tuple[str, ...] = ()
    logprobs: bool = False
    kv_exact: bool = False
    slo: str | None = None

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
        if self.slo is not None and (not isinstance(self.slo, str) or not self.slo):
            # class membership is the engine's (slo_targets names the
            # classes): `submit` checks it; here only the type
            raise ValueError(
                f"slo must be None or a non-empty class name, got {self.slo!r}"
            )
        # a lone string is one stop string, not its characters
        stop = (self.stop,) if isinstance(self.stop, str) else tuple(self.stop)
        if any(not s for s in stop):
            raise ValueError("stop strings must be non-empty")
        object.__setattr__(self, "stop", stop)
        ids = self.stop_token_ids
        try:
            ids = (operator.index(ids),)  # a lone id, like a lone string
        except TypeError:
            pass
        try:
            # operator.index: int(50256.9) would stop on the WRONG id
            ids = tuple(operator.index(t) for t in ids)
        except TypeError:
            raise ValueError(
                f"stop_token_ids must be integer token ids, got {ids!r}"
            ) from None
        object.__setattr__(self, "stop_token_ids", ids)

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
    """The key of one draw. ``seed >= 0``: a function of (base, seed,
    sample index) only — reproducible across runs and slot assignments.
    ``seed < 0``: of (base, engine step, slot, sample index)."""
    words = ((base, _SEED_TAG, seed, samp_idx) if seed >= 0
             else (base, _STEP_TAG, step_tag, slot, samp_idx))
    h = 0
    for w in words:
        h = _splitmix64(h ^ (w & _M64))
    return h >> 1  # non-negative: an int64 on the device


def draw_keys(base: int, step_tag: int, seeds, samp0, stochastic,
              width: int) -> np.ndarray:
    """The (width, S) int64 keys of the draws a decode call can make:
    row i, column s is slot s's key for sample index ``samp0[s] + i``
    (`request_seed`; 0 in the columns of greedy slots)."""
    out = np.zeros((width, len(samp0)), np.int64)
    for s, stoch in enumerate(stochastic):
        if stoch:
            out[:, s] = [request_seed(base, step_tag, s, int(seeds[s]),
                                      int(samp0[s]) + i) for i in range(width)]
    return out


def _signed(c: int) -> int:
    """A 64-bit constant as the int64 that holds its bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's `>>` is arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


# splitmix64's constants, and the odd multiplier that spreads token ids
_GOLDEN, _MIX1, _MIX2 = (_signed(0x9E3779B97F4A7C15), _signed(0xBF58476D1CE4E5B9),
                         _signed(0x94D049BB133111EB))
_ID_MUL = _signed(0xD1B54A32D192ED03)


def noise_bits(keys: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """splitmix64 of ``key ^ (id * 0xD1B54A32D192ED03)`` on int64
    tensors (broadcast), bit for bit the host's `_splitmix64` (int64
    products wrap modulo 2^64 on the CPU and the card alike)."""
    x = keys ^ (ids * _ID_MUL)
    x = x + _GOLDEN
    x = (x ^ _srl(x, 30)) * _MIX1
    x = (x ^ _srl(x, 27)) * _MIX2
    return x ^ _srl(x, 31)


def draw_noise(keys: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The Gumbel noise of candidate token `ids` (long) in draws of
    `keys` (long, broadcast against `ids`): the top 24 bits of
    `noise_bits` as a uniform in (0, 1), then ``-log(-log(u))``. A
    function of (draw key, token id) only, whatever the candidate's rank
    among the draw's support."""
    u = (_srl(noise_bits(keys, ids), 40).to(torch.float32) + 0.5) * 2.0**-24
    return -torch.log(-torch.log(u))


def capped_support(logits32: torch.Tensor, packed: PackedSampling, *,
                   cap: int, allow: torch.Tensor | None = None):
    """The bounded-support truncation: one top-`cap` selection, the
    optional per-row grammar allow-swap (`ops.allowed_logits`; a row
    whose first entry is >= 0 is constrained and its candidate domain
    becomes its allowed ids), temperature scaling (greedy rows scale by 1
    — their token comes from argmax; the scale only keeps the row
    finite) and the shared top-k / top-p / min-p masks. Returns
    ``(masked, top_idx)``."""
    top_vals, top_idx = torch.topk(logits32, cap, dim=-1)
    if allow is not None:
        constrained = (allow[:, 0] >= 0)[:, None]
        a_vals, a_idx = ops.allowed_logits(logits32, allow)
        top_vals = torch.where(constrained, a_vals, top_vals)
        top_idx = torch.where(constrained, a_idx, top_idx)
    temp = torch.where(packed.temperature <= 0.0,
                       torch.ones_like(packed.temperature),
                       packed.temperature)[:, None]
    scaled = top_vals / temp
    masked = ops.top_k_mask(scaled, packed.top_k[:, None])
    masked = ops.top_p_mask(masked, packed.top_p[:, None])
    masked = ops.min_p_mask(masked, packed.min_p[:, None])
    return masked, top_idx


def gumbel_pick(masked: torch.Tensor, top_idx: torch.Tensor,
                keys: torch.Tensor) -> torch.Tensor:
    """The Gumbel-max draw from the masked support (`capped_support`'s
    pair, any leading shape) under per-draw `keys` (the leading shape):
    the token id whose masked logit plus its `draw_noise` is largest."""
    noise = draw_noise(keys[..., None], top_idx)
    sel = torch.argmax(masked + noise, dim=-1, keepdim=True)
    return torch.gather(top_idx, -1, sel)[..., 0]


def fused_sample(logits: torch.Tensor, packed: PackedSampling,
                 keys: torch.Tensor | None, *, cap: int = 64,
                 allow: torch.Tensor | None = None, need_lp: bool = False):
    """Sample one token per slot; returns ``(tokens (S,) int64, logprobs
    (S,) float32 or None)``.

    `logits` is (S, vocab); `keys` holds each slot's draw key
    (`request_seed`; (S,) int64, ignored on greedy rows), or None when
    every slot is greedy. `allow` is the grammar
    constraint: (S, A) int64 token ids with -1 padding (`serve/grammar.
    py`), or None when no slot is constrained; a row whose first entry
    is >= 0 is constrained, its draw (or its argmax, for a greedy row)
    restricted to the listed ids, and all -1 rows are untouched. The host
    knows which rows are greedy and which constrained, so an all-greedy
    unconstrained batch is argmax only, with no selection and no masking.
    Stochastic rows draw by Gumbel-max over the masked top-`cap` support
    (the same categorical the reference draws), the noise keyed by token
    id (`gumbel_pick`).

    With `need_lp` (some slot asked for logprobs) the second result is
    the log-softmax of the RAW full-vocab logits at each chosen token;
    otherwise None and no log-softmax runs.
    """
    logits32 = logits.float()
    greedy_tok = torch.argmax(logits32, dim=-1)
    stochastic = keys is not None
    toks = greedy_tok
    if stochastic or allow is not None:
        cap = min(cap, logits.shape[-1])
        if allow is not None:
            # the engine packs sample_cap entries; the cap may have
            # clamped to a smaller vocab (allowed ids are distinct and
            # < vocab, so past `cap` only -1 padding can remain)
            if allow.shape[-1] > cap:
                allow = allow[:, :cap]
            elif allow.shape[-1] < cap:
                allow = torch.nn.functional.pad(
                    allow, (0, cap - allow.shape[-1]), value=-1)
        masked, top_idx = capped_support(logits32, packed, cap=cap,
                                         allow=allow)
        if allow is not None:
            # greedy under a constraint = argmax over the allowed domain
            # (the masks never drop a row's argmax)
            dom = torch.gather(top_idx, -1,
                               torch.argmax(masked, dim=-1, keepdim=True))[:, 0]
            toks = torch.where(allow[:, 0] >= 0, dom, greedy_tok)
        if stochastic:
            drawn = gumbel_pick(masked, top_idx, keys)
            toks = torch.where(packed.temperature <= 0.0, toks, drawn)
    lps = None
    if need_lp:
        chosen = torch.gather(logits32, -1, toks[:, None])[:, 0]
        lps = chosen - torch.logsumexp(logits32, dim=-1)
    return toks, lps
