"""Continuous-batching serving engine over a lane pool (port of the lane
path of `solvingpapers_tpu/serve/engine.py`).

`infer.generate` is one static batch to completion. `ServeEngine`
instead advances a pool of S independent slots one iteration at a time
(Orca-style iteration-level scheduling): each `step()` admits waiting
requests into free lanes with a chunked, bucketed prefill (the same
end-aligned `attend_len` contract as `generate`, so `use_flash` models
run the flash kernel there), then advances every active slot by a block
of single-token steps, emitting per-request token streams. A slot freed
by an early EOS is re-acquired by the next queued request at once.

From the reference's `vmap` to a batch: the reference applies a batch-1
single-token forward per slot under `vmap`, so each slot's scalar write
position becomes per-slot. Here one batch-S forward runs over the whole
pool, and what `vmap` gave implicitly is written out: per-slot RoPE
positions, per-slot cache writes (clamped like `dynamic_update_slice`,
see `infer.cache.update_kv_cache`) and the per-slot ``kv_index <=
position`` decode mask. Every block runs the full `decode_block` steps;
a slot that hits EOS or its budget mid-block keeps stepping and the host
discards its overshoot (its writes stay inside its own lane, which the
next prefill overwrites). Idle slots run masked dummy steps at position 0.

Prompts pad right to a multiple of `bucket` (the pad is causally
invisible to real tokens, and its cache slots are overwritten by the
decode stream before they are ever attended), and prefill runs in
`prefill_chunk` pieces (2048 automatically above 4096 tokens, as in the
reference).

Per-request sampling (`serve/sampling.py`): greedy slots (temperature 0)
take argmax and are token-exact with greedy `generate`; a seeded
stochastic slot replays its stream run to run.

Not in this slice (kept by the reference, listed in ROADMAP.md): the
paged pool, prefix cache, speculative decoding, grammar, stop strings,
logprobs, deadlines, the fault boundary, journal, tracing and the HTTP
front door.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from solvingpapers_tpu_torch.device import resolve_device
from solvingpapers_tpu_torch.serve import metrics as smetrics
from solvingpapers_tpu_torch.serve.kv_pool import (
    KVSlotPool,
    extract_lane,
    store_lane,
)
from solvingpapers_tpu_torch.serve.metrics import ServeMetrics
from solvingpapers_tpu_torch.serve.sampling import (
    GREEDY_ROW,
    PackedSampling,
    SamplingParams,
    encode_params,
    fused_sample,
    request_generator,
)
from solvingpapers_tpu_torch.serve.scheduler import (
    ACTIVE,
    FINISHED,
    WAITING,
    FIFOScheduler,
    Request,
)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine shape/policy knobs (the lane-pool subset of the reference's).

    `decode_block` amortizes host work: each decode call advances all
    slots `block` tokens before the host looks at the streams again.
    `bucket` quantizes prefill lengths. `sample_cap` bounds the support
    stochastic sampling draws from (requests' top_k must fit under it).
    `max_waiting`, `decode_priority`, `max_prefills_per_step` and
    `max_wait_steps` configure the scheduler; `eos_id` is the default
    per-request EOS (None = run to budget); `seed` keys sampling.
    """

    n_slots: int = 8
    max_len: int = 512
    decode_block: int = 8
    bucket: int = 64
    prefill_chunk: int | None = None
    sample_cap: int = 64
    max_waiting: int = 256
    decode_priority: bool = True
    max_prefills_per_step: int = 1
    max_wait_steps: int = 64
    eos_id: int | None = None
    seed: int = 0


_UNSET = object()


def _prefill_lane(model, padded, chunk, start, lane, prompt, length):
    """Chunked-prefill core: run `prompt` ((padded,) ids, right-padded)
    through the batch-1 `lane` from position `start`; returns the lane
    and the logits row of the LAST REAL token (index `length - 1`, taken
    from whichever chunk holds it)."""
    step = chunk or padded
    last = None
    for cs in range(0, padded, step):
        ce = min(cs + step, padded)
        positions = torch.arange(start + cs, start + ce, device=prompt.device)[None]
        logits, lane = model(prompt[None, cs:ce], positions=positions,
                             caches=lane, attend_len=start + ce)
        if cs <= length - 1 < ce:
            last = logits[0, length - 1 - cs]
    return lane, last


def _prefill_program(model, padded, chunk, cap, caches, prompt, slot, length,
                     packed, generator):
    """Prefill one request into lane `slot` and sample its first token
    (sample index 0 of its chain)."""
    lane = extract_lane(caches, slot)
    lane, last = _prefill_lane(model, padded, chunk, 0, lane, prompt, length)
    first = fused_sample(last[None], packed, [generator], cap=cap)
    caches = store_lane(caches, lane, slot)
    return caches, first[0]


def _decode_program(model, block, cap, caches, toks, pos, active, eos, packed,
                    generators):
    """Advance every slot `block` tokens; inactive slots run masked.

    toks/pos/eos are (S,) int64 and active (S,) bool device tensors;
    `generators(t)` gives step t's per-slot generators (None for greedy
    slots). EOS padding is sticky: a slot whose previous token was its
    EOS emits EOS again, as `generate` pads. Returns the caches and the
    (block, S) emitted tokens.
    """
    out = []
    for t in range(block):
        logits, caches = model(toks[:, None], positions=pos[:, None],
                               caches=caches)
        nxt = fused_sample(logits[:, 0], packed, generators(t), cap=cap)
        hit_eos = (eos >= 0) & (toks == eos)
        nxt = torch.where(hit_eos, eos, nxt)
        nxt = torch.where(active, nxt, toks)
        pos = torch.where(active, pos + 1, pos)
        out.append(nxt)
        toks = nxt
    return caches, torch.stack(out)


class ServeEngine:
    """Long-lived continuous-batching engine over one decoder model.

    >>> eng = ServeEngine(model, ServeConfig(n_slots=4))
    >>> reqs = [eng.submit(p, max_new_tokens=64) for p in prompts]
    >>> eng.run()              # step() until queue and slots drain
    >>> reqs[0].tokens         # per-request generated ids

    The model carries its own parameters (the reference passes `params`
    beside a stateless module) and must live on `device` (default
    ``cuda``; raises when there is none).
    """

    def __init__(self, model, config: ServeConfig | None = None, *,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, the engine was "
                             f"asked to serve on {self.device}")
        cfg = config or ServeConfig()
        limit = getattr(model, "max_positions", None)
        if limit is not None and cfg.max_len > limit:
            raise ValueError(
                f"max_len {cfg.max_len} exceeds the model's max positions {limit}"
            )
        for knob in ("decode_block", "bucket", "sample_cap"):
            if getattr(cfg, knob) < 1:
                raise ValueError(f"{knob} must be >= 1, got {getattr(cfg, knob)}")
        if cfg.prefill_chunk is not None and cfg.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {cfg.prefill_chunk}")
        self.model = model
        self.config = cfg
        self.metrics = ServeMetrics()
        self.pool = KVSlotPool(model, cfg.n_slots, cfg.max_len)
        self.scheduler = FIFOScheduler(
            max_waiting=cfg.max_waiting,
            decode_priority=cfg.decode_priority,
            max_prefills_per_step=cfg.max_prefills_per_step,
            max_wait_steps=cfg.max_wait_steps,
        )
        self._slot_req: list[Request | None] = [None] * cfg.n_slots
        # host-side numpy mirrors of per-slot decode state, shipped to the
        # device once per decode block
        self._toks = np.zeros(cfg.n_slots, np.int64)
        self._pos = np.zeros(cfg.n_slots, np.int64)
        # slot-major SamplingParams mirrors; free lanes rest at the greedy
        # row so an idle or all-greedy batch takes the argmax-only path
        self._samp_f = np.tile(
            np.asarray(GREEDY_ROW, np.float32)[:, None], (1, cfg.n_slots)
        )
        self._top_k = np.zeros(cfg.n_slots, np.int64)
        self._seed = np.full(cfg.n_slots, -1, np.int64)
        self._rng_step = 0  # engine call counter: the unseeded chain's step word
        self._last_emit = np.zeros(cfg.n_slots)

    # ------------------------------------------------------------- submit

    def submit(self, prompt, max_new_tokens: int = 64, eos_id=_UNSET,
               params: SamplingParams | None = None) -> Request:
        """Enqueue one request; returns its live handle immediately.

        Bad inputs raise `ValueError` here, host-side: empty, non-integer
        or non-1-D prompts, ids outside the vocabulary (a CUDA embedding
        gather out of range kills the process), budgets < 1, top_k above
        `sample_cap`, and prompt + budget beyond the engine capacity.
        A full waiting queue returns the request ``rejected``.
        """
        arr = np.asarray(prompt)
        if arr.size < 1:
            raise ValueError("prompt must have at least one token")
        if arr.dtype.kind not in "iu":
            raise ValueError(
                f"prompt must be integer token ids, got dtype {arr.dtype}"
            )
        if arr.ndim != 1:
            raise ValueError(
                f"prompt must be 1-D (one request's token ids), got shape "
                f"{arr.shape} — batch by submitting one request per row"
            )
        vocab = self.model.cfg.vocab_size
        if arr.min() < 0 or arr.max() >= vocab:
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        prompt = arr.astype(np.int64)
        params = params or SamplingParams()
        if params.max_tokens is not None:
            max_new_tokens = params.max_tokens
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if params.top_k > self.config.sample_cap:
            raise ValueError(
                f"top_k {params.top_k} exceeds ServeConfig.sample_cap "
                f"{self.config.sample_cap}"
            )
        total = prompt.size + max_new_tokens
        limit = getattr(self.model, "max_positions", None)
        cap = min(self.config.max_len, limit or self.config.max_len)
        if total > cap:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"= {total} exceeds the engine capacity {cap} "
                "(min of ServeConfig.max_len and the model's max positions)"
            )
        req = Request(
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            eos_id=self.config.eos_id if eos_id is _UNSET else eos_id,
            params=params,
        )
        if not self.scheduler.submit(req):
            self.metrics.record_reject()
        return req

    def cancel(self, req: Request) -> None:
        """A WAITING request leaves the queue and finishes "cancelled" at
        once; an ACTIVE one keeps its lane until the next block boundary.
        Finished/rejected requests are a no-op."""
        if req.state == WAITING:
            if self.scheduler.remove(req):
                req.state = FINISHED
                req.finish_reason = "cancelled"
                req.finish_time = smetrics.now()
                self.metrics.record_finish(req, req.finish_time)
        elif req.state == ACTIVE:
            req.cancelled = True

    # --------------------------------------------------------------- step

    def has_work(self) -> bool:
        return bool(len(self.scheduler)) or self.pool.n_active > 0

    @torch.no_grad()
    def step(self) -> list[Request]:
        """One engine iteration: admit + prefill, then one decode block.
        Returns the requests that FINISHED this iteration."""
        return self._step_inner()

    def _step_inner(self) -> list[Request]:
        finished: list[Request] = []
        picked = self.scheduler.pick(self.pool.n_free, self.pool.n_active)
        at = -1
        try:
            for at, req in enumerate(picked):
                if self._admit(req):
                    finished.append(req)  # prefill-only finish (eos/budget 1)
        except BaseException:
            # `pick` already popped this batch: put the not-yet-admitted
            # tail back at the head, in order, before the error propagates
            for r in reversed(picked[at + 1:]):
                self.scheduler.requeue_front(r)
            raise
        if self.pool.n_active > 0:
            finished.extend(self._decode_block())
        self.scheduler.tick()
        self.metrics.record_step(self.pool.occupancy)
        return finished

    def run(self, max_steps: int | None = None) -> None:
        """Drive step() until queue and slots drain (or `max_steps`)."""
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                return

    # ------------------------------------------------------------ private

    def _bucketed(self, length: int, start: int = 0) -> int:
        b = self.config.bucket
        padded = -(-length // b) * b
        limit = getattr(self.model, "max_positions", None)
        cap = min(self.config.max_len, limit or self.config.max_len) - start
        return max(length, min(padded, cap))

    def _prefill_shape(self, length: int) -> tuple[int, int | None]:
        """(padded length, chunk) of one prompt's prefill: bucketed, then
        cut into `prefill_chunk` pieces (2048 automatically above 4096
        tokens, as `infer.generate` does); chunk None is one piece."""
        padded = self._bucketed(length)
        chunk = self.config.prefill_chunk
        if chunk is None and padded > 4096:
            chunk = 2048
        if chunk is not None and chunk >= padded:
            chunk = None
        return padded, chunk

    def _packed(self, cols) -> PackedSampling:
        dev = self.device
        f = torch.as_tensor(self._samp_f[:, cols], device=dev)
        return PackedSampling(temperature=f[0], top_p=f[1], min_p=f[2],
                              top_k=torch.as_tensor(self._top_k[cols], device=dev))

    def _admit(self, req: Request) -> bool:
        """Prefill `req` into a free lane; True if it finished already."""
        slot = self.pool.acquire()
        if slot is None:
            raise RuntimeError("scheduler admitted beyond free slots")
        now = smetrics.now()
        req.state = ACTIVE
        req.slot = slot
        req.admit_time = now
        self._slot_req[slot] = req
        length = int(req.prompt.size)
        padded, chunk = self._prefill_shape(length)
        self.metrics.record_admit(now)
        prompt_padded = np.zeros(padded, np.int64)
        prompt_padded[:length] = req.prompt
        samp_row, top_k, seed = encode_params(req.params)
        self._samp_f[:, slot] = samp_row
        self._top_k[slot] = top_k
        self._seed[slot] = seed
        generator = (None if req.params.greedy else request_generator(
            self.config.seed, self._rng_step, slot, seed, 0, self.device))
        self._rng_step += 1
        self.pool.caches, first = _prefill_program(
            self.model, padded, chunk, self.config.sample_cap,
            self.pool.caches, torch.as_tensor(prompt_padded, device=self.device),
            slot, length, self._packed([slot]), generator,
        )
        first = int(first)  # waits for the device: `now` below is device-true
        now = smetrics.now()
        req.first_token_time = now
        req.tokens.append(first)
        self.metrics.record_first_token(req, now)
        self._last_emit[slot] = now
        self.pool.positions[slot] = length
        self._toks[slot] = first
        self._pos[slot] = length
        reason = self._stop_reason(req, first)
        if reason is None:
            return False
        self._finish(req, reason, now)
        return True

    def _stop_reason(self, req: Request, tok: int) -> str | None:
        if req.eos_id is not None and tok == req.eos_id:
            return "eos"
        if req.remaining == 0:
            return "length"
        return None

    def _decode_block(self) -> list[Request]:
        cfg = self.config
        block, n = cfg.decode_block, cfg.n_slots
        active = np.zeros(n, bool)
        eos = np.full(n, -1, np.int64)
        samp_idx = np.zeros(n, np.int64)
        stochastic = np.zeros(n, bool)
        for slot, r in enumerate(self._slot_req):
            if r is not None:
                active[slot] = True
                if r.eos_id is not None:
                    eos[slot] = r.eos_id
                # sample index of this block's first draw (index 0 was
                # the prefill's)
                samp_idx[slot] = len(r.tokens)
                stochastic[slot] = not r.params.greedy
        step_tag = self._rng_step
        self._rng_step += 1
        dev = self.device

        def generators(t):
            return [request_generator(cfg.seed, step_tag, s, int(self._seed[s]),
                                      int(samp_idx[s]) + t, dev)
                    if stochastic[s] else None for s in range(n)]

        t0 = smetrics.now()
        self.pool.caches, out = _decode_program(
            self.model, block, cfg.sample_cap, self.pool.caches,
            torch.as_tensor(self._toks, device=dev),
            torch.as_tensor(self._pos, device=dev),
            torch.as_tensor(active, device=dev),
            torch.as_tensor(eos, device=dev),
            self._packed(slice(None)), generators,
        )
        out = out.cpu().numpy()  # (block, n_slots); overshoot truncated below
        now = smetrics.now()
        self.metrics.record_decode_block(now - t0)
        finished: list[Request] = []
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            if req.cancelled:
                # lifecycle kill at the block boundary: the block's output
                # is discarded and the lane frees for the next pick
                self._finish(req, "cancelled", now)
                finished.append(req)
                continue
            appended = 0
            reason = None
            for t in out[:, slot]:
                req.tokens.append(int(t))
                appended += 1
                reason = self._stop_reason(req, int(t))
                if reason is not None:
                    break  # the tail of the block is discarded overshoot
            self.metrics.record_tokens(appended, now - self._last_emit[slot],
                                       now)
            self._last_emit[slot] = now
            self.pool.positions[slot] += appended
            if reason is not None:
                self._finish(req, reason, now)
                finished.append(req)
            else:
                # mirror the device carry: the slot ran the full block
                self._toks[slot] = out[-1, slot]
                self._pos[slot] += block
        return finished

    def _finish(self, req: Request, reason: str, now: float) -> None:
        req.state = FINISHED
        req.finish_reason = reason
        req.finish_time = now
        self.metrics.record_finish(req, now)
        slot = req.slot
        self._slot_req[slot] = None
        # park the idle lane at position 0 with greedy sampling rows: its
        # masked dummy writes land in slot 0 (overwritten by the next
        # prefill) and an all-greedy resting state keeps idle batches on
        # the argmax-only path
        self._toks[slot] = 0
        self._pos[slot] = 0
        self._samp_f[:, slot] = GREEDY_ROW
        self._top_k[slot] = 0
        self._seed[slot] = -1
        self.pool.release(slot)


__all__ = ["ServeConfig", "ServeEngine"]
