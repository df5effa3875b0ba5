"""Request lifecycle + FIFO admission (port of
`solvingpapers_tpu/serve/scheduler.py`).

A `Request` is the unit of work the engine tracks from submit to finish;
the `FIFOScheduler` decides, once per engine iteration, which waiting
requests are prefilled into free slots:

* admission control — the waiting queue is bounded (`max_waiting`);
  submissions beyond it are rejected up front (``state == "rejected"``);
* decode priority (default) — while any slot is decoding, at most
  `max_prefills_per_step` waiting requests are admitted per iteration,
  so a burst of arrivals cannot stall in-flight streams; with the pool
  idle, prefill fills every free slot at once;
* waiting budget — a request queued for more than `max_wait_steps`
  iterations overrides decode priority: the scheduler admits up to all
  free slots that iteration, bounding starvation;
* prefix awareness (`prefer_cached`, off by default) — with a
  `prefix_lookup` bound (the engine's cached-prefix match length), the
  requests within the wait budget go shortest uncovered suffix first
  (ties stay FIFO); requests past the wait budget still go first, in
  FIFO order;
* page-budget gate (`can_admit`, bound by the paged engine) — a free
  slot is no longer enough: the request also needs free pages for its
  prompt plus a decode reservation. `pick` stops at the first candidate
  the gate rejects (head-of-line blocking on purpose: admitting a
  shorter request past a page-starved head would starve long prompts),
  and `requeue_front` returns a preempted request to the head of the
  queue so its recompute runs as soon as pages free up.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque

import numpy as np

from solvingpapers_tpu_torch.serve import metrics as smetrics
from solvingpapers_tpu_torch.serve.sampling import GREEDY, SamplingParams

_ids = itertools.count()

WAITING = "waiting"
ACTIVE = "active"
FINISHED = "finished"
REJECTED = "rejected"


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request and its evolving state (identity semantics).

    `tokens` is the output stream. `finish_reason` says why it ended:

        eos        the request's `eos_id` was emitted (kept in the stream)
        length     `max_new_tokens` (or `params.max_tokens`) ids emitted
        stop       a `params.stop_token_ids` id or `params.stop` string
                   matched, or the grammar accepted a complete document
                   (the matching token is kept in the stream)
        cancelled  `engine.cancel(request)` — a waiting request finishes
                   at once, an active one at the next block boundary
        timeout    the request's deadline passed (a waiting request
                   leaves the queue; an active one is freed at the next
                   block boundary, the expired block's tokens discarded)
        error      the engine failed the request: its slot's logits went
                   non-finite (quarantined), or persistent device
                   failures drained the engine (serve/faults.py), or its
                   journal entry could not be resumed

    `logprobs` holds the chosen token's logprob per generated token when
    `params.logprobs`.
    """

    prompt: np.ndarray
    max_new_tokens: int
    eos_id: int | None
    params: SamplingParams = GREEDY
    id: int = dataclasses.field(default_factory=lambda: next(_ids))
    state: str = WAITING
    tokens: list[int] = dataclasses.field(default_factory=list)
    logprobs: list[float] = dataclasses.field(default_factory=list)
    finish_reason: str | None = None
    slot: int | None = None
    # accumulated wait, in BLOCK-EQUIVALENTS of delivered tokens (see
    # `FIFOScheduler.tick`): a plain engine iteration ages it by 1, a
    # speculative step that committed w blocks' worth of tokens by w
    waited_steps: float = 0.0
    # absolute deadline on the engine clock (serve.metrics.now), or None
    deadline: float | None = None
    cancelled: bool = False
    # grammar-constrained decoding (serve/grammar.py JsonStepper, or any
    # object with allowed(budget) / advance(tok) / done): the engine packs
    # its allowed ids into the sampler's allow-list and finishes the
    # stream ("stop") when the grammar accepts. One stepper per request.
    grammar: object | None = None
    # streaming hook, called on the ENGINE thread as
    # ``stream_cb(request, n_new_tokens, finished)`` after every token
    # append and once at finish (n_new may be 0 at a cancel or timeout
    # boundary). It must be cheap and must not block: the HTTP front door
    # (serve/api.py) pushes a count into a bounded per-connection queue
    # and does its I/O on its own handler thread.
    stream_cb: object | None = None
    # memoized cached-prefix match length for prefix-aware scheduling,
    # computed at the first pick (slightly stale by design: it only
    # orders admission; the engine matches again at admit time)
    prefix_hint: int | None = None
    # client-facing identity (the HTTP front door's X-Request-Id, honored
    # or minted): keys the write-ahead journal record, the Last-Event-ID
    # resume cursor and GET /v1/requests/<id>
    trace_id: str | None = None
    # why a rejected request was refused: None (queue full), "unhealthy"
    # (the engine is draining) or "shed:<class>" (the degradation ladder
    # load-shed its SLO class); the front door words its 503 from it
    reject_reason: str | None = None
    # per-request speculative-decoding facts (serve/spec.py): drafts this
    # request's slot proposed and that survived verification (the
    # acceptance fact its debug timeline carries)
    spec_proposed: int = 0
    spec_accepted: int = 0
    # peak pages the request's slot held (paged pool; 0 on lane pools),
    # stamped at finish and preemption
    pages_held: int = 0
    # the SLO verdict (serve/slo.py SloTracker.observe): class, attained,
    # violated targets, latencies; None until finished, or when the
    # engine tracks no SLOs
    slo_result: dict | None = None
    submit_time: float = dataclasses.field(default_factory=lambda: smetrics.now())
    admit_time: float | None = None
    first_token_time: float | None = None
    finish_time: float | None = None

    @property
    def done(self) -> bool:
        return self.state == FINISHED

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.tokens)


class FIFOScheduler:
    """Bounded FIFO queue with decode-priority prefill interleaving."""

    def __init__(self, max_waiting: int = 256, decode_priority: bool = True,
                 max_prefills_per_step: int = 1, max_wait_steps: int = 64,
                 prefer_cached: bool = False, prefix_lookup=None,
                 can_admit=None, trace=None):
        self.max_waiting = max_waiting
        self.decode_priority = decode_priority
        self.max_prefills_per_step = max(1, max_prefills_per_step)
        self.max_wait_steps = max_wait_steps
        self.prefer_cached = prefer_cached
        # prompt (np.ndarray) -> cached-prefix match length; read-only
        self.prefix_lookup = prefix_lookup
        # Request -> bool capacity gate beyond free slots (the paged
        # engine's page-budget check); None = slots are the only gate
        self.can_admit = can_admit
        # the engine's metrics.trace.FlightRecorder, or None (tracing off)
        self.trace = trace
        self.queue: deque[Request] = deque()

    def __len__(self) -> int:
        return len(self.queue)

    @property
    def capacity_left(self) -> int:
        """Waiting-queue room before `submit` starts rejecting — the HTTP
        front door's cheap backpressure probe."""
        return max(0, self.max_waiting - len(self.queue))

    def submit(self, req: Request) -> bool:
        """Enqueue, or reject when the waiting queue is at capacity."""
        if len(self.queue) >= self.max_waiting:
            req.state = REJECTED
            return False
        self.queue.append(req)
        return True

    def pick(self, n_free: int, n_active: int) -> list[Request]:
        """Pop the requests to prefill this iteration.

        FIFO order by default; with `prefer_cached` and a bound
        `prefix_lookup`, requests within the wait budget go shortest
        uncovered suffix first (ties stay FIFO), while overdue requests
        keep strict FIFO priority ahead of everything."""
        if not self.queue or n_free == 0:
            return []
        budget = n_free
        if self.decode_priority and n_active > 0:
            head = self.queue[0]
            if head.waited_steps <= self.max_wait_steps:
                budget = self.max_prefills_per_step
            elif self.trace is not None:
                # the anti-starvation override fired: prefill takes every
                # free slot despite active decodes (what explains an ITL
                # spike in a trace)
                self.trace.instant(
                    "wait_budget_override", "sched", "queue", req=head.id,
                    waited_steps=head.waited_steps, queued=len(self.queue),
                )
        k = min(budget, n_free, len(self.queue))
        if not (self.prefer_cached and self.prefix_lookup is not None):
            picked = []
            while len(picked) < k and self.queue:
                if (self.can_admit is not None
                        and not self.can_admit(self.queue[0])):
                    break  # page-starved head blocks: strict FIFO
                picked.append(self.queue.popleft())
            return picked
        overdue = [r for r in self.queue
                   if r.waited_steps > self.max_wait_steps]
        fresh = [r for r in self.queue
                 if r.waited_steps <= self.max_wait_steps]
        for r in fresh:
            if r.prefix_hint is None:
                r.prefix_hint = self.prefix_lookup(r.prompt)
        fresh.sort(key=lambda r: r.prompt.size - r.prefix_hint)
        picked = []
        for r in overdue + fresh:
            if len(picked) >= k:
                break
            if self.can_admit is not None and not self.can_admit(r):
                break  # the same head-of-line discipline in preference order
            picked.append(r)
        taken = {id(r) for r in picked}
        self.queue = deque(r for r in self.queue if id(r) not in taken)
        return picked

    def requeue_front(self, req: Request) -> None:
        """Return a request to the head of the queue (a preempted one, or
        the not-yet-admitted tail of a failed pick): it bypasses
        `max_waiting` and keeps its `waited_steps`."""
        req.state = WAITING
        self.queue.appendleft(req)

    def remove(self, req: Request) -> bool:
        """Drop a waiting request (identity match); False if not queued."""
        try:
            self.queue.remove(req)
            return True
        except ValueError:
            return False

    def tick(self, weight: float = 1.0) -> None:
        """One engine iteration elapsed for everything still queued.

        `weight` is the iteration's age in BLOCK-EQUIVALENTS of delivered
        tokens (the engine passes ``max per-slot delivered tokens /
        decode_block``, floored at 1). A plain decode block delivers at
        most one block a slot, so its weight is exactly 1. A speculative
        step can deliver several blocks' worth in one iteration; without
        the weight the wait budget would be worth more delivered work the
        better speculation goes, starving the queue head exactly when the
        engine is fastest."""
        weight = max(weight, 1.0)
        for req in self.queue:
            req.waited_steps += weight
