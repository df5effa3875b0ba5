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
        cancelled  `engine.cancel(request)` — a waiting request finishes
                   at once, an active one at the next block boundary
    """

    prompt: np.ndarray
    max_new_tokens: int
    eos_id: int | None
    params: SamplingParams = GREEDY
    id: int = dataclasses.field(default_factory=lambda: next(_ids))
    state: str = WAITING
    tokens: list[int] = dataclasses.field(default_factory=list)
    finish_reason: str | None = None
    slot: int | None = None
    waited_steps: int = 0
    cancelled: bool = False
    # memoized cached-prefix match length for prefix-aware scheduling,
    # computed at the first pick (slightly stale by design: it only
    # orders admission; the engine matches again at admit time)
    prefix_hint: int | None = None
    # peak pages the request's slot held (paged pool; 0 on lane pools),
    # stamped at finish and preemption
    pages_held: int = 0
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
                 can_admit=None):
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
        self.queue: deque[Request] = deque()

    def __len__(self) -> int:
        return len(self.queue)

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
        if (self.decode_priority and n_active > 0
                and self.queue[0].waited_steps <= self.max_wait_steps):
            budget = self.max_prefills_per_step
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

    def tick(self) -> None:
        """One engine iteration elapsed for everything still queued."""
        for req in self.queue:
            req.waited_steps += 1
