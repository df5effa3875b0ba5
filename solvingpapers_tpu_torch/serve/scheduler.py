"""Request lifecycle + FIFO admission (port of
`solvingpapers_tpu/serve/scheduler.py`, without the prefix-aware order
and the paged pool's page gate).

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
  free slots that iteration, bounding starvation.
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
                 max_prefills_per_step: int = 1, max_wait_steps: int = 64):
        self.max_waiting = max_waiting
        self.decode_priority = decode_priority
        self.max_prefills_per_step = max(1, max_prefills_per_step)
        self.max_wait_steps = max_wait_steps
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
        """Pop the requests to prefill this iteration, in FIFO order."""
        if not self.queue or n_free == 0:
            return []
        budget = n_free
        if (self.decode_priority and n_active > 0
                and self.queue[0].waited_steps <= self.max_wait_steps):
            budget = self.max_prefills_per_step
        k = min(budget, n_free, len(self.queue))
        return [self.queue.popleft() for _ in range(k)]

    def requeue_front(self, req: Request) -> None:
        """Return a request to the head of the queue (bypassing
        `max_waiting`, keeping its `waited_steps`)."""
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
