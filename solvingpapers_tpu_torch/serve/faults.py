"""Fault tolerance for the serving engine (port of
`solvingpapers_tpu/serve/faults.py`): seeded fault injection, a failure
taxonomy, and the SLO- and page-driven degradation ladder.

Once a request is admitted, a NaN-poisoned forward, a device OOM
mid-step or a wedged step would otherwise kill the engine-loop thread
and with it every concurrent stream. This module is the
correctness-under-failure layer, in three pieces the engine composes:

* `FaultPlan` — a deterministic, seeded fault-injection plane
  (`ServeConfig.fault_plan`; None = off, one `is not None` branch per
  hook, the flight recorder's discipline). Named SITES are threaded
  through the hot path — ``prefill`` (admission dispatch), ``decode``
  (the decode-block dispatch), ``scatter`` (the post-block output fetch
  / paged scatter boundary), ``prefix_splice`` (prefix-cache reuse),
  ``sse_write`` (the HTTP front door's event writer), ``journal_write``
  (the write-ahead journal's append/fsync boundary, serve/journal.py) —
  and each visit of a site advances a per-site counter; a `FaultSpec`
  fires at an exact visit index, so a fault schedule replays
  bit-identically run to run. KINDS: ``nan``/``inf`` poison one slot's
  logits on the device (through the fault row riding the packed control
  transfer — exercising the finite-logits guard), ``xla_error``/``oom``
  raise a synthetic `InjectedFault` the failure classifier treats
  exactly like a real device runtime error or out-of-memory error,
  ``stall`` sleeps the step past the watchdog deadline, ``socket_reset``
  breaks an SSE write mid-stream, and ``io_error`` fails a journal write
  (exercising the degrade-to-journal-off path — or, under
  `journal_strict`, the loud failure). The site and kind names are the
  reference's, so one plan parses the same in both packages, and every
  recovery path below is testable on the CPU.

* `classify_failure` — the failure taxonomy the engine's supervised
  step boundary switches on: ``poisoned`` failures (non-finite logits)
  are pinned to a slot and quarantined (that request finishes
  ``"error"``, its slot, pages and lane reclaimed leak-free, every other
  stream continues byte-identically); ``systemic`` failures (CUDA
  runtime errors, out-of-memory errors, anything escaping a step) cost
  a bounded pool-rebuild retry with exponential backoff, then flip the
  engine to a draining ``unhealthy`` state that /healthz reports as 503
  until recovery. A sticky CUDA error (an illegal address, a device-side
  assert) leaves the context unusable, so the rebuild raises too: each
  such attempt counts as a failed retry, and the engine reaches
  ``unhealthy`` after `fault_max_retries` and drains host-side.

* `DegradationLadder` — graceful degradation with hysteresis. Under
  page exhaustion or SLO error-budget burn the engine climbs one rung at
  a time: shed prefix-cache leaves (rung 1), hold speculation (rung 2;
  the port has no speculative decoding yet, so the rung only names the
  step), load-shed admissions by SLO class — batch first (rung 3), then
  standard (rung 4) — answering 503 with a JITTERED Retry-After so retry
  herds never synchronize. Escalation needs `up_steps` consecutive
  pressured evaluations, de-escalation `down_steps` clear ones, so the
  ladder cannot flap on a noisy signal; recovery re-arms in reverse
  order (admissions first, the prefix cache last). Each rung is a gauge
  (``serve/degradation_rung``), each transition a trace instant.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

__all__ = [
    "FAULT_SITES",
    "FAULT_KINDS",
    "RUNGS",
    "InjectedFault",
    "FaultSpec",
    "FaultPlan",
    "DegradationLadder",
    "classify_failure",
]

FAULT_SITES = ("prefill", "decode", "scatter", "prefix_splice",
               "sse_write", "journal_write")
FAULT_KINDS = ("nan", "inf", "xla_error", "oom", "stall", "socket_reset",
               "io_error")

# fault-row codes the engine's programs decode (0 = clean slot); the
# poison is applied with torch.where, and the row exists only while a
# fault plan is armed, so fault-free streams stay token-exact
FAULT_NONE = 0
FAULT_NAN = 1
FAULT_INF = 2

# substrings that mark a runtime failure as systemic even when it is a
# real exception rather than an InjectedFault: the reference's XLA
# markers (kept so a plan's synthetic errors read the same), then
# CUDA's: PyTorch's out-of-memory type, the runtime's, cuBLAS's and
# cuDNN's error texts, and the port's own kernel wrappers' launch errors
_SYSTEMIC_MARKERS = ("XlaRuntimeError", "RESOURCE_EXHAUSTED",
                     "Resource exhausted", "out of memory",
                     "OutOfMemoryError", "CUDA error", "CUBLAS_STATUS_",
                     "cuDNN error", "kernel launch failed")
# the type PyTorch raises for a CUDA runtime error (None on a build
# without it)
_ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", None)


class InjectedFault(RuntimeError):
    """Synthetic device-runtime failure raised by a `FaultPlan` — shaped
    so `classify_failure` cannot tell it from the real thing (that is
    the point: the recovery path under test is the production one)."""

    def __init__(self, kind: str, site: str):
        if kind == "oom":
            tag = "RESOURCE_EXHAUSTED: injected device OOM"
        elif kind == "io_error":
            tag = "injected journal I/O error"
        else:
            tag = "injected XlaRuntimeError"
        super().__init__(f"{tag} at site {site!r}")
        self.kind = kind
        self.site = site


def classify_failure(exc: BaseException) -> str:
    """The taxonomy the supervised step boundary switches on:
    ``"systemic"`` for device-runtime failures (injected, or a real CUDA
    runtime error, `torch.AcceleratorError`, or out-of-memory error —
    the step's outcome on the device is unknown, so the remedy is
    rebuild-and-recompute), ``"io"`` for host I/O failures
    (OSError, the journal's JournalError, or an injected ``io_error``
    — the DEVICE pool is untouched, so the remedy is degrade-the-
    durability-plane, not rebuild; the engine's journal boundary
    handles these before they ever reach the step boundary unless
    `journal_strict` deliberately lets them escape), ``"host"`` for
    everything else (a host-side bug; the pool was never touched, but
    the step's outcome is unknown — treated with the same rebuild
    remedy, the conservative choice)."""
    if isinstance(exc, InjectedFault):
        return "io" if exc.kind == "io_error" else "systemic"
    if _ACCELERATOR_ERROR is not None and isinstance(exc, _ACCELERATOR_ERROR):
        return "systemic"
    name = type(exc).__name__
    if isinstance(exc, OSError) or "JournalError" in name:
        return "io"
    text = f"{name}: {exc}"
    if any(m in text for m in _SYSTEMIC_MARKERS):
        return "systemic"
    return "host"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire `count` times starting at the `visit`-th
    poke of `site` (per-site visit counters start at 0 and advance on
    every poke, fired or not — which is what makes a schedule replay
    deterministically). `slot` targets nan/inf poison; `stall_s` is the
    sleep for ``stall``."""

    site: str
    kind: str
    visit: int
    slot: int = 0
    stall_s: float = 0.0
    count: int = 1

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(
                f"unknown fault site {self.site!r} (sites: {FAULT_SITES})"
            )
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (kinds: {FAULT_KINDS})"
            )
        if self.visit < 0:
            raise ValueError(f"visit must be >= 0, got {self.visit}")
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")
        if self.kind == "stall" and not self.stall_s > 0:
            raise ValueError("stall faults need stall_s > 0")
        if self.kind == "socket_reset" and self.site != "sse_write":
            raise ValueError(
                "socket_reset only makes sense at the sse_write site"
            )
        if self.kind in ("xla_error", "oom") and self.site in (
            "sse_write", "journal_write"
        ):
            raise ValueError(
                f"{self.kind} is a device-runtime failure and needs an "
                "engine site (the sse_write/journal_write hooks only act "
                "on their own kinds — the spec would fire and count as "
                "injected while exercising nothing)"
            )
        if self.kind == "io_error" and self.site != "journal_write":
            raise ValueError(
                "io_error models a journal write/fsync failure and only "
                "makes sense at the journal_write site"
            )
        if self.kind in ("nan", "inf") and self.site not in (
            "prefill", "decode"
        ):
            raise ValueError(
                f"{self.kind} poison lands in program logits and needs "
                "site 'prefill' or 'decode'"
            )
        if self.slot < 0:
            raise ValueError(f"slot must be >= 0, got {self.slot}")


class FaultPlan:
    """A deterministic fault schedule over the engine's named sites.

    Construct from a sequence of `FaultSpec` (or spec-shaped dicts —
    the `ServeConfig.fault_plan` spelling). `poke(site)` is the hot-path
    hook: it advances the site's visit counter and returns the specs
    firing at THIS visit (usually none — the common case is one dict
    lookup + one increment). The plan is pure host-side state: two
    engines built from the same plan replay the same schedule.

    Thread-safe: engine sites poke under the engine loop's lock while
    the front door's ``sse_write`` site pokes from HTTP handler threads,
    so `poke` serializes internally — per-site visit counters and the
    shared `fired` tally cannot lose updates across those lock domains.
    """

    def __init__(self, specs):
        parsed = []
        for s in specs:
            if isinstance(s, FaultSpec):
                parsed.append(s)
            elif isinstance(s, dict):
                parsed.append(FaultSpec(**s))
            else:
                raise ValueError(
                    f"fault_plan entries must be FaultSpec or dicts, got "
                    f"{type(s).__name__}"
                )
        self.specs = tuple(parsed)
        self._visits = dict.fromkeys(FAULT_SITES, 0)
        # site -> visit -> [specs]: O(1) per poke on the hot path
        self._by_site: dict[str, dict[int, list[FaultSpec]]] = {
            site: {} for site in FAULT_SITES
        }
        for spec in self.specs:
            for i in range(spec.count):
                self._by_site[spec.site].setdefault(
                    spec.visit + i, []
                ).append(spec)
        self.fired = 0
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, plan) -> "FaultPlan | None":
        """`ServeConfig.fault_plan` -> a live plan (None passes through:
        the engine keeps the None-pattern hooks)."""
        if plan is None:
            return None
        if isinstance(plan, FaultPlan):
            # each engine replays the schedule from visit 0: a shared
            # plan object must not leak one engine's counters into the
            # next (bench arms and rebuilt engines reuse one config)
            return cls(plan.specs)
        return cls(plan)

    def poke(self, site: str) -> list[FaultSpec]:
        """One visit of `site`; returns the specs that fire now."""
        with self._lock:
            visit = self._visits[site]
            self._visits[site] = visit + 1
            fired = self._by_site[site].get(visit)
            if not fired:
                return []
            self.fired += len(fired)
            return fired

    def stats(self) -> dict:
        """The /statusz `health.fault_plan` section."""
        with self._lock:
            return {
                "specs": len(self.specs),
                "fired": self.fired,
                "visits": dict(self._visits),
            }


# --------------------------------------------------------------- ladder


RUNGS = ("normal", "shed_prefix", "hold_spec", "shed_batch",
         "shed_standard")

# SLO classes shed per rung, most-expendable first; interactive traffic
# is never shed by the ladder (at that point the engine is unhealthy,
# not degraded)
_SHED_BY_RUNG = {3: ("batch",), 4: ("batch", "standard")}


class DegradationLadder:
    """Hysteretic escalation controller. `observe(pressured, reasons)`
    runs once per engine step; the return value is the new rung when a
    transition happened (None otherwise), so the engine can stamp a
    trace instant per transition without polling."""

    def __init__(self, up_steps: int = 2, down_steps: int = 16,
                 max_rung: int = len(RUNGS) - 1):
        if up_steps < 1 or down_steps < 1:
            raise ValueError("up_steps and down_steps must be >= 1")
        if not 1 <= max_rung < len(RUNGS):
            raise ValueError(
                f"max_rung must be in [1, {len(RUNGS) - 1}], got {max_rung}"
            )
        self.up_steps = up_steps
        self.down_steps = down_steps
        self.max_rung = max_rung
        self.rung = 0
        self.transitions = 0
        self.last_reasons: tuple = ()
        self._up = 0
        self._down = 0

    def observe(self, pressured: bool, reasons=()) -> int | None:
        """Feed one evaluation of the pressure signals; returns the new
        rung iff this observation caused a transition. Escalation and
        de-escalation both move ONE rung at a time (recovery re-arms in
        reverse order by construction), and both counters reset on any
        transition so a fresh rung gets a fresh hysteresis window."""
        if pressured:
            self.last_reasons = tuple(reasons)
            self._down = 0
            self._up += 1
            if self._up >= self.up_steps and self.rung < self.max_rung:
                self.rung += 1
                self.transitions += 1
                self._up = 0
                return self.rung
        else:
            self._up = 0
            self._down += 1
            if self._down >= self.down_steps and self.rung > 0:
                self.rung -= 1
                self.transitions += 1
                self._down = 0
                return self.rung
        return None

    def shed_classes(self) -> tuple:
        """SLO classes admissions are currently shed for (empty below
        rung 3)."""
        return _SHED_BY_RUNG.get(self.rung, ())

    @property
    def name(self) -> str:
        return RUNGS[self.rung]

    def stats(self) -> dict:
        """The /statusz `health.ladder` section."""
        return {
            "rung": self.rung,
            "name": self.name,
            "transitions": self.transitions,
            "shedding": list(self.shed_classes()),
            "pressure_reasons": list(self.last_reasons),
        }
