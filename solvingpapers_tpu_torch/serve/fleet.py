"""Fleet serving: N `ServeEngine` replicas behind one router (port of
`solvingpapers_tpu/serve/fleet.py`), between the HTTP front door
(serve/api.py) and the engines.

Each replica is a full engine with its own `EngineLoop`, KV pool,
journal file and metrics, so a replica's faults stay its own (the
replication shape, not a split into prefill and decode roles). On the
one card the replicas share one `nn.Module` and so one copy of its
weights, as the reference's replicas share one `params` tree; each
allocates its own pool.

Routing composes three signals, in order:

    health     a replica that is draining, whose loop thread died, or
               whose fault-plane health is "unhealthy" takes no new
               admissions: the gate its own /healthz shows an external
               balancer, applied inside.
    SLO burn   the request's SLO class avoids replicas whose windowed
               error-budget burn rate for that class exceeds
               `burn_threshold` (serve/slo.py `SloTracker.burn_rate`),
               unless every candidate is burning.
    affinity   the replica whose radix prefix tree covers the longest
               page-aligned prompt prefix wins (`ServeEngine._match_len`,
               read-only, taken under that replica's step lock: the tree
               mutates on its engine thread). A hit is a page-table append
               instead of a prefill; the least-loaded replica (free
               fraction of the scarcest resource: pages on a paged pool,
               slots otherwise; then queue room; then replica id) breaks
               ties and decides when no replica holds a prefix.

`submit` walks the ranked candidates: a replica whose waiting queue is
full rejects host-side and the router tries the next one instead of
bouncing the client (the front door consults `capacity_left`, the sum
of the admitting replicas' queue room, before it spends a submission).

Observability: `prom_sets()` feeds `PrometheusTextWriter.render_sets`
one unlabelled merged set (fleet gauges and the exact `LogHistogram`
merge of every replica's latency histograms, each taken under its
replica's step lock) and one ``replica="rN"`` set per replica;
`statusz()` is /statusz's ``fleet`` section; the router's own
`FlightRecorder` (on iff any replica traces) records `route`, `reroute`,
`drain` and `migrate` events on the engines' clock, and
`to_chrome_fleet` stitches it with every replica's recorder.

Drain: `drain(replica)` migrates every live stream through the journal.
Under the drained replica's step lock its journal is synced, its live
entries snapshotted and every in-flight request force-finished
"migrated" (slots and pages come back through the ordinary finish
paths); then the best admitting peer adopts each entry
(`ServeEngine.adopt`, newest-first, so the oldest ends at the queue
head), which continues it through the preemption-resume path. The front
door closes a "migrated" SSE stream without its terminal chunk, the
client reconnects with its Last-Event-ID cursor, and the cursor resolves
on the peer through the recovered set. "migrated" is left out of the
drained replica's SLO accounting (serve/slo.py): the adopter owns the
latency outcome.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import OrderedDict

import numpy as np

from solvingpapers_tpu_torch.metrics.hist import LogHistogram
from solvingpapers_tpu_torch.metrics.trace import (
    FlightRecorder,
    fleet_events_to_chrome,
)
from solvingpapers_tpu_torch.serve import metrics as smetrics
from solvingpapers_tpu_torch.serve.api import EngineLoop

__all__ = ["FleetRouter", "MigrationReport", "Replica"]


class Replica:
    """One engine and its step loop under a fleet id ("r0", "r1", ...).
    The engine keeps its pool, journal and metrics, the loop its step
    thread; the replica adds the fleet's facts: the id, the draining
    flag, the admission gate and the locked prefix probe."""

    def __init__(self, rid: str, engine, loop=None, start: bool = True):
        self.rid = rid
        self.engine = engine
        self.loop = loop if loop is not None else EngineLoop(engine, start=start)
        # drain() sets this before it touches the journal: the gate closes
        # first, so nothing lands between the snapshot and the force-drain
        self.draining = False

    @property
    def admitting(self) -> bool:
        """May this replica take NEW admissions? Not while draining, with
        a dead loop thread, or with an "unhealthy" fault plane."""
        return (not self.draining and self.loop.error is None
                and self.engine.health != "unhealthy")

    def free_fraction(self) -> float:
        """Free fraction of the scarcest pool resource: pages on a paged
        pool, slots otherwise (host mirrors, safe without the lock)."""
        pool = self.engine.pool
        budget = getattr(pool, "page_budget", 0)
        if budget:
            return pool.pages_free / budget
        return pool.n_free / max(pool.n_slots, 1)

    def probe(self, prompt: np.ndarray) -> int:
        """Cached-prefix match length of `prompt` on this replica, under
        its step lock (`PrefixCache.peek` is read-only: no LRU touch, so
        a probe cannot evict what it looks for)."""
        eng = self.engine
        if eng.prefix_cache is None:
            return 0
        return self.loop._locked(lambda: eng._match_len(prompt))


@dataclasses.dataclass
class MigrationReport:
    """What one `FleetRouter.drain` did. `targets` maps each migrated
    journal id to ``(peer_rid, new_rid)`` (`new_rid` differs only when
    the peer's journal already held a live entry of that id); `errors`
    holds ``(rid, reason)`` for entries no peer could adopt (they
    finished "migrated" on the drained replica and its journal record is
    their only trace)."""

    replica: str
    entries: int
    migrated: list
    targets: dict
    errors: list
    wall_s: float


class FleetRouter:
    """N `ServeEngine` replicas behind one submit surface (the module
    docstring has the policy). Each engine gets a `Replica` and a started
    `EngineLoop` (``start=False`` for manually stepped benches and
    tests); hand the router to `ApiServer(router=...)`."""

    # bounded like the front door's timeline registry: the owner map only
    # speeds up cancel and resume lookups, and an evicted id falls back to
    # scanning the replicas' recovered sets
    owner_cap = 4096

    def __init__(self, engines, *, replica_ids=None,
                 burn_threshold: float = 1.0, start: bool = True,
                 stale_shard_cutoff_s: float = 300.0):
        engines = list(engines)
        if not engines:
            raise ValueError("FleetRouter needs at least one engine")
        paths = [e.config.journal_path for e in engines]
        dup = {p for p in paths if p is not None and paths.count(p) > 1}
        if dup:
            raise ValueError(
                f"replicas share a journal file ({sorted(dup)}): each replica "
                "needs its OWN journal, since interleaved writers would "
                "corrupt recovery and drain migration")
        ids = (list(replica_ids) if replica_ids is not None
               else [f"r{i}" for i in range(len(engines))])
        if len(ids) != len(engines) or len(set(ids)) != len(ids):
            raise ValueError("replica_ids must be unique, one per engine")
        self.replicas = [Replica(rid, eng, start=start)
                         for rid, eng in zip(ids, engines)]
        self._by_id = {r.rid: r for r in self.replicas}
        # burn rate above which a replica stops taking traffic of the
        # burning class (1.0: the error budget is spent over the window)
        self.burn_threshold = burn_threshold
        # a non-admitting replica whose metrics have not moved for longer
        # than this is left out of the /metrics histogram merge (its
        # labelled set still serves it, tagged serve/shard_stale)
        self.stale_shard_cutoff_s = stale_shard_cutoff_s
        self._lock = threading.Lock()
        self._owners: OrderedDict[str, Replica] = OrderedDict()
        self.stats = {
            "routed": 0, "affinity_hits": 0, "burn_avoided": 0,
            "rerouted_full": 0, "drains": 0, "migrated_streams": 0,
            "migration_errors": 0,
        }
        # the router's own recorder, on iff any replica records, on the
        # engines' clock so the stitched export has one time base
        self.trace: FlightRecorder | None = None
        traced = [e for e in engines if e.trace is not None]
        if traced:
            self.trace = FlightRecorder(
                capacity=traced[0].config.trace_capacity, clock=smetrics.now)

    # ------------------------------------------------------------ routing

    def replica(self, rid: str) -> Replica:
        try:
            return self._by_id[rid]
        except KeyError:
            raise KeyError(f"unknown replica {rid!r} (have "
                           f"{sorted(self._by_id)})") from None

    def _rank(self, prompt: np.ndarray, slo: str | None
              ) -> tuple[list[Replica], list[dict]]:
        """Admitting replicas, best first: health gate, burn gate, prefix
        affinity, then least loaded. Returns (ranked, scores): one score
        row a replica, the evidence the `route` span records (ranked
        candidates with the sort's signals, excluded ones with the gate
        that dropped them)."""
        excluded = {r.rid: "not_admitting" for r in self.replicas
                    if not r.admitting}
        cands = [r for r in self.replicas if r.admitting]
        if slo is not None and len(cands) > 1:
            cool = [r for r in cands
                    if r.engine._slo is None
                    or slo not in r.engine._slo.targets
                    or r.engine._slo.burn_rate(slo) <= self.burn_threshold]
            if cool and len(cool) < len(cands):
                with self._lock:
                    self.stats["burn_avoided"] += 1
                for r in cands:
                    if r not in cool:
                        excluded[r.rid] = "burn"
                cands = cool
        matches = {r.rid: r.probe(prompt) for r in cands}
        if max(matches.values(), default=0) > 0:
            with self._lock:
                self.stats["affinity_hits"] += 1

        def key(r: Replica):
            # longest cached prefix, then emptiest, then roomiest queue;
            # the id last, so the ranking is deterministic
            return (-matches[r.rid], -r.free_fraction(),
                    -r.engine.scheduler.capacity_left, r.rid)

        ranked = sorted(cands, key=key)
        scores = [{"replica": r.rid, "match": matches[r.rid],
                   "free": round(r.free_fraction(), 4),
                   "queue_room": r.engine.scheduler.capacity_left}
                  for r in ranked]
        scores += [{"replica": rid, "excluded": why}
                   for rid, why in sorted(excluded.items())]
        return ranked, scores

    def route(self, prompt, slo: str | None = None) -> Replica | None:
        """The admission replica for `prompt` (None when nothing admits);
        `submit` is the same ranking with full-queue retry."""
        ranked, _ = self._rank(np.asarray(prompt).reshape(-1), slo)
        return ranked[0] if ranked else None

    def submit(self, prompt, *, max_new_tokens: int = 64, params=None,
               deadline_s=None, grammar=None, stream_cb=None, trace_id=None):
        """Route and submit through the chosen replica's loop; returns
        ``(replica, request)``, or ``(None, None)`` when nothing admits
        (the front door answers 503). A replica that rejects host-side
        (full queue, shed, or a health flip that raced the ranking) does
        not bounce the client while a peer has room: the router goes down
        the ranked list and returns the LAST rejection only when every
        candidate refused. A `ValueError` (a malformed request) propagates
        at once: it would fail the same everywhere.

        The accepted request carries ``fleet_reroutes`` (ranked peers
        that refused before this one took it: the ``X-Fleet-Reroutes``
        header) and ``fleet_route_s`` (ranking and retry wall: the trail's
        "route" phase), with tracing on or off."""
        prompt = np.asarray(prompt).reshape(-1)
        slo = getattr(params, "slo", None) if params is not None else None
        t0 = smetrics.now()
        ranked, scores = self._rank(prompt, slo)
        if not ranked:
            return None, None
        last = None
        refusals: list[tuple[float, str]] = []
        for i, rep in enumerate(ranked):
            try:
                req = rep.loop.submit(
                    prompt, max_new_tokens=max_new_tokens, params=params,
                    deadline_s=deadline_s, grammar=grammar,
                    stream_cb=stream_cb, trace_id=trace_id)
            except RuntimeError:
                # the loop died between the ranking and the submit
                refusals.append((smetrics.now(), rep.rid))
                continue
            if req.state != "rejected":
                with self._lock:
                    self.stats["routed"] += 1
                    if i:
                        self.stats["rerouted_full"] += 1
                self._remember(req.trace_id, rep)
                dur = max(smetrics.now() - t0, 0.0)
                req.fleet_reroutes = i
                req.fleet_route_s = dur
                if self.trace is not None:
                    for ts, frm in refusals:
                        self.trace.instant("reroute", "fleet", "router",
                                           req=req.id, ts=ts, rid=req.trace_id,
                                           rejected_by=frm)
                    self.trace.complete("route", "fleet", "router", ts=t0,
                                        dur=dur, req=req.id, rid=req.trace_id,
                                        replica=rep.rid, attempts=i + 1,
                                        scores=scores)
                return rep, req
            refusals.append((smetrics.now(), rep.rid))
            last = (rep, req)
        if self.trace is not None:
            self.trace.instant("route_failed", "fleet", "router",
                               ts=smetrics.now(), attempts=len(ranked),
                               scores=scores)
        return last if last is not None else (None, None)

    def _remember(self, rid, rep: Replica) -> None:
        if rid is None:
            return
        with self._lock:
            self._owners[rid] = rep
            self._owners.move_to_end(rid)
            while len(self._owners) > self.owner_cap:
                self._owners.popitem(last=False)

    def owner(self, rid) -> Replica | None:
        """The replica that owns stream `rid` now (the routed one, or the
        adopter after a migration); past the bounded owner map, found by
        scanning the recovered sets."""
        if rid is None:
            return None
        with self._lock:
            rep = self._owners.get(rid)
        if rep is not None:
            return rep
        for r in self.replicas:
            if rid in r.engine._recovered:
                return r
        return None

    def owner_loop(self, req) -> EngineLoop:
        """The loop that owns `req` (for cancel); replica 0's when the
        owner is unknown (a cancel on the wrong engine is a no-op:
        `engine.cancel` matches by identity)."""
        rep = self.owner(getattr(req, "trace_id", None))
        return rep.loop if rep is not None else self.replicas[0].loop

    # ------------------------------------------------------- fleet views

    @property
    def capacity_left(self) -> int:
        """Fleet-wide queue room over the admitting replicas: the front
        door's backpressure probe."""
        return sum(r.engine.scheduler.capacity_left
                   for r in self.replicas if r.admitting)

    @property
    def degradation_rung(self) -> int:
        """The Retry-After input: the least degraded admitting replica's
        rung (traffic goes there), the highest of all when none admits."""
        rungs = [r.engine.degradation_rung for r in self.replicas
                 if r.admitting]
        if rungs:
            return min(rungs)
        return max(r.engine.degradation_rung for r in self.replicas)

    @property
    def health(self) -> str:
        """/healthz of the fleet: healthy while any admitting replica is,
        degraded while only degraded ones admit, unhealthy when none
        admits."""
        states = [r.engine.health for r in self.replicas if r.admitting]
        if any(s == "healthy" for s in states):
            return "healthy"
        return "degraded" if states else "unhealthy"

    def prom_sets(self):
        """``[(step, labels, metrics), ...]`` for
        `PrometheusTextWriter.render_sets`: the unlabelled merged set
        first (fleet gauges and the exact merge of every replica's
        latency histograms, so a quantile over the merged series is the
        quantile over the union of observations), then one
        ``replica="rN"`` set per replica. Each replica's snapshot and its
        histograms' merge are taken under its step lock.

        A replica that is not admitting and whose metrics have not moved
        for `stale_shard_cutoff_s` is stale: its labelled set still
        serves its numbers, tagged ``serve/shard_stale`` 1, but the merge
        skips it (``fleet/stale_shards`` counts them); every labelled set
        carries ``serve/shard_age_s``."""
        merged: dict[str, LogHistogram] = {}
        per = []
        max_step = 0
        stale_shards = 0
        for r in self.replicas:
            m = r.engine.metrics
            ref = m._t_last if m._t_last is not None else m._t_first
            age = max(smetrics.now() - ref, 0.0) if ref is not None else 0.0
            stale = not r.admitting and age > self.stale_shard_cutoff_s
            stale_shards += stale

            def grab(eng=r.engine, stale=stale):
                snap = eng.metrics.prom_snapshot()
                if not stale:
                    for k, v in snap.items():
                        if isinstance(v, LogHistogram):
                            acc = merged.get(k)
                            if acc is None:
                                merged[k] = acc = LogHistogram(
                                    *v.layout[:2],
                                    buckets_per_decade=v.layout[2])
                            acc.merge_from(v)
                return eng._step_idx, snap

            step, snap = r.loop._locked(grab)
            snap["serve/shard_age_s"] = round(age, 3)
            snap["serve/shard_stale"] = float(stale)
            max_step = max(max_step, step)
            per.append((step, {"replica": r.rid}, snap))
        fleet = {
            "fleet/replicas": float(len(self.replicas)),
            "fleet/admitting": float(sum(r.admitting for r in self.replicas)),
            "fleet/draining": float(sum(r.draining for r in self.replicas)),
            "fleet/capacity_left": float(self.capacity_left),
            "fleet/stale_shards": float(stale_shards),
        }
        with self._lock:
            for k, v in self.stats.items():
                fleet[f"fleet/{k}"] = float(v)
        fleet.update(merged)
        return [(max_step, None, fleet)] + per

    def statusz(self) -> dict:
        """/statusz's ``fleet`` section: each replica's admission facts
        (host mirrors, safe from request threads) with the policy and the
        routing counters."""
        reps = {}
        for r in self.replicas:
            eng = r.engine
            d = {
                "health": eng.health,
                "draining": r.draining,
                "admitting": r.admitting,
                "rung": eng.degradation_rung,
                "loop_error": (None if r.loop.error is None else
                               f"{type(r.loop.error).__name__}: {r.loop.error}"),
                "step": eng._step_idx,
                "occupancy": round(eng.pool.occupancy, 4),
                "n_free": eng.pool.n_free,
                "queue_depth": len(eng.scheduler),
                "capacity_left": eng.scheduler.capacity_left,
                "recovered_requests": eng._recovered_total,
            }
            if getattr(eng.pool, "page_budget", 0):
                d["pages_free"] = eng.pool.pages_free
            reps[r.rid] = d
        with self._lock:
            routing = dict(self.stats)
        return {"replicas": reps,
                "policy": {"burn_threshold": self.burn_threshold},
                "routing": routing}

    def timeseriesz(self) -> dict:
        """The fleet's /timeseriesz body: one document a replica that
        keeps a time series."""
        return {"replicas": {r.rid: r.engine.timeseries.doc()
                             for r in self.replicas
                             if r.engine.timeseries is not None}}

    # ----------------------------------------------------- stitched export

    def to_chrome_fleet(self) -> dict:
        """ONE Chrome trace of the fleet: the router's recorder and every
        replica's, one Perfetto process each (`fleet_events_to_chrome`),
        with flows following each request across reroutes and
        migrations by the rid its events carry."""
        sections = []
        if self.trace is not None:
            sections.append(("router", self.trace.events()))
        for r in self.replicas:
            if r.engine.trace is not None:
                sections.append((r.rid, r.engine.trace.events()))
        if not sections:
            raise ValueError("no recorders to stitch: run the replicas with "
                             "ServeConfig.trace=True")
        return fleet_events_to_chrome(sections)

    def export_chrome_fleet(self, path: str) -> str:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_fleet(), f)
        return path

    # ------------------------------------------------------------- drain

    def undrain(self, rid: str) -> None:
        """Reopen admissions to a drained replica."""
        self.replica(rid).draining = False

    def drain(self, rid: str, *, peer_slo_route: bool = True) -> MigrationReport:
        """Stop admissions to `rid` and migrate every live stream to a
        peer through the journal.

        1. The replica's admission gate closes (`draining`).
        2. Under its step lock, in ONE critical section, its journal is
           synced, the live entries are snapshotted (token lists copied)
           and every in-flight request is force-finished "migrated"
           (`ServeEngine.force_drain`; slots and pages come back through
           the finish paths and the finish lands in its journal). One
           section, because a token decoded after the snapshot but before
           the stop would put the client's Last-Event-ID cursor past the
           peer's committed prefix: a 409 instead of a resume.
        3. The best admitting peer adopts each entry (`ServeEngine.adopt`
           under the peer's lock), newest-first so the oldest ends at each
           peer's queue head; the owner map follows the stream.

        Entries no peer can adopt go into `MigrationReport.errors`. The
        drained replica stays up (draining, with no streams); `undrain`
        reopens it. Raises KeyError for an unknown replica, ValueError
        when it has no journal, RuntimeError when no peer admits."""
        rep = self.replica(rid)
        if rep.engine.journal is None:
            raise ValueError(
                f"drain({rid!r}) migrates through the write-ahead journal; "
                "the replica has no journal_path")
        if not any(r is not rep and r.admitting for r in self.replicas):
            raise RuntimeError(f"no admitting peer to drain {rid!r} into: "
                               "refusing to drop its live streams")
        t0 = time.monotonic()
        t_d0 = smetrics.now()
        rep.draining = True

        def freeze(eng=rep.engine):
            eng.journal.sync()
            entries = [dataclasses.replace(e, tokens=list(e.tokens))
                       for e in eng.journal.live_entries()]
            eng.force_drain("migrated")
            return entries

        entries = rep.loop._locked(freeze)
        migrated, errors, targets = [], [], {}
        for e in reversed(entries):  # newest-first: see step 3
            t_m0 = smetrics.now()
            slo = (e.params or {}).get("slo") if peer_slo_route else None
            target = self.route(np.asarray(e.prompt, np.int64), slo=slo)
            if target is None or target is rep:
                errors.append((e.rid, "no admitting peer"))
                continue
            try:
                req = target.loop._locked(
                    lambda eng=target.engine, e=e: eng.adopt(e))
            except ValueError as exc:
                errors.append((e.rid, str(exc)))
                continue
            target.loop._wake.set()
            self._remember(req.trace_id, target)
            targets[e.rid] = (target.rid, req.trace_id)
            migrated.append(req)
            if self.trace is not None:
                self.trace.complete(
                    "migrate", "fleet", "router", ts=t_m0,
                    dur=max(smetrics.now() - t_m0, 0.0), req=req.id,
                    rid=req.trace_id, src=rid, dst=target.rid, old_rid=e.rid)
        migrated.reverse()  # arrival order
        with self._lock:
            self.stats["drains"] += 1
            self.stats["migrated_streams"] += len(migrated)
            self.stats["migration_errors"] += len(errors)
        if self.trace is not None:
            self.trace.complete(
                "drain", "fleet", "router", ts=t_d0,
                dur=max(smetrics.now() - t_d0, 0.0), replica=rid,
                entries=len(entries), migrated=len(migrated),
                errors=len(errors))
        return MigrationReport(replica=rid, entries=len(entries),
                               migrated=migrated, targets=targets,
                               errors=errors, wall_s=time.monotonic() - t0)

    # ------------------------------------------------------------- close

    def close(self, drain_timeout_s: float = 0.0) -> None:
        """Close every replica (loop, then engine) within ONE shared drain
        budget."""
        deadline = time.monotonic() + max(drain_timeout_s, 0.0)
        for r in self.replicas:
            left = max(deadline - time.monotonic(), 0.0)
            r.loop.close(drain_timeout_s=left)
            r.engine.close()
