"""Request write-ahead journal: crash-safe durability for the serving
engine (port of `solvingpapers_tpu/serve/journal.py`, in the same JSONL
record format, so either package reads the other's file).

The fault boundary (serve/faults.py) keeps the engine alive through
faults INSIDE a live process, but the process boundary stays a single
point of total loss: a crash, an OOM kill or SIGKILL drops every
in-flight request, and a reconnecting SSE client gets nothing back.
This module is the durability layer — an append-only JSONL write-ahead
journal (`ServeConfig.journal_path`; None-pattern off, like the tracer
and the fault plane) the engine writes three event kinds into:

    submit   request identity + everything needed to replay it: journal
             id (the HTTP front door's X-Request-Id when one exists),
             prompt token ids, the full SamplingParams (incl. seed and
             SLO class), max_new_tokens / eos_id, arrival time
    commit   committed token ids — written once per DECODE-BLOCK
             boundary from tokens already on the host (never per token:
             the journal's granularity is the engine's)
    finish   lifecycle outcome (reason) + usage

Durability contract: every record is ONE `write()` of one newline-
terminated JSON line under the journal lock (concurrent writers —
engine loop + HTTP handler threads — can interleave records but never
tear one), flushed to the OS immediately; `fsync` is BATCHED once per
engine step (`Journal.sync`), so a hard kill loses at most one step's
worth of records — the same boundary at which the engine commits
tokens to streams anyway. The loader tolerates a torn final line (a
crash mid-write) by ignoring it.

Bounded by compaction: finished requests' records are dead weight, so
once `rotate_bytes` of file or `rotate_finished` finish records
accumulate, the journal REWRITES itself to just the live set (one
submit record per unfinished request with its committed tokens folded
in) via atomic tmp + fsync + rename — the journal stays O(active
requests), never O(requests ever served). A bounded in-memory map of
recently finished entries survives rotation so `/v1/requests/<id>` and
SSE reconnects can replay completed streams.

Recovery (`ServeEngine.recover`, `cli serve --journal`): unfinished
entries replay through the engine's preemption-resume machinery —
prefill prompt + committed tokens, discard the resampled token, continue
decoding. Cached KV depends only on token ids and seeded sampling
chains fold only ``(seed, sample_index)``, so a recovered stream is
TOKEN-EXACT against an uninterrupted run for greedy and seeded requests
in float32; in bfloat16 the re-prefill computes through the flash
forward what the first run computed in decode steps, so streams agree
up to near-ties within bf16 rounding. Unseeded stochastic streams keep
their committed prefix and continue from fresh entropy.
Grammar-constrained requests are journaled but NOT resumed (their
stepper is host state the journal does not capture) — recovery
finishes them ``"error"`` instead of silently dropping them.

Failure policy: journal I/O failures (disk full; injected via the
fault plane's ``journal_write`` site, kind ``io_error``) must not take
serving down with them — the engine degrades to journal-off with a
single warning and a ``serve/journal_degraded`` gauge, unless
`ServeConfig.journal_strict` is set (then the failure propagates: a
deployment that REQUIRES durability fails loudly instead of silently
serving without it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import OrderedDict

__all__ = ["Journal", "JournalEntry", "JournalError", "read_entries"]


class JournalError(RuntimeError):
    """A journal write/rotate failed (wraps the OSError); raised to the
    engine's journal boundary, which degrades to journal-off (or, under
    `journal_strict`, lets it escape)."""


@dataclasses.dataclass
class JournalEntry:
    """One request's journaled state, reconstructed by the loader and
    kept live in memory (the recovery set and the lookup surface)."""

    rid: str
    prompt: list
    max_new_tokens: int
    eos_id: int | None
    params: dict
    arrival: float
    grammar: bool = False
    # the request's ORIGINAL relative deadline budget in seconds (None =
    # no deadline); absolute deadlines cannot cross a process restart
    # (monotonic clocks reset), so recovery re-arms this budget fresh
    deadline_s: float | None = None
    tokens: list = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: str | None = None
    usage: dict | None = None


def read_entries(path: str, *, retries: int = 1,
                 retry_delay_s: float = 0.05) -> list[JournalEntry]:
    """Read-only snapshot of a journal file (the reference's replay
    harness loads journals through it), safe against a LIVE writer on
    the same path. Returns every reconstructible entry in arrival order, both
    finished (tokens, outcome, usage folded in) and still-live ones;
    the caller filters for its corpus.

    Concurrency contract: one whole-file read. Appends are single
    `write()` calls of newline-terminated lines, so the only partial
    line a snapshot can see is the final one — tolerated exactly like
    a crash-torn tail. Compaction (`Journal._rotate_locked`) swaps the
    file via atomic tmp + rename; an open descriptor keeps reading the
    pre-rotation inode, and the one observable race — the path briefly
    unresolvable around the swap on non-POSIX rename semantics — is
    absorbed by retrying ENOENT `retries` times before giving up.
    Mid-file corruption still raises `JournalError`: only the tail can
    legitimately be torn."""
    for attempt in range(retries + 1):
        try:
            with open(path, encoding="utf-8") as f:
                lines = f.read().split("\n")
            break
        except FileNotFoundError:
            if attempt >= retries:
                raise
            time.sleep(retry_delay_s)
    entries: OrderedDict[str, JournalEntry] = OrderedDict()
    for i, line in enumerate(lines):
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            if i >= len(lines) - 2:
                break  # torn tail: a crash or an in-flight append
            raise JournalError(
                f"{path}:{i + 1}: malformed journal record before the "
                "final line — the file is corrupt, not merely torn"
            ) from None
        kind = rec.get("kind")
        if kind == "submit":
            e = JournalEntry(
                rid=rec["rid"], prompt=list(rec["prompt"]),
                max_new_tokens=int(rec["max_new_tokens"]),
                eos_id=rec.get("eos_id"), params=rec.get("params") or {},
                arrival=float(rec.get("arrival", 0.0)),
                grammar=bool(rec.get("grammar", False)),
                deadline_s=rec.get("deadline_s"),
                tokens=list(rec.get("tokens", ())),
            )
            # a reused rid (registry last-wins) replaces the old entry
            entries[e.rid] = e
        elif kind == "commit":
            e = entries.get(rec["rid"])
            if e is not None and not e.finished:
                e.tokens.extend(int(t) for t in rec["tokens"])
        elif kind == "finish":
            e = entries.get(rec["rid"])
            if e is not None and not e.finished:
                e.finished = True
                e.finish_reason = rec.get("reason")
                e.usage = rec.get("usage")
        # unknown kinds are skipped, the loader's forward-compat rule
    return list(entries.values())


class Journal:
    """Append-only JSONL write-ahead journal with live-set compaction.

    Opening an existing path LOADS it first (the recovery source — see
    `live_entries`) and then appends; records survive a crash up to the
    last `sync()` (fsync), lines up to the last append (flush). All
    appends serialize behind one lock, so records from the engine loop
    and HTTP handler threads interleave whole, never torn.
    """

    def __init__(self, path: str, *, rotate_bytes: int = 4 << 20,
                 rotate_finished: int = 256, finished_keep: int = 1024):
        if rotate_bytes < 1 or rotate_finished < 1:
            raise ValueError(
                "rotate_bytes and rotate_finished must be >= 1 (the "
                "journal must be allowed to compact)"
            )
        self.path = path
        self.rotate_bytes = rotate_bytes
        self.rotate_finished = rotate_finished
        self.finished_keep = finished_keep
        self._lock = threading.Lock()
        # arrival-ordered unfinished entries: the recovery set
        self.live: OrderedDict[str, JournalEntry] = OrderedDict()
        # recently finished entries, bounded (lookup surface for
        # /v1/requests/<id> and SSE replay past the registry)
        self.finished: OrderedDict[str, JournalEntry] = OrderedDict()
        # counters (the serve/journal_* gauges + /statusz section)
        self.records = 0
        self.bytes_written = 0
        self.fsyncs = 0
        self.fsync_s = 0.0
        self.rotations = 0
        self._finished_since_rotate = 0
        self._dirty = False
        self._load()
        self._f = open(self.path, "a", encoding="utf-8")  # noqa: SIM115

    # ------------------------------------------------------------- load

    def _load(self) -> None:
        """Rebuild the in-memory index from an existing journal file.
        Tolerates a torn FINAL line (crash mid-write); a malformed line
        anywhere else raises — that is corruption, not a crash tail."""
        if not os.path.exists(self.path):
            return
        with open(self.path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        for i, line in enumerate(lines):
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if i >= len(lines) - 2:
                    break  # torn tail: the crash interrupted this write
                raise JournalError(
                    f"{self.path}:{i + 1}: malformed journal record "
                    "before the final line — the file is corrupt, not "
                    "merely crash-torn"
                ) from None
            self._apply(rec)

    def _apply(self, rec: dict) -> None:
        kind = rec.get("kind")
        if kind == "submit":
            e = JournalEntry(
                rid=rec["rid"], prompt=list(rec["prompt"]),
                max_new_tokens=int(rec["max_new_tokens"]),
                eos_id=rec.get("eos_id"), params=rec.get("params") or {},
                arrival=float(rec.get("arrival", 0.0)),
                grammar=bool(rec.get("grammar", False)),
                deadline_s=rec.get("deadline_s"),
                tokens=list(rec.get("tokens", ())),
            )
            self.live[e.rid] = e
        elif kind == "commit":
            e = self.live.get(rec["rid"])
            if e is not None:
                e.tokens.extend(int(t) for t in rec["tokens"])
        elif kind == "finish":
            e = self.live.pop(rec["rid"], None)
            if e is not None:
                e.finished = True
                e.finish_reason = rec.get("reason")
                e.usage = rec.get("usage")
                self._remember_finished(e)
        # unknown kinds are skipped: a newer writer's record must not
        # brick an older reader's recovery

    def _remember_finished(self, e: JournalEntry) -> None:
        self.finished[e.rid] = e
        self.finished.move_to_end(e.rid)
        while len(self.finished) > self.finished_keep:
            self.finished.popitem(last=False)

    # ----------------------------------------------------------- append

    def _write(self, rec: dict) -> None:
        """One record = ONE write of one line (torn-record safety) +
        flush (line-visible to readers; fsync is batched in sync())."""
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        try:
            self._f.write(line)
            self._f.flush()
        except (OSError, ValueError) as exc:  # ValueError: closed file
            raise JournalError(
                f"journal write to {self.path} failed: {exc}"
            ) from exc
        self.records += 1
        self.bytes_written += len(line)
        self._dirty = True

    def is_live(self, rid: str) -> bool:
        """True while `rid` has an unfinished entry — the engine's
        duplicate-id guard (two live streams must never merge their
        commits into one record)."""
        with self._lock:
            return rid in self.live

    def append_submit(self, rid: str, prompt, max_new_tokens: int,
                      eos_id, params: dict, arrival: float,
                      grammar: bool = False,
                      deadline_s: float | None = None) -> None:
        with self._lock:
            e = JournalEntry(
                rid=rid, prompt=[int(t) for t in prompt],
                max_new_tokens=int(max_new_tokens),
                eos_id=None if eos_id is None else int(eos_id),
                params=params, arrival=float(arrival), grammar=grammar,
                deadline_s=deadline_s,
            )
            self._write({
                "kind": "submit", "rid": rid, "prompt": e.prompt,
                "max_new_tokens": e.max_new_tokens, "eos_id": e.eos_id,
                "params": params, "arrival": round(e.arrival, 6),
                "grammar": grammar, "deadline_s": deadline_s,
            })
            self.live[rid] = e

    def append_commit(self, rid: str, tokens) -> None:
        toks = [int(t) for t in tokens]
        if not toks:
            return
        with self._lock:
            self._write({"kind": "commit", "rid": rid, "tokens": toks})
            e = self.live.get(rid)
            if e is not None:
                e.tokens.extend(toks)

    def append_finish(self, rid: str, reason: str,
                      usage: dict | None = None) -> None:
        with self._lock:
            self._write({"kind": "finish", "rid": rid, "reason": reason,
                         "usage": usage or {}})
            e = self.live.pop(rid, None)
            if e is not None:
                e.finished = True
                e.finish_reason = reason
                e.usage = usage or {}
                self._remember_finished(e)
            self._finished_since_rotate += 1
            if (self._finished_since_rotate >= self.rotate_finished
                    or self._f.tell() >= self.rotate_bytes):
                self._rotate_locked()

    # ------------------------------------------------------ sync/rotate

    @property
    def dirty(self) -> bool:
        """Records written since the last `sync()` — the engine's
        per-step fsync gate (idle steps skip the lock and the fault-
        plane poke entirely)."""
        return self._dirty

    def sync(self) -> None:
        """Batched durability point: fsync once if anything was written
        since the last sync — the engine calls this once per step."""
        with self._lock:
            if not self._dirty:
                return
            t0 = time.monotonic()
            try:
                os.fsync(self._f.fileno())
            except OSError as exc:
                raise JournalError(
                    f"journal fsync of {self.path} failed: {exc}"
                ) from exc
            self.fsync_s += time.monotonic() - t0
            self.fsyncs += 1
            self._dirty = False

    def compact(self) -> None:
        """Force a compaction (recovery calls this after replaying the
        live set, so a freshly recovered journal starts O(active))."""
        with self._lock:
            self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Rewrite the journal to the live set only: each unfinished
        request becomes one submit record with its committed tokens
        folded in (`"tokens"`, which the loader accepts). Atomic
        tmp + fsync + rename — a crash mid-rotation leaves either the
        old journal or the new one, never a hybrid."""
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                for e in self.live.values():
                    f.write(json.dumps({
                        "kind": "submit", "rid": e.rid, "prompt": e.prompt,
                        "max_new_tokens": e.max_new_tokens,
                        "eos_id": e.eos_id, "params": e.params,
                        "arrival": round(e.arrival, 6),
                        "grammar": e.grammar, "deadline_s": e.deadline_s,
                        "tokens": e.tokens,
                    }, separators=(",", ":")) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "a", encoding="utf-8")  # noqa: SIM115
        except OSError as exc:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise JournalError(
                f"journal rotation of {self.path} failed: {exc}"
            ) from exc
        self.rotations += 1
        self._finished_since_rotate = 0
        self._dirty = False

    # ----------------------------------------------------------- lookup

    def live_entries(self) -> list[JournalEntry]:
        """Unfinished entries in arrival order — the recovery set."""
        with self._lock:
            return list(self.live.values())

    def lookup(self, rid: str) -> JournalEntry | None:
        """Live or recently finished entry for `rid` (None once a
        finished entry ages past `finished_keep`)."""
        with self._lock:
            return self.live.get(rid) or self.finished.get(rid)

    def stats(self) -> dict:
        """The /statusz `journal` section + gauge source."""
        with self._lock:
            return {
                "path": self.path,
                "records": self.records,
                "bytes_written": self.bytes_written,
                "fsyncs": self.fsyncs,
                "fsync_s": round(self.fsync_s, 6),
                "rotations": self.rotations,
                "live": len(self.live),
                "finished_kept": len(self.finished),
            }

    def close(self) -> None:
        """Flush + fsync + close (idempotent); further appends raise
        JournalError, which the engine's degrade boundary absorbs."""
        with self._lock:
            if self._f.closed:
                return
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except OSError:
                pass
            self._f.close()
