"""Durable control-plane state: write-ahead journal + snapshot + recovery.

The data plane survives chip loss, torn checkpoints, and preemption, but
the control plane (scheduler queue, HBM reservation ledger, serving-fleet
roster, held requests, autopilot/spill cooldowns, prefix host-tier index)
is a single in-memory process. :class:`ControlPlaneJournal` makes its
death recoverable: every state-changing control event is appended as one
JSONL line (write-ahead), and a periodic full-state ``snapshot`` record
bounds replay length. Recovery is ``snapshot + replay of the event
suffix`` — deterministic, so restoring the same journal twice yields
byte-identical state — followed by reconciliation against live reality
(see ``FleetScheduler.restore`` / ``ServingFleet.re_adopt``).

Persistence follows the flight recorder's idiom exactly
(``tracing.FlightRecorder._persist``): size-capped file, atomic
``os.replace`` rotation keeping exactly one previous generation,
``schema_version`` stamped on every line. Ingestion mirrors
``twin.read_recorder_jsonl``: a torn final line of the live file, parse
errors, unknown schema versions, and unknown record kinds are all
skipped and counted, never raised.

``stats()`` and the module-level :func:`journal_stats` /
:func:`recovery_stats` read O(1) counters only — a metrics scrape never
walks journal contents (see ``tests/test_depth_bounds.py``).

The port's copy of ``tpu_engine/journal.py`` (the JAX package's module uses
no JAX, and the port imports nothing of that package): the same code,
with the port's imports and its own exporter name; Prometheus families
keep JAX's names, so one dashboard reads both.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

__all__ = [
    "SCHEMA_VERSION",
    "SKIP_REASONS",
    "ControlPlaneJournal",
    "set_active_journal",
    "get_active_journal",
    "clear_active_journal",
    "journal_stats",
    "recovery_stats",
    "note_mttr",
    "note_recovery",
    "collect_sections",
]

# Version stamped onto every journal line. Bump on any change to the
# record shape; readers accept lines at or below their own version and
# skip newer ones, so an old journal stays restorable across upgrades.
SCHEMA_VERSION = 1

# Record kinds a reader of this build understands.
_KNOWN_RECORDS = ("snapshot", "event")

SKIP_REASONS = ("torn_tail", "parse_error", "unknown_schema", "unknown_record")

DEFAULT_MAX_BYTES = 16 * 1024 * 1024


# -- module health counters (tpu_engine_journal_* / _ctl_recovery_*) ----------

_STATS_LOCK = threading.Lock()
_READ_STATS: Dict[str, Any] = {
    "reads_total": 0,
    "read_lines_total": 0,
    "read_skipped_lines_total": 0,
    "read_skipped_by_reason": {r: 0 for r in SKIP_REASONS},
}
_RECOVERY: Dict[str, Any] = {
    "restores_total": 0,
    "records_replayed_total": 0,
    "jobs_readopted_total": 0,
    "requeued_vanished_total": 0,
    "double_grants_total": 0,
    "replicas_readopted_total": 0,
    "replicas_redispatched_total": 0,
    "requests_recovered_total": 0,
    "last_mttr_seconds": 0.0,
}


def recovery_stats() -> Dict[str, Any]:
    """Snapshot of the crash-recovery counters (O(1), no journal walk)."""
    with _STATS_LOCK:
        return dict(_RECOVERY)


def note_mttr(seconds: float) -> None:
    """Record the wall duration of the last control-plane recovery."""
    with _STATS_LOCK:
        _RECOVERY["last_mttr_seconds"] = float(seconds)


def note_recovery(**deltas: float) -> None:
    """Accumulate recovery counters (called by the restore/re_adopt paths)."""
    with _STATS_LOCK:
        for k, v in deltas.items():
            _RECOVERY[k] += v


def _reset_stats_for_tests() -> None:
    with _STATS_LOCK:
        for k, v in list(_READ_STATS.items()):
            _READ_STATS[k] = {r: 0 for r in SKIP_REASONS} if isinstance(v, dict) else 0
        for k, v in list(_RECOVERY.items()):
            _RECOVERY[k] = 0 if isinstance(v, int) else 0.0


# -- the journal ---------------------------------------------------------------


class ControlPlaneJournal:
    """Bounded, atomically-rotated JSONL write-ahead journal.

    Two record kinds: ``event`` (one control-plane state change) and
    ``snapshot`` (full serialized state; replay starts from the newest
    one). Appends never raise — persistence failures increment
    ``append_errors_total`` and the control plane keeps running, exactly
    like the flight recorder."""

    def __init__(
        self,
        path: str,
        max_bytes: int = DEFAULT_MAX_BYTES,
        clock: Callable[[], float] = time.time,
    ):
        self.path = path
        self.max_bytes = int(max_bytes)
        self.clock = clock
        self._lock = threading.Lock()
        self.bytes = 0
        self.appends_total = 0
        self.snapshots_total = 0
        self.rotations_total = 0
        self.append_errors_total = 0
        if os.path.exists(path):
            try:
                self.bytes = os.path.getsize(path)
            except OSError:
                pass

    # -- writes ---------------------------------------------------------------

    def append(self, kind: str, payload: Dict[str, Any], ts: Optional[float] = None) -> None:
        """Write-ahead one control-plane event (e.g. ``sched.submit``)."""
        self._write({
            "record": "event",
            "kind": kind,
            "ts": self.clock() if ts is None else ts,
            "payload": payload,
        })
        with self._lock:
            self.appends_total += 1

    def snapshot(self, sections: Dict[str, Any], ts: Optional[float] = None) -> None:
        """Write a full-state snapshot; replay starts at the newest one.

        ``sections`` maps component name (``scheduler``, ``serving``,
        ``autopilot``, ``spec_spill``, ``prefix_host``) to that
        component's serialized state dict."""
        self._write({
            "record": "snapshot",
            "ts": self.clock() if ts is None else ts,
            "sections": sections,
        })
        with self._lock:
            self.snapshots_total += 1

    def _write(self, record: Dict[str, Any]) -> None:
        try:
            record = dict(record, schema_version=SCHEMA_VERSION)
            line = json.dumps(record, default=str) + "\n"
            with self._lock:
                if self.bytes + len(line) > self.max_bytes:
                    # rotate: keep exactly one previous generation bounded
                    try:
                        os.replace(self.path, self.path + ".1")
                    except OSError:
                        pass
                    self.bytes = 0
                    self.rotations_total += 1
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line)
                self.bytes += len(line)
        except Exception:
            with self._lock:
                self.append_errors_total += 1

    # -- reads ----------------------------------------------------------------

    def read(self) -> Dict[str, Any]:
        """Ingest the journal (rotated ``.1`` generation first) into the
        newest snapshot plus the event suffix recorded after it.

        Hardened for mid-write capture exactly like
        ``twin.read_recorder_jsonl``: an undecodable *final* line of the
        live file is a torn tail, any other bad line a parse error, a
        ``schema_version`` above this build's an unknown future format,
        an unrecognized ``record`` kind an unknown record — all skipped
        and counted, never raised. Lines without ``schema_version`` are
        legacy and accepted."""
        files = [p for p in (self.path + ".1", self.path) if os.path.exists(p)]
        snapshot: Optional[dict] = None
        events: list = []
        stats: Dict[str, Any] = {
            "files": len(files),
            "lines": 0,
            "accepted": 0,
            "skipped": 0,
            "skipped_by_reason": {},
            "legacy_lines": 0,
            "schema_version": SCHEMA_VERSION,
        }

        def _skip(reason: str) -> None:
            stats["skipped"] += 1
            by = stats["skipped_by_reason"]
            by[reason] = by.get(reason, 0) + 1

        for fi, fp in enumerate(files):
            with open(fp, encoding="utf-8", errors="replace") as f:
                lines = f.read().split("\n")
            if lines and lines[-1] == "":
                lines.pop()
            for li, line in enumerate(lines):
                if not line.strip():
                    continue
                stats["lines"] += 1
                # Only the live file's final line can be a torn partial
                # write; rotation happens on line boundaries.
                torn_candidate = fi == len(files) - 1 and li == len(lines) - 1
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    _skip("torn_tail" if torn_candidate else "parse_error")
                    continue
                if not isinstance(rec, dict):
                    _skip("parse_error")
                    continue
                sv = rec.get("schema_version")
                if sv is None:
                    stats["legacy_lines"] += 1  # pre-versioning journal
                elif not isinstance(sv, int) or sv < 1 or sv > SCHEMA_VERSION:
                    _skip("unknown_schema")
                    continue
                kind = rec.get("record")
                if kind not in _KNOWN_RECORDS:
                    _skip("unknown_record")
                    continue
                stats["accepted"] += 1
                if kind == "snapshot":
                    snapshot = rec
                    events = []  # replay restarts at the newest snapshot
                else:
                    events.append(rec)

        with _STATS_LOCK:
            _READ_STATS["reads_total"] += 1
            _READ_STATS["read_lines_total"] += stats["lines"]
            _READ_STATS["read_skipped_lines_total"] += stats["skipped"]
            for r, n in stats["skipped_by_reason"].items():
                by = _READ_STATS["read_skipped_by_reason"]
                by[r] = by.get(r, 0) + n
        return {"snapshot": snapshot, "events": events, "stats": stats}

    # -- health ---------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """O(1) counters — never opens or walks the journal files."""
        with self._lock:
            return {
                "path": self.path,
                "max_bytes": self.max_bytes,
                "bytes": self.bytes,
                "appends_total": self.appends_total,
                "snapshots_total": self.snapshots_total,
                "rotations_total": self.rotations_total,
                "append_errors_total": self.append_errors_total,
            }


# -- process-wide active journal (mirrors faults.set_active) -------------------

_ACTIVE_LOCK = threading.Lock()
_active: Optional[ControlPlaneJournal] = None


def set_active_journal(journal: Optional[ControlPlaneJournal]) -> None:
    global _active
    with _ACTIVE_LOCK:
        _active = journal


def get_active_journal() -> Optional[ControlPlaneJournal]:
    with _ACTIVE_LOCK:
        return _active


def clear_active_journal() -> None:
    set_active_journal(None)


def journal_stats() -> Dict[str, Any]:
    """Module health snapshot for ``/metrics`` and ``/api/v1/journal``:
    the active journal's write counters (zeros when none is attached)
    plus the module-level read counters. O(1) — no file access."""
    j = get_active_journal()
    js = j.stats() if j is not None else {
        "path": None,
        "max_bytes": 0,
        "bytes": 0,
        "appends_total": 0,
        "snapshots_total": 0,
        "rotations_total": 0,
        "append_errors_total": 0,
    }
    with _STATS_LOCK:
        out = dict(js)
        out["attached"] = j is not None
        out["reads_total"] = _READ_STATS["reads_total"]
        out["read_lines_total"] = _READ_STATS["read_lines_total"]
        out["read_skipped_lines_total"] = _READ_STATS["read_skipped_lines_total"]
        out["read_skipped_by_reason"] = dict(_READ_STATS["read_skipped_by_reason"])
    return out


# -- snapshot assembly ---------------------------------------------------------


def collect_sections(
    scheduler: Any = None,
    serving: Any = None,
    autopilot: Any = None,
    spec_spill: Any = None,
    prefix_plane: Any = None,
) -> Dict[str, Any]:
    """Gather one full-state snapshot from the live control-plane
    components. Each argument is optional; components that expose
    ``snapshot_state()`` / ``export_state()`` contribute a section."""
    sections: Dict[str, Any] = {}
    if scheduler is not None:
        sections["scheduler"] = scheduler.snapshot_state()
    if serving is not None:
        sections["serving"] = serving.snapshot_state()
    if autopilot is not None:
        sections["autopilot"] = autopilot.export_state()
    if spec_spill is not None:
        sections["spec_spill"] = spec_spill.export_state()
    if prefix_plane is not None:
        sections["prefix_host"] = prefix_plane.export_host_index()
    return sections
