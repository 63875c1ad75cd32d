"""Fleet flight recorder: causally-linked lifecycle tracing.

The control plane can already answer "what is the fleet doing *now*"
(Prometheus gauges in ``backend/routers/metrics.py``), but not "what
happened to job X and why was step 412 slow" — each subsystem keeps its
own ad-hoc log (``FaultInjector.events``, scheduler skip reasons,
``recovery_state`` transitions, autoscaler decisions) with no shared IDs
or causality. This module is the shared spine those logs thread through:

- ``FlightRecorder``: a process-wide, thread-safe, bounded record of
  **spans** (named intervals with a ``trace_id`` and a causal
  ``parent_id``) and **instant events**. One trace per job submission /
  serving request; children chain to parents so detect → emergency-save
  → requeue → shrink-admit → resume → grow-back reads as one causal
  chain instead of six island logs.
- **Step-time anomaly attribution** (``StepTimeAnomalyDetector`` +
  ``FlightRecorder.attribute``): a sliding per-job step-latency baseline
  flags outlier steps; the recorder attributes each to the span/event
  overlapping that step's wall window (checkpoint save, host-slow fault,
  compile, preemption drain) in a fixed priority order. A sustained
  regression can opt-in auto-start a bounded ``TraceSession``
  (``profiler.py``) XPlane capture.
- **Export**: Chrome-trace/Perfetto JSON (``export_chrome_trace``,
  served at ``GET /api/v1/trace/{trace_id}.json``), a filterable span
  query (``GET /api/v1/trace``), bounded JSONL persistence, and health
  counters for the ``tpu_engine_trace_*`` Prometheus families.

Timestamps are plain float seconds. Every recording API accepts an
explicit timestamp so discrete-event simulations (``benchmarks/chaos.py``
runs on a virtual clock) can record the same spans a live run would;
when omitted, the recorder's ``clock`` (default ``time.time``) is used.

The port's copy of ``tpu_engine/tracing.py`` (the JAX package's module uses
no JAX, and the port imports nothing of that package): the same code,
with the port's imports and its own exporter name; Prometheus families
keep JAX's names, so one dashboard reads both.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import uuid
from collections import Counter, OrderedDict, deque
from statistics import median
from typing import Any, Callable, Dict, List, Optional, Union

from tpu_engine_torch import historian as historian_mod

__all__ = [
    "SCHEMA_VERSION",
    "Span",
    "FlightRecorder",
    "StepTimeAnomalyDetector",
    "get_recorder",
    "set_recorder",
]

# Version stamped onto every persisted JSONL line. Bump on any change to
# the persisted record shape; the twin's ingester (``tpu_engine/twin.py``)
# accepts lines at or below its own version and skips newer ones, so old
# traces stay replayable across recorder changes.
SCHEMA_VERSION = 1

# Attribution causes, highest priority first: a host-slow fault explains
# a slow step better than a checkpoint save that also overlapped it.
# Maps recorder kind -> attributed cause label.
ATTRIBUTION_PRIORITY: List[tuple] = [
    ("fault", "host-slow"),
    ("preempt_drain", "preempt-drain"),
    ("emergency_save", "preempt-drain"),
    ("checkpoint_save", "checkpoint-save"),
    ("checkpoint_restore", "restore"),
    ("compile", "compile"),
]


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """A named interval on a trace. Open until :meth:`end` is called;
    open spans still export (with ``t1 = now``) so a live timeline is
    viewable mid-run."""

    __slots__ = (
        "span_id",
        "trace_id",
        "parent_id",
        "name",
        "kind",
        "t0",
        "t1",
        "attrs",
        "_recorder",
    )

    def __init__(
        self,
        recorder: "FlightRecorder",
        name: str,
        kind: str,
        trace_id: str,
        parent_id: Optional[str],
        t0: float,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self._recorder = recorder
        self.span_id = recorder._make_id()
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.t0 = float(t0)
        self.t1: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs or {})

    def annotate(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, t1: Optional[float] = None, **attrs: Any) -> "Span":
        if attrs:
            self.attrs.update(attrs)
        self._recorder._finish_span(self, t1)
        return self

    def cancel(self) -> None:
        """Drop an open span without recording it (e.g. an admission
        attempt that will retry next poll pass — recording every pass
        would flood the buffer)."""
        self._recorder._cancel_span(self)

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "span_id": self.span_id,
            "trace_id": self.trace_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "kind": self.kind,
            "t0": self.t0,
            "t1": self.t1,
            "duration_s": self.duration_s,
            "attrs": dict(self.attrs),
        }

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        if self.t1 is None:
            self.end()


class FlightRecorder:
    """Process-wide bounded span/event recorder.

    Closed spans and events live in bounded ring buffers; evictions bump
    monotonic drop counters (never silently — that is the exact bug the
    ``FaultInjector`` event log had). All methods are thread-safe; the
    internal lock is never held while calling foreign code."""

    def __init__(
        self,
        max_spans: int = 4096,
        max_events: int = 4096,
        clock: Callable[[], float] = time.time,
        persist_path: Optional[str] = None,
        persist_max_bytes: int = 16 * 1024 * 1024,
        id_factory: Optional[Callable[[], str]] = None,
    ):
        self._lock = threading.RLock()
        self.clock = clock
        # Injectable so the digital twin can replay with deterministic,
        # byte-stable span/event ids (uuid4 otherwise).
        self._id_factory = id_factory
        self.max_spans = int(max_spans)
        self.max_events = int(max_events)
        self._closed: deque = deque()  # Span dicts, oldest first
        self._open: "OrderedDict[str, Span]" = OrderedDict()
        self._events: deque = deque()  # event dicts, oldest first
        # Per-trace views of the same ring entries (references, not
        # copies), maintained on close/evict. A trace-filtered query —
        # the goodput ledger decomposes one trace per finalize — reads
        # O(that trace's records) instead of copying and filtering the
        # whole ring, which made reaping 100k jobs quadratic in practice.
        self._closed_by_trace: Dict[str, deque] = {}
        self._open_by_trace: Dict[str, "OrderedDict[str, Span]"] = {}
        self._events_by_trace: Dict[str, deque] = {}
        self._trace_roots: Dict[str, str] = {}  # trace_id -> root span_id
        self._trace_order: "OrderedDict[str, float]" = OrderedDict()
        # health counters (monotonic)
        self.spans_total: Counter = Counter()  # by kind
        self.events_total: Counter = Counter()  # by kind
        self.spans_dropped = 0
        self.events_dropped = 0
        self.traces_total = 0
        self.anomalies_total: Counter = Counter()  # by attributed cause
        # bounded JSONL persistence
        self.persist_path = persist_path
        self.persist_max_bytes = int(persist_max_bytes)
        self.persist_bytes = 0
        self.persist_rotations = 0
        self.persist_errors = 0

    # -- ids / traces --------------------------------------------------------

    def _make_id(self) -> str:
        return self._id_factory() if self._id_factory is not None else _new_id()

    def new_trace_id(self) -> str:
        with self._lock:
            self.traces_total += 1
        return self._make_id()

    def trace_root(self, trace_id: Optional[str]) -> Optional[str]:
        """span_id of the first span recorded on ``trace_id`` (the causal
        root), or None for an unknown/event-only trace."""
        if trace_id is None:
            return None
        with self._lock:
            return self._trace_roots.get(trace_id)

    # -- recording -----------------------------------------------------------

    def start_span(
        self,
        name: str,
        kind: str = "span",
        trace_id: Optional[str] = None,
        parent: Union[None, str, Span] = None,
        t0: Optional[float] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> Span:
        parent_id = parent.span_id if isinstance(parent, Span) else parent
        if trace_id is None:
            trace_id = (
                parent.trace_id if isinstance(parent, Span) else self.new_trace_id()
            )
        t0 = self.clock() if t0 is None else float(t0)
        span = Span(self, name, kind, trace_id, parent_id, t0, attrs)
        with self._lock:
            self._open[span.span_id] = span
            self._open_by_trace.setdefault(trace_id, OrderedDict())[
                span.span_id
            ] = span
            self._note_trace(trace_id, span.span_id, t0)
        return span

    def record_span(
        self,
        name: str,
        kind: str = "span",
        trace_id: Optional[str] = None,
        parent: Union[None, str, Span] = None,
        t0: Optional[float] = None,
        t1: Optional[float] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> Span:
        """Record an already-finished interval in one call (used where the
        caller timed the work itself, e.g. a successful admission pass)."""
        span = self.start_span(name, kind, trace_id, parent, t0, attrs)
        span.end(t1 if t1 is not None else None)
        return span

    def event(
        self,
        name: str,
        kind: str = "event",
        trace_id: Optional[str] = None,
        parent: Union[None, str, Span] = None,
        ts: Optional[float] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Record an instant (zero-duration) event."""
        parent_id = parent.span_id if isinstance(parent, Span) else parent
        ts = self.clock() if ts is None else float(ts)
        ev = {
            "event_id": self._make_id(),
            "trace_id": trace_id,
            "parent_id": parent_id,
            "name": name,
            "kind": kind,
            "ts": ts,
            "attrs": dict(attrs or {}),
        }
        with self._lock:
            self._events.append(ev)
            if trace_id is not None:
                self._events_by_trace.setdefault(trace_id, deque()).append(ev)
            self.events_total[kind] += 1
            if trace_id is not None and trace_id not in self._trace_order:
                # Same bound as _note_trace: an event-only trace (e.g. a
                # fault marker per submission) must not grow the trace
                # registry past the span ring — at 100k submissions this
                # was the control plane's only unbounded index.
                self._trace_order[trace_id] = ts
                while len(self._trace_order) > self.max_spans:
                    self._trace_order.popitem(last=False)
            while len(self._events) > self.max_events:
                old = self._events.popleft()
                self._drop_from_trace_index(
                    self._events_by_trace, old["trace_id"]
                )
                self.events_dropped += 1
        self._persist(dict(ev, record="event"))
        return ev

    def counter(
        self,
        name: str,
        values: Dict[str, float],
        trace_id: Optional[str] = None,
        ts: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Record a counter sample: a named set of numeric series at one
        timestamp. Stored as a ``kind="counter"`` event; the Chrome-trace
        export renders it as a Perfetto counter track (``ph="C"``), so
        goodput fraction / burn rate plot as stacked area charts next to
        the span lanes that explain them."""
        clean = {
            k: float(v)
            for k, v in values.items()
            if isinstance(v, (int, float))
        }
        return self.event(name, kind="counter", trace_id=trace_id, ts=ts, attrs=clean)

    def _note_trace(self, trace_id: str, span_id: str, t0: float) -> None:
        # caller holds the lock
        if trace_id not in self._trace_roots:
            self._trace_roots[trace_id] = span_id
            # bound the root registry alongside the span buffer
            while len(self._trace_roots) > self.max_spans:
                self._trace_roots.pop(next(iter(self._trace_roots)))
        if trace_id not in self._trace_order:
            self._trace_order[trace_id] = t0
            while len(self._trace_order) > self.max_spans:
                self._trace_order.popitem(last=False)

    def _finish_span(self, span: Span, t1: Optional[float]) -> None:
        with self._lock:
            span.t1 = self.clock() if t1 is None else float(t1)
            if span.t1 < span.t0:  # clock skew / bad virtual ts: clamp
                span.t1 = span.t0
            self._open.pop(span.span_id, None)
            self._pop_open_by_trace(span)
            closed = span.to_dict()
            self._closed.append(closed)
            self._closed_by_trace.setdefault(span.trace_id, deque()).append(
                closed
            )
            self.spans_total[span.kind] += 1
            while len(self._closed) > self.max_spans:
                # Ring eviction is FIFO and so is each per-trace deque —
                # the evicted span is always its trace's leftmost entry.
                old = self._closed.popleft()
                self._drop_from_trace_index(
                    self._closed_by_trace, old["trace_id"]
                )
                self.spans_dropped += 1
        self._persist(dict(span.to_dict(), record="span"))

    def _cancel_span(self, span: Span) -> None:
        with self._lock:
            self._open.pop(span.span_id, None)
            self._pop_open_by_trace(span)

    def _pop_open_by_trace(self, span: Span) -> None:
        # caller holds the lock
        per_trace = self._open_by_trace.get(span.trace_id)
        if per_trace is not None:
            per_trace.pop(span.span_id, None)
            if not per_trace:
                self._open_by_trace.pop(span.trace_id, None)

    @staticmethod
    def _drop_from_trace_index(
        index: Dict[str, deque], trace_id: Optional[str]
    ) -> None:
        # caller holds the lock
        if trace_id is None:
            return
        per_trace = index.get(trace_id)
        if per_trace:
            per_trace.popleft()
            if not per_trace:
                index.pop(trace_id, None)

    # -- persistence ---------------------------------------------------------

    def _persist(self, record: Dict[str, Any]) -> None:
        if not self.persist_path:
            return
        try:
            record = dict(record, schema_version=SCHEMA_VERSION)
            line = json.dumps(record, default=str) + "\n"
            with self._lock:
                if self.persist_bytes + len(line) > self.persist_max_bytes:
                    # rotate: keep exactly one previous generation bounded
                    try:
                        os.replace(self.persist_path, self.persist_path + ".1")
                    except OSError:
                        pass
                    self.persist_bytes = 0
                    self.persist_rotations += 1
                with open(self.persist_path, "a", encoding="utf-8") as f:
                    f.write(line)
                self.persist_bytes += len(line)
        except Exception:
            self.persist_errors += 1

    # -- queries -------------------------------------------------------------

    def spans(
        self,
        trace_id: Optional[str] = None,
        kind: Optional[str] = None,
        limit: int = 200,
        include_open: bool = True,
    ) -> List[Dict[str, Any]]:
        """Recorded spans, newest last, optionally filtered."""
        with self._lock:
            if trace_id is not None:
                # Trace-indexed read: O(that trace's spans), not O(ring).
                out = list(self._closed_by_trace.get(trace_id, ()))
                if include_open:
                    per_trace = self._open_by_trace.get(trace_id)
                    if per_trace is not None:
                        out.extend(s.to_dict() for s in per_trace.values())
            else:
                out = list(self._closed)
                if include_open:
                    out.extend(s.to_dict() for s in self._open.values())
        if kind is not None:
            out = [s for s in out if s["kind"] == kind]
        out.sort(key=lambda s: s["t0"])
        return out[-max(0, int(limit)):] if limit else out

    def events(
        self,
        trace_id: Optional[str] = None,
        kind: Optional[str] = None,
        limit: int = 200,
    ) -> List[Dict[str, Any]]:
        with self._lock:
            if trace_id is not None:
                out = [dict(e) for e in self._events_by_trace.get(trace_id, ())]
            else:
                out = [dict(e) for e in self._events]
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        return out[-max(0, int(limit)):] if limit else out

    def traces(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Per-trace summary (newest first): root span name, span/event
        counts, first/last timestamps."""
        with self._lock:
            order = list(self._trace_order.items())
            roots = dict(self._trace_roots)
            all_spans = list(self._closed) + [
                s.to_dict() for s in self._open.values()
            ]
            all_events = list(self._events)
        by_trace: Dict[str, Dict[str, Any]] = {}
        for tid, t0 in order:
            by_trace[tid] = {
                "trace_id": tid,
                "root_span_id": roots.get(tid),
                "root_name": None,
                "spans": 0,
                "events": 0,
                "t_first": t0,
                "t_last": t0,
            }
        for s in all_spans:
            rec = by_trace.get(s["trace_id"])
            if rec is None:
                continue
            rec["spans"] += 1
            rec["t_last"] = max(rec["t_last"], s["t1"] if s["t1"] else s["t0"])
            if s["span_id"] == rec["root_span_id"]:
                rec["root_name"] = s["name"]
        for e in all_events:
            rec = by_trace.get(e["trace_id"])
            if rec is None:
                continue
            rec["events"] += 1
            rec["t_last"] = max(rec["t_last"], e["ts"])
        out = list(by_trace.values())
        out.sort(key=lambda r: r["t_first"], reverse=True)
        return out[: max(0, int(limit))] if limit else out

    # -- anomaly attribution ---------------------------------------------------

    def attribute(self, trace_id: Optional[str], t0: float, t1: float) -> str:
        """Attribute a slow-step window ``[t0, t1]`` to the overlapping
        span/event of highest priority (see ``ATTRIBUTION_PRIORITY``).
        Returns the cause label, ``"unknown"`` when nothing overlaps."""
        spans = self.spans(trace_id=trace_id, limit=0)
        events = self.events(trace_id=trace_id, limit=0)
        now = self.clock()
        hit_kinds = set()
        for s in spans:
            s_t1 = s["t1"] if s["t1"] is not None else now
            if s["t0"] <= t1 and s_t1 >= t0:
                hit_kinds.add(s["kind"])
        for e in events:
            if t0 <= e["ts"] <= t1:
                hit_kinds.add(e["kind"])
        for kind, cause in ATTRIBUTION_PRIORITY:
            if kind in hit_kinds:
                return cause
        return "unknown"

    def record_anomaly(
        self,
        cause: str,
        trace_id: Optional[str] = None,
        ts: Optional[float] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        with self._lock:
            self.anomalies_total[cause] += 1
        a = dict(attrs or {})
        a["cause"] = cause
        return self.event(
            f"step_anomaly:{cause}", kind="anomaly", trace_id=trace_id,
            ts=ts, attrs=a,
        )

    # -- export --------------------------------------------------------------

    def export_chrome_trace(
        self, trace_id: Optional[str] = None
    ) -> Dict[str, Any]:
        """Chrome-trace / Perfetto JSON (``{"traceEvents": [...]}``).

        Each trace becomes one ``pid`` lane (named via a ``process_name``
        metadata event); span kinds become ``tid`` lanes within it. Spans
        are ``ph="X"`` complete events, instants ``ph="i"``; parent links
        ride in ``args`` and as Chrome flow events (``ph="s"``/``"f"``).
        Timestamps are microseconds, emitted sorted (monotonic)."""
        spans = self.spans(trace_id=trace_id, limit=0)
        events = self.events(trace_id=trace_id, limit=0)
        now = self.clock()
        pid_of: Dict[Any, int] = {}
        tid_of: Dict[tuple, int] = {}
        meta: List[Dict[str, Any]] = []
        root_names: Dict[Any, str] = {}
        for s in spans:
            root_names.setdefault(s["trace_id"], s["name"])

        def _pid(tid: Any) -> int:
            if tid not in pid_of:
                pid_of[tid] = len(pid_of) + 1
                label = root_names.get(tid) or str(tid)
                meta.append(
                    {
                        "name": "process_name",
                        "ph": "M",
                        "ts": 0,
                        "pid": pid_of[tid],
                        "tid": 0,
                        "args": {"name": f"trace:{tid} {label}"},
                    }
                )
            return pid_of[tid]

        def _tid(trace: Any, kind: str) -> int:
            key = (trace, kind)
            if key not in tid_of:
                n = sum(1 for k in tid_of if k[0] == trace) + 1
                tid_of[key] = n
                meta.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "ts": 0,
                        "pid": _pid(trace),
                        "tid": n,
                        "args": {"name": kind},
                    }
                )
            return tid_of[key]

        out: List[Dict[str, Any]] = []
        span_pos: Dict[str, tuple] = {}  # span_id -> (pid, tid, ts_us)
        for s in spans:
            t1 = s["t1"] if s["t1"] is not None else now
            pid = _pid(s["trace_id"])
            tid = _tid(s["trace_id"], s["kind"])
            ts_us = s["t0"] * 1e6
            args = dict(s["attrs"])
            args["span_id"] = s["span_id"]
            if s["parent_id"]:
                args["parent_id"] = s["parent_id"]
            span_pos[s["span_id"]] = (pid, tid, ts_us)
            out.append(
                {
                    "name": s["name"],
                    "cat": s["kind"],
                    "ph": "X",
                    "ts": ts_us,
                    "dur": max(0.0, (t1 - s["t0"]) * 1e6),
                    "pid": pid,
                    "tid": tid,
                    "args": args,
                }
            )
        # flow arrows for causal parent links between spans
        for s in spans:
            child = span_pos.get(s["span_id"])
            parent = span_pos.get(s["parent_id"]) if s["parent_id"] else None
            if child is None or parent is None:
                continue
            flow_id = s["span_id"]
            out.append(
                {
                    "name": "link",
                    "cat": "causal",
                    "ph": "s",
                    "id": flow_id,
                    "ts": parent[2],
                    "pid": parent[0],
                    "tid": parent[1],
                }
            )
            out.append(
                {
                    "name": "link",
                    "cat": "causal",
                    "ph": "f",
                    "bp": "e",
                    "id": flow_id,
                    "ts": max(child[2], parent[2]),
                    "pid": child[0],
                    "tid": child[1],
                }
            )
        for e in events:
            trace = e["trace_id"] if e["trace_id"] is not None else "process"
            pid = _pid(trace)
            if e["kind"] == "counter":
                # Counter samples render as Perfetto counter tracks: one
                # ph="C" event per sample, series stacked from args.
                out.append(
                    {
                        "name": e["name"],
                        "cat": e["kind"],
                        "ph": "C",
                        "ts": e["ts"] * 1e6,
                        "pid": pid,
                        "tid": 0,
                        "args": dict(e["attrs"]),
                    }
                )
                continue
            tid = _tid(trace, e["kind"])
            args = dict(e["attrs"])
            if e["parent_id"]:
                args["parent_id"] = e["parent_id"]
            out.append(
                {
                    "name": e["name"],
                    "cat": e["kind"],
                    "ph": "i",
                    "s": "t",
                    "ts": e["ts"] * 1e6,
                    "pid": pid,
                    "tid": tid,
                    "args": args,
                }
            )
        out.sort(key=lambda ev: ev["ts"])
        return {
            "traceEvents": meta + out,
            "displayTimeUnit": "ms",
            "otherData": {"exporter": "tpu_engine_torch.tracing", "trace_id": trace_id},
        }

    # -- health --------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "spans_total": sum(self.spans_total.values()),
                "spans_by_kind": dict(self.spans_total),
                "events_total": sum(self.events_total.values()),
                "events_by_kind": dict(self.events_total),
                "open_spans": len(self._open),
                "trace_index": len(self._trace_order),
                "spans_dropped": self.spans_dropped,
                "events_dropped": self.events_dropped,
                "traces_total": self.traces_total,
                "anomalies_total": sum(self.anomalies_total.values()),
                "anomalies_by_cause": dict(self.anomalies_total),
                "persist": {
                    "path": self.persist_path,
                    "bytes": self.persist_bytes,
                    "rotations": self.persist_rotations,
                    "errors": self.persist_errors,
                },
            }


# Every detector instance gets a unique historian label so concurrent
# jobs (and repeated constructions in one process) never share a
# baseline series in the process-wide historian.
_DETECTOR_SEQ = itertools.count(1)


class StepTimeAnomalyDetector:
    """Sliding per-job step-latency baseline (Poplar-style continuous
    measurement: the per-step wall time IS the health signal).

    ``observe(step, duration_s)`` returns an anomaly record when the
    duration exceeds ``max(baseline * ratio, baseline + min_excess_s)``
    against the rolling median of recent *non-anomalous* steps (outliers
    are excluded from the baseline so a regression cannot normalise
    itself away). ``sustained`` turns true after ``sustained_k``
    consecutive anomalous steps — the auto-trace trigger.

    The sample windows live in the :mod:`tpu_engine_torch.historian` (every
    observed duration in ``series``, the non-anomalous baseline window in
    ``series + "_baseline"``), so a historian range query over
    ``step_time_s`` sees exactly what the detector thresholds against."""

    def __init__(
        self,
        window: int = 64,
        warmup: int = 5,
        ratio: float = 1.75,
        min_excess_s: float = 0.025,
        sustained_k: int = 3,
        historian: Optional["historian_mod.MetricHistorian"] = None,
        series: str = "step_time_s",
        series_labels: Optional[Dict[str, Any]] = None,
    ):
        self.window = int(window)
        self.warmup = max(1, int(warmup))
        self.ratio = float(ratio)
        self.min_excess_s = float(min_excess_s)
        self.sustained_k = max(1, int(sustained_k))
        self._historian = historian
        self.series = series
        self.baseline_series = series + "_baseline"
        self.series_labels: Dict[str, str] = {
            "detector": str(next(_DETECTOR_SEQ))
        }
        if series_labels:
            self.series_labels.update(
                {str(k): str(v) for k, v in series_labels.items()}
            )
        self.consecutive = 0
        self.flagged_total = 0

    def _hist(self) -> "historian_mod.MetricHistorian":
        if self._historian is None:
            self._historian = historian_mod.get_historian()
        return self._historian

    def _baseline_window(self) -> List[float]:
        return self._hist().last_n(
            self.baseline_series, self.window, labels=self.series_labels
        )

    @property
    def baseline_s(self) -> Optional[float]:
        window = self._baseline_window()
        if len(window) < self.warmup:
            return None
        return float(median(window))

    def observe(
        self, step: int, duration_s: float, ts: Optional[float] = None
    ) -> Optional[Dict[str, Any]]:
        hist = self._hist()
        hist.record(
            self.series, float(duration_s), ts=ts, labels=self.series_labels
        )
        baseline = self.baseline_s
        anomalous = baseline is not None and duration_s > max(
            baseline * self.ratio, baseline + self.min_excess_s
        )
        if anomalous:
            self.consecutive += 1
            self.flagged_total += 1
            return {
                "step": int(step),
                "duration_s": float(duration_s),
                "baseline_s": baseline,
                "excess_s": float(duration_s) - baseline,
                "sustained": self.consecutive >= self.sustained_k,
            }
        self.consecutive = 0
        hist.record(
            self.baseline_series, float(duration_s), ts=ts,
            labels=self.series_labels,
        )
        return None

    def summary(self) -> Dict[str, Any]:
        return {
            "baseline_s": self.baseline_s,
            "observed": len(self._baseline_window()),
            "flagged_total": self.flagged_total,
            "consecutive": self.consecutive,
        }


# -- process-wide recorder -----------------------------------------------------

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    """The process-wide recorder (created lazily). ``TPU_ENGINE_TRACE_JSONL``
    in the environment enables bounded JSONL persistence at that path."""
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder(
                persist_path=os.environ.get("TPU_ENGINE_TRACE_JSONL") or None
            )
        return _recorder


def set_recorder(recorder: Optional[FlightRecorder]) -> None:
    """Swap the process-wide recorder (tests install a fresh one)."""
    global _recorder
    with _recorder_lock:
        _recorder = recorder
