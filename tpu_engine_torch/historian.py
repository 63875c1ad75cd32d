"""Fleet historian: bounded metric history + causal incident correlation.

The observability plane before this module was rich but amnesiac — the
flight recorder (``tracing.py``), the goodput ledger (``goodput.py``) and
~120 Prometheus families all answer "what is the fleet doing *now*",
while the SLO burn-rate alerter and the step-time anomaly detector each
kept their own private sample windows. This module is the shared memory
those consumers (and the fleet autopilot) read instead:

- :class:`MetricHistorian` — an embedded multi-resolution time-series
  store. Raw samples land in a bounded per-series ring; every sample is
  simultaneously folded into 10s and 1m downsampled rollup buckets
  (count/sum/min/max/first/last — the tiers *conserve* the raw ring's
  sum/min/max by construction) under configurable retention. A small
  query engine answers range queries (``avg``/``min``/``max``/``last``/
  ``sum``/``count``/``rate``/``p99``) against whichever tier still
  covers the window. Every write takes an explicit timestamp, so
  virtual-clock sims and the digital twin record exactly like live
  processes — and replaying a recorded trace rebuilds the same store.

- :class:`IncidentCorrelator` — stitches recorder activity that overlaps
  in time into causally-linked incidents: ``FaultEvent`` mirrors and
  ``detect`` spans open an incident; scheduler/admission actions
  (preempt, requeue, shrink-admit, grow-back, rebalance) attach through
  the recorder's parent links (or, for unlinked live events, through
  trace/time adjacency); ``resume``/``grow_back``/alert-resolve records
  resolve it. Each incident carries a timeline (detect → action →
  resolution), the implicated device/trace, and — via the historian —
  metric-series snippets around its window.

Both are pure stdlib with no imports from the rest of ``tpu_engine``, so
every other layer (tracing, goodput, faults, scheduler, supervisor,
twin, routers) can depend on them without cycles.

The port's copy of ``tpu_engine/historian.py`` (the JAX package's module uses
no JAX, and the port imports nothing of that package): the same code,
with the port's imports and its own exporter name; Prometheus families
keep JAX's names, so one dashboard reads both.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "MetricHistorian",
    "IncidentCorrelator",
    "Incident",
    "percentile",
    "get_historian",
    "set_historian",
    "get_correlator",
    "set_correlator",
]

#: (bucket width seconds, max retained buckets) — 10s tier holds 2 h,
#: 1m tier holds 24 h by default.
DEFAULT_TIERS: Tuple[Tuple[float, int], ...] = ((10.0, 720), (60.0, 1440))

AGGS = ("avg", "min", "max", "last", "sum", "count", "rate", "p99")

# Bucket list layout (kept as a plain list for memory, not a dataclass):
# [count, sum, min, max, first_ts, first, last_ts, last]
_B_COUNT, _B_SUM, _B_MIN, _B_MAX, _B_FTS, _B_FIRST, _B_LTS, _B_LAST = range(8)


def percentile(values: List[float], q: float) -> float:
    """Linear-interpolated percentile (same convention as ``twin.percentile``)."""
    vs = sorted(values)
    if not vs:
        return 0.0
    idx = (len(vs) - 1) * q
    lo = int(idx)
    hi = min(lo + 1, len(vs) - 1)
    return vs[lo] + (vs[hi] - vs[lo]) * (idx - lo)


def _series_key(name: str, labels: Optional[Dict[str, Any]]) -> tuple:
    if not labels:
        return (name, ())
    return (name, tuple(sorted((str(k), str(v)) for k, v in labels.items())))


class _Series:
    __slots__ = ("name", "labels", "raw", "tiers", "last_ts")

    def __init__(
        self,
        name: str,
        labels: Dict[str, str],
        raw_capacity: int,
        tiers: Tuple[Tuple[float, int], ...],
    ):
        self.name = name
        self.labels = labels
        self.raw: deque = deque(maxlen=raw_capacity)  # (ts, value)
        # width_s -> OrderedDict[bucket_idx -> bucket list]
        self.tiers: Dict[float, OrderedDict] = {w: OrderedDict() for w, _ in tiers}
        self.last_ts: Optional[float] = None


class MetricHistorian:
    """Embedded, bounded, multi-resolution time-series store.

    Memory is bounded three ways: the raw ring per series
    (``raw_capacity`` samples), the rollup tiers per series
    (``tiers[i][1]`` buckets each), and the series registry itself
    (``max_series``, least-recently-written evicted). Writes take an
    explicit ``ts`` so virtual-clock callers never touch the wall clock;
    ``clock`` is only consulted when ``ts`` is omitted.
    """

    def __init__(
        self,
        raw_capacity: int = 4096,
        tiers: Tuple[Tuple[float, int], ...] = DEFAULT_TIERS,
        max_series: int = 512,
        clock: Optional[Callable[[], float]] = None,
    ):
        self._lock = threading.RLock()
        self.raw_capacity = int(raw_capacity)
        self.tiers = tuple((float(w), int(n)) for w, n in tiers)
        self.max_series = int(max_series)
        self.clock = clock or time.time
        self._series: "OrderedDict[tuple, _Series]" = OrderedDict()
        self._collectors: List[Callable[[float], Any]] = []
        self.samples_total = 0
        self.ticks_total = 0
        self.series_evicted_total = 0
        self.bucket_evictions_total = 0
        self.collector_errors_total = 0
        # Batched-ingest efficiency counters: how many lock acquisitions
        # the batch path saved is (batched_samples - batches).
        self.ingest_batch_total = 0
        self.ingest_batched_samples_total = 0

    # -- writes --------------------------------------------------------------

    def _record_locked(
        self,
        name: str,
        value: float,
        ts: float,
        labels: Optional[Dict[str, Any]],
    ) -> None:
        """Fold one (validated, floated) sample into the raw ring and every
        rollup tier. Caller holds ``self._lock``."""
        key = _series_key(name, labels)
        s = self._series.get(key)
        if s is None:
            s = _Series(
                name,
                {str(k): str(v) for k, v in (labels or {}).items()},
                self.raw_capacity,
                self.tiers,
            )
            self._series[key] = s
            while len(self._series) > self.max_series:
                self._series.popitem(last=False)
                self.series_evicted_total += 1
        else:
            self._series.move_to_end(key)
        s.raw.append((ts, value))
        s.last_ts = ts if s.last_ts is None else max(s.last_ts, ts)
        for (width, max_buckets) in self.tiers:
            od = s.tiers[width]
            idx = int(ts // width)
            b = od.get(idx)
            if b is None:
                od[idx] = [1, value, value, value, ts, value, ts, value]
                while len(od) > max_buckets:
                    od.popitem(last=False)
                    self.bucket_evictions_total += 1
            else:
                b[_B_COUNT] += 1
                b[_B_SUM] += value
                if value < b[_B_MIN]:
                    b[_B_MIN] = value
                if value > b[_B_MAX]:
                    b[_B_MAX] = value
                if ts < b[_B_FTS]:
                    b[_B_FTS], b[_B_FIRST] = ts, value
                if ts >= b[_B_LTS]:
                    b[_B_LTS], b[_B_LAST] = ts, value
        self.samples_total += 1

    def record(
        self,
        name: str,
        value: float,
        ts: Optional[float] = None,
        labels: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Append one sample; folds into the raw ring and every rollup tier."""
        if value is None or not isinstance(value, (int, float)):
            return
        ts = self.clock() if ts is None else float(ts)
        with self._lock:
            self._record_locked(name, float(value), ts, labels)

    def observe_batch(
        self,
        samples: Any,
        ts: Optional[float] = None,
        labels: Optional[Dict[str, Any]] = None,
    ) -> int:
        """Batched ingest: one lock acquisition for the whole batch, then
        the same raw+rollup fold per sample as :meth:`record`.

        ``samples`` is a mapping ``name → value`` or an iterable of
        ``(name, value)`` / ``(name, value, labels)`` tuples (the tuple
        form carries per-sample labels; the ``labels`` argument is the
        default). Non-numeric values are skipped exactly as
        :meth:`record` skips them. Returns the number of samples
        retained. This is the hot-path entry: at control-plane scale the
        per-sample lock round-trip in ``record`` dominated ingest cost,
        so :meth:`record_many` and :meth:`tick` both route through here.
        """
        ts = self.clock() if ts is None else float(ts)
        if isinstance(samples, dict):
            items: List[Tuple[str, Any, Optional[Dict[str, Any]]]] = [
                (name, value, labels) for name, value in samples.items()
            ]
        else:
            items = [
                (it[0], it[1], it[2] if len(it) > 2 else labels)
                for it in samples
            ]
        n = 0
        with self._lock:
            for name, value, lab in items:
                if value is None or not isinstance(value, (int, float)):
                    continue
                self._record_locked(name, float(value), ts, lab)
                n += 1
            self.ingest_batch_total += 1
            self.ingest_batched_samples_total += n
        return n

    def record_many(
        self,
        samples: Dict[str, float],
        ts: Optional[float] = None,
        labels: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.observe_batch(samples, ts=ts, labels=labels)

    # -- scrape tick ---------------------------------------------------------

    def add_collector(self, fn: Callable[[float], Any]) -> None:
        """Register ``fn(now) -> {name: value} | [(name, value, labels)]``;
        every :meth:`tick` runs it and retains what it returns."""
        with self._lock:
            self._collectors.append(fn)

    def tick(self, now: Optional[float] = None) -> int:
        """One scrape tick: run every registered collector at an explicit
        timestamp. Returns the number of samples retained; collector
        failures are counted, never raised (a broken collector must not
        break the scrape path that drives the tick)."""
        now = self.clock() if now is None else float(now)
        recorded = 0
        with self._lock:
            collectors = list(self._collectors)
        # Collectors run outside the lock (they may be arbitrarily slow);
        # their combined output lands through ONE batched fold.
        batch: List[Tuple[str, Any, Optional[Dict[str, Any]]]] = []
        for fn in collectors:
            try:
                out = fn(now)
            except Exception:
                self.collector_errors_total += 1
                continue
            if not out:
                continue
            if isinstance(out, dict):
                for name, value in out.items():
                    batch.append((name, value, None))
                    recorded += 1
            else:
                for name, value, labels in out:
                    batch.append((name, value, labels))
                    recorded += 1
        if batch:
            self.observe_batch(batch, ts=now)
        with self._lock:
            self.ticks_total += 1
        return recorded

    # -- queries -------------------------------------------------------------

    def _get(self, name: str, labels: Optional[Dict[str, Any]]) -> Optional[_Series]:
        return self._series.get(_series_key(name, labels))

    def raw_len(self, name: str, labels: Optional[Dict[str, Any]] = None) -> int:
        with self._lock:
            s = self._get(name, labels)
            return len(s.raw) if s is not None else 0

    def last_n(
        self, name: str, n: int, labels: Optional[Dict[str, Any]] = None
    ) -> List[float]:
        """Values of the most recent ``n`` raw samples (count-based window)."""
        with self._lock:
            s = self._get(name, labels)
            if s is None:
                return []
            n = max(0, int(n))
            return [v for _, v in list(s.raw)[-n:]] if n else []

    def _pick_tier(self, s: _Series, t0: float) -> Optional[float]:
        """Finest rollup tier whose retained buckets still cover ``t0``."""
        for (width, _) in self.tiers:
            od = s.tiers[width]
            if od and next(iter(od)) * width <= t0:
                return width
        return self.tiers[-1][0] if self.tiers else None

    def query(
        self,
        name: str,
        t0: Optional[float] = None,
        t1: Optional[float] = None,
        agg: str = "avg",
        labels: Optional[Dict[str, Any]] = None,
        tier: str = "auto",
        max_points: int = 512,
    ) -> Dict[str, Any]:
        """Range query. ``tier`` is ``raw``/``10s``/``1m``/``auto``; auto
        serves from raw when the ring still covers the window start and
        falls back to the finest rollup tier that does. ``p99`` and
        ``rate`` always derive from the raw points inside the window
        (percentiles don't survive downsampling); when raw no longer
        covers the window, ``p99`` degrades to the bucket max (an upper
        bound) and the result is marked ``approx``."""
        if agg not in AGGS:
            raise ValueError(f"unknown agg {agg!r}; one of {AGGS}")
        with self._lock:
            s = self._get(name, labels)
            empty = {
                "name": name, "labels": dict(labels or {}), "agg": agg,
                "tier": tier, "t0": t0, "t1": t1, "value": None, "count": 0,
                "aggregates": {}, "points": [], "approx": False,
            }
            if s is None or (not s.raw and not any(s.tiers[w] for w, _ in self.tiers)):
                return empty
            if t1 is None:
                t1 = s.last_ts if s.last_ts is not None else self.clock()
            if t0 is None:
                t0 = t1 - 600.0
            t0, t1 = float(t0), float(t1)
            raw_pts = [(ts, v) for ts, v in s.raw if t0 <= ts <= t1]
            raw_covers = bool(s.raw) and (
                len(s.raw) < s.raw.maxlen or s.raw[0][0] <= t0
            )
            chosen = tier
            if tier == "auto":
                chosen = "raw" if raw_covers else None
            if chosen == "raw":
                count = len(raw_pts)
                total = sum(v for _, v in raw_pts)
                aggs: Dict[str, Any] = {
                    "count": count,
                    "sum": total,
                    "avg": (total / count) if count else None,
                    "min": min((v for _, v in raw_pts), default=None),
                    "max": max((v for _, v in raw_pts), default=None),
                    "last": raw_pts[-1][1] if raw_pts else None,
                }
                points = raw_pts
                approx = False
            else:
                if chosen in (None, "auto"):
                    width = self._pick_tier(s, t0)
                else:
                    width = {"10s": 10.0, "1m": 60.0}.get(chosen)
                    if width is None:
                        try:
                            width = float(chosen)
                        except (TypeError, ValueError):
                            raise ValueError(f"unknown tier {tier!r}")
                if width is None:
                    return empty
                chosen = {10.0: "10s", 60.0: "1m"}.get(width, str(width))
                bs = [
                    b for idx, b in s.tiers[width].items()
                    if idx * width < t1 and (idx + 1) * width > t0
                ]
                count = sum(b[_B_COUNT] for b in bs)
                total = sum(b[_B_SUM] for b in bs)
                aggs = {
                    "count": count,
                    "sum": total,
                    "avg": (total / count) if count else None,
                    "min": min((b[_B_MIN] for b in bs), default=None),
                    "max": max((b[_B_MAX] for b in bs), default=None),
                    "last": bs[-1][_B_LAST] if bs else None,
                }
                points = [
                    (b[_B_LTS], b[_B_SUM] / b[_B_COUNT]) for b in bs
                ]
                approx = True
            if agg == "rate":
                src = raw_pts if raw_pts else points
                if len(src) >= 2 and src[-1][0] > src[0][0]:
                    value: Any = (src[-1][1] - src[0][1]) / (src[-1][0] - src[0][0])
                else:
                    value = None
            elif agg == "p99":
                if raw_pts:
                    value = percentile([v for _, v in raw_pts], 0.99)
                else:
                    value, approx = aggs["max"], True
            else:
                value = aggs[agg]
            return {
                "name": name,
                "labels": dict(s.labels),
                "agg": agg,
                "tier": chosen,
                "t0": t0,
                "t1": t1,
                "value": value,
                "count": aggs["count"],
                "aggregates": aggs,
                "points": [[ts, v] for ts, v in points[-max(0, int(max_points)):]],
                "approx": approx,
            }

    def buckets(
        self, name: str, width_s: float, labels: Optional[Dict[str, Any]] = None
    ) -> List[Dict[str, float]]:
        """The retained rollup buckets of one tier (for invariant checks)."""
        with self._lock:
            s = self._get(name, labels)
            if s is None:
                return []
            od = s.tiers.get(float(width_s))
            if od is None:
                return []
            return [
                {
                    "t0": idx * float(width_s),
                    "width_s": float(width_s),
                    "count": b[_B_COUNT],
                    "sum": b[_B_SUM],
                    "min": b[_B_MIN],
                    "max": b[_B_MAX],
                    "first": b[_B_FIRST],
                    "last": b[_B_LAST],
                }
                for idx, b in od.items()
            ]

    def series_list(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                {
                    "name": s.name,
                    "labels": dict(s.labels),
                    "raw_samples": len(s.raw),
                    "last_ts": s.last_ts,
                }
                for s in self._series.values()
            ]

    # -- ingestion from recorder / JSONL --------------------------------------

    def ingest_counter_events(self, events: Iterable[Dict[str, Any]]) -> int:
        """Fold recorder ``kind="counter"`` events into series: each numeric
        attr of a counter named ``N`` becomes a sample of series ``N.attr``
        at the event's timestamp. Replaying a recorded JSONL through this
        rebuilds the live run's series exactly (same explicit timestamps)."""
        n = 0
        for ev in events:
            if ev.get("kind") != "counter":
                continue
            ts = ev.get("ts")
            name = ev.get("name")
            if ts is None or not name:
                continue
            for k, v in (ev.get("attrs") or {}).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    self.record(f"{name}.{k}", float(v), ts=float(ts))
                    n += 1
        return n

    def ingest_jsonl_records(self, records: Iterable[Dict[str, Any]]) -> int:
        """Same, over raw flight-recorder JSONL records (``record="event"``)."""
        return self.ingest_counter_events(
            r for r in records if r.get("record") == "event"
        )

    # -- export ---------------------------------------------------------------

    def export_chrome_counters(
        self,
        names: Optional[List[str]] = None,
        t0: Optional[float] = None,
        t1: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Any queried series as Perfetto counter tracks (``ph="C"``), the
        same rendering ``FlightRecorder.export_chrome_trace`` gives its
        own counter events — so a historian range query drops straight
        into the Perfetto UI next to the span lanes that explain it."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            series = list(self._series.values())
        for s in series:
            if names is not None and s.name not in names:
                continue
            label = s.name
            if s.labels:
                label += "{" + ",".join(
                    f"{k}={v}" for k, v in sorted(s.labels.items())
                ) + "}"
            for ts, v in list(s.raw):
                if t0 is not None and ts < t0:
                    continue
                if t1 is not None and ts > t1:
                    continue
                out.append(
                    {
                        "name": label,
                        "cat": "counter",
                        "ph": "C",
                        "ts": ts * 1e6,
                        "pid": 0,
                        "tid": 0,
                        "args": {"value": v},
                    }
                )
        out.sort(key=lambda ev: ev["ts"])
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"exporter": "tpu_engine_torch.historian"},
        }

    # -- health ----------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            raw = sum(len(s.raw) for s in self._series.values())
            buckets = {
                {10.0: "10s", 60.0: "1m"}.get(w, str(w)): sum(
                    len(s.tiers[w]) for s in self._series.values()
                )
                for w, _ in self.tiers
            }
            # Rough but monotone-with-reality: a raw sample is a 2-tuple of
            # floats, a bucket an 8-slot list, a series the fixed overhead.
            est = raw * 72 + sum(buckets.values()) * 144 + len(self._series) * 512
            return {
                "series": len(self._series),
                "samples_total": self.samples_total,
                "raw_samples": raw,
                "rollup_buckets": buckets,
                "ticks_total": self.ticks_total,
                "series_evicted_total": self.series_evicted_total,
                "bucket_evictions_total": self.bucket_evictions_total,
                "collector_errors_total": self.collector_errors_total,
                "ingest_batch_total": self.ingest_batch_total,
                "ingest_batched_samples_total": self.ingest_batched_samples_total,
                "estimated_bytes": est,
                "raw_capacity": self.raw_capacity,
                "max_series": self.max_series,
            }


# ---------------------------------------------------------------------------
# Incident correlation
# ---------------------------------------------------------------------------

#: Trigger kinds: records in these kinds open an incident when nothing
#: existing claims them.
_TRIGGER_KINDS = ("fault", "anomaly", "slo_alert")
#: Action kinds: attach to an incident (via parent link or adjacency) and
#: move it to ``mitigating``. ``autopilot`` spans are the control loop's
#: DecisionRecord mirrors (``tpu_engine/autopilot.py``).
_ACTION_KINDS = (
    "scheduler", "admission", "emergency_save", "compile", "hetero",
    "autopilot",
)
#: Records that resolve an incident.
_RESOLUTION_NAMES = ("resume", "grow_back", "hetero_quarantine_release")


def _classify(kind: str, name: str, attrs: Dict[str, Any]) -> Optional[str]:
    """Map one recorder record to a timeline role (None = not of interest)."""
    if kind == "slo_alert":
        return "resolution" if attrs.get("transition") == "resolve" else "detect"
    if kind in ("fault", "anomaly"):
        return "detect"
    if kind == "supervisor" and "resume" in name:
        return "resolution"
    if name in _RESOLUTION_NAMES:
        return "resolution"
    if kind in _ACTION_KINDS:
        return "action"
    return None


class Incident:
    """One causally-linked incident: trigger, timeline, resolution state."""

    __slots__ = (
        "incident_id", "trigger", "t0", "t1", "state", "trace_id",
        "device_index", "submission_id", "slo", "timeline",
    )

    def __init__(self, incident_id: str, trigger: str, rec: Dict[str, Any]):
        self.incident_id = incident_id
        self.trigger = trigger
        self.t0 = rec["ts"]
        self.t1 = rec["ts"]
        self.state = "open"
        self.trace_id = rec.get("trace_id")
        attrs = rec.get("attrs") or {}
        self.device_index = attrs.get("device") if attrs.get(
            "device"
        ) is not None else attrs.get("device_index")
        self.submission_id = attrs.get("submission_id")
        self.slo = attrs.get("slo")
        self.timeline: List[Dict[str, Any]] = []

    def add(self, role: str, rec: Dict[str, Any]) -> None:
        attrs = rec.get("attrs") or {}
        entry = {
            "ts": rec["ts"],
            "role": role,
            "kind": rec["kind"],
            "name": rec["name"],
            "attrs": dict(attrs),
        }
        if role == "action":
            # Who acted: autopilot decision mirrors carry their own
            # source (``autopilot`` | ``autopilot-dryrun``); every other
            # action leg is human-operated machinery.
            entry["action_source"] = attrs.get("action_source") or "human"
        self.timeline.append(entry)
        self.t1 = max(self.t1, rec.get("t_end") or rec["ts"])
        if self.device_index is None:
            d = attrs.get("device", attrs.get("device_index"))
            if d is not None:
                self.device_index = d
        if self.submission_id is None and attrs.get("submission_id") is not None:
            self.submission_id = attrs.get("submission_id")

    def roles(self) -> List[str]:
        return [e["role"] for e in self.timeline]

    def to_dict(
        self,
        historian: Optional[MetricHistorian] = None,
        snippet_series: Optional[List[str]] = None,
        snippet_pad_s: float = 60.0,
        max_points: int = 50,
    ) -> Dict[str, Any]:
        out = {
            "incident_id": self.incident_id,
            "trigger": self.trigger,
            "state": self.state,
            "t0": self.t0,
            "t1": self.t1,
            "duration_s": round(self.t1 - self.t0, 6),
            "trace_id": self.trace_id,
            "device_index": self.device_index,
            "submission_id": self.submission_id,
            "slo": self.slo,
            "timeline": list(self.timeline),
        }
        if historian is not None:
            names = snippet_series or [
                info["name"] for info in historian.series_list()
            ][:4]
            snippets = {}
            for name in names:
                q = historian.query(
                    name,
                    t0=self.t0 - snippet_pad_s,
                    t1=self.t1 + snippet_pad_s,
                    agg="avg",
                    max_points=max_points,
                )
                if q["count"]:
                    snippets[name] = {
                        "aggregates": q["aggregates"], "points": q["points"],
                    }
            out["metric_snippets"] = snippets
        return out


class IncidentCorrelator:
    """Stitches recorder spans/events into bounded incident objects.

    Attachment precedence per record: (1) walk the span parent chain —
    the recorder's causal links are ground truth; (2) for detect-class
    records, merge into a same-device incident within ``merge_window_s``
    (dedups the live double-record: a ``detect`` span plus the
    ``FaultEvent`` mirror at the same instant) or a same-SLO open alert
    incident; (3) for action/resolution records with no parent link
    (live scheduler events are not parented to faults), attach to the
    most recent open incident on the same trace — or any open incident —
    within ``attach_gap_s``. Anything unclaimed and non-triggering is
    ignored, counted.
    """

    def __init__(
        self,
        max_incidents: int = 256,
        merge_window_s: float = 0.25,
        attach_gap_s: float = 120.0,
        stale_after_s: float = 900.0,
        clock: Optional[Callable[[], float]] = None,
    ):
        self._lock = threading.RLock()
        self.max_incidents = int(max_incidents)
        self.merge_window_s = float(merge_window_s)
        self.attach_gap_s = float(attach_gap_s)
        self.stale_after_s = float(stale_after_s)
        self.clock = clock or time.time
        self._seen: set = set()
        self._seen_order: deque = deque(maxlen=65536)
        self._record_to_incident: Dict[str, Incident] = {}
        self._parents: Dict[str, Optional[str]] = {}
        self._open: List[Incident] = []
        self._closed: deque = deque(maxlen=self.max_incidents)
        self._seq = 0
        self.opened_by_trigger: Dict[str, int] = {}
        self.resolved_total = 0
        self.correlated_total = 0
        self.ignored_total = 0

    # -- normalization --------------------------------------------------------

    @staticmethod
    def _normalize(
        spans: Iterable[Dict[str, Any]], events: Iterable[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for s in spans:
            out.append(
                {
                    "id": s["span_id"],
                    "ts": s["t0"],
                    "t_end": s.get("t1"),
                    "kind": s["kind"],
                    "name": s["name"],
                    "parent_id": s.get("parent_id"),
                    "trace_id": s.get("trace_id"),
                    "attrs": s.get("attrs") or {},
                }
            )
        for e in events:
            if e.get("kind") == "counter":
                continue
            out.append(
                {
                    "id": e["event_id"],
                    "ts": e["ts"],
                    "t_end": e["ts"],
                    "kind": e["kind"],
                    "name": e["name"],
                    "parent_id": e.get("parent_id"),
                    "trace_id": e.get("trace_id"),
                    "attrs": e.get("attrs") or {},
                }
            )
        # Stable by timestamp: chains recorded at one instant keep their
        # recording order (spans arrive t0-sorted from the recorder).
        out.sort(key=lambda r: r["ts"])
        return out

    @staticmethod
    def normalize_jsonl(records: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Split raw flight-recorder JSONL records into (spans, events) and
        normalize — the twin replay path."""
        spans = [r for r in records if r.get("record") == "span"]
        events = [r for r in records if r.get("record") == "event"]
        return IncidentCorrelator._normalize(spans, events)

    # -- ingestion ------------------------------------------------------------

    def ingest(
        self,
        recorder: Any = None,
        records: Optional[List[Dict[str, Any]]] = None,
        now: Optional[float] = None,
    ) -> int:
        """Pull new activity and stitch it. ``recorder`` is any object with
        the FlightRecorder query surface; ``records`` is raw JSONL
        records (twin replay). Idempotent: records are deduped by id."""
        if recorder is not None:
            normalized = self._normalize(
                recorder.spans(limit=0, include_open=False),
                recorder.events(limit=0),
            )
        elif records is not None:
            normalized = self.normalize_jsonl(records)
        else:
            normalized = []
        n = 0
        with self._lock:
            for rec in normalized:
                rid = rec["id"]
                if rid in self._seen:
                    continue
                self._note_seen(rid)
                self._parents[rid] = rec.get("parent_id")
                if len(self._parents) > 65536:
                    self._parents.pop(next(iter(self._parents)))
                if self._process(rec):
                    n += 1
            self._expire(self.clock() if now is None else float(now))
        return n

    def _note_seen(self, rid: str) -> None:
        if len(self._seen_order) == self._seen_order.maxlen:
            self._seen.discard(self._seen_order[0])
        self._seen_order.append(rid)
        self._seen.add(rid)

    def _process(self, rec: Dict[str, Any]) -> bool:
        role = _classify(rec["kind"], rec["name"], rec["attrs"])
        if role is None:
            return False
        inc = self._find_by_parent(rec)
        if inc is None and role == "detect":
            inc = self._find_mergeable(rec)
            if inc is None:
                inc = self._open_incident(rec)
        if inc is None and role in ("action", "resolution"):
            inc = self._find_adjacent(rec)
        if inc is None:
            self.ignored_total += 1
            return False
        inc.add(role, rec)
        self._record_to_incident[rec["id"]] = inc
        if len(self._record_to_incident) > 65536:
            self._record_to_incident.pop(next(iter(self._record_to_incident)))
        self.correlated_total += 1
        if role == "action" and inc.state == "open":
            inc.state = "mitigating"
        elif role == "resolution" and inc.state != "resolved":
            inc.state = "resolved"
            self.resolved_total += 1
            if inc in self._open:
                self._open.remove(inc)
                self._closed.append(inc)
        return True

    def _find_by_parent(self, rec: Dict[str, Any]) -> Optional[Incident]:
        p, hops = rec.get("parent_id"), 0
        while p and hops < 64:
            inc = self._record_to_incident.get(p)
            if inc is not None:
                return inc
            p = self._parents.get(p)
            hops += 1
        return None

    def _find_mergeable(self, rec: Dict[str, Any]) -> Optional[Incident]:
        attrs = rec["attrs"]
        if rec["kind"] == "slo_alert":
            slo = attrs.get("slo")
            for inc in reversed(self._open):
                if inc.trigger == "slo_alert" and inc.slo == slo:
                    return inc
            return None
        device = attrs.get("device", attrs.get("device_index"))
        for inc in self._all_recent():
            if (
                device is not None
                and inc.device_index == device
                and abs(rec["ts"] - inc.t1) <= self.merge_window_s
            ):
                return inc
        return None

    def _find_adjacent(self, rec: Dict[str, Any]) -> Optional[Incident]:
        tid = rec.get("trace_id")
        best = None
        for inc in reversed(self._open):
            if rec["ts"] - inc.t1 > self.attach_gap_s or rec["ts"] < inc.t0:
                continue
            if tid is not None and inc.trace_id == tid:
                return inc
            if best is None:
                best = inc
        return best

    def _all_recent(self) -> List[Incident]:
        return list(self._open) + list(self._closed)[-8:]

    def _open_incident(self, rec: Dict[str, Any]) -> Incident:
        self._seq += 1
        trigger = rec["kind"]
        inc = Incident(f"inc-{self._seq}", trigger, rec)
        self._open.append(inc)
        self.opened_by_trigger[trigger] = self.opened_by_trigger.get(trigger, 0) + 1
        return inc

    def _expire(self, now: float) -> None:
        for inc in list(self._open):
            if now - inc.t1 > self.stale_after_s:
                inc.state = "unresolved"
                self._open.remove(inc)
                self._closed.append(inc)

    # -- queries --------------------------------------------------------------

    def incidents(
        self,
        state: Optional[str] = None,
        limit: int = 50,
        historian: Optional[MetricHistorian] = None,
        snippet_series: Optional[List[str]] = None,
    ) -> List[Dict[str, Any]]:
        """Incidents newest-first, optionally filtered and with historian
        metric snippets around each window."""
        with self._lock:
            all_inc = list(self._closed) + list(self._open)
        all_inc.sort(key=lambda i: i.t0)
        if state is not None:
            all_inc = [i for i in all_inc if i.state == state]
        if limit:
            all_inc = all_inc[-max(0, int(limit)):]
        return [
            i.to_dict(historian=historian, snippet_series=snippet_series)
            for i in reversed(all_inc)
        ]

    def open_refs(self, limit: int = 8) -> List[Dict[str, Any]]:
        """Lightweight refs to open incidents, newest-first — the
        autopilot copies these ids into every DecisionRecord's inputs
        without paying for full timelines."""
        with self._lock:
            out = [
                {
                    "incident_id": inc.incident_id,
                    "trigger": inc.trigger,
                    "state": inc.state,
                    "t0": inc.t0,
                    "trace_id": inc.trace_id,
                    "device_index": inc.device_index,
                    "slo": inc.slo,
                }
                for inc in reversed(self._open)
            ]
        return out[: max(0, int(limit))] if limit else out

    def get(
        self, incident_id: str, historian: Optional[MetricHistorian] = None
    ) -> Optional[Dict[str, Any]]:
        with self._lock:
            for inc in list(self._open) + list(self._closed):
                if inc.incident_id == incident_id:
                    return inc.to_dict(historian=historian)
        return None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "open": len(self._open),
                "opened_total": sum(self.opened_by_trigger.values()),
                "opened_by_trigger": dict(self.opened_by_trigger),
                "resolved_total": self.resolved_total,
                "correlated_total": self.correlated_total,
                "ignored_total": self.ignored_total,
            }


# ---------------------------------------------------------------------------
# Process-wide singletons (same pattern as goodput.get_ledger)
# ---------------------------------------------------------------------------

_historian: Optional[MetricHistorian] = None
_correlator: Optional[IncidentCorrelator] = None
_singleton_lock = threading.RLock()


def get_historian() -> MetricHistorian:
    global _historian
    with _singleton_lock:
        if _historian is None:
            _historian = MetricHistorian()
        return _historian


def set_historian(historian: Optional[MetricHistorian]) -> None:
    """Swap the process-wide historian (tests/sims install a fresh one)."""
    global _historian
    with _singleton_lock:
        _historian = historian


def get_correlator() -> IncidentCorrelator:
    global _correlator
    with _singleton_lock:
        if _correlator is None:
            _correlator = IncidentCorrelator()
        return _correlator


def set_correlator(correlator: Optional[IncidentCorrelator]) -> None:
    global _correlator
    with _singleton_lock:
        _correlator = correlator
