"""Fleet goodput ledger: wall-clock decomposition + SLO burn-rate alerting
(port of ``tpu_engine/goodput.py``; it uses no JAX, so the logic is JAX's,
over this package's ``tracing`` and ``historian``).

The scheduler's only fleet-efficiency signal so far is the per-tenant
``goodput_busy_s`` proxy (admission→reap seconds) — it cannot answer
"what fraction of paid chip-seconds trained the model, and where did the
rest go?". The flight recorder already produces the causally-linked
spans that answer that exactly; this module turns them into an account:

- :func:`decompose_trace` sweeps one submission's spans/events into
  **disjoint categories** — productive step time, queue wait, compile,
  checkpoint save, restore, preempt-drain, shrink-degraded capacity
  (healthy-mesh-equivalent deficit), host-slow penalty, idle/unknown —
  with the invariant that the categories sum to the wall window exactly
  (a boundary sweep assigns every elementary segment to exactly one
  category, so the invariant holds by construction, not by tolerance).
- :class:`GoodputLedger` maintains fleet / per-tenant / per-workload
  rollups **incrementally** (bounded memory: a per-trace cursor lets the
  same trace be accounted repeatedly without double counting) plus
  time-bucketed history rings the burn-rate windows read. Every API
  takes explicit timestamps, so virtual-clock simulations
  (``benchmarks/chaos.py``) account identically to live runs.
- :class:`SLOBurnRateAlerter` evaluates multi-window burn rates over a
  configurable goodput-fraction SLO (and the serving p99 SLO already
  tracked by ``ServingFleet``) and fires structured alert events onto
  the flight recorder's ``fleet`` timeline on every ok → warning → page
  (or resolve) transition.

Burn-rate semantics (Google SRE style): with an SLO target ``g`` the
error budget is ``1 - g``; a window's burn rate is
``(1 - measured_goodput_fraction) / (1 - g)`` — 1.0 means the budget is
consumed exactly at the sustainable rate, N means N× too fast. An alert
escalates only when BOTH the short and the long window burn above the
threshold (the short window makes it fast, the long window keeps a
brief blip from paging).

The span kinds it reads (``_SPAN_KIND_CATEGORY``) are the ones this
package's supervisor, checkpoint manager and scheduler record.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpu_engine_torch import historian as historian_mod
from tpu_engine_torch.tracing import FlightRecorder

__all__ = [
    "CATEGORIES",
    "decompose_trace",
    "GoodputLedger",
    "SLOBurnRateAlerter",
    "get_ledger",
    "set_ledger",
    "get_alerter",
    "set_alerter",
    "FLEET_TRACE_ID",
]

# Disjoint wall-clock categories, and the fixed overlay priority used to
# resolve overlaps (highest wins — mirrors tracing.ATTRIBUTION_PRIORITY:
# a host-slow stall explains a window better than the checkpoint save
# that also overlapped it). "productive"/"shrink_degraded" are the
# running baseline under the overlays; "idle_unknown" is the residual.
CATEGORIES: Tuple[str, ...] = (
    "productive",
    "queue_wait",
    "compile",
    "checkpoint_save",
    "restore",
    "preempt_drain",
    "shrink_degraded",
    "host_slow",
    "idle_unknown",
)

_OVERLAY_PRIORITY: Tuple[str, ...] = (
    "host_slow",
    "preempt_drain",
    "checkpoint_save",
    "restore",
    "compile",
    "queue_wait",
)

# Span kind -> overlay category. "admission" covers both the live
# admission pass (sub-second) and the chaos sim's shrink_admit /
# grow_back requeue+re-admit overheads — all of it is time the job
# waited on the scheduler, i.e. queue wait.
_SPAN_KIND_CATEGORY: Dict[str, str] = {
    "fault": "host_slow",
    "emergency_save": "preempt_drain",
    "checkpoint_save": "checkpoint_save",
    "final_save": "checkpoint_save",
    "checkpoint_restore": "restore",
    "compile": "compile",
    "admission": "queue_wait",
}

# The flight-recorder timeline SLO alerts land on: not a per-job trace,
# the fleet-wide one (event-only traces render as their own Perfetto
# lane, so alerts are visible next to the job timelines they explain).
FLEET_TRACE_ID = "fleet"


def _clip(a: float, b: float, w0: float, w1: float) -> Optional[Tuple[float, float]]:
    a, b = max(a, w0), min(b, w1)
    return (a, b) if b > a else None


def decompose_trace(
    recorder: FlightRecorder,
    trace_id: str,
    t0: Optional[float] = None,
    t1: Optional[float] = None,
    now: Optional[float] = None,
    full_gang: Optional[int] = None,
) -> Dict[str, Any]:
    """Decompose one trace's wall clock over the window ``[t0, t1]``.

    Defaults: the root span's own interval (open root → ``now``). Returns
    ``{"wall_s", "categories": {cat: s}, "segments": [(a, b, cat, w)],
    "goodput_fraction", "sum_error_s"}`` where segments carry the time
    resolution the ledger buckets by (``w`` scales the duration — a
    degraded-mesh segment splits into a productive part at weight
    ``use/full`` and a shrink-degraded part at the complement).

    The categories are disjoint and sum to the window exactly (modulo
    float error, reported as ``sum_error_s``): a boundary sweep assigns
    every elementary segment to the single highest-priority overlay
    covering it, the running baseline (productive / shrink-degraded)
    under it, idle/unknown outside.
    """
    spans = recorder.spans(trace_id=trace_id, limit=0)
    events = recorder.events(trace_id=trace_id, limit=0)
    now = recorder.clock() if now is None else float(now)

    root = next((s for s in spans if s["kind"] == "job"), None)
    if root is None and spans:
        root = spans[0]
    if root is None:
        w0 = 0.0 if t0 is None else float(t0)
        w1 = w0 if t1 is None else float(t1)
    else:
        w0 = root["t0"] if t0 is None else float(t0)
        w1 = (root["t1"] if root["t1"] is not None else now) if t1 is None else float(t1)
    empty = {c: 0.0 for c in CATEGORIES}
    if w1 <= w0:
        return {
            "wall_s": 0.0, "categories": empty, "segments": [],
            "goodput_fraction": None, "sum_error_s": 0.0,
            "compile_split": {"warm_s": 0.0, "cold_s": 0.0},
        }

    def span_end(s: Dict[str, Any]) -> float:
        return s["t1"] if s["t1"] is not None else now

    # -- overlay intervals per category --------------------------------------
    overlays: Dict[str, List[Tuple[float, float]]] = {c: [] for c in _OVERLAY_PRIORITY}
    compile_warm_raw = 0.0  # raw (pre-sweep) compile span seconds by verdict
    compile_cold_raw = 0.0
    admissions = sorted(
        (s for s in spans if s["kind"] == "admission"), key=lambda s: s["t0"]
    )
    attempts = sorted(
        (s for s in spans if s["kind"] == "attempt"), key=lambda s: s["t0"]
    )
    for s in spans:
        cat = _SPAN_KIND_CATEGORY.get(s["kind"])
        if cat is None:
            continue
        # Async checkpoint dispatch (attrs blocking=False) overlaps
        # training — it must not displace productive time.
        if cat == "checkpoint_save" and s["attrs"].get("blocking") is False:
            continue
        iv = _clip(s["t0"], span_end(s), w0, w1)
        if iv:
            overlays[cat].append(iv)
            # Warm/cold sub-attribution of compile time: the supervisor's
            # compile spans carry a ``cache_hit`` attr (fed by the fleet
            # compile index); missing/false counts cold — pessimistic.
            if cat == "compile":
                if s["attrs"].get("cache_hit"):
                    compile_warm_raw += iv[1] - iv[0]
                else:
                    compile_cold_raw += iv[1] - iv[0]
    for e in events:
        # Host-slow faults are *reported* stalls: the supervisor records
        # the event right after the step, penalty carried in attrs — the
        # stall occupied the window ending at the event.
        if e["kind"] == "fault":
            pen = float(e["attrs"].get("penalty_s") or 0.0)
            if pen > 0:
                iv = _clip(e["ts"] - pen, e["ts"], w0, w1)
                if iv:
                    overlays["host_slow"].append(iv)
        # A preemption drain runs from the signal to the end of the
        # enclosing attempt (the emergency save inside it maps to the
        # same category, so the overlap is harmless).
        elif e["kind"] == "preempt_drain":
            encl = next(
                (a for a in attempts if a["t0"] <= e["ts"] <= span_end(a)), None
            )
            drain_end = span_end(encl) if encl is not None else e["ts"]
            iv = _clip(e["ts"], drain_end, w0, w1)
            if iv:
                overlays["preempt_drain"].append(iv)
        # Live queue wait: submit/requeue → the end of the next admission
        # pass (no admission ever → waited until the window closed).
        elif e["kind"] == "scheduler" and e["name"] in ("submit", "requeue"):
            nxt = next(
                (a for a in admissions if span_end(a) >= e["ts"]), None
            )
            wait_end = span_end(nxt) if nxt is not None else w1
            iv = _clip(e["ts"], wait_end, w0, w1)
            if iv:
                overlays["queue_wait"].append(iv)

    # -- running baseline ----------------------------------------------------
    # Attempt spans when the live supervisor recorded them; otherwise
    # (discrete-event sims record no attempts) the root window itself.
    if attempts:
        running = [
            iv for a in attempts if (iv := _clip(a["t0"], span_end(a), w0, w1))
        ]
    else:
        running = [(w0, w1)]
    # Supervisor hook: an attempt annotated with its measured per-step
    # wall total (``step_s``) caps how much of the attempt's uncovered
    # time may count productive — input-pipeline stalls and similar
    # untraced time fall to idle/unknown instead of inflating goodput.
    step_s_cap: Dict[int, Optional[float]] = {}
    for i, a in enumerate(attempts):
        v = a["attrs"].get("step_s")
        step_s_cap[i] = float(v) if isinstance(v, (int, float)) else None

    # -- capacity-fraction timeline (shrink-degraded deficit) ----------------
    # Piecewise healthy-mesh-equivalent fraction: each admission span's
    # end switches the running mesh to its admitted size over the
    # configured ("full") gang. Full comes from the admission's own
    # ``configured_gang``, the caller, or the root's ``n_chips``.
    changes: List[Tuple[float, float]] = [(w0, 1.0)]
    root_full = None
    if root is not None:
        ra = root["attrs"]
        root_full = ra.get("n_chips") or ra.get("gang")
    for s in admissions:
        at = s["attrs"]
        size = at.get("mesh") or at.get("gang")
        if isinstance(size, dict):  # live shrunk_mesh dicts carry axes
            prod = 1
            for v in size.values():
                prod *= int(v)
            size = prod
        full = at.get("configured_gang") or full_gang or root_full
        if not size or not full:
            continue
        degraded = (
            at.get("shrunk_mesh") is not None
            or s["name"] in ("shrink_admit", "grow_back")
            or float(size) < float(full)
        )
        frac = min(1.0, float(size) / float(full)) if degraded else 1.0
        changes.append((span_end(s), frac))
    changes.sort(key=lambda c: c[0])

    def fraction_at(ts: float) -> float:
        frac = 1.0
        for t, f in changes:
            if t <= ts:
                frac = f
            else:
                break
        return frac

    # -- boundary sweep ------------------------------------------------------
    edges = {w0, w1}
    for ivs in overlays.values():
        for a, b in ivs:
            edges.add(a)
            edges.add(b)
    for a, b in running:
        edges.add(a)
        edges.add(b)
    for t, _ in changes:
        if w0 < t < w1:
            edges.add(t)
    cuts = sorted(edges)

    cats = {c: 0.0 for c in CATEGORIES}
    segments: List[Tuple[float, float, str, float]] = []
    # Per-attempt uncovered-productive totals, for the step_s cap below.
    attempt_prod: Dict[int, List[int]] = {}

    def attempt_index(ts: float) -> Optional[int]:
        for i, a in enumerate(attempts):
            if a["t0"] <= ts < span_end(a):
                return i
        return None

    for a, b in zip(cuts, cuts[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2.0
        cat = next(
            (
                c
                for c in _OVERLAY_PRIORITY
                if any(x <= mid < y for x, y in overlays[c])
            ),
            None,
        )
        if cat is not None:
            cats[cat] += b - a
            segments.append((a, b, cat, 1.0))
            continue
        if any(x <= mid < y for x, y in running):
            frac = fraction_at(mid)
            cats["productive"] += (b - a) * frac
            segments.append((a, b, "productive", frac))
            if frac < 1.0:
                cats["shrink_degraded"] += (b - a) * (1.0 - frac)
                segments.append((a, b, "shrink_degraded", 1.0 - frac))
            if attempts:
                idx = attempt_index(mid)
                if idx is not None:
                    attempt_prod.setdefault(idx, []).append(len(segments) - 1)
        else:
            cats["idle_unknown"] += b - a
            segments.append((a, b, "idle_unknown", 1.0))

    # Apply the supervisor's step_s cap per attempt: scale that attempt's
    # productive segments down uniformly, residual to idle/unknown.
    for idx, seg_ids in attempt_prod.items():
        cap = step_s_cap.get(idx)
        if cap is None:
            continue
        total = sum(
            (segments[i][1] - segments[i][0]) * segments[i][3] for i in seg_ids
        )
        if total <= cap or total <= 0:
            continue
        ratio = cap / total
        for i in seg_ids:
            sa, sb, _, wgt = segments[i]
            segments[i] = (sa, sb, "productive", wgt * ratio)
            spill = (sb - sa) * wgt * (1.0 - ratio)
            cats["productive"] -= spill
            cats["idle_unknown"] += spill
            segments.append((sa, sb, "idle_unknown", wgt * (1.0 - ratio)))

    wall = w1 - w0
    total = sum(cats.values())
    # Proportional warm/cold split of the swept compile seconds: raw span
    # seconds may overlap (double compiles across attempts) but the sweep
    # assigned each elementary segment once — scale the raw verdict mix
    # onto the disjoint total so warm_s + cold_s == categories["compile"]
    # exactly and the 9-category sum-to-wall invariant is untouched.
    comp = cats["compile"]
    raw = compile_warm_raw + compile_cold_raw
    warm_s = comp * compile_warm_raw / raw if comp > 0 and raw > 0 else 0.0
    return {
        "wall_s": wall,
        "categories": cats,
        "segments": segments,
        "goodput_fraction": (cats["productive"] / wall) if wall > 0 else None,
        "sum_error_s": total - wall,
        "compile_split": {"warm_s": warm_s, "cold_s": comp - warm_s},
    }


# ---------------------------------------------------------------------------
# Incremental ledger
# ---------------------------------------------------------------------------


def _zero() -> Dict[str, float]:
    return {c: 0.0 for c in CATEGORIES}


class GoodputLedger:
    """Incremental fleet/tenant/workload goodput rollups over recorder
    traces, with time-bucketed history rings.

    Bounded memory: tracked traces are capped (oldest evicted), tenants
    beyond ``max_tenants`` fold into ``~other``, the history ring holds
    ``history_buckets`` buckets of ``bucket_s`` seconds. Per-trace
    cursors make re-accounting idempotent — ``refresh`` can run on every
    metrics scrape and each wall-clock second is still counted once.
    All methods take explicit timestamps (virtual-clock sims pass their
    own ``now``); the ``clock`` default is only the live fallback.
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.time,
        bucket_s: float = 60.0,
        history_buckets: int = 120,
        tolerance: float = 0.01,
        max_tenants: int = 64,
        max_tracked: int = 512,
    ):
        self._lock = threading.RLock()
        self.clock = clock
        self.bucket_s = float(bucket_s)
        self.history_buckets = int(history_buckets)
        self.tolerance = float(tolerance)
        self.max_tenants = int(max_tenants)
        self.max_tracked = int(max_tracked)
        self._fleet = _zero()
        self._by_tenant: Dict[str, Dict[str, float]] = {}
        self._by_workload: Dict[str, Dict[str, float]] = {}
        # bucket index -> category seconds; ordered oldest-first
        self._history: "OrderedDict[int, Dict[str, float]]" = OrderedDict()
        # trace_id -> {"tenant","workload","full_gang","cursor"}
        self._tracked: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.traces_accounted = 0
        self.invariant_violations = 0
        self.accounted_wall_s = 0.0
        # Warm/cold sub-attribution of the `compile` category (fed by the
        # decomposition's per-span cache_hit verdicts; never a 10th
        # category — warm_s + cold_s tracks categories["compile"]).
        self._compile_warm_s = 0.0
        self._compile_cold_s = 0.0

    # -- tracking ------------------------------------------------------------

    def track(
        self,
        trace_id: str,
        tenant: str = "anonymous",
        workload: str = "training",
        full_gang: Optional[int] = None,
    ) -> None:
        """Register a live trace for incremental accounting (idempotent)."""
        with self._lock:
            if trace_id not in self._tracked:
                self._tracked[trace_id] = {
                    "tenant": tenant,
                    "workload": workload,
                    "full_gang": full_gang,
                    "cursor": None,
                }
                while len(self._tracked) > self.max_tracked:
                    self._tracked.popitem(last=False)

    def untrack(self, trace_id: str) -> None:
        with self._lock:
            self._tracked.pop(trace_id, None)

    # -- accounting ----------------------------------------------------------

    def _tenant_slot(self, tenant: str) -> Dict[str, float]:
        # caller holds the lock
        if tenant not in self._by_tenant and len(self._by_tenant) >= self.max_tenants:
            tenant = "~other"
        return self._by_tenant.setdefault(tenant, _zero())

    def _fold_segment(
        self, a: float, b: float, cat: str, weight: float,
        tenant: str, workload: str,
    ) -> None:
        # caller holds the lock
        secs = (b - a) * weight
        if secs <= 0:
            return
        self._fleet[cat] += secs
        self._tenant_slot(tenant)[cat] += secs
        self._by_workload.setdefault(workload, _zero())[cat] += secs
        # spread over history buckets by exact overlap
        k0 = int(a // self.bucket_s)
        k1 = int(max(a, b - 1e-12) // self.bucket_s)
        for k in range(k0, k1 + 1):
            lo, hi = k * self.bucket_s, (k + 1) * self.bucket_s
            part = max(0.0, min(b, hi) - max(a, lo)) * weight
            if part <= 0:
                continue
            bucket = self._history.get(k)
            if bucket is None:
                bucket = self._history[k] = _zero()
                while len(self._history) > self.history_buckets:
                    self._history.popitem(last=False)
            bucket[cat] += part

    def note(
        self,
        category: str,
        seconds: float,
        tenant: str = "anonymous",
        workload: str = "training",
        ts: Optional[float] = None,
        compile_warm: Optional[bool] = None,
    ) -> None:
        """Explicit-timestamp escape hatch: fold ``seconds`` of ``category``
        ending at ``ts`` without a trace (sims, external accounting).
        ``compile_warm`` attributes a ``compile`` contribution to the
        warm/cold sub-split."""
        if category not in CATEGORIES:
            raise ValueError(f"unknown goodput category {category!r}")
        if seconds <= 0:
            return
        ts = self.clock() if ts is None else float(ts)
        with self._lock:
            self._fold_segment(ts - seconds, ts, category, 1.0, tenant, workload)
            self.accounted_wall_s += seconds
            if category == "compile" and compile_warm is not None:
                if compile_warm:
                    self._compile_warm_s += seconds
                else:
                    self._compile_cold_s += seconds

    def account_trace(
        self,
        recorder: FlightRecorder,
        trace_id: str,
        tenant: Optional[str] = None,
        workload: Optional[str] = None,
        now: Optional[float] = None,
        final: bool = False,
    ) -> Optional[Dict[str, Any]]:
        """Account ``trace_id`` from its cursor up to ``now`` (or the root
        span's end). Returns the delta decomposition, or None when there
        was nothing new to account. Safe to call repeatedly."""
        now = recorder.clock() if now is None else float(now)
        with self._lock:
            meta = self._tracked.get(trace_id)
            if meta is None:
                meta = {
                    "tenant": tenant or "anonymous",
                    "workload": workload or "training",
                    "full_gang": None,
                    "cursor": None,
                }
                self._tracked[trace_id] = meta
            if tenant is not None:
                meta["tenant"] = tenant
            if workload is not None:
                meta["workload"] = workload
            cursor = meta["cursor"]
        d = decompose_trace(
            recorder, trace_id, t0=cursor, now=now, full_gang=meta["full_gang"]
        )
        # An explicit cursor with no t1 decomposes [cursor, root end/now];
        # clamp forward motion only.
        with self._lock:
            if d["wall_s"] <= 0:
                if final:
                    self._tracked.pop(trace_id, None)
                    self.traces_accounted += 1
                return None
            upto = (cursor or 0.0) + d["wall_s"] if cursor is not None else None
            if cursor is None:
                # first accounting pass: cursor starts at window end
                seg_end = max((b for _, b, _, _ in d["segments"]), default=now)
                upto = seg_end
            meta["cursor"] = upto
            for a, b, cat, wgt in d["segments"]:
                self._fold_segment(a, b, cat, wgt, meta["tenant"], meta["workload"])
            self.accounted_wall_s += d["wall_s"]
            split = d.get("compile_split") or {}
            self._compile_warm_s += float(split.get("warm_s", 0.0))
            self._compile_cold_s += float(split.get("cold_s", 0.0))
            if abs(d["sum_error_s"]) > self.tolerance * max(d["wall_s"], 1e-9):
                self.invariant_violations += 1
            if final:
                self._tracked.pop(trace_id, None)
                self.traces_accounted += 1
        return d

    def finalize(
        self,
        recorder: FlightRecorder,
        trace_id: str,
        now: Optional[float] = None,
    ) -> Optional[Dict[str, Any]]:
        """Terminal accounting: account the remainder and drop the cursor."""
        return self.account_trace(recorder, trace_id, now=now, final=True)

    def refresh(
        self, recorder: FlightRecorder, now: Optional[float] = None
    ) -> int:
        """Incrementally account every tracked live trace (the pull model:
        readers — the router, /metrics, the alerter — call this so the
        rollups are current at read time). Returns traces touched."""
        with self._lock:
            ids = list(self._tracked)
        n = 0
        for tid in ids:
            if self.account_trace(recorder, tid, now=now) is not None:
                n += 1
        return n

    # -- views ---------------------------------------------------------------

    def window_fraction(
        self, window_s: float, now: Optional[float] = None
    ) -> Optional[float]:
        """Goodput fraction over the trailing ``window_s`` of history
        buckets (productive / all accounted seconds); None when the
        window holds no accounted time."""
        now = self.clock() if now is None else float(now)
        lo = now - float(window_s)
        prod = total = 0.0
        with self._lock:
            for k, bucket in self._history.items():
                b0, b1 = k * self.bucket_s, (k + 1) * self.bucket_s
                overlap = max(0.0, min(b1, now) - max(b0, lo))
                if overlap <= 0:
                    continue
                share = overlap / self.bucket_s
                bsum = sum(bucket.values())
                prod += bucket["productive"] * share
                total += bsum * share
        if total <= 0:
            return None
        return prod / total

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = self.clock() if now is None else float(now)
        with self._lock:
            wall = sum(self._fleet.values())
            history = [
                {"t0": k * self.bucket_s, "t1": (k + 1) * self.bucket_s,
                 "categories": {c: round(v, 3) for c, v in b.items() if v > 0}}
                for k, b in self._history.items()
            ]
            return {
                "categories": {c: round(v, 3) for c, v in self._fleet.items()},
                "wall_s": round(wall, 3),
                "goodput_fraction": (
                    round(self._fleet["productive"] / wall, 4) if wall > 0 else None
                ),
                "by_tenant": {
                    t: {c: round(v, 3) for c, v in cats.items() if v > 0}
                    for t, cats in self._by_tenant.items()
                },
                "by_workload": {
                    w: {c: round(v, 3) for c, v in cats.items() if v > 0}
                    for w, cats in self._by_workload.items()
                },
                "history": history,
                "bucket_s": self.bucket_s,
                "tracked_traces": len(self._tracked),
                "traces_accounted": self.traces_accounted,
                "invariant_violations": self.invariant_violations,
                "accounted_wall_s": round(self.accounted_wall_s, 3),
                "compile_split": {
                    "warm_s": round(self._compile_warm_s, 3),
                    "cold_s": round(self._compile_cold_s, 3),
                },
            }


# ---------------------------------------------------------------------------
# SLO burn-rate alerting
# ---------------------------------------------------------------------------

_SEVERITY_ORDER = {"ok": 0, "warning": 1, "page": 2}


# Unique historian label per alerter instance (see SLOBurnRateAlerter).
_ALERTER_SEQ = itertools.count(1)


class SLOBurnRateAlerter:
    """Multi-window burn-rate alerting over two SLOs:

    - **goodput**: fraction of accounted wall time that was productive,
      against ``goodput_target`` — measured from the ledger's history
      rings over a short and a long window;
    - **serving_p99**: fraction of observed p99 samples under
      ``p99_slo_ms`` (``ServingFleet.tick`` feeds samples), against
      ``serving_target``.

    A state escalates when BOTH windows burn at or above the threshold
    (``warning_burn`` → warning, ``page_burn`` → page) and de-escalates
    as the windows drain. Every transition appends a structured alert
    and fires an event on the recorder's ``fleet`` timeline.
    """

    def __init__(
        self,
        ledger: GoodputLedger,
        goodput_target: float = 0.85,
        short_window_s: float = 300.0,
        long_window_s: float = 1800.0,
        warning_burn: float = 1.5,
        page_burn: float = 3.0,
        p99_slo_ms: float = 2000.0,
        serving_target: float = 0.99,
        recorder: Optional[FlightRecorder] = None,
        clock: Optional[Callable[[], float]] = None,
        max_alerts: int = 256,
        historian: Optional["historian_mod.MetricHistorian"] = None,
    ):
        self._lock = threading.RLock()
        self.ledger = ledger
        self.goodput_target = float(goodput_target)
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        self.warning_burn = float(warning_burn)
        self.page_burn = float(page_burn)
        self.p99_slo_ms = float(p99_slo_ms)
        self.serving_target = float(serving_target)
        self.recorder = recorder
        self.clock = clock or ledger.clock
        self.state: Dict[str, str] = {"goodput": "ok", "serving_p99": "ok"}
        self.alerts: deque = deque(maxlen=int(max_alerts))
        self.alerts_total: Dict[str, int] = {}
        # p99 samples live in the historian (bounded there by the series
        # raw ring), so the alert window and a `/history/query` over the
        # same range can never disagree. Per-instance label: repeated
        # constructions in one process never share a window.
        self._historian = historian
        self.p99_series = "slo_serving_p99_ms"
        self.p99_ok_series = "slo_serving_p99_ok"
        self.series_labels: Dict[str, str] = {
            "alerter": str(next(_ALERTER_SEQ))
        }
        self.last_eval: Optional[Dict[str, Any]] = None

    def _hist(self) -> "historian_mod.MetricHistorian":
        if self._historian is None:
            self._historian = historian_mod.get_historian()
        return self._historian

    # -- inputs --------------------------------------------------------------

    def observe_p99(self, p99_ms: Optional[float], ts: Optional[float] = None) -> None:
        """Feed one serving p99 sample (``ServingFleet.tick`` calls this)."""
        if p99_ms is None:
            return
        ts = self.clock() if ts is None else float(ts)
        with self._lock:
            hist = self._hist()
            hist.record(
                self.p99_series, float(p99_ms), ts=ts, labels=self.series_labels
            )
            hist.record(
                self.p99_ok_series,
                1.0 if float(p99_ms) <= self.p99_slo_ms else 0.0,
                ts=ts,
                labels=self.series_labels,
            )

    # -- evaluation ----------------------------------------------------------

    def _burn(self, bad_fraction: Optional[float], budget: float) -> Optional[float]:
        if bad_fraction is None:
            return None
        return bad_fraction / max(budget, 1e-9)

    def _p99_bad_fraction(self, window_s: float, now: float) -> Optional[float]:
        q = self._hist().query(
            self.p99_ok_series,
            t0=now - window_s,
            t1=now,
            agg="avg",
            labels=self.series_labels,
            tier="raw",
        )
        if not q["count"]:
            return None
        return 1.0 - float(q["value"])

    def _severity(
        self, short_burn: Optional[float], long_burn: Optional[float]
    ) -> str:
        if short_burn is None or long_burn is None:
            return "ok"
        if short_burn >= self.page_burn and long_burn >= self.page_burn:
            return "page"
        if short_burn >= self.warning_burn and long_burn >= self.warning_burn:
            return "warning"
        return "ok"

    def _transition(
        self, slo: str, new: str, detail: Dict[str, Any], now: float
    ) -> None:
        # caller holds the lock
        old = self.state[slo]
        if new == old:
            return
        self.state[slo] = new
        kind = "escalate" if _SEVERITY_ORDER[new] > _SEVERITY_ORDER[old] else "resolve"
        alert = {
            "slo": slo,
            "severity": new,
            "previous": old,
            "transition": kind,
            "ts": now,
            **detail,
        }
        self.alerts.append(alert)
        self.alerts_total[new] = self.alerts_total.get(new, 0) + 1
        if self.recorder is not None:
            self.recorder.event(
                f"slo_alert:{slo}:{new}",
                kind="slo_alert",
                trace_id=FLEET_TRACE_ID,
                ts=now,
                attrs=dict(alert),
            )

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One evaluation pass; returns the full SLO view and fires any
        state-transition alerts."""
        now = self.clock() if now is None else float(now)
        g_short = self.ledger.window_fraction(self.short_window_s, now=now)
        g_long = self.ledger.window_fraction(self.long_window_s, now=now)
        g_budget = 1.0 - self.goodput_target
        gb_short = self._burn(
            None if g_short is None else 1.0 - g_short, g_budget
        )
        gb_long = self._burn(None if g_long is None else 1.0 - g_long, g_budget)
        s_budget = 1.0 - self.serving_target
        with self._lock:
            sb_short = self._burn(
                self._p99_bad_fraction(self.short_window_s, now), s_budget
            )
            sb_long = self._burn(
                self._p99_bad_fraction(self.long_window_s, now), s_budget
            )
            g_sev = self._severity(gb_short, gb_long)
            s_sev = self._severity(sb_short, sb_long)
            self._transition(
                "goodput", g_sev,
                {
                    "short_burn": gb_short, "long_burn": gb_long,
                    "short_fraction": g_short, "long_fraction": g_long,
                    "target": self.goodput_target,
                },
                now,
            )
            self._transition(
                "serving_p99", s_sev,
                {
                    "short_burn": sb_short, "long_burn": sb_long,
                    "p99_slo_ms": self.p99_slo_ms,
                    "target": self.serving_target,
                },
                now,
            )
            out = {
                "goodput": {
                    "state": self.state["goodput"],
                    "target": self.goodput_target,
                    "short_window_s": self.short_window_s,
                    "long_window_s": self.long_window_s,
                    "short_fraction": g_short,
                    "long_fraction": g_long,
                    "short_burn": gb_short,
                    "long_burn": gb_long,
                },
                "serving_p99": {
                    "state": self.state["serving_p99"],
                    "p99_slo_ms": self.p99_slo_ms,
                    "target": self.serving_target,
                    "short_burn": sb_short,
                    "long_burn": sb_long,
                    "samples": self._hist().raw_len(
                        self.p99_ok_series, labels=self.series_labels
                    ),
                },
                "thresholds": {
                    "warning_burn": self.warning_burn,
                    "page_burn": self.page_burn,
                },
                "alerts_total": dict(self.alerts_total),
                "recent_alerts": list(self.alerts)[-20:],
            }
            self.last_eval = out
        return out


# ---------------------------------------------------------------------------
# Process-wide singletons (same pattern as tracing.get_recorder)
# ---------------------------------------------------------------------------

_ledger: Optional[GoodputLedger] = None
_alerter: Optional[SLOBurnRateAlerter] = None
# RLock: get_alerter() constructs its default ledger via get_ledger()
# while already holding the lock.
_singleton_lock = threading.RLock()


def get_ledger() -> GoodputLedger:
    global _ledger
    with _singleton_lock:
        if _ledger is None:
            _ledger = GoodputLedger()
        return _ledger


def set_ledger(ledger: Optional[GoodputLedger]) -> None:
    """Swap the process-wide ledger (tests/sims install a fresh one).
    Also drops the alerter when it pointed at the old ledger."""
    global _ledger, _alerter
    with _singleton_lock:
        if _alerter is not None and _alerter.ledger is not ledger:
            _alerter = None
        _ledger = ledger


def get_alerter() -> SLOBurnRateAlerter:
    global _alerter
    with _singleton_lock:
        if _alerter is None:
            from tpu_engine_torch import tracing

            _alerter = SLOBurnRateAlerter(
                get_ledger(), recorder=tracing.get_recorder()
            )
        return _alerter


def set_alerter(alerter: Optional[SLOBurnRateAlerter]) -> None:
    global _alerter
    with _singleton_lock:
        _alerter = alerter
