"""Explainable fleet autopilot: one audited control loop from incident to
action. Port of
``tpu_engine/autopilot.py``: host-side control code, JAX's names, messages,
defaults and metric families, over this package's planes.

The sensor planes (flight recorder, goodput/SLO alerter, historian,
incident correlator) tell a human *what* happened; until now the three
control ticks — scheduler poll, serving autoscaler, precompile worker —
actuated independently with no shared record of *why*. ``FleetAutopilot``
subsumes them into one deterministic, virtual-clock-compatible
:meth:`FleetAutopilot.tick` and makes every actuation (and every
deliberate non-actuation) a first-class, queryable artifact:

- **Inputs are trends, never instants.** Each policy rule consults
  historian *range queries* (aggregate over ``trend_window_s``), recorder
  blame events over the same window, open incident ids, and host-health
  gauges — and every one of those inputs is copied into the decision.
- **DecisionRecords.** One bounded, id-stable record per consult: the
  rule, the target, the query inputs, the hysteresis/cooldown state, the
  chosen action or the structured suppression reason, and the outcome.
  Records are mirrored as ``kind="autopilot"`` spans on the flight
  recorder, which the :class:`~tpu_engine_torch.historian.IncidentCorrelator`
  ingests as the incident's *action* leg (``action_source`` distinguishes
  ``autopilot`` from ``autopilot-dryrun`` from ``human``).
- **Blast-radius guards.** A rule fires only after ``sustain_consults``
  consecutive breaching consults (hysteresis), outside the per-target
  ``cooldown_s``, and under ``max_actions_per_window`` across the whole
  loop — each guard trip is itself a recorded suppression.
- **Dry-run (shadow) mode.** The full decision stream with zero
  actuations: mode lives on the autopilot, never inside the serialized
  record, so a shadow run is byte-identical to an armed run over the
  same inputs.

``GET /api/v1/autopilot/decisions`` serves the record stream
(``backend/routers/autopilot.py``); ``/metrics`` exports the
``tpu_engine_autopilot_*`` families; the twin's
:func:`tpu_engine_torch.twin.autopilot_lane` A/Bs chaos goodput with the loop
on vs off, and ``benchmarks/chaos.py`` exit-gates on it.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from tpu_engine_torch import historian as historian_mod
from tpu_engine_torch import tracing as tracing_mod

log = logging.getLogger("tpu_engine_torch.autopilot")

__all__ = [
    "RULES",
    "OUTCOMES",
    "SUPPRESSION_REASONS",
    "ACTION_SOURCES",
    "AutopilotConfig",
    "DecisionRecord",
    "FleetAutopilot",
    "get_autopilot",
    "set_autopilot",
]

# Evaluated in this order every tick — the order is part of the contract
# (blast-radius budget is consumed first-come) and must stay stable.
RULES = ("replan_slow_job", "rescale_serving", "drain_host", "kick_precompile")
OUTCOMES = ("fired", "suppressed")
# Checked in this order; the first failing guard names the suppression.
SUPPRESSION_REASONS = (
    "trend-not-sustained", "cooldown-active", "blast-radius", "no-actuator",
)
ACTION_SOURCES = ("human", "autopilot", "autopilot-dryrun")


@dataclasses.dataclass
class AutopilotConfig:
    """Policy constants. Mode (armed vs dry-run) deliberately lives on the
    :class:`FleetAutopilot`, not here — records must not encode it."""

    # Input windows: rules aggregate over trend_window_s; the slow-step
    # baseline (when no nominal is configured) comes from the longer one.
    trend_window_s: float = 120.0
    baseline_window_s: float = 480.0
    # Hysteresis / blast radius.
    sustain_consults: int = 3
    cooldown_s: float = 120.0                 # per (rule, target)
    max_actions_per_window: int = 2           # across ALL rules
    action_window_s: float = 300.0
    max_decisions: int = 512                  # retained record ring
    # replan_slow_job: avg step time over the window vs a nominal (explicit,
    # or the min over the baseline window when None).
    step_time_series: str = "step_time_s"
    step_time_labels: Optional[Dict[str, str]] = None
    nominal_step_time_s: Optional[float] = None
    slow_step_factor: float = 1.25
    # rescale_serving: windowed p99-ok ratio under the floor means the SLO
    # is burning — scale ahead of the page.
    serving_ok_series: str = "slo_serving_p99_ok"
    serving_p99_series: str = "slo_serving_p99_ms"
    serving_labels: Optional[Dict[str, str]] = None
    serving_ok_floor: float = 0.9
    serving_scale_step: int = 1
    # drain_host: the recorder keeps blaming one device AND its retained
    # health trend sits under the floor (or has no healthy evidence).
    fault_blame_threshold: int = 3
    host_health_series: str = "hetero_host_health"
    host_health_floor: float = 0.9
    # kick_precompile: queued work is sitting idle (the autopilot records
    # the depth gauge itself each tick, then queries its own trend).
    precompile_series: str = "precompile_queue_depth"
    # Per-rule sustain overrides (kick_precompile reacts in one consult —
    # pumping a queue is cheap and self-correcting).
    rule_sustain: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"kick_precompile": 1}
    )


@dataclasses.dataclass
class DecisionRecord:
    """One consult, fired or suppressed. ``to_json()`` is byte-stable:
    two runs fed identical inputs serialize identically regardless of
    armed/dry-run mode (mode is recorded only on the mirrored span and
    the incident timeline, as ``action_source``)."""

    decision_id: str
    ts: float
    rule: str
    target: str
    # {"queries": [...], "incidents": [...], "gauges": {...}, "evidence": {...}}
    inputs: Dict[str, Any]
    # {"streak", "required", "cooldown_remaining_s",
    #  "actions_in_window", "max_actions_per_window"}
    hysteresis: Dict[str, Any]
    action: Optional[Dict[str, Any]]
    suppressed_reason: Optional[str]
    outcome: str  # "fired" | "suppressed"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "decision_id": self.decision_id,
            "ts": self.ts,
            "rule": self.rule,
            "target": self.target,
            "inputs": self.inputs,
            "hysteresis": self.hysteresis,
            "action": self.action,
            "suppressed_reason": self.suppressed_reason,
            "outcome": self.outcome,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, separators=(",", ":"))


def _default_ids() -> Callable[[], str]:
    counter = itertools.count(1)
    return lambda: f"apd-{next(counter):06d}"


class FleetAutopilot:
    """The unified control loop. All collaborators are injectable; the
    historian/correlator/recorder default to the process singletons *at
    tick time*, so tests that swap singletons see the swap."""

    def __init__(
        self,
        config: Optional[AutopilotConfig] = None,
        *,
        dry_run: bool = True,
        historian: Optional["historian_mod.MetricHistorian"] = None,
        correlator: Optional["historian_mod.IncidentCorrelator"] = None,
        recorder: Optional["tracing_mod.FlightRecorder"] = None,
        scheduler: Any = None,
        serving_fleet: Any = None,
        precompiler: Any = None,
        actuators: Optional[Dict[str, Callable[[DecisionRecord], Any]]] = None,
        gauges_fn: Optional[Callable[[], Dict[str, float]]] = None,
        clock: Callable[[], float] = time.time,
        id_factory: Optional[Callable[[], str]] = None,
        trace_id: str = "fleet",
    ):
        self.config = config or AutopilotConfig()
        self.dry_run = bool(dry_run)
        self._historian = historian
        self._correlator = correlator
        self._recorder = recorder
        self.scheduler = scheduler
        self.serving_fleet = serving_fleet
        self.precompiler = precompiler
        self.actuators = dict(actuators or {})
        self.gauges_fn = gauges_fn
        self.clock = clock
        self.id_factory = id_factory or _default_ids()
        self.trace_id = trace_id
        self._lock = threading.RLock()
        self._records: deque[DecisionRecord] = deque(
            maxlen=max(int(self.config.max_decisions), 1)
        )
        # Guard state. All of it evolves identically in dry-run — that is
        # what makes the shadow stream byte-identical to an armed one.
        self._streak: Dict[tuple, int] = {}
        self._last_action: Dict[tuple, float] = {}
        self._action_times: deque[float] = deque()
        # Health counters.
        self.ticks_total = 0
        self.decisions_total = 0
        self.fired_total = 0
        self.suppressed_total = 0
        self.suppressed_by_reason: Dict[str, int] = {
            r: 0 for r in SUPPRESSION_REASONS
        }
        self.decisions_by_rule: Dict[str, int] = {r: 0 for r in RULES}
        self.actuations_total = 0
        self.actuations_by_rule: Dict[str, int] = {r: 0 for r in RULES}
        self.actuation_errors_total = 0
        self.decisions_dropped_total = 0
        self.subsumed_errors_total = 0
        self.last_tick_ts: Optional[float] = None

    # -- plane resolution ------------------------------------------------------

    def _hist(self) -> "historian_mod.MetricHistorian":
        return self._historian or historian_mod.get_historian()

    def _corr(self) -> "historian_mod.IncidentCorrelator":
        return self._correlator or historian_mod.get_correlator()

    def _rec(self) -> "tracing_mod.FlightRecorder":
        return self._recorder or tracing_mod.get_recorder()

    # -- the tick --------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> List[DecisionRecord]:
        """One deterministic control pass: run the subsumed plane ticks,
        roll the historian forward, refresh incidents, evaluate every
        policy rule, and emit exactly one DecisionRecord per consult."""
        with self._lock:
            now = float(self.clock() if now is None else now)
            hist, corr, rec = self._hist(), self._corr(), self._rec()
            self._subsumed_ticks(now, hist)
            # Headless fleets (no /metrics scraper)
            # still roll up and expire series through this tick.
            try:
                hist.tick(now=now)
            except Exception:
                self.subsumed_errors_total += 1
            try:
                corr.ingest(recorder=rec, now=now)
            except Exception:
                self.subsumed_errors_total += 1
            incidents = self._open_incident_ids(corr)
            gauges = self._gauges()
            records: List[DecisionRecord] = []
            consulted: set = set()
            for rule in RULES:
                try:
                    consults = self._consults_for(rule, now, hist, rec)
                except Exception:
                    self.subsumed_errors_total += 1
                    consults = []
                for consult in consults:
                    key = (rule, consult["target"])
                    consulted.add(key)
                    record = self._decide(now, rule, consult, incidents, gauges)
                    records.append(record)
                    self._admit(record)
                    self._mirror(rec, record)
                    if record.outcome == "fired" and not self.dry_run:
                        self._actuate(rule, record)
            # Hysteresis demands *consecutive* breaches: any target whose
            # signal went quiet this tick starts over.
            for key in [k for k in self._streak if k not in consulted]:
                del self._streak[key]
            # Ingest again so this tick's decision spans attach to their
            # incidents as the action leg immediately, not a tick late.
            try:
                corr.ingest(recorder=rec, now=now)
            except Exception:
                self.subsumed_errors_total += 1
            self.ticks_total += 1
            self.last_tick_ts = now
            return records

    def _subsumed_ticks(self, now: float, hist: Any) -> None:
        """The three control loops this tick replaces. Each is best-effort:
        one failing plane must not starve the others or the policy pass."""
        if self.scheduler is not None:
            try:
                self.scheduler.poll()
            except Exception:
                self.subsumed_errors_total += 1
        if self.serving_fleet is not None:
            try:
                self.serving_fleet.tick(now)
            except Exception:
                self.subsumed_errors_total += 1
        if self.precompiler is not None:
            # The worker's queue depth becomes a historian series so the
            # kick_precompile rule consults a trend, not an instant.
            try:
                depth = float(self.precompiler.stats().get("queue_depth", 0))
                hist.record(self.config.precompile_series, depth, ts=now)
            except Exception:
                self.subsumed_errors_total += 1

    # -- inputs ----------------------------------------------------------------

    def _query(
        self,
        hist: Any,
        series: str,
        labels: Optional[Dict[str, str]],
        now: float,
        window_s: float,
        agg: str,
    ) -> Dict[str, Any]:
        q = hist.query(
            series, t0=now - window_s, t1=now, agg=agg, labels=labels
        )
        value = q.get("value")
        return {
            "series": series,
            "labels": {str(k): str(v) for k, v in (labels or {}).items()},
            "agg": agg,
            "window_s": round(float(window_s), 6),
            "value": None if value is None else round(float(value), 6),
            "count": int(q.get("count") or 0),
        }

    def _open_incident_ids(self, corr: Any) -> List[str]:
        try:
            return [ref["incident_id"] for ref in corr.open_refs(limit=8)]
        except Exception:
            return []

    def _gauges(self) -> Dict[str, float]:
        if self.gauges_fn is None:
            return {}
        try:
            return {
                str(k): round(float(v), 6)
                for k, v in sorted(self.gauges_fn().items())
            }
        except Exception:
            return {}

    # -- rules -----------------------------------------------------------------

    def _consults_for(
        self, rule: str, now: float, hist: Any, rec: Any
    ) -> List[Dict[str, Any]]:
        if rule == "replan_slow_job":
            return self._rule_replan(now, hist)
        if rule == "rescale_serving":
            return self._rule_rescale(now, hist)
        if rule == "drain_host":
            return self._rule_drain(now, hist, rec)
        return self._rule_precompile(now, hist)

    def _rule_replan(self, now: float, hist: Any) -> List[Dict[str, Any]]:
        cfg = self.config
        q = self._query(
            hist, cfg.step_time_series, cfg.step_time_labels, now,
            cfg.trend_window_s, "avg",
        )
        if not q["count"] or q["value"] is None:
            return []
        queries = [q]
        nominal = cfg.nominal_step_time_s
        if nominal is None:
            base = self._query(
                hist, cfg.step_time_series, cfg.step_time_labels, now,
                cfg.baseline_window_s, "min",
            )
            queries.append(base)
            nominal = base["value"]
        if not nominal or q["value"] < cfg.slow_step_factor * nominal:
            return []
        return [{
            "target": "training",
            "queries": queries,
            "action": {
                "kind": "replan",
                "params": {
                    "observed_step_s": q["value"],
                    "nominal_step_s": round(float(nominal), 6),
                },
            },
        }]

    def _rule_rescale(self, now: float, hist: Any) -> List[Dict[str, Any]]:
        cfg = self.config
        labels = cfg.serving_labels
        if labels is None:
            if self.serving_fleet is None:
                return []
            try:
                from tpu_engine_torch import goodput as goodput_mod

                labels = goodput_mod.get_alerter().series_labels
            except Exception:
                return []
        q_ok = self._query(
            hist, cfg.serving_ok_series, labels, now, cfg.trend_window_s, "avg"
        )
        if not q_ok["count"] or q_ok["value"] is None:
            return []
        q_p99 = self._query(
            hist, cfg.serving_p99_series, labels, now, cfg.trend_window_s, "avg"
        )
        if q_ok["value"] >= cfg.serving_ok_floor:
            return []
        return [{
            "target": "serving",
            "queries": [q_ok, q_p99],
            "action": {
                "kind": "rescale",
                "params": {
                    "delta": int(cfg.serving_scale_step),
                    "p99_ok_ratio": q_ok["value"],
                    "p99_ms": q_p99["value"],
                },
            },
        }]

    def _rule_drain(
        self, now: float, hist: Any, rec: Any
    ) -> List[Dict[str, Any]]:
        """Drain a host the recorder keeps blaming — fault/anomaly events
        over the window, corroborated by the retained health trend."""
        cfg = self.config
        blame: Dict[int, int] = {}
        for kind in ("fault", "anomaly"):
            for ev in rec.events(kind=kind, limit=0):
                ts = ev.get("ts")
                if ts is None or ts < now - cfg.trend_window_s or ts > now:
                    continue
                idx = (ev.get("attrs") or {}).get("device_index")
                if idx is None:
                    continue
                blame[int(idx)] = blame.get(int(idx), 0) + 1
        consults: List[Dict[str, Any]] = []
        for idx in sorted(blame):
            if blame[idx] < cfg.fault_blame_threshold:
                continue
            q_health = self._query(
                hist, cfg.host_health_series, {"host": str(idx)}, now,
                cfg.trend_window_s, "avg",
            )
            healthy = (
                q_health["count"]
                and q_health["value"] is not None
                and q_health["value"] >= cfg.host_health_floor
            )
            if healthy:
                continue
            consults.append({
                "target": f"host-{idx}",
                "queries": [q_health],
                "evidence": {"blame_events": blame[idx]},
                "attrs": {"device_index": idx},
                "action": {
                    "kind": "drain",
                    "params": {
                        "device_index": idx,
                        "blame_events": blame[idx],
                    },
                },
            })
        return consults

    def _rule_precompile(self, now: float, hist: Any) -> List[Dict[str, Any]]:
        cfg = self.config
        if self.precompiler is None and "kick_precompile" not in self.actuators:
            return []
        q_avg = self._query(
            hist, cfg.precompile_series, None, now, cfg.trend_window_s, "avg"
        )
        q_last = self._query(
            hist, cfg.precompile_series, None, now, cfg.trend_window_s, "last"
        )
        if not q_last["count"] or not q_last["value"]:
            return []
        return [{
            "target": "precompile",
            "queries": [q_avg, q_last],
            "action": {
                "kind": "kick_precompile",
                "params": {"queue_depth": q_last["value"]},
            },
        }]

    # -- decision + guards -----------------------------------------------------

    def _decide(
        self,
        now: float,
        rule: str,
        consult: Dict[str, Any],
        incidents: List[str],
        gauges: Dict[str, float],
    ) -> DecisionRecord:
        cfg = self.config
        key = (rule, consult["target"])
        required = max(int(cfg.rule_sustain.get(rule, cfg.sustain_consults)), 1)
        streak = self._streak.get(key, 0) + 1
        self._streak[key] = streak
        while self._action_times and self._action_times[0] <= now - cfg.action_window_s:
            self._action_times.popleft()
        last = self._last_action.get(key)
        cooldown_remaining = (
            max(0.0, last + cfg.cooldown_s - now) if last is not None else 0.0
        )
        actions_in_window = len(self._action_times)
        reason: Optional[str] = None
        if streak < required:
            reason = "trend-not-sustained"
        elif cooldown_remaining > 0:
            reason = "cooldown-active"
        elif actions_in_window >= cfg.max_actions_per_window:
            reason = "blast-radius"
        elif self._resolve_actuator(rule) is None:
            reason = "no-actuator"
        outcome = "suppressed" if reason else "fired"
        inputs: Dict[str, Any] = {
            "queries": consult.get("queries", []),
            "incidents": list(incidents),
            "gauges": gauges,
        }
        if consult.get("evidence"):
            inputs["evidence"] = consult["evidence"]
        record = DecisionRecord(
            decision_id=self.id_factory(),
            ts=round(now, 6),
            rule=rule,
            target=consult["target"],
            inputs=inputs,
            hysteresis={
                "streak": streak,
                "required": required,
                "cooldown_remaining_s": round(cooldown_remaining, 6),
                "actions_in_window": actions_in_window,
                "max_actions_per_window": cfg.max_actions_per_window,
            },
            action=consult["action"] if outcome == "fired" else None,
            suppressed_reason=reason,
            outcome=outcome,
        )
        if outcome == "fired":
            # Guard state moves on "fired" in BOTH modes — a shadow run
            # must trace the exact decisions an armed run would make.
            self._streak[key] = 0
            self._last_action[key] = now
            self._action_times.append(now)
        record._span_attrs = dict(consult.get("attrs") or {})  # type: ignore[attr-defined]
        return record

    def _admit(self, record: DecisionRecord) -> None:
        if len(self._records) == self._records.maxlen:
            self.decisions_dropped_total += 1
        self._records.append(record)
        self.decisions_total += 1
        self.decisions_by_rule[record.rule] += 1
        if record.outcome == "fired":
            self.fired_total += 1
        else:
            self.suppressed_total += 1
            if record.suppressed_reason in self.suppressed_by_reason:
                self.suppressed_by_reason[record.suppressed_reason] += 1

    def action_source(self) -> str:
        return "autopilot-dryrun" if self.dry_run else "autopilot"

    def _mirror(self, rec: Any, record: DecisionRecord) -> None:
        attrs = {
            "decision_id": record.decision_id,
            "rule": record.rule,
            "target": record.target,
            "outcome": record.outcome,
            "suppressed_reason": record.suppressed_reason,
            "action": (record.action or {}).get("kind"),
            "action_source": self.action_source(),
            "incident_ids": list(record.inputs.get("incidents", []))[:8],
        }
        attrs.update(getattr(record, "_span_attrs", {}))
        try:
            rec.record_span(
                f"autopilot:{record.rule}",
                kind="autopilot",
                trace_id=self.trace_id,
                t0=record.ts,
                t1=record.ts,
                attrs=attrs,
            )
        except Exception:
            self.subsumed_errors_total += 1

    # -- actuation -------------------------------------------------------------

    def _resolve_actuator(
        self, rule: str
    ) -> Optional[Callable[[DecisionRecord], Any]]:
        if rule in self.actuators:
            return self.actuators[rule]
        if rule == "drain_host" and self.scheduler is not None:
            fn = getattr(self.scheduler, "quarantine_device", None)
            if fn is not None:
                return lambda r: fn(
                    int(r.action["params"]["device_index"]), owner="autopilot"
                )
        if rule == "replan_slow_job" and self.scheduler is not None:
            fn = getattr(self.scheduler, "request_replan", None)
            if fn is not None:
                return lambda r: fn()
        if rule == "rescale_serving" and self.serving_fleet is not None:
            fleet = self.serving_fleet
            return lambda r: fleet.scale_to(
                int(getattr(fleet, "desired_replicas", 0))
                + int(r.action["params"]["delta"])
            )
        if rule == "kick_precompile" and self.precompiler is not None:
            fn = getattr(self.precompiler, "pump", None)
            if fn is not None:
                return lambda r: fn()
        return None

    def _actuate(self, rule: str, record: DecisionRecord) -> None:
        actuator = self._resolve_actuator(rule)
        if actuator is None:  # pragma: no cover — guarded by "no-actuator"
            return
        try:
            actuator(record)
            self.actuations_total += 1
            self.actuations_by_rule[rule] += 1
        except Exception as e:  # noqa: BLE001 — the loop must survive a plane
            self.actuation_errors_total += 1
            log.warning("autopilot: %s actuation failed — %s", rule, e)

    # -- queries ---------------------------------------------------------------

    def decisions(
        self,
        limit: int = 50,
        rule: Optional[str] = None,
        outcome: Optional[str] = None,
        target: Optional[str] = None,
    ) -> List[Dict[str, Any]]:
        """Retained DecisionRecords, newest first, optionally filtered."""
        with self._lock:
            out: List[Dict[str, Any]] = []
            for record in reversed(self._records):
                if rule is not None and record.rule != rule:
                    continue
                if outcome is not None and record.outcome != outcome:
                    continue
                if target is not None and record.target != target:
                    continue
                out.append(record.to_dict())
                if limit and len(out) >= limit:
                    break
            return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "armed": not self.dry_run,
                "dry_run": self.dry_run,
                "ticks_total": self.ticks_total,
                "decisions_total": self.decisions_total,
                "fired_total": self.fired_total,
                "suppressed_total": self.suppressed_total,
                "suppressed_by_reason": dict(self.suppressed_by_reason),
                "decisions_by_rule": dict(self.decisions_by_rule),
                "actuations_total": self.actuations_total,
                "actuations_by_rule": dict(self.actuations_by_rule),
                "actuation_errors_total": self.actuation_errors_total,
                "decisions_retained": len(self._records),
                "decisions_dropped_total": self.decisions_dropped_total,
                "subsumed_errors_total": self.subsumed_errors_total,
                "last_tick_ts": self.last_tick_ts,
            }

    def set_dry_run(self, dry_run: bool) -> None:
        """Flip shadow mode. Guard state carries over — arming after a
        shadow soak keeps the learned streaks and cooldowns."""
        with self._lock:
            self.dry_run = bool(dry_run)

    # -- durability (control-plane journal snapshot section) -----------------

    def export_state(self) -> Dict[str, Any]:
        """Serialized guard state (streaks, per-rule cooldown clocks,
        rate-limit window) for the control-plane journal. Tuple keys are
        flattened to ``[key_parts, value]`` pairs for JSON."""
        with self._lock:
            return {
                "dry_run": self.dry_run,
                "streak": [
                    [list(k), int(v)] for k, v in sorted(self._streak.items())
                ],
                "last_action": [
                    [list(k), float(v)]
                    for k, v in sorted(self._last_action.items())
                ],
                "action_times": [float(t) for t in self._action_times],
            }

    def load_state(self, state: Dict[str, Any]) -> None:
        """Inverse of :meth:`export_state`; a restarted autopilot keeps
        its hysteresis so cooldowns survive a control-plane crash instead
        of refiring immediately. Tolerant of missing keys."""
        if not isinstance(state, dict):
            return
        with self._lock:
            if "dry_run" in state:
                self.dry_run = bool(state["dry_run"])
            self._streak = {
                tuple(k): int(v) for k, v in state.get("streak") or []
            }
            self._last_action = {
                tuple(k): float(v) for k, v in state.get("last_action") or []
            }
            self._action_times = deque(
                float(t) for t in state.get("action_times") or []
            )


# -- process-wide autopilot (the backend/router default) -----------------------

_autopilot: Optional[FleetAutopilot] = None
_autopilot_lock = threading.Lock()


def get_autopilot() -> FleetAutopilot:
    """The process autopilot: created on first use in dry-run (shadow)
    mode with no planes wired beyond the process singletons — arming and
    actuator wiring are deliberate, explicit steps."""
    global _autopilot
    with _autopilot_lock:
        if _autopilot is None:
            _autopilot = FleetAutopilot(dry_run=True)
        return _autopilot


def set_autopilot(autopilot: Optional[FleetAutopilot]) -> None:
    global _autopilot
    with _autopilot_lock:
        _autopilot = autopilot
