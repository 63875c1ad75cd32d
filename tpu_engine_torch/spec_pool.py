"""Fleet-level speculative decoding pools: draft tenants, paired
draft/verify routing, acceptance-aware spill. Port of
``tpu_engine/spec_pool.py``: host-side control code, JAX's names, messages,
defaults and metric families, over this package's planes.

The engine already speaks speculative decoding (``serving.speculative_round``
drives draft-propose / batched-verify over the whole slot pool, and
``benchmarks/spec_decode_distill.py`` produces drafts with a measured α),
but nothing at fleet level *serves* drafts — the per-replica win never
reached tokens/sec/chip at fleet scale. This module closes that gap the
same way :mod:`tpu_engine_torch.disagg` closed prefill/decode:

- **Draft models are first-class scheduler tenants.** A draft pool is an
  ordinary ``workload="serving"`` :class:`~tpu_engine_torch.serving_fleet.
  ServingFleet` whose spec carries ``pool_role="draft"``; placement goes
  through ``plan_serving_pool(role="draft")``, which ranks layouts by
  draft-propose latency (γ *sequential* memory-bound decode steps) and
  tie-breaks toward single chips — drafts are tiny and exist to backfill
  the fragmented HBM headroom the verify pools leave behind, which callers
  express by passing that fragmented headroom as the plan's HBM filter.
  ``estimate_serving_hbm(draft_model_name=..., device_budget_gib=...)``
  sizes a colocated draft (weights + a second KV pool) and raises a
  structured :class:`~tpu_engine_torch.hbm_estimate.SpecHBMOversubscribed` when
  the headroom is a lie.
- **Paired routing.** :class:`SpecServingFleet` owns the request plane:
  each request rides a draft-propose leg (the draft pool generates the
  greedy continuation — the proposal) and then a target-verify leg on the
  verify pool, whose stream is authoritative — the emitted tokens are the
  target model's own, so speculation can never change output, only speed.
  Acceptance is the longest common prefix between proposal and target
  stream — the same accept rule ``speculative_round`` applies per round,
  measured per request, folded into a per-tenant EMA and fed to the
  historian as the ``serving.spec.accept_rate`` series.
- **Acceptance-aware spill.** :class:`SpecSpillController` closes the
  control loop as the autopilot does: a historian range query per tenant, sustained
  α below the floor across consecutive consults + per-tenant cooldown →
  an audited :class:`~tpu_engine_torch.autopilot.DecisionRecord` that spills the
  tenant back to plain chunked decode (requests skip the draft leg). A bad
  draft can therefore never make serving slower than the non-speculative
  baseline for long. Spilled tenants keep sending every Nth request down
  the draft leg as a **canary probe**; a recovered α (floor + margin,
  same sustain) fires a restore decision and re-enables speculation.
- **Prefix-plane hygiene.** Draft replicas that vanish (preempt, migrate,
  scale-down) get their prefix-cache entries dropped from the attached
  :class:`~tpu_engine_torch.prefix_plane.PrefixPlane` — a migrated draft must
  not leave stale cache hints pointing at a replica that no longer holds
  its KV.

Always-rendered observability: module-level counters/gauges surface as
``tpu_engine_spec_pool_*`` Prometheus families via
``backend/routers/metrics.py`` (zero before first use — same contract as
the prefix plane)."""

from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from tpu_engine_torch.autopilot import DecisionRecord
from tpu_engine_torch.scheduler import FleetScheduler, JobPriority
from tpu_engine_torch.serving_fleet import (
    ReplicaAutoscaler,
    ServingFleet,
    ServingReplicaSpec,
    build_replica_engine,
)

__all__ = [
    "SpecServingFleet",
    "SpecSpillConfig",
    "SpecSpillController",
    "spec_pool_stats",
]


# ---------------------------------------------------------------------------
# Always-rendered observability plane (backend/routers/metrics.py)
# ---------------------------------------------------------------------------

_STATS_LOCK = threading.Lock()
_STATS: Dict[str, float] = {
    "requests_total": 0,
    "draft_legs_total": 0,
    "verify_legs_total": 0,
    "plain_legs_total": 0,
    "canary_probes_total": 0,
    "accepted_tokens_total": 0,
    "proposed_tokens_total": 0,
    "spills_total": 0,
    "restores_total": 0,
    "spill_decisions_total": 0,
    "draft_cache_invalidations_total": 0,
    # Gauges: the most recent fleet snapshot (one live fleet per process
    # in practice; the twin installs its own and restores after).
    "tenants_total": 0,
    "tenants_spilled": 0,
}


def spec_pool_stats() -> Dict[str, float]:
    """Snapshot of the plane's monotonic counters + last-seen gauges."""
    with _STATS_LOCK:
        return dict(_STATS)


def _reset_stats_for_tests() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _bump(**deltas: float) -> None:
    with _STATS_LOCK:
        for k, d in deltas.items():
            _STATS[k] += d


def _gauge(**values: float) -> None:
    with _STATS_LOCK:
        _STATS.update(values)


# ---------------------------------------------------------------------------
# Acceptance-aware spill: an audited rule, as the autopilot's
# ---------------------------------------------------------------------------

RULES = ("spill_low_acceptance", "restore_speculation")
SUPPRESSION_REASONS = ("trend-not-sustained", "cooldown-active", "no-data")


@dataclass(frozen=True)
class SpecSpillConfig:
    """Policy constants for the acceptance spill rule. Floors/margins are
    acceptance rates in [0, 1]: α below ``accept_floor`` sustained for
    ``sustain_consults`` consults spills the tenant to plain decode; a
    spilled tenant's canary α above ``accept_floor + recover_margin`` for
    the same sustain restores it. The margin IS the hysteresis band — a
    tenant hovering at the floor cannot flap."""

    accept_floor: float = 0.35
    recover_margin: float = 0.15
    window_s: float = 60.0
    sustain_consults: int = 3
    cooldown_s: float = 120.0
    # Every Nth request of a spilled tenant still rides the draft leg so
    # α keeps getting measured (otherwise a spill would be forever).
    canary_every: int = 8
    max_decisions: int = 512


def _default_ids() -> Callable[[], str]:
    counter = itertools.count(1)
    return lambda: f"spd-{next(counter):06d}"


class SpecSpillController:
    """Sustained-α spill/restore over historian range queries.

    One consult per tenant per :meth:`consult` call: query the tenant's
    ``serving.spec.accept_rate`` series over ``window_s``, advance the
    per-tenant streak, and fire (or record as suppressed — every consult
    that *could* fire leaves an audited :class:`DecisionRecord`, the
    autopilot's contract) when the streak reaches ``sustain_consults`` outside the
    per-tenant cooldown. The controller owns only the spilled-set; the
    fleet reads :meth:`is_spilled` at routing time."""

    def __init__(
        self,
        historian: Any,
        config: Optional[SpecSpillConfig] = None,
        *,
        series: str = "serving.spec.accept_rate",
        clock: Callable[[], float] = time.time,
    ):
        self.historian = historian
        self.cfg = config or SpecSpillConfig()
        self.series = series
        self.clock = clock
        self._next_id = _default_ids()
        self._spilled: set[str] = set()
        self._streak: Dict[str, int] = {}
        self._last_fired: Dict[str, float] = {}
        self.decisions: collections.deque[DecisionRecord] = collections.deque(
            maxlen=self.cfg.max_decisions)

    # -- read side -----------------------------------------------------------

    def is_spilled(self, tenant: str) -> bool:
        return tenant in self._spilled

    def spilled(self) -> List[str]:
        return sorted(self._spilled)

    # -- consult -------------------------------------------------------------

    def _record(self, rule: str, tenant: str, now: float,
                inputs: Dict[str, Any], action: Optional[Dict[str, Any]],
                suppressed: Optional[str]) -> DecisionRecord:
        cool = max(0.0, self.cfg.cooldown_s -
                   (now - self._last_fired.get(tenant, -1e18)))
        rec = DecisionRecord(
            decision_id=self._next_id(),
            ts=round(float(now), 3),
            rule=rule,
            target=tenant,
            inputs=inputs,
            hysteresis={
                "streak": self._streak.get(tenant, 0),
                "required": self.cfg.sustain_consults,
                "cooldown_remaining_s": round(cool, 3),
            },
            action=action,
            suppressed_reason=suppressed,
            outcome="suppressed" if suppressed else "fired",
        )
        self.decisions.append(rec)
        _bump(spill_decisions_total=1)
        return rec

    def _consult_tenant(self, tenant: str, now: float) -> None:
        cfg = self.cfg
        q = self.historian.query(
            self.series, now - cfg.window_s, now, agg="avg",
            labels={"tenant": tenant},
        )
        alpha, count = q.get("value"), int(q.get("count") or 0)
        inputs = {
            "queries": [{
                "series": self.series, "tenant": tenant, "agg": "avg",
                "window_s": cfg.window_s,
                "value": None if alpha is None else round(float(alpha), 4),
                "count": count,
            }],
            "evidence": {
                "accept_floor": cfg.accept_floor,
                "recover_margin": cfg.recover_margin,
                "spilled": tenant in self._spilled,
            },
        }
        spilled = tenant in self._spilled
        rule = "restore_speculation" if spilled else "spill_low_acceptance"
        if alpha is None or count == 0:
            # No evidence either way: freeze the streak (a tenant that
            # went quiet must neither spill nor recover on silence).
            if self._streak.get(tenant, 0) > 0:
                self._record(rule, tenant, now, inputs, None, "no-data")
            return
        alpha = float(alpha)
        breach = (alpha > cfg.accept_floor + cfg.recover_margin) if spilled \
            else (alpha < cfg.accept_floor)
        if not breach:
            self._streak[tenant] = 0
            return
        self._streak[tenant] = self._streak.get(tenant, 0) + 1
        if self._streak[tenant] < cfg.sustain_consults:
            self._record(rule, tenant, now, inputs, None,
                         "trend-not-sustained")
            return
        if now - self._last_fired.get(tenant, -1e18) < cfg.cooldown_s:
            self._record(rule, tenant, now, inputs, None, "cooldown-active")
            return
        verb = "restore" if spilled else "spill"
        self._record(rule, tenant, now, inputs,
                     {"verb": verb, "tenant": tenant,
                      "alpha": round(alpha, 4)}, None)
        self._last_fired[tenant] = now
        self._streak[tenant] = 0
        if spilled:
            self._spilled.discard(tenant)
            _bump(restores_total=1)
        else:
            self._spilled.add(tenant)
            _bump(spills_total=1)

    def consult(self, tenants: List[str],
                now: Optional[float] = None) -> List[str]:
        """One consult pass over ``tenants``; returns the spilled set."""
        now = self.clock() if now is None else float(now)
        for t in tenants:
            self._consult_tenant(t, now)
        _gauge(tenants_total=len(set(tenants) | self._spilled),
               tenants_spilled=len(self._spilled))
        return self.spilled()

    def status(self) -> Dict[str, Any]:
        return {
            "spilled": self.spilled(),
            "streaks": dict(self._streak),
            "decisions_total": len(self.decisions),
            "fired_total": sum(
                1 for d in self.decisions if d.outcome == "fired"),
            "config": {
                "accept_floor": self.cfg.accept_floor,
                "recover_margin": self.cfg.recover_margin,
                "window_s": self.cfg.window_s,
                "sustain_consults": self.cfg.sustain_consults,
                "cooldown_s": self.cfg.cooldown_s,
                "canary_every": self.cfg.canary_every,
            },
        }

    # -- durability (control-plane journal snapshot section) -----------------

    def export_state(self) -> Dict[str, Any]:
        """Serialized guard state (spilled set, streaks, cooldown clocks)
        for the control-plane journal; restored via :meth:`load_state` so
        a restarted controller keeps its hysteresis instead of re-spilling
        every tenant from scratch."""
        return {
            "spilled": self.spilled(),
            "streak": {t: int(n) for t, n in sorted(self._streak.items())},
            "last_fired": {
                t: float(ts) for t, ts in sorted(self._last_fired.items())
            },
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        """Inverse of :meth:`export_state`; tolerant of missing keys."""
        if not isinstance(state, dict):
            return
        self._spilled = {str(t) for t in state.get("spilled") or []}
        self._streak = {
            str(t): int(n) for t, n in (state.get("streak") or {}).items()
        }
        self._last_fired = {
            str(t): float(ts)
            for t, ts in (state.get("last_fired") or {}).items()
        }


# ---------------------------------------------------------------------------
# The paired fleet
# ---------------------------------------------------------------------------

_PENDING_PHASES = ("queued", "drafting")


@dataclass
class _TenantState:
    """Per-tenant acceptance bookkeeping (EMA + canary rotation)."""

    ema: Optional[float] = None
    requests: int = 0
    accepted_tokens: int = 0
    proposed_tokens: int = 0
    canary_seq: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)


class SpecServingFleet:
    """Draft pool + verify pool + the acceptance plane between them.

    Each pool is a full :class:`ServingFleet` (scheduler-tenant replicas,
    per-pool HBM admission through ``estimate_serving_hbm(pool_role=...)``,
    its own router and autoscaler). This object owns the REQUEST plane:
    route the draft-propose leg to a draft replica, collect the proposal,
    route the target-verify leg to a verify replica, emit ITS stream (the
    target model's own tokens — speculation is a latency optimization,
    never a correctness change), and score acceptance as the longest
    common prefix of proposal and target stream. Per-tenant α EMAs feed
    the historian; the attached :class:`SpecSpillController` spills
    sustained-low-α tenants back to plain decode (draft leg skipped) with
    canary probes for recovery."""

    def __init__(
        self,
        scheduler: FleetScheduler,
        verify_spec: ServingReplicaSpec,
        draft_spec: ServingReplicaSpec,
        verify_autoscaler: Optional[ReplicaAutoscaler] = None,
        draft_autoscaler: Optional[ReplicaAutoscaler] = None,
        priority: JobPriority = JobPriority.NORMAL,
        submitter: str = "spec-serving",
        engine_factory: Callable[[ServingReplicaSpec], Any] = build_replica_engine,
        latency_window: int = 512,
        max_redispatch: int = 8,
        historian: Any = None,
        spill: Optional[SpecSpillController] = None,
        spill_config: Optional[SpecSpillConfig] = None,
        prefix_plane: Any = None,
        spec_gamma: int = 4,
        accept_ema_beta: float = 0.25,
        clock: Callable[[], float] = time.time,
    ):
        verify_spec = verify_spec.model_copy(update={"pool_role": "decode"})
        draft_spec = draft_spec.model_copy(update={"pool_role": "draft"})
        self.verify = ServingFleet(
            scheduler, verify_spec, autoscaler=verify_autoscaler,
            priority=priority, submitter=f"{submitter}-verify",
            engine_factory=engine_factory, latency_window=latency_window,
        )
        self.draft = ServingFleet(
            scheduler, draft_spec, autoscaler=draft_autoscaler,
            priority=priority, submitter=f"{submitter}-draft",
            engine_factory=engine_factory, latency_window=latency_window,
            prefix_plane=prefix_plane,
        )
        self.prefix_plane = prefix_plane
        self.spec_gamma = max(int(spec_gamma), 1)
        self.accept_ema_beta = float(accept_ema_beta)
        self.max_redispatch = int(max_redispatch)
        self.clock = clock
        self.historian = historian
        if spill is not None:
            self.spill = spill
        elif historian is not None:
            self.spill = SpecSpillController(
                historian, spill_config, clock=clock)
        else:
            self.spill = None

        self._lock = threading.RLock()
        self._requests: dict[str, dict[str, Any]] = {}
        self._req_seq = 0
        self._tenants: Dict[str, _TenantState] = {}
        self._draft_sids_seen: set[str] = set()
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=latency_window)
        self.requests_total = 0
        self.completed_total = 0
        self.failed_total = 0
        self.tokens_total = 0
        self.draft_legs_total = 0
        self.plain_legs_total = 0
        self.redispatches_total = 0

    # -- pool lifecycle ------------------------------------------------------

    def start(self) -> None:
        self.verify.start()
        self.draft.start()

    def stop(self) -> None:
        self.draft.stop()
        self.verify.stop()

    # -- request plane -------------------------------------------------------

    def submit_request(
        self,
        prompt: list[int],
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        tenant: str = "default",
    ) -> str:
        with self._lock:
            self._req_seq += 1
            fid = f"sreq_{self._req_seq}"
            self.requests_total += 1
            _bump(requests_total=1)
            ts = self._tenants.setdefault(tenant, _TenantState())
            ts.requests += 1
            speculate = True
            canary = False
            if self.spill is not None and self.spill.is_spilled(tenant):
                ts.canary_seq += 1
                every = self.spill.cfg.canary_every
                canary = every > 0 and ts.canary_seq % every == 0
                speculate = canary
                if canary:
                    _bump(canary_probes_total=1)
            self._requests[fid] = {
                "prompt": list(prompt),
                "max_new_tokens": int(max_new_tokens),
                "temperature": float(temperature),
                "tenant": tenant,
                "speculate": speculate,
                "canary": canary,
                "phase": "queued",
                "draft_sid": None, "draft_rid": None,
                "verify_sid": None, "verify_rid": None,
                "proposal": [],
                "submitted_at": self.clock(),
                "redispatches": 0,
                "tokens": [], "error": None,
            }
            self._pump_locked()
            return fid

    def _requeue_locked(self, fid: str, r: dict[str, Any],
                        reason: str) -> None:
        """Replica loss at any phase: both legs are re-derivable from the
        prompt (greedy determinism), so retry-from-scratch is the correct
        recovery — same contract as disagg's re-prefill."""
        r["redispatches"] += 1
        self.redispatches_total += 1
        if r["redispatches"] > self.max_redispatch:
            r["phase"] = "failed"
            r["error"] = (
                f"gave up after {self.max_redispatch} re-dispatches: {reason}")
            self.failed_total += 1
            return
        r.update(phase="queued", draft_sid=None, draft_rid=None,
                 verify_sid=None, verify_rid=None, proposal=[])

    def _finish_locked(self, fid: str, r: dict[str, Any],
                       tokens: list[int]) -> None:
        r["tokens"] = tokens
        r["phase"] = "done"
        self.completed_total += 1
        self.tokens_total += len(tokens)
        self._latencies.append((self.clock() - r["submitted_at"]) * 1000.0)

    def _score_locked(self, r: dict[str, Any], target: list[int]) -> None:
        """Acceptance for one request: longest common prefix of the draft
        proposal and the authoritative target stream — the per-request
        analogue of ``speculative_round``'s accept rule — folded into the
        tenant EMA and recorded to the historian."""
        proposal = list(r["proposal"])
        if not proposal:
            return
        accepted = 0
        for a, b in zip(proposal, target):
            if a != b:
                break
            accepted += 1
        ts = self._tenants.setdefault(r["tenant"], _TenantState())
        ts.accepted_tokens += accepted
        ts.proposed_tokens += len(proposal)
        alpha = accepted / len(proposal)
        ts.ema = alpha if ts.ema is None else (
            self.accept_ema_beta * alpha
            + (1.0 - self.accept_ema_beta) * ts.ema)
        _bump(accepted_tokens_total=accepted,
              proposed_tokens_total=len(proposal))
        if self.historian is not None:
            self.historian.record(
                "serving.spec.accept_rate", round(ts.ema, 6),
                ts=self.clock(), labels={"tenant": r["tenant"]},
            )

    def _invalidate_lost_drafts_locked(
            self, draft_engines: dict[str, Any]) -> None:
        """Prefix-plane hygiene: any draft replica that vanished since the
        last pump (preempt / migrate / scale-down) must drop its cache
        entries — stale hints would route prompts at KV that moved."""
        live = set(draft_engines)
        lost = self._draft_sids_seen - live
        for sid in lost:
            if self.prefix_plane is not None:
                try:
                    self.prefix_plane.drop_replica(sid)
                except Exception:  # noqa: BLE001 — hygiene must not wedge
                    pass
            _bump(draft_cache_invalidations_total=1)
        self._draft_sids_seen = live

    def _pump_locked(self) -> None:
        """Advance every request's phase machine one notch. All engine
        calls are non-blocking (replica threads do the device work)."""
        draft_engines = self.draft.running_replicas()
        verify_engines = self.verify.running_replicas()
        self._invalidate_lost_drafts_locked(draft_engines)
        stats_of = ServingFleet._engine_router_stats
        self.draft.router.update(
            {sid: stats_of(e) for sid, e in draft_engines.items()})
        self.verify.router.update(
            {sid: stats_of(e) for sid, e in verify_engines.items()})

        for fid, r in self._requests.items():
            if r["phase"] == "queued":
                if not r["speculate"]:
                    # Spilled tenant (non-canary): plain chunked decode.
                    sid = self.verify.router.route(r["prompt"])
                    if sid is None or sid not in verify_engines:
                        continue
                    try:
                        rid = verify_engines[sid].submit(
                            r["prompt"],
                            max_new_tokens=r["max_new_tokens"],
                            temperature=r["temperature"],
                        )
                    except Exception:  # engine died under us — next pump
                        continue
                    r["verify_sid"], r["verify_rid"] = sid, rid
                    r["phase"] = "verifying"
                    self.plain_legs_total += 1
                    _bump(plain_legs_total=1, verify_legs_total=1)
                    continue
                sid = self.draft.router.route(r["prompt"])
                if sid is None or sid not in draft_engines:
                    continue
                try:
                    rid = draft_engines[sid].submit(
                        r["prompt"],
                        max_new_tokens=min(
                            self.spec_gamma, r["max_new_tokens"]),
                        temperature=r["temperature"],
                    )
                except Exception:
                    continue
                r["draft_sid"], r["draft_rid"] = sid, rid
                r["phase"] = "drafting"
                self.draft_legs_total += 1
                _bump(draft_legs_total=1)

            elif r["phase"] == "drafting":
                eng = draft_engines.get(r["draft_sid"])
                if eng is None:
                    self._requeue_locked(fid, r, "draft replica lost")
                    continue
                try:
                    out = eng.result(r["draft_rid"])
                except KeyError:
                    self._requeue_locked(fid, r, "draft engine forgot request")
                    continue
                if out.get("status") == "failed":
                    self._requeue_locked(fid, r, "draft engine drained")
                    continue
                if out.get("status") != "done":
                    continue
                r["proposal"] = list(out.get("tokens", []))
                sid = self.verify.router.route(r["prompt"])
                if sid is None or sid not in verify_engines:
                    continue  # proposal waits host-side for a verify slot
                try:
                    rid = verify_engines[sid].submit(
                        r["prompt"],
                        max_new_tokens=r["max_new_tokens"],
                        temperature=r["temperature"],
                    )
                except Exception:
                    continue
                r["verify_sid"], r["verify_rid"] = sid, rid
                r["phase"] = "verifying"
                _bump(verify_legs_total=1)

            elif r["phase"] == "verifying":
                eng = verify_engines.get(r["verify_sid"])
                if eng is None:
                    self._requeue_locked(fid, r, "verify replica lost")
                    continue
                try:
                    out = eng.result(r["verify_rid"])
                except KeyError:
                    self._requeue_locked(
                        fid, r, "verify engine forgot request")
                    continue
                if out.get("status") == "failed":
                    self._requeue_locked(fid, r, "verify engine drained")
                    continue
                if out.get("status") == "done":
                    target = list(out.get("tokens", []))
                    self._score_locked(r, target)
                    self._finish_locked(fid, r, target)

    def result(self, fid: str) -> dict[str, Any]:
        with self._lock:
            r = self._requests.get(fid)
            if r is None:
                raise KeyError(fid)
            self._pump_locked()
            out: dict[str, Any] = {
                "id": fid,
                "phase": r["phase"],
                "tenant": r["tenant"],
                "speculated": bool(r["speculate"]),
                "canary": bool(r["canary"]),
                "draft_replica": r["draft_sid"],
                "verify_replica": r["verify_sid"],
                "redispatches": r["redispatches"],
            }
            if r["phase"] == "done":
                out["status"] = "done"
                out["tokens"] = list(r["tokens"])
            elif r["phase"] == "failed":
                out["status"] = "failed"
                out["error"] = r["error"]
                out["tokens"] = list(r["tokens"])
            else:
                out["status"] = ("running" if r["phase"] == "verifying"
                                 else "pending")
                out["tokens"] = []
            return out

    def wait(self, fid: str, timeout: float = 60.0,
             poll_s: float = 0.005) -> dict[str, Any]:
        deadline = time.time() + timeout
        while True:
            out = self.result(fid)
            if out["status"] in ("done", "failed"):
                return out
            if time.time() >= deadline:
                raise TimeoutError(f"request {fid} not done in {timeout}s")
            time.sleep(poll_s)

    # -- control loop --------------------------------------------------------

    def _pct(self, vals: collections.deque, q: float) -> Optional[float]:
        if not vals:
            return None
        s = sorted(vals)
        return round(s[min(int(q * (len(s) - 1)), len(s) - 1)], 2)

    def _pool_depths_locked(self) -> tuple[int, int]:
        """(draft-side, verify-side) demand — the two SEPARATE autoscaler
        signals: requests waiting on each pool's legs."""
        draft_depth = sum(
            1 for r in self._requests.values()
            if r["phase"] in _PENDING_PHASES and r["speculate"])
        verify_depth = sum(
            1 for r in self._requests.values()
            if r["phase"] == "verifying"
            or (r["phase"] == "queued" and not r["speculate"]))
        return draft_depth, verify_depth

    def _drive_pool(self, pool: ServingFleet, now: float, depth: int,
                    p99: Optional[float]) -> None:
        n_running = len(pool.running_replicas())
        desired = pool.autoscaler.observe(now, depth, p99, n_running)
        if desired > pool.desired_replicas:
            pool.scale_ups_total += 1
            pool.scale_to(desired)
        elif desired < pool.desired_replicas and \
                n_running >= pool.desired_replicas:
            pool.scale_downs_total += 1
            pool.scale_to(desired)

    def tick(self, now: Optional[float] = None) -> dict[str, Any]:
        """One control pass: pump the phase machine, consult the spill
        controller over every tenant with evidence, then scale each pool
        on ITS signal — draft on draft-leg depth, verify on verify-leg
        depth + end-to-end p99."""
        now = self.clock() if now is None else float(now)
        with self._lock:
            self._pump_locked()
            if self.spill is not None:
                self.spill.consult(
                    [t for t, s in self._tenants.items()
                     if s.proposed_tokens > 0], now)
            draft_depth, verify_depth = self._pool_depths_locked()
            p99 = self._pct(self._latencies, 0.99)
            self._drive_pool(self.draft, now, draft_depth, None)
            self._drive_pool(self.verify, now, verify_depth, p99)
        return self.status()

    def tenant_accept_rates(self) -> Dict[str, Optional[float]]:
        with self._lock:
            return {t: (None if s.ema is None else round(s.ema, 4))
                    for t, s in self._tenants.items()}

    def status(self) -> dict[str, Any]:
        with self._lock:
            pending = sum(1 for r in self._requests.values()
                          if r["phase"] in _PENDING_PHASES)
            verifying = sum(1 for r in self._requests.values()
                            if r["phase"] == "verifying")
            out = {
                "requests_total": self.requests_total,
                "completed_total": self.completed_total,
                "failed_total": self.failed_total,
                "tokens_total": self.tokens_total,
                "draft_legs_total": self.draft_legs_total,
                "plain_legs_total": self.plain_legs_total,
                "redispatches_total": self.redispatches_total,
                "pending_requests": pending,
                "verifying_requests": verifying,
                "p99_latency_ms": self._pct(self._latencies, 0.99),
                "spec_gamma": self.spec_gamma,
                "tenants": {
                    t: {
                        "accept_ema": (None if s.ema is None
                                       else round(s.ema, 4)),
                        "requests": s.requests,
                        "accepted_tokens": s.accepted_tokens,
                        "proposed_tokens": s.proposed_tokens,
                        "spilled": (self.spill is not None
                                    and self.spill.is_spilled(t)),
                    } for t, s in sorted(self._tenants.items())
                },
                "draft_pool": self.draft.status(),
                "verify_pool": self.verify.status(),
            }
            if self.spill is not None:
                out["spill"] = self.spill.status()
            return out
