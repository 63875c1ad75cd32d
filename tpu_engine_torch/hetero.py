"""Heterogeneity plane: throughput-weighted data sharding for uneven gangs
(port of ``tpu_engine/hetero.py``).

The synchronous gang assumes uniform chips: ``data.py`` splits every step's
``[accum, global_micro]`` batch into equal per-process rows, so one degraded
host (thermal throttle, flaky ICI link, mixed-generation slice) drags the
whole step to its speed — and the only remedy used to be
``elastic_shrink_plan``, which throws the slow-but-healthy host away
entirely. Poplar (arXiv 2408.12596) shows that assigning *non-uniform*
per-device batch proportional to measured throughput recovers near-ideal
goodput on heterogeneous fleets; ZeRO-Infinity-style capacity reasoning
(arXiv 2104.07857) is the constraint — uneven batch means uneven activation
HBM, so every candidate assignment must stay inside each device's envelope
(``hbm_estimate.estimate_job_hbm`` re-run at the per-process micro batch).

Three layers, smallest first:

- :class:`ThroughputTracker` — per-process relative-throughput EMA over
  profiler step timings, *seeded* by the flight recorder's sustained
  host-slow attribution (the supervisor's anomaly path and the ``faults.py``
  host-slow seam both feed it) and *decaying* back toward 1.0 every quiet
  step so transient stalls heal instead of permanently skewing the split.
- :func:`solve_row_assignment` — integer apportionment (largest-remainder)
  of the global micro batch proportional to throughput, subject to a
  minimum-rows floor and optional per-process row caps (HBM feasibility),
  preserving the declared global batch **exactly** — the sum invariant is
  property-tested, never "approximately right".
- :class:`HeteroRebalancer` — the hysteresis-guarded policy loop the
  supervisor consults: never more than one rebalance per cooldown window,
  only on sustained imbalance, only when the predicted goodput gain clears
  a floor, dry-run mode by default, and every decision (acted, dry-run, or
  skipped) is audited on the flight recorder.

Consumers: the supervisor (periodic consult + ``data_fn.reassign``). The
dry-run detector runs at every world size; a live plan that assigns
unequal rows on a mesh meets ``tpu_engine_torch/data.py``'s refusal
(the train step takes one row count on every rank).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from tpu_engine_torch import tracing

# A relative throughput below this is treated as this (a host reporting
# ~zero throughput is dying, not slow — shrink/self-heal owns that case,
# and the apportionment must never divide by zero or starve the gang).
MIN_RELATIVE_THROUGHPUT = 0.05


class InfeasibleAssignment(ValueError):
    """No integer assignment satisfies the floor/cap constraints exactly."""



# -- pure apportionment -------------------------------------------------------


def uniform_assignment(total_rows: int, n: int) -> list[int]:
    """The equal split (remainder spread over the first processes) —
    the implicit assignment every gang starts from."""
    if n <= 0:
        raise ValueError(f"need at least one process, got {n}")
    base, rem = divmod(int(total_rows), n)
    return [base + (1 if i < rem else 0) for i in range(n)]


def solve_row_assignment(
    throughputs: Sequence[float],
    total_rows: int,
    *,
    min_rows: int = 1,
    max_rows: Optional[Sequence[Optional[int]]] = None,
) -> list[int]:
    """Integer per-process rows proportional to ``throughputs``.

    Largest-remainder apportionment with a per-process floor (``min_rows``)
    and optional per-process caps (``max_rows``, ``None`` = uncapped — the
    HBM-feasibility hook). The result always sums to ``total_rows`` exactly;
    when floors and caps make that impossible, :class:`InfeasibleAssignment`
    is raised rather than silently changing the declared global batch.
    Deterministic: ties break by lowest process index.
    """
    n = len(throughputs)
    if n <= 0:
        raise ValueError("throughputs must be non-empty")
    total = int(total_rows)
    if total < n * min_rows:
        raise InfeasibleAssignment(
            f"{total} rows cannot give {n} processes the {min_rows}-row floor"
        )
    caps = [
        total if (max_rows is None or max_rows[i] is None) else int(max_rows[i])
        for i in range(n)
    ]
    if any(c < min_rows for c in caps):
        raise InfeasibleAssignment(
            f"per-process row cap below the {min_rows}-row floor: {caps}"
        )
    if sum(caps) < total:
        raise InfeasibleAssignment(
            f"row caps {caps} sum to {sum(caps)} < global micro batch {total}"
        )
    w = [max(float(t), MIN_RELATIVE_THROUGHPUT) for t in throughputs]
    sw = sum(w)
    quotas = [total * wi / sw for wi in w]
    rows = [min(max(int(math.floor(q)), min_rows), caps[i]) for i, q in enumerate(quotas)]

    # Top up by largest fractional remainder (classic largest-remainder),
    # then drain by most-over-quota — both loops terminate because the
    # feasible region is non-empty (checked above) and every iteration
    # moves sum(rows) one row toward total.
    while sum(rows) < total:
        i = max(
            (i for i in range(n) if rows[i] < caps[i]),
            key=lambda i: (quotas[i] - rows[i], -i),
        )
        rows[i] += 1
    while sum(rows) > total:
        i = max(
            (i for i in range(n) if rows[i] > min_rows),
            key=lambda i: (rows[i] - quotas[i], -i),
        )
        rows[i] -= 1
    return rows


def predicted_goodput(
    assignment: Sequence[int], throughputs: Sequence[float]
) -> float:
    """Fraction of ideal gang throughput this assignment achieves.

    The synchronous step is gated by the slowest process
    (``max_i rows_i / rate_i``); the ideal is the work-conserving bound
    ``total_rows / sum(rate)``. Unit-free — per-row seconds cancel.
    """
    rates = [max(float(t), MIN_RELATIVE_THROUGHPUT) for t in throughputs]
    total = sum(int(r) for r in assignment)
    if total <= 0:
        return 0.0
    actual = max(int(r) / rate for r, rate in zip(assignment, rates))
    if actual <= 0:
        return 1.0
    return (total / sum(rates)) / actual


def hbm_max_rows_fn(
    config: Any,
    n_processes: int,
    hbm_budget_gib: float,
    *,
    estimate_fn: Optional[Callable[..., Any]] = None,
    margin_frac: float = 0.10,
) -> Callable[[int, int], Optional[int]]:
    """Per-process HBM row caps for :func:`solve_row_assignment`.

    Uneven rows mean uneven activation/logit HBM: a process holding
    ``rows`` of the uniform split's ``rows_u`` runs an effective micro
    batch of ``micro × rows / rows_u``, and the estimate must be re-run at
    that batch (ZeRO-Infinity-style capacity reasoning). Returns
    ``max_rows(process_index, rows_uniform) -> cap`` computed by binary
    search over the monotone estimate; ``None`` when the estimator cannot
    price the config (caller then skips the HBM gate, as admission did).
    """
    if estimate_fn is None:
        from tpu_engine_torch.hbm_estimate import estimate_job_hbm

        estimate_fn = estimate_job_hbm
    budget = float(hbm_budget_gib) / (1.0 + margin_frac)
    micro = int(getattr(config, "micro_batch_size", 0) or 0)

    def _fits(rows: int, rows_u: int) -> Optional[bool]:
        eff = max(int(math.ceil(micro * rows / max(rows_u, 1))), 1)
        try:
            est = estimate_fn(dataclasses.replace(config, micro_batch_size=eff))
        except Exception:
            return None
        if est is None:
            return None
        return float(est.device_total_gib) <= budget

    def max_rows(process_index: int, rows_uniform: int) -> Optional[int]:
        if micro <= 0 or rows_uniform <= 0:
            return None
        if _fits(1, rows_uniform) is not True:
            # Even one row does not provably fit (or the estimator cannot
            # price it) — report "no cap known" rather than an impossible 0.
            return None
        lo, hi = 1, max(rows_uniform * n_processes, 1)
        if _fits(hi, rows_uniform):
            return hi
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if _fits(mid, rows_uniform):
                lo = mid
            else:
                hi = mid
        return lo

    return max_rows


# -- throughput tracking ------------------------------------------------------


class ThroughputTracker:
    """Per-process relative-throughput EMA with decay-to-healthy.

    ``1.0`` means full speed; a sustained host-slow signal pulls the slow
    process's estimate down toward ``baseline / (baseline + penalty)``;
    every quiet observed step relaxes all *unreinforced* estimates back
    toward 1.0 by ``decay`` — transient stalls heal, chronic ones persist.
    Thread-safe (the supervisor step loop and scheduler poll both read it).
    """

    def __init__(
        self,
        n_processes: int,
        *,
        alpha: float = 0.25,
        decay: float = 0.02,
    ):
        if n_processes <= 0:
            raise ValueError(f"n_processes must be positive, got {n_processes}")
        self.n_processes = int(n_processes)
        self.alpha = float(alpha)
        self.decay = float(decay)
        self._lock = threading.Lock()
        self._rel = [1.0 for _ in range(self.n_processes)]
        self._reinforced = [False for _ in range(self.n_processes)]
        self._baseline_s: Optional[float] = None
        self.steps_observed = 0
        self.slow_signals_total = 0
        self.attribution_seeds_total = 0

    def observe_step(self, duration_s: float) -> None:
        """One gang step: refresh the healthy-step baseline (EMA of the
        fastest recent steps) and decay every estimate that was not
        reinforced since the last observation."""
        dt = float(duration_s)
        if dt <= 0:
            return
        with self._lock:
            self.steps_observed += 1
            if self._baseline_s is None or dt < self._baseline_s:
                self._baseline_s = dt
            else:
                # Slow drift upward so a genuinely slower regime (bigger
                # batch after rebalance) re-baselines instead of reading
                # as a permanent anomaly.
                self._baseline_s = 0.98 * self._baseline_s + 0.02 * dt
            for i in range(self.n_processes):
                if self._reinforced[i]:
                    self._reinforced[i] = False
                else:
                    self._rel[i] += self.decay * (1.0 - self._rel[i])

    def note_host_slow(
        self,
        process_index: Optional[int],
        penalty_s: float,
        baseline_s: Optional[float] = None,
    ) -> None:
        """A host-slow signal (the ``faults.py`` seam or a real detector):
        the process ran at ``baseline / (baseline + penalty)`` speed."""
        pen = float(penalty_s)
        if pen <= 0:
            return
        with self._lock:
            base = float(baseline_s) if baseline_s else (self._baseline_s or pen)
            if base <= 0:
                return
            i = self._clamp_index(process_index)
            obs = max(base / (base + pen), MIN_RELATIVE_THROUGHPUT)
            self._rel[i] = (1 - self.alpha) * self._rel[i] + self.alpha * obs
            self._reinforced[i] = True
            self.slow_signals_total += 1

    def note_attribution(
        self,
        cause: str,
        anomaly: dict[str, Any],
        process_index: Optional[int] = None,
    ) -> None:
        """Seed from the flight recorder's step-anomaly attribution: a
        *sustained* anomaly blamed on host-slow means the gang is running
        at ``baseline_s / duration_s`` of its healthy speed."""
        if cause != "host-slow" or not anomaly.get("sustained"):
            return
        dur = float(anomaly.get("duration_s") or 0.0)
        base = float(anomaly.get("baseline_s") or 0.0)
        if dur <= base or base <= 0:
            return
        with self._lock:
            i = self._clamp_index(process_index)
            obs = max(base / dur, MIN_RELATIVE_THROUGHPUT)
            self._rel[i] = (1 - self.alpha) * self._rel[i] + self.alpha * obs
            self._reinforced[i] = True
            self.attribution_seeds_total += 1

    def _clamp_index(self, process_index: Optional[int]) -> int:
        i = 0 if process_index is None else int(process_index)
        return min(max(i, 0), self.n_processes - 1)

    def relative_throughput(self) -> list[float]:
        with self._lock:
            return list(self._rel)

    def imbalance(self) -> float:
        """max/min relative throughput — 1.0 means a uniform gang."""
        with self._lock:
            lo = min(self._rel)
            return (max(self._rel) / lo) if lo > 0 else float("inf")

    def baseline_s(self) -> Optional[float]:
        with self._lock:
            return self._baseline_s

    def stats(self) -> dict[str, Any]:
        with self._lock:
            lo = min(self._rel)
            return {
                "n_processes": self.n_processes,
                "relative_throughput": [round(r, 4) for r in self._rel],
                "imbalance_ratio": round((max(self._rel) / lo) if lo > 0 else 0.0, 4),
                "baseline_step_s": self._baseline_s,
                "steps_observed": self.steps_observed,
                "slow_signals_total": self.slow_signals_total,
                "attribution_seeds_total": self.attribution_seeds_total,
            }


# -- per-host health ----------------------------------------------------------


def host_health(
    n_hosts: int,
    relative_throughput: Optional[Sequence[float]] = None,
    quarantined_devices: Sequence[int] = (),
    devices_per_host: int = 1,
    fault_counts: Optional[dict[int, int]] = None,
) -> list[float]:
    """Composite 0–1 health score per host.

    Folds the three degradation signals this plane already measures into
    one scalar the historian can retain and the autopilot can threshold:
    the tracker's relative-throughput EMA (clamped to [0, 1] — a host
    running *faster* than the gang is healthy, not >1 healthy), a 4×
    penalty while any of the host's devices sits in scheduler
    quarantine, and a per-recent-fault penalty (40% each, floored at
    0.2 so a flapping host stays visible instead of pinning to 0).
    Pure function: callers map devices to hosts and window the fault
    counts (``backend/routers/metrics.py`` uses the flight recorder's
    recent fleet fault events).
    """
    n_hosts = max(1, int(n_hosts))
    devices_per_host = max(1, int(devices_per_host))
    rel = list(relative_throughput or [])
    quarantined_hosts = {
        int(d) // devices_per_host for d in quarantined_devices
    }
    scores = []
    for h in range(n_hosts):
        score = min(1.0, max(0.0, rel[h] if h < len(rel) else 1.0))
        if h in quarantined_hosts:
            score *= 0.25
        faults = int((fault_counts or {}).get(h, 0))
        if faults > 0:
            score *= max(0.2, 1.0 - 0.4 * faults)
        scores.append(score)
    return scores


# -- rebalance policy ---------------------------------------------------------


@dataclass
class RebalancePlan:
    """One rebalance decision — what the audit event and the caller see."""

    step: int
    ts: float
    assignment: list[int]
    previous: list[int]
    throughputs: list[float]
    imbalance: float
    goodput_before: float
    goodput_after: float
    dry_run: bool
    reason: str = "imbalance"
    hbm_capped: list[int] = field(default_factory=list)

    def describe(self) -> dict[str, Any]:
        return {
            "step": self.step,
            "ts": self.ts,
            "assignment": list(self.assignment),
            "previous": list(self.previous),
            "throughputs": [round(t, 4) for t in self.throughputs],
            "imbalance": round(self.imbalance, 4),
            "goodput_before": round(self.goodput_before, 4),
            "goodput_after": round(self.goodput_after, 4),
            "dry_run": self.dry_run,
            "reason": self.reason,
            "hbm_capped": list(self.hbm_capped),
        }


def broadcast_agree_fn() -> Callable[[Sequence[float]], list[float]]:
    """Cross-process agreement hook for :class:`HeteroRebalancer`.

    Every process adopts process 0's throughput estimates before solving,
    so — together with step-keyed consults and a step-based cooldown —
    all ranks derive the identical assignment at the identical step and
    the per-process row windows can never overlap or gap. Identity on a
    single-process runtime; degrades to the process-local estimates (with
    one warning) when the collective is unavailable.
    """
    warned = [False]

    def agree(tput: Sequence[float]) -> list[float]:
        vals = [float(t) for t in tput]
        try:
            import torch.distributed as dist

            if not (dist.is_available() and dist.is_initialized()) \
                    or dist.get_world_size() <= 1:
                return vals
            out = [vals]
            dist.broadcast_object_list(out, src=0)
            return [float(x) for x in out[0]]
        except Exception:
            if not warned[0]:
                warned[0] = True
                import logging

                logging.getLogger(__name__).warning(
                    "hetero: cross-process broadcast unavailable; falling "
                    "back to process-local throughput estimates",
                    exc_info=True,
                )
            return vals

    return agree


class HeteroRebalancer:
    """Hysteresis-guarded rebalance loop over a :class:`ThroughputTracker`.

    ``maybe_rebalance`` is safe to call every step: it acts at most once
    per cooldown window (``cooldown_s`` wall-clock, or ``cooldown_steps``
    when set — the deterministic choice for multi-process gangs), only
    after ``sustain_consults`` consecutive consults propose a different
    split (a single noisy reading never moves the gang), and only when the
    predicted goodput gain clears ``min_gain``. ``dry_run=True`` (the
    default) evaluates and audits the decision without changing the live
    assignment — the supervisor flips it per job. Every path lands an
    audit event on the flight recorder.

    Cross-process agreement is *enforced*, not assumed: on multi-process
    runtimes the owner wires ``agree_fn`` (see :func:`broadcast_agree_fn`)
    so every rank solves from rank 0's estimates, consults happen at the
    same step on every rank (the supervisor's step-keyed modulo check),
    and ``cooldown_steps`` replaces wall-clock cooldown so no rank's clock
    skew can make it skip a consult its peers acted on. Out-of-band
    consult requests (:meth:`request_consult`, the scheduler's
    rebalance-over-shrink path) are therefore only honored between step
    boundaries on single-process runtimes.
    """

    def __init__(
        self,
        tracker: ThroughputTracker,
        global_micro: int,
        *,
        min_rows: int = 1,
        cooldown_s: float = 60.0,
        cooldown_steps: Optional[int] = None,
        imbalance_trigger: float = 1.15,
        min_gain: float = 0.03,
        sustain_consults: int = 2,
        dry_run: bool = True,
        max_rows_fn: Optional[Callable[[int, int], Optional[int]]] = None,
        agree_fn: Optional[Callable[[Sequence[float]], list[float]]] = None,
        clock: Callable[[], float] = time.time,
        recorder: Optional[Any] = None,
        trace_id: Optional[str] = None,
    ):
        self.tracker = tracker
        self.global_micro = int(global_micro)
        self.min_rows = int(min_rows)
        self.cooldown_s = float(cooldown_s)
        self.cooldown_steps = (
            None if cooldown_steps is None else int(cooldown_steps)
        )
        self.imbalance_trigger = float(imbalance_trigger)
        self.min_gain = float(min_gain)
        self.sustain_consults = int(sustain_consults)
        self.dry_run = bool(dry_run)
        self.max_rows_fn = max_rows_fn
        self.agree_fn = agree_fn
        self.clock = clock
        self._recorder = recorder
        self.trace_id = trace_id or "fleet"
        self._lock = threading.Lock()
        self.assignment = uniform_assignment(self.global_micro, tracker.n_processes)
        self.last_rebalance_at: Optional[float] = None
        self.last_rebalance_step: Optional[int] = None
        self.last_plan: Optional[RebalancePlan] = None
        self._pending = 0  # consecutive consults proposing a change
        self._consult_requested = False
        self.rebalances_total = 0
        self.dry_runs_total = 0
        self.reverts_total = 0
        self.consults_total = 0
        self.skips: dict[str, int] = {
            "cooldown": 0, "balanced": 0, "sustain": 0, "gain": 0, "hbm": 0,
        }

    def _rec(self) -> Any:
        return self._recorder if self._recorder is not None else tracing.get_recorder()

    def _skip(self, reason: str) -> None:
        self.skips[reason] = self.skips.get(reason, 0) + 1

    def request_consult(self) -> None:
        """Ask the owner to serve ``maybe_rebalance`` at its next step
        boundary (the ``FleetScheduler``'s rebalance-over-shrink path).
        The scheduler thread never moves rows itself: only the
        supervisor's step loop is a safe reassignment point, and on
        multi-process runtimes only a step-keyed consult keeps the ranks
        in agreement."""
        with self._lock:
            self._consult_requested = True

    def consult_pending(self) -> bool:
        with self._lock:
            return self._consult_requested

    def _in_cooldown(self, step: int, now: float) -> bool:
        # Caller holds the lock. Step-based when configured (deterministic
        # across processes); wall-clock otherwise.
        if self.cooldown_steps is not None:
            return (
                self.last_rebalance_step is not None
                and int(step) - self.last_rebalance_step < self.cooldown_steps
            )
        return (
            self.last_rebalance_at is not None
            and now - self.last_rebalance_at < self.cooldown_s
        )

    def maybe_rebalance(
        self, step: int, now: Optional[float] = None
    ) -> Optional[RebalancePlan]:
        """One consult. Returns a :class:`RebalancePlan` when a rebalance
        (or dry-run of one) fired; ``None`` on every guarded skip."""
        now = self.clock() if now is None else float(now)
        with self._lock:
            self.consults_total += 1
            self._consult_requested = False  # this consult serves any request
            tput = self.tracker.relative_throughput()
            if self.agree_fn is not None:
                agreed = [float(t) for t in self.agree_fn(tput)]
                if len(agreed) == len(tput):
                    tput = agreed
            n = len(tput)
            rows_u = max(self.global_micro // n, 1)
            caps = None
            capped: list[int] = []
            if self.max_rows_fn is not None:
                caps = [self.max_rows_fn(i, rows_u) for i in range(n)]
                capped = [i for i, c in enumerate(caps) if c is not None and c < self.global_micro]
            try:
                proposed = solve_row_assignment(
                    tput, self.global_micro, min_rows=self.min_rows, max_rows=caps
                )
            except InfeasibleAssignment:
                self._skip("hbm")
                self._audit("hetero_rebalance_skip", step, now, {"reason": "hbm-infeasible"})
                return None
            if proposed == self.assignment:
                self._pending = 0
                self._skip("balanced")
                return None
            # Imbalance from the AGREED estimates (== the tracker's own
            # when no agree_fn): every rank must take the same branch.
            lo = min(tput)
            imb = (max(tput) / lo) if lo > 0 else float("inf")
            before = predicted_goodput(self.assignment, tput)
            after = predicted_goodput(proposed, tput)
            # Healing back toward uniform is triggered by the *gain*, not
            # the imbalance ratio (a healed gang has imbalance ≈ 1 but a
            # stale skewed split still gates on its over-loaded hosts).
            if imb < self.imbalance_trigger and after - before < self.min_gain:
                self._pending = 0
                self._skip("balanced")
                return None
            self._pending += 1
            if self._pending < self.sustain_consults:
                self._skip("sustain")
                return None
            if self._in_cooldown(step, now):
                self._skip("cooldown")
                return None
            if after - before < self.min_gain:
                self._skip("gain")
                self._audit(
                    "hetero_rebalance_skip", step, now,
                    {"reason": "gain-below-floor",
                     "goodput_before": round(before, 4),
                     "goodput_after": round(after, 4)},
                )
                return None
            plan = RebalancePlan(
                step=int(step), ts=now,
                assignment=proposed, previous=list(self.assignment),
                throughputs=tput, imbalance=imb,
                goodput_before=before, goodput_after=after,
                dry_run=self.dry_run, hbm_capped=capped,
            )
            self.last_plan = plan
            self.last_rebalance_at = now
            self.last_rebalance_step = int(step)
            self._pending = 0
            if self.dry_run:
                self.dry_runs_total += 1
            else:
                self.rebalances_total += 1
                self.assignment = list(proposed)
            self._audit("hetero_rebalance", step, now, plan.describe())
            return plan

    def _audit(self, name: str, step: int, ts: float, attrs: dict[str, Any]) -> None:
        try:
            self._rec().event(
                name, kind="hetero", trace_id=self.trace_id, ts=ts,
                attrs={"step": int(step), **attrs},
            )
        except Exception:
            pass  # audit must never take the step loop down

    def revert(self, plan: RebalancePlan) -> None:
        """Roll back a live plan the caller could not apply (the data
        layer rejected the windows, or there is no ``reassign`` seam at
        all): restore the previous assignment so
        ``hetero_assignment_rows`` and ``recovered_goodput_fraction``
        never report a split that is not actually feeding the mesh."""
        if plan.dry_run:
            return
        with self._lock:
            if self.assignment == list(plan.assignment):
                self.assignment = list(plan.previous)
            self.reverts_total += 1
        self._audit(
            "hetero_rebalance_reverted", plan.step, self.clock(),
            {"assignment": list(plan.previous),
             "rejected": list(plan.assignment)},
        )

    def recovered_goodput_fraction(self) -> float:
        """Predicted goodput of the live assignment minus the uniform
        split's, under current throughput — the "what rebalancing buys"
        gauge. 0 when uniform (or in dry-run, where nothing moved)."""
        with self._lock:
            tput = self.tracker.relative_throughput()
            uni = uniform_assignment(self.global_micro, len(tput))
            return max(
                predicted_goodput(self.assignment, tput) - predicted_goodput(uni, tput),
                0.0,
            )

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "global_micro": self.global_micro,
                "assignment": list(self.assignment),
                "dry_run": self.dry_run,
                "cooldown_s": self.cooldown_s,
                "cooldown_steps": self.cooldown_steps,
                "imbalance_trigger": self.imbalance_trigger,
                "min_gain": self.min_gain,
                "consults_total": self.consults_total,
                "rebalances_total": self.rebalances_total,
                "dry_runs_total": self.dry_runs_total,
                "reverts_total": self.reverts_total,
                "consult_requested": self._consult_requested,
                "skips": dict(self.skips),
                "last_rebalance_at": self.last_rebalance_at,
                "last_rebalance_step": self.last_rebalance_step,
                "last_plan": self.last_plan.describe() if self.last_plan else None,
                "tracker": self.tracker.stats(),
            }


# -- process-wide plane (router/metrics/scheduler default lookup) -------------

_active: Optional[HeteroRebalancer] = None
_active_lock = threading.Lock()


def set_active(rebalancer: Optional[HeteroRebalancer]) -> None:
    global _active
    with _active_lock:
        _active = rebalancer


def get_active() -> Optional[HeteroRebalancer]:
    return _active


def clear_active() -> None:
    set_active(None)
