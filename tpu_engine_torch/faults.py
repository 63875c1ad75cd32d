"""Deterministic fault injection — failure as a first-class, testable input.

The reference advertises auto-resume and corrupt-checkpoint rollback but
ships them as stubs; our reproduction has the real recovery machinery
(PreemptionWatcher, checkpoint-preempt-requeue, health assessment, stable
rollback) and this module is how we *prove* it survives failures. A seeded
:class:`FaultPlan` describes faults that trigger at a training step or at
elapsed wall time; a :class:`FaultInjector` is consulted through explicit
seams in :class:`~tpu_engine.tpu_manager.TPUManager` (chip-unhealthy /
telemetry-NaN overlays), :class:`~tpu_engine_torch.checkpoint.TrainCheckpointManager`
(save IOError / restore corruption), and the supervisor loop (host-slow,
preemption-signal, and the self-healing detect path).

Design rules:

- **Deterministic.** Step-triggered faults fire on the exact step the plan
  names; ``FaultPlan.random(seed)`` is reproducible. Nothing in here sleeps
  and nothing depends on thread timing — host-slow is injected as a *reported*
  step-time penalty, not an actual stall.
- **Observable.** Every injected fault (and every heal) appends a structured
  :class:`FaultEvent` to a bounded log with per-kind counters, surfaced via
  the ``/api/v1/faults`` HTTP API and ``tpu_engine_fault_*`` Prometheus lines.
- **Opt-in.** Seams consult the process-wide active injector
  (:func:`get_active`); when none is armed (the default) every seam is a
  no-op costing one attribute read.

The port's copy of ``tpu_engine/faults.py`` (the JAX package's module uses
no JAX, and the port imports nothing of that package): the same code,
with the port's imports and its own exporter name; Prometheus families
keep JAX's names, so one dashboard reads both.
"""

from __future__ import annotations

import enum
import random
import threading
import time
from typing import Optional

from pydantic import BaseModel, Field, model_validator

from tpu_engine_torch import historian, tracing


class FaultKind(str, enum.Enum):
    """The eight injectable fault types."""

    CHIP_UNHEALTHY = "chip-unhealthy"
    HOST_SLOW = "host-slow"
    CHECKPOINT_SAVE_IOERROR = "checkpoint-save-ioerror"
    CHECKPOINT_RESTORE_CORRUPTION = "checkpoint-restore-corruption"
    TELEMETRY_NAN = "telemetry-nan"
    PREEMPTION_SIGNAL = "preemption-signal"
    PRECOMPILE_ERROR = "precompile-error"
    CONTROLPLANE_CRASH = "controlplane-crash"


# Kinds that attach to a specific chip and stay active until healed/expired.
_CHIP_KINDS = frozenset({FaultKind.CHIP_UNHEALTHY, FaultKind.TELEMETRY_NAN})
# Kinds consumed once per trigger (``count`` occurrences, then spent).
_CONSUMABLE_KINDS = frozenset(
    {
        FaultKind.CHECKPOINT_SAVE_IOERROR,
        FaultKind.CHECKPOINT_RESTORE_CORRUPTION,
        FaultKind.PREEMPTION_SIGNAL,
        FaultKind.HOST_SLOW,
        FaultKind.PRECOMPILE_ERROR,
        FaultKind.CONTROLPLANE_CRASH,
    }
)
# Kinds never drawn by ``FaultPlan.random``: adding a kind to the enum must
# not perturb existing seeded plans (chaos traces are gated byte-identical),
# so anything introduced after the original seven is excluded from the draw
# and injected only via an explicit FaultSpec.
_NON_RANDOM_KINDS = frozenset(
    {FaultKind.PRECOMPILE_ERROR, FaultKind.CONTROLPLANE_CRASH}
)


class FaultSpec(BaseModel):
    """One planned fault.

    Triggers when the supervisor reaches ``at_step`` OR ``after_s`` seconds
    have elapsed since :meth:`FaultInjector.arm` (whichever is specified; if
    both, either condition suffices). Chip faults (`chip-unhealthy`,
    `telemetry-nan`) name a ``device_index`` (fleet snapshot index) and stay
    active for ``duration_steps`` observed steps — or until
    :meth:`FaultInjector.heal` — modelling a chip that recovers. Consumable
    faults (save/restore/preempt/host-slow/precompile) fire ``count`` times
    then spend.
    """

    kind: FaultKind
    at_step: Optional[int] = Field(default=None, ge=0)
    after_s: Optional[float] = Field(default=None, ge=0.0)
    device_index: Optional[int] = Field(default=None, ge=0)
    count: int = Field(default=1, ge=1)
    duration_steps: Optional[int] = Field(default=None, ge=1)
    slow_s: float = Field(default=0.5, ge=0.0)  # host-slow reported penalty

    @model_validator(mode="after")
    def _check(self) -> "FaultSpec":
        if self.at_step is None and self.after_s is None:
            raise ValueError("fault spec needs a trigger: at_step or after_s")
        if self.kind in _CHIP_KINDS and self.device_index is None:
            raise ValueError(f"{self.kind.value} fault needs device_index")
        return self


class FaultEvent(BaseModel):
    """Structured record of one injected fault / heal — the observable log."""

    seq: int
    kind: str
    step: Optional[int] = None
    device_index: Optional[int] = None
    detail: str = ""
    timestamp: float


class FaultPlan(BaseModel):
    """A seeded, serialisable set of faults — the chaos-trace input."""

    seed: int = 0
    specs: list[FaultSpec] = Field(default_factory=list)

    @classmethod
    def random(
        cls,
        seed: int,
        n_faults: int = 4,
        max_step: int = 50,
        n_devices: int = 8,
    ) -> "FaultPlan":
        """Reproducible random plan: same seed → identical specs.

        Kinds in :data:`_NON_RANDOM_KINDS` (``precompile-error``,
        ``controlplane-crash``) are control-plane faults, not
        per-training-step faults, and are excluded from the draw so every
        seeded plan — and every chaos trace derived from one — stays
        byte-identical across each kind's introduction. Inject them with
        an explicit :class:`FaultSpec`.
        """
        rng = random.Random(seed)
        kinds = [k for k in FaultKind if k not in _NON_RANDOM_KINDS]
        specs = []
        for _ in range(n_faults):
            kind = rng.choice(kinds)
            spec = {
                "kind": kind,
                "at_step": rng.randrange(1, max(2, max_step)),
            }
            if kind in _CHIP_KINDS:
                spec["device_index"] = rng.randrange(n_devices)
                spec["duration_steps"] = rng.randrange(1, 10)
            if kind is FaultKind.HOST_SLOW:
                spec["slow_s"] = round(rng.uniform(0.1, 2.0), 3)
            specs.append(FaultSpec(**spec))
        return cls(seed=seed, specs=specs)


class _SpecState:
    """Runtime state for one spec: trigger bookkeeping, no pydantic churn."""

    __slots__ = ("spec", "remaining", "triggered_step", "healed", "announced")

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.remaining = spec.count
        self.triggered_step: Optional[int] = None  # chip faults: activation step
        self.healed = False
        self.announced = False


class FaultInjector:
    """Thread-safe runtime that seams query. One per process (see
    :func:`set_active`); jobs may also carry a private injector."""

    MAX_EVENTS = 1000

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan or FaultPlan()
        self._lock = threading.Lock()
        self._states = [_SpecState(s) for s in self.plan.specs]
        self._t0: Optional[float] = None
        self._step = 0
        self._seq = 0
        self.events: list[FaultEvent] = []
        self.counters: dict[str, int] = {}
        # Monotonic count of events evicted from the bounded log. The log
        # used to truncate silently at MAX_EVENTS — a consumer paging the
        # event list had no way to tell "quiet period" from "lost history".
        self.events_dropped = 0
        # Cumulative reported host-slow stall seconds — the goodput
        # ledger's host_slow category should reconcile against this.
        self.host_slow_penalty_s_total = 0.0

    # -- lifecycle -----------------------------------------------------------

    def arm(self) -> None:
        """Start the wall clock for ``after_s`` triggers (idempotent)."""
        with self._lock:
            if self._t0 is None:
                self._t0 = time.monotonic()

    def extend(self, specs: list[FaultSpec]) -> None:
        with self._lock:
            self.plan.specs.extend(specs)
            self._states.extend(_SpecState(s) for s in specs)

    def specs_active(self) -> int:
        """Specs with trigger budget left (metrics gauge)."""
        with self._lock:
            return sum(1 for st in self._states if st.remaining > 0)

    def observe_step(self, step: int) -> None:
        """Supervisor seam: advance the injector's notion of training progress."""
        with self._lock:
            if self._t0 is None:
                self._t0 = time.monotonic()
            self._step = max(self._step, int(step))
            # Announce chip faults the moment they activate so the event log
            # orders activation before the detection that follows it.
            for st in self._states:
                if st.spec.kind in _CHIP_KINDS and self._due_locked(st) and not st.announced:
                    st.announced = True
                    if st.triggered_step is None:
                        st.triggered_step = self._step
                    self._record_locked(
                        st.spec.kind.value,
                        step=self._step,
                        device_index=st.spec.device_index,
                        detail="activated",
                    )

    # -- trigger evaluation ---------------------------------------------------

    def _due_locked(self, st: _SpecState) -> bool:
        spec = st.spec
        if spec.at_step is not None and self._step >= spec.at_step:
            return True
        if spec.after_s is not None and self._t0 is not None:
            return (time.monotonic() - self._t0) >= spec.after_s
        return False

    def _chip_active_locked(self, st: _SpecState) -> bool:
        if st.spec.kind not in _CHIP_KINDS or st.healed:
            return False
        if not self._due_locked(st):
            return False
        if st.triggered_step is None:
            st.triggered_step = self._step
        if st.spec.duration_steps is not None:
            return self._step < st.triggered_step + st.spec.duration_steps
        return True

    def chip_overlay(self) -> dict[int, FaultKind]:
        """Active chip faults as {fleet device index: kind} (TPUManager seam).

        ``chip-unhealthy`` wins when both kinds target the same chip."""
        with self._lock:
            out: dict[int, FaultKind] = {}
            for st in self._states:
                if self._chip_active_locked(st):
                    idx = int(st.spec.device_index)  # validated non-None
                    if out.get(idx) is not FaultKind.CHIP_UNHEALTHY:
                        out[idx] = st.spec.kind
            return out

    def _take_locked(self, kind: FaultKind, step: Optional[int]) -> Optional[FaultSpec]:
        if step is not None:
            self._step = max(self._step, int(step))
        for st in self._states:
            if st.spec.kind is kind and st.remaining > 0 and self._due_locked(st):
                st.remaining -= 1
                self._record_locked(
                    kind.value,
                    step=self._step,
                    device_index=st.spec.device_index,
                    detail=f"fired ({st.spec.count - st.remaining}/{st.spec.count})",
                )
                return st.spec
        return None

    def take_save_fault(self, step: int) -> bool:
        """Checkpoint seam: consume one save-IOError fault if due."""
        with self._lock:
            return self._take_locked(FaultKind.CHECKPOINT_SAVE_IOERROR, step) is not None

    def take_precompile_fault(self, step: int) -> bool:
        """Precompile-worker seam: consume one precompile-error fault if due
        (:class:`~tpu_engine.compile_index.PrecompileWorker` consults this
        before every background AOT attempt)."""
        with self._lock:
            return self._take_locked(FaultKind.PRECOMPILE_ERROR, step) is not None

    def take_controlplane_crash(self, step: int) -> bool:
        """Control-plane seam: consume one controlplane-crash fault if due.
        The crash lane (``twin.ctl_crash_lane``) consults this per poll to
        pick the kill point; a real deployment would wire it to a
        supervisor that SIGKILLs the scheduler host."""
        with self._lock:
            return self._take_locked(FaultKind.CONTROLPLANE_CRASH, step) is not None

    def take_restore_fault(self, step: int) -> bool:
        """Checkpoint seam: consume one restore-corruption fault if due."""
        with self._lock:
            return self._take_locked(FaultKind.CHECKPOINT_RESTORE_CORRUPTION, step) is not None

    def preempt_due(self, step: int) -> bool:
        """Supervisor seam: consume one preemption-signal fault if due."""
        with self._lock:
            return self._take_locked(FaultKind.PREEMPTION_SIGNAL, step) is not None

    def take_host_slow(self, step: int) -> Optional[FaultSpec]:
        """Supervisor seam: consume one host-slow fault if due, returning
        the full spec — the heterogeneity plane needs ``device_index`` to
        attribute the stall to a host, not just the penalty magnitude."""
        with self._lock:
            spec = self._take_locked(FaultKind.HOST_SLOW, step)
            if spec is not None:
                self.host_slow_penalty_s_total += float(spec.slow_s)
            return spec

    def host_slow_penalty_s(self, step: int) -> float:
        """Supervisor seam: reported step-time penalty (never an actual sleep)."""
        spec = self.take_host_slow(step)
        return float(spec.slow_s) if spec is not None else 0.0

    def heal(self, device_index: int) -> int:
        """Clear active chip faults on a device; returns how many were healed."""
        with self._lock:
            n = 0
            for st in self._states:
                if (
                    st.spec.kind in _CHIP_KINDS
                    and st.spec.device_index == device_index
                    and not st.healed
                ):
                    st.healed = True
                    n += 1
            if n:
                self._record_locked(
                    "heal", step=self._step, device_index=device_index, detail=f"cleared {n} fault(s)"
                )
            return n

    # -- observability --------------------------------------------------------

    def _record_locked(
        self,
        kind: str,
        step: Optional[int] = None,
        device_index: Optional[int] = None,
        detail: str = "",
    ) -> None:
        self._seq += 1
        self.counters[kind] = self.counters.get(kind, 0) + 1
        self.events.append(
            FaultEvent(
                seq=self._seq,
                kind=kind,
                step=step,
                device_index=device_index,
                detail=detail,
                timestamp=time.time(),
            )
        )
        if len(self.events) > self.MAX_EVENTS:
            drop = len(self.events) - self.MAX_EVENTS
            self.events_dropped += drop
            del self.events[:drop]
        # Mirror onto the shared flight-recorder timeline so fault history
        # lines up with job/serving spans instead of living in an island
        # log. The recorder has its own lock and never calls back in here.
        tracing.get_recorder().event(
            kind,
            kind="fault",
            trace_id="fleet",
            attrs={"step": step, "device_index": device_index, "detail": detail},
        )
        # Retain the injection in the historian too, so incident windows
        # can pull "faults over the last N minutes" as a series. Best
        # effort: the injector must keep working if the historian is
        # swapped mid-flight by a test.
        try:
            historian.get_historian().record(
                "fault_injected",
                1.0,
                ts=self.events[-1].timestamp,
                labels={"kind": kind},
            )
        except Exception:
            pass

    def record(
        self,
        kind: str,
        step: Optional[int] = None,
        device_index: Optional[int] = None,
        detail: str = "",
    ) -> None:
        """Append an external observation (e.g. supervisor recovery marks)."""
        with self._lock:
            self._record_locked(kind, step=step, device_index=device_index, detail=detail)

    def describe(self) -> dict:
        with self._lock:
            return {
                "seed": self.plan.seed,
                "armed": self._t0 is not None,
                "current_step": self._step,
                "specs": [s.model_dump(mode="json") for s in self.plan.specs],
                "active_chip_faults": {},  # filled below without the lock
                "counters": dict(self.counters),
                "events_dropped": self.events_dropped,
                "host_slow_penalty_s_total": round(
                    self.host_slow_penalty_s_total, 6
                ),
                "events": [e.model_dump() for e in self.events[-50:]],
            }

    def describe_full(self) -> dict:
        out = self.describe()
        out["active_chip_faults"] = {
            str(idx): kind.value for idx, kind in self.chip_overlay().items()
        }
        return out


# -- process-wide active injector (the seams' default lookup) -----------------

_active: Optional[FaultInjector] = None
_active_lock = threading.Lock()


def set_active(injector: Optional[FaultInjector]) -> None:
    global _active
    with _active_lock:
        _active = injector


def get_active() -> Optional[FaultInjector]:
    return _active


def clear_active() -> None:
    set_active(None)


def activate(plan: FaultPlan) -> FaultInjector:
    """Build an injector from ``plan``, arm it, and make it process-active."""
    inj = FaultInjector(plan)
    inj.arm()
    set_active(inj)
    return inj
