"""Fleet job scheduler: priority queue, HBM-aware gang admission, preemption
(port of ``tpu_engine/scheduler.py``: JAX's state machine, unchanged, over
this package's supervisor, planner, estimators and journal).

The reference admits a job immediately or refuses (``DeepSpeedLauncher`` has
no queue — SURVEY.md §5); launch here becomes a two-phase submit→admit
pipeline owned by one admission authority:

- **submit** enqueues a :class:`Submission` (priority + FIFO within a
  priority class, per-submitter quotas) and returns immediately with a
  queue position;
- **admit** runs on every scheduler pass: a submission starts only when its
  *gang* of devices (the product of its mesh axes) fits the fleet's healthy
  chips — unhealthy/critical chips (``TPUDevice.is_available``,
  ``tpu_engine_torch/tpu_manager.py`` thresholds) are excluded from placement —
  AND its projected per-device HBM footprint
  (:func:`tpu_engine_torch.hbm_estimate.estimate_job_hbm`) fits the headroom left
  after every already-running job's reservation (Poplar's stance that
  cluster-aware placement, not just per-job parallelism, drives fleet
  utilization — arXiv:2408.12596);
- a higher-priority submission that cannot be admitted triggers
  **checkpoint-preempt-requeue** of the lowest-priority running job through
  the supervisor's existing emergency-save path
  (``PreemptionWatcher.simulate_interruption`` → synchronous checkpoint save →
  the submission re-enters the queue and auto-resumes from its checkpoint
  when re-admitted — zero lost steps);
- **backfill**: a small job behind a too-big head-of-queue job may start if
  it fits, bounded by ``backfill_depth`` so the head cannot starve.

``TPULauncher.launch`` is a thin wrapper over ``submit`` (priority=normal).

Differences from JAX's, where the runtimes differ:

- placements map onto CUDA devices (``cuda:i``), or CPU devices for a
  scheduler built with ``device="cpu"``; without a fleet view the gang
  resolves against the visible CUDA devices;
- this package runs a mesh as one process a rank (torchrun), never as one
  process over several devices: a real job whose gang is more than one
  device, admitted in a process that is not one rank of a group that
  large, fails at construction with that reason (the scheduler marks it
  FAILED, as JAX marks a job whose build fails). Jobs from other
  factories (stubs) take any gang.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import threading
import time
import uuid
from collections import deque
from datetime import datetime, timezone
from enum import Enum, IntEnum
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from tpu_engine_torch import compile_index as compile_index_mod
from tpu_engine_torch import goodput as goodput_mod
from tpu_engine_torch import hetero as hetero_mod
from tpu_engine_torch import historian as historian_mod
from tpu_engine_torch import journal as journal_mod
from tpu_engine_torch import tracing
from tpu_engine_torch.hbm_estimate import (
    HBMEstimate,
    elastic_shrink_plan,
    estimate_job_hbm,
    gang_size,
)
from tpu_engine_torch.mesh_runtime import MeshConfig
from tpu_engine_torch.placement import PlacementPlanner, visible_device_count
from tpu_engine_torch.supervisor import JobStatus, TrainingJob
from tpu_engine_torch.tpu_manager import TPUFleetStatus
from tpu_engine_torch.train import TrainConfig

log = logging.getLogger(__name__)


class JobPriority(IntEnum):
    LOW = 0
    NORMAL = 1
    HIGH = 2
    CRITICAL = 3


class SubmissionState(str, Enum):
    QUEUED = "queued"
    RUNNING = "running"
    PREEMPTING = "preempting"  # emergency save in flight; requeued when done
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLING = "cancelling"
    CANCELLED = "cancelled"


# Submission states that will never change again.
TERMINAL_STATES = frozenset(
    {SubmissionState.COMPLETED, SubmissionState.FAILED, SubmissionState.CANCELLED}
)

# Admission-wait histogram bucket upper bounds (seconds). Spans sub-second
# idle-fleet admissions through multi-minute capacity waits; +Inf is
# implicit in the exposition.
WAIT_BUCKETS_S = (0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0)


def _observe_hist(hist: dict[float, int], value: float) -> None:
    for b in WAIT_BUCKETS_S:
        if value <= b:
            hist[b] += 1


def config_to_dict(config: TrainConfig) -> dict[str, Any]:
    """A JSON-safe dict of ``config`` (JAX's ``model_dump(mode="json")``):
    the mesh as a dict, tuples as lists; ``beta2`` only where it was set,
    so :func:`config_from_dict` keeps Adafactor's default decay."""
    d = dataclasses.asdict(config)
    if not config.beta2_is_set:
        del d["beta2"]
    return {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}


def config_from_dict(d: dict[str, Any]) -> TrainConfig:
    """The inverse of :func:`config_to_dict` (JAX's ``model_validate``)."""
    return TrainConfig(**{**d, "mesh": MeshConfig(**d["mesh"])})


class QuotaExceeded(Exception):
    """Per-submitter quota would be exceeded (maps to HTTP 429)."""

    def __init__(self, submitter: str, limit: int):
        self.submitter = submitter
        self.limit = limit
        super().__init__(
            f"submitter '{submitter}' already has {limit} active submission(s) "
            f"(quota {limit}); wait for one to finish or cancel it"
        )


class Submission:
    """One queued/running unit of work — survives preempt-requeue cycles
    (the :class:`~tpu_engine_torch.supervisor.TrainingJob` is per *attempt*; the
    submission is the durable identity the queue orders and the API names).
    """

    def __init__(
        self,
        config: TrainConfig,
        priority: JobPriority,
        submitter: str,
        seq: int,
        job_kwargs: Optional[dict[str, Any]] = None,
        workload: str = "training",
        estimate_fn: Optional[Callable[..., Optional[HBMEstimate]]] = None,
        job_factory: Optional[Callable[["Submission"], Any]] = None,
    ):
        ts = datetime.now(timezone.utc).strftime("%Y%m%d_%H%M%S")
        # The monotonic seq makes the id collision-proof per scheduler: at
        # >10k submissions per wall-second the second-resolution timestamp
        # plus 24 random bits alone collides (birthday bound), and a
        # collision while both submissions are queued silently drops the
        # older one from the admission index.
        self.submission_id = f"sub_{ts}_{seq}_{uuid.uuid4().hex[:6]}"
        # Attempts reuse this id so the registry's newest entry wins.
        prefix = "srv" if workload == "serving" else "tpu"
        self.job_id = (
            f"{prefix}_{config.model_name}_{ts}_{seq}_{uuid.uuid4().hex[:6]}"
        )
        self.config = config
        self.priority = priority
        self.submitter = submitter
        self.seq = seq  # FIFO tiebreak within a priority class; kept on requeue
        self.job_kwargs = job_kwargs or {}
        # Workload class: "training" (the default) or "serving" (a decode
        # replica — same queue/quota/ledger, but its own footprint estimator
        # and job factory, carried per-submission so one scheduler admits
        # both side by side).
        self.workload = workload
        self.estimate_fn = estimate_fn
        self.job_factory = job_factory

        self.state = SubmissionState.QUEUED
        self.job: Optional[TrainingJob] = None
        self.attempts = 0
        self.preemptions = 0
        self.submitted_at = time.time()
        self.first_admitted_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.last_skip_reason: Optional[str] = None
        self.estimate: Optional[HBMEstimate] = None
        self.placement: list[int] = []  # fleet device indices reserved for it
        # Elastic-shrink admission: the mesh this attempt actually runs at
        # (None = configured shape) and the gang it occupies — grow-back
        # compares the healthy fleet against admitted_gang.
        self.shrunk_mesh: Optional[dict[str, int]] = None
        self.admitted_gang: Optional[int] = None
        # Last shrink/grow resize of this submission — the grow-back
        # hysteresis clock (a flapping chip must not thrash a job through
        # shrink/grow cycles faster than the cooldown).
        self.last_resize_at: Optional[float] = None
        self.last_admitted_at: Optional[float] = None
        # Auto placement (mesh="auto"): the planner replaces the submitted
        # mesh/schedule at every admission with the predicted-fastest
        # feasible plan against the then-current fleet.
        self.auto_place = False
        self.placement_plan: Optional[dict[str, Any]] = None
        self.predicted_step_time_s: Optional[float] = None
        # Flight-recorder identity: ONE trace per submission for its whole
        # lifetime — every attempt, requeue, shrink and grow-back chains
        # under this root span (closed at the terminal state).
        rec = tracing.get_recorder()
        self.trace_id = rec.new_trace_id()
        self._root_span = rec.start_span(
            f"job:{self.job_id}",
            kind="job",
            trace_id=self.trace_id,
            attrs={
                "submission_id": self.submission_id,
                "model": config.model_name,
                "priority": priority.name.lower(),
                "submitter": submitter,
                "workload": workload,
            },
        )

    def finish_trace(self, state: str) -> None:
        """Close the lifecycle root span (idempotent), then settle the
        submission's goodput account — terminal accounting drops the
        ledger's per-trace cursor, so ledger memory is bounded by the
        active set."""
        if self._root_span is not None and self._root_span.t1 is None:
            self._root_span.end(state=state)
            try:
                goodput_mod.get_ledger().finalize(
                    tracing.get_recorder(), self.trace_id
                )
            except Exception:  # accounting must never break reaping
                log.debug("goodput finalize failed", exc_info=True)

    @property
    def preemptible(self) -> bool:
        """Preemption is only safe when the job can be rebuilt from durable
        state. Training needs the full emergency-save path — a watcher to
        fire and a checkpoint dir the requeued attempt resumes from. A
        serving replica is stateless above its snapshot (in-flight requests
        are re-dispatched by the fleet router), so the watcher alone
        suffices: checkpoint-free teardown."""
        if self.job is None or self.job.watcher is None:
            return False
        if self.workload == "serving":
            return True
        return bool(self.config.checkpoint_dir)

    @property
    def wait_s(self) -> Optional[float]:
        if self.first_admitted_at is None:
            return None
        return self.first_admitted_at - self.submitted_at

    def describe(self) -> dict[str, Any]:
        return {
            "submission_id": self.submission_id,
            "job_id": self.job_id,
            "state": self.state.value,
            "priority": self.priority.name.lower(),
            "submitter": self.submitter,
            "workload": self.workload,
            "model_name": self.config.model_name,
            "attempts": self.attempts,
            "preemptions": self.preemptions,
            "submitted_at": self.submitted_at,
            "first_admitted_at": self.first_admitted_at,
            "finished_at": self.finished_at,
            "wait_s": self.wait_s,
            "last_skip_reason": self.last_skip_reason,
            "trace_id": self.trace_id,
            "hbm_estimate": self.estimate.model_dump() if self.estimate else None,
            "placement": self.placement,
            "shrunk_mesh": self.shrunk_mesh,
            "admitted_gang": self.admitted_gang,
            "auto_place": self.auto_place,
            "placement_plan": self.placement_plan,
            "predicted_step_time_s": self.predicted_step_time_s,
            "job": self.job.describe() if self.job is not None else None,
        }


def _default_job_factory(sub: Submission, device: str = "cuda") -> TrainingJob:
    """The port's ``TrainingJob`` on ``device``'s type: the admission's
    pinned devices where it pinned some, else the first card (or the
    CPU). A gang of more than one device runs only as one rank a process
    of a group that large (this package has no one-process mesh); any
    other such job raises here."""
    kwargs = dict(sub.job_kwargs)
    # Every scheduler-run job is preemptible-by-the-scheduler: the watcher
    # exists (simulate_interruption is the preempt verb) and the injected
    # never-true check swaps the 5 s metadata poll for the 0.05 s
    # cadence, so a preempt lands within a step, not seconds later. A
    # caller who passed watch_preemption=True explicitly wants the REAL
    # metadata poll — leave their check alone.
    if "watch_preemption" not in kwargs:
        kwargs["watch_preemption"] = True
        kwargs.setdefault("simulate_preemption_check", lambda: False)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    pinned = kwargs.get("devices")
    n_visible = len(pinned) if pinned else world if world > 1 else (
        visible_device_count() if device == "cuda" else 1)
    gang = gang_size(sub.config, n_visible)
    if gang > 1 and gang != world:
        raise ValueError(
            f"gang of {gang} device(s) in one process: tpu_engine_torch runs a mesh as one "
            f"process a rank (torchrun, WORLD_SIZE={gang}), not one process over several "
            f"devices; this process is {'one of ' + str(world) if world > 1 else 'alone'}")
    if not pinned and device == "cpu":
        kwargs["devices"] = ["cpu"] * world  # the job's default is one card a process
    return TrainingJob(job_id=sub.job_id, config=sub.config, **kwargs)


class FleetScheduler:
    """Single admission authority for this process's devices.

    ``fleet_fn`` supplies the placement view (a
    :class:`~tpu_engine_torch.tpu_manager.TPUFleetStatus`); None, an empty fleet,
    or chips with no HBM telemetry (``hbm_total_gb == 0`` — the CPU backend)
    degrade admission to capacity-only, never to a refusal: missing
    telemetry must not brick the queue.

    ``device`` (port-only): ``"cuda"`` (the default) places jobs on the
    cards, ``"cpu"`` on CPU devices.
    """

    def __init__(
        self,
        max_concurrent_jobs: int = 1,
        fleet_fn: Optional[Callable[[], TPUFleetStatus]] = None,
        job_factory: Optional[Callable[[Submission], TrainingJob]] = None,
        estimate_fn: Callable[..., Optional[HBMEstimate]] = estimate_job_hbm,
        backfill_depth: int = 4,
        default_quota: Optional[int] = None,
        quotas: Optional[dict[str, int]] = None,
        checkpoint_root: Optional[str] = None,
        poll_interval_s: float = 0.1,
        grow_back: bool = True,
        grow_back_cooldown_s: float = 30.0,
        planner: Optional[PlacementPlanner] = None,
        compile_index: Optional[compile_index_mod.CompileCacheIndex] = None,
        precompile_before_grow: bool = True,
        precompile_deadline_s: float = 60.0,
        precompile_fn: Optional[Callable[..., None]] = None,
        hetero_rebalance: bool = True,
        hetero_goodput_floor: float = 0.80,
        hetero_cooldown_s: float = 30.0,
        hetero_imbalance_trigger: float = 1.15,
        hetero_heal_threshold: float = 0.95,
        hetero_quarantine_ttl_s: float = 900.0,
        max_finished_history: int = 10_000,
        device: str = "cuda",
    ):
        self.device = torch.device(device).type
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {device!r}")
        self.grow_back = grow_back
        # Hysteresis window: a shrunk job is not grown back until this long
        # after its last shrink/grow resize — a chip flapping between
        # healthy and unhealthy faster than the cooldown costs the job ONE
        # shrink, not a preempt-requeue storm (each cycle pays an emergency
        # save + recompile).
        self.grow_back_cooldown_s = grow_back_cooldown_s
        self.max_concurrent_jobs = max_concurrent_jobs
        self.fleet_fn = fleet_fn
        self.job_factory = job_factory or functools.partial(
            _default_job_factory, device=self.device)
        self.estimate_fn = estimate_fn
        self.backfill_depth = backfill_depth
        self.default_quota = default_quota
        self.quotas = dict(quotas or {})
        self.checkpoint_root = checkpoint_root
        self.poll_interval_s = poll_interval_s
        # Compile-cache awareness: admission ranking (via the planner) and
        # grow-back both consult the layout-keyed warm index, and grow-back
        # warms its target mesh in the background before preempting. The
        # process index is the default so the supervisor's compile spans
        # (which have no scheduler handle) feed the same ledger admission
        # reads.
        self.compile_index = (
            compile_index if compile_index is not None
            else compile_index_mod.get_index()
        )
        self.precompile_before_grow = precompile_before_grow
        # How long a grow-back waits for its background precompile before
        # resizing cold anyway — a broken precompiler must delay the grow,
        # never prevent it.
        self.precompile_deadline_s = precompile_deadline_s
        self.precompiler = compile_index_mod.PrecompileWorker(
            self.compile_index, compile_fn=precompile_fn
        )
        # submission_id → (target layout key, precompile requested at).
        self._grow_precompiles: dict[str, tuple[str, float]] = {}
        # One planner per scheduler: auto admission, grow-back, the
        # launcher plan and the /plan endpoint share its counter plane.
        self.planner = planner or PlacementPlanner(
            estimate_fn=estimate_fn, compile_index=self.compile_index
        )
        if self.planner.compile_index is None:
            self.planner.compile_index = self.compile_index
        # Calibration survives restarts next to the checkpoints; the cost
        # model sees live per-process relative throughput so degraded
        # hosts surface in every prediction (grow targets included).
        if self.checkpoint_root and self.planner._calibration_path is None:
            try:
                self.planner.attach_calibration(self.checkpoint_root)
            except Exception:
                log.warning("placement calibration attach failed", exc_info=True)
        if self.planner.throughput_fn is None:
            self.planner.throughput_fn = self._fleet_rel_throughput

        self._lock = threading.RLock()
        self._subs: dict[str, Submission] = {}
        self._seq = 0
        self._draining = False
        self._reserved: dict[int, float] = {}  # device index → reserved GiB

        # State-bucketed indexes: `_subs` keeps every submission ever (the
        # API's history surface), so any scan of it is O(all submissions
        # ever) — at 100k jobs that made each 0.1 s poll pass quadratic.
        # Admission, stats and the metrics scrape read these buckets
        # instead; `_set_state` is the single transition point that keeps
        # them consistent. Queued buckets are per-priority deques in seq
        # order: a new submission always carries the max seq (append), a
        # preempt-requeue re-enters at its ORIGINAL seq (sorted re-insert,
        # rare — one per preemption).
        self._queued_idx: dict[int, deque[Submission]] = {
            int(p): deque() for p in JobPriority
        }
        self._state_idx: dict[SubmissionState, dict[str, Submission]] = {
            SubmissionState.RUNNING: {},
            SubmissionState.PREEMPTING: {},
            SubmissionState.CANCELLING: {},
        }
        self._by_job_id: dict[str, Submission] = {}
        # Terminal submissions in finish order: queue_state()'s "finished"
        # history surface without a _subs scan (rendering it is still
        # O(terminal) — that is the size of the answer, not a scan tax).
        # Bounded: beyond max_finished_history the oldest terminal
        # submissions leave _subs/_by_job_id too — at 100k jobs an
        # unbounded history made every control action pay for the
        # retained object graph (gen-2 GC scans grow with it), so per-job
        # submit cost crept up 1.6x over the run. Aggregate counters and
        # per-tenant rollups survive eviction; only the per-submission
        # describe() record ages out.
        self.max_finished_history = int(max_finished_history)
        self.finished_evicted_total = 0
        self._finished_idx: dict[str, Submission] = {}
        # Quota reads and the stats() tenant roster without a _subs scan.
        self._active_by_submitter: dict[str, int] = {}
        self._tenants: set[str] = set()

        # Telemetry counters (the metrics router renders these).
        self.submitted_total = 0
        self.admitted_total = 0
        self.preemptions_total = 0
        self.requeues_total = 0
        self.completed_total = 0
        self.failed_total = 0
        self.cancelled_total = 0
        self.elastic_shrinks_total = 0
        self.grow_backs_total = 0
        self.self_heal_requeues_total = 0
        self.auto_admissions_total = 0
        self.no_estimate_skips_total = 0
        self.precompiles_started_total = 0
        self.grow_back_warm_total = 0
        self.grow_back_cold_total = 0
        # Heterogeneity policy (tpu_engine_torch/hetero.py): for a slow-but-
        # HEALTHY host the scheduler prefers a throughput-weighted
        # rebalance of the data split over throwing the host away with an
        # elastic shrink; it shrinks only when the best rebalance cannot
        # clear hetero_goodput_floor. The scheduler never moves rows
        # itself — it requests a consult that the job's own rebalancer
        # serves at its next step boundary (the only safe reassignment
        # point), and counts the shrink as avoided only once that consult
        # actually fires a plan. Shrinks quarantine the slow host's chips
        # out of admission; quarantine entries carry their owner + age and
        # are released when the tracker reads the host healthy again, the
        # owning submission leaves the scheduler, no tracker can vouch for
        # the chip, or the TTL expires — never held forever.
        self.hetero_rebalance = hetero_rebalance
        self.hetero_goodput_floor = float(hetero_goodput_floor)
        self.hetero_cooldown_s = float(hetero_cooldown_s)
        self.hetero_imbalance_trigger = float(hetero_imbalance_trigger)
        self.hetero_heal_threshold = float(hetero_heal_threshold)
        self.hetero_quarantine_ttl_s = float(hetero_quarantine_ttl_s)
        self.hetero_rebalances_total = 0
        self.hetero_shrinks_total = 0
        self.hetero_shrinks_avoided_total = 0
        self.hetero_rebalance_preferred_total = 0
        # device index → {"owner": submission_id, "ts": quarantined-at}.
        self._hetero_quarantined: dict[int, dict[str, Any]] = {}
        # submission_id → (rebalances+dry_runs) baseline at consult-request
        # time; resolved by _resolve_hetero_consults on later passes.
        self._hetero_pending: dict[str, int] = {}
        self._last_hetero_action_at: Optional[float] = None
        self._wait_samples: list[float] = []  # bounded; admitted-wait seconds
        # Cumulative admission-wait histogram (Prometheus semantics: the
        # bucket counts only grow, unlike the bounded sample window the
        # mean gauges are computed from — both are exported).
        self._wait_hist: dict[float, int] = {b: 0 for b in WAIT_BUCKETS_S}
        self._wait_hist_sum = 0.0
        self._wait_hist_count = 0
        self._tenant_wait_hist: dict[str, dict[float, int]] = {}
        self._tenant_wait_hist_sum: dict[str, float] = {}
        self._tenant_wait_hist_count: dict[str, int] = {}
        # Per-submitter planes (the fairness follow-on needs a measured
        # baseline): admitted-wait samples and accumulated busy seconds
        # (admission → reap, summed across attempts — the goodput proxy).
        self._tenant_waits: dict[str, list[float]] = {}
        self._tenant_busy_s: dict[str, float] = {}
        self._tenant_completed: dict[str, int] = {}

        # Durable control plane (tpu_engine_torch/journal.py): when a journal is
        # attached, every state-changing event below is written ahead so a
        # crashed scheduler host can be reconstructed with restore().
        self._journal: Optional[journal_mod.ControlPlaneJournal] = None

        self._shutdown = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- submission ----------------------------------------------------------

    def submit(
        self,
        config: TrainConfig,
        priority: JobPriority = JobPriority.NORMAL,
        submitter: str = "anonymous",
        job_kwargs: Optional[dict[str, Any]] = None,
        workload: str = "training",
        estimate_fn: Optional[Callable[..., Optional[HBMEstimate]]] = None,
        job_factory: Optional[Callable[[Submission], Any]] = None,
        mesh: Optional[str] = None,
    ) -> Submission:
        """Enqueue; raises :class:`QuotaExceeded` when the submitter already
        holds their quota of active (queued/running) submissions.

        ``mesh="auto"`` hands layout choice to the placement planner: every
        admission pass replaces the submitted mesh/schedule with the
        predicted-fastest feasible plan (``tpu_engine_torch/placement.py``)
        against the then-current fleet and reservation ledger. Refused
        outright (ValueError, reason ``no_estimate:<model>``) for models
        the HBM estimator does not know — the planner cannot bound a
        layout it cannot cost.

        ``workload="serving"`` enters the SAME queue/quota/ledger as
        training, carrying its own ``estimate_fn`` (the KV-pool plane) and
        ``job_factory`` (a decode replica, not a train loop)."""
        if mesh not in (None, "explicit", "auto"):
            raise ValueError(f"mesh must be 'auto' or 'explicit', got {mesh!r}")
        auto_place = mesh == "auto"
        if auto_place:
            if workload != "training":
                raise ValueError("mesh='auto' is only supported for training")
            from tpu_engine_torch.models.config import MODEL_CONFIGS

            if config.model_name not in MODEL_CONFIGS:
                self.planner.no_estimate_refusals_total += 1
                raise ValueError(
                    f"mesh='auto' refused: no_estimate:{config.model_name} "
                    "(the planner cannot cost an unknown model; submit an "
                    "explicit mesh instead)"
                )
        with self._lock:
            quota = self.quotas.get(submitter, self.default_quota)
            if quota is not None:
                active = self._active_by_submitter.get(submitter, 0)
                if active >= quota:
                    raise QuotaExceeded(submitter, quota)
            if (
                workload == "training"
                and not config.checkpoint_dir
                and self.checkpoint_root
            ):
                # Preemptibility needs somewhere to emergency-save; give the
                # submission a stable dir its requeued attempts resume from.
                # (Serving replicas tear down checkpoint-free — no dir.)
                config = dataclasses.replace(
                    config,
                    checkpoint_dir=f"{self.checkpoint_root}/sub_{uuid.uuid4().hex[:8]}",
                )
            self._seq += 1
            sub = Submission(
                config, priority, submitter, self._seq, job_kwargs,
                workload=workload, estimate_fn=estimate_fn,
                job_factory=job_factory,
            )
            sub.auto_place = auto_place
            self._subs[sub.submission_id] = sub
            self._index_add(sub)
            self._by_job_id[sub.job_id] = sub
            self._tenants.add(submitter)
            self._active_by_submitter[submitter] = (
                self._active_by_submitter.get(submitter, 0) + 1
            )
            self.submitted_total += 1
        tracing.get_recorder().event(
            "submit",
            kind="scheduler",
            trace_id=sub.trace_id,
            parent=sub._root_span,
            attrs={
                "priority": priority.name.lower(),
                "submitter": submitter,
                "mesh": "auto" if auto_place else "explicit",
                "workload": workload,
            },
        )
        # Goodput ledger hook: the trace is live from submit — queue wait
        # accrues to the tenant from this moment, not from admission.
        goodput_mod.get_ledger().track(
            sub.trace_id, tenant=submitter, workload=workload
        )
        self._journal_event("sched.submit", self._serialize_sub(sub))
        self._ensure_thread()
        self._wake.set()
        return sub

    def get(self, submission_id: str) -> Optional[Submission]:
        return self._subs.get(submission_id)

    def find_by_job_id(self, job_id: str) -> Optional[Submission]:
        return self._by_job_id.get(job_id)

    def queue_position(self, submission_id: str) -> Optional[int]:
        """1-based position in admission order; None when not queued."""
        with self._lock:
            for i, s in enumerate(self._queued()):
                if s.submission_id == submission_id:
                    return i + 1
        return None

    def cancel(self, submission_id: str) -> bool:
        """Cancel a queued submission immediately; a running one is stopped
        (its final checkpoint still lands) and reaped to CANCELLED."""
        with self._lock:
            sub = self._subs.get(submission_id)
            if sub is None or sub.state in TERMINAL_STATES:
                return False
            if sub.state == SubmissionState.QUEUED:
                self._set_state(sub, SubmissionState.CANCELLED)
                sub.finished_at = time.time()
                self.cancelled_total += 1
                sub.finish_trace("cancelled")
                self._journal_event("sched.finish", {
                    "sid": sub.submission_id,
                    "state": "cancelled",
                    "finished_at": sub.finished_at,
                })
                return True
            self._set_state(sub, SubmissionState.CANCELLING)
            if sub.job is not None:
                sub.job._stop.set()
            self._journal_event(
                "sched.cancelling", {"sid": sub.submission_id}
            )
        self._wake.set()
        return True

    def drain(self) -> None:
        """Stop admitting; running jobs continue, submissions keep queuing."""
        with self._lock:
            self._draining = True

    def resume_admission(self) -> None:
        with self._lock:
            self._draining = False
        self._wake.set()

    # -- external control surface (the autopilot's actuators) -----------------

    def quarantine_device(
        self,
        device_index: int,
        owner: str = "autopilot",
        now: Optional[float] = None,
    ) -> bool:
        """Quarantine one device out of admission on behalf of an external
        controller. Entries tagged ``source="autopilot"`` skip the
        owner-vouch healing in ``_heal_quarantine`` (no submission will
        ever vouch for them): only the quarantine TTL or an explicit
        :meth:`release_quarantine` returns the chip. Returns False when
        the device is already quarantined."""
        idx = int(device_index)
        now = time.time() if now is None else float(now)
        with self._lock:
            if idx in self._hetero_quarantined:
                return False
            self._hetero_quarantined[idx] = {
                "owner": owner, "ts": now, "source": "autopilot",
            }
        self._journal_event("sched.quarantine", {
            "device": idx,
            "entry": {"owner": owner, "ts": now, "source": "autopilot"},
        })
        tracing.get_recorder().event(
            "hetero_quarantine",
            kind="scheduler",
            trace_id="fleet",
            attrs={"devices": [idx], "owner": owner, "source": "autopilot"},
        )
        return True

    def release_quarantine(self, device_index: int) -> bool:
        """Explicitly release one quarantined device (any owner)."""
        idx = int(device_index)
        with self._lock:
            if idx not in self._hetero_quarantined:
                return False
            del self._hetero_quarantined[idx]
        self._journal_event("sched.quarantine_release", {"device": idx})
        tracing.get_recorder().event(
            "hetero_quarantine_release",
            kind="hetero",
            trace_id="fleet",
            attrs={"devices": [idx], "reason": "released"},
        )
        return True

    def request_replan(self, submission_id: Optional[str] = None) -> bool:
        """Ask a running training job to consult its heterogeneity
        rebalancer at the next safe step boundary — the autopilot's
        replan actuator. Targets ``submission_id`` when given, else the
        first RUNNING training job with a heterogeneity plane. The job's
        own rebalancer still applies its hysteresis (cooldown, sustain,
        min-gain); avoided-shrink accounting settles through the normal
        ``_resolve_hetero_consults`` path. Returns True when a consult
        was requested."""
        with self._lock:
            subs = (
                [self._subs.get(submission_id)]
                if submission_id is not None
                else self._running()
            )
            for sub in subs:
                if sub is None or sub.state != SubmissionState.RUNNING:
                    continue
                if sub.workload != "training":
                    continue
                reb = getattr(sub.job, "_hetero", None)
                if reb is None:
                    continue
                self._hetero_pending[sub.submission_id] = (
                    reb.rebalances_total + reb.dry_runs_total
                )
                reb.request_consult()
                tracing.get_recorder().event(
                    "replan_requested",
                    kind="scheduler",
                    trace_id=sub.trace_id,
                    parent=sub._root_span,
                    attrs={
                        "submission_id": sub.submission_id,
                        "consult_requested": True,
                    },
                )
                return True
        return False

    @property
    def draining(self) -> bool:
        return self._draining

    # -- scheduling pass ------------------------------------------------------

    def poll(self) -> None:
        """One pass: reap finished attempts (requeue preempted ones), then
        admit. Idempotent and safe to call from any thread."""
        with self._lock:
            self._reap()
            if not self._draining:
                self._admit()
                self._maybe_rebalance()
                self._maybe_grow()
            queued = self._queued_count()
            running = self._active_count()
            quarantined = len(self._hetero_quarantined)
        # Retain queue depth per poll pass in the historian (outside the
        # lock — the historian has its own). Best effort: scheduling must
        # never fail because observability did.
        try:
            historian_mod.get_historian().record_many(
                {
                    "scheduler_queued": float(queued),
                    "scheduler_running": float(running),
                    "scheduler_quarantined_devices": float(quarantined),
                },
                ts=time.time(),
            )
        except Exception:
            pass

    def wait(self, submission_id: str, timeout: Optional[float] = None) -> Submission:
        """Block until the submission reaches a terminal state."""
        deadline = None if timeout is None else time.time() + timeout
        sub = self._subs[submission_id]
        while sub.state not in TERMINAL_STATES:
            if deadline is not None and time.time() > deadline:
                break
            self.poll()
            if sub.job is not None and sub.state == SubmissionState.RUNNING:
                sub.job.join(timeout=self.poll_interval_s)
            else:
                time.sleep(self.poll_interval_s)
        return sub

    def shutdown(self) -> None:
        self._shutdown.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.precompiler.shutdown()

    # -- durability: write-ahead journal + crash recovery ----------------------

    def attach_journal(
        self, journal: Optional[journal_mod.ControlPlaneJournal]
    ) -> None:
        """Write-ahead every state-changing control event to ``journal``;
        pair with :meth:`restore` on the replacement process after a
        control-plane crash. The journal swallows its own I/O failures
        (``append_errors_total``), so scheduling never blocks on it."""
        self._journal = journal

    def _journal_event(self, kind: str, payload: dict[str, Any]) -> None:
        j = self._journal
        if j is not None:
            j.append(kind, payload)

    @staticmethod
    def _serialize_sub(sub: Submission) -> dict[str, Any]:
        """JSON-safe full identity of one submission — the journal's
        ``sched.submit`` payload and the snapshot's per-submission record.
        Everything restore() needs to rebuild the Submission; the live
        job handle and the un-serializable callables (estimate_fn,
        job_factory) are reconciled against reality instead."""
        return {
            "sid": sub.submission_id,
            "job_id": sub.job_id,
            "seq": sub.seq,
            "priority": int(sub.priority),
            "submitter": sub.submitter,
            "workload": sub.workload,
            "state": sub.state.value,
            "attempts": sub.attempts,
            "preemptions": sub.preemptions,
            "submitted_at": sub.submitted_at,
            "first_admitted_at": sub.first_admitted_at,
            "finished_at": sub.finished_at,
            "last_admitted_at": sub.last_admitted_at,
            "last_skip_reason": sub.last_skip_reason,
            "placement": list(sub.placement),
            "admitted_gang": sub.admitted_gang,
            "shrunk_mesh": dict(sub.shrunk_mesh) if sub.shrunk_mesh else None,
            "trace_id": sub.trace_id,
            "hbm_estimate": (
                sub.estimate.model_dump(mode="json") if sub.estimate else None
            ),
            "config": config_to_dict(sub.config),
        }

    def snapshot_state(self) -> dict[str, Any]:
        """Full serialized scheduler state — the ``scheduler`` section of a
        journal snapshot. Deterministically ordered (seq), so
        ``json.dumps(snapshot_state(), sort_keys=True)`` is a state
        digest: restoring the same journal twice must yield byte-identical
        digests (the ctl_crash lane's double-recovery gate)."""
        with self._lock:
            subs = sorted(self._subs.values(), key=lambda s: s.seq)
            return {
                "seq": self._seq,
                "draining": self._draining,
                "submissions": [self._serialize_sub(s) for s in subs],
                "reserved": {
                    str(i): round(v, 6)
                    for i, v in sorted(self._reserved.items())
                },
                "quarantine": {
                    str(i): dict(e)
                    for i, e in sorted(self._hetero_quarantined.items())
                },
                "counters": {
                    "submitted_total": self.submitted_total,
                    "admitted_total": self.admitted_total,
                    "requeues_total": self.requeues_total,
                    "preemptions_total": self.preemptions_total,
                    "completed_total": self.completed_total,
                    "failed_total": self.failed_total,
                    "cancelled_total": self.cancelled_total,
                },
            }

    def restore(
        self,
        journal: journal_mod.ControlPlaneJournal,
        live_jobs: Optional[dict[str, Any]] = None,
        now: Optional[float] = None,
    ) -> dict[str, Any]:
        """Reconstruct a crashed scheduler from its journal, then reconcile
        against live reality. Call on a FRESHLY constructed scheduler.

        Phase 1 — deterministic rebuild: apply the newest snapshot's
        scheduler section, then replay the ``sched.*`` event suffix onto
        it (submit/admit/requeue/finish/cancelling/quarantine), and
        materialize every submission via the real constructor with its
        journaled identity (submission_id, job_id, seq, timestamps,
        trace_id) restored.

        Phase 2 — reconcile: a journaled-RUNNING submission whose job is
        still alive (``live_jobs[submission_id]``) is **re-adopted** — its
        HBM reservation re-entered, never re-launched; a vanished training
        job is requeued at its original seq (the default job factory and
        estimator serve the re-admission); a vanished serving replica is
        marked failed with reason ``vanished_at_recovery`` (the fleet's
        ``re_adopt`` re-dispatches a fresh one); a re-reservation that
        oversubscribes a device's HBM capacity is a **double grant** — the
        youngest claimant is demoted back to the queue and the device
        quarantined with reason ``ctl_recovery:double_grant``.

        Does not start the pump thread and does not write to the journal,
        so restoring the same journal twice is byte-identical
        (``snapshot_state()`` digests compare equal). Attaches the journal
        for subsequent write-ahead; the caller should write a fresh
        snapshot once recovery settles. Counters without journaled events
        (preemptions, hetero) restore from the snapshot only — bounded
        drift between snapshots, by design."""
        now = time.time() if now is None else float(now)
        doc = journal.read()
        snap = doc.get("snapshot") or {}
        base = (snap.get("sections") or {}).get("scheduler") or {}
        entries: dict[str, dict] = {
            e["sid"]: dict(e)
            for e in base.get("submissions", [])
            if isinstance(e, dict) and e.get("sid")
        }
        counters = {
            "submitted_total": 0,
            "admitted_total": 0,
            "requeues_total": 0,
            "preemptions_total": 0,
            "completed_total": 0,
            "failed_total": 0,
            "cancelled_total": 0,
        }
        counters.update({
            k: int(v) for k, v in (base.get("counters") or {}).items()
            if k in counters
        })
        quarantine: dict[int, dict] = {}
        for k, v in (base.get("quarantine") or {}).items():
            try:
                quarantine[int(k)] = dict(v)
            except (TypeError, ValueError):
                continue

        replayed = 0
        for ev in doc.get("events", []):
            kind = ev.get("kind") or ""
            p = ev.get("payload")
            if not kind.startswith("sched.") or not isinstance(p, dict):
                continue
            replayed += 1
            sid = p.get("sid")
            if kind == "sched.submit" and sid:
                entries[sid] = dict(p)
                counters["submitted_total"] += 1
            elif kind == "sched.admit" and sid in entries:
                e = entries[sid]
                e["state"] = "running"
                e["placement"] = list(p.get("placement") or [])
                for f in (
                    "admitted_gang", "shrunk_mesh", "attempts",
                    "first_admitted_at", "last_admitted_at",
                ):
                    if p.get(f) is not None:
                        e[f] = p[f]
                if p.get("hbm_estimate") is not None:
                    e["hbm_estimate"] = p["hbm_estimate"]
                counters["admitted_total"] += 1
            elif kind == "sched.requeue" and sid in entries:
                e = entries[sid]
                e["state"] = "queued"
                e["placement"] = []
                e["preemptions"] = p.get("preemptions", e.get("preemptions", 0))
                counters["requeues_total"] += 1
            elif kind == "sched.cancelling" and sid in entries:
                entries[sid]["state"] = "cancelling"
            elif kind == "sched.finish" and sid in entries:
                e = entries[sid]
                e["state"] = p.get("state") or "failed"
                e["finished_at"] = p.get("finished_at")
                bucket = {
                    "completed": "completed_total",
                    "cancelled": "cancelled_total",
                    "failed": "failed_total",
                }.get(e["state"])
                if bucket:
                    counters[bucket] += 1
            elif kind == "sched.quarantine" and p.get("device") is not None:
                quarantine[int(p["device"])] = dict(p.get("entry") or {})
            elif kind == "sched.quarantine_release":
                quarantine.pop(int(p.get("device", -1)), None)

        restored = readopted = requeued = vanished_failed = dgrants = 0
        live_jobs = live_jobs or {}
        with self._lock:
            for c, v in counters.items():
                setattr(self, c, v)
            self._draining = bool(base.get("draining", False))
            self._hetero_quarantined = quarantine
            # device index → re-adopted claimants in seq order, for the
            # double-grant audit below.
            claims: dict[int, list[Submission]] = {}
            for e in sorted(entries.values(), key=lambda d: d.get("seq", 0)):
                try:
                    config = config_from_dict(e["config"])
                    sub = Submission(
                        config,
                        JobPriority(int(e.get("priority", JobPriority.NORMAL))),
                        e.get("submitter", "anonymous"),
                        int(e.get("seq", 0)),
                        workload=e.get("workload", "training"),
                    )
                except Exception:
                    log.warning(
                        "restore: could not rebuild submission %s",
                        e.get("sid"), exc_info=True,
                    )
                    continue
                sub.submission_id = e["sid"]
                sub.job_id = e.get("job_id") or sub.job_id
                sub.submitted_at = e.get("submitted_at") or sub.submitted_at
                sub.attempts = int(e.get("attempts") or 0)
                sub.preemptions = int(e.get("preemptions") or 0)
                sub.first_admitted_at = e.get("first_admitted_at")
                sub.finished_at = e.get("finished_at")
                sub.last_admitted_at = e.get("last_admitted_at")
                sub.last_skip_reason = e.get("last_skip_reason")
                sub.admitted_gang = e.get("admitted_gang")
                sub.shrunk_mesh = e.get("shrunk_mesh")
                sub.trace_id = e.get("trace_id") or sub.trace_id
                if e.get("hbm_estimate"):
                    try:
                        sub.estimate = HBMEstimate.model_validate(
                            e["hbm_estimate"]
                        )
                    except Exception:
                        sub.estimate = None
                try:
                    state = SubmissionState(e.get("state", "queued"))
                except ValueError:
                    state = SubmissionState.QUEUED
                sub.state = state
                self._subs[sub.submission_id] = sub
                self._by_job_id[sub.job_id] = sub
                self._tenants.add(sub.submitter)
                self._index_add(sub)
                restored += 1
                if state in TERMINAL_STATES:
                    sub.finish_trace(state.value)
                    continue
                self._active_by_submitter[sub.submitter] = (
                    self._active_by_submitter.get(sub.submitter, 0) + 1
                )
                if state == SubmissionState.QUEUED:
                    continue
                # RUNNING / PREEMPTING / CANCELLING: reconcile vs reality.
                job = live_jobs.get(sub.submission_id)
                if job is not None:
                    # Orphan re-adoption: the work kept running through the
                    # control-plane crash — take it back, never re-launch.
                    sub.job = job
                    sub.placement = [int(i) for i in e.get("placement") or []]
                    if sub.estimate is not None:
                        for idx in sub.placement:
                            self._reserved[idx] = (
                                self._reserved.get(idx, 0.0)
                                + sub.estimate.device_total_gib
                            )
                            claims.setdefault(idx, []).append(sub)
                    if state == SubmissionState.CANCELLING:
                        stop = getattr(job, "_stop", None)
                        if stop is not None:
                            stop.set()
                    readopted += 1
                elif sub.workload == "training":
                    # Vanished with the crash (same host, or killed while
                    # unsupervised): requeue at its ORIGINAL seq — its
                    # checkpoints resume it on re-admission.
                    self._set_state(sub, SubmissionState.QUEUED)
                    sub.job = None
                    sub.placement = []
                    sub.last_skip_reason = "requeued_at_recovery"
                    self.requeues_total += 1
                    requeued += 1
                else:
                    # A vanished serving replica has nothing to resume —
                    # mark it failed; ServingFleet.re_adopt re-dispatches a
                    # fresh replica to meet the journaled desired count.
                    self._set_state(sub, SubmissionState.FAILED)
                    sub.finished_at = now
                    sub.last_skip_reason = "vanished_at_recovery"
                    self.failed_total += 1
                    vanished_failed += 1
                    sub.finish_trace("failed")
            # Double-grant audit: the journal can over-promise (an admit
            # whose crash-interrupted release never journaled). Where the
            # re-entered reservations oversubscribe a device's HBM
            # capacity, the youngest claimant's grant is the bogus one:
            # demote it to the queue and quarantine the device with a
            # structured reason.
            fleet = self._fleet()
            if fleet is not None and fleet.devices:
                cap = {
                    d.index: d.hbm_total_gb
                    for d in fleet.devices if d.hbm_total_gb > 0
                }
                for idx in sorted(claims):
                    if idx not in cap:
                        continue
                    claimants = sorted(claims[idx], key=lambda s: s.seq)
                    while (
                        self._reserved.get(idx, 0.0) > cap[idx] + 1e-9
                        and len(claimants) > 1
                    ):
                        victim = claimants.pop()
                        if victim.state != SubmissionState.RUNNING and (
                            victim.state != SubmissionState.CANCELLING
                        ):
                            continue
                        self._release(victim)
                        stop = getattr(victim.job, "_stop", None)
                        if stop is not None:
                            stop.set()
                        victim.job = None
                        self._set_state(victim, SubmissionState.QUEUED)
                        victim.last_skip_reason = "double_grant_at_recovery"
                        self.requeues_total += 1
                        dgrants += 1
                        self._hetero_quarantined[idx] = {
                            "owner": victim.submission_id,
                            "ts": now,
                            "source": "ctl_recovery:double_grant",
                        }
                        tracing.get_recorder().event(
                            "ctl_recovery_double_grant",
                            kind="scheduler",
                            trace_id=victim.trace_id,
                            attrs={
                                "device": idx,
                                "submission_id": victim.submission_id,
                                "reason": "ctl_recovery:double_grant",
                            },
                        )
            self._seq = max(
                int(base.get("seq", 0)),
                max((s.seq for s in self._subs.values()), default=0),
            )
        journal_mod.note_recovery(
            restores_total=1,
            records_replayed_total=replayed,
            jobs_readopted_total=readopted,
            requeued_vanished_total=requeued,
            double_grants_total=dgrants,
        )
        self._journal = journal
        summary = {
            "restored_submissions": restored,
            "events_replayed": replayed,
            "had_snapshot": bool(snap),
            "readopted": readopted,
            "requeued_vanished": requeued,
            "serving_vanished": vanished_failed,
            "double_grants": dgrants,
            "ingest": doc.get("stats", {}),
        }
        log.info("scheduler: restored from journal — %s", summary)
        return summary

    # -- internals (all hold self._lock) --------------------------------------

    def _index_add(self, sub: Submission) -> None:
        st = sub.state
        if st == SubmissionState.QUEUED:
            dq = self._queued_idx[int(sub.priority)]
            if dq and sub.seq < dq[-1].seq:
                # Preempt-requeue: the submission keeps its ORIGINAL seq
                # (front of its class, not the back) — re-insert in order.
                items = sorted([*dq, sub], key=lambda s: s.seq)
                dq.clear()
                dq.extend(items)
            else:
                dq.append(sub)
        elif st in self._state_idx:
            self._state_idx[st][sub.submission_id] = sub
        elif st in TERMINAL_STATES:
            self._finished_idx[sub.submission_id] = sub

    def _index_discard(self, sub: Submission) -> None:
        st = sub.state
        if st == SubmissionState.QUEUED:
            try:
                self._queued_idx[int(sub.priority)].remove(sub)
            except ValueError:
                pass
        elif st in self._state_idx:
            self._state_idx[st].pop(sub.submission_id, None)
        elif st in TERMINAL_STATES:
            self._finished_idx.pop(sub.submission_id, None)

    def _set_state(self, sub: Submission, new_state: SubmissionState) -> None:
        """The single transition point: moves the submission between state
        buckets and settles the per-submitter active count. Every
        ``sub.state`` write in the scheduler goes through here."""
        old = sub.state
        if old == new_state:
            return
        self._index_discard(sub)
        sub.state = new_state
        self._index_add(sub)
        if old not in TERMINAL_STATES and new_state in TERMINAL_STATES:
            n = self._active_by_submitter.get(sub.submitter, 0) - 1
            if n > 0:
                self._active_by_submitter[sub.submitter] = n
            else:
                self._active_by_submitter.pop(sub.submitter, None)
            while (
                self.max_finished_history > 0
                and len(self._finished_idx) > self.max_finished_history
            ):
                sid = next(iter(self._finished_idx))
                evicted = self._finished_idx.pop(sid)
                self._subs.pop(sid, None)
                if self._by_job_id.get(evicted.job_id) is evicted:
                    del self._by_job_id[evicted.job_id]
                self.finished_evicted_total += 1

    def _queued(self) -> list[Submission]:
        """Admission order — priority classes high→low, FIFO (seq) within.
        O(queued): concatenates the per-priority index deques (each already
        seq-ordered); never scans ``_subs``."""
        out: list[Submission] = []
        for p in sorted(self._queued_idx, reverse=True):
            out.extend(self._queued_idx[p])
        return out

    def _queued_count(self) -> int:
        return sum(len(dq) for dq in self._queued_idx.values())

    def _queued_heads(self, k: int) -> list[Submission]:
        """First ``k`` submissions in admission order — what one admission
        pass actually looks at (the backfill window), O(k)."""
        heads: list[Submission] = []
        for p in sorted(self._queued_idx, reverse=True):
            for s in self._queued_idx[p]:
                heads.append(s)
                if len(heads) >= k:
                    return heads
        return heads

    def _active(self) -> list[Submission]:
        subs = [
            s for idx in self._state_idx.values() for s in idx.values()
        ]
        subs.sort(key=lambda s: s.seq)  # == _subs insertion order
        return subs

    def _active_count(self) -> int:
        return sum(len(idx) for idx in self._state_idx.values())

    def _running(self) -> list[Submission]:
        subs = list(self._state_idx[SubmissionState.RUNNING].values())
        subs.sort(key=lambda s: s.seq)
        return subs

    def _release(self, sub: Submission) -> None:
        for idx in sub.placement:
            est = sub.estimate.device_total_gib if sub.estimate else 0.0
            left = self._reserved.get(idx, 0.0) - est
            if left <= 1e-9:
                self._reserved.pop(idx, None)
            else:
                self._reserved[idx] = left
        sub.placement = []

    def _credit_busy(self, sub: Submission) -> None:
        """Accumulate this attempt's admission→reap seconds to the
        submitter's goodput lane (summed across attempts)."""
        if sub.last_admitted_at is None:
            return
        self._tenant_busy_s[sub.submitter] = self._tenant_busy_s.get(
            sub.submitter, 0.0
        ) + max(time.time() - sub.last_admitted_at, 0.0)
        sub.last_admitted_at = None

    def _reap(self) -> None:
        for sub in self._active():
            job = sub.job
            if job is None or job.is_alive:
                continue
            # Predicted-vs-observed step time for auto-placed attempts:
            # wall seconds held ÷ steps run feeds the planner's error gauge
            # (tpu_engine_placement_step_time_abs_rel_error).
            if sub.predicted_step_time_s and sub.last_admitted_at is not None:
                steps = getattr(job, "current_step", None)
                if steps:
                    self.planner.record_observation(
                        sub.predicted_step_time_s,
                        max(time.time() - sub.last_admitted_at, 1e-9) / steps,
                    )
            self._credit_busy(sub)
            if job.status == JobStatus.PREEMPTED and sub.state != SubmissionState.CANCELLING:
                # Emergency save completed (the train loop's final
                # force+wait save runs before the thread exits) — requeue
                # at the submission's ORIGINAL seq: a preempted job goes
                # back to the front of its priority class, it does not
                # re-pay the whole wait.
                self._release(sub)
                self._set_state(sub, SubmissionState.QUEUED)
                sub.preemptions += 1
                sub.job = None
                self.requeues_total += 1
                if str(getattr(job, "preemption_reason", "") or "").startswith("self-heal"):
                    self.self_heal_requeues_total += 1
                tracing.get_recorder().event(
                    "requeue",
                    kind="scheduler",
                    trace_id=sub.trace_id,
                    parent=sub._root_span,
                    attrs={
                        "step": job.current_step,
                        "reason": getattr(job, "preemption_reason", None),
                        "preemptions": sub.preemptions,
                    },
                )
                self._journal_event("sched.requeue", {
                    "sid": sub.submission_id,
                    "preemptions": sub.preemptions,
                })
                log.info(
                    "scheduler: %s preempted at step %s — requeued",
                    sub.submission_id, job.current_step,
                )
            elif job.status in (
                JobStatus.COMPLETED,
                JobStatus.FAILED,
                JobStatus.STOPPED,
                JobStatus.PREEMPTED,  # cancelled mid-preempt
            ) or sub.state == SubmissionState.CANCELLING:
                self._release(sub)
                sub.finished_at = time.time()
                if sub.state == SubmissionState.CANCELLING:
                    self._set_state(sub, SubmissionState.CANCELLED)
                    self.cancelled_total += 1
                elif job.status == JobStatus.COMPLETED:
                    self._set_state(sub, SubmissionState.COMPLETED)
                    self.completed_total += 1
                    self._tenant_completed[sub.submitter] = (
                        self._tenant_completed.get(sub.submitter, 0) + 1
                    )
                elif job.status == JobStatus.STOPPED:
                    self._set_state(sub, SubmissionState.CANCELLED)
                    self.cancelled_total += 1
                else:
                    self._set_state(sub, SubmissionState.FAILED)
                    self.failed_total += 1
                sub.finish_trace(sub.state.value)
                self._journal_event("sched.finish", {
                    "sid": sub.submission_id,
                    "state": sub.state.value,
                    "finished_at": sub.finished_at,
                })

    def _note_skip(self, sub: Submission, reason: str) -> None:
        """Set the structured skip reason; a CHANGED reason is mirrored to
        the flight recorder (recording every 0.1 s poll pass of the same
        refusal would flood the bounded buffer with no information)."""
        if reason != sub.last_skip_reason:
            tracing.get_recorder().event(
                "admission_skip",
                kind="scheduler",
                trace_id=sub.trace_id,
                parent=sub._root_span,
                attrs={"reason": reason},
            )
        sub.last_skip_reason = reason

    def _fleet(self) -> Optional[TPUFleetStatus]:
        if self.fleet_fn is None:
            return None
        try:
            return self.fleet_fn()
        except Exception:  # degraded telemetry must not brick admission
            log.exception("scheduler: fleet snapshot failed — capacity-only pass")
            return None

    def _eligible(self, fleet: TPUFleetStatus) -> list:
        """Placement-eligible chips: healthy AND not hetero-quarantined —
        a chip shed by a hetero shrink stays out of admission until its
        throughput estimate heals (``_maybe_rebalance`` releases it)."""
        return [
            d for d in fleet.devices
            if d.is_available and d.index not in self._hetero_quarantined
        ]

    def _admit(self) -> None:
        # One pass touches only the backfill window of queued heads — the
        # rest of the queue (and every terminal submission) stays cold.
        queued = self._queued_heads(max(self.backfill_depth, 1))
        if not queued:
            return
        fleet = self._fleet()
        slots = self.max_concurrent_jobs - self._active_count()

        preempt_wanted = False
        for rank, sub in enumerate(queued):
            if slots <= 0:
                if rank == 0:
                    self._note_skip(sub, "at max_concurrent_jobs capacity")
                    # Eviction frees a slot and HBM — but never heals a
                    # chip. A head whose gang exceeds the healthy fleet
                    # must not thrash victims it can never replace.
                    preempt_wanted = self._placeable(sub, fleet)
                break
            if self._try_admit(sub, fleet):
                slots -= 1
            elif rank == 0 and "healthy chip" not in (sub.last_skip_reason or ""):
                # Only the HEAD preempts (backfill candidates must never
                # evict work), and only when eviction can actually help:
                # capacity or HBM headroom — not a gang larger than the
                # healthy fleet, which no preemption fixes.
                preempt_wanted = True
        if preempt_wanted:
            self._maybe_preempt(queued[0])

    def _placeable(self, sub: Submission, fleet: Optional[TPUFleetStatus]) -> bool:
        """Could ``sub``'s gang fit the healthy fleet if capacity/HBM were
        freed? (No fleet view → capacity-only admission → always yes.)"""
        if fleet is None or not fleet.devices:
            return True
        eligible = self._eligible(fleet)
        if sub.auto_place:
            # The planner re-sizes to whatever is healthy — placeable as
            # long as anything is (HBM may still refuse, like any job).
            return bool(eligible)
        return gang_size(sub.config, len(eligible)) <= len(eligible)

    def _saved_topology(self, sub: Submission) -> Optional[dict]:
        """The mesh factorization ``sub``'s checkpoints were saved under
        (reshard-plane manifest next to the checkpoint steps), or None: no
        checkpoint_dir, no manifest yet (fresh job), or unreadable —
        admission must never block on manifest I/O."""
        directory = getattr(sub.config, "checkpoint_dir", None)
        if not directory:
            return None
        try:
            from tpu_engine_torch import reshard

            return reshard.read_topology(directory)
        except Exception:
            return None

    def _plan_auto(self, sub: Submission, eligible, n_avail: int):
        """Pick the predicted-fastest feasible plan for an auto-placed
        submission. Returns the chosen :class:`PlacementPlan` (its config
        becomes this attempt's config) or None with a structured skip
        reason — including the next-best fallback trail when faster plans
        were unplaceable against live headroom."""
        # Honor the submitted gang (data=-1 resolves to "best available" =
        # everything eligible): the planner searches layouts AT that size
        # and only falls back to smaller gangs when nothing at the
        # requested size is feasible (HBM) or the fleet is degraded.
        requested = gang_size(sub.config, n_avail)
        # Resume-aware planning: the factorization this submission's
        # checkpoints were saved under (reshard plane manifest) prices a
        # remap into every candidate and rejects the ones the plane
        # cannot bridge (pipe extent changes).
        saved_topo = self._saved_topology(sub)
        if requested <= n_avail:
            result = self.planner.plan(
                sub.config, devices=eligible, reserved=self._reserved,
                gang=requested, saved_topology=saved_topo,
            )
            if not result.plans and not result.skip_reason:
                result = self.planner.plan(
                    sub.config, devices=eligible, reserved=self._reserved,
                    n_avail=requested, saved_topology=saved_topo,
                )
        else:
            result = self.planner.plan(
                sub.config, devices=eligible, reserved=self._reserved,
                n_avail=n_avail, saved_topology=saved_topo,
            )
        if result.skip_reason:  # no_estimate:<model>
            self._note_skip(sub, result.skip_reason)
            return None
        head = result.best
        if head is None:
            reasons = sorted(
                {p.skip_reason for p in result.infeasible if p.skip_reason}
            )
            if any(
                r.startswith("no_topology_compatible_checkpoint")
                for r in reasons
            ):
                # Some otherwise-admissible layout was refused because the
                # saved checkpoints only exist for a factorization the
                # reshard plane cannot bridge (every other rejection here
                # is HBM/headroom, i.e. could not run regardless) — the
                # structured skip the queue surface reports instead of a
                # generic restore failure downstream.
                self._note_skip(
                    sub,
                    f"no_topology_compatible_checkpoint:{sub.config.model_name}",
                )
                return None
            self._note_skip(
                sub,
                "auto-placement: no feasible layout"
                + (f" — {reasons[0]}" if reasons else ""),
            )
            return None
        # Plans that predicted faster than the choice but were unplaceable
        # (HBM headroom) — the structured record of the next-best fallback.
        passed_over = sorted(
            (
                p for p in result.infeasible
                if p.predicted_step_time_s < head.predicted_step_time_s
            ),
            key=lambda p: p.predicted_step_time_s,
        )
        sub.placement_plan = {
            "chosen": head.model_dump(exclude={"config", "hbm_estimate"}),
            "label": head.label,
            "evaluated": result.evaluated,
            "feasible": len(result.plans),
            "pruned": len(result.pruned),
            "fallback_from": [
                {"layout": p.label, "reason": p.skip_reason}
                for p in passed_over[:3]
            ],
            "search_s": round(result.search_s, 6),
        }
        sub.predicted_step_time_s = head.predicted_step_time_s
        sub.config = head.config
        return head

    def _try_admit(self, sub: Submission, fleet: Optional[TPUFleetStatus]) -> bool:
        t_admit0 = time.time()
        eligible = None
        if fleet is not None and fleet.devices:
            eligible = self._eligible(fleet)
        n_avail = len(eligible) if eligible is not None else self._n_visible()

        estimate_fn = sub.estimate_fn or self.estimate_fn
        no_est_reason = None
        head = None
        if sub.auto_place:
            t_plan0 = time.time()
            head = self._plan_auto(sub, eligible, n_avail)
            if head is None:
                return False
            # Recorded only for the CHOSEN plan — a queued-but-infeasible
            # auto submission re-plans every poll pass and would flood.
            tracing.get_recorder().record_span(
                "placement_plan",
                kind="placement_plan",
                trace_id=sub.trace_id,
                parent=sub._root_span,
                t0=t_plan0,
                attrs={
                    "label": (sub.placement_plan or {}).get("label"),
                    "evaluated": (sub.placement_plan or {}).get("evaluated"),
                    "feasible": (sub.placement_plan or {}).get("feasible"),
                    "pruned": (sub.placement_plan or {}).get("pruned"),
                    "search_s": (sub.placement_plan or {}).get("search_s"),
                    "predicted_step_time_s": sub.predicted_step_time_s,
                },
            )
            gang, est = head.gang, head.hbm_estimate
            sub.estimate = est
        else:
            gang = gang_size(sub.config, n_avail)
            saved_topo = self._saved_topology(sub)
            if saved_topo is not None and sub.workload == "training":
                from tpu_engine_torch import reshard

                target = {
                    ax: int(getattr(sub.config.mesh, ax, 1) or 1)
                    for ax in ("fsdp", "pipe", "sequence", "model")
                }
                ok, _why = reshard.topology_compatible(saved_topo, target)
                if not ok:
                    # A fixed-mesh resume candidate whose checkpoints only
                    # exist for a factorization the reshard plane cannot
                    # bridge: refuse with the structured reason instead of
                    # admitting into a guaranteed restore failure.
                    self._note_skip(
                        sub,
                        "no_topology_compatible_checkpoint:"
                        f"{sub.config.model_name}",
                    )
                    return False
            try:
                est = estimate_fn(sub.config, n_avail)
            except Exception:  # estimator must never block admission
                est = None
            sub.estimate = est
            if est is None and sub.workload == "training":
                from tpu_engine_torch.models.config import MODEL_CONFIGS

                if sub.config.model_name not in MODEL_CONFIGS:
                    # Structured skip annotation: admission still proceeds
                    # capacity-only (missing telemetry must not brick the
                    # queue), but the queue surface names WHY there is no
                    # HBM estimate — and stays on the submission if the
                    # job construction fails downstream.
                    no_est_reason = f"no_estimate:{sub.config.model_name}"
                    if sub.last_skip_reason != no_est_reason:
                        self.no_estimate_skips_total += 1
                    sub.last_skip_reason = no_est_reason

        placement: list[int] = []
        shrunk_mesh = None
        # The configured (pre-shrink) gang — the goodput ledger's
        # healthy-mesh-equivalent baseline for the shrink-degraded split.
        configured_gang = gang
        if eligible is not None:
            if gang > len(eligible):
                # Elastic-shrink admission: a job with declared elastic
                # bounds is admitted at the largest mesh its bounds allow on
                # the healthy remainder instead of being skipped — the
                # paper's keep-training-on-a-degraded-fleet behavior.
                shrink = elastic_shrink_plan(sub.config, len(eligible), estimate_fn)
                if shrink is None:
                    self._note_skip(
                        sub,
                        f"gang of {gang} device(s) > {len(eligible)} healthy chip(s)",
                    )
                    return False
                shrunk_mesh, gang, est = shrink
                sub.estimate = est
                sub.last_skip_reason = None
            # HBM gate only when the fleet actually reports HBM (CPU chips
            # report 0 total — capacity-only there).
            hbm_known = all(d.hbm_total_gb > 0 for d in eligible)
            if hbm_known and est is not None:
                need = est.device_total_gib
                fits = [
                    d
                    for d in eligible
                    if d.hbm_free_gb - self._reserved.get(d.index, 0.0) >= need
                ]
                if gang > len(fits):
                    self._note_skip(
                        sub,
                        f"needs {need:.2f} GiB/device on {gang} chip(s); only "
                        f"{len(fits)} have that headroom",
                    )
                    return False
                # Most-headroom-first keeps the fleet balanced.
                fits.sort(
                    key=lambda d: -(d.hbm_free_gb - self._reserved.get(d.index, 0.0))
                )
                placement = [d.index for d in fits[:gang]]
            else:
                placement = [d.index for d in eligible[:gang]]

        # Shrunk admission pins the attempt to the healthy chips it was
        # placed on — without pinning, the job would span ALL visible
        # devices, unhealthy one included. The factory receives the pin via
        # job_kwargs (stub factories that ignore kwargs are unaffected).
        sub.job_kwargs.pop("devices", None)
        # The attempt joins the submission's trace: every compile/save/
        # recovery span it records chains under this root.
        sub.job_kwargs["trace_id"] = sub.trace_id
        # Self-healing detection: the supervisor watches the same fleet
        # health view admission uses (explicit caller wiring wins).
        if self.fleet_fn is not None:
            sub.job_kwargs.setdefault("fleet_fn", self.fleet_fn)
        pin_needed = shrunk_mesh is not None or (
            # An auto plan sized below the full fleet must not span the
            # unhealthy remainder — pin it exactly like a shrunk admission.
            sub.auto_place
            and fleet is not None
            and gang < len(fleet.devices)
        )
        if pin_needed and placement:
            devs = self._runtime_devices_for(placement)
            if devs is None:
                self._note_skip(
                    sub,
                    f"admission at {gang} device(s) admissible, but the "
                    f"fleet indices {placement} do not map onto this "
                    "process's runtime devices",
                )
                return False
            sub.job_kwargs["devices"] = devs

        try:
            job = (sub.job_factory or self.job_factory)(sub)
        except Exception as e:  # noqa: BLE001 — constructor boundary
            self._set_state(sub, SubmissionState.FAILED)
            sub.finished_at = time.time()
            reason = f"job construction failed: {type(e).__name__}: {e}"
            if no_est_reason:
                reason = f"{no_est_reason}; {reason}"
            sub.last_skip_reason = reason
            self.failed_total += 1
            sub.finish_trace("failed")
            return False

        sub.job = job
        sub.attempts += 1
        self._set_state(sub, SubmissionState.RUNNING)
        # A capacity-only admission keeps its structured annotation (the
        # queue surface should say WHY the HBM gate was skipped); every
        # other stale skip reason clears on success.
        sub.last_skip_reason = no_est_reason
        sub.placement = placement
        sub.admitted_gang = gang
        sub.shrunk_mesh = (dataclasses.asdict(shrunk_mesh)
                           if shrunk_mesh is not None else None)
        sub.last_admitted_at = time.time()
        rec = tracing.get_recorder()
        rec.record_span(
            "admission",
            kind="admission",
            trace_id=sub.trace_id,
            parent=sub._root_span,
            t0=t_admit0,
            t1=sub.last_admitted_at,
            attrs={
                "attempt": sub.attempts,
                "gang": gang,
                "configured_gang": configured_gang,
                "placement": list(placement),
                "shrunk_mesh": sub.shrunk_mesh,
                "auto_place": sub.auto_place,
            },
        )
        if shrunk_mesh is not None:
            rec.event(
                "shrink_admit",
                kind="scheduler",
                trace_id=sub.trace_id,
                parent=sub._root_span,
                attrs={"mesh": sub.shrunk_mesh, "gang": gang},
            )
            sub.last_resize_at = sub.last_admitted_at
            self.elastic_shrinks_total += 1
            log.warning(
                "scheduler: elastic-shrink admission of %s — configured gang "
                "does not fit the healthy fleet; admitted at %s on %d chip(s)",
                sub.submission_id, sub.shrunk_mesh, gang,
            )
        if est is not None:
            for idx in placement:
                self._reserved[idx] = (
                    self._reserved.get(idx, 0.0) + est.device_total_gib
                )
        if sub.auto_place:
            self.auto_admissions_total += 1
            if head is not None:
                self.planner.note_chosen(head)
        if sub.first_admitted_at is None:
            sub.first_admitted_at = time.time()
            wait = sub.wait_s or 0.0
            self._wait_samples.append(wait)
            del self._wait_samples[:-1000]
            _observe_hist(self._wait_hist, wait)
            self._wait_hist_sum += wait
            self._wait_hist_count += 1
            t_hist = self._tenant_wait_hist.setdefault(
                sub.submitter, {b: 0 for b in WAIT_BUCKETS_S}
            )
            _observe_hist(t_hist, wait)
            self._tenant_wait_hist_sum[sub.submitter] = (
                self._tenant_wait_hist_sum.get(sub.submitter, 0.0) + wait
            )
            self._tenant_wait_hist_count[sub.submitter] = (
                self._tenant_wait_hist_count.get(sub.submitter, 0) + 1
            )
            waits = self._tenant_waits.setdefault(sub.submitter, [])
            waits.append(wait)
            del waits[:-200]
        self.admitted_total += 1
        self._journal_event("sched.admit", {
            "sid": sub.submission_id,
            "placement": list(placement),
            "admitted_gang": sub.admitted_gang,
            "shrunk_mesh": sub.shrunk_mesh,
            "attempts": sub.attempts,
            "first_admitted_at": sub.first_admitted_at,
            "last_admitted_at": sub.last_admitted_at,
            "hbm_estimate": (
                est.model_dump(mode="json") if est is not None else None
            ),
        })
        job.start()
        log.info(
            "scheduler: admitted %s (%s, priority %s, attempt %d, gang %d)",
            sub.submission_id, sub.config.model_name,
            sub.priority.name, sub.attempts, gang,
        )
        return True

    def _n_visible(self) -> int:
        """Devices this process can place on without a fleet view: the
        visible cards, or one CPU device."""
        return visible_device_count() if self.device == "cuda" else 1

    def _runtime_devices_for(self, placement: list[int]) -> Optional[list[torch.device]]:
        """Map fleet snapshot indices onto this process's runtime devices:
        ``cuda:i`` (the live fleet is built from the visible cards in
        order), or the CPU for a scheduler on ``"cpu"``. None when the
        indices don't map (injected/mock fleet over a differently-sized
        runtime) — the caller then declines the shrink rather than pinning
        the wrong chips."""
        if any(i < 0 for i in placement):
            return None
        if self.device == "cpu":  # every index is the one CPU device
            return [torch.device("cpu")] * len(placement)
        if any(i >= torch.cuda.device_count() for i in placement):
            return None
        return [torch.device("cuda", i) for i in placement]

    def _fleet_rel_throughput(self) -> list[float]:
        """Per-device relative throughput for the placement cost model.

        Expands the active hetero tracker's per-process estimates across
        each process's chip block; empty list (= assume nominal) when no
        heterogeneity plane is live."""
        reb = hetero_mod.get_active()
        if reb is None:
            for sub in list(self._subs.values()):
                cand = getattr(sub.job, "_hetero", None)
                if cand is not None:
                    reb = cand
                    break
        if reb is None:
            return []
        tput = reb.tracker.relative_throughput()
        n_proc = len(tput)
        if n_proc == 0:
            return []
        fleet = self._fleet()
        n_dev = len(fleet.devices) if fleet is not None and fleet.devices else n_proc
        dev_per_proc = max(n_dev // n_proc, 1)
        return [
            tput[min(i // dev_per_proc, n_proc - 1)] for i in range(n_dev)
        ]

    def _heal_quarantine(self, now: float) -> None:
        """Release quarantined chips. Runs every pass, independent of the
        job loop, so an entry can never outlive anyone able to vouch for
        it: released when the owning submission's tracker reads the chip's
        process healthy again (``hetero_heal_threshold``), when the owner
        has left the scheduler or reached a terminal state, when the owner
        is RUNNING without
        a heterogeneity plane (no tracker will ever vouch), or when the
        quarantine TTL expires. Grow-back then reclaims the chips through
        the normal precompile-gated path."""
        if not self._hetero_quarantined:
            return
        released: dict[str, list[int]] = {}
        for idx, ent in list(self._hetero_quarantined.items()):
            reason = None
            if ent.get("source") == "autopilot":
                # Autopilot drains have no owning submission to vouch for
                # them — only the TTL below or an explicit
                # release_quarantine() returns the chips.
                if (
                    self.hetero_quarantine_ttl_s > 0
                    and now - ent["ts"] >= self.hetero_quarantine_ttl_s
                ):
                    reason = "ttl-expired"
                if reason is not None:
                    del self._hetero_quarantined[idx]
                    released.setdefault(reason, []).append(idx)
                continue
            sub = self._subs.get(ent["owner"])
            if sub is None or sub.state in TERMINAL_STATES:
                # Finished/failed/cancelled owners are kept in _subs as
                # history; their quarantine must not outlive them.
                reason = "owner-gone"
            elif (
                self.hetero_quarantine_ttl_s > 0
                and now - ent["ts"] >= self.hetero_quarantine_ttl_s
            ):
                reason = "ttl-expired"
            elif sub.state == SubmissionState.RUNNING:
                reb = getattr(sub.job, "_hetero", None)
                if reb is None:
                    reason = "no-tracker"
                else:
                    tput = reb.tracker.relative_throughput()
                    n_proc = len(tput)
                    if n_proc:
                        fleet = self._fleet()
                        n_dev = (
                            len(fleet.devices)
                            if fleet is not None and fleet.devices else n_proc
                        )
                        dev_per_proc = max(n_dev // n_proc, 1)
                        if (
                            tput[min(idx // dev_per_proc, n_proc - 1)]
                            >= self.hetero_heal_threshold
                        ):
                            reason = "healed"
            if reason is not None:
                del self._hetero_quarantined[idx]
                released.setdefault(reason, []).append(idx)
        for reason, idxs in released.items():
            for idx in sorted(idxs):
                self._journal_event(
                    "sched.quarantine_release", {"device": idx}
                )
            tracing.get_recorder().event(
                "hetero_quarantine_release",
                kind="hetero",
                trace_id="fleet",
                attrs={"devices": sorted(idxs), "reason": reason},
            )

    def _resolve_hetero_consults(self) -> None:
        """Settle earlier rebalance-preferred decisions: a shrink counts
        as *avoided* only once the job's rebalancer actually fired a plan
        (live or dry-run) for the requested consult — a consult that
        declined (cooldown, sustain, gain floor) is dropped without
        inflating the headline counter."""
        for sid, baseline in list(self._hetero_pending.items()):
            sub = self._subs.get(sid)
            reb = getattr(sub.job, "_hetero", None) if sub is not None else None
            if sub is None or sub.state != SubmissionState.RUNNING or reb is None:
                del self._hetero_pending[sid]
                continue
            acted = reb.rebalances_total + reb.dry_runs_total
            if acted > baseline:
                self.hetero_shrinks_avoided_total += 1
                self.hetero_rebalances_total += 1
                del self._hetero_pending[sid]
            elif not reb.consult_pending():
                # Consumed and declined — not a win, just forgotten.
                del self._hetero_pending[sid]

    def _maybe_rebalance(self) -> None:
        """Prefer throughput-weighted rebalance over elastic shrink for
        slow-but-HEALTHY hosts (``tpu_engine_torch/hetero.py``).

        One decision per pass, cooldown-bounded, audited on the flight
        recorder. For each running training job with a heterogeneity
        plane: when its tracker shows sustained imbalance, the scheduler
        first checks what the best integer row reassignment would recover
        — if that predicted goodput clears ``hetero_goodput_floor`` the
        job keeps every chip and the scheduler *requests a consult* that
        the job's rebalancer serves at its next step boundary (the only
        safe reassignment point; the supervisor applies the plan through
        ``data_fn.reassign``). The avoided-shrink accounting settles on a
        later pass, once the consult actually fired. Only when rebalance
        cannot clear the floor does the slow host's chip set get
        quarantined out of admission and the job preempt-requeued to
        re-admit at the reduced (full-speed) gang; ``_heal_quarantine``
        releases the chips when the estimate heals, the owner leaves, or
        the TTL expires."""
        now = time.time()
        # Heal + settle before any early return: quarantine entries and
        # pending consults must never leak behind the feature gate or a
        # drain.
        self._heal_quarantine(now)
        self._resolve_hetero_consults()
        if not self.hetero_rebalance or self._draining:
            return
        if self._state_idx[SubmissionState.PREEMPTING]:
            return
        for sub in self._running():
            if sub.workload != "training":
                continue
            reb = getattr(sub.job, "_hetero", None)
            if reb is None:
                continue
            tracker = reb.tracker
            tput = tracker.relative_throughput()
            n_proc = len(tput)
            if tracker.imbalance() < self.hetero_imbalance_trigger:
                continue
            if (
                self.hetero_cooldown_s > 0
                and self._last_hetero_action_at is not None
                and now - self._last_hetero_action_at < self.hetero_cooldown_s
            ):
                return
            try:
                proposed = hetero_mod.solve_row_assignment(
                    tput, reb.global_micro, min_rows=reb.min_rows
                )
            except (hetero_mod.InfeasibleAssignment, ValueError):
                continue
            rebalanced = hetero_mod.predicted_goodput(proposed, tput)
            if rebalanced >= self.hetero_goodput_floor:
                if sub.submission_id in self._hetero_pending:
                    continue  # consult already requested; let it settle
                # Slow but recoverable: prefer rebalance over shedding the
                # host. The job's own rebalancer applies its hysteresis
                # (cooldown, sustain, min-gain) when the supervisor serves
                # the consult at its next step boundary.
                self.hetero_rebalance_preferred_total += 1
                self._hetero_pending[sub.submission_id] = (
                    reb.rebalances_total + reb.dry_runs_total
                )
                reb.request_consult()
                tracing.get_recorder().event(
                    "hetero_rebalance_preferred",
                    kind="hetero",
                    trace_id=sub.trace_id,
                    parent=sub._root_span,
                    attrs={
                        "predicted_goodput": round(rebalanced, 4),
                        "goodput_floor": self.hetero_goodput_floor,
                        "assignment": list(proposed),
                        "consult_requested": True,
                    },
                )
                self._last_hetero_action_at = now
                return
            if not sub.preemptible:
                continue
            # Rebalance cannot clear the floor — shed the slow host:
            # quarantine its chips and preempt-requeue; re-admission's
            # elastic_shrink_plan lands the job on the full-speed rest.
            fleet = self._fleet()
            n_dev = len(fleet.devices) if fleet is not None and fleet.devices else n_proc
            dev_per_proc = max(n_dev // n_proc, 1)
            slow_proc = min(range(n_proc), key=lambda i: tput[i])
            shed = set(
                range(slow_proc * dev_per_proc, (slow_proc + 1) * dev_per_proc)
            )
            for idx in shed:
                self._hetero_quarantined[idx] = {
                    "owner": sub.submission_id, "ts": now,
                }
            for idx in sorted(shed):
                self._journal_event("sched.quarantine", {
                    "device": idx,
                    "entry": {"owner": sub.submission_id, "ts": now},
                })
            self.hetero_shrinks_total += 1
            self.preemptions_total += 1
            self._set_state(sub, SubmissionState.PREEMPTING)
            sub.last_resize_at = now
            self._last_hetero_action_at = now
            tracing.get_recorder().event(
                "hetero_shrink",
                kind="hetero",
                trace_id=sub.trace_id,
                parent=sub._root_span,
                attrs={
                    "predicted_goodput": round(rebalanced, 4),
                    "goodput_floor": self.hetero_goodput_floor,
                    "slow_process": slow_proc,
                    "quarantined": sorted(shed),
                },
            )
            log.info(
                "scheduler: hetero shrink of %s — best rebalance goodput "
                "%.3f < floor %.3f; quarantining chips %s",
                sub.submission_id, rebalanced, self.hetero_goodput_floor,
                sorted(shed),
            )
            sub.job.watcher.simulate_interruption()
            return

    def _maybe_grow(self) -> None:
        """Grow elastic jobs back when quarantined chips recover.

        A RUNNING job admitted shrunk is preempt-requeued (checkpoint →
        requeue → re-admit) when the healthy fleet now supports a strictly
        larger gang for it — one per pass, only when the queue is empty
        (queued work has first claim on freed chips) and no other
        preemption is in flight."""
        if not self.grow_back or self._draining or self._queued_count():
            return
        if self._state_idx[SubmissionState.PREEMPTING]:
            return
        fleet = self._fleet()
        if fleet is None or not fleet.devices:
            return
        # Health-keyed, not availability-keyed: the candidate's OWN chips
        # are busy (it is running on them) but still count toward the gang
        # it could occupy after the requeue round-trip.
        from tpu_engine_torch.tpu_manager import TPUHealthStatus

        healthy_devs = [
            d for d in fleet.devices
            if d.health_status != TPUHealthStatus.CRITICAL
            and d.index not in self._hetero_quarantined
        ]
        healthy = len(healthy_devs)
        now = time.time()
        for sub in self._running():
            if (
                sub.shrunk_mesh is None
                or sub.admitted_gang is None
                or not sub.preemptible
            ):
                continue
            if (
                self.grow_back_cooldown_s > 0
                and sub.last_resize_at is not None
                and now - sub.last_resize_at < self.grow_back_cooldown_s
            ):
                # Hysteresis: the chip that freed up may be the same one
                # that flapped this job into its shrink moments ago — hold
                # the grow until the fleet has stayed healthy a full
                # cooldown, or a flap cadence under the window turns into a
                # preempt/save/recompile storm.
                continue
            # Planner-driven target: the full configured gang when it fits,
            # else the largest feasible INTERMEDIATE mesh of the elastic
            # family — both HBM-gated against per-device headroom minus
            # every OTHER job's reservation (this job's own chips free up
            # on the requeue round-trip, so its reservation is dropped).
            own = sub.estimate.device_total_gib if sub.estimate else 0.0
            others_reserved = dict(self._reserved)
            for idx in sub.placement:
                left = others_reserved.get(idx, 0.0) - own
                if left <= 1e-9:
                    others_reserved.pop(idx, None)
                else:
                    others_reserved[idx] = left
            target = self.planner.grow_target(
                sub.config, healthy_devs, others_reserved, sub.admitted_gang,
                estimate_fn=sub.estimate_fn or self.estimate_fn,
            )
            if target is None:
                continue
            if not self._grow_target_warm_or_deadline(sub, target, now):
                # Background precompile of the target layout in flight —
                # hold the preempt until the destination mesh is warm (or
                # the deadline/failure path lets the grow proceed cold).
                continue
            self.grow_backs_total += 1
            self._set_state(sub, SubmissionState.PREEMPTING)
            sub.last_resize_at = now
            self.preemptions_total += 1
            tracing.get_recorder().event(
                "grow_back",
                kind="scheduler",
                trace_id=sub.trace_id,
                parent=sub._root_span,
                attrs={
                    "healthy": healthy,
                    "target_gang": target,
                    "current_gang": sub.admitted_gang,
                },
            )
            log.info(
                "scheduler: growing %s back — %d healthy chip(s) now admit "
                "gang %d (> current %d); checkpoint-requeue to resize",
                sub.submission_id, healthy, target, sub.admitted_gang,
            )
            sub.job.watcher.simulate_interruption()
            return

    def _grow_target_key(self, sub: Submission, target: int) -> Optional[str]:
        """(key, label) of the layout a grow-back to ``target`` lands on:
        the configured mesh when the target is the full gang, else the
        elastic family's mesh at that size. None when the layout cannot be
        determined — the grow then proceeds ungated (a keying problem must
        never pin a job at its shrunk size)."""
        try:
            cfg = sub.config
            full = gang_size(cfg, max(target, sub.admitted_gang or 1))
            if target >= full:
                mesh = cfg.mesh
            else:
                shrink = elastic_shrink_plan(
                    cfg, target, sub.estimate_fn or self.estimate_fn
                )
                if shrink is None:
                    return None
                mesh = shrink[0]
            label = compile_index_mod.label_for_config(cfg, mesh=mesh, gang=target)
            return compile_index_mod.index_key(label, cfg)
        except Exception:
            log.debug("grow-back layout keying failed", exc_info=True)
            return None

    def _grow_target_warm_or_deadline(
        self, sub: Submission, target: int, now: float
    ) -> bool:
        """Precompile-before-grow-back gate: True when the resize may
        proceed (target warm, precompile disabled/unkeyable, failed, or the
        deadline lapsed — the last two proceed *cold*); False while the
        background warm-up is still in flight."""
        if not self.precompile_before_grow:
            return True
        key = self._grow_target_key(sub, target)
        if key is None:
            return True
        if self.compile_index.is_warm(key):
            self.grow_back_warm_total += 1
            self._grow_precompiles.pop(sub.submission_id, None)
            return True
        pending = self._grow_precompiles.get(sub.submission_id)
        if pending is None or pending[0] != key:
            # First sight of this target (or the target moved): kick the
            # background warm-up and hold the preempt.
            state = self.precompiler.request(
                key,
                label=key.rsplit("|", 1)[-1],
                config=sub.config,
                gang=target,
            )
            self._grow_precompiles[sub.submission_id] = (key, now)
            if state == "queued":
                self.precompiles_started_total += 1
            tracing.get_recorder().event(
                "grow_back_precompile",
                kind="scheduler",
                trace_id=sub.trace_id,
                parent=sub._root_span,
                attrs={"target_gang": target, "key": key, "state": state},
            )
            return False
        status = self.precompiler.status(key)
        if status in ("queued", "running") and (
            now - pending[1] < self.precompile_deadline_s
        ):
            return False
        # Warm (completed between passes), failed, rejected, or deadline —
        # the grow proceeds; cold when the index still says so.
        self._grow_precompiles.pop(sub.submission_id, None)
        if self.compile_index.is_warm(key):
            self.grow_back_warm_total += 1
        else:
            self.grow_back_cold_total += 1
            log.info(
                "scheduler: grow-back of %s proceeding COLD (precompile %s)",
                sub.submission_id, status or "missing",
            )
        return True

    def _maybe_preempt(self, head: Submission) -> None:
        """Evict the lowest-priority running job strictly below ``head``'s
        priority (one per pass) via the emergency-save seam."""
        if self._state_idx[SubmissionState.PREEMPTING]:
            return  # one eviction in flight at a time — its save must land
        running = [s for s in self._running() if s.preemptible]
        victims = [s for s in running if s.priority < head.priority]
        if not victims:
            return
        victims.sort(key=lambda s: (int(s.priority), -s.seq))  # lowest, youngest
        victim = victims[0]
        self._set_state(victim, SubmissionState.PREEMPTING)
        self.preemptions_total += 1
        rec = tracing.get_recorder()
        rec.event(
            "preempt_victim",
            kind="scheduler",
            trace_id=victim.trace_id,
            parent=victim._root_span,
            attrs={"for": head.submission_id, "head_trace_id": head.trace_id},
        )
        rec.event(
            "preempt_requested",
            kind="scheduler",
            trace_id=head.trace_id,
            parent=head._root_span,
            attrs={
                "victim": victim.submission_id,
                "victim_trace_id": victim.trace_id,
            },
        )
        log.warning(
            "scheduler: preempting %s (priority %s) for %s (priority %s)",
            victim.submission_id, victim.priority.name,
            head.submission_id, head.priority.name,
        )
        victim.job.watcher.simulate_interruption()

    # -- background pump -------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="fleet-scheduler"
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._shutdown.is_set():
            self._wake.wait(timeout=self.poll_interval_s)
            self._wake.clear()
            try:
                self.poll()
            except Exception:  # the pump must survive anything
                log.exception("scheduler: poll pass failed")

    # -- views -----------------------------------------------------------------

    def queue_state(self) -> dict[str, Any]:
        with self._lock:
            return {
                "draining": self._draining,
                "max_concurrent_jobs": self.max_concurrent_jobs,
                "queued": [s.describe() for s in self._queued()],
                "running": [s.describe() for s in self._active()],
                "finished": [s.describe() for s in self._finished_idx.values()],
                "stats": self.stats(),
            }

    def stats(self) -> dict[str, Any]:
        """Telemetry snapshot (the metrics router renders these as gauges).

        Cost is O(queued + running + tenants): the queued/running views
        come from the state indexes, never from a ``_subs`` scan — a
        metrics scrape must not get slower with every submission the
        scheduler has EVER seen."""
        queued = self._queued()
        running_subs = self._running()
        now = time.time()
        by_priority = {p.name.lower(): 0 for p in JobPriority}
        queued_by_tenant: dict[str, int] = {}
        for s in queued:
            by_priority[s.priority.name.lower()] += 1
            queued_by_tenant[s.submitter] = queued_by_tenant.get(s.submitter, 0) + 1
        running_by_tenant: dict[str, int] = {}
        for s in running_subs:
            running_by_tenant[s.submitter] = (
                running_by_tenant.get(s.submitter, 0) + 1
            )
        waits = self._wait_samples
        tenants = sorted(
            self._tenants | set(self._tenant_waits) | set(self._tenant_busy_s)
        )
        per_submitter = {}
        for t in tenants:
            t_waits = self._tenant_waits.get(t, [])
            per_submitter[t] = {
                "queued": queued_by_tenant.get(t, 0),
                "running": running_by_tenant.get(t, 0),
                "mean_wait_s": (
                    round(sum(t_waits) / len(t_waits), 4) if t_waits else 0.0
                ),
                "completed_total": self._tenant_completed.get(t, 0),
                "goodput_busy_s": round(self._tenant_busy_s.get(t, 0.0), 3),
                "wait_histogram": {
                    "buckets": {
                        str(b): c
                        for b, c in self._tenant_wait_hist.get(t, {}).items()
                    },
                    "sum": round(self._tenant_wait_hist_sum.get(t, 0.0), 4),
                    "count": self._tenant_wait_hist_count.get(t, 0),
                },
            }
        return {
            "queue_depth": len(queued),
            "queue_depth_by_priority": by_priority,
            "running": self._active_count(),
            "oldest_queued_wait_s": (
                round(now - min(s.submitted_at for s in queued), 3) if queued else 0.0
            ),
            "mean_admission_wait_s": (
                round(sum(waits) / len(waits), 4) if waits else 0.0
            ),
            "admission_wait_histogram": {
                "buckets": {str(b): c for b, c in self._wait_hist.items()},
                "sum": round(self._wait_hist_sum, 4),
                "count": self._wait_hist_count,
            },
            "submitted_total": self.submitted_total,
            "admitted_total": self.admitted_total,
            "preemptions_total": self.preemptions_total,
            "requeues_total": self.requeues_total,
            "completed_total": self.completed_total,
            "failed_total": self.failed_total,
            "cancelled_total": self.cancelled_total,
            "finished_evicted_total": self.finished_evicted_total,
            "elastic_shrinks_total": self.elastic_shrinks_total,
            "grow_backs_total": self.grow_backs_total,
            "self_heal_requeues_total": self.self_heal_requeues_total,
            "auto_admissions_total": self.auto_admissions_total,
            "no_estimate_skips_total": self.no_estimate_skips_total,
            "placement": self.planner.stats(),
            "compile_cache": {
                **self.compile_index.stats(),
                "precompile": self.precompiler.stats(),
                "precompiles_started_total": self.precompiles_started_total,
                "grow_back_warm_total": self.grow_back_warm_total,
                "grow_back_cold_total": self.grow_back_cold_total,
                "precompile_deadline_s": self.precompile_deadline_s,
                "precompile_before_grow": self.precompile_before_grow,
            },
            "hetero": {
                "rebalance_enabled": self.hetero_rebalance,
                "goodput_floor": self.hetero_goodput_floor,
                "cooldown_s": self.hetero_cooldown_s,
                "imbalance_trigger": self.hetero_imbalance_trigger,
                "quarantine_ttl_s": self.hetero_quarantine_ttl_s,
                "rebalances_total": self.hetero_rebalances_total,
                "shrinks_total": self.hetero_shrinks_total,
                "shrinks_avoided_total": self.hetero_shrinks_avoided_total,
                "rebalance_preferred_total": self.hetero_rebalance_preferred_total,
                "quarantined_devices": sorted(self._hetero_quarantined),
            },
            "running_shrunk": sum(
                1 for s in running_subs if s.shrunk_mesh is not None
            ),
            "running_serving": sum(
                1 for s in running_subs if s.workload == "serving"
            ),
            "reserved_hbm_gib": round(sum(self._reserved.values()), 3),
            "per_submitter": per_submitter,
            "draining": self._draining,
        }

    def fleet_hbm_utilization(self) -> Optional[dict[str, float]]:
        """Fleet-wide HBM view for telemetry: measured + scheduler-reserved
        over total; None when no fleet source (or no HBM telemetry)."""
        fleet = self._fleet()
        if fleet is None or not fleet.devices:
            return None
        total = sum(d.hbm_total_gb for d in fleet.devices)
        if total <= 0:
            return None
        used = sum(d.hbm_used_gb for d in fleet.devices)
        reserved = sum(self._reserved.values())
        return {
            "total_gib": round(total, 3),
            "used_gib": round(used, 3),
            "reserved_gib": round(reserved, 3),
            "utilization_pct": round(min((used + reserved) / total, 1.0) * 100, 2),
        }
