"""Supervised in-process training jobs: launch, monitor, rollback, resume
(port of ``tpu_engine/supervisor.py``).

The reference launches training as a fire-and-forget subprocess — stdout
piped and dropped, only the pid kept, no tracking after launch
(``ai_engine/deepspeed_launcher.py:354-362``; SURVEY.md §5 "no failure
detector for a running job"). Here the training task is an in-process thread
the supervisor actually owns:

- every step's metrics feed the :class:`~tpu_engine_torch.loss_monitor.LossSpikeMonitor`
  directly (no HTTP hop for the local case — SURVEY.md §3.3);
- a critical divergence/spike alert triggers halt → restore last *stable*
  checkpoint → cut LR → continue (mechanising the remediation strings at
  reference ``loss_monitor.py:131-136,167-172``);
- periodic async DCP saves; a checkpoint is marked stable only after a
  healthy margin of steps passes with no critical alert;
- preemption (metadata, SIGTERM, or the simulation seam) triggers a
  synchronous emergency save (``tpu_engine_torch/preemption.py``);
- on restart, a job with the same checkpoint directory auto-resumes from the
  newest loadable checkpoint (corrupt ones are quarantined) — MTTR is
  bounded by restore + the kernel library found already built
  (``tpu_engine_torch/compile_cache.py``).

Every restore (resume, rollback) loads into a fresh
``abstract_state_like(program)``, never the live state: the manager loads
in place, so a restore that fails partway leaves the live state untouched.
The job runs on ``devices[0]`` (a torch device; default the first card) or,
inside a process group, on the program's mesh. The host reads a step's
metrics once (``tolist``), where JAX's ``device_get`` does.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import tempfile
import threading
import time
import traceback
from enum import Enum
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from tpu_engine_torch import telemetry, tracing
from tpu_engine_torch.checkpoint import TrainCheckpointManager, abstract_state_like
from tpu_engine_torch.loss_monitor import (
    AlertSeverity,
    LossSpikeMonitor,
    MonitorConfig,
    TrainingMetrics,
)
from tpu_engine_torch.models.config import ModelConfig
from tpu_engine_torch.preemption import PreemptionWatcher
from tpu_engine_torch.profiler import StepProfiler, pipeline_tick_account
from tpu_engine_torch.train import TrainConfig, TrainProgram, build_train_program

log = logging.getLogger(__name__)


def _world() -> tuple[int, int]:
    """(this process's rank, the number of processes): (0, 1) outside a
    process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _device_id(d: torch.device, position: int) -> int:
    """The fleet id of a device: a card's CUDA index, else its position."""
    return d.index if d.type == "cuda" and d.index is not None else position


def _perplexity(loss: float) -> float:
    """exp(loss), clamped so a divergence spike can't overflow to inf."""
    return math.exp(min(loss, 30.0))


def _host_metrics(metrics: dict) -> dict[str, float]:
    """A step's metrics on the host in one read: the device tensors
    (loss, gradient norm) stacked and copied once, JAX's ``device_get``."""
    tensors = {k: v for k, v in metrics.items() if isinstance(v, torch.Tensor)}
    host = {k: float(v) for k, v in metrics.items() if k not in tensors}
    if tensors:
        vals = torch.stack([v.detach().float().reshape(()) for v in tensors.values()]).tolist()
        host.update(zip(tensors, vals))
    return host


class JobStatus(str, Enum):
    PENDING = "pending"
    COMPILING = "compiling"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    STOPPED = "stopped"
    PREEMPTED = "preempted"


class TrainingJob:
    """One supervised training run (thread-owned)."""

    def __init__(
        self,
        job_id: str,
        config: TrainConfig,
        program: Optional[TrainProgram] = None,
        data_fn: Optional[Callable[[int], torch.Tensor]] = None,
        monitor_config: Optional[MonitorConfig] = None,
        max_steps: Optional[int] = None,
        auto_rollback: bool = True,
        lr_cut_on_rollback: float = 0.5,
        max_rollbacks: int = 3,
        stable_margin_steps: int = 50,
        watch_preemption: bool = False,
        install_signal_handlers: bool = False,
        simulate_preemption_check: Optional[Callable[[], bool]] = None,
        devices: Optional[Sequence[Any]] = None,
        fault_injector: Optional[Any] = None,
        fleet_fn: Optional[Callable[[], Any]] = None,
        self_heal: Optional[bool] = None,
        health_check_interval_steps: int = 1,
        emergency_save_retries: int = 3,
        emergency_save_backoff_s: float = 0.05,
        trace_id: Optional[str] = None,
        anomaly_detection: bool = True,
        anomaly_detector: Optional[tracing.StepTimeAnomalyDetector] = None,
        anomaly_trace_session: Optional[Any] = None,
        anomaly_trace_dir: Optional[str] = None,
        hetero_detection: bool = True,
        hetero_rebalancer: Optional[Any] = None,
        hetero_check_interval_steps: int = 25,
        hetero_dry_run: bool = True,
        model_config: Optional[ModelConfig] = None,
    ):
        """JAX's arguments; ``devices`` are torch devices (or CUDA indices):
        the job runs on the first, and elastic admission counts them.
        ``model_config`` (port-only) builds another config than the
        catalog's ``config.model_name`` (a model cut in depth)."""
        self.job_id = job_id
        self.config = config
        self.program = program
        self.data_fn = data_fn
        self.monitor = LossSpikeMonitor(job_id=job_id, config=monitor_config)
        self.max_steps = max_steps if max_steps is not None else config.total_steps
        self.auto_rollback = auto_rollback
        self.lr_cut_on_rollback = lr_cut_on_rollback
        self.max_rollbacks = max_rollbacks
        self.stable_margin_steps = stable_margin_steps

        # Device pinning / elastic seam: None = all visible devices. A job
        # resumed on a different-sized slice records the auto-selected
        # shape in ``elastic_mesh`` (None = ran at the configured mesh).
        self._devices = ([torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
                          for d in devices] if devices is not None else None)
        self.model_config = model_config
        self.elastic_mesh: Optional[dict[str, int]] = None
        # The effective batch this job DECLARES — captured NOW, before any
        # elastic resize can shrink the world that a ``data=-1`` mesh
        # resolves against. ``elastic_target_batch_size`` overrides for
        # cross-process resumes where construction already happens on the
        # shrunken slice (the -1 re-resolution hazard; see the config
        # field's docstring).
        self._declared_batch = (
            config.elastic_target_batch_size
            if config.elastic_target_batch_size is not None
            else config.effective_batch_size
        )

        # Self-healing / fault-injection seams. A private injector wins;
        # otherwise the process-active one (tpu_engine_torch.faults.get_active)
        # is consulted per step. fleet_fn gives the loop a live health view
        # (the scheduler wires TPUManager.get_fleet_status here); self_heal
        # defaults to the config's elastic_resume — a job that declared
        # elasticity wants to survive chip loss, one that didn't should
        # fail loudly as before.
        self.fault_injector = fault_injector
        self.fleet_fn = fleet_fn
        self.self_heal = self_heal if self_heal is not None else bool(config.elastic_resume)
        self.health_check_interval_steps = max(1, int(health_check_interval_steps))
        self.emergency_save_retries = emergency_save_retries
        self.emergency_save_backoff_s = emergency_save_backoff_s
        #: None | detected | saving | saved | save-failed — the recovery
        #: state machine position, surfaced via describe()/HTTP.
        self.recovery_state: Optional[str] = None
        self.recovery_events: list[dict[str, Any]] = []
        self.unhealthy_devices: list[int] = []

        # Flight-recorder identity: the scheduler passes its submission's
        # trace so every attempt chains under one lifecycle root; a
        # standalone job gets its own trace lazily when the loop starts.
        self.trace_id = trace_id
        # Step-time anomaly attribution (Poplar-style: per-step wall time
        # is the health signal). The detector flags outliers against a
        # sliding baseline; the recorder attributes each to the span/event
        # overlapping that step's wall window. A sustained regression can
        # auto-start a bounded trace capture via anomaly_trace_session
        # (any object with TraceSession's start(log_dir, duration_s)).
        self._anomaly = anomaly_detector or (
            tracing.StepTimeAnomalyDetector(series_labels={"job": job_id})
            if anomaly_detection
            else None
        )
        self._anomaly_trace_session = anomaly_trace_session
        self._anomaly_trace_dir = anomaly_trace_dir
        self._auto_trace_started = False
        self._prev_step_end_ts: Optional[float] = None
        self.anomalies_total = 0
        self.last_anomaly: Optional[dict[str, Any]] = None
        # Heterogeneity plane (tpu_engine_torch/hetero.py): per-host throughput
        # EMA + hysteresis-guarded rebalance of the data split. Dry-run by
        # default — the detector and audit trail run everywhere, but the
        # live row reassignment is opt-in per job.
        self.hetero_detection = hetero_detection
        self._hetero = hetero_rebalancer
        self.hetero_check_interval_steps = max(1, int(hetero_check_interval_steps))
        self.hetero_dry_run = hetero_dry_run
        self.hetero_rebalances_total = 0
        self._last_slow_proc: Optional[int] = None

        self.status = JobStatus.PENDING
        self.error: Optional[str] = None
        self.rollback_count = 0
        self.resumed_from_step: Optional[int] = None
        self.resumed_via_reshard: Optional[dict] = None
        self._topology_written = False
        self.preemption_reason: Optional[str] = None
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.last_step_time_s: Optional[float] = None
        self.tokens_per_sec: Optional[float] = None
        self.current_step: int = 0
        self.profiler: Optional[StepProfiler] = None
        self._dataset: Any = None
        self._eval_dataset: Any = None
        self._eval_data_fn: Optional[Callable[[int], torch.Tensor]] = None
        self._eval_source: Optional[str] = None  # "file" | "synthetic"
        # (step, eval_loss) pairs, newest last; bounded (reference's unbounded
        # metric lists were a leak — SURVEY.md §3.3).
        self.eval_history: list[tuple[int, float]] = []
        self._max_eval_history = 1000
        # LoRA sampling: (step, merged params) — repeated /generate calls at
        # the same step reuse the merge instead of re-materialising it.
        self._merged_cache: Optional[tuple[int, Any]] = None
        self._metrics_file = None  # JSONL sink (config.metrics_log_path)

        self._state: Any = None
        self._state_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_critical_step = -1
        self._pending_stable: list[int] = []

        self.ckpt: Optional[TrainCheckpointManager] = None
        if config.checkpoint_dir:
            self.ckpt = TrainCheckpointManager(
                config.checkpoint_dir,
                max_to_keep=config.max_checkpoints_to_keep,
                save_interval_steps=1,
                fault_injector=fault_injector,
                program=program,
            )

        self.watcher: Optional[PreemptionWatcher] = None
        if watch_preemption:
            kwargs: dict[str, Any] = {}
            if simulate_preemption_check is not None:
                # Test seam: poll the injected check fast instead of GCE metadata.
                kwargs = {
                    "metadata_check": simulate_preemption_check,
                    "check_interval_s": 0.05,
                }
            self.watcher = PreemptionWatcher(
                on_preemption=self._on_preemption,
                install_signal_handlers=install_signal_handlers,
                **kwargs,
            )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True, name=f"job-{self.job_id}")
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    @property
    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- preemption ----------------------------------------------------------

    def _on_preemption(self, reason: str) -> None:
        """Emergency path: flag stop; the train loop does the synchronous save."""
        log.warning("job %s: preemption (%s) — emergency checkpoint", self.job_id, reason)
        self.preemption_reason = reason
        tracing.get_recorder().event(
            "preemption",
            kind="preempt_drain",
            trace_id=self.trace_id,
            attrs={"reason": reason, "step": self.current_step},
        )
        self._stop.set()

    # -- self-healing ---------------------------------------------------------

    def _injector(self):
        if self.fault_injector is not None:
            return self.fault_injector
        from tpu_engine_torch import faults

        return faults.get_active()

    def _record_recovery(self, kind: str, step: int, detail: str = "") -> None:
        self.recovery_events.append(
            {"kind": kind, "step": step, "detail": detail, "timestamp": time.time()}
        )
        del self.recovery_events[:-100]
        tracing.get_recorder().event(
            f"recovery:{kind}",
            kind="recovery",
            trace_id=self.trace_id,
            attrs={"job_id": self.job_id, "step": step, "detail": detail},
        )
        inj = self._injector()
        if inj is not None:
            inj.record(f"recovery:{kind}", step=step, detail=f"job {self.job_id}: {detail}")

    def _unhealthy_mesh_devices(self) -> list[int]:
        """Fleet device indices that are CRITICAL *and* inside this job's
        mesh. Keyed on health, not ``is_available`` — this job's own HBM
        footprint and duty cycle must never read as a failure."""
        prog = self.program
        if prog is None:
            return []
        mesh_ids = set(self._local_device_ids())

        def in_mesh(fleet_index: int) -> bool:
            return fleet_index in mesh_ids

        bad: set[int] = set()
        inj = self._injector()
        if inj is not None:
            from tpu_engine_torch.faults import FaultKind

            for idx, kind in inj.chip_overlay().items():
                if kind is FaultKind.CHIP_UNHEALTHY and in_mesh(idx):
                    bad.add(idx)
        if self.fleet_fn is not None:
            from tpu_engine_torch.tpu_manager import TPUHealthStatus

            try:
                fleet = self.fleet_fn()
            except Exception:
                fleet = None
            if fleet is not None:
                for dev in fleet.devices:
                    if dev.health_status == TPUHealthStatus.CRITICAL and in_mesh(dev.index):
                        bad.add(dev.index)
        return sorted(bad)

    def _begin_self_heal(self, step: int, bad: list[int]) -> None:
        """Detect → (loop exit) → emergency save → PREEMPTED → scheduler
        requeues and re-admits on the healthy remainder (elastic shrink)."""
        self.unhealthy_devices = bad
        self.recovery_state = "detected"
        self._record_recovery("detected", step, f"unhealthy mesh device(s) {bad}")
        log.warning(
            "job %s: unhealthy device(s) %s in live mesh at step %d — "
            "self-healing: emergency save then elastic requeue",
            self.job_id, bad, step,
        )
        # Riding the preemption path gives us the whole proven machinery:
        # synchronous save, PREEMPTED status, scheduler requeue-with-seq.
        self.preemption_reason = f"self-heal: unhealthy device(s) {bad}"
        self._stop.set()

    def _local_device_ids(self) -> list[int]:
        """Fleet ids of the devices this process's part of the job drives:
        the program's card (a rank's own on a mesh)."""
        return [_device_id(self.program.device, 0)]

    def _note_saved_topology(self) -> None:
        """Best-effort: record the live mesh factorization next to the
        checkpoints (once per attempt) so a future resume on a different
        mesh knows it must route through the reshard plane."""
        if self._topology_written or self.ckpt is None or self.program is None:
            return
        try:
            from tpu_engine_torch import reshard

            reshard.write_topology(
                self.ckpt.directory,
                reshard.mesh_topology(self.program.runtime),
                extra={"job_id": self.job_id},
            )
            self._topology_written = True
        except Exception:  # noqa: BLE001 — manifest is advisory, never fatal
            pass

    def _final_save(self, step: int) -> bool:
        """Final/emergency checkpoint with bounded retry; never raises.

        On persistent I/O failure the step is quarantined (partial write)
        and the job falls back to the last good periodic checkpoint on
        resume — progress loss is bounded by checkpoint_interval_steps
        instead of the whole run."""
        if self.recovery_state == "detected":
            self.recovery_state = "saving"
        ok = self.ckpt.save_with_retry(
            step,
            self._state,
            retries=self.emergency_save_retries,
            backoff_base_s=self.emergency_save_backoff_s,
            on_attempt=lambda attempt, err: self._record_recovery(
                "save-retry", step, f"attempt {attempt}: {err}"
            ),
        )
        if ok:
            self._note_saved_topology()
        if self.recovery_state is not None:
            self.recovery_state = "saved" if ok else "save-failed"
            self._record_recovery(
                self.recovery_state, step,
                "emergency checkpoint persisted" if ok
                else "emergency save failed after retries — step quarantined",
            )
        return ok

    # -- training loop -------------------------------------------------------

    def _visible_devices(self) -> list[torch.device]:
        """The devices the job may use: the given ones, else one a process
        of the process group (a process drives one card: this process's
        current one; the CUDA runtime's absence is raised by the build)."""
        if self._devices is not None:
            return list(self._devices)
        here = (torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
                else torch.device("cuda"))
        return [here] * _world()[1]

    def _elastic_config(self) -> TrainConfig:
        """The config to build with: when the declared elastic bounds allow
        and the configured mesh does not fit the visible devices, swap in
        the largest admissible mesh (reference elasticity min/max bounds,
        ``deepspeed_launcher.py:226-238``). Cross-mesh restore then loads
        the checkpoint onto the new shardings as usual."""
        cfg = self.config
        devices = self._visible_devices()
        n_visible = len(devices)
        if not (cfg.elastic_resume and cfg.elastic_min_devices is not None):
            cfg.mesh.resolved_shape(n_visible)  # exact fit or raise
            return cfg
        from tpu_engine_torch.mesh_runtime import derive_elastic_mesh

        # Bounds declared → they govern UNCONDITIONALLY: even a mesh that
        # "fits" (data=-1 absorbs anything) must land inside
        # [min_devices, max_devices], so always derive, then compare.
        new_mesh = derive_elastic_mesh(
            cfg.mesh, n_visible, cfg.elastic_min_devices,
            cfg.elastic_max_devices,
        )
        # derive_elastic_mesh returns explicit axis sizes (no -1).
        n_use = (new_mesh.data * new_mesh.fsdp * new_mesh.pipe
                 * new_mesh.sequence * new_mesh.model)
        if n_use < n_visible:
            # The derived mesh is smaller than the visible world
            # (max_devices cap, or divisibility): pair it with a concrete
            # device subset — a mesh must cover its runtime's devices
            # exactly. Auto-subset is SINGLE-PROCESS only: in a
            # multi-process run a subset of ranks would strand the others
            # mid-collective; shrinking means relaunching with fewer
            # processes (this path then sees a single consistent process
            # world again).
            if _world()[1] > 1:
                raise ValueError(
                    f"elastic bounds admit {n_use} of {n_visible} visible "
                    "devices, but auto-subset cannot span a multi-process "
                    "world — relaunch with fewer processes instead"
                )
            self._devices = devices[:n_use]
        try:
            same = cfg.mesh.resolved_shape(n_visible) == new_mesh.resolved_shape(n_use)
        except ValueError:
            same = False
        if same:
            return cfg
        self.elastic_mesh = dataclasses.asdict(new_mesh)
        log.warning(
            "job %s: configured mesh %s vs %d visible device(s); elastic "
            "bounds [%s, %s] admit %s on %d device(s) — relaunching at that "
            "shape",
            self.job_id, dataclasses.asdict(cfg.mesh), n_visible,
            cfg.elastic_min_devices, cfg.elastic_max_devices,
            self.elastic_mesh, n_use,
        )
        update: dict = {"mesh": new_mesh}
        # Preserve the DECLARED effective batch across the resize
        # (reference min/max-batch elasticity semantics,
        # ``deepspeed_launcher.py:226-233``): a mesh
        # shrink halves the data-parallel extent — without rescaling,
        # optimizer dynamics silently change. Ceil so the batch never
        # silently SHRINKS; the declared batch bounds then gate admission.
        # The target comes from ``_declared_batch`` (captured at job
        # construction, or the explicit ``elastic_target_batch_size``) —
        # NOT re-derived here, where a ``data=-1`` mesh would re-resolve
        # against the already-shrunken world and bless the shrink.
        target = self._declared_batch
        new_dp = new_mesh.data * new_mesh.fsdp
        new_accum = max(1, -(-target // (cfg.micro_batch_size * new_dp)))
        achieved = cfg.micro_batch_size * new_accum * new_dp
        if new_accum != cfg.gradient_accumulation_steps:
            update["gradient_accumulation_steps"] = new_accum
        if achieved != target or new_accum != cfg.gradient_accumulation_steps:
            # Growth is as loud as shrink: dp beyond target/micro with
            # accum already 1 GROWS the batch — say so (bounds, if
            # declared, gate it below).
            log.warning(
                "job %s: effective batch across elastic resize: declared "
                "%d, achieved %d on dp=%d (accum %d -> %d)",
                self.job_id, target, achieved, new_dp,
                cfg.gradient_accumulation_steps, new_accum,
            )
        lo, hi = cfg.elastic_min_batch_size, cfg.elastic_max_batch_size
        if (lo is not None and achieved < lo) or (
            hi is not None and achieved > hi
        ):
            raise ValueError(
                f"no admissible effective batch: the elastic mesh "
                f"{self.elastic_mesh} achieves batch {achieved} "
                f"(micro {cfg.micro_batch_size} x accum {new_accum} x "
                f"dp {new_dp}), outside declared bounds [{lo}, {hi}]"
            )
        return dataclasses.replace(cfg, **update)

    def _build_program(self):
        """Build the train program on the job's device; for LoRA, load the
        frozen base weights from the configured HF checkpoint directory."""
        cfg = self._elastic_config()
        device = self._visible_devices()[0]
        if cfg.lora_rank and cfg.lora_base_hf_checkpoint:
            from transformers import AutoModelForCausalLM

            from tpu_engine_torch.models.convert import config_from_hf, from_hf

            hf_model = AutoModelForCausalLM.from_pretrained(cfg.lora_base_hf_checkpoint)
            model_cfg = config_from_hf(hf_model.config)
            base = from_hf(hf_model.state_dict(), model_cfg, device=device)
            del hf_model
            log.info(
                "job %s: LoRA base loaded from %s (%s)",
                self.job_id, cfg.lora_base_hf_checkpoint, model_cfg.name,
            )
            return build_train_program(cfg, model_cfg, device=device, base_params=base)
        if cfg.lora_rank:
            log.warning(
                "job %s: lora_rank set without lora_base_hf_checkpoint — "
                "adapting a randomly initialised base model (only meaningful "
                "for tests and benchmarks)", self.job_id,
            )
        return build_train_program(cfg, self.model_config, device=device)

    def _abstract_state(self):
        """A fresh state of the program's shapes on its ranks to restore
        into (the manager loads in place: never the live state)."""
        return abstract_state_like(self.program)

    def _note_compile_outcome(self, compile_s: float) -> Optional[bool]:
        """Classify this attempt's compile as warm (persistent-cache hit)
        or cold, and record the outcome into the fleet compile index.

        The classification is a cheap wall-clock heuristic against the
        index's measured cold-compile EMA: a layout the index already calls
        warm stays a hit unless the measured wall time blew far past the
        cold reference (cache evicted under us); a layout the index has
        never seen is a hit only when the compile came in at a small
        fraction of the cold reference (another process warmed the shared
        cache dir). Returns None (and records nothing) when keying fails —
        the index must never break the compile path.
        """
        try:
            from tpu_engine_torch import compile_index as compile_index_mod

            idx = compile_index_mod.get_index()
            mesh = self.elastic_mesh or self.config.mesh
            gang = len(self._devices) if self._devices else _world()[1]
            label = compile_index_mod.label_for_config(
                self.config, mesh=mesh, gang=gang
            )
            key = compile_index_mod.index_key(label, self.config)
            prior_warm = idx.is_warm(key)
            cold_ref = idx.expected_cold_s(key)
            if prior_warm:
                cache_hit = cold_ref is None or compile_s <= max(
                    0.5 * cold_ref, 1.0
                )
            else:
                cache_hit = (
                    cold_ref is not None and compile_s < 0.33 * cold_ref
                )
            idx.record(
                key, compile_s, cache_hit,
                label=label, model=self.config.model_name,
            )
            return cache_hit
        except Exception:
            log.debug("compile index record failed", exc_info=True)
            return None

    def _run(self) -> None:
        self.started_at = time.time()
        rec = tracing.get_recorder()
        if self.trace_id is None:
            self.trace_id = rec.new_trace_id()
        if self.ckpt is not None:
            self.ckpt.trace_id = self.trace_id
        attempt_span = rec.start_span(
            f"attempt:{self.job_id}",
            kind="attempt",
            trace_id=self.trace_id,
            parent=rec.trace_root(self.trace_id),
            attrs={"job_id": self.job_id},
        )
        # Measured per-step wall total for this attempt — annotated onto the
        # attempt span at close; the goodput ledger uses it as the cap on
        # how much attempt time may count productive (untraced gaps fall to
        # idle/unknown, not goodput).
        attempt_step_s = 0.0
        try:
            self.status = JobStatus.COMPILING
            # Warm-start compiles across restarts: a preempted job that
            # resumes finds its kernel library built (the MTTR bound this
            # module's docstring promises; SURVEY.md §7 hard part c).
            from tpu_engine_torch.compile_cache import enable_compilation_cache

            with rec.start_span(
                "compile", kind="compile", trace_id=self.trace_id,
                parent=attempt_span,
            ) as compile_span:
                t_compile0 = time.time()
                enable_compilation_cache(self.config.compilation_cache_dir)
                if self.program is None:
                    self.program = self._build_program()
                if self.ckpt is not None and self.ckpt.program is None:
                    self.ckpt.program = self.program
                if self.program.device.type == "cuda":
                    # The port's compile: the kernel library, built from the
                    # sources unless the directory already holds it.
                    from tpu_engine_torch.ops import _flash_cuda

                    _flash_cuda.build()
                compile_s = max(time.time() - t_compile0, 0.0)
                # Warm/cold classification feeds the fleet compile index
                # (scheduler admission + grow-back read it) and lets the
                # goodput ledger split `compile` into warm vs cold time.
                cache_hit = self._note_compile_outcome(compile_s)
                compile_span.annotate(
                    cache_hit=cache_hit, compile_s=round(compile_s, 6),
                )
            prog = self.program

            # Per-chip attribution: claim this job's chips in the fleet view
            # (reference per-GPU process table, ``gpu_manager.py:174-184``)
            # as soon as the mesh exists — the compile/restore/init window
            # holds the chips too, and shows as status "compiling".
            # Released in the outer finally. The same ids scope the derived
            # duty-cycle telemetry below.
            local_device_ids = self._local_device_ids()
            telemetry.register_job_devices(
                self.job_id, local_device_ids, _world()[0],
                lambda: self.status.value,
            )

            # Resume if checkpoints exist (auto-resume; MTTR path). When the
            # saved topology manifest disagrees with the live mesh, route
            # through the reshard plane so any planner-feasible factorization
            # is a valid resume target (parity-gated).
            start_step = 0
            if self.ckpt is not None and self.ckpt.latest_step() is not None:
                from tpu_engine_torch import reshard

                saved_topo = reshard.read_topology(self.ckpt.directory)
                live_topo = reshard.mesh_topology(prog.runtime)
                resharded = (
                    saved_topo is not None
                    and not reshard.same_topology(saved_topo, live_topo)
                )
                if resharded:
                    step, state, report = reshard.restore_resharded(
                        self.ckpt,
                        self._abstract_state(),
                        saved_topology=saved_topo,
                        target_topology=live_topo,
                        program=prog,
                    )
                    self.resumed_via_reshard = report
                else:
                    step, state = self.ckpt.restore(self._abstract_state())
                if state is not None:
                    self._state = state
                    start_step = int(step)
                    self.resumed_from_step = start_step
                    rec.event(
                        "resume",
                        kind="supervisor",
                        trace_id=self.trace_id,
                        parent=attempt_span,
                        attrs={"from_step": start_step, "resharded": resharded},
                    )
                    log.info(
                        "job %s: resumed from checkpoint step %d%s",
                        self.job_id, start_step,
                        " (resharded across topologies)" if resharded else "",
                    )
            if self._state is None:
                self._state = prog.init()

            if self.watcher is not None:
                self.watcher.start()

            # Input pipeline: explicit data_fn > config dataset file > synthetic.
            if self.data_fn is None and self.config.dataset_path:
                from tpu_engine_torch.data import TokenFileDataset, make_data_fn

                self._dataset = TokenFileDataset(
                    self.config.dataset_path,
                    seq_len=self.config.seq_len,
                    dtype=self.config.dataset_dtype,
                )
                self.data_fn = make_data_fn(prog, self._dataset, seed=self.config.seed)
                log.info(
                    "job %s: dataset %s (%d sequences, native=%s)",
                    self.job_id, self.config.dataset_path,
                    self._dataset.num_sequences, self._dataset.native,
                )

            # Held-out eval source: dedicated file > held-out synthetic seeds.
            if self.config.eval_interval_steps:
                if self.config.eval_dataset_path:
                    from tpu_engine_torch.data import TokenFileDataset, make_eval_data_fn

                    self._eval_dataset = TokenFileDataset(
                        self.config.eval_dataset_path,
                        seq_len=self.config.seq_len,
                        dtype=self.config.dataset_dtype,
                    )
                    # Fixed held-out batches: call index i always reads the
                    # same sequences, so the eval curve is comparable.
                    self._eval_data_fn = make_eval_data_fn(prog, self._eval_dataset)
                    self._eval_source = "file"
                else:
                    # Synthetic fallback: a seed space disjoint from training
                    # steps (which seed by step index < total_steps).
                    self._eval_data_fn = lambda i: prog.synthetic_batch(
                        seed=1_000_000_007 + i
                    )
                    self._eval_source = "synthetic"
                    if self.data_fn is not None:
                        log.warning(
                            "job %s: eval_interval_steps set with real training "
                            "data but no eval_dataset_path — eval uses synthetic "
                            "random tokens (loss ≈ ln(vocab), not a held-out "
                            "metric)", self.job_id,
                        )

            if self.config.metrics_log_path:
                try:
                    self._metrics_file = open(self.config.metrics_log_path, "a")
                except OSError:  # metrics are best-effort; never fail the job
                    log.exception(
                        "job %s: cannot open metrics log %s — continuing without",
                        self.job_id, self.config.metrics_log_path,
                    )
                if self.resumed_from_step is not None:
                    self._log_metrics(kind="resume", step=start_step)

            self.status = JobStatus.RUNNING
            tokens_per_batch = 1
            for d in prog.global_batch_shape():
                tokens_per_batch *= d
            from tpu_engine_torch.models import transformer as tfm

            n_devices = prog.runtime.n_devices if prog.runtime is not None else 1
            self.profiler = StepProfiler(
                tokens_per_step=tokens_per_batch,
                flops_per_token=tfm.train_flops_per_token(prog.model_config, self.config.seq_len),
                n_devices=n_devices,
                pipeline_account=pipeline_tick_account(
                    prog.pipeline_schedule,
                    prog.runtime.axis_sizes["pipe"] if prog.runtime is not None else 1,
                    self.config.gradient_accumulation_steps,
                ),
            )
            if self._hetero is None and self.hetero_detection:
                from tpu_engine_torch import hetero as hetero_mod

                _, gm_h, _ = prog.global_batch_shape()
                n_proc = _world()[1]
                # Multi-process: every rank consults at the same step (the
                # modulo check below), solves from rank 0's broadcast
                # estimates, and cools down in steps — so all ranks derive
                # the identical plan and the row windows never overlap or
                # gap (agreement enforced, not a caller convention).
                self._hetero = hetero_mod.HeteroRebalancer(
                    hetero_mod.ThroughputTracker(n_proc),
                    gm_h,
                    dry_run=self.hetero_dry_run,
                    trace_id=self.trace_id,
                    agree_fn=(
                        hetero_mod.broadcast_agree_fn() if n_proc > 1 else None
                    ),
                    cooldown_steps=(
                        4 * self.hetero_check_interval_steps
                        if n_proc > 1 else None
                    ),
                )
            if self._hetero is not None:
                from tpu_engine_torch import hetero as hetero_mod

                hetero_mod.set_active(self._hetero)
            step = start_step
            while step < self.max_steps and not self._stop.is_set():
                self.profiler.begin_step()
                batch = (
                    self.data_fn(step) if self.data_fn is not None else prog.synthetic_batch(step)
                )
                self.profiler.mark("data")
                with self._state_lock:
                    self._state, metrics = prog.step(self._state, batch)
                self.profiler.mark("dispatch")
                host = _host_metrics(metrics)
                self.profiler.mark("device")
                dt = self.profiler.end_step()
                attempt_step_s += dt
                self.last_step_time_s = dt
                self.tokens_per_sec = tokens_per_batch / dt if dt > 0 else None
                # Feed the fleet's derived duty-cycle source: device-phase
                # time (the blocking device→host read absorbs the step's
                # device execution) over step wall time.
                telemetry.observe_step(
                    self.profiler.last_step_phases().get("device", 0.0), dt,
                    device_ids=local_device_ids,
                )
                step = int(host["step"])
                self.current_step = step

                # Fault-injection seams + self-healing health check.
                inj = self._injector()
                if inj is not None:
                    inj.observe_step(step)
                    slow_spec = inj.take_host_slow(step)
                    slow = float(slow_spec.slow_s) if slow_spec is not None else 0.0
                    if slow > 0:
                        # Host-slow is a *reported* stall (step time +
                        # throughput degrade) — never an actual sleep, so
                        # chaos runs stay deterministic and fast.
                        self.last_step_time_s = dt + slow
                        self.tokens_per_sec = tokens_per_batch / self.last_step_time_s
                        rec.event(
                            "host-slow",
                            kind="fault",
                            trace_id=self.trace_id,
                            parent=attempt_span,
                            attrs={"step": step, "penalty_s": slow},
                        )
                        if self._hetero is not None:
                            # Attribute the stall to the host the spec
                            # names (fleet device index → owning process).
                            n_proc = self._hetero.tracker.n_processes
                            dev_per_proc = max(n_devices // n_proc, 1)
                            proc = (
                                slow_spec.device_index // dev_per_proc
                                if slow_spec.device_index is not None
                                else None
                            )
                            self._last_slow_proc = proc
                            self._hetero.tracker.note_host_slow(proc, slow, dt)
                    if inj.preempt_due(step):
                        # Synchronous injection (not via the watcher thread):
                        # the step that triggers is the step that saves.
                        self._on_preemption("fault-injected:preemption-signal")
                if (
                    self.self_heal
                    and self.preemption_reason is None
                    and step % self.health_check_interval_steps == 0
                ):
                    bad = self._unhealthy_mesh_devices()
                    if bad:
                        self._begin_self_heal(step, bad)

                # Step-time anomaly attribution: flag against the sliding
                # baseline, then attribute to whatever span/event overlaps
                # this step's wall window (the previous step's end →  now
                # covers inter-step work like a checkpoint save). The
                # host-slow event above lands BEFORE this check, so an
                # injected stall is both the anomaly and its cause.
                if self._anomaly is not None:
                    now_ts = time.time()
                    observed = (
                        self.last_step_time_s
                        if self.last_step_time_s is not None
                        else dt
                    )
                    anom = self._anomaly.observe(step, observed)
                    if anom is not None:
                        w0 = (
                            self._prev_step_end_ts
                            if self._prev_step_end_ts is not None
                            else now_ts - observed
                        )
                        cause = rec.attribute(self.trace_id, w0, now_ts)
                        anom["cause"] = cause
                        self.anomalies_total += 1
                        self.last_anomaly = dict(anom)
                        if self._hetero is not None:
                            # Sustained host-slow attribution seeds the
                            # throughput tracker even when no injector
                            # reported a penalty (real-fleet path).
                            self._hetero.tracker.note_attribution(
                                cause, anom, self._last_slow_proc
                            )
                        rec.record_anomaly(
                            cause,
                            trace_id=self.trace_id,
                            attrs={
                                "job_id": self.job_id,
                                "step": anom["step"],
                                "duration_s": anom["duration_s"],
                                "baseline_s": anom["baseline_s"],
                                "sustained": anom["sustained"],
                            },
                        )
                        if (
                            anom["sustained"]
                            and self._anomaly_trace_session is not None
                            and not self._auto_trace_started
                        ):
                            # Opt-in: one bounded trace capture per job on
                            # sustained regression (never a retry storm).
                            # On a card TraceSession refuses this thread and
                            # a timed capture: recorded as unavailable.
                            self._auto_trace_started = True
                            try:
                                log_dir = self._anomaly_trace_dir or (
                                    tempfile.mkdtemp(
                                        prefix=f"anomtrace_{self.job_id}_"
                                    )
                                )
                                self._anomaly_trace_session.start(
                                    log_dir, duration_s=30.0
                                )
                                rec.event(
                                    "auto_trace_started",
                                    kind="supervisor",
                                    trace_id=self.trace_id,
                                    attrs={"log_dir": log_dir, "step": step},
                                )
                            except Exception as e:
                                rec.event(
                                    "auto_trace_unavailable",
                                    kind="supervisor",
                                    trace_id=self.trace_id,
                                    attrs={"error": str(e)},
                                )
                    self._prev_step_end_ts = now_ts

                # Heterogeneity plane: every step feeds the throughput EMA
                # (decay-to-1 heals transient stalls); every
                # hetero_check_interval_steps the rebalancer is consulted.
                # A live (non-dry-run) plan moves the data split through
                # data_fn.reassign — the declared global batch is preserved
                # exactly (validated again at the data layer).
                if self._hetero is not None:
                    self._hetero.tracker.observe_step(
                        self.last_step_time_s if self.last_step_time_s else dt
                    )
                    consult = step % self.hetero_check_interval_steps == 0
                    if not consult and _world()[1] <= 1:
                        # Out-of-band consult requested by the scheduler's
                        # rebalance-over-shrink path. Honored between
                        # modulo boundaries only single-process —
                        # multi-process ranks must all consult at the same
                        # step, so there the request simply rides the next
                        # periodic consult.
                        consult = self._hetero.consult_pending()
                    if consult:
                        h_plan = self._hetero.maybe_rebalance(step)
                        if h_plan is not None and not h_plan.dry_run:
                            reassign_fn = getattr(self.data_fn, "reassign", None)
                            if reassign_fn is None:
                                # No seam to move rows through (synthetic
                                # batches): roll the plan back so the
                                # gauges never report a split that is not
                                # actually feeding the mesh.
                                self._hetero.revert(h_plan)
                            else:
                                try:
                                    reassign_fn(h_plan.assignment)
                                    self.hetero_rebalances_total += 1
                                    rec.event(
                                        "hetero_reassign",
                                        kind="hetero",
                                        trace_id=self.trace_id,
                                        parent=attempt_span,
                                        attrs={
                                            "step": step,
                                            "assignment": list(h_plan.assignment),
                                        },
                                    )
                                except ValueError as e:
                                    self._hetero.revert(h_plan)
                                    rec.event(
                                        "hetero_reassign_rejected",
                                        kind="hetero",
                                        trace_id=self.trace_id,
                                        attrs={"step": step, "error": str(e)},
                                    )

                alerts = self.monitor.ingest(
                    TrainingMetrics(
                        step=step,
                        loss=host["loss"],
                        learning_rate=host["learning_rate"],
                        gradient_norm=host["grad_norm"],
                        throughput_tokens_per_sec=self.tokens_per_sec,
                    )
                )

                if step % self.config.log_every_steps == 0:
                    self._log_metrics(
                        kind="train", step=step, loss=host["loss"],
                        learning_rate=host["learning_rate"],
                        grad_norm=host["grad_norm"],
                        tokens_per_sec=self.tokens_per_sec,
                    )

                critical = [a for a in alerts if a.severity == AlertSeverity.CRITICAL]
                if critical:
                    self._last_critical_step = step
                    if self.auto_rollback and self.ckpt is not None:
                        rolled = self._rollback(before_step=step)
                        if rolled is not None:
                            step = rolled
                            continue
                        if any(a.alert_type == "divergence" for a in critical):
                            raise RuntimeError(
                                f"diverged at step {step} with no stable checkpoint to roll back to"
                            )
                    elif any(a.alert_type == "divergence" for a in critical):
                        raise RuntimeError(f"training diverged at step {step}")

                # Held-out evaluation.
                if (
                    self.config.eval_interval_steps
                    and step % self.config.eval_interval_steps == 0
                ):
                    self._run_eval(step)

                # Periodic checkpoint + stable-pointer advancement.
                if self.ckpt is not None:
                    if step % self.config.checkpoint_interval_steps == 0:
                        with self._state_lock:  # disk-overlap: saved params
                            self._flush_state()  # must include every update
                        self.ckpt.save(step, self._state, metrics={"loss": host["loss"]})
                        self._note_saved_topology()
                        self._pending_stable.append(step)
                    self._advance_stable(step)

            # Final save + status.
            if self.ckpt is not None and self._state is not None:
                with self._state_lock:
                    self._flush_state()
                save_kind = (
                    "emergency_save"
                    if (
                        self.preemption_reason is not None
                        or self.recovery_state is not None
                    )
                    else "final_save"
                )
                with rec.start_span(
                    save_kind, kind=save_kind, trace_id=self.trace_id,
                    parent=attempt_span, attrs={"step": step},
                ) as save_span:
                    ok = self._final_save(step)
                    save_span.annotate(ok=ok)
                if ok:
                    self._advance_stable(step)
            if self.preemption_reason is not None:
                self.status = JobStatus.PREEMPTED
            elif self._stop.is_set() and step < self.max_steps:
                self.status = JobStatus.STOPPED
            else:
                self.status = JobStatus.COMPLETED
        except Exception as e:  # noqa: BLE001 — job boundary
            self.error = f"{type(e).__name__}: {e}"
            log.error("job %s failed:\n%s", self.job_id, traceback.format_exc())
            self.status = JobStatus.FAILED
        finally:
            self.finished_at = time.time()
            if attempt_span.t1 is None:
                attempt_span.end(
                    status=self.status.value,
                    step=self.current_step,
                    step_s=round(attempt_step_s, 6),
                    preemption_reason=self.preemption_reason,
                    error=self.error,
                    resumed_from_step=self.resumed_from_step,
                    anomalies=self.anomalies_total,
                )
            telemetry.unregister_job_devices(self.job_id)
            # Release the process-wide hetero plane only if this job owns it
            # (a newer job may already have installed its own rebalancer).
            if self._hetero is not None:
                from tpu_engine_torch import hetero as hetero_mod

                if hetero_mod.get_active() is self._hetero:
                    hetero_mod.clear_active()
            # Stop a sharded-read prefetch thread with the job (make_data_fn
            # attaches close when it owns a stream).
            close_fn = getattr(self.data_fn, "close", None)
            if callable(close_fn):
                try:
                    close_fn()
                except Exception:
                    pass
            for ds in (self._dataset, self._eval_dataset):
                if ds is not None:
                    try:
                        ds.close()
                    except Exception:
                        pass
            if self._metrics_file is not None:
                try:
                    self._metrics_file.close()
                except Exception:
                    pass
            if self.watcher is not None:
                self.watcher.stop()
            if self.ckpt is not None:
                try:
                    self.ckpt.wait_until_finished()
                except Exception:
                    pass

    def run_eval_now(self) -> dict[str, float]:
        """On-demand held-out evaluation at the current step (requires
        ``eval_interval_steps`` so an eval data source exists). Returns
        {step, loss, perplexity} and records it in the history."""
        if self.program is None or self._state is None:
            raise RuntimeError(
                "job has not started its train loop yet (or failed during "
                "compile) — retry once it is running"
            )
        if self._eval_data_fn is None:
            raise RuntimeError(
                "job has no eval data source (set eval_interval_steps)"
            )
        try:
            step, loss = self._run_eval()
        except Exception as e:  # e.g. file-backed source closed after finish
            raise RuntimeError(f"eval failed: {type(e).__name__}: {e}")
        return {"step": step, "loss": loss, "perplexity": _perplexity(loss)}

    def _flush_state(self) -> None:
        """Disk-overlap jobs: fold the in-flight host walk into ``_state``
        so params match the step label (checkpoints, eval, and snapshots
        must never see the one-walk-stale tree). Caller holds
        ``_state_lock``. No-op for every other program kind."""
        prog = self.program
        if prog is not None and prog.flush is not None and self._state is not None:
            self._state = prog.flush(self._state)

    def _run_eval(self, step: Optional[int] = None) -> tuple[int, float]:
        """Average ``eval_batches`` held-out losses; record in history.

        ``step=None`` (the on-demand path) reads the current step under the
        state lock, so the recorded step matches the state evaluated even
        while training advances. Returns ``(step, loss)`` — callers must
        not re-read shared history, which concurrent evals/rollbacks mutate.
        """
        prog = self.program
        with self._state_lock:
            if step is None:
                step = self.current_step
            self._flush_state()  # disk-overlap: eval the step's real params
            # Dispatch all eval steps before the single host sync, so device
            # execution of batch k overlaps dispatch of batch k+1.
            device_losses = [
                prog.eval_step(self._state, self._eval_data_fn(i))
                for i in range(self.config.eval_batches)
            ]
        loss = float(torch.stack(device_losses).sum().item()) / self.config.eval_batches
        self.eval_history.append((step, loss))
        del self.eval_history[: -self._max_eval_history]
        self._log_metrics(kind="eval", step=step, loss=loss, perplexity=_perplexity(loss))
        log.info(
            "job %s: eval @ step %d — loss %.4f ppl %.2f",
            self.job_id, step, loss, _perplexity(loss),
        )
        return step, loss

    def _log_metrics(self, **fields) -> None:
        """One JSON line to the job's metrics log (no-op when unconfigured)."""
        if self._metrics_file is None:
            return
        import json

        try:
            fields["job_id"] = self.job_id
            # Timeline disambiguation: after a divergence rollback the same
            # step numbers are re-logged; group by (step, rollback) to pick
            # the live timeline.
            fields["rollback"] = self.rollback_count
            fields["ts"] = time.time()
            self._metrics_file.write(json.dumps(fields) + "\n")
            self._metrics_file.flush()
        except Exception:  # a full disk must not kill training
            log.exception("job %s: metrics log write failed", self.job_id)

    def _advance_stable(self, current_step: int) -> None:
        """Mark saved steps stable once a healthy margin has passed them."""
        still_pending: list[int] = []
        for s in self._pending_stable:
            if self._last_critical_step >= s:
                continue  # anomaly at/after this save — never stable
            if current_step >= s + self.stable_margin_steps or current_step >= self.max_steps:
                self.ckpt.mark_stable(s)
            else:
                still_pending.append(s)
        self._pending_stable = still_pending

    def _rollback(self, before_step: int) -> Optional[int]:
        """Restore last stable checkpoint and cut LR; returns restored step."""
        if self.rollback_count >= self.max_rollbacks:
            log.error("job %s: max rollbacks (%d) reached", self.job_id, self.max_rollbacks)
            return None
        self.ckpt.wait_until_finished()
        step, state = self.ckpt.restore_stable(self._abstract_state(), before_step=before_step)
        if state is None:
            return None
        # Purge post-anomaly checkpoints: a crash-restart must not auto-resume
        # into the diverged timeline (latest-step restore would prefer them).
        self.ckpt.delete_after(int(step))
        self._pending_stable = [s for s in self._pending_stable if s <= int(step)]
        # Evals from the abandoned timeline would collide with re-reached steps.
        self.eval_history = [(s, l) for s, l in self.eval_history if s <= int(step)]
        # New timeline: the old anomaly step must not veto fresh post-rollback
        # checkpoints from ever being marked stable.
        self._last_critical_step = -1
        new_scale = float(state["lr_scale"]) * self.lr_cut_on_rollback
        state["lr_scale"] = new_scale
        with self._state_lock:
            self._state = state
        self.rollback_count += 1
        self.monitor.reset()
        self._log_metrics(kind="rollback", step=int(step), anomaly_step=before_step)
        log.warning(
            "job %s: rolled back to stable step %d (rollback #%d, lr_scale=%.4f)",
            self.job_id, step, self.rollback_count, float(new_scale),
        )
        return int(step)

    # -- sampling ------------------------------------------------------------

    def _sampling_program(self) -> TrainProgram:
        """The program to sample or export from: one whose ranks are this
        process's alone (gathering a mesh job's weights whole is a
        collective every rank would have to call)."""
        if self.program is None or self._state is None:
            raise RuntimeError("job has no initialized state to sample from")
        if self.program.runtime is not None and self.program.runtime.n_devices > 1:
            raise NotImplementedError(
                "sampling and export from a job on a mesh of several ranks are not "
                "ported: every rank would have to gather the weights whole")
        return self.program

    def generate_sample(
        self,
        prompt_tokens: list[list[int]],
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        seed: int = 0,
        kv_quant: bool = False,
    ) -> list[list[int]]:
        """Sample continuations from the job's *current* weights.

        Safe while training runs: the state lock is held across the
        generation, whose forward reads the live parameters (the train step
        updates them in place). Returns prompt + continuation token ids per
        row."""
        from tpu_engine_torch.generate import generate

        prog = self._sampling_program()
        lens = {len(p) for p in prompt_tokens}
        if len(lens) != 1 or 0 in lens:
            raise ValueError("prompt rows must be non-empty and equal-length")
        vocab = prog.model_config.vocab_size
        if any(t < 0 or t >= vocab for row in prompt_tokens for t in row):
            raise ValueError(f"prompt token id out of range [0, {vocab})")
        prompt = torch.tensor(prompt_tokens, dtype=torch.long, device=prog.device)
        with self._state_lock:
            params = self._full_params_locked()
            out = generate(
                params, prompt, prog.model_config, max_new_tokens,
                generator=torch.Generator(device=prog.device).manual_seed(seed),
                temperature=temperature, top_k=top_k, top_p=top_p,
                compute_dtype=prog.config.compute_dtype(), kv_quant=kv_quant,
                device=prog.device,
            )
        return out.tolist()

    def generate_samples_ragged(
        self,
        prompt_rows: list[list[int]],
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        seed: int = 0,
        kv_quant: bool = False,
    ) -> list[list[int]]:
        """Sample continuations for rows of *different* lengths — each row
        decodes separately (no padding mask exists), all from one
        consistent weight snapshot taken under the state lock, so a long
        ragged generation never stalls the training thread."""
        from tpu_engine_torch.generate import generate

        prog = self._sampling_program()
        vocab = prog.model_config.vocab_size
        for row in prompt_rows:
            if not row:
                raise ValueError("prompt rows must be non-empty")
            if any(t < 0 or t >= vocab for t in row):
                raise ValueError(f"prompt token id out of range [0, {vocab})")
        params = self._params_snapshot()
        outs = []
        for i, ids in enumerate(prompt_rows):
            outs.append(generate(
                params, torch.tensor([ids], dtype=torch.long, device=prog.device),
                prog.model_config, max_new_tokens,
                generator=torch.Generator(device=prog.device).manual_seed(seed + i),
                temperature=temperature, top_k=top_k, top_p=top_p,
                compute_dtype=prog.config.compute_dtype(), kv_quant=kv_quant,
                device=prog.device,
            ))
        return [o[0].tolist() for o in outs]

    def speculative_sample(
        self,
        prompt_tokens: list[int],
        draft_hf_checkpoint: str,
        max_new_tokens: int = 32,
        gamma: int = 4,
    ) -> tuple[list[int], int]:
        """Greedy speculative decoding from the job's current weights with a
        small draft model loaded from a local HF checkpoint directory
        (cached per path). Returns (prompt+continuation ids, verification
        rounds — i.e. target forward passes taken).
        """
        from tpu_engine_torch.generate import speculative_generate

        prog = self._sampling_program()
        if not prompt_tokens:
            raise ValueError("prompt must be non-empty")
        model_cfg = prog.model_config
        vocab = model_cfg.vocab_size
        if any(t < 0 or t >= vocab for t in prompt_tokens):
            raise ValueError(f"prompt token id out of range [0, {vocab})")
        draft_params, draft_cfg = _load_draft(
            draft_hf_checkpoint, prog.config.compute_dtype(), prog.device
        )
        if draft_cfg.vocab_size != model_cfg.vocab_size:
            raise ValueError(
                f"draft vocab ({draft_cfg.vocab_size}) != target vocab "
                f"({model_cfg.vocab_size}); speculative verification needs a "
                "shared tokenizer"
            )
        prompt = torch.tensor([prompt_tokens], dtype=torch.long, device=prog.device)
        # Snapshot once; the draft/verify rounds run outside the state lock
        # (a speculative decode is many dispatches — holding the lock across
        # them would stall training).
        params = self._params_snapshot()
        out, rounds = speculative_generate(
            params, draft_params, prompt, model_cfg, draft_cfg,
            max_new_tokens=max_new_tokens, gamma=gamma,
            compute_dtype=prog.config.compute_dtype(),
            return_stats=True, device=prog.device,
        )
        return out[0].tolist(), rounds

    def _full_params_locked(self):
        """Full model params for the current step (caller holds _state_lock):
        the trainable tree itself, or (LoRA) base+adapters merged — cached
        per step so repeated sampling/export reuses the merge."""
        params = self._state["params"]
        if self.program.base_params is None:
            return params
        if self._merged_cache is not None and self._merged_cache[0] == self.current_step:
            return self._merged_cache[1]
        params = self.program.merged_params(params)
        self._merged_cache = (self.current_step, params)
        return params

    def _params_snapshot(self):
        """A decode-safe snapshot of the current full params.

        Taken under the state lock, returned with the lock RELEASED: the
        train step updates the live tensors in place, so a multi-dispatch
        decode loop (ragged rows, speculative rounds) must not read them
        once training can advance. The merged LoRA tree already owns fresh
        tensors; host-offloaded params are cast to the compute dtype on
        the device (generation computes in it either way, at half the fp32
        master's bytes); the plain tree is copied on its device."""
        with self._state_lock:
            self._flush_state()  # disk-overlap: serve the step's real params
            params = self._full_params_locked()
            if self.program.base_params is not None:
                return params
            with torch.no_grad():
                if self.program.config.param_offload == "host":
                    dtype = self.program.config.compute_dtype()
                    return {k: v.to(device=self.program.device,
                                    dtype=dtype if v.is_floating_point() else v.dtype)
                            for k, v in params.items()}
                return {k: v.detach().clone() for k, v in params.items()}

    def export_hf_checkpoint(self, out_dir: str) -> tuple[str, int]:
        """Write the job's current weights (LoRA: base+adapters merged) as a
        loadable HF checkpoint directory.

        Returns ``(out_dir, step)`` where ``step`` is the training step the
        exported weights belong to (captured under the state lock — the job
        may advance while the conversion writes).
        """
        from tpu_engine_torch.models.convert import save_hf_checkpoint

        prog = self._sampling_program()
        with self._state_lock:
            step = self.current_step
            # A host copy before the lock drops: the next step updates the
            # live tensors in place.
            params = {k: v.detach().cpu() for k, v in self._full_params_locked().items()}
        return save_hf_checkpoint(params, prog.model_config, out_dir), step

    def export_quantized_snapshot(self, out_dir: str) -> tuple[str, int]:
        """Quantize the job's current weights (weight-only int8,
        ``tpu_engine_torch/quant.py``) and persist them as a self-describing
        serving snapshot — quantize once, serve many times
        (``quant.load_quantized``). Returns ``(out_dir, step)``."""
        from tpu_engine_torch.quant import quantize_params, save_quantized

        prog = self._sampling_program()
        # _params_snapshot takes the state lock itself; the step is read
        # after — a running job may be off by the in-flight step, same as
        # the generate path.
        params = self._params_snapshot()
        step = self.current_step
        qparams = quantize_params(params)
        return save_quantized(qparams, out_dir, model_config=prog.model_config), step

    # -- views ---------------------------------------------------------------

    def describe(self) -> dict[str, Any]:
        spill = None
        disk = getattr(self.program, "disk", None) if self.program else None
        store = getattr(disk, "store", None)
        if store is not None:
            try:
                spill = store.spill_bytes()
            except RuntimeError:
                # The train thread may be repopulating the slab dict
                # (attach/reseed) — a transient miss, not an error.
                spill = None
        return {
            "job_id": self.job_id,
            "status": self.status.value,
            "error": self.error,
            "model_name": self.config.model_name,
            "sharding_stage": int(self.config.sharding_stage),
            "max_steps": self.max_steps,
            "current_step": self.current_step,
            "rollback_count": self.rollback_count,
            "resumed_from_step": self.resumed_from_step,
            "resumed_via_reshard": self.resumed_via_reshard,
            "elastic_mesh": self.elastic_mesh,
            "preemption_reason": self.preemption_reason,
            "recovery_state": self.recovery_state,
            "recovery_events": list(self.recovery_events),
            "unhealthy_devices": list(self.unhealthy_devices),
            "trace_id": self.trace_id,
            "anomalies_total": self.anomalies_total,
            "last_anomaly": self.last_anomaly,
            "hetero": self._hetero.stats() if self._hetero is not None else None,
            "hetero_rebalances_total": self.hetero_rebalances_total,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
            "last_step_time_s": self.last_step_time_s,
            "tokens_per_sec": self.tokens_per_sec,
            "monitor": self.monitor.get_summary(),
            "profile": self.profiler.summary() if self.profiler is not None else None,
            "eval": self.eval_summary(),
            "disk_spill_bytes": spill,
        }

    def eval_summary(self) -> Optional[dict[str, Any]]:
        if not self.eval_history:
            return None
        step, loss = self.eval_history[-1]
        return {
            "source": self._eval_source,
            "latest_step": step,
            "latest_loss": loss,
            "latest_perplexity": _perplexity(loss),
            "history": [{"step": s, "loss": l} for s, l in self.eval_history],
        }


# -- speculative-draft cache -------------------------------------------------

_draft_cache: dict[tuple[str, int, str, str], tuple] = {}
_DRAFT_CACHE_MAX = 4


def _load_draft(path: str, compute_dtype, device):
    """Load (and cache) a draft model from a local HF checkpoint directory
    for speculative decoding. Cached per (path, mtime, dtype, device) — a
    re-export to the same directory refreshes the draft; the cache is tiny
    because drafts are meant to be small."""
    import os

    if not os.path.isdir(path):
        raise ValueError(
            f"draft_hf_checkpoint {path!r} is not a local directory "
            "(hub repo ids are not fetched)"
        )
    key = (path, os.stat(path).st_mtime_ns, str(compute_dtype), str(device))
    hit = _draft_cache.get(key)
    if hit is not None:
        return hit
    from transformers import AutoModelForCausalLM

    from tpu_engine_torch.models.convert import config_from_hf, from_hf

    hf_model = AutoModelForCausalLM.from_pretrained(path, local_files_only=True)
    cfg = config_from_hf(hf_model.config)
    params = from_hf(hf_model.state_dict(), cfg, dtype=compute_dtype, device=device)
    del hf_model
    if len(_draft_cache) >= _DRAFT_CACHE_MAX:
        _draft_cache.pop(next(iter(_draft_cache)))
    _draft_cache[key] = (params, cfg)
    return params, cfg
