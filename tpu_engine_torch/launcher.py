"""Training launcher: config → sharding plan → supervised in-process job
(port of ``tpu_engine/launcher.py``).

Capability parity with the reference's ``DeepSpeedLauncher``
(``ai_engine/deepspeed_launcher.py:103-407``): instead of generating a ZeRO
JSON file and shelling out to the ``deepspeed`` CLI, the launcher *owns*
the training engine — it resolves the config into a concrete sharding
plan, builds the train program, and runs it as a supervised thread with
real status tracking.

- ``generate_plan``  ≈ ``generate_config``: the inspectable, serialisable
  description of what will run (mesh, shardings, optimizer, precision,
  offload, checkpointing, effective batch), resolved against the visible
  CUDA devices;
- ``launch``         ≈ ``launch``: ``dry_run`` short-circuits after plan
  generation; every other launch is a submission to the
  :class:`~tpu_engine_torch.scheduler.FleetScheduler`;
- ``presets``        ≈ ``presets``: JAX's named configurations
  (``tpu_engine/sharding.py``) as this package's ``TrainConfig``.

The CLI is ``python -m tpu_engine_torch.launcher``. It joins torchrun's
process group where its environment names one and points the kernel build
directory at ``compilation_cache_dir``; JAX's XLA flag surface
(``apply_comm_flags``) has no counterpart here. Jobs run on the cards
unless the caller asks for the CPU (``device="cpu"``, ``--device cpu``).
"""

from __future__ import annotations

import dataclasses
import threading
import uuid
from datetime import datetime, timezone
from typing import Any, Callable, Optional

import torch
from pydantic import BaseModel, Field

from tpu_engine_torch import comm, faults, quant_train
from tpu_engine_torch import scheduler as scheduler_mod
from tpu_engine_torch.hbm_estimate import gang_size
from tpu_engine_torch.mesh_runtime import MESH_AXES, MeshConfig
from tpu_engine_torch.models import transformer as tfm
from tpu_engine_torch.parallel import pipeline_zb
from tpu_engine_torch.placement import visible_device_count
from tpu_engine_torch.scheduler import FleetScheduler, JobPriority, QuotaExceeded
from tpu_engine_torch.sharding import (
    ShardingStage,
    grad_pspecs,
    opt_state_pspecs,
    param_pspecs,
    resolve_pipeline_schedule,
)
from tpu_engine_torch.supervisor import JobStatus, TrainingJob
from tpu_engine_torch.tpu_manager import TPUManager
from tpu_engine_torch.train import TrainConfig


def presets() -> dict[str, TrainConfig]:
    """Named configuration registry: JAX's presets, field for field.

    Parity with reference ``DeepSpeedLauncher.presets`` (7b / 13b / 70b),
    plus the 125m smoke config, llama-1b and the 8x7b MoE. The batch
    geometry matches the reference presets. The meshes are JAX's, sized for
    slices of many accelerators; on fewer devices ``generate_plan`` reports
    the shape as requested, not resolved.
    """
    return {
        "125m": TrainConfig(
            model_name="gpt-125m",
            sharding_stage=ShardingStage.DISABLED,
            mesh=MeshConfig(data=-1),
            micro_batch_size=8,
            gradient_accumulation_steps=1,
            seq_len=1024,
            learning_rate=6e-4,
            activation_checkpointing=False,
        ),
        "1b": TrainConfig(
            model_name="llama-1b",
            sharding_stage=ShardingStage.FULL_PARTITIONING,
            mesh=MeshConfig(data=1, fsdp=8),
            micro_batch_size=4,
            gradient_accumulation_steps=4,
            seq_len=2048,
            learning_rate=3e-4,
        ),
        "7b": TrainConfig(
            model_name="llama-7b",
            sharding_stage=ShardingStage.FULL_PARTITIONING,
            mesh=MeshConfig(data=1, fsdp=8),
            micro_batch_size=2,
            gradient_accumulation_steps=8,  # eff. batch 128, as reference
            seq_len=4096,
            learning_rate=3e-4,
            optimizer_offload="host",
        ),
        "13b": TrainConfig(
            model_name="llama-13b",
            sharding_stage=ShardingStage.FULL_PARTITIONING,
            mesh=MeshConfig(data=1, fsdp=16),
            micro_batch_size=1,
            gradient_accumulation_steps=16,  # eff. batch 256, as reference
            seq_len=4096,
            learning_rate=2e-4,
            optimizer_offload="host",
            param_offload="host",
            loss_chunk_size=1024,
        ),
        "70b": TrainConfig(
            model_name="llama-70b",
            sharding_stage=ShardingStage.FULL_PARTITIONING,
            mesh=MeshConfig(data=2, fsdp=128),
            micro_batch_size=1,
            gradient_accumulation_steps=4,  # eff. batch 1024, as reference
            seq_len=4096,
            learning_rate=1.5e-4,
            optimizer_offload="host",
            param_offload="host",
            loss_chunk_size=1024,
            remat_policy="nothing_saveable",
        ),
        "8x7b": TrainConfig(  # Mixtral-style MoE: experts over "model" (EP)
            model_name="moe-8x7b",
            sharding_stage=ShardingStage.FULL_PARTITIONING,
            mesh=MeshConfig(data=1, fsdp=8, model=8),
            micro_batch_size=1,
            # micro 1 x accum 8 x dp 8: an effective batch of 64.
            gradient_accumulation_steps=8,
            seq_len=4096,
            learning_rate=2e-4,
            optimizer_offload="host",
            loss_chunk_size=1024,
        ),
    }


class LaunchResult(BaseModel):
    """Mirrors reference ``LaunchResult``, plus the two-phase fields: a
    launch that cannot be admitted right now is ``status="queued"`` with its
    queue position — not a refusal."""

    job_id: str
    status: str  # "dry_run" | "launched" | "queued" | "failed"
    model_name: str
    effective_batch_size: int
    num_devices: int
    plan: dict[str, Any] = Field(default_factory=dict)
    error: Optional[str] = None
    submission_id: Optional[str] = None
    queue_position: Optional[int] = None


class TPULauncher:
    """In-process launch + job registry (replaces subprocess orchestration).

    Admission is owned by the :class:`~tpu_engine_torch.scheduler.FleetScheduler`
    (one admission authority): ``launch`` is a thin wrapper over ``submit``
    with ``priority=normal``."""

    def __init__(
        self,
        max_concurrent_jobs: int = 1,
        scheduler: Optional[FleetScheduler] = None,
        device: str = "cuda",
    ):
        """``max_concurrent_jobs``: running-job cap for this process's
        devices (default 1 — concurrent train loops would fight for the
        same HBM; raise it deliberately for tiny-model multi-tenancy).
        Enforced by the scheduler. ``device``: ``"cuda"`` (the default) or
        ``"cpu"``, where the jobs run; a given ``scheduler``'s own."""
        self._jobs: dict[str, TrainingJob] = {}
        self._lock = threading.Lock()
        self.device = scheduler.device if scheduler is not None else torch.device(device).type
        # Default to a live fleet view: without one, admission is
        # capacity-only and the elastic shrink path can never engage — a
        # self-healed job would be re-admitted onto the same bad chip.
        self.scheduler = scheduler or FleetScheduler(
            max_concurrent_jobs=max_concurrent_jobs,
            job_factory=self._make_job,
            fleet_fn=TPUManager().get_fleet_status,
            device=self.device,
        )
        if scheduler is not None:
            self.scheduler.job_factory = self._make_job

    @property
    def max_concurrent_jobs(self) -> int:
        return self.scheduler.max_concurrent_jobs

    @max_concurrent_jobs.setter
    def max_concurrent_jobs(self, n: int) -> None:
        self.scheduler.max_concurrent_jobs = n

    def _make_job(self, sub: "scheduler_mod.Submission") -> TrainingJob:
        """Scheduler job factory: construct the attempt AND register it, so
        the registry views (get_job/list_jobs/stop_job) keep working; a
        requeued attempt reuses its job_id — newest wins."""
        job = scheduler_mod._default_job_factory(sub, device=self.device)
        with self._lock:
            self._jobs[job.job_id] = job
        return job

    # -- plan generation (generate_config parity) ----------------------------

    def generate_plan(self, config: TrainConfig) -> dict[str, Any]:
        """Resolve a config into the concrete execution plan: the mesh shape
        against the visible devices, the specs each ZeRO stage gives
        params/grads/optimizer state, optimizer+schedule, precision, remat,
        and checkpoint policy (JAX's keys)."""
        model_cfg = tfm.MODEL_CONFIGS.get(config.model_name)
        n_avail = visible_device_count()
        try:
            mesh_shape = dict(zip(MESH_AXES, config.mesh.resolved_shape(n_avail)))
            mesh_note = f"resolved on {n_avail} visible device(s)"
        except ValueError:
            mesh_shape = dataclasses.asdict(config.mesh)
            mesh_note = (
                f"requested shape (does not fit the {n_avail} visible device(s); "
                "valid on the target slice)"
            )

        stage = config.sharding_stage
        # Representative logical tensors → the sharding each stage gives them.
        rep = {
            "attention_qkv [embed, heads]": ("embed", "heads"),
            "mlp_in [embed, mlp]": ("embed", "mlp"),
            "embedding [vocab, embed]": ("vocab", "embed"),
            "norm_scale [embed]": ("embed",),
        }
        specs = {"params": param_pspecs(rep, stage), "grads": grad_pspecs(rep, stage),
                 "opt_state": opt_state_pspecs(rep, stage)}

        def spec_str(p) -> str:
            return str(tuple(p)) if len(tuple(p)) else "(replicated)"

        shardings = {name: {kind: spec_str(specs[kind][name]) for kind in specs}
                     for name in rep}

        plan: dict[str, Any] = {
            "model": {
                "name": config.model_name,
                "known": model_cfg is not None,
                "param_count": tfm.param_count(model_cfg) if model_cfg else None,
                "seq_len": config.seq_len,
            },
            "mesh": {"shape": mesh_shape, "note": mesh_note, "axes_order_note":
                     "outer→inner = DCN-most→ICI-most: " + str(MESH_AXES)},
            "pipeline_schedule": {
                "configured": config.pipeline_schedule,
                "resolved": resolve_pipeline_schedule(config),
                # Analytic per-stage tick/busy-lane account for the
                # resolved schedule (None off the pipelined path).
                "tick_account": (
                    pipeline_zb.schedule_account(
                        resolve_pipeline_schedule(config),
                        config.mesh.pipe,
                        config.gradient_accumulation_steps,
                    )
                    if config.mesh.pipe > 1 else None
                ),
            },
            "sharding": {
                "stage": int(stage),
                "stage_name": ShardingStage(stage).name,
                "semantics": {
                    "params": "sharded over fsdp" if stage >= 3 else "replicated",
                    "gradients": "reduce-scattered to fsdp shards" if stage >= 2 else "all-reduced",
                    "optimizer_state": "sharded over fsdp" if stage >= 1 else "replicated",
                },
                "representative_tensors": shardings,
            },
            "batch": {
                "micro_batch_size": config.micro_batch_size,
                "gradient_accumulation_steps": config.gradient_accumulation_steps,
                "effective_batch_size": config.effective_batch_size,
            },
            "optimizer": {
                "name": config.optimizer,
                "learning_rate": config.learning_rate,
                "min_lr": config.min_lr,
                "schedule": f"warmup_{config.lr_schedule}",
                "warmup_steps": config.warmup_steps,
                "total_steps": config.total_steps,
                "weight_decay": config.weight_decay,
                "betas": [config.beta1, float(config.beta2)],
                "grad_clip_norm": config.grad_clip_norm,
                "offload": config.optimizer_offload,
            },
            "precision": {
                "compute": config.precision,
                "master_params": config.param_dtype,
                "loss_scaling": "none (bf16 — not needed)",
            },
            # ZeRO++-style collective compression: which mechanisms are on
            # and the analytic wire-volume factors.
            "comm_compression": comm.compression_plan(config),
            # int8 quantized training: mode, targeted matmul groups, and the
            # MFU accounting basis.
            "quant_training": quant_train.training_plan(config),
            "activation_checkpointing": {
                "enabled": config.activation_checkpointing,
                "policy": config.remat_policy,
            },
            "checkpoint": {
                "dir": config.checkpoint_dir,
                "interval_steps": config.checkpoint_interval_steps,
                "max_to_keep": config.max_checkpoints_to_keep,
                "stable_pointer": True,
                "rollback_on_divergence": True,
            },
            "elasticity": {
                "mode": "relaunch-at-new-mesh-shape + resume-from-checkpoint"
                if config.elastic_resume
                else "disabled",
                # Declared admissible device-count bounds: with min set, a
                # resume on a mismatched world auto-selects the largest
                # admissible mesh instead of failing; None = exact-fit only.
                "min_devices": config.elastic_min_devices,
                "max_devices": config.elastic_max_devices,
                # Effective-batch preservation across a resize: accumulation
                # is rescaled to hold micro x accum x dp invariant; these
                # bounds gate admission of the achieved batch.
                "min_batch_size": config.elastic_min_batch_size,
                "max_batch_size": config.elastic_max_batch_size,
                "preserve_effective_batch": True,
                "note": "a process group is fixed-size; a resize is a relaunch with another "
                "world size (reference elasticity block: deepspeed_launcher.py:226-238)",
            },
            # Self-healing recovery pipeline: what happens when a mesh card
            # goes unhealthy mid-training, and whether chaos injection is
            # currently armed in this process.
            "fault_tolerance": {
                "self_heal": bool(config.elastic_resume),
                "recovery_path": (
                    "detect unhealthy mesh chip -> synchronous emergency save "
                    "(bounded exponential-backoff retry; quarantine the step "
                    "on persistent I/O failure) -> requeue -> elastic-shrink "
                    "re-admission on the healthy remainder -> resume from the "
                    "emergency checkpoint (zero lost steps)"
                ),
                "elastic_shrink_on_admission": bool(
                    config.elastic_resume and config.elastic_min_devices is not None
                ),
                "grow_back_when_chips_recover": True,
                "fault_injection_armed": faults.get_active() is not None,
            },
            # Placement planner: the ranked alternative-layout table for this
            # job at the same gang — what `mesh="auto"` would have picked.
            # Advisory on the dry-run/plan surface; binding only at auto
            # admission.
            "placement": self._placement_section(config, n_avail),
        }
        return plan

    def _placement_section(
        self, config: TrainConfig, n_avail: int
    ) -> dict[str, Any]:
        planner = self.scheduler.planner
        if config.model_name not in tfm.MODEL_CONFIGS:
            return {
                "available": False,
                "reason": f"no_estimate:{config.model_name}",
            }
        try:
            fleet = self.scheduler._fleet()
            devices = (
                [d for d in fleet.devices if d.is_available]
                if fleet is not None and fleet.devices
                else None
            )
            gang = gang_size(config, len(devices) if devices else n_avail)
            result = planner.plan(
                config, devices=devices, reserved=self.scheduler._reserved,
                gang=gang,
            )
        except Exception as e:  # advisory plane — never sink the plan
            return {"available": False, "reason": f"{type(e).__name__}: {e}"}
        return {
            "available": True,
            "gang": gang,
            "evaluated": result.evaluated,
            "feasible": len(result.plans),
            "pruned": len(result.pruned),
            "ranked_plans": result.table(top_k=5),
            "note": (
                "predicted step times are a nominal-roofline RANKING model "
                "(see tpu_engine_torch/placement.py); submit with mesh='auto' to "
                "admit the top feasible plan"
            ),
        }

    # -- launch --------------------------------------------------------------

    def launch(
        self,
        config: TrainConfig,
        dry_run: bool = False,
        max_steps: Optional[int] = None,
        data_fn: Optional[Callable[[int], torch.Tensor]] = None,
        watch_preemption: Optional[bool] = None,
        install_signal_handlers: bool = False,
        block: bool = False,
        priority: JobPriority = JobPriority.NORMAL,
        submitter: str = "anonymous",
    ) -> LaunchResult:
        """Two-phase: submit to the scheduler, then one synchronous admit
        pass. An admitted job is ``"launched"``; one the fleet cannot take
        right now is ``"queued"`` with its position (the scheduler keeps
        working on it — this is not a refusal).

        ``watch_preemption=True`` opts into the REAL metadata poll / signal
        handlers; the default (None) still gets a watcher wired to the
        scheduler's preempt seam."""
        plan = self.generate_plan(config)
        ts = datetime.now(timezone.utc).strftime("%Y%m%d_%H%M%S")
        # Reference id format + a uniquifier: second-resolution stamps
        # collide for rapid launches of the same model.
        job_id = f"tpu_{config.model_name}_{ts}_{uuid.uuid4().hex[:6]}"

        base = dict(
            model_name=config.model_name,
            effective_batch_size=config.effective_batch_size,
            num_devices=visible_device_count(),
            plan=plan,
        )
        if dry_run:
            return LaunchResult(job_id=job_id, status="dry_run", **base)

        if config.model_name not in tfm.MODEL_CONFIGS:
            return LaunchResult(
                job_id=job_id,
                status="failed",
                error=f"unknown model '{config.model_name}'; known: {sorted(tfm.MODEL_CONFIGS)}",
                **base,
            )
        job_kwargs: dict[str, Any] = dict(
            data_fn=data_fn,
            max_steps=max_steps,
            install_signal_handlers=install_signal_handlers,
        )
        if watch_preemption is not None:
            job_kwargs["watch_preemption"] = watch_preemption
        try:
            sub = self.scheduler.submit(
                config, priority=priority, submitter=submitter,
                job_kwargs=job_kwargs,
            )
        except QuotaExceeded as e:
            return LaunchResult(job_id=job_id, status="failed", error=str(e), **base)
        self.scheduler.poll()
        if block:
            sub = self.scheduler.wait(sub.submission_id)
        state = sub.state
        if state == scheduler_mod.SubmissionState.QUEUED:
            return LaunchResult(
                job_id=sub.job_id,
                status="queued",
                submission_id=sub.submission_id,
                queue_position=self.scheduler.queue_position(sub.submission_id),
                **base,
            )
        if state == scheduler_mod.SubmissionState.FAILED and (
            sub.job is None or sub.attempts == 0
        ):
            return LaunchResult(
                job_id=sub.job_id,
                status="failed",
                submission_id=sub.submission_id,
                error=sub.last_skip_reason or "admission failed",
                **base,
            )
        return LaunchResult(
            job_id=sub.job_id,
            status="launched",
            submission_id=sub.submission_id,
            **base,
        )

    # -- presets -------------------------------------------------------------

    @staticmethod
    def presets() -> dict[str, TrainConfig]:
        return presets()

    # -- registry ------------------------------------------------------------

    def get_job(self, job_id: str) -> Optional[TrainingJob]:
        return self._jobs.get(job_id)

    def list_jobs(self) -> list[dict[str, Any]]:
        return [j.describe() for j in self._jobs.values()]

    def stop_job(self, job_id: str) -> bool:
        job = self._jobs.get(job_id)
        if job is None:
            # Not admitted yet — a queued submission is cancelled instead.
            sub = self.scheduler.find_by_job_id(job_id)
            if sub is not None:
                return self.scheduler.cancel(sub.submission_id)
            return False
        job.stop()
        return True

    def delete_job(self, job_id: str) -> bool:
        """Drop a *terminal* job from the registry (bounds registry growth;
        checkpoints on disk are untouched). Raises ValueError for a job
        that is still pending/compiling/running — stop it first."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return False
            if job.status in (JobStatus.PENDING, JobStatus.COMPILING, JobStatus.RUNNING):
                raise ValueError(
                    f"job '{job_id}' is {job.status.value}; stop it before deleting"
                )
            del self._jobs[job_id]
        return True


# ---------------------------------------------------------------------------
# CLI — `python -m tpu_engine_torch.launcher` (one worker a process under
# torchrun; training runs in this process).
# ---------------------------------------------------------------------------


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    import json
    import os

    parser = argparse.ArgumentParser(description="Training launcher (PyTorch/CUDA)")
    parser.add_argument("--preset", help="named preset (see --list-presets)")
    parser.add_argument("--model", help="model name (overrides preset's)")
    parser.add_argument("--list-presets", action="store_true")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--checkpoint-dir", default=os.environ.get("CHECKPOINT_DIR"))
    parser.add_argument("--watch-preemption", action="store_true",
                        help="poll the preemption notice; checkpoint on warning")
    parser.add_argument("--dry-run", action="store_true",
                        help="print the execution plan and exit")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="config override, e.g. --set seq_len=4096 "
                        "--set mesh.fsdp=8 (repeatable)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the job runs (default: the cards)")
    args = parser.parse_args(argv)

    launcher = TPULauncher(device=args.device)
    if args.list_presets:
        for name, cfg in launcher.presets().items():
            print(f"{name}: {cfg.model_name} stage={int(cfg.sharding_stage)} "
                  f"eff_batch={cfg.effective_batch_size}")
        return 0

    if args.preset:
        all_presets = launcher.presets()
        if args.preset not in all_presets:
            parser.error(f"unknown preset '{args.preset}'; known: {sorted(all_presets)}")
        cfg_dict = scheduler_mod.config_to_dict(all_presets[args.preset])
    else:
        cfg_dict = scheduler_mod.config_to_dict(TrainConfig())
    if args.model:
        cfg_dict["model_name"] = args.model
    if args.checkpoint_dir:
        cfg_dict["checkpoint_dir"] = args.checkpoint_dir
    for item in args.set:
        key, _, value = item.partition("=")
        if not value:
            parser.error(f"--set expects KEY=VALUE, got '{item}'")
        target, leaf = cfg_dict, key
        if "." in key:
            head, leaf = key.rsplit(".", 1)
            for part in head.split("."):
                target = target.setdefault(part, {})
        try:
            target[leaf] = json.loads(value)
        except json.JSONDecodeError:
            target[leaf] = value
    config = scheduler_mod.config_from_dict(cfg_dict)

    # Multi-process rendezvous first (torchrun's environment; a run of one
    # process joins nothing), then the kernel build directory: restarts of
    # this worker (preemption, elastic relaunch) find the kernels built.
    from tpu_engine_torch.mesh_runtime import initialize_distributed

    initialize_distributed(device=args.device)

    from tpu_engine_torch.compile_cache import enable_compilation_cache

    enable_compilation_cache(config.compilation_cache_dir)

    result = launcher.launch(
        config,
        dry_run=args.dry_run,
        max_steps=args.max_steps,
        # True opts into the real metadata poll; None keeps the scheduler seam.
        watch_preemption=True if args.watch_preemption else None,
        install_signal_handlers=not args.dry_run,
        block=not args.dry_run,
    )
    print(json.dumps(result.model_dump(), indent=2, default=str))
    if result.status == "failed":
        return 1
    if result.status == "dry_run":
        return 0
    job = launcher.get_job(result.job_id)
    final = job.describe() if job else {}
    print(json.dumps(final, indent=2, default=str))
    return 0 if final.get("status") == "completed" else 1


if __name__ == "__main__":
    raise SystemExit(main())
