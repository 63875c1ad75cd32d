"""Placement planner: auto-layout search at admission, one shared cost model
(port of ``tpu_engine/placement.py``: JAX's search and cost model over this
package's estimators; the nominal constants are the H100's).

Users hand-pick ``(data, fsdp, model, pipe, schedule, quant, comm)`` per
submission even though every cost-model ingredient already exists in-tree:
the per-layout memory plane (:func:`tpu_engine_torch.hbm_estimate.estimate_job_hbm`),
the analytic pipeline lane account
(:func:`tpu_engine_torch.parallel.pipeline_zb.schedule_account`) and the
ZeRO++-style per-leaf byte model
(:func:`tpu_engine_torch.comm_compress.expected_volume_factors`). The planner
composes them into one search (the Placement-Semantics recipe,
arXiv:2601.02311; the comm-volume accounting follows ZeRO++,
arXiv:2306.10209):

1. **enumerate** — every factorization of the gang across the
   ``data × fsdp × pipe × model`` mesh axes, crossed with sharding stage,
   pipeline schedule and (opt-in) quant / comm-compression toggles;
2. **prune** — each candidate is constructed as a real
   :class:`~tpu_engine_torch.train.TrainConfig` (so the config interaction
   matrix fires) and then pushed through a mirror of
   ``build_train_program``'s build-time checks — the planner can never
   emit a layout that build_train_program would reject;
3. **filter** — per-device HBM via ``estimate_job_hbm`` against live
   fleet headroom minus the scheduler's per-device reservation ledger;
4. **rank** — predicted step time = max(roofline compute ÷
   ``schedule_account`` busy fraction, streamed fsdp/data collectives)
   + the exposed interconnect term (tensor-parallel all-reduces, pipe
   boundary permutes, cross-node hops) from the comm byte model over
   intra-node ("ICI": NVLink) vs cross-node ("DCN": the network) bandwidth.

The prediction is a *ranking* model: absolute seconds assume a nominal
H100 roofline and are meaningless on the CPU, but every term that
differs between layouts (bubble fraction, gather/reduce bytes, per-shard
batch) is modelled, so the order survives.

Wiring: ``FleetScheduler.submit(..., mesh="auto")`` admits the
predicted-fastest feasible plan, and ``TPULauncher`` dry runs return the
ranked table.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Iterable, Optional, Sequence

import torch
from pydantic import BaseModel, ConfigDict, Field

from tpu_engine_torch.hbm_estimate import HBMEstimate, estimate_job_hbm, gang_size
from tpu_engine_torch.mesh_runtime import MeshConfig
from tpu_engine_torch.models import transformer as tfm
from tpu_engine_torch.parallel.pipeline_zb import schedule_account
from tpu_engine_torch.sharding import (
    OffloadDevice,
    Precision,
    ShardingStage,
    dtype_of,
    resolve_pipeline_schedule,
)
from tpu_engine_torch.train import TrainConfig

log = logging.getLogger(__name__)

# Nominal per-card roofline / link constants, from NVIDIA's data sheet of
# the H100 SXM5 80GB (NVIDIA H100 80GB HBM3, 700 W). Absolute values only
# scale the prediction; RANKING depends on their ratios. Inside a node
# "ICI" is NVLink, across nodes "DCN" is the network. The compute fallback
# keeps predictions defined on the CPU, where
# profiler.peak_flops_per_chip returns None.
NOMINAL_PEAK_FLOPS = 989e12  # H100 SXM5 dense bf16 (profiler.PEAK_FLOPS_BF16["h100"])
NOMINAL_ICI_BYTES_S = 4.5e11  # H100 SXM5 NVLink 4: 900 GB/s both ways, one way
NOMINAL_DCN_BYTES_S = 5e10  # one 400 Gb/s NIC a GPU, as in a DGX H100
ASSUMED_MFU = 0.45  # roofline derate; cancels in ranking


def visible_device_count() -> int:
    """Devices this process can place on: the visible CUDA cards, or one
    CPU device where there is no card."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


class PlacementPlan(BaseModel):
    """One validated candidate layout with its cost-model verdict."""

    model_config = ConfigDict(arbitrary_types_allowed=True)

    mesh: dict[str, int]
    gang: int
    sharding_stage: int
    pipeline_schedule: str  # resolved concrete schedule ("gpipe"/"1f1b"/"zb")
    micro_batch_size: int
    gradient_accumulation_steps: int
    quant_training: str = "none"
    comm_compress: bool = False
    predicted_compute_s: float
    predicted_bubble_fraction: float
    predicted_comm_s: float  # total collective seconds (streamed + exposed)
    predicted_exposed_comm_s: float = 0.0  # critical-path share of the above
    predicted_step_time_s: float
    # Compile-cache verdict (None/0 when the planner has no index): is this
    # exact layout warm in the kernel build directory, and what cold-build
    # cost does admission pay when it is not (per-layout EMA of measured
    # cold builds — see tpu_engine_torch/compile_index.py).
    compile_warm: Optional[bool] = None
    expected_compile_s: float = 0.0
    # Reshard verdict (0/None without a resume topology): one-time cost of
    # remapping the saved checkpoint onto THIS plan's factorization
    # (tpu_engine_torch/reshard.py cost model) — 0 for a same-topology resume.
    predicted_reshard_s: float = 0.0
    reshard_same_topology: Optional[bool] = None
    # Mean relative throughput the cost model assumed for this gang (1.0 =
    # every chip at nominal speed; < 1 when the heterogeneity plane reports
    # degraded hosts — see tpu_engine_torch/hetero.py). Observability only: the
    # compute term was already divided by it.
    assumed_rel_throughput: float = 1.0
    hbm_estimate: Optional[HBMEstimate] = None
    feasible: bool = True
    skip_reason: Optional[str] = None
    # The fully-validated config this plan runs as — excluded from dumps
    # (the API table stays compact); the scheduler admits exactly this.
    config: Optional[Any] = Field(default=None, exclude=True, repr=False)

    @property
    def label(self) -> str:
        axes = "x".join(
            f"{k}{v}" for k, v in self.mesh.items()
            if v > 1 and k != "dcn_data"
        ) or "data1"
        tags = [self.pipeline_schedule] if self.mesh.get("pipe", 1) > 1 else []
        if self.quant_training != "none":
            tags.append(self.quant_training)
        if self.comm_compress:
            tags.append("commq")
        return "·".join([axes, f"s{self.sharding_stage}", *tags])


class PlannerResult(BaseModel):
    """Ranked outcome of one planning pass."""

    plans: list[PlacementPlan]  # feasible, predicted-fastest first
    infeasible: list[PlacementPlan]  # HBM/headroom rejected (with reasons)
    pruned: list[dict[str, str]]  # invalid layouts: {"layout", "reason"}
    evaluated: int
    skip_reason: Optional[str] = None  # e.g. "no_estimate:<model>"
    search_s: float = 0.0  # wall seconds the enumerate+rank pass took

    @property
    def best(self) -> Optional[PlacementPlan]:
        return self.plans[0] if self.plans else None

    def table(self, top_k: int = 10) -> list[dict[str, Any]]:
        """Compact ranked rows for the API / launcher plan."""
        rows = []
        for rank, p in enumerate(self.plans[:top_k], start=1):
            rows.append({
                "rank": rank,
                "layout": p.label,
                "mesh": p.mesh,
                "gang": p.gang,
                "sharding_stage": p.sharding_stage,
                "pipeline_schedule": p.pipeline_schedule,
                "micro_batch_size": p.micro_batch_size,
                "gradient_accumulation_steps": p.gradient_accumulation_steps,
                "predicted_step_time_s": round(p.predicted_step_time_s, 6),
                "predicted_bubble_fraction": round(p.predicted_bubble_fraction, 4),
                "predicted_comm_s": round(p.predicted_comm_s, 6),
                "compile_warm": p.compile_warm,
                "expected_compile_s": round(p.expected_compile_s, 3),
                "predicted_reshard_s": round(p.predicted_reshard_s, 3),
                "hbm_gib_per_device": (
                    round(p.hbm_estimate.device_total_gib, 3)
                    if p.hbm_estimate else None
                ),
            })
        return rows


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def _mirror_build_checks(cfg: TrainConfig, model_cfg: tfm.ModelConfig) -> None:
    """Re-raise (as ValueError) every ``build_train_program`` build-time
    interaction the config validators do not already cover, so an
    enumerated plan can never fail at job construction. Mirrors
    ``tpu_engine_torch/train.py`` — the checks there are the source of truth;
    this copy exists so the planner prunes instead of admitting a dud."""
    m = cfg.mesh
    pipe, model_ax, seq_ax = m.pipe, m.model, m.sequence
    schedule = resolve_pipeline_schedule(cfg)
    if pipe > 1 and model_cfg.n_layers % pipe != 0:
        raise ValueError(
            f"n_layers={model_cfg.n_layers} not divisible by pipe={pipe}"
        )
    moe_impl = cfg.moe_impl or model_cfg.moe_impl
    if cfg.moe_impl is not None and not model_cfg.is_moe:
        raise ValueError(f"moe_impl={cfg.moe_impl!r} on dense model")
    if model_cfg.is_moe and moe_impl == "ragged" and model_ax > 1:
        raise ValueError("moe_impl='ragged' cannot shard the expert dim")
    if (
        cfg.quant_training == "int8"
        and model_cfg.is_moe
        and moe_impl == "ragged"
        and "moe" in cfg.quant_train_targets
    ):
        raise ValueError("quant int8 cannot quantize ragged MoE")
    window = (
        cfg.sliding_window
        if cfg.sliding_window is not None
        else model_cfg.sliding_window
    )
    if window and cfg.attention_impl in ("ring", "ulysses"):
        raise ValueError("sliding_window with context-parallel attention")
    if cfg.attention_impl == "ulysses":
        local_heads = model_cfg.n_heads // model_ax
        if local_heads % seq_ax != 0:
            raise ValueError(
                f"ulysses: {local_heads} local heads not divisible by "
                f"sequence axis {seq_ax}"
            )
    if model_ax > 1 and (
        model_cfg.n_heads % model_ax
        or model_cfg.n_kv_heads % model_ax
        or model_cfg.d_ff % model_ax
        or model_cfg.vocab_size % model_ax
    ):
        raise ValueError(
            f"model axis {model_ax} does not divide heads/kv/ffn/vocab"
        )
    if cfg.loss_chunk_size:
        if cfg.seq_len % cfg.loss_chunk_size:
            raise ValueError("loss_chunk_size must divide seq_len")
        if schedule in ("1f1b", "zb") and pipe > 1:
            raise ValueError(f"loss_chunk_size with schedule {schedule!r}")
    use_lora = cfg.lora_rank is not None
    if use_lora and pipe > 1:
        raise ValueError("LoRA with pipeline parallelism")
    offload_params = cfg.param_offload == OffloadDevice.HOST
    if offload_params and (use_lora or pipe > 1):
        raise ValueError("param_offload=host with LoRA/pipeline")
    if cfg.optimizer_offload == OffloadDevice.DISK and pipe > 1:
        raise ValueError("optimizer_offload='disk' with pipeline")
    reduced_comm = (
        cfg.grad_allreduce_dtype is not None
        and cfg.grad_allreduce_dtype != Precision.FP32
    )
    if reduced_comm and pipe > 1 and schedule in ("1f1b", "zb"):
        raise ValueError(f"grad_allreduce_dtype with schedule {schedule!r}")
    if reduced_comm and offload_params:
        raise ValueError("grad_allreduce_dtype with param_offload=host")
    # JAX's config refuses int8 under the manual-vjp schedules; this
    # package's schedules run it, but the search keeps JAX's space.
    if cfg.quant_training != "none" and cfg.pipeline_schedule in ("1f1b", "zb"):
        raise ValueError(
            f"quant_training='int8' with pipeline_schedule="
            f"{cfg.pipeline_schedule!r} is unsupported")


class PlacementPlanner:
    """Enumerate → prune → HBM-filter → rank layouts for one submission.

    Thread-safe counters only; the search itself is pure. One instance
    lives on the :class:`~tpu_engine_torch.scheduler.FleetScheduler` so
    admission, grow-back and the launcher plan share a single counter
    plane.
    """

    def __init__(
        self,
        estimate_fn: Callable[..., Optional[HBMEstimate]] = estimate_job_hbm,
        peak_flops: Optional[float] = None,
        ici_bytes_s: float = NOMINAL_ICI_BYTES_S,
        dcn_bytes_s: float = NOMINAL_DCN_BYTES_S,
        consider_quant: bool = False,
        consider_comm_compress: bool = False,
        stages: tuple[ShardingStage, ...] = (
            ShardingStage.FULL_PARTITIONING,
            ShardingStage.GRADIENT_PARTITIONING,
        ),
        max_gang_enumeration: int = 16,
        hbm_margin_frac: float = 0.35,
        compile_index: Optional[Any] = None,
        prefer_warm_max_slowdown_pct: float = 5.0,
        throughput_fn: Optional[Callable[[], Sequence[float]]] = None,
        calibration_path: Optional[str] = None,
        calibration_alpha: float = 0.3,
    ):
        if peak_flops is None:
            try:
                from tpu_engine_torch.profiler import peak_flops_per_chip

                peak_flops = peak_flops_per_chip()
            except Exception:
                peak_flops = None
        self.peak_flops = peak_flops or NOMINAL_PEAK_FLOPS
        self.estimate_fn = estimate_fn
        self.ici_bytes_s = ici_bytes_s
        self.dcn_bytes_s = dcn_bytes_s
        # Quant / comm-compression variants are opt-in (JAX's default):
        # enumerating them by default would rank layouts by wins the
        # cost model only assumes.
        self.consider_quant = consider_quant
        self.consider_comm_compress = consider_comm_compress
        self.stages = stages
        self.max_gang_enumeration = max_gang_enumeration
        # estimate_job_hbm is analytic: it cannot see the allocator's
        # temporaries or the in-flight microbatch stash, so a plan near the
        # top of free HBM can still run out. JAX's 35% margin is kept: the
        # gate charges every estimate this fraction on top before
        # comparing to headroom.
        self.hbm_margin_frac = hbm_margin_frac
        # Compile-cache awareness: with an index attached, every candidate
        # is annotated warm/cold and the ranking tie-breaks toward warm
        # layouts — a warm plan may be preferred over a cold one predicted
        # up to ``prefer_warm_max_slowdown_pct`` percent faster (the cold
        # plan's one-time compile usually dwarfs that step-time edge).
        self.compile_index = compile_index
        self.prefer_warm_max_slowdown_pct = prefer_warm_max_slowdown_pct
        # Reshard awareness: when ``plan(saved_topology=...)`` names the
        # factorization a resume candidate's checkpoints were saved under,
        # a same-topology plan within this band of the fastest feasible
        # one outranks every topology-changing plan — the remap is a
        # one-time cost, so only a real step-time edge justifies it.
        self.prefer_same_topology_max_slowdown_pct = prefer_warm_max_slowdown_pct
        # Heterogeneity input: a callable returning per-device relative
        # throughputs (1.0 = nominal). The compute term is divided by the
        # gang's mean, so a 25%-degraded host raises the predicted step
        # time of any plan forced to gate on it. Default None keeps every
        # existing prediction byte-identical.
        self.throughput_fn = throughput_fn

        self._lock = threading.Lock()
        self.plans_evaluated_total = 0
        self.plans_pruned_total = 0
        self.plans_hbm_rejected_total = 0
        self.plans_chosen_total = 0
        self.no_estimate_refusals_total = 0
        self.warm_tiebreaks_total = 0
        self.topology_rejected_total = 0
        self.reshard_tiebreaks_total = 0
        self.prune_reasons: dict[str, int] = {}
        self.last_feasible = 0
        self.last_chosen_predicted_s: Optional[float] = None
        self._observations: list[tuple[float, float]] = []  # (predicted, observed)

        # Predicted-vs-observed calibration, persisted alongside the
        # compile-index sidecar so restarts don't forget what admission
        # learned (same atomic tmp+rename discipline as compile_index.py).
        self.calibration_alpha = calibration_alpha
        self.calibration_persist_errors_total = 0
        self.calibration_load_errors_total = 0
        self._calibration_path: Optional[str] = None
        self._calib_ema_rel_error: Optional[float] = None
        self._calib_observations_total = 0
        self._calib_last: Optional[tuple[float, float]] = None
        if calibration_path is not None:
            self.attach_calibration(calibration_path)

    # -- enumeration ---------------------------------------------------------

    def enumerate(
        self,
        config: TrainConfig,
        gang: int,
        *,
        consider_quant: Optional[bool] = None,
        consider_comm_compress: Optional[bool] = None,
        stages: Optional[Iterable[ShardingStage]] = None,
    ) -> tuple[list[PlacementPlan], list[dict[str, str]]]:
        """All valid layouts of ``config`` on exactly ``gang`` devices.

        Returns ``(plans, pruned)``: every plan carries a fully-validated
        ``TrainConfig`` (the interaction matrix and the mirrored build
        checks both passed); ``pruned`` records the rejected layouts with
        their reason — known-invalid combos (1f1b × quant_training,
        comm-compression × pipe, ...) land there, never in ``plans``.

        The search keeps tokens/step constant: the submitted global batch
        (``micro × accum × data × fsdp`` at the configured mesh) is
        re-split per layout — per-shard batch must divide evenly, micro
        shrinks to the largest divisor ≤ the requested micro, and the
        remainder becomes gradient accumulation (the pipeline stream).
        """
        model_cfg = tfm.MODEL_CONFIGS.get(config.model_name)
        if model_cfg is None:
            raise ValueError(f"no_estimate:{config.model_name}")
        cq = self.consider_quant if consider_quant is None else consider_quant
        cc = (
            self.consider_comm_compress
            if consider_comm_compress is None
            else consider_comm_compress
        )
        stage_opts = tuple(stages) if stages is not None else self.stages

        base = {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}
        base_mesh = config.mesh
        # Requested global batch at the configured mesh (data=-1 resolved
        # against the same gang).
        base_data, base_fsdp, _, _, _ = base_mesh.resolved_shape(
            gang_size(config, gang)
        )
        global_batch = (
            config.micro_batch_size
            * config.gradient_accumulation_steps
            * base_data
            * base_fsdp
        )
        seq_ax = base_mesh.sequence  # held fixed: same factor in every plan
        dcn = base_mesh.dcn_data

        plans: list[PlacementPlan] = []
        pruned: list[dict[str, str]] = []

        def _prune(layout: str, reason: str) -> None:
            pruned.append({"layout": layout, "reason": reason})

        if gang % seq_ax:
            _prune(f"gang{gang}", f"gang not divisible by sequence axis {seq_ax}")
            self._account(evaluated=1, pruned_n=1, reasons=[r["reason"] for r in pruned])
            return plans, pruned

        spatial = gang // seq_ax
        n_evaluated = 0
        for model_ax in _divisors(spatial):
            for pipe in _divisors(spatial // model_ax):
                for fsdp in _divisors(spatial // (model_ax * pipe)):
                    data = spatial // (model_ax * pipe * fsdp)
                    name = f"d{data}·f{fsdp}·p{pipe}·t{model_ax}"
                    if data % dcn:
                        n_evaluated += 1
                        _prune(name, f"data axis {data} not divisible by dcn_data {dcn}")
                        continue
                    dp = data * fsdp
                    if global_batch % dp:
                        n_evaluated += 1
                        _prune(name, f"global batch {global_batch} not divisible by dp {dp}")
                        continue
                    per_shard = global_batch // dp
                    micro = max(
                        d for d in _divisors(per_shard)
                        if d <= config.micro_batch_size
                    )
                    accum = per_shard // micro
                    schedules = (
                        ("gpipe", "1f1b", "zb") if pipe > 1 else ("auto",)
                    )
                    stage_list = (
                        stage_opts if fsdp > 1
                        else (ShardingStage.FULL_PARTITIONING,)
                    )
                    quant_opts = ("none", "int8") if cq else ("none",)
                    comm_opts = (False, True) if cc else (False,)
                    for stage in stage_list:
                        for schedule in schedules:
                            for quant in quant_opts:
                                for comm in comm_opts:
                                    n_evaluated += 1
                                    tag = name + f"·s{int(stage)}·{schedule}" + (
                                        f"·{quant}" if quant != "none" else ""
                                    ) + ("·commq" if comm else "")
                                    cand = dict(base)
                                    cand["mesh"] = MeshConfig(
                                        data=data, fsdp=fsdp,
                                        pipe=pipe, sequence=seq_ax,
                                        model=model_ax, dcn_data=dcn,
                                    )
                                    cand["sharding_stage"] = stage
                                    cand["pipeline_schedule"] = schedule
                                    cand["micro_batch_size"] = micro
                                    cand["gradient_accumulation_steps"] = accum
                                    cand["quant_training"] = quant
                                    if comm:
                                        cand["comm_quant_weights"] = True
                                        cand["comm_quant_grads"] = True
                                    try:
                                        # A fresh construction, so that
                                        # __post_init__ runs the
                                        # interaction matrix.
                                        cfg = TrainConfig(**cand)
                                        _mirror_build_checks(cfg, model_cfg)
                                    except ValueError as e:
                                        _prune(tag, str(e).splitlines()[0][:160])
                                        continue
                                    plans.append(self._predict(cfg, model_cfg, gang))
        self._account(
            evaluated=n_evaluated,
            pruned_n=len(pruned),
            reasons=[r["reason"] for r in pruned],
        )
        return plans, pruned

    # -- cost model ----------------------------------------------------------

    def _gang_rel_throughput(self, gang: int) -> float:
        """Mean relative throughput of the ``gang`` fastest known devices.

        The planner places on the best available chips, so the cost model
        charges the mean of the top-``gang`` per-device estimates; unknown
        devices (fewer estimates than gang) count as nominal 1.0. Clamped
        to (0, 1]: chips never beat nominal, and a dead estimate must not
        zero the divisor. Any failure in the callable degrades to 1.0 —
        heterogeneity awareness must never block prediction.
        """
        if self.throughput_fn is None:
            return 1.0
        try:
            rates = [float(r) for r in self.throughput_fn()]
        except Exception:
            log.debug("throughput_fn consult failed", exc_info=True)
            return 1.0
        if not rates:
            return 1.0
        top = sorted(rates, reverse=True)[:gang]
        top += [1.0] * max(gang - len(top), 0)
        mean = sum(top) / len(top)
        return min(max(mean, 1e-3), 1.0)

    def _predict(
        self, cfg: TrainConfig, model_cfg: tfm.ModelConfig, gang: int
    ) -> PlacementPlan:
        """Predicted step time for one validated candidate.

        compute: roofline seconds for the step's global tokens, divided by
        the schedule's busy fraction (bubble lanes burn chip time);
        comm: analytic bytes per device per step over ICI/DCN —
        stage-3 weight all-gathers per microbatch (÷ the qwZ wire factor
        when compressed), gradient reduce-scatter/all-reduce over
        fsdp/data (the data plane rides DCN when dcn_data > 1, ÷ the qgZ
        factor when compressed), per-layer tensor-parallel activation
        all-reduces, and pipeline boundary permutes.

        The fsdp/data collectives are *streamed*: the weight gathers and
        gradient reduces overlap the per-layer matmuls (that is what makes
        FSDP work at all), so they are charged as ``max(compute,
        streamed_comm)`` rather than added.
        Tensor-parallel activation all-reduces sit between sequential
        matmuls, pipeline boundary permutes between stages, and DCN hops
        behind a long latency — those stay on the critical path. Charging
        everything serially over-ranks deep-pipe layouts (their comm is
        boundary-only) against fsdp layouts whose gathers are actually
        free.
        """
        m = cfg.mesh
        # Resolve elastic axes (data=-1) against the gang — the raw mesh
        # would give a negative token count.
        data, fsdp, pipe, seq_axis, model_ax = m.resolved_shape(gang)
        seq = cfg.seq_len
        micro = cfg.micro_batch_size
        accum = cfg.gradient_accumulation_steps
        schedule = resolve_pipeline_schedule(cfg)

        tokens = data * fsdp * micro * accum * seq
        flops = tfm.train_flops_per_token(model_cfg, seq) * tokens
        compute_s = flops / (gang * self.peak_flops * ASSUMED_MFU)
        acct = schedule_account(schedule, pipe, accum)
        busy = acct["busy_fraction"] or 1.0
        compute_s /= busy
        # Heterogeneity: a synchronous gang runs at its mean effective rate
        # only if rows are rebalanced; without input (rel=1.0) nothing
        # changes. The divide keeps ranking stable — every candidate on the
        # same gang is scaled identically, but cross-gang comparisons (grow
        # targets) see the slow chips.
        rel = self._gang_rel_throughput(gang)
        compute_s /= rel

        compute_b = cfg.compute_dtype().itemsize
        grad_b = (
            dtype_of(cfg.grad_allreduce_dtype).itemsize
            if cfg.grad_allreduce_dtype is not None else 4
        )
        n_params = tfm.param_count(model_cfg)
        # Params owned by this device's fsdp group (model/pipe shard first).
        p_group = n_params / (model_ax * pipe)
        ici_stream_bytes = 0.0  # overlaps with compute (fsdp/data plane)
        ici_exposed_bytes = 0.0  # critical path (tp all-reduce, pipe p2p)
        dcn_bytes = 0.0

        if fsdp > 1 and cfg.sharding_stage >= ShardingStage.FULL_PARTITIONING:
            # ZeRO-3 weight all-gather, forward + backward re-gather, once
            # per accumulation microbatch.
            gather = p_group * compute_b * (fsdp - 1) / fsdp * 2 * accum
            if cfg.comm_quant_weights:
                from tpu_engine_torch.comm_compress import expected_volume_factors

                gather /= expected_volume_factors(
                    cfg.comm_quant_block_size
                )["weight_gather"]
            ici_stream_bytes += gather

        g_bytes = p_group * grad_b
        if fsdp > 1:
            if cfg.sharding_stage >= ShardingStage.GRADIENT_PARTITIONING:
                ici_stream_bytes += g_bytes * (fsdp - 1) / fsdp  # reduce-scatter
                g_bytes /= fsdp  # the data-plane reduce moves the shard
            else:
                ici_stream_bytes += 2 * g_bytes * (fsdp - 1) / fsdp  # all-reduce
        if data > 1:
            reduce = 2 * g_bytes * (data - 1) / data
            if m.dcn_data > 1:
                if cfg.comm_quant_grads:
                    from tpu_engine_torch.comm_compress import expected_volume_factors

                    reduce /= expected_volume_factors(
                        cfg.comm_quant_block_size
                    )["grad_cross_slice"]
                dcn_bytes += reduce
            else:
                ici_stream_bytes += reduce
        if model_ax > 1:
            # Two activation all-reduces per layer per direction (attention
            # out + MLP out), sized [micro, seq, d_model].
            act = micro * seq * model_cfg.d_model * compute_b
            ici_exposed_bytes += (
                8.0 * act * (model_ax - 1) / model_ax
                * (model_cfg.n_layers / pipe) * accum
            )
        if pipe > 1:
            act = micro * seq * model_cfg.d_model * compute_b
            ici_exposed_bytes += 2.0 * act * accum  # boundary ppermute fwd+bwd

        stream_s = ici_stream_bytes / self.ici_bytes_s
        exposed_s = (
            ici_exposed_bytes / self.ici_bytes_s
            + dcn_bytes / self.dcn_bytes_s
        )
        comm_s = stream_s + exposed_s
        plan = PlacementPlan(
            mesh={
                "data": data, "fsdp": fsdp, "pipe": pipe,
                "sequence": seq_axis, "model": model_ax,
                "dcn_data": m.dcn_data,
            },
            gang=gang,
            sharding_stage=int(cfg.sharding_stage),
            pipeline_schedule=schedule,
            micro_batch_size=micro,
            gradient_accumulation_steps=accum,
            quant_training=cfg.quant_training,
            comm_compress=bool(cfg.comm_quant_weights or cfg.comm_quant_grads),
            predicted_compute_s=compute_s,
            predicted_bubble_fraction=acct["bubble_fraction"],
            predicted_comm_s=comm_s,
            predicted_exposed_comm_s=exposed_s,
            predicted_step_time_s=max(compute_s, stream_s) + exposed_s,
            assumed_rel_throughput=rel,
            config=cfg,
        )
        if self.compile_index is not None:
            try:
                key = self.compile_index.key_for_plan(plan)
                plan.compile_warm = self.compile_index.is_warm(key)
                plan.expected_compile_s = self.compile_index.expected_compile_s(key)
            except Exception:  # the index must never block prediction
                log.debug("compile index consult failed", exc_info=True)
        return plan

    def predict(
        self,
        config: TrainConfig,
        gang: Optional[int] = None,
        model_cfg: Optional[tfm.ModelConfig] = None,
    ) -> PlacementPlan:
        """Cost one explicit layout without enumerating alternatives.

        The benchmark/A-B entry point: same prediction the search ranks
        by, for a config the caller already fixed. ``model_cfg`` overrides
        the zoo lookup (mirrors ``build_train_program``'s escape hatch);
        without it, raises ``ValueError`` with ``no_estimate:<model>``
        for models outside the zoo.
        """
        if model_cfg is None:
            if config.model_name not in tfm.MODEL_CONFIGS:
                with self._lock:
                    self.no_estimate_refusals_total += 1
                raise ValueError(f"no_estimate:{config.model_name}")
            model_cfg = tfm.MODEL_CONFIGS[config.model_name]
        g = gang if gang is not None else gang_size(config, None)
        return self._predict(config, model_cfg, g)

    # -- planning (enumerate + HBM filter + rank) ----------------------------

    def plan(
        self,
        config: TrainConfig,
        *,
        devices: Optional[list[Any]] = None,
        reserved: Optional[dict[int, float]] = None,
        gang: Optional[int] = None,
        n_avail: Optional[int] = None,
        saved_topology: Optional[dict] = None,
        **enum_kw: Any,
    ) -> PlannerResult:
        """Ranked feasible plans for ``config`` against the live fleet.

        ``devices``: eligible fleet devices (``TPUDevice``-shaped: index /
        hbm_free_gb / hbm_total_gb); None degrades the HBM gate to
        capacity-only — missing telemetry must not brick planning.
        ``reserved``: the scheduler's device-index → GiB ledger.
        ``gang``: pin the search to one gang size; default searches every
        admissible size up to the available device count ("best
        available") — predicted-fastest wins, which naturally prefers the
        largest gang unless its layouts are HBM-infeasible.
        ``saved_topology``: the mesh factorization a resume candidate's
        checkpoints were saved under (``tpu_engine_torch.reshard`` manifest).
        Plans the reshard plane cannot bridge to (pipe extent change) are
        marked infeasible with a ``no_topology_compatible_checkpoint``
        skip reason; every other plan is priced with
        ``predicted_reshard_s`` and ranking prefers a same-topology
        resume within ``prefer_same_topology_max_slowdown_pct`` of the
        fastest — the remap only wins on a real step-time edge.
        """
        t_search0 = time.time()
        if config.model_name not in tfm.MODEL_CONFIGS:
            with self._lock:
                self.no_estimate_refusals_total += 1
            return PlannerResult(
                plans=[], infeasible=[], pruned=[], evaluated=0,
                skip_reason=f"no_estimate:{config.model_name}",
            )
        if n_avail is None:
            n_avail = len(devices) if devices is not None else None
        if n_avail is None:
            n_avail = visible_device_count()
        gangs = [gang] if gang else self._candidate_gangs(n_avail)

        reserved = reserved or {}
        feasible: list[PlacementPlan] = []
        infeasible: list[PlacementPlan] = []
        pruned: list[dict[str, str]] = []
        evaluated = 0
        for g in gangs:
            plans, dropped = self.enumerate(config, g, **enum_kw)
            pruned.extend(dropped)
            evaluated += len(plans) + len(dropped)
            for p in plans:
                est = None
                try:
                    est = self.estimate_fn(p.config, g)
                except Exception:  # estimator must never block planning
                    est = None
                p.hbm_estimate = est
                ok, reason = self._hbm_feasible(est, g, devices, reserved)
                if ok and saved_topology is not None:
                    ok, reason = self._annotate_reshard(p, saved_topology)
                p.feasible = ok
                p.skip_reason = reason
                (feasible if ok else infeasible).append(p)
        # Normalize by samples/step: within one gang every plan carries the
        # same global batch (so this is exactly predicted step time), but
        # across gangs an elastic data=-1 job scales its batch with the
        # devices — raw step time would crown a 1-chip gang that simply
        # does less work. Per-sample time is the throughput-fair order.
        def _per_sample(p: PlacementPlan) -> float:
            samples = (
                p.mesh["data"] * p.mesh["fsdp"]
                * p.micro_batch_size * p.gradient_accumulation_steps
            )
            return p.predicted_step_time_s / samples

        # Warm-first band: with a compile index attached, any WARM layout
        # predicted within ``prefer_warm_max_slowdown_pct`` of the fastest
        # feasible plan outranks every cold one — admission then pays zero
        # compile instead of the cold EMA. The band bounds the trade: a
        # warm plan more than the knob slower never wins on warmth alone.
        best_ps = min(map(_per_sample, feasible), default=0.0)
        warm_band = best_ps * (1.0 + self.prefer_warm_max_slowdown_pct / 100.0)
        reshard_band = best_ps * (
            1.0 + self.prefer_same_topology_max_slowdown_pct / 100.0
        )

        # Same-topology band (only bites with ``saved_topology``): a plan
        # resuming without a remap and predicted within the band of the
        # fastest outranks every topology-changing plan — mirroring the
        # warm-first band, because both costs are one-time admission taxes
        # a small step-time edge never amortizes.
        def _reshard_rank(p: PlacementPlan) -> int:
            if p.reshard_same_topology is None:
                return 0  # no resume topology: the term is inert
            return 0 if (
                p.reshard_same_topology and _per_sample(p) <= reshard_band
            ) else 1

        # Tiebreak equal predicted throughput by expected one-time
        # admission cost (compile when cold + reshard when topology
        # changes), then projected HBM: when two layouts cost the same
        # (fully-overlapped comm makes e.g. fsdp16 and data2xfsdp8
        # identical), the cheaper-to-enter one resumes faster and the one
        # with more headroom is strictly safer to admit.
        feasible.sort(key=lambda p: (
            0 if (p.compile_warm and _per_sample(p) <= warm_band) else 1,
            _reshard_rank(p),
            _per_sample(p),
            p.expected_compile_s + p.predicted_reshard_s,
            p.hbm_estimate.device_total_gib if p.hbm_estimate else float("inf"),
            -p.gang,
        ))
        warm_tiebreak = bool(
            feasible
            and feasible[0].compile_warm
            and _per_sample(feasible[0]) > best_ps
        )
        reshard_tiebreak = bool(
            feasible
            and feasible[0].reshard_same_topology
            and _per_sample(feasible[0]) > best_ps
        )
        with self._lock:
            self.plans_hbm_rejected_total += len(infeasible)
            self.last_feasible = len(feasible)
            if warm_tiebreak:
                self.warm_tiebreaks_total += 1
            if reshard_tiebreak:
                self.reshard_tiebreaks_total += 1
        return PlannerResult(
            plans=feasible, infeasible=infeasible, pruned=pruned,
            evaluated=evaluated, search_s=time.time() - t_search0,
        )

    def _candidate_gangs(self, n_avail: int) -> list[int]:
        """Gang sizes worth searching, largest first. Exhaustive up to
        ``max_gang_enumeration`` devices; beyond that, the full fleet plus
        powers of two (the shapes real slices come in)."""
        if n_avail <= 0:
            return []
        if n_avail <= self.max_gang_enumeration:
            return list(range(n_avail, 0, -1))
        sizes = {n_avail}
        p = 1
        while p <= n_avail:
            sizes.add(p)
            p *= 2
        return sorted(sizes, reverse=True)

    def _annotate_reshard(
        self, p: PlacementPlan, saved_topology: dict
    ) -> tuple[bool, Optional[str]]:
        """Price resuming saved checkpoints onto this plan's mesh.

        Same-topology → zero remap; a bridgeable change → the reshard
        cost model over the model's params+optimizer bytes; a pipe
        extent change → infeasible with the structured skip reason the
        scheduler surfaces verbatim."""
        from tpu_engine_torch import reshard

        ok, why = reshard.topology_compatible(saved_topology, p.mesh)
        if not ok:
            with self._lock:
                self.topology_rejected_total += 1
            return False, f"no_topology_compatible_checkpoint: {why}"
        p.reshard_same_topology = reshard.same_topology(saved_topology, p.mesh)
        if not p.reshard_same_topology:
            state_bytes = reshard.state_bytes_for_model(
                p.config.model_name if p.config is not None else ""
            )
            p.predicted_reshard_s = reshard.reshard_cost_s(state_bytes or 0)
        return True, None

    def _hbm_feasible(
        self,
        est: Optional[HBMEstimate],
        gang: int,
        devices: Optional[list[Any]],
        reserved: dict[int, float],
    ) -> tuple[bool, Optional[str]]:
        """Mirror of the scheduler's admission HBM gate: enough devices
        with ``free - reserved >= need``, where ``need`` carries the
        ``hbm_margin_frac`` surcharge for temporaries the analytic
        estimate cannot see. Capacity-only (always feasible) when there is
        no fleet view or no HBM telemetry."""
        if devices is None or not devices:
            return True, None
        if len(devices) < gang:
            return False, f"gang {gang} > {len(devices)} eligible chip(s)"
        if est is None or not all(
            getattr(d, "hbm_total_gb", 0) > 0 for d in devices
        ):
            return True, None
        need = est.device_total_gib * (1.0 + self.hbm_margin_frac)
        fits = sum(
            1 for d in devices
            if d.hbm_free_gb - reserved.get(d.index, 0.0) >= need
        )
        if fits < gang:
            return False, (
                f"needs {need:.2f} GiB/device (est + "
                f"{self.hbm_margin_frac:.0%} margin) on {gang} chip(s); "
                f"only {fits} have that headroom"
            )
        return True, None

    # -- grow-back support ---------------------------------------------------

    def grow_target(
        self,
        config: TrainConfig,
        devices: list[Any],
        reserved: dict[int, float],
        current_gang: int,
        estimate_fn: Optional[Callable[..., Optional[HBMEstimate]]] = None,
    ) -> Optional[int]:
        """Largest gang (> ``current_gang``) a shrunk job could grow to on
        ``devices`` — the full configured gang when it fits, else the
        largest *intermediate* mesh from the elastic family, HBM-gated
        against per-device headroom minus ``reserved`` (the caller drops
        the job's own reservation first). None → stay at the current size.
        """
        from tpu_engine_torch.hbm_estimate import elastic_shrink_plan

        est_fn = estimate_fn or self.estimate_fn
        n = len(devices)
        full = gang_size(config, n)
        if current_gang < full <= n:
            try:
                est = est_fn(config, full)
            except Exception:
                est = None
            if self._hbm_feasible(est, full, devices, reserved)[0]:
                return full
        probe = n
        while probe > current_gang:
            try:
                shrink = elastic_shrink_plan(config, probe, est_fn)
            except Exception:
                return None
            if shrink is None:
                return None
            _, n_use, est = shrink
            if n_use <= current_gang:
                return None
            if self._hbm_feasible(est, n_use, devices, reserved)[0]:
                return n_use
            probe = n_use - 1
        return None

    # -- telemetry -----------------------------------------------------------

    def _account(
        self, evaluated: int, pruned_n: int, reasons: list[str]
    ) -> None:
        with self._lock:
            self.plans_evaluated_total += evaluated
            self.plans_pruned_total += pruned_n
            for r in reasons:
                key = r.split("(")[0].split(":")[0].strip()[:60]
                self.prune_reasons[key] = self.prune_reasons.get(key, 0) + 1

    def note_chosen(self, plan: PlacementPlan) -> None:
        with self._lock:
            self.plans_chosen_total += 1
            self.last_chosen_predicted_s = plan.predicted_step_time_s

    def record_observation(self, predicted_s: float, observed_s: float) -> None:
        """Predicted-vs-observed step time for an admitted auto plan
        (the scheduler calls this at reap with wall seconds / steps)."""
        if predicted_s <= 0 or observed_s <= 0:
            return
        with self._lock:
            self._observations.append((predicted_s, observed_s))
            del self._observations[:-200]
            rel_err = abs(predicted_s - observed_s) / observed_s
            prev = self._calib_ema_rel_error
            a = self.calibration_alpha
            self._calib_ema_rel_error = (
                rel_err if prev is None else (1 - a) * prev + a * rel_err
            )
            self._calib_observations_total += 1
            self._calib_last = (predicted_s, observed_s)
        if self._calibration_path is not None:
            self._persist_calibration()

    # -- calibration sidecar -------------------------------------------------

    CALIBRATION_SIDECAR = "placement_calibration.json"

    def attach_calibration(self, cache_dir: str) -> None:
        """Persist predicted-vs-observed calibration under ``cache_dir``.

        Mirrors the compile-index sidecar: load whatever a previous run
        learned (the EMA survives restarts, fixing the silent loss of
        in-memory-only calibration), then keep the file fresh on every
        ``record_observation``. Attach is idempotent and failure-tolerant.
        """
        path = os.path.join(cache_dir, self.CALIBRATION_SIDECAR)
        self._calibration_path = path
        self._load_calibration()
        self._persist_calibration()

    def _load_calibration(self) -> None:
        path = self._calibration_path
        if path is None or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                raise ValueError(f"sidecar is not a JSON object: {type(doc).__name__}")
        except Exception:
            # Torn/garbage sidecar (crash mid-write) — warn, count, start
            # fresh; calibration rebuilds from live observations.
            with self._lock:
                self.calibration_load_errors_total += 1
            log.warning("placement calibration sidecar unreadable: %s", path)
            return
        try:
            with self._lock:
                ema = doc.get("ema_rel_error")
                if ema is not None and self._calib_ema_rel_error is None:
                    self._calib_ema_rel_error = float(ema)
                self._calib_observations_total += int(
                    doc.get("observations_total", 0)
                )
                last = doc.get("last")
                if self._calib_last is None and isinstance(last, (list, tuple)):
                    if len(last) == 2:
                        self._calib_last = (float(last[0]), float(last[1]))
        except (TypeError, ValueError):
            with self._lock:
                self.calibration_load_errors_total += 1
            log.warning("placement calibration sidecar malformed: %s", path)

    def _persist_calibration(self) -> None:
        path = self._calibration_path
        if path is None:
            return
        with self._lock:
            doc = {
                "version": 1,
                "ema_rel_error": self._calib_ema_rel_error,
                "alpha": self.calibration_alpha,
                "observations_total": self._calib_observations_total,
                "last": list(self._calib_last) if self._calib_last else None,
            }
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)  # atomic on POSIX: readers never see a torn file
        except OSError:
            with self._lock:
                self.calibration_persist_errors_total += 1
            log.warning("placement calibration persist failed: %s", path)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            obs = list(self._observations)
            top_reasons = dict(
                sorted(self.prune_reasons.items(), key=lambda kv: -kv[1])[:8]
            )
            out = {
                "plans_evaluated_total": self.plans_evaluated_total,
                "plans_pruned_total": self.plans_pruned_total,
                "plans_hbm_rejected_total": self.plans_hbm_rejected_total,
                "plans_chosen_total": self.plans_chosen_total,
                "no_estimate_refusals_total": self.no_estimate_refusals_total,
                "warm_tiebreaks_total": self.warm_tiebreaks_total,
                "topology_rejected_total": self.topology_rejected_total,
                "reshard_tiebreaks_total": self.reshard_tiebreaks_total,
                "compile_index_attached": self.compile_index is not None,
                "prefer_warm_max_slowdown_pct": self.prefer_warm_max_slowdown_pct,
                "last_feasible": self.last_feasible,
                "last_chosen_predicted_s": self.last_chosen_predicted_s,
                "prune_reasons": top_reasons,
                "observations_total": len(obs),
                "throughput_fn_attached": self.throughput_fn is not None,
                "calibration": {
                    "attached": self._calibration_path is not None,
                    "path": self._calibration_path,
                    "ema_rel_error": self._calib_ema_rel_error,
                    "observations_total": self._calib_observations_total,
                    "persist_errors_total": self.calibration_persist_errors_total,
                    "load_errors_total": self.calibration_load_errors_total,
                },
            }
        if obs:
            errs = [abs(p - o) / o for p, o in obs]
            out["step_time_abs_rel_error"] = sum(errs) / len(errs)
            out["last_predicted_s"], out["last_observed_s"] = obs[-1]
        else:
            out["step_time_abs_rel_error"] = None
        return out


# ---------------------------------------------------------------------------
# Serving-pool planning (disaggregated prefill/decode pools)
# ---------------------------------------------------------------------------


class ServingPoolPlan(BaseModel):
    """One candidate layout for a disaggregated serving pool, with the
    role-specific cost-model verdict. Prefill pools rank by the compute
    roofline (per-request prefill latency at ``max_len``); decode pools by
    aggregate KV-pool decode throughput (slots served per HBM-bound step,
    summed over replicas)."""

    model_config = ConfigDict(arbitrary_types_allowed=True)

    role: str  # "prefill" | "decode" | "draft"
    tensor_parallel: int
    replicas: int
    max_slots: int
    max_len: int
    kv_quant: bool = False
    weight_quant: Optional[str] = None
    predicted_prefill_s: float = 0.0  # one max_len prompt through one replica
    predicted_decode_tok_s: float = 0.0  # pool-aggregate steady-state tokens/s
    predicted_propose_s: float = 0.0  # gamma sequential draft steps (draft role)
    hbm_estimate: Optional[HBMEstimate] = None
    feasible: bool = True
    skip_reason: Optional[str] = None

    @property
    def label(self) -> str:
        tags = []
        if self.kv_quant:
            tags.append("kvq")
        if self.weight_quant:
            tags.append(self.weight_quant)
        return "·".join(
            [f"{self.role}", f"tp{self.tensor_parallel}x{self.replicas}",
             f"slots{self.max_slots}", *tags]
        )


# HBM stream bandwidth closes the decode roofline the same way
# NOMINAL_PEAK_FLOPS closes the prefill one: NVIDIA's data-sheet HBM3 rate
# of the H100 SXM5 80GB (700 W); ranking depends only on the ratios.
NOMINAL_HBM_BYTES_S = 3.35e12


def plan_serving_pool(
    model_name: str,
    role: str,
    n_devices: int,
    *,
    hbm_free_gib: float = 16.0,
    max_len: int = 1024,
    candidate_slots: Sequence[int] = (4, 8, 16, 32),
    inflight_handoffs: int = 4,
    compute_dtype: Precision = Precision.BF16,
    kv_quant: bool = False,
    weight_quant: Optional[str] = None,
    prefill_chunk: int = 256,
    spec_gamma: int = 4,
) -> list[ServingPoolPlan]:
    """Enumerate → HBM-filter → rank layouts for ONE disaggregated serving
    pool over ``n_devices`` chips. The same enumerate/filter/rank recipe as
    the training planner, with the serving cost model:

    - every ``tensor_parallel`` that divides ``n_devices`` (and the model's
      kv/q heads), each yielding ``n_devices // tp`` replicas;
    - per-device HBM through :func:`estimate_serving_hbm` with the pool's
      ``pool_role`` — the SAME admission gate the scheduler enforces, so a
      plan this function ranks first is a plan the ledger will admit;
    - **prefill** rank: roofline latency of one ``max_len`` prompt,
      ``2·P·T / (tp·peak·MFU)`` plus per-chunk dispatch overhead — more
      tensor parallelism is better until chunk dispatch dominates; slots
      are pinned to ``inflight_handoffs`` (the pool's only job is holding
      finished requests for extraction);
    - **decode** rank: aggregate tokens/sec with every slot busy — each
      step streams the weight shard once for the whole batch plus one
      resident KV row per slot, so bigger pools amortize the weight read
      until the KV term (or HBM) bites. This is exactly the
      "decode ranked by KV-pool capacity" axis;
    - **draft** rank (the speculative pool): latency of one
      draft-propose leg — ``spec_gamma`` *sequential* memory-bound decode
      steps, each streaming the draft weight shard + resident KV rows.
      Tie-break toward SMALLER tensor parallelism: draft pools exist to
      backfill the fragmented single-chip headroom the verify pools leave
      behind, and callers express that by passing the fragmented
      ``hbm_free_gib`` as the filter. Slots come from ``candidate_slots``
      like decode.

    Returns ALL candidates, feasible first in rank order (infeasible tail
    carries ``skip_reason``) — callers record ``plans[0].label`` as the
    planner-chosen layout. Empty list for unknown models.
    """
    from tpu_engine_torch.hbm_estimate import estimate_serving_hbm

    if role not in ("prefill", "decode", "draft"):
        raise ValueError(f"role must be prefill|decode|draft, got {role!r}")
    model_cfg = tfm.MODEL_CONFIGS.get(model_name)
    if model_cfg is None:
        return []

    n_devices = max(int(n_devices), 1)
    n_params = tfm.param_count(model_cfg)
    compute_b = 1.02 if weight_quant == "int8" else (
        2 if compute_dtype != Precision.FP32 else 4)
    kv_row_bytes = (  # one token's K+V across all layers, as stored
        2 * model_cfg.n_layers * model_cfg.n_kv_heads * model_cfg.head_dim
        * (1 if kv_quant else (2 if compute_dtype != Precision.FP32 else 4))
    )

    plans: list[ServingPoolPlan] = []
    slot_choices = (
        [max(int(inflight_handoffs), 1)] if role == "prefill"
        else sorted({max(int(s), 1) for s in candidate_slots})
    )
    for tp in _divisors(n_devices):
        if model_cfg.n_heads % tp or model_cfg.n_kv_heads % tp:
            continue  # serving.py would replicate heads — not a real layout
        replicas = n_devices // tp
        for slots in slot_choices:
            est = estimate_serving_hbm(
                model_name, slots, max_len,
                tensor_parallel=tp, compute_dtype=compute_dtype,
                kv_quant=kv_quant, weight_quant=weight_quant,
                prefill_chunk=prefill_chunk, pool_role=role,
                inflight_handoffs=(
                    inflight_handoffs if role == "prefill" else None),
            )
            # Prefill: compute roofline over the tp shard + one dispatch
            # latency per chunk (why tp→∞ is not free).
            n_chunks = -(-int(max_len) // max(int(prefill_chunk), 1))
            prefill_s = (
                2.0 * n_params * max_len
                / (tp * NOMINAL_PEAK_FLOPS * ASSUMED_MFU)
                + n_chunks * 2e-3
            )
            # Decode: per step, stream the weight shard once + every
            # resident KV row (half-full on average); all slots emit one
            # token per step, replicas are independent.
            kv_shard = tp if model_cfg.n_kv_heads % tp == 0 else 1
            step_bytes = (
                n_params * compute_b / tp
                + slots * (max_len / 2) * kv_row_bytes / kv_shard
            )
            tok_s = replicas * slots / (step_bytes / NOMINAL_HBM_BYTES_S)
            # Draft: one propose leg = spec_gamma SEQUENTIAL decode steps
            # (all slots share each step's weight stream, so the leg's
            # latency is per-step time, not per-token).
            propose_s = max(int(spec_gamma), 1) * step_bytes / NOMINAL_HBM_BYTES_S
            plan = ServingPoolPlan(
                role=role, tensor_parallel=tp, replicas=replicas,
                max_slots=slots, max_len=int(max_len), kv_quant=kv_quant,
                weight_quant=weight_quant,
                predicted_prefill_s=prefill_s,
                predicted_decode_tok_s=tok_s,
                predicted_propose_s=propose_s,
                hbm_estimate=est,
            )
            if est is not None and est.device_total_gib > hbm_free_gib:
                plan.feasible = False
                plan.skip_reason = (
                    f"needs {est.device_total_gib:.2f} GiB/device, "
                    f"{hbm_free_gib:.2f} free"
                )
            plans.append(plan)

    def rank_key(p: ServingPoolPlan) -> tuple:
        if role == "prefill":
            # Fastest single-prompt prefill; tie-break toward more
            # parallel lanes (replicas) for burst absorption.
            return (p.predicted_prefill_s, -p.replicas, p.tensor_parallel)
        if role == "draft":
            # Fastest propose leg; tie-break toward SMALLER tp — draft
            # pools backfill fragmented single-chip headroom.
            return (p.predicted_propose_s, p.tensor_parallel, -p.max_slots)
        return (-p.predicted_decode_tok_s, p.tensor_parallel, -p.max_slots)

    feasible = sorted([p for p in plans if p.feasible], key=rank_key)
    infeasible = sorted([p for p in plans if not p.feasible], key=rank_key)
    return feasible + infeasible
