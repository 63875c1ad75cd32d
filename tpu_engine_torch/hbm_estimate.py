"""Per-device HBM footprint estimation for jobs — the admission-control math
(port of ``tpu_engine/hbm_estimate.py``).

Two measurement planes:

1. :func:`per_device_bytes` — **exact** state accounting from a built
   program's state: each rank's tensors are the shards it keeps (ZeRO's
   shards over ``fsdp``, its block of the ``model`` split, its stage's
   leaves over ``pipe``), and a tensor placed in host memory (a
   ``HostArena``'s, ``optimizer_offload``/``param_offload="host"``) counts
   on the host side. Needs ``build_train_program`` and ``init``.

2. :func:`estimate_job_hbm` — **analytic** projection straight from a
   :class:`~tpu_engine_torch.train.TrainConfig`: params / grads / optimizer
   state / activations / logits per device from ``param_count`` and the
   sharding semantics alone. No build, microseconds, safe to call on a
   scheduler tick. Deliberately a slight over-estimate (workspace terms are
   rounded up) — an admission gate must err toward "does not fit".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from pydantic import BaseModel, Field

from tpu_engine_torch.sharding import (
    OffloadDevice,
    Precision,
    ShardingStage,
    dtype_of,
    resolve_pipeline_schedule,
)

_GIB = 2**30


def _itemsize(p: Precision) -> int:
    return torch.empty((), dtype=dtype_of(p)).element_size()


def _value(x: Any) -> Any:
    """An enum member's value, a plain string as it is."""
    return getattr(x, "value", x)


class HostBudgetExceeded(ValueError):
    """A serving host-RAM KV tier was promised more prefix tokens than its
    budget holds. Structured so admission callers (the prefix plane, the
    scheduler) can surface the rejection without parsing the message."""

    def __init__(self, model_name: str, host_prefix_tokens: int,
                 required_gib: float, budget_gib: float):
        self.model_name = model_name
        self.host_prefix_tokens = int(host_prefix_tokens)
        self.required_gib = round(float(required_gib), 4)
        self.budget_gib = round(float(budget_gib), 4)
        self.reason = {
            "kind": "host_budget_exceeded",
            "model_name": self.model_name,
            "host_prefix_tokens": self.host_prefix_tokens,
            "required_gib": self.required_gib,
            "budget_gib": self.budget_gib,
        }
        super().__init__(
            f"host KV tier for {model_name}: {host_prefix_tokens} prefix "
            f"tokens need {self.required_gib} GiB host RAM but the budget "
            f"is {self.budget_gib} GiB"
        )


class SpecHBMOversubscribed(ValueError):
    """A speculative replica (target + colocated draft weights and draft KV
    pool) was asked to fit in less device HBM than the projection needs.
    Structured so the spec-pool placement plane can surface the rejection
    without parsing the message — same shape as :class:`HostBudgetExceeded`."""

    def __init__(self, model_name: str, draft_model_name: str,
                 required_gib: float, budget_gib: float, draft_gib: float):
        self.model_name = model_name
        self.draft_model_name = draft_model_name
        self.required_gib = round(float(required_gib), 4)
        self.budget_gib = round(float(budget_gib), 4)
        self.draft_gib = round(float(draft_gib), 4)
        self.reason = {
            "kind": "spec_hbm_oversubscribed",
            "model_name": self.model_name,
            "draft_model_name": self.draft_model_name,
            "required_gib": self.required_gib,
            "budget_gib": self.budget_gib,
            "draft_gib": self.draft_gib,
        }
        super().__init__(
            f"speculative replica {model_name}+{draft_model_name}: needs "
            f"{self.required_gib} GiB/device ({self.draft_gib} GiB of it "
            f"draft weights + draft KV) but the budget is "
            f"{self.budget_gib} GiB"
        )


# ---------------------------------------------------------------------------
# Exact plane: state accounting from a built program (ex benchmarks/
# hbm_projection.run_table — the benchmark now imports this).
# ---------------------------------------------------------------------------


def _on_host(t: torch.Tensor) -> bool:
    """Whether ``t`` lives in host memory: a host arena's (pinned on a
    card) or any CPU tensor of a program whose device is a card."""
    return hasattr(t, "_host_arena") or t.device.type == "cpu"


def per_device_bytes(tree: Any, host: bool, device: Any = None) -> int:
    """This rank's bytes of one state subtree (``state["params"]``,
    ``state["opt_state"]``), exact: the tensors a rank holds are its shards.
    ``host`` selects the host-resident or the device-resident part; on a
    CPU program (``device`` of type cpu) every tensor is the device's."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    total = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, torch.Tensor):
            placed = hasattr(node, "_host_arena") if on_cpu else _on_host(node)
            if placed == host:
                total += node.numel() * node.element_size()
    return total


# ---------------------------------------------------------------------------
# Analytic plane: projection from the config alone.
# ---------------------------------------------------------------------------


class HBMEstimate(BaseModel):
    """Per-device footprint projection for one training job."""

    model_name: str
    gang_devices: int  # devices the job's mesh occupies
    params_gib: float  # master params resident on device
    grads_gib: float
    opt_gib: float  # optimizer state resident on device
    working_gib: float  # compute-dtype copies / gather buffers
    activations_gib: float  # saved activations + one layer's workspace
    logits_gib: float  # fp32 loss logits chunk
    device_total_gib: float  # sum of the device-resident terms
    host_gib: float  # offloaded (pinned_host / disk-staging) state
    # Serving-only plane: the slot-pool KV cache (max_slots × lanes at the
    # replica's KV dtype). Zero for training jobs — their KV never outlives
    # a forward pass, so it rides the activations term.
    kv_pool_gib: float = 0.0
    notes: list[str] = Field(default_factory=list)


def gang_size(config: Any, available: Optional[int] = None) -> int:
    """Devices a config's mesh occupies.

    Explicit axes multiply out directly; ``data=-1`` absorbs devices, so it
    resolves against ``available`` (largest multiple of the fixed axes that
    fits, minimum one block). With no ``available`` hint a ``-1`` data axis
    counts as 1 block — the smallest gang the job can legally run on.
    """
    m = config.mesh
    fixed = m.fsdp * m.pipe * m.sequence * m.model
    if m.data != -1:
        return m.data * fixed
    if available is None or available < fixed:
        return fixed
    return (available // fixed) * fixed


def elastic_shrink_plan(
    config: Any,
    n_eligible: int,
    estimate_fn: Any = None,
) -> Optional[tuple[Any, int, Optional[HBMEstimate]]]:
    """Largest elastic mesh admissible on ``n_eligible`` healthy chips.

    The scheduler's elastic-shrink admission path: when a job's configured
    gang exceeds the healthy fleet but the job declared elastic bounds,
    admit it shrunk instead of skipping it (Poplar's keep-goodput-on-a-
    degraded-fleet stance, arXiv:2408.12596). Returns
    ``(mesh, n_devices, estimate)`` — the derived explicit mesh, the gang it
    occupies, and the HBM projection *at that shrunken shape* (None when the
    model is unknown) — or None when the config is not elastic or no mesh
    within its bounds fits.
    """
    if not (config.elastic_resume and config.elastic_min_devices is not None):
        return None
    from tpu_engine_torch.mesh_runtime import derive_elastic_mesh

    try:
        mesh = derive_elastic_mesh(
            config.mesh, n_eligible, config.elastic_min_devices, config.elastic_max_devices
        )
    except ValueError:
        return None
    n_use = mesh.data * mesh.fsdp * mesh.pipe * mesh.sequence * mesh.model
    if n_use > n_eligible:
        return None
    est: Optional[HBMEstimate] = None
    try:
        fn = estimate_fn if estimate_fn is not None else estimate_job_hbm
        est = fn(dataclasses.replace(config, mesh=mesh), n_use)
    except Exception:  # estimator must never block admission
        est = None
    return mesh, n_use, est


def estimate_job_hbm(
    config: Any, available_devices: Optional[int] = None, model_cfg: Any = None,
) -> Optional[HBMEstimate]:
    """Analytic per-device HBM projection for a queued job.

    Returns None for unknown model names (nothing honest to project).
    ``model_cfg`` prices another config than the catalog's entry of
    ``config.model_name`` (a model cut in depth). The terms mirror the
    sharding semantics in ``tpu_engine_torch/sharding.py``:
    params shard over fsdp at stage>=3, grads at stage>=2, optimizer state
    at stage>=1; tensor/pipe axes divide all weight-shaped state; the
    sequence axis divides activations. LoRA jobs train adapter-sized
    grads/optimizer state over a frozen compute-dtype base.
    """
    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.models.config import MODEL_CONFIGS

    if model_cfg is None:
        model_cfg = MODEL_CONFIGS.get(config.model_name)
    if model_cfg is None:
        return None

    gang = gang_size(config, available_devices)
    m = config.mesh
    tp_pp = m.model * m.pipe  # axes that divide every weight-shaped tensor
    stage = config.sharding_stage
    notes: list[str] = []

    n_params = tfm.param_count(model_cfg)
    master_b = _itemsize(config.param_dtype)
    compute_b = _itemsize(config.precision)

    lora = config.lora_rank is not None
    if lora:
        # Adapters on the targeted projections: rank x (in + out) each.
        d, hd = model_cfg.d_model, model_cfg.head_dim
        out_dims = {
            "q": model_cfg.n_heads * hd, "k": model_cfg.n_kv_heads * hd,
            "v": model_cfg.n_kv_heads * hd, "o": d,
        }
        n_train = sum(
            config.lora_rank * (d + out_dims.get(t, d))
            for t in config.lora_targets
        ) * model_cfg.n_layers
        notes.append("lora: frozen base in compute dtype, adapter-sized grads/opt")
    else:
        n_train = n_params

    params_shard = tp_pp * (m.fsdp if stage >= ShardingStage.FULL_PARTITIONING else 1)
    grads_shard = tp_pp * (
        m.fsdp if stage >= ShardingStage.GRADIENT_PARTITIONING else 1
    )
    opt_shard = tp_pp * (m.fsdp if stage >= ShardingStage.OPTIMIZER_STATE else 1)

    host_bytes = 0.0
    params_dev = n_params * (compute_b if lora else master_b) / params_shard
    if not lora and config.param_offload != OffloadDevice.NONE:
        host_bytes += params_dev
        params_dev = 0.0
        notes.append(f"params offloaded to {_value(config.param_offload)}")

    grads_dev = n_train * master_b / grads_shard

    # Optimizer state multiplier in master-dtype units.
    mu_b = _itemsize(config.moment_dtype) if config.moment_dtype else master_b
    if config.optimizer == "adamw":
        opt_bytes_per_param = mu_b + master_b  # mu + nu
    elif config.optimizer == "lion":
        opt_bytes_per_param = mu_b
    else:  # adafactor: factored second moments, O(in+out) per kernel
        opt_bytes_per_param = 0.05 * master_b
        notes.append("adafactor: factored moments approximated at 5%")
    opt_dev = n_train * opt_bytes_per_param / opt_shard
    if config.optimizer_offload != OffloadDevice.NONE:
        host_bytes += opt_dev
        opt_dev = 0.0
        notes.append(f"optimizer state offloaded to {_value(config.optimizer_offload)}")

    # Working set: compute-dtype weights. Stage-3 gathers materialise ~2
    # layers at a time (current + prefetched); otherwise a full cast copy
    # exists whenever compute != master dtype.
    per_layer = n_params / max(model_cfg.n_layers, 1)
    if stage >= ShardingStage.FULL_PARTITIONING and not lora:
        working_dev = 2 * per_layer * compute_b / m.model
    elif config.precision != config.param_dtype and not lora:
        working_dev = n_params * compute_b / tp_pp
    else:
        working_dev = 0.0

    # Activations: one microbatch lives at a time (accumulation is
    # sequential). The batch dim is per data-parallel shard already; the
    # sequence axis divides S.
    bsz = config.micro_batch_size
    seq = config.seq_len / m.sequence
    d_model, d_ff = model_cfg.d_model, model_cfg.d_ff
    layers_per_stage = max(model_cfg.n_layers / m.pipe, 1)
    layer_ws = bsz * seq * (4 * d_model + 2 * d_ff) / m.model * compute_b
    if config.activation_checkpointing:
        # Saved boundaries (B,S,D per layer) + one layer's live workspace.
        act_dev = bsz * seq * d_model * layers_per_stage * compute_b + layer_ws
    else:
        act_dev = layer_ws * layers_per_stage

    # Pipelined jobs additionally hold stage boundary buffers whose count
    # is set by the SCHEDULE, not the model: GPipe-by-autodiff saves one
    # [B,S,D] carry per forward tick — O(M + P) buffers — while the
    # manual-vjp schedules (1f1b/zb) bound residency at the 2(P-1)+1-slot
    # ring plus the two lane buffers, O(P) independent of the microbatch
    # count (zb adds its P-1-entry deferred-W cotangent stash). Ignoring
    # this term (the pre-schedule-aware behaviour) under-charges GPipe at
    # large M and — worse for utilisation — makes 1F1B/ZB gangs look as
    # expensive as GPipe, so the admission gate over-rejects jobs that fit.
    if m.pipe > 1:
        sched = resolve_pipeline_schedule(config)
        M = config.gradient_accumulation_steps
        boundary = bsz * seq * d_model * compute_b
        if sched == "gpipe":
            n_bufs = M + m.pipe - 1
        else:
            n_bufs = (2 * (m.pipe - 1) + 1) + 2  # ring + fwd/bwd lane bufs
            if sched == "zb":
                n_bufs += m.pipe - 1  # deferred-W stash
        act_dev += n_bufs * boundary
        notes.append(
            f"pipeline schedule {sched}: {n_bufs} stage boundary "
            f"buffers/device ({'O(M+P)' if sched == 'gpipe' else 'O(P)'})"
        )

    # fp32 logits for the loss: the [B, S_chunk, V] tensor (often dominant
    # for small models / large vocabs); chunked loss bounds S_chunk.
    s_chunk = min(seq, config.loss_chunk_size or seq)
    logits_dev = bsz * s_chunk * model_cfg.vocab_size * 4 / m.model

    total = params_dev + grads_dev + opt_dev + working_dev + act_dev + logits_dev
    return HBMEstimate(
        model_name=config.model_name,
        gang_devices=gang,
        params_gib=round(params_dev / _GIB, 4),
        grads_gib=round(grads_dev / _GIB, 4),
        opt_gib=round(opt_dev / _GIB, 4),
        working_gib=round(working_dev / _GIB, 4),
        activations_gib=round(act_dev / _GIB, 4),
        logits_gib=round(logits_dev / _GIB, 4),
        device_total_gib=round(total / _GIB, 4),
        host_gib=round(host_bytes / _GIB, 4),
        notes=notes,
    )


# ---------------------------------------------------------------------------
# Serving plane: KV-pool projection for a decode replica.
# ---------------------------------------------------------------------------


def estimate_serving_hbm(
    model_name: str,
    max_slots: int,
    max_len: int,
    *,
    tensor_parallel: int = 1,
    compute_dtype: Precision = Precision.BF16,
    kv_quant: bool = False,
    weight_quant: Optional[str] = None,
    prefill_chunk: int = 256,
    prefix_cache_tokens: int = 0,
    pool_role: str = "unified",
    inflight_handoffs: Optional[int] = None,
    host_prefix_tokens: int = 0,
    host_budget_gib: Optional[float] = None,
    draft_model_name: Optional[str] = None,
    device_budget_gib: Optional[float] = None,
) -> Optional[HBMEstimate]:
    """Per-device HBM projection for one decode replica.

    The training estimator's weight-shaped terms mostly vanish here (no
    grads, no optimizer state, no saved activations); what dominates instead
    is the **KV pool** — ``max_slots`` fully-committed slots of
    ``ring_lanes(max_len)`` each, the cost the training plane never pays and
    the reason serving admission needs its own estimate. Mirrors the actual
    allocation in ``tpu_engine/serving.py``:

    - params at the serving dtype, or int8 codes + per-channel fp32 scales
      when the replica loads a ``quant.py`` snapshot (``weight_quant="int8"``),
      divided over the ``model`` (tensor-parallel) axis;
    - K and V per layer: ``[slots, lanes, n_kv_heads, head_dim]`` at the
      compute dtype, or int8 codes plus per-(lane, kv-head) fp32 scales when
      ``kv_quant`` — the exact layout ``init_slot_cache`` builds, kv-heads
      sharded over the model axis when divisible;
    - the shared-prefix cache's budgeted lanes, plus a rounded-up decode /
      prefill workspace (one chunk's activations and the fp32 logits rows).

    ``pool_role`` selects the disaggregated-serving admission mode
    (``tpu_engine/disagg.py``): a ``"prefill"`` pool's slots exist only to
    hold requests between prefill completion and KV extraction, so its KV
    term is sized to ``inflight_handoffs`` slots (not the full
    ``max_slots``) and its prefill workspace is doubled (the chunk forward
    is the pool's steady-state occupant, not an admission transient).
    ``"decode"`` estimates like ``"unified"`` — the full slot pool is the
    honest cost either way.

    ``host_prefix_tokens`` is the fleet prefix plane's host-RAM KV tier
    (``tpu_engine/prefix_plane.py``): prefix entries parked in host memory
    as int8 ``KVHandoff`` payloads (codes + per-(layer, token, kv-head)
    fp32 scales, always int8 — the tier quantizes on store), unsharded
    (host RAM is per-host, not per-chip). It lands in ``host_gib``, not
    the device total. When ``host_budget_gib`` is given the projection is
    checked against it and an oversubscribed tier raises
    :class:`HostBudgetExceeded` with a structured reason — the plane can
    never promise KV the host cannot hold.

    ``pool_role="draft"`` estimates like ``"unified"`` (a draft pool's
    replicas are ordinary decode pools, just tiny — the role exists so the
    spec-pool planner can rank/backfill them separately). Independently,
    ``draft_model_name`` sizes a **speculative** replica: the target model
    plus a colocated draft — draft weights at the compute dtype (unsharded:
    speculative serving is single-chip, ``serving.py`` rejects ``mesh=``)
    and a second full-slot KV pool at the draft's geometry, exactly what
    ``ContinuousBatcher(draft_params=...)`` allocates. When
    ``device_budget_gib`` is given the draft-augmented total is checked
    against it and oversubscription raises :class:`SpecHBMOversubscribed`
    with a structured reason — a draft can never be promised HBM the
    verify pool does not actually have spare.

    Returns None for unknown model names — the scheduler then degrades the
    serving submission to capacity-only admission, same as training.
    """
    from tpu_engine_torch.generate import ring_lanes
    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.models.config import MODEL_CONFIGS

    cfg = MODEL_CONFIGS.get(model_name)
    if cfg is None:
        return None
    if pool_role not in ("unified", "prefill", "decode", "draft"):
        raise ValueError(
            f"pool_role must be unified|prefill|decode|draft, got {pool_role!r}"
        )

    tp = max(int(tensor_parallel), 1)
    slots = max(int(max_slots), 1)
    if pool_role == "prefill":
        # The physical pool allocates min(max_slots, inflight) slots —
        # disagg.py builds prefill engines with max_slots == inflight, so
        # the estimate and the allocation agree.
        slots = min(slots, max(int(inflight_handoffs or slots), 1))
    compute_b = _itemsize(compute_dtype)
    notes: list[str] = []

    n_params = tfm.param_count(cfg)
    if weight_quant == "int8":
        # quant.py stores int8 codes + one fp32 scale per output channel of
        # each kernel (~4/d_model of the kernel's size); 2% rounds that up.
        params_dev = n_params * 1.02 / tp
        notes.append("weights: int8 snapshot (codes + per-channel fp32 scales)")
    else:
        params_dev = n_params * compute_b / tp

    # KV pool: k and v, [L, slots, lanes, KV, HD]; kv-heads shard over the
    # model axis only when divisible (serving.py falls back to replicated).
    lanes = ring_lanes(cfg, int(max_len), int(prefill_chunk))
    kv_shard = tp if cfg.n_kv_heads % tp == 0 else 1
    if kv_shard == 1 and tp > 1:
        notes.append(f"kv pool replicated: {cfg.n_kv_heads} kv-heads !% model={tp}")
    kv_cells = 2 * cfg.n_layers * slots * lanes * cfg.n_kv_heads * cfg.head_dim
    if kv_quant:
        # int8 codes + fp32 scale per (lane, kv-head) row of each of k/v.
        kv_pool = kv_cells * 1 + 2 * cfg.n_layers * slots * lanes * cfg.n_kv_heads * 4
        notes.append("kv pool: int8 codes + per-(lane, kv-head) fp32 scales")
    else:
        kv_pool = kv_cells * compute_b
    kv_pool /= kv_shard
    if prefix_cache_tokens > 0:
        # Shared-prefix entries are extra KV lanes outside the slot pool,
        # bounded by the token budget (eviction enforces it).
        per_tok = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
        per_tok = per_tok * 1 + 2 * cfg.n_layers * cfg.n_kv_heads * 4 if kv_quant \
            else per_tok * compute_b
        kv_pool += prefix_cache_tokens * per_tok / kv_shard

    # Decode/prefill workspace: one prefill chunk's layer activations for
    # the widest dispatch plus every slot's fp32 logits row. A prefill
    # pool runs chunk forwards back-to-back — double-buffer the workspace
    # (current dispatch + the next chunk's staged operands) since it, not
    # the KV pool, is the pool's dominant transient.
    chunk = max(int(prefill_chunk), 1)
    working = chunk * (4 * cfg.d_model + 2 * cfg.d_ff) * compute_b / tp
    if pool_role == "prefill":
        working *= 2
        notes.append(
            f"prefill pool: KV sized to {slots} in-flight handoff slots, "
            "workspace double-buffered"
        )
    logits = slots * cfg.vocab_size * 4 / tp

    draft_bytes = 0.0
    if draft_model_name is not None:
        draft_cfg = MODEL_CONFIGS.get(draft_model_name)
        if draft_cfg is None:
            return None
        # Colocated draft: weights at the compute dtype, unsharded (the
        # speculative engine is single-chip), plus a second full-slot KV
        # pool at the draft's geometry — init_slot_cache(draft_cfg, ...)
        # in ContinuousBatcher, always unquantized.
        draft_lanes = ring_lanes(draft_cfg, int(max_len), int(prefill_chunk))
        draft_kv = (2 * draft_cfg.n_layers * slots * draft_lanes
                    * draft_cfg.n_kv_heads * draft_cfg.head_dim * compute_b)
        draft_bytes = tfm.param_count(draft_cfg) * compute_b + draft_kv
        notes.append(
            f"speculative: draft {draft_model_name} colocated "
            f"({draft_bytes / _GIB:.3f} GiB weights + draft KV, unsharded)"
        )

    host_bytes = 0.0
    if host_prefix_tokens > 0:
        # Host tier stores KVHandoff wire payloads: int8 k/v codes plus one
        # fp32 scale per (layer, token, kv-head) row of each of k/v. Host
        # RAM is per-host — no tensor-parallel division.
        host_per_tok = 2 * cfg.n_layers * cfg.n_kv_heads * (cfg.head_dim + 4)
        host_bytes = float(host_prefix_tokens) * host_per_tok
        notes.append(
            f"host KV tier: {int(host_prefix_tokens)} prefix tokens as int8 "
            "KVHandoff payloads (codes + per-(layer, token, kv-head) fp32 "
            "scales), unsharded host RAM"
        )
        if host_budget_gib is not None and host_bytes > host_budget_gib * _GIB:
            raise HostBudgetExceeded(
                model_name, host_prefix_tokens,
                required_gib=host_bytes / _GIB,
                budget_gib=host_budget_gib,
            )

    total = params_dev + kv_pool + working + logits + draft_bytes
    if device_budget_gib is not None and total > device_budget_gib * _GIB:
        raise SpecHBMOversubscribed(
            model_name, draft_model_name or "<none>",
            required_gib=total / _GIB,
            budget_gib=device_budget_gib,
            draft_gib=draft_bytes / _GIB,
        )
    return HBMEstimate(
        model_name=model_name,
        gang_devices=tp,
        params_gib=round(params_dev / _GIB, 4),
        grads_gib=0.0,
        opt_gib=0.0,
        working_gib=round(working / _GIB, 4),
        activations_gib=0.0,
        logits_gib=round(logits / _GIB, 4),
        device_total_gib=round(total / _GIB, 4),
        host_gib=round(host_bytes / _GIB, 4),
        kv_pool_gib=round(kv_pool / _GIB, 4),
        notes=notes,
    )
