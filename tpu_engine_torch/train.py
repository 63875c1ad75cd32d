"""Single-GPU training program: schedule, optimizers (AdamW, Adafactor,
Lion), loss and the train step (port of the single-device path of
``tpu_engine/train.py``, and of its sequence-parallel path with the ring's
ranks in one process). MoE models train with the router's aux loss in the
objective; ``quant_training="int8"`` runs the targeted products in int8
(``tpu_engine_torch/quant_train.py``); ``lora_rank`` trains LoRA adapters on
a frozen base (``tpu_engine_torch/lora.py``).

The JAX step is one jitted function over a pytree state; here the state is a
dict of tensors and the step runs eagerly. The optimizer updates the master
weights in place (saving the second copy JAX's functional update makes),
and gradients sum in fp32 across the microbatches of a step, as JAX's do
(``offload.GradSums``).

Where the state lives (JAX's ``OffloadDevice``): ``optimizer_offload=
"host"`` keeps the optimizer's tensors and ``param_offload="host"`` the
masters in host memory, streamed through the device
(``tpu_engine_torch/offload.py``); ``optimizer_offload="disk"`` keeps
masters and moments in memory-mapped spill files updated by a host AdamW
(``tpu_engine_torch/disk_offload.py``), the device holding compute-dtype
params only.

On a mesh (``cfg.mesh``, ``cfg.sharding_stage``; a process group joined by
``mesh_runtime.initialize_distributed``) the step is JAX's GSPMD program's
with explicit collectives (``tpu_engine_torch/parallel/zero.py``): ZeRO
stages 0–3 over ``data`` and ``fsdp``, ring or Ulysses attention over
``sequence``, tensor and expert parallelism over ``model``
(``tpu_engine_torch/parallel/tensor_parallel.py``: each rank holds its
heads, MLP columns, experts and vocabulary block; the loss's reductions
run over the vocabulary blocks; LoRA's adapters split with their
projections; Adafactor's factored means reduce over the split dims), and
pipelines over ``pipe``, one rank a stage (GPipe, 1F1B and zero-bubble,
``tpu_engine_torch/parallel/pipeline*.py``). The placements and int8
training run there too: a rank's shards of the state in its host memory,
or spilled under a directory of its own with the attach and reseed
decisions agreed over the world; int8's weight-gradient scales span the
ranks that split the tokens, and a product's scales span the ``model``
ranks where that axis splits the dim it contracts.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, ClassVar, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from tpu_engine_torch import comm_compress
from tpu_engine_torch import disk_offload as dsk
from tpu_engine_torch import lora as lora_mod
from tpu_engine_torch import quant_train, sharding
from tpu_engine_torch.mesh_runtime import TOKEN_AXES, MeshConfig, MeshRuntime
from tpu_engine_torch.offload import GradSums, HostArena, HostParams, UpdateWalk
from tpu_engine_torch.models import transformer as tfm
from tpu_engine_torch.models.config import MODEL_CONFIGS, ModelConfig
from tpu_engine_torch.parallel import pipeline, zero
from tpu_engine_torch.parallel.collectives import all_reduce_
from tpu_engine_torch.parallel.pipeline_1f1b import pipeline_1f1b_grads
from tpu_engine_torch.parallel.pipeline_zb import pipeline_zb_grads
from tpu_engine_torch.parallel.tensor_parallel import model_axis, model_block, vocab_ce_sums

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
_PLACES = ("none", "host", "disk")


class _DefaultFloat(float):
    """A field's default value, told apart from the same value set
    explicitly (JAX reads ``model_fields_set``): Adafactor takes ``beta2``
    as its decay exponent only when it was set."""


_DEFAULT_BETA2 = _DefaultFloat(0.95)


@dataclass
class TrainConfig:
    """The fields of ``TPUTrainConfig`` (``tpu_engine/sharding.py``) with its
    defaults: the single-device ones, the mesh (``mesh``,
    ``sharding_stage``, ``grad_allreduce_dtype``, the ``comm_quant_*``
    compressed collectives), and ``sequence``, the
    ring size of sequence-parallel attention with every rank in this
    process (``mesh.sequence`` is the ring across ranks; setting both
    raises). ``pipeline_schedule`` is JAX's ("auto" resolves by
    ``sharding.resolve_pipeline_schedule``). Values the port does not
    support raise; the combinations JAX refuses raise JAX's messages.
    JAX's XLA flag fields (``async_collectives``,
    ``latency_hiding_scheduler``, ``xla_extra_flags``) have no counterpart:
    the port's collectives are explicit calls. Refused on a mesh, with
    ``NotImplementedError``: a model whose heads, MLP or experts do not
    split over ``model`` (JAX's program refuses that too;
    ``tpu_engine_torch/sharding.py``)."""

    model_name: str = "gpt-125m"
    micro_batch_size: int = 1
    gradient_accumulation_steps: int = 1
    seq_len: int = 2048
    precision: str = "bf16"          # compute dtype
    param_dtype: str = "fp32"        # master weights
    moment_dtype: Optional[str] = None  # Adam mu dtype (None = fp32, as optax holds it)
    lr_schedule: str = "cosine"      # cosine | linear | constant | rsqrt
    learning_rate: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = _DEFAULT_BETA2
    grad_clip_norm: float = 1.0
    optimizer: str = "adamw"         # adamw | adafactor | lion
    decay_all_params: bool = False
    activation_checkpointing: bool = True
    remat_policy: str = "nothing_saveable"  # tfm.REMAT_POLICIES
    loss_chunk_size: Optional[int] = None
    z_loss_coef: float = 0.0
    attention_impl: str = "auto"     # auto | xla | flash | ring | ulysses
    sequence: int = 1                # ring size; > 1 selects ring attention
    # MoE dispatch override (MoE models only): None = the model's own
    # (dense); "dense" = capacity-factor dense dispatch; "ragged" = sorted
    # per-expert products, no token dropped.
    moe_impl: Optional[str] = None
    # int8 quantised training of the targeted product groups.
    quant_training: str = "none"     # none | int8
    quant_train_targets: tuple[str, ...] = ("attn", "mlp", "moe")
    # LoRA: adapters of rank lora_rank on lora_targets; the base is frozen.
    lora_rank: Optional[int] = None
    lora_alpha: float = 16.0
    lora_targets: tuple[str, ...] = ("q", "k", "v", "o")
    # Where the state lives (JAX's OffloadDevice): "none" | "host" | "disk".
    optimizer_offload: str = "none"
    param_offload: str = "none"      # "disk" refused, as in JAX
    # The disk tier's spill directory, and its delayed parameter update
    # (the device computes step N+1 while the host applies step N).
    optimizer_spill_dir: Optional[str] = None
    disk_update_overlap: bool = False
    # None = the model's own window; 0 = full causal; N = window N.
    sliding_window: Optional[int] = None
    seed: int = 0
    # The mesh (JAX's TPUTrainConfig fields): ZeRO stage 0-3 and the axes.
    sharding_stage: int = 3
    mesh: MeshConfig = field(default_factory=MeshConfig)
    grad_allreduce_dtype: Optional[str] = None  # None | "fp32" | the compute dtype
    pipeline_schedule: str = "auto"  # auto | gpipe | 1f1b | zb (pipe > 1)
    # ZeRO++ compressed collectives at stage 3 (tpu_engine_torch/comm_compress.py):
    # qwZ int8 weight gathers, hpZ their secondary int8 store, qgZ int8
    # gradient sums across slices (dcn_data > 1).
    comm_quant_weights: bool = False
    comm_secondary_weights: bool = False
    comm_quant_grads: bool = False
    comm_quant_block_size: int = 256
    # The supervised job's fields (tpu_engine_torch/supervisor.py), JAX's:
    # the LoRA base from an HF directory; elastic resume within declared
    # device and effective-batch bounds; the kernel build directory
    # (tpu_engine_torch/compile_cache.py); checkpoints; the token files of
    # training and eval; the metrics log.
    lora_base_hf_checkpoint: Optional[str] = None
    elastic_resume: bool = True
    elastic_min_devices: Optional[int] = None
    elastic_max_devices: Optional[int] = None
    elastic_min_batch_size: Optional[int] = None
    elastic_max_batch_size: Optional[int] = None
    elastic_target_batch_size: Optional[int] = None
    compilation_cache_dir: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_interval_steps: int = 500
    max_checkpoints_to_keep: int = 3
    dataset_path: Optional[str] = None   # flat binary token file; None = synthetic
    dataset_dtype: str = "uint16"        # uint16 | int32
    eval_interval_steps: Optional[int] = None
    eval_batches: int = 4
    eval_dataset_path: Optional[str] = None
    log_every_steps: int = 100
    metrics_log_path: Optional[str] = None

    def __post_init__(self):
        # Enum-valued fields of the JAX config arrive as str subclasses.
        for name in ("precision", "param_dtype", "moment_dtype", "optimizer_offload",
                     "param_offload", "grad_allreduce_dtype"):
            val = getattr(self, name)
            if val is not None:
                setattr(self, name, getattr(val, "value", val))
        checks = [
            (self.micro_batch_size >= 1, "micro_batch_size must be >= 1"),
            (self.gradient_accumulation_steps >= 1, "gradient_accumulation_steps must be >= 1"),
            (self.seq_len >= 2, "seq_len must be >= 2"),
            (self.precision in _DTYPES, f"precision={self.precision!r}: bf16 or fp32"),
            (self.param_dtype in _DTYPES, f"param_dtype={self.param_dtype!r}: bf16 or fp32"),
            (self.moment_dtype in (None, "bf16", "fp32"),
             f"moment_dtype={self.moment_dtype!r}: None, bf16 or fp32"),
            (self.lr_schedule in ("cosine", "linear", "constant", "rsqrt"),
             f"lr_schedule={self.lr_schedule!r} unknown"),
            (self.learning_rate > 0 and self.min_lr >= 0, "learning rates must be positive"),
            (self.warmup_steps >= 0 and self.total_steps >= 1, "bad step counts"),
            (self.weight_decay >= 0 and self.grad_clip_norm > 0, "bad weight_decay/grad_clip_norm"),
            (0 < self.beta1 < 1 and 0 < self.beta2 < 1, "betas must be in (0, 1)"),
            (self.z_loss_coef >= 0, "z_loss_coef must be >= 0"),
            (self.attention_impl in ("auto", "xla", "flash", "ring", "ulysses"),
             f"attention_impl={self.attention_impl!r}: auto, xla, flash, ring or ulysses"),
            (self.moe_impl in (None, "dense", "ragged"),
             f"moe_impl={self.moe_impl!r}: None, dense or ragged"),
            (self.sequence >= 1 and self.seq_len % self.sequence == 0,
             f"sequence={self.sequence} must be >= 1 and divide seq_len={self.seq_len}"),
            (self.loss_chunk_size is None
             or (self.loss_chunk_size >= 1 and self.seq_len % self.loss_chunk_size == 0),
             f"loss_chunk_size={self.loss_chunk_size} must divide seq_len={self.seq_len}"),
            (self.optimizer in ("adamw", "adafactor", "lion"),
             f"optimizer={self.optimizer!r}: adamw, adafactor or lion"),
            (self.quant_training in ("none", "int8"),
             f"quant_training={self.quant_training!r}: none or int8"),
            (self.lora_rank is None or self.lora_rank >= 1, "lora_rank must be >= 1"),
            (self.lora_alpha > 0, "lora_alpha must be > 0"),
            (self.optimizer_offload in _PLACES and self.param_offload in _PLACES,
             f"optimizer_offload={self.optimizer_offload!r} / param_offload="
             f"{self.param_offload!r}: none, host or disk"),
            (self.sliding_window is None or self.sliding_window >= 0,
             f"sliding_window={self.sliding_window} must be None or >= 0"),
            (int(self.sharding_stage) in (0, 1, 2, 3),
             f"sharding_stage={self.sharding_stage!r}: 0, 1, 2 or 3"),
            (self.sequence == 1 or self.mesh.sequence == 1,
             f"sequence={self.sequence} (a ring in this process) and mesh.sequence="
             f"{self.mesh.sequence} (a ring across ranks): set one"),
            (self.pipeline_schedule in sharding.PIPELINE_SCHEDULES,
             f"pipeline_schedule={self.pipeline_schedule!r}: auto, gpipe, 1f1b or zb"),
            (self.comm_quant_block_size >= 8, "comm_quant_block_size must be >= 8"),
            (all(getattr(self, n) is None or getattr(self, n) >= 1 for n in (
                "elastic_min_devices", "elastic_max_devices", "elastic_min_batch_size",
                "elastic_max_batch_size", "elastic_target_batch_size", "eval_interval_steps")),
             "elastic bounds and eval_interval_steps must be >= 1"),
            (self.checkpoint_interval_steps >= 1 and self.max_checkpoints_to_keep >= 1
             and self.eval_batches >= 1 and self.log_every_steps >= 1,
             "checkpoint_interval_steps, max_checkpoints_to_keep, eval_batches and "
             "log_every_steps must be >= 1"),
            (self.dataset_dtype in ("uint16", "int32"),
             f"dataset_dtype={self.dataset_dtype!r}: uint16 or int32"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)
        self._check_elastic_bounds()
        self.quant_train_targets = tuple(self.quant_train_targets)
        self.lora_targets = tuple(self.lora_targets)
        quant_train.check_targets(self.quant_train_targets, self.quant_training,
                                  self.lora_rank, self.moe_impl)
        if self.optimizer == "adafactor" and self.moment_dtype is not None:
            raise ValueError(
                "moment_dtype is not supported with optimizer='adafactor' "
                "(factored statistics have no dtype knob)"
            )
        tfm.resolve_remat_policy(self.remat_policy)
        self._check_disk_offload()
        self.sharding_stage = int(self.sharding_stage)
        if self.grad_allreduce_dtype not in (None, "fp32"):
            if self.grad_allreduce_dtype != self.precision:
                raise ValueError(
                    f"grad_allreduce_dtype={self.grad_allreduce_dtype!r} must "
                    f"be 'fp32' or match precision={self.precision!r}")
            schedule = sharding.resolve_pipeline_schedule(self)
            if self.mesh.pipe > 1 and schedule in ("1f1b", "zb"):
                raise ValueError(
                    f"grad_allreduce_dtype with pipeline_schedule="
                    f"{schedule!r} is not supported: the manual-vjp schedule "
                    "accumulates gradients in fp32 inside its scan, so the "
                    "reduced-dtype collective the option exists for would never "
                    "materialise (use 'gpipe', or drop grad_allreduce_dtype)")
        comm_compress.validate_config(self)

    def _check_elastic_bounds(self) -> None:
        """JAX's ``_validate_elastic_bounds``, with its messages."""
        lo, hi = self.elastic_min_devices, self.elastic_max_devices
        if lo is not None and hi is not None and hi < lo:
            raise ValueError(f"elastic_max_devices={hi} < elastic_min_devices={lo}")
        if hi is not None and lo is None:
            raise ValueError(
                "elastic_max_devices requires elastic_min_devices (the bounds "
                "are one declaration: 'this job may run between X and Y chips')")
        blo, bhi = self.elastic_min_batch_size, self.elastic_max_batch_size
        if blo is not None and bhi is not None and bhi < blo:
            raise ValueError(f"elastic_max_batch_size={bhi} < elastic_min_batch_size={blo}")

    @property
    def effective_batch_size(self) -> int:
        """micro × accum × data-parallel world (JAX's): ``data = -1`` is
        resolved against the ranks of the process group (one without), and
        conservatively taken as 1 where the mesh does not fit them."""
        data = self.mesh.data
        if data == -1:
            world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
            try:
                data = self.mesh.resolved_shape(world)[0]
            except ValueError:
                data = 1
        return self.micro_batch_size * self.gradient_accumulation_steps * data * self.mesh.fsdp

    def _check_disk_offload(self) -> None:
        """JAX's ``_validate_disk_offload``: the combinations the disk tier
        (a host AdamW over memmap slabs) cannot run, with its messages."""
        if self.optimizer_offload != "disk":
            if self.optimizer_spill_dir is not None:
                raise ValueError("optimizer_spill_dir only applies with optimizer_offload='disk'")
            if self.disk_update_overlap:
                raise ValueError("disk_update_overlap only applies with optimizer_offload='disk'")
            if self.param_offload == "disk":
                raise ValueError(
                    "param_offload='disk' is not supported: params are read every forward "
                    "pass — spill optimizer state instead (optimizer_offload='disk')")
            return
        if self.optimizer_spill_dir is None:
            raise ValueError(
                "optimizer_offload='disk' requires optimizer_spill_dir (the reference's nvme_path)")
        if self.optimizer != "adamw":
            raise ValueError("optimizer_offload='disk' supports optimizer='adamw' only "
                             "(the host update implements the AdamW chain)")
        if self.moment_dtype is not None:
            raise ValueError("moment_dtype targets device/host memory; disk-tier moments "
                             "live in fp32 spill files — drop moment_dtype")
        if self.param_offload != "none":
            raise ValueError("optimizer_offload='disk' with param_offload is not supported "
                             "(the disk tier already keeps only compute-dtype params on device)")
        if self.lora_rank is not None:
            raise ValueError("optimizer_offload='disk' with LoRA is pointless (adapter state "
                             "is rank-sized) and unsupported")

    @property
    def beta2_is_set(self) -> bool:
        """Whether ``beta2`` was given (JAX: ``"beta2" in
        cfg.model_fields_set``)."""
        return not isinstance(self.beta2, _DefaultFloat)

    def lora_scale(self) -> float:
        return self.lora_alpha / self.lora_rank if self.lora_rank is not None else 1.0

    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.precision]

    def master_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]


# ---------------------------------------------------------------------------
# Schedule and optimizer
# ---------------------------------------------------------------------------


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Warmup then the configured decay; the numbers of optax's
    ``warmup_cosine_decay_schedule`` / ``join_schedules`` of linear,
    constant and rsqrt tails, as ``tpu_engine.train.make_schedule`` builds."""
    warmup = max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps, cfg.warmup_steps + 1)
    peak, end = cfg.learning_rate, cfg.min_lr

    def linear(init, final, steps, count):
        count = min(max(count, 0), steps)
        return (init - final) * (1 - count / steps) + final

    if cfg.lr_schedule == "cosine":
        alpha = 0.0 if peak == 0.0 else end / peak
        cos_steps = decay_steps - warmup

        def tail(count):
            count = min(count, cos_steps)
            cosine = 0.5 * (1 + math.cos(math.pi * count / cos_steps))
            return peak * ((1 - alpha) * cosine + alpha)
    elif cfg.lr_schedule == "linear":
        def tail(count):
            return linear(peak, end, max(decay_steps - warmup, 1), count)
    elif cfg.lr_schedule == "constant":
        def tail(count):
            return peak
    else:  # rsqrt: lr · sqrt(warmup / step) past warmup, floored at min_lr
        def tail(count):
            return max(peak * math.sqrt(warmup / max(count + warmup, 1)), end)

    def schedule(step: int) -> float:
        step = int(step)
        if step < warmup:
            return linear(0.0, peak, warmup, step)
        return tail(step - warmup)

    return schedule


def kernel_decay_mask(params: dict[str, torch.Tensor]) -> dict[str, bool]:
    """Weight decay applies to matmul kernels and LoRA factors (path ends in
    ``kernel``, ``A`` or ``B``), not to biases, norm scales or embedding and
    position tables (a tied head is its embedding, so it does not decay
    either)."""
    return {k: k.rsplit(".", 1)[-1] in ("kernel", "A", "B") for k in params}


@dataclass
class _Chain:
    """optax ``chain(clip_by_global_norm, <scaler>,
    add_decayed_weights(mask))`` followed by ``p - lr·u``, written on
    tensors; a subclass is the scaler (:meth:`scale`, which may update its
    state in place and returns the update u of one unit).

    Clipping scales only when the norm exceeds the max (optax's rule, which
    is not ``clip_grad_norm_``'s).

    The update runs over units of the leaves (``offload.update_units``: an
    elementwise scaler cuts a large leaf into runs of whole rows), in place
    or streamed through the device by a walk (``offload.UpdateWalk``); the
    arithmetic is the same either way. A master below fp32 (bf16) follows
    optax's dtype order: the fp32 gradient, clipped in fp32; the optimizer's
    tensors in fp32 as optax holds them from the first update on (a
    ``mu_dtype`` apart); the decay term wd·p in p's dtype; p + (-lr·u)
    summed in fp32 and rounded once."""

    weight_decay: float
    grad_clip_norm: float
    decay_all_params: bool
    elementwise: ClassVar[bool] = True

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
               state: dict, lr: float, walk: Optional[UpdateWalk] = None,
               norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply one update in place to ``params`` and ``state``; ``grads``
        must already hold the raw (unclipped) gradients, and are clipped in
        place (fp32 ones; another dtype's in an fp32 copy at its unit).
        ``walk`` moves host-resident masters or optimizer tensors through
        the device (default: all in place). ``norm``: the global norm where
        ``grads`` hold a rank's shards of it (the mesh program's). Returns
        the global norm of the raw gradients."""
        keys = list(params)
        g_list = [grads[k] for k in keys]
        g_norm = global_norm(g_list) if norm is None else norm
        factor = torch.where(g_norm < self.grad_clip_norm, torch.ones_like(g_norm),
                             self.grad_clip_norm / g_norm)
        f32 = [g for g in g_list if g.dtype == torch.float32]
        if f32:
            torch._foreach_mul_(f32, factor)
        count = state["count"]
        state["count"] += 1
        decay = kernel_decay_mask(params)
        walk = walk or UpdateWalk(g_norm.device)
        for k, p, g, st in walk.walk(params, grads, state, self.elementwise):
            if g.dtype != torch.float32:
                g = g.float().mul_(factor)
            u = self.scale(g, p, st, count, k)
            low = p.dtype != torch.float32
            if self.weight_decay and (self.decay_all_params or decay[k]):
                if low:
                    u.add_(p * torch.tensor(self.weight_decay, dtype=p.dtype, device=p.device))
                else:
                    u.add_(p, alpha=self.weight_decay)
            if low:
                p.copy_(u.mul_(-lr).add_(p))
            else:
                p.add_(u, alpha=-lr)
        return g_norm

    def state_bytes(self, state: dict) -> int:
        """Bytes of the optimizer's tensors (moments, factored statistics)."""
        return sum(t.numel() * t.element_size() for name, tree in state.items()
                   if name != "count" for t in tree.values())


def _update_fp32(t: torch.Tensor) -> torch.Tensor:
    """An optimizer tensor as it updates: itself in fp32, else an fp32 copy
    (the stored tensor then takes the result with one rounding)."""
    return t if t.dtype == torch.float32 else t.float()


@dataclass
class AdamW(_Chain):
    """``scale_by_adam(b1, b2, eps=1e-8, mu_dtype)``. The moments are fp32
    whatever the masters' dtype: optax's update of bf16 zeros by an fp32
    gradient is fp32, and it casts only mu, only to a given ``mu_dtype``.
    A bf16 mu updates in fp32 and only its stored copy rounds, as optax
    casts it."""

    b1: float = 0.9
    b2: float = 0.95
    mu_dtype: Optional[torch.dtype] = None
    eps: float = 1e-8

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p, dtype=self.mu_dtype or torch.float32)
                   for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        }

    def scale(self, g, p, st, count, key=None):
        mu, nu = st["mu"], st["nu"]
        bc1 = 1 - self.b1 ** (count + 1)
        bc2 = 1 - self.b2 ** (count + 1)
        mu32, nu32 = _update_fp32(mu), _update_fp32(nu)
        mu32.mul_(self.b1).add_(g, alpha=1 - self.b1)
        nu32.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
        u = (mu32 / bc1).div_((nu32 / bc2).sqrt_().add_(self.eps))
        for stored, new in ((mu, mu32), (nu, nu32)):
            if new is not stored:
                stored.copy_(new)
        return u


def factored_dims(shape, min_dim_size_to_factor: int = 128) -> Optional[tuple[int, int]]:
    """optax ``_factored_dims``: (second-largest dim, largest dim) when the
    second-largest is at least ``min_dim_size_to_factor``, else None. On a
    stacked [L, in, out] kernel these are ``in`` and ``out``, never ``L``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


@dataclass
class Adafactor(_Chain):
    """optax ``scale_by_factored_rms(decay_rate)`` with optax's other
    defaults (``min_dim_size_to_factor`` 128, ``epsilon`` 1e-30,
    ``step_offset`` 0): second moments factored into row and column means
    over a leaf's two largest dims where both reach 128, whole otherwise;
    decay ``1 - (t + 1) ** -decay_rate`` at count t. The statistics are
    fp32 whatever the masters' dtype (optax's promote to fp32 at the first
    update). Its units are whole leaves (the factored means reduce over
    them).

    On a mesh a leaf may be a rank's block (``splits``: key → the dims
    ``model`` or ``fsdp`` split, each with its group and rank count; set
    by the program). Whether a leaf is factored, and over which dims, is
    decided on its whole shape (``shapes``): a split must not bring a
    local dim under 128 and change the decision. A mean over a split dim
    is the group's sum of the local means over its rank count (equal
    blocks); the row means' own normalising mean likewise."""

    decay_rate: float = 0.8
    epsilon: float = 1e-30
    elementwise: ClassVar[bool] = False
    shapes: dict = field(default_factory=dict)
    splits: dict = field(default_factory=dict)

    def _dims(self, key, p) -> Optional[tuple[int, int]]:
        return factored_dims(self.shapes.get(key, tuple(p.shape)))

    def _mean(self, x: torch.Tensor, dim: int, key, keepdim: bool = False,
               shift: int = 0) -> torch.Tensor:
        """``x.mean(dim)`` over the whole leaf: summed over the group that
        splits ``dim`` (``shift`` maps a reduced tensor's dim back to the
        leaf's)."""
        m = x.mean(dim=dim, keepdim=keepdim)
        for d, group, n in self.splits.get(key, ()):
            if d == dim + shift:
                m = all_reduce_(m.contiguous(), group).div_(n)
        return m

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        v_row, v_col, v = {}, {}, {}
        f32 = torch.float32
        for k, p in params.items():
            dims = self._dims(k, p)
            if dims is None:
                v[k] = torch.zeros_like(p, dtype=f32)
            else:
                d1, d0 = dims
                v_row[k] = torch.zeros_like(p.select(d0, 0), dtype=f32)
                v_col[k] = torch.zeros_like(p.select(d1, 0), dtype=f32)
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    def scale(self, g, p, st, count, key=None):
        # optax computes the decay in fp32: 1 - float32(t + 1) ** -rate.
        beta = np.float32(1.0) - np.float32(count + 1) ** np.float32(-self.decay_rate)
        beta, rest = float(beta), float(np.float32(1.0) - beta)
        grad_sqr = g * g + self.epsilon
        dims = self._dims(key, p)
        if dims is None:
            v = st["v"]
            v.mul_(beta).add_(grad_sqr, alpha=rest)
            return g * v.rsqrt()
        d1, d0 = dims
        v_row, v_col = st["v_row"], st["v_col"]
        v_row.mul_(beta).add_(self._mean(grad_sqr, d0, key), alpha=rest)
        v_col.mul_(beta).add_(self._mean(grad_sqr, d1, key), alpha=rest)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_mean = self._mean(v_row, reduced_d1, key, keepdim=True, shift=d1 - reduced_d1)
        row_factor = (v_row / row_mean).rsqrt()
        return g * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)


@dataclass
class Lion(_Chain):
    """optax ``scale_by_lion(b1, b2, mu_dtype)``: the update is
    sign((1 - b1)·g + b1·μ), then μ ← b2·μ + (1 - b2)·g (one moment, fp32
    unless ``mu_dtype`` is given, as in optax whatever the masters' dtype)."""

    b1: float = 0.9
    b2: float = 0.99
    mu_dtype: Optional[torch.dtype] = None

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p, dtype=self.mu_dtype or torch.float32)
                       for k, p in params.items()}}

    def scale(self, g, p, st, count, key=None):
        mu = st["mu"]
        # optax's b·μ is in μ's dtype, b rounded to it: a bf16 product for a
        # bf16 mu_dtype, fp32 otherwise, before the fp32 sum.
        def decayed(b):
            return (mu * torch.tensor(b, dtype=mu.dtype, device=mu.device)).float()

        u = torch.sign(g * (1 - self.b1) + decayed(self.b1))
        mu.copy_(g * (1 - self.b2) + decayed(self.b2))
        return u


Optimizer = Union[AdamW, Adafactor, Lion]


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ‖t‖²) over a list of tensors, as a 0-d fp32 tensor. Tensors
    below fp32 are reduced in fp32 without an fp32 copy of each (a 7B
    model's bf16 gradients would need 25 GiB of copies)."""
    f32 = [t for t in tensors if t.dtype == torch.float32]
    low = [t for t in tensors if t.dtype != torch.float32]
    norms = list(torch._foreach_norm(f32)) if f32 else []
    if low:
        norms += torch._foreach_norm(low, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


def make_optimizer(cfg: TrainConfig) -> tuple[Optimizer, Callable[[int], float]]:
    """The configured optimizer and the schedule. The learning rate is
    applied by the step: ``lr = schedule(step) · lr_scale``, as in the JAX
    train step. Adafactor's decay exponent is ``beta2`` only where it was
    set, else 0.8, as in JAX."""
    mu_dtype = _DTYPES[cfg.moment_dtype] if cfg.moment_dtype is not None else None
    chain = dict(weight_decay=cfg.weight_decay, grad_clip_norm=cfg.grad_clip_norm,
                 decay_all_params=cfg.decay_all_params)
    if cfg.optimizer == "adafactor":
        tx = Adafactor(decay_rate=float(cfg.beta2) if cfg.beta2_is_set else 0.8, **chain)
    elif cfg.optimizer == "lion":
        tx = Lion(b1=cfg.beta1, b2=float(cfg.beta2), mu_dtype=mu_dtype, **chain)
    else:
        tx = AdamW(b1=cfg.beta1, b2=float(cfg.beta2), mu_dtype=mu_dtype, **chain)
    return tx, make_schedule(cfg)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _ce_target_sums(logits: torch.Tensor, targets: torch.Tensor, tp=None):
    """Raw CE sums (Σ log-likelihood, Σ logZ², valid count) of ``logits``
    [B, S, V] against ``targets`` [B, S] at the same positions; targets < 0
    are excluded. ``tp``
    (:class:`~tpu_engine_torch.parallel.tensor_parallel.ModelAxis`): the
    logits are this rank's vocabulary block (:func:`vocab_ce_sums`)."""
    if tp is not None and tp.vocab_split:
        return vocab_ce_sums(logits, targets, tp)
    valid = (targets >= 0).float()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets.clamp(min=0)[..., None].long()).squeeze(-1) - logz
    return torch.sum(ll * valid), torch.sum(logz * logz * valid), torch.sum(valid)


def _ce_sums(logits: torch.Tensor, tokens: torch.Tensor, tp=None):
    """Raw next-token CE sums (Σ log-likelihood, Σ logZ², valid count);
    targets < 0 are excluded."""
    return _ce_target_sums(logits[:, :-1, :], tokens[:, 1:], tp)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor, z_loss_coef: float = 0.0):
    """Mean next-token cross-entropy over valid targets (+ z-loss)."""
    ll_sum, z_sum, n_valid = _ce_sums(logits, tokens)
    denom = torch.clamp(n_valid, min=1.0)
    loss = -ll_sum / denom
    if z_loss_coef:
        loss = loss + z_loss_coef * z_sum / denom
    return loss


def decode_masked_tokens(raw: torch.Tensor):
    """In-band SFT masking: ``-(t+1)`` is context token ``t`` with no loss.
    Returns (tokens for the forward, loss-view tokens with masked = -1)."""
    masked = raw < 0
    clean = torch.where(masked, -raw - 1, raw)
    return clean, torch.where(masked, torch.full_like(raw, -1), raw)


def _chunk_sums(params, hc, tc, model_cfg, mesh=None):
    logits = tfm.unembed(params, hc, model_cfg, mesh)
    tp = model_axis(mesh, model_cfg)
    if tp is not None and tp.vocab_split:
        return vocab_ce_sums(logits, tc, tp)
    logz = torch.logsumexp(logits, dim=-1)
    mask = (tc >= 0).float()
    ll = torch.gather(logits, -1, tc.clamp(min=0)[..., None].long()).squeeze(-1) - logz
    return torch.sum(ll * mask), torch.sum(logz * logz * mask), torch.sum(mask)


def _next_targets(tokens: torch.Tensor) -> torch.Tensor:
    """Each position's next token (-1, no target, at the last)."""
    B = tokens.shape[0]
    return torch.cat([tokens[:, 1:], torch.full((B, 1), -1, dtype=tokens.dtype,
                                                 device=tokens.device)], dim=1)


def _chunked_ce_sums(params, hidden, tokens, model_cfg: ModelConfig, chunk: int,
                     targets: Optional[torch.Tensor] = None, mesh=None):
    """The sums of :func:`_ce_sums`, ``chunk`` positions at a time; each
    chunk is checkpointed so its fp32 logits are recomputed in backward
    rather than kept. ``targets``: each position's target, given (a
    rank's block of the sequence) rather than read from ``tokens``.
    ``mesh``: the head and the sums over its ``model`` axis's vocabulary
    blocks."""
    B, S, _ = hidden.shape
    tgt = _next_targets(tokens) if targets is None else targets
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    ll_total, z_total, n_total = zero, zero, zero
    for c in range(0, S, chunk):
        ll, zz, n = checkpoint(_chunk_sums, params, hidden[:, c:c + chunk],
                               tgt[:, c:c + chunk], model_cfg, mesh, use_reentrant=False)
        ll_total, z_total, n_total = ll_total + ll, z_total + zz, n_total + n
    return ll_total, z_total, n_total


def chunked_lm_loss(params, hidden, tokens, model_cfg: ModelConfig, chunk: int,
                    z_loss_coef: float = 0.0):
    """Chunked next-token cross-entropy, equal to
    ``lm_loss(unembed(params, hidden), tokens)``."""
    ll_total, z_total, n_total = _chunked_ce_sums(params, hidden, tokens, model_cfg, chunk)
    denom = torch.clamp(n_total, min=1.0)
    loss = -ll_total / denom
    if z_loss_coef:
        loss = loss + z_loss_coef * z_total / denom
    return loss


def _take_grad(sums: GradSums, key: str, p: torch.Tensor) -> None:
    sums.take(key, p.grad)
    p.grad = None


def accumulate_grads(loss_fn, params: dict[str, torch.Tensor], batch: torch.Tensor,
                     sums: Optional[GradSums] = None, denom: Optional[torch.Tensor] = None):
    """Gradient accumulation over ``batch`` [accum, B, S]: each microbatch's
    raw sums are divided by the batch-wide valid-target count, so the summed
    loss and gradients are the global mean (``denom``: that count, given
    where the batch is a rank's share of the step's), and its MoE aux term
    is weighted 1/accum, so the summed aux is the mean over microbatches.
    Gradients sum in fp32 on the device, as JAX's do (:class:`~tpu_engine_torch.offload.
    GradSums`): each leaf's ``.grad`` is taken as autograd finishes it and
    then cleared, so a step holds one gradient a leaf, and masters streamed
    from the host add theirs to ``sums`` themselves. Returns (the summed
    loss, 0-d; the summed gradients), JAX's pair."""
    if denom is None:
        denom = torch.clamp(torch.sum((batch[:, :, 1:] >= 0).float()), min=1.0)

    def run():
        total = torch.zeros((), dtype=torch.float32, device=batch.device)
        for tokens in batch:
            loss = loss_fn(params, tokens, include_aux=True, denom=denom,
                           aux_weight=1.0 / batch.shape[0])
            loss.backward()
            total = total + loss.detach()
        return total

    return collect_grads(run, params, sums if sums is not None else GradSums(batch.device))


def collect_grads(run: Callable[[], torch.Tensor], params: dict[str, torch.Tensor],
                  sums: GradSums):
    """Call ``run`` (which runs a step's backward passes and returns its
    summed loss) with every trainable leaf's ``.grad`` taken into ``sums``
    as autograd finishes it; returns (the loss, the summed gradients)."""
    sums.begin(params)
    hooks = []
    for k, p in params.items():
        p.grad = None
        if p.requires_grad:
            hooks.append(p.register_post_accumulate_grad_hook(partial(_take_grad, sums, k)))
    try:
        total = run()
    finally:
        for h in hooks:
            h.remove()
    return total, sums.finish()


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------


@dataclass
class TrainProgram:
    """A training program bound to one device.

    ``init()`` makes the state (params, optimizer state, step, lr_scale);
    ``step(state, batch)`` runs one optimizer step over
    ``gradient_accumulation_steps`` microbatches, ``batch`` being
    [accum, micro_batch, seq_len] int64 on the program's device.

    With LoRA (``config.lora_rank``) ``base_params`` holds the frozen base
    (master dtype, no gradient) and ``state["params"]`` the adapters alone,
    so gradients and optimizer state are rank-sized; ``merged_params``
    folds them into the base for ``generate`` and the batcher.

    The placements: ``optimizer_offload="host"`` puts ``state["opt_state"]``'s
    tensors, ``param_offload="host"`` ``state["params"]`` in host memory
    (pinned on a CUDA device), the update streaming them through the
    device (``walk``); with ``param_offload`` the streamed layers' gradients
    sum on the device (``host.sums``). ``optimizer_offload="disk"`` (``disk``)
    keeps the masters and moments in spill files: the state holds the
    params in the compute dtype and no ``opt_state``, and with
    ``disk_update_overlap`` the returned params lag the host walk by one
    step until :meth:`flush`.

    On a mesh (``runtime``, a :class:`~tpu_engine_torch.mesh_runtime.MeshRuntime`)
    ``step`` and ``eval_step`` take the global batch [accum, micro_batch ·
    data · fsdp, seq_len], JAX's, and each rank computes its block of it
    (or just this rank's rows, [accum, micro_batch, seq_len]);
    ``state["params"]`` and the optimizer state hold this rank's shards as
    ``zero`` (:class:`~tpu_engine_torch.parallel.zero.ZeroLayout`) places
    them, ``stream`` gathering stage 3's layer by layer; :meth:`whole_params`
    gathers them whole. With ``pipe > 1`` (``pipe``, a
    :class:`~tpu_engine_torch.parallel.pipeline.Stage`) a rank holds its
    stage's leaves alone and the step runs ``pipeline_schedule`` (the
    resolved one; "gpipe" without ``pipe``, as JAX names it)."""

    config: TrainConfig
    model_config: ModelConfig
    device: torch.device
    tx: Optimizer = field(repr=False)
    schedule: Callable[[int], float] = field(repr=False)
    base_params: Optional[dict[str, torch.Tensor]] = field(default=None, repr=False)
    walk: Optional[UpdateWalk] = field(default=None, repr=False)
    host: Optional[HostParams] = field(default=None, repr=False)
    disk: Optional["_DiskTier"] = field(default=None, repr=False)
    runtime: Optional[MeshRuntime] = field(default=None, repr=False)
    zero: Optional[zero.ZeroLayout] = field(default=None, repr=False)
    stream: Optional[zero.ShardedParams] = field(default=None, repr=False)
    pipe: Optional[pipeline.Stage] = field(default=None, repr=False)
    pipeline_schedule: str = "gpipe"

    def global_batch_shape(self) -> tuple[int, int, int]:
        c = self.config
        dp = self.runtime.data_parallel_size() if self.runtime is not None else 1
        return (c.gradient_accumulation_steps, c.micro_batch_size * dp, c.seq_len)

    def synthetic_batch(self, seed: int = 0) -> torch.Tensor:
        """Deterministic random tokens (its numbers differ from the JAX
        program's for the same seed)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randint(0, self.model_config.vocab_size, self.global_batch_shape(),
                             generator=gen, device=self.device)

    def init(self, params: Optional[dict[str, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None) -> dict:
        """Fresh state from ``params`` (e.g. ``params_from_jax``; with LoRA
        the adapters, e.g. ``lora_from_jax``; taken in the master dtype) or
        a random init drawn from ``generator`` (default: seeded by
        ``config.seed``) on the device. The disk tier re-attaches to a
        matching clean spill instead, whose masters are the truth."""
        cfg = self.config
        if self.disk is not None and self.disk.attach():
            return self.disk.state(self.disk.params_from_masters())
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
            if self.base_params is not None:
                params = lora_mod.init_lora_params(generator, self.model_config, cfg.lora_rank,
                                                   cfg.lora_targets, self.device)
            else:
                params = tfm.init_params(self.model_config, generator, self.device,
                                         dtype=cfg.master_dtype())
        elif self.base_params is None:
            params = {k: v.detach().to(device=self.device, dtype=cfg.master_dtype())
                      .requires_grad_(True) for k, v in params.items()}
        if self.disk is not None:
            return self.disk.state(self.disk.seed(params))
        like = params
        if self.zero is not None:
            if self.pipe is not None:  # leaves of the stage's own
                params = {k: v.detach().clone().requires_grad_(v.requires_grad)
                          for k, v in self.pipe.block(params).items()}
            params = self.zero.place(params)
            like = self.zero.state_like(params)
        pin = self.device.type == "cuda"
        opt_state = self.tx.init({k: torch.empty_like(p, device="meta") for k, p in like.items()}
                                 if cfg.optimizer_offload == "host" else like)
        if cfg.optimizer_offload == "host":
            opt_state = {name: tree if name == "count" else HostArena(tree, pin).tensors
                         for name, tree in opt_state.items()}
        if cfg.param_offload == "host":
            params = HostArena(params, pin).tensors
        state = {"params": params, "opt_state": opt_state, "step": 0, "lr_scale": 1.0}
        hpz = self._refresh_hpz(params)
        if hpz is not None:
            state["hpz"] = hpz
        return state

    def loss_fn(self, params, raw_tokens, include_aux: bool = True, denom=None,
                aux_weight: float = 1.0):
        """Masked LM loss of one microbatch: its own valid-target mean, or
        raw sums over ``denom`` when summing over microbatches. With
        ``include_aux`` (training; the held-out loss has none) it adds the
        z-loss and, for MoE, ``aux_weight · router_aux_coef · aux``. Host
        masters stream in: the non-layer leaves once here, each layer in
        its block (JAX's ``_device_view`` and ``layer_stream``). On a mesh
        ``raw_tokens`` are this rank's rows: it computes its block of their
        positions, with their next tokens as targets, and stage 3's shards
        are gathered (each layer in its block); the MoE aux term, the same
        on every rank, is weighted 1/ranks, so the ranks' losses sum to
        JAX's."""
        cfg = self.config
        lora = None
        if self.base_params is not None:  # the trainable params are the adapters
            params, lora = self.base_params, params
        layer_stream = None
        if self.host is not None:
            params, layer_stream = self.host.bind(params), self.host
        if self.stream is not None:
            if lora is not None:
                lora = self.stream.bind(lora, layers=False)
            else:
                params, layer_stream = self.stream.bind(params), self.stream
        tokens, loss_tokens, positions, targets = self._inputs(raw_tokens)
        hidden, aux = tfm.forward_hidden_and_aux(
            params, tokens, self.model_config, compute_dtype=cfg.compute_dtype(),
            remat=cfg.activation_checkpointing, positions=positions, sequence=cfg.sequence,
            remat_policy=cfg.remat_policy, lora=lora, lora_scale=cfg.lora_scale(),
            layer_stream=layer_stream, mesh=self.runtime,
        )
        loss = self._exit(params, hidden, loss_tokens, targets, denom, include_aux)
        if self.model_config.is_moe and include_aux:
            loss = loss + aux_weight * self._aux_coef() * aux
        return loss

    def _aux_coef(self) -> float:
        """The MoE aux loss's weight, over the token ranks (each rank's
        term is the same, so the ranks' losses sum to JAX's)."""
        ranks = self.runtime.size(TOKEN_AXES) if self.runtime is not None else 1
        return self.model_config.router_aux_coef / ranks

    def _inputs(self, raw_tokens):
        """(tokens, loss-view tokens, positions, targets) of one microbatch
        [B, S] of this rank's rows: on a ``sequence`` axis the rank's block
        of the positions and each one's next token as its target; else
        None for both (all positions, the next tokens read from the loss
        view)."""
        tokens, loss_tokens = decode_masked_tokens(raw_tokens)
        positions = targets = None
        block = zero.sequence_block(self.runtime, tokens.shape[1]) if self.runtime else None
        if block is not None:
            s0, n = block
            targets = _next_targets(loss_tokens)[:, s0:s0 + n]
            tokens = tokens[:, s0:s0 + n]
            positions = torch.arange(s0, s0 + n, device=tokens.device).expand(tokens.shape)
        return tokens, loss_tokens, positions, targets

    def _exit(self, params, hidden, loss_tokens, targets, denom, include_aux: bool):
        """The cross-entropy of ``hidden`` (and the z-loss with
        ``include_aux``) over ``denom`` (None: this microbatch's own valid
        count): the final norm, the head and the loss."""
        cfg, mesh = self.config, self.runtime
        tp = model_axis(mesh, self.model_config)
        if cfg.loss_chunk_size:
            ll_sum, z_sum, n_valid = _chunked_ce_sums(
                params, hidden, loss_tokens, self.model_config, cfg.loss_chunk_size, targets,
                mesh)
        elif targets is not None:
            ll_sum, z_sum, n_valid = _ce_target_sums(
                tfm.unembed(params, hidden, self.model_config, mesh), targets, tp)
        else:
            ll_sum, z_sum, n_valid = _ce_sums(
                tfm.unembed(params, hidden, self.model_config, mesh), loss_tokens, tp)
        d = torch.clamp(n_valid, min=1.0) if denom is None else denom
        loss = -ll_sum / d
        z_coef = cfg.z_loss_coef if include_aux else 0.0
        if z_coef:
            loss = loss + z_coef * z_sum / d
        return loss

    def _stage_work(self, params, rows, denom, include_aux: bool = True) -> pipeline.StageWork:
        """This stage's work for one step over ``rows`` [accum, B, S]
        (:class:`~tpu_engine_torch.parallel.pipeline.StageWork`): the first
        stage embeds, every stage runs its block of layers (under the remat
        policy; stage 3 gathering each layer from ``stream``), the last takes
        the loss. A stage's MoE aux term is its layers' aux losses summed,
        at JAX's ``router_aux_coef / (n_layers · accum)`` over the token
        ranks."""
        cfg, mc, stage = self.config, self.model_config, self.pipe
        inputs = [self._inputs(r) for r in rows]
        tokens0, _, positions, _ = inputs[0]
        if positions is None:
            B, S = tokens0.shape
            positions = torch.arange(S, device=tokens0.device).expand(B, S)
        if self.stream is not None:
            self.stream.params = params  # the layer stream reads the stage's shards
        policy = tfm.resolve_remat_policy(cfg.remat_policy) if cfg.activation_checkpointing \
            else None
        aux_w = (self._aux_coef() / (mc.n_layers * rows.shape[0])
                 if mc.is_moe and include_aux else None)

        def bound():
            return self.stream.bind(params) if self.stream is not None else params

        def embed(m):
            return tfm.embed_tokens(bound(), inputs[m][0], cfg.compute_dtype(),
                                    positions=positions, cfg=mc, mesh=self.runtime)

        def layers(x):
            y, auxes = tfm.run_layers(params, x, mc, positions, stage.layers,
                                      cfg.compute_dtype(), policy, cfg.sequence,
                                      layer_stream=self.stream, mesh=self.runtime)
            return y, (None if aux_w is None else aux_w * torch.stack(auxes).sum())

        def loss(y, m):
            _, loss_tokens, _, targets = inputs[m]
            return self._exit(bound(), y, loss_tokens, targets, denom, include_aux)

        like = torch.empty((*tokens0.shape, mc.d_model), dtype=cfg.compute_dtype(),
                           device=self.device)
        return pipeline.StageWork(embed, layers, loss, like, rows.shape[0])

    def _pipe_grads(self, params, rows, denom):
        """The step's loss terms of this stage (summed over the
        microbatches, CE on the last stage plus the stage's aux terms) and
        its gradients, by the resolved schedule."""
        work = self._stage_work(params, rows, denom)
        run = _SCHEDULES[self.pipeline_schedule]
        sums = self.stream.sums if self.stream is not None else GradSums(self.device)

        def go():
            loss, aux = run(self.pipe, work)
            return loss + aux

        return collect_grads(go, params, sums)

    def _rows_and_denom(self, batch: torch.Tensor):
        """A mesh step's share: this rank's rows of the global ``batch`` (or
        ``batch`` itself where it holds just this rank's
        ``micro_batch_size`` rows of each microbatch, as ``data.make_data_fn``
        reads them on a mesh), and the step's valid-target count summed over
        every rank."""
        micro = self.config.micro_batch_size
        if batch.shape[1] == micro and self.runtime.data_parallel_size() > 1:
            rows = batch
        else:
            rows = zero.local_rows(batch, self.runtime, micro)
        targets = rows[:, :, 1:]
        block = zero.sequence_block(self.runtime, rows.shape[2])
        if block is not None:
            targets = targets[..., block[0]:block[0] + block[1]]
        count = all_reduce_(torch.sum((targets >= 0).float()), self.zero.tokens)
        return rows, torch.clamp(count, min=1.0)

    def _refresh_hpz(self, params: dict) -> Optional[dict]:
        """hpZ's secondary store of ``params`` (this rank's shards), or None
        without hpZ."""
        cc = self.zero.compress if self.zero is not None else None
        return cc.refresh(params) if cc is not None else None

    def _mesh_step(self, state: dict, batch: torch.Tensor) -> tuple[dict, dict]:
        """The step on a mesh: this rank's share of the loss and gradients;
        the gradients reduced over the ranks (stage 3's in its backward),
        the global norm, the update of this rank's shards, and at stages
        1 and 2 the parameters gathered whole again; under hpZ the
        secondary store refreshed from the updated shards."""
        z, params = self.zero, state["params"]
        if self.stream is not None:
            self.stream.hpz = state.get("hpz")
        loss, grads = self.mesh_grads(params, batch)
        norm = z.grad_norm(grads, global_norm)
        lr = self.schedule(state["step"]) * state["lr_scale"]
        p_upd, g_upd = z.update_views(params, grads)
        self.tx.update(p_upd, g_upd, state["opt_state"], lr, self.walk, norm=norm)
        z.gather_updated(params)
        if "hpz" in state:
            state["hpz"] = self._refresh_hpz(params)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": norm,
                       "learning_rate": lr, "step": state["step"]}

    def mesh_grads(self, params: dict, batch: torch.Tensor):
        """A mesh step's loss (summed over the ranks: every rank reports
        JAX's) and this rank's gradients, reduced over the ranks as the
        update takes them (this rank's shards where they are split)."""
        z = self.zero
        rows, denom = self._rows_and_denom(batch)
        sink = self.stream or self.host
        # int8's weight-gradient scales over the microbatch's ranks, as
        # JAX's GSPMD program; a rank's own under the compressed
        # collectives (JAX's manual region).
        scales = z.tokens if self.model_config.quant_training == "int8" \
            and z.compress is None else None
        # Recompute every collective a checkpointed block ran: stopping
        # early after its last saved tensor could leave one out on one rank.
        with set_checkpoint_early_stop(False), quant_train.token_scales(scales):
            if self.pipe is not None:
                loss, grads = self._pipe_grads(params, rows, denom)
            else:
                loss, grads = accumulate_grads(self.loss_fn, params, rows,
                                               sink.sums if sink else None, denom)
        grads = z.reduce_grads(grads)
        if self.pipe is not None:
            grads = self.pipe.reduce_tied(grads)
            loss = all_reduce_(loss, self.pipe.group)  # each stage's terms
        return all_reduce_(loss, z.tokens), grads

    def whole_params(self, state: dict) -> dict[str, torch.Tensor]:
        """``state["params"]`` with every leaf whole (stage 3's shards
        gathered, the ``model`` blocks joined, every stage's leaves on
        every rank; the leaves themselves otherwise)."""
        if self.zero is None:
            return state["params"]
        return self.whole_tree(state["params"])

    def whole_tree(self, tree: dict, split: Optional[bool] = None) -> dict:
        """A tree of this rank's leaves (params, or gradients as
        :meth:`mesh_grads` returns them) made whole on every rank:
        gathered over ``fsdp`` where ``split`` (default: where stage 3
        splits the params), over ``model`` and over ``pipe``."""
        z = self.zero
        out = z.whole(tree, fsdp=z.params_split if split is None else split)
        if self.pipe is None:
            return out
        return self.pipe.whole(out, sharding.whole_shapes(self.model_config))

    def step(self, state: dict, batch: torch.Tensor) -> tuple[dict, dict]:
        """One optimizer step. Metrics are device tensors (no host sync)
        except ``learning_rate`` and ``step``, which the host knows."""
        if self.disk is not None:
            return self.disk.step(state, batch)
        if self.runtime is not None:
            return self._mesh_step(state, batch)
        params = state["params"]
        loss, grads = accumulate_grads(self.loss_fn, params, batch,
                                       self.host.sums if self.host is not None else None)
        lr = self.schedule(state["step"]) * state["lr_scale"]
        grad_norm = self.tx.update(params, grads, state["opt_state"], lr, self.walk)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "learning_rate": lr, "step": state["step"]}

    def flush(self, state: dict) -> dict:
        """The state with every update its step counts applied: the disk
        tier's in-flight walk joined under ``disk_update_overlap``; the
        state itself otherwise."""
        return self.disk.flush(state) if self.disk is not None else state

    def transfer_bytes(self) -> dict[str, int]:
        """Bytes copied host→device and device→host by the placements
        since the program was built."""
        parts = [x.bytes for x in (self.walk, self.host, self.stream, self.disk)
                 if x is not None]
        return {d: sum(b[d] for b in parts) for d in ("h2d", "d2h")}

    @torch.no_grad()
    def merged_params(self, adapters: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """LoRA only: the base with ``adapters`` (``state["params"]``)
        merged (``lora.merge_lora``), every leaf in the compute dtype, for
        ``generate`` and the ``ContinuousBatcher``. On a ``model`` mesh it
        is this rank's block of the merged tree (the base's block plus its
        adapters' product: A whole times B's columns, or A's rows times B
        whole), what a batcher on the same mesh takes."""
        if self.base_params is None:
            raise ValueError("merged_params needs a LoRA program (lora_rank set)")
        cfg = self.config
        if self.zero is not None:  # this rank's model block of the merged tree
            adapters = self.zero.whole(adapters, fsdp=self.zero.params_split, model=False)
        merged = lora_mod.merge_lora(self.base_params, adapters, cfg.lora_alpha, cfg.lora_rank)
        return {k: v.to(cfg.compute_dtype()) for k, v in merged.items()}

    @torch.no_grad()
    def eval_step(self, state: dict, batch: torch.Tensor) -> torch.Tensor:
        """Held-out loss over one [accum, B, S] batch: pure cross-entropy,
        on the full-width weights (JAX's eval runs no compressed gather)."""
        if self.runtime is not None:
            batch, denom = self._rows_and_denom(batch)
        else:
            denom = torch.clamp(torch.sum((batch[:, :, 1:] >= 0).float()), min=1.0)
        if self.pipe is not None:
            work = self._stage_work(state["params"], batch, denom, include_aux=False)
            with set_checkpoint_early_stop(False):
                total = all_reduce_(pipeline.eval_losses(self.pipe, work), self.pipe.group)
            return all_reduce_(total, self.zero.tokens)
        total = torch.zeros((), dtype=torch.float32, device=batch.device)
        compress = self.zero.compress if self.zero is not None else None
        try:
            if compress is not None:
                self.zero.compress = None
            for tokens in batch:
                total = total + self.loss_fn(state["params"], tokens, include_aux=False,
                                             denom=denom)
        finally:
            if compress is not None:
                self.zero.compress = compress
        return all_reduce_(total, self.zero.tokens) if self.runtime is not None else total


class _DiskTier:
    """The disk tier of one program (port of the single-process half of
    ``_assemble_disk_tier``, ``tpu_engine/train.py``): the device computes
    and clips fp32 gradients on compute-dtype params; a host AdamW
    (:class:`~tpu_engine_torch.disk_offload.DiskAdamW`) updates fp32 masters
    and moments in memmap slabs under ``optimizer_spill_dir`` and uploads
    each new master in the compute dtype.

    The spill persists its applied-step count. When the incoming state's
    step does not continue it (a rollback, a restored checkpoint, a fresh
    run on an old spill), the masters reseed from the state's params with
    the moments zeroed and the bias-correction counter reset, keeping each
    master that still rounds to the incoming value (``reseed_masters``'s
    ``cast_dtype``). With ``disk_update_overlap`` the walk of step N runs
    on a thread while the device computes step N+1 (JAX's one-step-stale
    delayed parameter update).

    On a mesh (stage 3 only, as JAX across processes) each rank is one of
    JAX's processes: it spills its own shards under
    ``<optimizer_spill_dir>/proc<rank>`` and updates them from its
    reduce-scattered gradient shards, and the attach-or-reseed decisions
    are one all-reduce (MIN) of a boolean over the world
    (:meth:`_all_ranks`), so a torn or discontinuous spill on any rank
    reseeds every rank. The steady state skips that collective;
    ``store.consensus_checks`` counts the ones that ran."""

    def __init__(self, prog: TrainProgram):
        cfg = prog.config
        self.prog = prog
        self.device = prog.device
        self.compute_dtype = cfg.compute_dtype()
        self.mesh = prog.zero is not None
        spill = cfg.optimizer_spill_dir
        if self.mesh:
            rank = dist.get_rank()
            spill = os.path.join(cfg.optimizer_spill_dir, f"proc{rank}")
            if rank == 0 and os.path.isdir(cfg.optimizer_spill_dir):
                # A one-process run's flat slabs, never read by this layout.
                for f in os.listdir(cfg.optimizer_spill_dir):
                    if f.endswith(".f32") or f == dsk._META:
                        try:
                            os.remove(os.path.join(cfg.optimizer_spill_dir, f))
                        except OSError:
                            pass
        self.store = dsk.DiskAdamW(spill, b1=cfg.beta1, b2=float(cfg.beta2),
                                   eps=1e-8, weight_decay=cfg.weight_decay)
        self.store.consensus_checks = 0  # discontinuity checks run (JAX's counter)
        shapes = tfm.init_params(prog.model_config, None, device="meta")
        self.whole_shapes = {k: tuple(p.shape) for k, p in shapes.items()}
        if self.mesh:  # the rank's shards
            shapes = prog.zero.place(shapes)
        self.shapes = {k: tuple(p.shape) for k, p in shapes.items()}
        decay = kernel_decay_mask(shapes)
        self.mask = {k: cfg.decay_all_params or decay[k] for k in shapes}
        self.pending: Optional[dsk.WalkInFlight] = None
        self.verified: Optional[int] = None  # the last step applied or checked
        cuda = self.device.type == "cuda"
        self.fetch_stream = torch.cuda.Stream(self.device) if cuda else None
        self.upload_stream = torch.cuda.Stream(self.device) if cuda else None
        self.bytes = {"h2d": 0, "d2h": 0}
        self.walk_s: Optional[float] = None  # the last serial walk's host seconds

    def _all_ranks(self, flag: bool) -> bool:
        """JAX's ``_all_hosts``: True only where every rank says True (one
        all-reduce MIN over the world; ``flag`` itself on one device)."""
        if not self.mesh:
            return flag
        t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return bool(t.item())

    def attach(self) -> bool:
        """Whether a matching clean spill is (or could be) attached, on
        every rank."""
        self.verified = None
        return self._all_ranks(bool(self.store.slabs)
                               or self.store.try_attach(self.shapes, self.mask))

    def state(self, params: dict) -> dict:
        return {"params": params, "step": 0, "lr_scale": 1.0}

    @staticmethod
    def _fetcher(params: dict):
        return lambda k: params[k].detach().to("cpu", torch.float32).numpy()

    def seed(self, masters: dict) -> dict:
        """A fresh spill from ``masters`` (whole leaves; on a mesh the
        rank's shards of them); returns the compute-dtype params."""
        if self.mesh:
            masters = self.prog.zero.place(masters)
        self.store.initialize(self._fetcher(masters), self.mask, shapes=self.shapes,
                              force_fresh=True)
        return self._params({k: p.detach().to(self.compute_dtype) for k, p in masters.items()})

    def _uploader(self) -> dsk.Uploader:
        return dsk.Uploader(self.device, self.compute_dtype, self.upload_stream)

    def _params(self, leaves: dict) -> dict:
        """The state's params from uploaded leaves: each a whole leaf with
        its gradient on one device; on a mesh the rank's shards, no
        gradient (the stream's gathers carry it), and a block is a
        replicated leaf only where it is the whole leaf
        (``disk_offload.is_replicated_upload``)."""
        if not self.mesh:
            return {k: leaves[k].requires_grad_(True) for k in self.shapes}
        z = self.prog.zero
        for k in self.shapes:
            whole = dsk.is_replicated_upload(tuple(leaves[k].shape), self.whole_shapes[k])
            if tuple(leaves[k].shape) != self.shapes[k] or whole != (z.dims[k] is None):
                raise ValueError(f"{k}: uploaded block {tuple(leaves[k].shape)} is not this "
                                 f"rank's shard {self.shapes[k]}")
        return {k: leaves[k] for k in self.shapes}

    def params_from_masters(self) -> dict:
        up = self._uploader()
        try:
            for key, slab in self.store.slabs.items():
                up.emit(key, slab.master)
        finally:
            up.close()
        return self._params(up.result())

    def _grads(self, state: dict, batch: torch.Tensor):
        """fp32 gradients summed over the microbatches and clipped (JAX's
        ``grad_step``: scale min(1, clip / max(norm, 1e-12))), and the
        metrics."""
        prog = self.prog
        if self.mesh:  # the rank's reduce-scattered shards
            loss, grads = prog.mesh_grads(state["params"], batch)
        else:
            loss, grads = accumulate_grads(prog.loss_fn, state["params"], batch)
        grads = {k: g.float() for k, g in grads.items()}
        g_list = list(grads.values())
        norm = prog.zero.grad_norm(grads, global_norm) if self.mesh else global_norm(g_list)
        clip = prog.config.grad_clip_norm
        torch._foreach_mul_(g_list, torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0))
        lr = prog.schedule(state["step"]) * state["lr_scale"]
        return grads, {"loss": loss, "grad_norm": norm, "learning_rate": lr,
                       "step": state["step"] + 1}

    def _grad_fetchers(self, grads: dict) -> dict:
        """Leaf → a call that copies its gradient to the host, on a side
        stream once the gradients are done (the walk's prefetch thread
        calls these one leaf ahead)."""
        if self.fetch_stream is None:
            return dict(grads)
        ready = torch.cuda.current_stream(self.device).record_event()
        side = self.fetch_stream

        def fetch(g):
            with torch.cuda.stream(side):
                side.wait_event(ready)
                return g.to("cpu").numpy()

        return {k: (lambda g=g: fetch(g)) for k, g in grads.items()}

    def _count(self, grads: dict) -> None:
        n = sum(g.numel() for g in grads.values())
        self.bytes["d2h"] += 4 * n
        self.bytes["h2d"] += n * torch.tensor([], dtype=self.compute_dtype).element_size()

    def _ensure_store(self, params: dict) -> None:
        """Attach where a clean matching spill is on every rank; otherwise
        every rank seeds a fresh one from ``params``."""
        if not self.attach():
            self.store.initialize(self._fetcher(params), self.mask, shapes=self.shapes,
                                  force_fresh=True)
        self.verified = None

    def _check_discontinuity(self, state: dict, t: int) -> None:
        """The spill must have applied exactly step t - 1; where it has not
        on any rank, every rank reseeds its masters from the state's params
        (moments zeroed). Skipped once this program applied or checked
        t - 1 itself (every rank takes the same branch)."""
        if self.verified == t - 1:
            return
        self.store.consensus_checks += 1
        needs = self.store.step_on_disk is not None and self.store.step_on_disk != t - 1
        if not self._all_ranks(not needs):
            self.store.reseed_masters(self._fetcher(state["params"]), step=t - 1,
                                      cast_dtype=self.compute_dtype)
        self.verified = t - 1

    def step(self, state: dict, batch: torch.Tensor) -> tuple[dict, dict]:
        if self.prog.config.disk_update_overlap:
            return self._step_overlap(state, batch)
        grads, metrics = self._grads(state, batch)
        t = state["step"] + 1
        if not self.store.slabs:
            self._ensure_store(state["params"])
        self._check_discontinuity(state, t)
        up = self._uploader()
        t0 = time.perf_counter()
        try:
            self.store.update(self._grad_fetchers(grads), metrics["learning_rate"], t, up.emit)
        finally:
            up.close()  # never leak the worker on an update failure
        self.walk_s = time.perf_counter() - t0
        self._count(grads)
        params = self._params(up.result())
        self.verified = t
        return {"params": params, "step": t, "lr_scale": state["lr_scale"]}, metrics

    def _step_overlap(self, state: dict, batch: torch.Tensor) -> tuple[dict, dict]:
        """This step's gradients on the current (one walk stale) params,
        then the previous step's walk joined, then this step's walk started
        on a thread: the returned params lag by exactly the walk in
        flight."""
        grads, metrics = self._grads(state, batch)
        t = state["step"] + 1
        if not self.store.slabs:
            self._ensure_store(state["params"])
        prev, self.pending = self.pending, None
        leaves = None
        if prev is not None:
            if prev.step == state["step"]:
                leaves = prev.join()
            else:  # the state does not continue the walk: abandon it
                prev.discard()
        self._check_discontinuity(state, t)
        self.pending = dsk.WalkInFlight(self.store, self._grad_fetchers(grads),
                                        metrics["learning_rate"], t, self._uploader())
        self._count(grads)
        self.verified = t
        params = state["params"] if leaves is None else self._params(leaves)
        return {"params": params, "step": t, "lr_scale": state["lr_scale"]}, metrics

    def flush(self, state: dict) -> dict:
        walk, self.pending = self.pending, None
        if walk is None:
            return state
        if walk.step != state["step"]:
            walk.discard()
            return state
        return {**state, "params": self._params(walk.join())}


_SCHEDULES = {"gpipe": pipeline.pipeline_gpipe_grads, "1f1b": pipeline_1f1b_grads,
              "zb": pipeline_zb_grads}


def _mesh_refusals(cfg: TrainConfig, model_cfg: ModelConfig) -> None:
    """JAX's ``ValueError``s for the mesh combinations it refuses, with its
    messages; a model that does not split over ``model`` raises
    ``NotImplementedError`` naming the dims (JAX's jit refuses it too)."""
    mesh = cfg.mesh
    if mesh.model > 1:
        if model_cfg.is_moe and model_cfg.moe_impl == "ragged":
            raise ValueError(
                "moe_impl='ragged' does not support expert parallelism "
                "(ragged_dot cannot shard over the expert dim); use "
                "moe_impl='dense' on meshes with a model axis")
        sharding.check_model_axis(model_cfg, mesh.model)
    if mesh.pipe > 1:
        if model_cfg.n_layers % mesh.pipe != 0:
            raise ValueError(f"model n_layers={model_cfg.n_layers} must be divisible by the "
                             f"pipe axis size {mesh.pipe}")
        if cfg.lora_rank is not None:
            raise ValueError("LoRA is not supported with pipeline parallelism")
        if cfg.param_offload == "host":
            raise ValueError(
                "param_offload is not supported with pipeline parallelism "
                "(pipeline stages re-enter their layer block per microbatch; "
                "host-streaming weights per stage visit would thrash PCIe)")
        if cfg.optimizer_offload == "disk":
            raise ValueError(
                "optimizer_offload='disk' with pipeline parallelism is not "
                "supported (the host update walks the flat gradient tree)")
        schedule = sharding.resolve_pipeline_schedule(cfg)
        if schedule in ("1f1b", "zb") and cfg.loss_chunk_size:
            raise ValueError(
                f"loss_chunk_size is not supported with "
                f"pipeline_schedule={schedule!r} (the exit loss "
                "runs inside the schedule's scan)")


def _runtime_for(cfg: TrainConfig, device: torch.device,
                 runtime: Optional[MeshRuntime]) -> Optional[MeshRuntime]:
    """The mesh the program runs on: ``runtime`` if given, else one built
    from ``cfg.mesh`` where this process is one rank of several, else none
    (``cfg.mesh`` must then resolve to one rank). One rank keeps the
    one-device paths of the placements and int8 training."""
    if runtime is None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        runtime = MeshRuntime(cfg.mesh, device=device)
    if runtime is None:
        cfg.mesh.resolved_shape(1)
        return None
    if runtime.device.type != device.type:
        raise ValueError(f"the mesh runs on {runtime.device}, the program on {device}")
    single_paths = (cfg.optimizer_offload != "none" or cfg.param_offload != "none"
                    or cfg.quant_training != "none")
    if single_paths and runtime.n_devices == 1:
        return None
    if (cfg.optimizer_offload == "disk"
            and cfg.sharding_stage < sharding.ShardingStage.FULL_PARTITIONING):
        # JAX's refusal across processes; every rank of the port is one.
        raise ValueError(
            "optimizer_offload='disk' across processes requires "
            "sharding_stage=3 (param and gradient shards must coincide "
            "per host)")
    return runtime


def build_train_program(cfg: TrainConfig, model_cfg: Optional[ModelConfig] = None,
                        device="cuda",
                        base_params: Optional[dict[str, Any]] = None,
                        runtime: Optional[MeshRuntime] = None) -> TrainProgram:
    """The program for ``cfg`` on ``device``. Attention resolves as in JAX
    (``tpu_engine/train.py``): a ``sequence`` axis (the mesh's, or
    ``cfg.sequence``'s ring in this process) is ring attention, or Ulysses
    when asked for (across ranks only); otherwise ``"auto"`` is the flash
    kernels on a CUDA device and the plain path on the CPU, and an
    explicit choice is honoured; ``cfg.sliding_window`` then overrides the
    model's window. ``quant_training`` and its targets resolve onto the
    model config, as in JAX.

    ``base_params`` applies to LoRA only (``cfg.lora_rank``): the frozen base
    to adapt (e.g. ``params_from_jax`` or ``from_hf_llama``), taken in the
    master dtype without gradients; default ``init_params`` from
    ``cfg.seed``.

    ``runtime``: the :class:`~tpu_engine_torch.mesh_runtime.MeshRuntime` to
    run on (a mesh of one rank included); by default one is built from
    ``cfg.mesh`` when this process is one rank of several
    (``initialize_distributed``). The frozen LoRA base stays whole on every
    rank."""
    device = torch.device(device)
    if model_cfg is None:
        if cfg.model_name not in MODEL_CONFIGS:
            raise ValueError(f"unknown model {cfg.model_name!r}; known: {sorted(MODEL_CONFIGS)}")
        model_cfg = MODEL_CONFIGS[cfg.model_name]
    if cfg.moe_impl is not None:
        if not model_cfg.is_moe:
            # Checked before the no-op case: 'dense' on a dense model is as
            # wrong as 'ragged'.
            raise ValueError(f"moe_impl={cfg.moe_impl!r} set on the dense model "
                             f"{model_cfg.name!r} (no experts to dispatch)")
        if model_cfg.moe_impl != cfg.moe_impl:
            model_cfg = model_cfg.with_(moe_impl=cfg.moe_impl)
    if (model_cfg.quant_training != cfg.quant_training
            or model_cfg.quant_train_targets != cfg.quant_train_targets):
        model_cfg = model_cfg.with_(quant_training=cfg.quant_training,
                                    quant_train_targets=cfg.quant_train_targets)
    if (model_cfg.quant_training == "int8" and model_cfg.is_moe
            and model_cfg.moe_impl == "ragged" and "moe" in model_cfg.quant_train_targets):
        # The config check sees moe_impl=None when the model carries ragged.
        raise ValueError(quant_train.RAGGED_MOE_REFUSAL)
    if cfg.remat_policy == "offload_dots" and device.type != "cuda":
        raise ValueError(
            "remat_policy='offload_dots' requires TPU (the CPU SPMD "
            "partitioner cannot compile the policy's host-placement "
            "annotations)"
        )
    tfm._require_ported(model_cfg)
    _mesh_refusals(cfg, model_cfg)
    runtime = _runtime_for(cfg, device, runtime)
    seq_size = runtime.axis_sizes["sequence"] if runtime is not None else 1
    if seq_size > 1 or cfg.sequence > 1:
        impl = "ulysses" if cfg.attention_impl == "ulysses" else "ring"
    elif cfg.attention_impl == "auto":
        impl = "flash" if device.type == "cuda" else "xla"
    else:
        impl = cfg.attention_impl
    if impl == "ulysses":
        if seq_size == 1:
            raise NotImplementedError(
                "attention_impl='ulysses' runs across ranks only (a mesh with "
                "sequence > 1): one process has no all-to-all")
        n_model = runtime.axis_sizes["model"]
        local_heads = model_cfg.n_heads // n_model
        if local_heads % seq_size != 0:
            raise ValueError(
                f"attention_impl='ulysses' needs the per-device head count "
                f"({model_cfg.n_heads} heads / model axis {n_model} = {local_heads}) "
                f"divisible by the sequence axis size {seq_size}")
    if model_cfg.attention_impl != impl:
        model_cfg = model_cfg.with_(attention_impl=impl)
    if cfg.sliding_window is not None and model_cfg.sliding_window != cfg.sliding_window:
        model_cfg = model_cfg.with_(sliding_window=cfg.sliding_window)
    # Reject window × sequence parallelism at build time, as JAX does,
    # rather than at the first step deep inside _attention.
    if model_cfg.sliding_window and impl in ("ring", "ulysses"):
        raise ValueError(
            f"sliding_window={model_cfg.sliding_window} is not supported with "
            f"attention_impl={impl!r} (a windowed model has no use for "
            "full-sequence context parallelism); set sequence=1 or sliding_window=0"
        )
    if comm_compress.enabled(cfg):
        sizes = runtime.axis_sizes if runtime is not None else dict.fromkeys(
            ("pipe", "sequence", "model"), 1)
        comm_compress.validate_runtime(cfg, sizes, model_cfg, impl)
        if runtime is None:
            raise NotImplementedError(
                "comm compression runs on a mesh runtime (a process group, or "
                "runtime=MeshRuntime(...) of one rank): one device has no collective")
    if cfg.grad_allreduce_dtype not in (None, "fp32") and cfg.param_offload == "host":
        raise ValueError(
            "grad_allreduce_dtype with param_offload=host is not supported: "
            "offloaded layers already stream in the compute dtype, and the "
            "host-resident master tree cannot be re-cast in device code")
    if cfg.lora_rank is not None:
        lora_mod.validate_targets(model_cfg, cfg.lora_targets)
        if cfg.param_offload == "host":
            raise ValueError(
                "param_offload is not supported with LoRA (the trainable "
                "adapters are rank-sized; offloading them saves nothing and the "
                "frozen base is better streamed via its own placement)"
            )
        if base_params is None:
            gen = torch.Generator(device=device).manual_seed(cfg.seed)
            base_params = tfm.init_params(model_cfg, gen, device)
        base_params = {k: v.detach().to(device=device, dtype=cfg.master_dtype())
                       for k, v in base_params.items()}
    else:
        base_params = None
    tx, schedule = make_optimizer(cfg)
    prog = TrainProgram(config=cfg, model_config=model_cfg, device=device, tx=tx,
                        schedule=schedule, base_params=base_params,
                        walk=UpdateWalk(device, host_params=cfg.param_offload == "host",
                                        host_state=cfg.optimizer_offload == "host"),
                        pipeline_schedule=sharding.resolve_pipeline_schedule(cfg))
    if runtime is not None:
        _bind_mesh(prog, runtime)
    if cfg.param_offload == "host" and prog.stream is None:
        prog.host = HostParams(device, cfg.compute_dtype())
    if cfg.optimizer_offload == "disk":
        prog.disk = _DiskTier(prog)
    return prog


def _bind_mesh(prog: TrainProgram, runtime: MeshRuntime) -> None:
    """Put ``prog`` on ``runtime``'s mesh: its ZeRO layout of the trainable
    tree (the adapters under LoRA, as JAX's ``train_logical``) and, at
    stage 3, its layer stream; refuses what the mesh step does not run."""
    cfg, mc = prog.config, prog.model_config
    n_seq = runtime.axis_sizes["sequence"]
    if cfg.seq_len % n_seq:
        raise ValueError(f"mesh.sequence={n_seq} must divide seq_len={cfg.seq_len}")
    if cfg.loss_chunk_size and (cfg.seq_len // n_seq) % cfg.loss_chunk_size:
        raise ValueError(f"loss_chunk_size={cfg.loss_chunk_size} must divide a rank's "
                         f"{cfg.seq_len // n_seq} positions (seq_len / sequence)")
    logical = sharding.logical_axes(mc)
    targets = cfg.lora_targets if cfg.lora_rank is not None else ()
    shapes = sharding.whole_shapes(mc, targets, cfg.lora_rank or 1)
    if cfg.lora_rank is not None:
        logical = sharding.lora_logical_axes(logical, cfg.lora_targets)
        shapes = {k: shapes[k] for k in logical}
    whole = dict(shapes)
    prog.runtime = runtime
    if runtime.axis_sizes["pipe"] > 1:
        prog.pipe = pipeline.Stage(runtime, mc)
        shapes = prog.pipe.shapes(shapes)
        logical = {k: logical[k] for k in shapes}
    z = prog.zero = zero.ZeroLayout(runtime, cfg.sharding_stage, logical, shapes, mc)
    if prog.pipe is not None:
        z.pipe, z.norm_skip = prog.pipe.group, prog.pipe.norm_skip(shapes)
    if cfg.grad_allreduce_dtype not in (None, "fp32"):
        z.comm_dtype = _DTYPES[cfg.grad_allreduce_dtype]
    if comm_compress.enabled(cfg):
        plans = comm_compress.build_leaf_plans(sharding.param_pspecs(logical, 3), shapes,
                                               runtime.axis_sizes["fsdp"], cfg.comm_quant_weights)
        z.compress = comm_compress.Compression(
            runtime, plans, cfg.comm_quant_block_size, quant_weights=cfg.comm_quant_weights,
            secondary_weights=cfg.comm_secondary_weights, quant_grads=cfg.comm_quant_grads)
    if z.params_split:
        prog.stream = zero.ShardedParams(z, prog.device, cfg.compute_dtype())
    if prog.base_params is not None and z.model is not None:
        # The frozen base as the products take it: the rank's model blocks.
        prog.base_params = {k: v.clone() for k, v in model_block(
            prog.base_params, mc, z.n_model, z.i_model).items()}
    if isinstance(prog.tx, Adafactor):
        _adafactor_splits(prog.tx, z, whole, prog.pipe is not None)


def _adafactor_splits(tx: "Adafactor", z: zero.ZeroLayout, whole: dict, piped: bool) -> None:
    """Tell Adafactor the whole shape of each leaf and the dims of the
    optimizer's view that ``model`` and (its state split, stage >= 1)
    ``fsdp`` split, with their groups."""
    tx.shapes = whole
    tx.splits = {}
    for k in z.dims:
        if piped and 0 in (factored_dims(whole[k]) or ()):
            raise NotImplementedError(
                f"optimizer='adafactor' with pipe > 1: {k}'s factored moment reduces over "
                "its layers, which pipe splits")
        splits = []
        if z.mdims[k] is not None:
            splits.append((z.mdims[k], z.model, z.n_model))
        if z.state_split and z.dims[k] is not None:
            splits.append((z.dims[k], z.fsdp, z.n_fsdp))
        tx.splits[k] = splits
