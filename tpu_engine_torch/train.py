"""Single-GPU training program: schedule, optimizers (AdamW, Adafactor,
Lion), loss and the train step (port of the single-device path of
``tpu_engine/train.py``, and of its sequence-parallel path with the ring's
ranks in one process). MoE models train with the router's aux loss in the
objective; ``quant_training="int8"`` runs the targeted products in int8
(``tpu_engine_torch/quant_train.py``); ``lora_rank`` trains LoRA adapters on
a frozen base (``tpu_engine_torch/lora.py``).

The JAX step is one jitted function over a pytree state; here the state is a
dict of tensors and the step runs eagerly. The optimizer updates the fp32
master weights in place (saving the second copy JAX's functional update
makes), and gradients accumulate in the masters' ``.grad`` across the
microbatches of a step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tpu_engine_torch import lora as lora_mod
from tpu_engine_torch import quant_train
from tpu_engine_torch.models import transformer as tfm
from tpu_engine_torch.models.config import MODEL_CONFIGS, ModelConfig

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


class _DefaultFloat(float):
    """A field's default value, told apart from the same value set
    explicitly (JAX reads ``model_fields_set``): Adafactor takes ``beta2``
    as its decay exponent only when it was set."""


_DEFAULT_BETA2 = _DefaultFloat(0.95)


@dataclass
class TrainConfig:
    """The single-device fields of ``TPUTrainConfig`` (``tpu_engine/sharding.py``),
    with its defaults, and ``sequence``, the counterpart of
    ``MeshConfig.sequence``: the ring size of sequence-parallel attention.
    Values the port does not support raise."""

    model_name: str = "gpt-125m"
    micro_batch_size: int = 1
    gradient_accumulation_steps: int = 1
    seq_len: int = 2048
    precision: str = "bf16"          # compute dtype
    param_dtype: str = "fp32"        # master weights
    moment_dtype: Optional[str] = None  # Adam mu dtype (None = master dtype)
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
    seed: int = 0

    def __post_init__(self):
        # Enum-valued fields of the JAX config arrive as str subclasses.
        for name in ("precision", "param_dtype", "moment_dtype"):
            val = getattr(self, name)
            if val is not None:
                setattr(self, name, getattr(val, "value", val))
        checks = [
            (self.micro_batch_size >= 1, "micro_batch_size must be >= 1"),
            (self.gradient_accumulation_steps >= 1, "gradient_accumulation_steps must be >= 1"),
            (self.seq_len >= 2, "seq_len must be >= 2"),
            (self.precision in _DTYPES, f"precision={self.precision!r}: bf16 or fp32"),
            (self.param_dtype == "fp32", f"param_dtype={self.param_dtype!r}: only fp32 is ported"),
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
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)
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

    @property
    def beta2_is_set(self) -> bool:
        """Whether ``beta2`` was given (JAX: ``"beta2" in
        cfg.model_fields_set``)."""
        return not isinstance(self.beta2, _DefaultFloat)

    def lora_scale(self) -> float:
        return self.lora_alpha / self.lora_rank if self.lora_rank is not None else 1.0

    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.precision]


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
    state in place and returns the update u of one leaf).

    Clipping scales only when the norm exceeds the max (optax's rule, which
    is not ``clip_grad_norm_``'s)."""

    weight_decay: float
    grad_clip_norm: float
    decay_all_params: bool

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
               state: dict, lr: float) -> torch.Tensor:
        """Apply one update in place to ``params`` and ``state``; ``grads``
        must already hold the raw (unclipped) gradients, and are clipped in
        place. Returns the global norm of the raw gradients."""
        keys = list(params)
        g_list = [grads[k] for k in keys]
        g_norm = global_norm(g_list)
        factor = torch.where(g_norm < self.grad_clip_norm, torch.ones_like(g_norm),
                             self.grad_clip_norm / g_norm)
        torch._foreach_mul_(g_list, factor)
        count = state["count"]
        state["count"] += 1
        decay = kernel_decay_mask(params)
        for k, g in zip(keys, g_list):
            p = params[k]
            u = self.scale(k, g, p, state, count)
            if self.weight_decay and (self.decay_all_params or decay[k]):
                u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)
        return g_norm

    def state_bytes(self, state: dict) -> int:
        """Bytes of the optimizer's tensors (moments, factored statistics)."""
        return sum(t.numel() * t.element_size() for name, tree in state.items()
                   if name != "count" for t in tree.values())


@dataclass
class AdamW(_Chain):
    """``scale_by_adam(b1, b2, eps=1e-8, mu_dtype)``. With a bf16
    ``mu_dtype`` the update uses the fp32 first moment and only the stored
    moment rounds, as in optax."""

    b1: float = 0.9
    b2: float = 0.95
    mu_dtype: Optional[torch.dtype] = None
    eps: float = 1e-8

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    def scale(self, k, g, p, state, count):
        mu, nu = state["mu"][k], state["nu"][k]
        bc1 = 1 - self.b1 ** (count + 1)
        bc2 = 1 - self.b2 ** (count + 1)
        mu32 = mu.float() if mu.dtype != torch.float32 else mu
        mu32.mul_(self.b1).add_(g, alpha=1 - self.b1)
        nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
        u = (mu32 / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
        if mu32 is not mu:
            mu.copy_(mu32)
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
    decay ``1 - (t + 1) ** -decay_rate`` at count t."""

    decay_rate: float = 0.8
    epsilon: float = 1e-30

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        v_row, v_col, v = {}, {}, {}
        for k, p in params.items():
            dims = factored_dims(p.shape)
            if dims is None:
                v[k] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                v_row[k] = torch.zeros_like(p.select(d0, 0))
                v_col[k] = torch.zeros_like(p.select(d1, 0))
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    def scale(self, k, g, p, state, count):
        # optax computes the decay in fp32: 1 - float32(t + 1) ** -rate.
        beta = np.float32(1.0) - np.float32(count + 1) ** np.float32(-self.decay_rate)
        beta, rest = float(beta), float(np.float32(1.0) - beta)
        grad_sqr = g * g + self.epsilon
        dims = factored_dims(p.shape)
        if dims is None:
            v = state["v"][k]
            v.mul_(beta).add_(grad_sqr, alpha=rest)
            return g * v.rsqrt()
        d1, d0 = dims
        v_row, v_col = state["v_row"][k], state["v_col"][k]
        v_row.mul_(beta).add_(grad_sqr.mean(dim=d0), alpha=rest)
        v_col.mul_(beta).add_(grad_sqr.mean(dim=d1), alpha=rest)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)).rsqrt()
        return g * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)


@dataclass
class Lion(_Chain):
    """optax ``scale_by_lion(b1, b2, mu_dtype)``: the update is
    sign((1 - b1)·g + b1·μ), then μ ← b2·μ + (1 - b2)·g (one moment)."""

    b1: float = 0.9
    b2: float = 0.99
    mu_dtype: Optional[torch.dtype] = None

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                       for k, p in params.items()}}

    def scale(self, k, g, p, state, count):
        mu = state["mu"][k]

        def decayed(b):
            # optax's b·μ is in μ's dtype, b rounded to it (a bf16 product
            # for a bf16 moment), before the fp32 sum.
            return (mu * torch.tensor(b, dtype=mu.dtype, device=mu.device)).float()

        u = torch.sign(g * (1 - self.b1) + decayed(self.b1))
        mu.copy_(g * (1 - self.b2) + decayed(self.b2))
        return u


Optimizer = Union[AdamW, Adafactor, Lion]


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ‖t‖²) over a list of tensors, as a 0-d fp32 tensor."""
    norms = torch._foreach_norm([t.float() for t in tensors])
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


def _ce_sums(logits: torch.Tensor, tokens: torch.Tensor):
    """Raw next-token CE sums (Σ log-likelihood, Σ logZ², valid count);
    targets < 0 are excluded."""
    targets = tokens[:, 1:]
    valid = (targets >= 0).float()
    logits = logits[:, :-1, :].float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets.clamp(min=0)[..., None].long()).squeeze(-1) - logz
    return torch.sum(ll * valid), torch.sum(logz * logz * valid), torch.sum(valid)


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


def _chunk_sums(params, hc, tc, model_cfg):
    logits = tfm.unembed(params, hc, model_cfg)
    logz = torch.logsumexp(logits, dim=-1)
    mask = (tc >= 0).float()
    ll = torch.gather(logits, -1, tc.clamp(min=0)[..., None].long()).squeeze(-1) - logz
    return torch.sum(ll * mask), torch.sum(logz * logz * mask), torch.sum(mask)


def _chunked_ce_sums(params, hidden, tokens, model_cfg: ModelConfig, chunk: int):
    """The sums of :func:`_ce_sums`, ``chunk`` positions at a time; each
    chunk is checkpointed so its fp32 logits are recomputed in backward
    rather than kept."""
    B, S, _ = hidden.shape
    tgt = torch.cat([tokens[:, 1:], torch.full((B, 1), -1, dtype=tokens.dtype,
                                               device=tokens.device)], dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    ll_total, z_total, n_total = zero, zero, zero
    for c in range(0, S, chunk):
        ll, zz, n = checkpoint(_chunk_sums, params, hidden[:, c:c + chunk],
                               tgt[:, c:c + chunk], model_cfg, use_reentrant=False)
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


def accumulate_grads(loss_fn, params: dict[str, torch.Tensor], batch: torch.Tensor):
    """Gradient accumulation over ``batch`` [accum, B, S]: each microbatch's
    raw sums are divided by the batch-wide valid-target count, so the summed
    loss and gradients are the global mean, and its MoE aux term is weighted
    1/accum, so the summed aux is the mean over microbatches. Gradients
    accumulate in the masters' ``.grad`` (fp32). Returns the summed loss
    (0-d tensor)."""
    denom = torch.clamp(torch.sum((batch[:, :, 1:] >= 0).float()), min=1.0)
    for p in params.values():
        p.grad = None
    total = torch.zeros((), dtype=torch.float32, device=batch.device)
    for tokens in batch:
        loss = loss_fn(params, tokens, include_aux=True, denom=denom,
                       aux_weight=1.0 / batch.shape[0])
        loss.backward()
        total = total + loss.detach()
    return total


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
    folds them into the base for ``generate`` and the batcher."""

    config: TrainConfig
    model_config: ModelConfig
    device: torch.device
    tx: Optimizer = field(repr=False)
    schedule: Callable[[int], float] = field(repr=False)
    base_params: Optional[dict[str, torch.Tensor]] = field(default=None, repr=False)

    def global_batch_shape(self) -> tuple[int, int, int]:
        c = self.config
        return (c.gradient_accumulation_steps, c.micro_batch_size, c.seq_len)

    def synthetic_batch(self, seed: int = 0) -> torch.Tensor:
        """Deterministic random tokens (its numbers differ from the JAX
        program's for the same seed)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randint(0, self.model_config.vocab_size, self.global_batch_shape(),
                             generator=gen, device=self.device)

    def init(self, params: Optional[dict[str, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None) -> dict:
        """Fresh state from ``params`` (e.g. ``params_from_jax``; with LoRA
        the adapters, e.g. ``lora_from_jax``) or a random init drawn from
        ``generator`` (default: seeded by ``config.seed``)."""
        if params is None:
            cfg = self.config
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
            if self.base_params is not None:
                params = lora_mod.init_lora_params(generator, self.model_config, cfg.lora_rank,
                                                   cfg.lora_targets, self.device)
            else:
                params = tfm.init_params(self.model_config, generator, self.device)
        return {
            "params": params,
            "opt_state": self.tx.init(params),
            "step": 0,
            "lr_scale": 1.0,
        }

    def loss_fn(self, params, raw_tokens, include_aux: bool = True, denom=None,
                aux_weight: float = 1.0):
        """Masked LM loss of one microbatch: its own valid-target mean, or
        raw sums over ``denom`` when summing over microbatches. With
        ``include_aux`` (training; the held-out loss has none) it adds the
        z-loss and, for MoE, ``aux_weight · router_aux_coef · aux``."""
        cfg = self.config
        lora = None
        if self.base_params is not None:  # the trainable params are the adapters
            params, lora = self.base_params, params
        tokens, loss_tokens = decode_masked_tokens(raw_tokens)
        hidden, aux = tfm.forward_hidden_and_aux(
            params, tokens, self.model_config, compute_dtype=cfg.compute_dtype(),
            remat=cfg.activation_checkpointing, sequence=cfg.sequence,
            remat_policy=cfg.remat_policy, lora=lora, lora_scale=cfg.lora_scale(),
        )
        if cfg.loss_chunk_size:
            ll_sum, z_sum, n_valid = _chunked_ce_sums(
                params, hidden, loss_tokens, self.model_config, cfg.loss_chunk_size)
        else:
            ll_sum, z_sum, n_valid = _ce_sums(
                tfm.unembed(params, hidden, self.model_config), loss_tokens)
        d = torch.clamp(n_valid, min=1.0) if denom is None else denom
        loss = -ll_sum / d
        z_coef = cfg.z_loss_coef if include_aux else 0.0
        if z_coef:
            loss = loss + z_coef * z_sum / d
        if self.model_config.is_moe and include_aux:
            loss = loss + aux_weight * self.model_config.router_aux_coef * aux
        return loss

    def step(self, state: dict, batch: torch.Tensor) -> tuple[dict, dict]:
        """One optimizer step. Metrics are device tensors (no host sync)
        except ``learning_rate`` and ``step``, which the host knows."""
        params = state["params"]
        loss = accumulate_grads(self.loss_fn, params, batch)
        grads = {k: p.grad for k, p in params.items()}
        lr = self.schedule(state["step"]) * state["lr_scale"]
        grad_norm = self.tx.update(params, grads, state["opt_state"], lr)
        for p in params.values():
            p.grad = None
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "learning_rate": lr, "step": state["step"]}

    @torch.no_grad()
    def merged_params(self, adapters: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """LoRA only: the base with ``adapters`` (``state["params"]``)
        merged (``lora.merge_lora``), every leaf in the compute dtype, for
        ``generate`` and the ``ContinuousBatcher``."""
        if self.base_params is None:
            raise ValueError("merged_params needs a LoRA program (lora_rank set)")
        cfg = self.config
        merged = lora_mod.merge_lora(self.base_params, adapters, cfg.lora_alpha, cfg.lora_rank)
        return {k: v.to(cfg.compute_dtype()) for k, v in merged.items()}

    @torch.no_grad()
    def eval_step(self, state: dict, batch: torch.Tensor) -> torch.Tensor:
        """Held-out loss over one [accum, B, S] batch: pure cross-entropy."""
        denom = torch.clamp(torch.sum((batch[:, :, 1:] >= 0).float()), min=1.0)
        total = torch.zeros((), dtype=torch.float32, device=batch.device)
        for tokens in batch:
            total = total + self.loss_fn(state["params"], tokens, include_aux=False,
                                         denom=denom)
        return total


def build_train_program(cfg: TrainConfig, model_cfg: Optional[ModelConfig] = None,
                        device="cuda",
                        base_params: Optional[dict[str, Any]] = None) -> TrainProgram:
    """The program for ``cfg`` on ``device``. Attention resolves as in JAX
    (``tpu_engine/train.py``): ``sequence > 1`` is ring attention (Ulysses
    when asked for, which is not ported and raises); otherwise ``"auto"`` is
    the flash kernels on a CUDA device and the plain path on the CPU, and an
    explicit choice is honoured. ``quant_training`` and its targets resolve
    onto the model config, as in JAX.

    ``base_params`` applies to LoRA only (``cfg.lora_rank``): the frozen base
    to adapt (e.g. ``params_from_jax`` or ``from_hf_llama``), taken in the
    master dtype without gradients; default ``init_params`` from
    ``cfg.seed``."""
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
    if cfg.remat_policy == "offload_dots":
        if device.type != "cuda":
            raise ValueError(
                "remat_policy='offload_dots' requires TPU (the CPU SPMD "
                "partitioner cannot compile the policy's host-placement "
                "annotations)"
            )
        raise NotImplementedError(
            "remat_policy='offload_dots' is not ported to CUDA (queued in ROADMAP.md)")
    tfm._require_ported(model_cfg)
    if cfg.sequence > 1:
        impl = "ulysses" if cfg.attention_impl == "ulysses" else "ring"
    elif cfg.attention_impl == "auto":
        impl = "flash" if device.type == "cuda" else "xla"
    else:
        impl = cfg.attention_impl
    if impl == "ulysses":
        raise NotImplementedError(
            "attention_impl='ulysses' is not ported (queued with multi-GPU)")
    if model_cfg.attention_impl != impl:
        model_cfg = model_cfg.with_(attention_impl=impl)
    # Reject window × sequence parallelism at build time, as JAX does,
    # rather than at the first step deep inside _attention.
    if model_cfg.sliding_window and impl == "ring":
        raise ValueError(
            f"sliding_window={model_cfg.sliding_window} is not supported with "
            f"attention_impl={impl!r} (a windowed model has no use for "
            "full-sequence context parallelism); set sequence=1 or sliding_window=0"
        )
    if cfg.lora_rank is not None:
        lora_mod.validate_targets(model_cfg, cfg.lora_targets)
        if base_params is None:
            gen = torch.Generator(device=device).manual_seed(cfg.seed)
            base_params = tfm.init_params(model_cfg, gen, device)
        base_params = {k: v.detach().to(device=device, dtype=torch.float32)
                       for k, v in base_params.items()}
    else:
        base_params = None
    tx, schedule = make_optimizer(cfg)
    return TrainProgram(config=cfg, model_config=model_cfg, device=device, tx=tx,
                        schedule=schedule, base_params=base_params)
