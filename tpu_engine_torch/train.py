"""Single-GPU training program: schedule, AdamW, loss and the train step
(port of the single-device path of ``tpu_engine/train.py``).

The JAX step is one jitted function over a pytree state; here the state is a
dict of tensors and the step runs eagerly. The optimizer updates the fp32
master weights in place (saving the second copy JAX's functional update
makes), and gradients accumulate in the masters' ``.grad`` across the
microbatches of a step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from tpu_engine_torch.models import transformer as tfm
from tpu_engine_torch.models.config import MODEL_CONFIGS, ModelConfig

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


@dataclass
class TrainConfig:
    """The single-device fields of ``TPUTrainConfig`` (``tpu_engine/sharding.py``),
    with its defaults. Values the port does not support raise."""

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
    beta2: float = 0.95
    grad_clip_norm: float = 1.0
    decay_all_params: bool = False
    activation_checkpointing: bool = True
    loss_chunk_size: Optional[int] = None
    z_loss_coef: float = 0.0
    attention_impl: str = "auto"     # auto | xla | flash
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
            (self.attention_impl in ("auto", "xla", "flash"),
             f"attention_impl={self.attention_impl!r}: auto, xla or flash "
             "(ring/ulysses are multi-GPU, not ported)"),
            (self.loss_chunk_size is None
             or (self.loss_chunk_size >= 1 and self.seq_len % self.loss_chunk_size == 0),
             f"loss_chunk_size={self.loss_chunk_size} must divide seq_len={self.seq_len}"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)

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
    """Weight decay applies to matmul kernels only (path ends in ``kernel``),
    not to norm scales or embeddings. (JAX's mask also decays LoRA factors,
    which the port does not have yet.)"""
    return {k: k.rsplit(".", 1)[-1] == "kernel" for k in params}


@dataclass
class AdamW:
    """optax ``chain(clip_by_global_norm, scale_by_adam(eps=1e-8, mu_dtype),
    add_decayed_weights(mask))`` followed by ``p - lr·u``, written on tensors.

    Clipping scales only when the norm exceeds the max (optax's rule, which
    is not ``clip_grad_norm_``'s). With a bf16 ``mu_dtype`` the update uses
    the fp32 first moment and only the stored moment rounds, as in optax."""

    b1: float
    b2: float
    weight_decay: float
    grad_clip_norm: float
    mu_dtype: Optional[torch.dtype]
    decay_all_params: bool
    eps: float = 1e-8

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        }

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
        state["count"] += 1
        bc1 = 1 - self.b1 ** state["count"]
        bc2 = 1 - self.b2 ** state["count"]
        decay = kernel_decay_mask(params)
        for k, g in zip(keys, g_list):
            p, mu, nu = params[k], state["mu"][k], state["nu"][k]
            mu32 = mu.float() if mu.dtype != torch.float32 else mu
            mu32.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (mu32 / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            if self.weight_decay and (self.decay_all_params or decay[k]):
                u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)
            if mu32 is not mu:
                mu.copy_(mu32)
        return g_norm


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ‖t‖²) over a list of tensors, as a 0-d fp32 tensor."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def make_optimizer(cfg: TrainConfig) -> tuple[AdamW, Callable[[int], float]]:
    """AdamW and the schedule. The learning rate is applied by the step:
    ``lr = schedule(step) · lr_scale``, as in the JAX train step."""
    mu_dtype = _DTYPES[cfg.moment_dtype] if cfg.moment_dtype is not None else None
    tx = AdamW(b1=cfg.beta1, b2=cfg.beta2, weight_decay=cfg.weight_decay,
               grad_clip_norm=cfg.grad_clip_norm, mu_dtype=mu_dtype,
               decay_all_params=cfg.decay_all_params)
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
    loss and gradients are the global mean. Gradients accumulate in the
    masters' ``.grad`` (fp32). Returns the summed loss (0-d tensor)."""
    denom = torch.clamp(torch.sum((batch[:, :, 1:] >= 0).float()), min=1.0)
    for p in params.values():
        p.grad = None
    total = torch.zeros((), dtype=torch.float32, device=batch.device)
    for tokens in batch:
        loss = loss_fn(params, tokens, include_aux=True, denom=denom)
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
    [accum, micro_batch, seq_len] int64 on the program's device."""

    config: TrainConfig
    model_config: ModelConfig
    device: torch.device
    tx: AdamW = field(repr=False)
    schedule: Callable[[int], float] = field(repr=False)

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
        """Fresh state from ``params`` (e.g. ``params_from_jax``) or a random
        init drawn from ``generator`` (default: seeded by ``config.seed``)."""
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(self.config.seed)
            params = tfm.init_params(self.model_config, generator, self.device)
        return {
            "params": params,
            "opt_state": self.tx.init(params),
            "step": 0,
            "lr_scale": 1.0,
        }

    def loss_fn(self, params, raw_tokens, include_aux: bool = True, denom=None):
        """Masked LM loss of one microbatch: its own valid-target mean, or
        raw sums over ``denom`` when summing over microbatches."""
        cfg = self.config
        tokens, loss_tokens = decode_masked_tokens(raw_tokens)
        hidden, _ = tfm.forward_hidden_and_aux(
            params, tokens, self.model_config, compute_dtype=cfg.compute_dtype(),
            remat=cfg.activation_checkpointing,
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
    def eval_step(self, state: dict, batch: torch.Tensor) -> torch.Tensor:
        """Held-out loss over one [accum, B, S] batch: pure cross-entropy."""
        denom = torch.clamp(torch.sum((batch[:, :, 1:] >= 0).float()), min=1.0)
        total = torch.zeros((), dtype=torch.float32, device=batch.device)
        for tokens in batch:
            total = total + self.loss_fn(state["params"], tokens, include_aux=False,
                                         denom=denom)
        return total


def build_train_program(cfg: TrainConfig, model_cfg: Optional[ModelConfig] = None,
                        device="cuda") -> TrainProgram:
    """The program for ``cfg`` on ``device``. ``attention_impl="auto"`` is the
    flash kernels on a CUDA device and the plain path on the CPU."""
    device = torch.device(device)
    if model_cfg is None:
        if cfg.model_name not in MODEL_CONFIGS:
            raise ValueError(f"unknown model {cfg.model_name!r}; known: {sorted(MODEL_CONFIGS)}")
        model_cfg = MODEL_CONFIGS[cfg.model_name]
    tfm._require_llama(model_cfg)
    if cfg.attention_impl == "auto":
        impl = "flash" if device.type == "cuda" else "xla"
    else:
        impl = cfg.attention_impl
    if model_cfg.attention_impl != impl:
        model_cfg = model_cfg.with_(attention_impl=impl)
    tx, schedule = make_optimizer(cfg)
    return TrainProgram(config=cfg, model_config=model_cfg, device=device, tx=tx,
                        schedule=schedule)
