"""Decoder-only llama transformer in PyTorch (port of
``tpu_engine/models/transformer.py``, dense llama arch).

Parameters are the flat dict of :mod:`tpu_engine_torch.models.convert`:
the JAX leaves, shapes and ``[in, out]`` kernel layout, with every per-layer
weight stacked on a leading ``[L, ...]`` axis. The forward pass is plain
functions on tensors. Heavy products run in the compute dtype (bf16 on the
card) with fp32 accumulation; norms, RoPE and softmax run in fp32.

Activation checkpointing (JAX ``jax.checkpoint`` with ``nothing_saveable``
around each scanned block) is ``torch.utils.checkpoint`` around each block:
only the block's input is kept, and the block is recomputed in backward.

Other archs (gpt2, gemma, qwen), MoE, LoRA and quantized weights are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_engine_torch.models.config import MODEL_CONFIGS, ModelConfig  # noqa: F401
from tpu_engine_torch.models.convert import LLAMA_KEYS
from tpu_engine_torch.ops import flash_attention

LAYER_KEYS = tuple(k[len("layers."):] for k in LLAMA_KEYS if k.startswith("layers."))


def _require_llama(cfg: ModelConfig) -> None:
    if cfg.arch != "llama" or cfg.is_moe or cfg.quant_training != "none":
        raise NotImplementedError(
            f"{cfg.name}: arch={cfg.arch!r}, n_experts={cfg.n_experts}, "
            f"quant_training={cfg.quant_training!r} is not ported "
            "(slice 1 is the dense llama arch)"
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Random llama parameters with the JAX init scales: normal(0.02), the
    residual-out projections (o, down) at 0.02/sqrt(2L), norm scales 1.
    ``generator`` must live on ``device``. The numbers differ from JAX's for
    the same seed; parity tests move weights with ``params_from_jax``."""
    _require_llama(cfg)
    L, D, V, F_ = cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.d_ff
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std = 0.02
    res_std = std / (2 * L) ** 0.5

    def norm(shape, s):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, s, generator=generator).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    shapes = {
        "embed.embedding": lambda: norm((V, D), std),
        "layers.attn_norm.scale": lambda: ones((L, D)),
        "layers.q.kernel": lambda: norm((L, D, H * HD), std),
        "layers.k.kernel": lambda: norm((L, D, KV * HD), std),
        "layers.v.kernel": lambda: norm((L, D, KV * HD), std),
        "layers.o.kernel": lambda: norm((L, H * HD, D), res_std),
        "layers.mlp_norm.scale": lambda: ones((L, D)),
        "layers.gate.kernel": lambda: norm((L, D, F_), std),
        "layers.up.kernel": lambda: norm((L, D, F_), std),
        "layers.down.kernel": lambda: norm((L, F_, D), res_std),
        "final_norm.scale": lambda: ones((D,)),
        "lm_head.kernel": lambda: norm((D, V), std),
    }
    return {k: shapes[k]().requires_grad_(True) for k in LLAMA_KEYS}


def param_count(cfg: ModelConfig) -> int:
    L, D, V, F_ = cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.d_ff
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.arch == "gpt2":
        attn = 4 * D * D + 4 * D
        mlp = 2 * D * F_ + F_ + D
        per_layer = attn + mlp + 4 * D
        return V * D + cfg.max_seq_len * D + L * per_layer + 2 * D
    mlp = 3 * D * F_ * (cfg.n_experts if cfg.is_moe else 1)
    router = D * cfg.n_experts if cfg.is_moe else 0
    per_layer = D * H * HD + 2 * D * KV * HD + H * HD * D + mlp + router + 2 * D
    if cfg.arch == "qwen":
        per_layer += 2 * HD
    head = 0 if cfg.arch == "gemma" else D * V
    return V * D + L * per_layer + D + head


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (top-k experts only for MoE)."""
    if not cfg.is_moe:
        return param_count(cfg)
    L, D, F_ = cfg.n_layers, cfg.d_model, cfg.d_ff
    return param_count(cfg) - L * 3 * D * F_ * (cfg.n_experts - cfg.top_k)


def train_flops_per_token(cfg: ModelConfig, seq_len: int) -> float:
    """Training FLOPs/token: 6·N_matmul + 12·L·D·min(S, window) attention."""
    if cfg.arch == "gpt2":
        n = active_param_count(cfg) - cfg.max_seq_len * cfg.d_model
    elif cfg.arch == "gemma":
        n = active_param_count(cfg)
    else:
        n = active_param_count(cfg) - cfg.vocab_size * cfg.d_model
    attn_ctx = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    return 6.0 * n + 12.0 * cfg.n_layers * cfg.d_model * attn_ctx


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings (split-half form). x: [B, S, H, HD], positions [B, S]."""
    half = x.shape[-1] // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device)
        * (log_theta.to(x.device) / half)
    )
    angles = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _attention(q, k, v, impl: str, window: int = 0):
    """Causal attention: ``"flash"`` (CUDA kernels; their plain versions on
    CPU tensors) or ``"xla"`` (plain PyTorch)."""
    if impl not in ("flash", "xla"):
        raise NotImplementedError(f"attention_impl={impl!r} is not ported")
    return flash_attention.mha(q, k, v, causal=True, force_xla=(impl != "flash"),
                               window=window)


def _proj(h: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``h @ W``: h [B, S, in], kernel [in, out] → [B, S, out]."""
    return torch.matmul(h, kernel)


def _dense_mlp(h: torch.Tensor, lp: dict[str, torch.Tensor]) -> torch.Tensor:
    """SwiGLU: down(silu(h·gate) ∘ h·up)."""
    gate = _proj(h, lp["gate.kernel"])
    up = _proj(h, lp["up.kernel"])
    return _proj(F.silu(gate) * up, lp["down.kernel"])


def _block(x: torch.Tensor, lp: dict[str, torch.Tensor], cfg: ModelConfig,
           positions: torch.Tensor) -> torch.Tensor:
    """One llama block. x: [B, S, D] → [B, S, D]."""
    B, S, _ = x.shape
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = _rms_norm(x, lp["attn_norm.scale"], cfg.norm_eps)
    q = _proj(h, lp["q.kernel"]).reshape(B, S, H, HD)
    k = _proj(h, lp["k.kernel"]).reshape(B, S, KV, HD)
    v = _proj(h, lp["v.kernel"]).reshape(B, S, KV, HD)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    attn = _attention(q, k, v, cfg.attention_impl, window=cfg.sliding_window)
    x = x + _proj(attn.reshape(B, S, H * HD), lp["o.kernel"])
    h = _rms_norm(x, lp["mlp_norm.scale"], cfg.norm_eps)
    return x + _dense_mlp(h, lp)


def embed_tokens(params: dict[str, torch.Tensor], tokens: torch.Tensor,
                 compute_dtype=torch.bfloat16, *, cfg: ModelConfig) -> torch.Tensor:
    """tokens [..., S] int → activations [..., S, D] in the compute dtype.

    The rows are gathered from the master table and then cast, which gives
    the same values as JAX's cast-then-gather while its backward scatters
    into fp32 rather than into a compute-dtype copy of the whole table."""
    _require_llama(cfg)
    return F.embedding(tokens, params["embed.embedding"]).to(compute_dtype)


def _head_grads_f32(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """(g @ wᵀ, xᵀ @ g) in fp32 for bf16 x [N, D], w [D, V] and an fp32
    cotangent g [N, V]. g is split into two bf16 terms, hi + lo, which hold
    about 16 of its 24 significant bits; each of the four bf16 products
    accumulates in fp32. This stands in for JAX's fp32 transpose of the head
    at twice the bf16 cost, where one bf16 rounding of g would lose 16 bits."""
    f32 = torch.float32
    hi = g.to(x.dtype)
    lo = (g - hi.float()).to(x.dtype)
    wt, xt = w.t(), x.t()
    dx = torch.mm(hi, wt, out_dtype=f32).add_(torch.mm(lo, wt, out_dtype=f32))
    dw = torch.mm(xt, hi, out_dtype=f32).add_(torch.mm(xt, lo, out_dtype=f32))
    return dx, dw


class _MatmulF32Out(torch.autograd.Function):
    """x [N, D] @ w [D, V] with bf16 operands and an fp32 result (the JAX
    ``preferred_element_type=float32`` head); the backward keeps the fp32
    cotangent (see :func:`_head_grads_f32`) and rounds only the gradients
    to the operands' dtype, as JAX's transpose does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _head_grads_f32(x, w, g)
        return dx.to(x.dtype), dw.to(w.dtype)


def _matmul_f32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last dim with an fp32 result. bf16 on the card
    takes ``torch.mm(..., out_dtype=float32)``; on the CPU, where that
    overload does not exist, the operands are upcast (the same products,
    since bf16 values are exact in fp32)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda:
        lead = x.shape[:-1]
        out = _MatmulF32Out.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*lead, w.shape[-1])
    return torch.matmul(x.float(), w.float())


def unembed(params: dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm + LM head: [..., S, D] → logits [..., S, V] fp32."""
    _require_llama(cfg)
    x = _rms_norm(x, params["final_norm.scale"].to(x.dtype), cfg.norm_eps)
    return _matmul_f32_out(x, params["lm_head.kernel"].to(x.dtype))


def cast_layer_stack(params: dict[str, torch.Tensor],
                     compute_dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """The stacked per-layer params cast to the compute dtype, once per call.
    Gradients flow back through the cast onto the fp32 masters."""
    return {k: params["layers." + k].to(compute_dtype) for k in LAYER_KEYS}


def forward_hidden_and_aux(
    params: dict[str, torch.Tensor],
    tokens: torch.Tensor,
    cfg: ModelConfig,
    compute_dtype=torch.bfloat16,
    remat: bool = False,
    positions: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decoder stack only: tokens [B, S] → (hidden [B, S, D] in the compute
    dtype, before the final norm; the mean MoE aux loss, 0 for dense)."""
    _require_llama(cfg)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = embed_tokens(params, tokens, compute_dtype, cfg=cfg)
    stack = cast_layer_stack(params, compute_dtype)
    # One unbind per leaf: its backward stacks the L per-layer gradients in a
    # single op, where per-layer indexing would scatter into L full copies.
    layers = {k: torch.unbind(t, 0) for k, t in stack.items()}
    for i in range(cfg.n_layers):
        lp = {k: layers[k][i] for k in LAYER_KEYS}
        if remat:
            x = checkpoint(_block, x, lp, cfg, positions, use_reentrant=False)
        else:
            x = _block(x, lp, cfg, positions)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward_and_aux(params, tokens, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                    remat: bool = False, positions=None):
    """tokens [B, S] → (logits [B, S, V] fp32, aux loss scalar)."""
    x, aux = forward_hidden_and_aux(params, tokens, cfg, compute_dtype=compute_dtype,
                                    remat=remat, positions=positions)
    return unembed(params, x, cfg), aux


def forward(params, tokens, cfg: ModelConfig, compute_dtype=torch.bfloat16,
            remat: bool = False, positions=None) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] fp32."""
    logits, _ = forward_and_aux(params, tokens, cfg, compute_dtype=compute_dtype,
                                remat=remat, positions=positions)
    return logits


__all__ = [
    "ModelConfig", "MODEL_CONFIGS", "init_params", "param_count",
    "active_param_count", "train_flops_per_token", "embed_tokens", "unembed",
    "cast_layer_stack", "forward_hidden_and_aux", "forward_and_aux", "forward",
]
