"""Decoder-only transformer in PyTorch (port of
``tpu_engine/models/transformer.py``: the dense llama, gpt2, qwen and gemma
archs, and llama with a Mixture-of-Experts MLP).

Parameters are the flat dict of :mod:`tpu_engine_torch.models.convert`:
the JAX leaves, shapes and ``[in, out]`` kernel layout, with every per-layer
weight stacked on a leading ``[L, ...]`` axis. The forward pass is plain
functions on tensors. Heavy products run in the compute dtype (bf16 on the
card) with fp32 accumulation; norms, RoPE and softmax run in fp32.

The archs differ as in JAX: llama is RMSNorm, RoPE, SwiGLU and an untied
head; gpt2 LayerNorm with bias, biased projections, no RoPE, a learned
position table added at embedding, a GELU-tanh fc/proj MLP and the head tied
to the token embedding; qwen is llama with a per-head RMSNorm of q and k
before RoPE; gemma stores norm scales as offsets from 1, scales the
embedding by sqrt(d_model), uses GeGLU and ties the head.

Activation checkpointing (JAX ``jax.checkpoint`` around each scanned
block, under a ``remat_policy``) is ``torch.utils.checkpoint`` around each
block. ``nothing_saveable`` keeps only the block's input and recomputes the
block in backward; ``everything_saveable`` keeps everything (no
checkpoint); the ``dots_*`` policies keep the products' outputs through a
selective-checkpoint policy over the aten ops (``mm``/``addmm``/``_int_mm``
have no batch dims, ``bmm`` has), which, like JAX's policies with a Pallas
call, never sees the flash kernels; the named policies split the block at
the tensors JAX tags (q, k, v after RoPE, ``attn_out``) and checkpoint each
piece, so what crosses a cut is what is kept.

Attention is ``"flash"`` (the CUDA kernels), ``"xla"`` (plain PyTorch) or
``"ring"`` (sequence-parallel ring attention over ``sequence`` ranks, all in
this process; ``tpu_engine_torch/parallel/ring_attention.py``). Where JAX
threads the mesh down to ``_attention``, the port threads the ring size, and
``"ring"`` without one raises ``ValueError`` as JAX does without a mesh.

MoE (``cfg.n_experts > 0``) routes each token to its top-k experts, by
dense dispatch (``moe_impl="dense"``: a per-expert capacity, tokens over it
dropped, all dispatch and combine as products) or ragged dispatch
(``"ragged"``: tokens sorted by expert, one product per expert's rows, no
capacity); both return the Switch load-balancing aux loss. A projection or
expert kernel may be an int8 :class:`~tpu_engine_torch.quant.QuantWeight`
(weight-only quantized serving).

Quantised training (``quant_training="int8"``) routes the targeted products
through :func:`tpu_engine_torch.quant_train.int8_einsum` (:func:`_train_dot`).
LoRA adapters (``tpu_engine_torch/lora.py``) add ``scale·(h@A)@B`` inside
each adapted projection. ``offload_dots`` keeps the products' outputs in
host memory instead of on the device. With host-resident masters
(``param_offload``) each block reads its layer through a ``layer_stream``
(:class:`tpu_engine_torch.offload.HostParams`) inside its checkpoint, so
the recompute streams the layer again (the mesh program's stage 3 gathers
its shards the same way). On a mesh (``tpu_engine_torch/mesh_runtime.py``)
ring and Ulysses attention run across the ranks of its ``sequence`` axis;
in one process Ulysses raises ``NotImplementedError``. Over its ``model``
axis (``tpu_engine_torch/parallel/tensor_parallel.py``) the params are the
rank's blocks: q, k, v and the gate/up (gpt2's fc) columns are
column-parallel behind ``f``, o and down (proj) row-parallel and summed by
``g`` (gpt2's o and proj biases added once, after the sum), attention runs
on the rank's heads, the MoE runs the rank's experts on every token and
sums their combine by ``g``, and the embedding and head are
vocabulary-parallel.
"""

from __future__ import annotations

import collections
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tpu_engine_torch import offload
from tpu_engine_torch.mesh_runtime import TOKEN_AXES
from tpu_engine_torch.models.config import MODEL_CONFIGS, ModelConfig  # noqa: F401
from tpu_engine_torch.models.convert import param_keys
from tpu_engine_torch.ops import flash_attention
from tpu_engine_torch.parallel.collectives import all_reduce_, all_reduce_sum
from tpu_engine_torch.parallel.tensor_parallel import (
    copy_to,
    model_axis,
    reduce_from,
    replicated_share,
    vocab_embed,
)
from tpu_engine_torch.parallel.ring_attention import ring_mha, ring_mha_group
from tpu_engine_torch.parallel.ulysses_attention import ulysses_mha_group
from tpu_engine_torch.quant import QuantWeight, dequantize_weight, mul_round
from tpu_engine_torch.quant_train import RAGGED_MOE_REFUSAL, int8_einsum


def _require_ported(cfg: ModelConfig) -> None:
    """Refuse an arch/MoE pair outside ``MODEL_CONFIGS``' families
    (:func:`param_keys`)."""
    param_keys(cfg)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Random parameters of ``cfg``'s arch with JAX's tree and init scales:
    normal(0.02) (MoE's router and gate/up experts too), the residual-out
    projections (o, down, proj; MoE's down experts) at
    0.02/sqrt(2L), gpt2's position table at 0.01, biases 0, norm scales 1
    (gemma's, stored as offsets from 1, 0). ``generator`` must live on
    ``device``. The numbers differ from JAX's for the same seed; parity
    tests move weights with ``params_from_jax``."""
    _require_ported(cfg)
    L, D, V, F_ = cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.d_ff
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.arch == "gpt2":
        KV = H  # gpt2's k and v are full width
    std = 0.02
    res_std = std / (2 * L) ** 0.5

    def norm(shape, s):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, s, generator=generator).to(dtype)

    def const(value):
        return lambda shape: torch.full(shape, value, dtype=dtype, device=device)

    ones, zeros = const(1.0), const(0.0)
    scale = zeros if cfg.arch == "gemma" else ones
    E = cfg.n_experts
    experts = (E,) if cfg.is_moe else ()  # MoE stacks [L, E, ...] expert kernels
    shapes = {
        "embed.embedding": lambda: norm((V, D), std),
        "pos_embed.embedding": lambda: norm((cfg.max_seq_len, D), 0.01),
        "layers.attn_norm.scale": lambda: scale((L, D)),
        "layers.attn_norm.bias": lambda: zeros((L, D)),
        "layers.q.kernel": lambda: norm((L, D, H * HD), std),
        "layers.q.bias": lambda: zeros((L, H * HD)),
        "layers.k.kernel": lambda: norm((L, D, KV * HD), std),
        "layers.k.bias": lambda: zeros((L, KV * HD)),
        "layers.v.kernel": lambda: norm((L, D, KV * HD), std),
        "layers.v.bias": lambda: zeros((L, KV * HD)),
        "layers.o.kernel": lambda: norm((L, H * HD, D), res_std),
        "layers.o.bias": lambda: zeros((L, D)),
        "layers.q_norm.scale": lambda: ones((L, HD)),
        "layers.k_norm.scale": lambda: ones((L, HD)),
        "layers.mlp_norm.scale": lambda: scale((L, D)),
        "layers.mlp_norm.bias": lambda: zeros((L, D)),
        "layers.router.kernel": lambda: norm((L, D, E), std),
        "layers.gate.kernel": lambda: norm((L, *experts, D, F_), std),
        "layers.up.kernel": lambda: norm((L, *experts, D, F_), std),
        "layers.down.kernel": lambda: norm((L, *experts, F_, D), res_std),
        "layers.fc.kernel": lambda: norm((L, D, F_), std),
        "layers.fc.bias": lambda: zeros((L, F_)),
        "layers.proj.kernel": lambda: norm((L, F_, D), res_std),
        "layers.proj.bias": lambda: zeros((L, D)),
        "final_norm.scale": lambda: scale((D,)),
        "final_norm.bias": lambda: zeros((D,)),
        "lm_head.kernel": lambda: norm((D, V), std),
    }
    return {k: shapes[k]().requires_grad_(True) for k in param_keys(cfg)}


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


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Mean-subtracting LayerNorm with bias (gpt2), in fp32."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
          cfg: ModelConfig) -> torch.Tensor:
    """The arch's norm: LayerNorm with ``bias`` (gpt2), RMSNorm with the
    stored scale as an offset from 1 (gemma: ``scale``, already in the
    compute dtype, plus 1 in fp32, as JAX orders it), or RMSNorm."""
    if cfg.arch == "gpt2":
        return _layer_norm(x, scale, bias, cfg.norm_eps)
    if cfg.arch == "gemma":
        return _rms_norm(x, scale.float() + 1.0, cfg.norm_eps)
    return _rms_norm(x, scale, cfg.norm_eps)


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


def _attention(q, k, v, impl: str, window: int = 0, sequence: Optional[int] = None,
               mesh=None):
    """Causal attention dispatch:

    - ``"ring"`` / ``"ulysses"`` with a ``mesh``
      (:class:`~tpu_engine_torch.mesh_runtime.MeshRuntime`) whose
      ``sequence`` axis has ranks: this rank's shard of ring attention
      (``ring_mha_group``) or Ulysses attention (``ulysses_mha_group``)
      over that axis;
    - ``"ring"`` without one: ring attention over ``sequence`` ranks in
      this process (required: JAX's ring requires a mesh);
    - ``"flash"``: the CUDA kernels (their plain versions on CPU tensors);
    - ``"xla"``: plain PyTorch.

    ``window > 0`` is sliding-window attention, on the flash and xla paths
    only: sequence parallelism is full-context by construction."""
    if impl in ("ring", "ulysses"):
        if window:
            raise ValueError(
                f"sliding_window is not supported with attention_impl={impl!r}; "
                "use 'flash' or 'xla' (a windowed model has no use for "
                "full-sequence context parallelism)"
            )
        if mesh is not None and mesh.axis_sizes["sequence"] > 1:
            across = ring_mha_group if impl == "ring" else ulysses_mha_group
            return across(q, k, v, mesh.group("sequence"), causal=True)
        if sequence is None:
            raise ValueError(f"attention_impl={impl!r} requires a mesh "
                             "(in the port, its ring size: sequence=N)")
        if impl == "ulysses":
            raise NotImplementedError(
                "attention_impl='ulysses' runs across ranks only (a mesh with "
                "sequence > 1): one process has no all-to-all")
        return ring_mha(q, k, v, sequence=sequence, causal=True)
    if impl not in ("flash", "xla"):
        raise NotImplementedError(f"attention_impl={impl!r} is not ported")
    return flash_attention.mha(q, k, v, causal=True, force_xla=(impl != "flash"),
                               window=window)


def _train_dot(cfg: ModelConfig, group: str):
    """The quantised-dot hook of one product group ("attn", "mlp", "moe"):
    :func:`~tpu_engine_torch.quant_train.int8_einsum` when
    ``cfg.quant_training == "int8"`` and ``group`` is targeted, else None
    (the call site's plain product)."""
    if cfg.quant_training == "int8" and group in cfg.quant_train_targets:
        return int8_einsum
    return None


def _proj(h: torch.Tensor, kernel, bias: Optional[torch.Tensor] = None, lora_ab=None,
          lora_scale: float = 1.0, dot=None) -> torch.Tensor:
    """``h @ W (+ b)``: h [B, S, in], kernel [in, out] → [B, S, out].

    An int8 :class:`QuantWeight` kernel multiplies its codes cast to h's
    dtype (exact: |code| <= 127), then applies the per-output-channel scale
    to the product in fp32 with one rounding, as JAX does (rounding the
    scale to bf16 first would add a second error). ``dot`` (quantised
    training, :func:`_train_dot`) takes the main product of a float kernel.
    ``lora_ab`` = (A [in, r], B [r, out]) adds ``lora_scale·(h@A)@B``, the
    activation-side form: only rank-sized intermediates, never a full ΔW;
    it bypasses ``dot``, as in JAX."""
    if isinstance(kernel, QuantWeight):
        out = mul_round(torch.matmul(h, kernel.q.to(h.dtype)), kernel.scale, h.dtype)
    elif dot is not None:
        out = dot("bsi,io->bso", h, kernel)
    else:
        out = torch.matmul(h, kernel)
    if bias is not None:
        out = out + bias.to(out.dtype)
    if lora_ab is not None:
        a, b = lora_ab
        out = out + lora_scale * torch.matmul(torch.matmul(h, a), b)
    return out


def _layer_proj(h: torch.Tensor, lp: dict[str, torch.Tensor], name: str, dot=None,
                lora_scale: float = 1.0) -> torch.Tensor:
    """The layer's projection ``name`` with its bias, where the arch has one
    (gpt2), and its LoRA adapter, where ``lp`` holds one (``name.A``,
    ``name.B``)."""
    a = lp.get(f"{name}.A")
    return _proj(h, lp[f"{name}.kernel"], lp.get(f"{name}.bias"),
                 None if a is None else (a, lp[f"{name}.B"]), lora_scale, dot)


def _row_proj(h: torch.Tensor, lp: dict[str, torch.Tensor], name: str, dot=None,
              lora_scale: float = 1.0, tp=None) -> torch.Tensor:
    """A row-parallel projection (o, down, proj): each ``model`` rank's
    product over its rows, summed by ``g``, then the bias added once."""
    if tp is None:
        return _layer_proj(h, lp, name, dot, lora_scale)
    # A LoRA term rides inside the sum: the rank's rows of A give a partial
    # x·A, so (Σ x_i·A_i)·B = Σ (x_i·A_i)·B (B's gradient is partial).
    a = lp.get(f"{name}.A")
    out = reduce_from(_proj(h, lp[f"{name}.kernel"], None,
                            None if a is None else (a, lp[f"{name}.B"]), lora_scale, dot), tp)
    bias = lp.get(f"{name}.bias")
    return out if bias is None else out + bias.to(out.dtype)


def _dense_mlp(h: torch.Tensor, lp: dict[str, torch.Tensor], cfg: ModelConfig,
               lora_scale: float = 1.0, tp=None) -> torch.Tensor:
    """The MLP of the training and the decode block: SwiGLU (llama, qwen),
    biased GELU-tanh fc/proj (gpt2), GeGLU (gemma). h [B, S, D], normed.
    The "mlp" group of quantised training, in both blocks, as in JAX.
    ``tp``: the rank's columns of gate/up (fc) behind ``f``, its rows of
    down (proj) summed by ``g``."""
    dot = _train_dot(cfg, "mlp")
    h = copy_to(h, tp)

    def proj(x, name):
        return _layer_proj(x, lp, name, dot, lora_scale)

    if cfg.arch == "gpt2":
        return _row_proj(F.gelu(proj(h, "fc"), approximate="tanh"), lp, "proj", dot,
                         lora_scale, tp)
    gate = proj(h, "gate")
    up = proj(h, "up")
    act = F.gelu(gate, approximate="tanh") if cfg.arch == "gemma" else F.silu(gate)
    return _row_proj(act * up, lp, "down", dot, lora_scale, tp)


def _qkv(h: torch.Tensor, lp: dict[str, torch.Tensor], cfg: ModelConfig,
         positions: torch.Tensor, dot=None, lora_scale: float = 1.0, tp=None,
         kv_local: bool = True):
    """q [B, S, H, HD], k and v [B, S, KV, HD] of the normed input h: qwen's
    per-head RMSNorm of q and k, then RoPE (not gpt2, whose positions are
    added at embedding). Shared with the decode block, which passes no
    ``dot``: JAX's decode projections skip the "attn" hook. ``tp``: the
    rank's heads (H/model; its kv heads, behind ``f``); where K and V stay
    whole, ``kv_local`` computes only the kv head the rank reads, else
    every kv head (the decode block's whole cache)."""
    B, S, _ = h.shape
    HD = cfg.head_dim
    h = copy_to(h, tp)

    def kv(name):
        if tp is None or tp.kv_split or not kv_local:
            return _layer_proj(h, lp, name, dot, lora_scale)
        cols = (tp.kv_first * HD, tp.kv_count * HD)
        bias, a = lp.get(f"{name}.bias"), lp.get(f"{name}.A")
        return _proj(h, lp[f"{name}.kernel"].narrow(-1, *cols),
                     None if bias is None else bias.narrow(-1, *cols),
                     None if a is None else (a, lp[f"{name}.B"].narrow(-1, *cols)),
                     lora_scale, dot)

    q = _layer_proj(h, lp, "q", dot, lora_scale).reshape(B, S, -1, HD)
    k = kv("k").reshape(B, S, -1, HD)
    v = kv("v").reshape(B, S, -1, HD)
    if cfg.arch == "qwen":
        q = _rms_norm(q, lp["q_norm.scale"], cfg.norm_eps)
        k = _rms_norm(k, lp["k_norm.scale"], cfg.norm_eps)
    if cfg.arch != "gpt2":
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expert_kernel(lp: dict, name: str, dtype: torch.dtype) -> torch.Tensor:
    """The stacked [E, ...] expert kernel ``name`` in ``dtype``; an int8
    one dequantized (fp32 product, one rounding), as JAX's MoE paths do."""
    w = lp[f"{name}.kernel"]
    return dequantize_weight(w, dtype) if isinstance(w, QuantWeight) else w


def _router_probs(h: torch.Tensor, lp: dict) -> torch.Tensor:
    """Router softmax over the experts, fp32: h [..., D] → [..., E]. The
    router product takes compute-dtype operands and an fp32 result."""
    return torch.softmax(_matmul_f32_out(h, lp["router.kernel"]), dim=-1)


def _switch_aux(probs: torch.Tensor, first: torch.Tensor, E: int, mesh=None) -> torch.Tensor:
    """Switch load-balancing loss (eq. 4): E · Σ_e f_e · p_e, with f the
    share of tokens whose first choice is e (no gradient) and p the mean
    router probability. probs [..., E], first [...] expert ids. On a
    ``mesh`` the means run over the whole microbatch, as in JAX: the
    per-expert sums are all-reduced over the ranks that hold its tokens
    before the product (the probabilities' sum differentiably, so each rank
    gets the gradient of its own tokens)."""
    group = mesh.group(TOKEN_AXES) if mesh is not None else None
    if group is None:
        f = F.one_hot(first.reshape(-1), E).float().mean(dim=0)
        p = probs.reshape(-1, E).mean(dim=0)
        return E * torch.sum(f * p)
    n = first.numel() * mesh.size(TOKEN_AXES)
    f = all_reduce_(F.one_hot(first.reshape(-1), E).float().sum(dim=0), group) / n
    p = all_reduce_sum(probs.reshape(-1, E).sum(dim=0), group) / n
    return E * torch.sum(f * p)


def _moe_mlp(h: torch.Tensor, lp: dict, cfg: ModelConfig, mesh=None):
    """Top-k MoE by dense dispatch (JAX ``_moe_mlp``): h [B, S, D] →
    (out [B, S, D], aux).

    Each expert takes at most ``expert_capacity(S)`` tokens of a sequence.
    Choices are placed one rank at a time, so every first choice claims
    capacity before any second choice; within a rank a token's position in
    its expert's buffer is the count of earlier tokens of its row that
    chose that expert (a cumsum over S in fp32). Tokens past capacity drop;
    the kept gates are renormalised to sum to 1 (floor 1e-9). Dispatch and
    combine are products with the [B, S, E, C] masks, in the compute dtype.
    ``mesh``: the aux loss's means run over the mesh's microbatch
    (:func:`_switch_aux`). Over its ``model`` axis (expert parallelism)
    every rank routes every token alike and runs its ``E/model`` experts on
    its slice of the dispatch; the partial combine is summed by ``g``. The
    router's gradient is then a part on each rank (summed over ``model``
    by the program), so the aux loss, whole on every rank, enters it at
    ``1/model`` (:func:`replicated_share`)."""
    B, S, D = h.shape
    E, K = cfg.n_experts, cfg.top_k
    C = cfg.expert_capacity(S)
    tp = model_axis(mesh, cfg)
    h = copy_to(h, tp)
    probs = _router_probs(h, lp)  # [B, S, E] fp32
    remaining = probs
    count = torch.zeros((B, E), dtype=torch.float32, device=h.device)
    combine = torch.zeros((B, S, E, C), dtype=h.dtype, device=h.device)
    slots = torch.arange(C, device=h.device)
    for _ in range(K):
        idx = torch.argmax(remaining, dim=-1)                # first maximum, as jnp.argmax
        mask = F.one_hot(idx, E).float()                     # [B, S, E]
        gate = torch.sum(probs * mask, dim=-1)               # [B, S]
        pos = torch.cumsum(mask, dim=1) - 1 + count[:, None, :]
        pos_tok = torch.sum(pos * mask, dim=-1)              # [B, S]
        keep = (pos_tok < C) & (gate > 0)
        count = count + mask.sum(dim=1)
        # One-hot of the buffer position; a position past C has none.
        onehot_pos = (pos_tok.long()[..., None] == slots).float()  # [B, S, C]
        contrib = ((gate * keep)[:, :, None, None] * mask[:, :, :, None]
                   * onehot_pos[:, :, None, :])
        combine = combine + contrib.to(h.dtype)
        remaining = remaining * (1.0 - mask)
    denom = torch.sum(combine, dim=(2, 3), keepdim=True)
    combine = combine / denom.clamp_min(1e-9)
    if tp is not None:  # this rank's experts
        n = E // tp.size
        combine = combine[:, :, tp.index * n:(tp.index + 1) * n]
    dispatch = (combine > 0).to(h.dtype)
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, h)
    gate_w, up_w, down_w = (_expert_kernel(lp, n, h.dtype) for n in ("gate", "up", "down"))
    dot = _train_dot(cfg, "moe")
    if dot is not None:  # the expert products only; routing stays in full precision
        act = F.silu(dot("ebcd,edf->ebcf", expert_in, gate_w)) * dot(
            "ebcd,edf->ebcf", expert_in, up_w)
        expert_out = dot("ebcf,efd->ebcd", act, down_w)
    else:
        expert_in = expert_in.reshape(-1, B * C, D)
        act = F.silu(torch.bmm(expert_in, gate_w)) * torch.bmm(expert_in, up_w)
        expert_out = torch.bmm(act, down_w).reshape(-1, B, C, D)
    out = reduce_from(torch.einsum("bsec,ebcd->bsd", combine, expert_out), tp)
    aux = _switch_aux(probs, torch.argmax(probs, dim=-1), E, mesh)
    return out, replicated_share(aux, tp)


def _moe_mlp_ragged(h: torch.Tensor, lp: dict, cfg: ModelConfig, mesh=None):
    """Top-k MoE by ragged dispatch (JAX ``_moe_mlp_ragged``): h [B, S, D]
    → (out [B, S, D], aux). No capacity, so no token drops. The B·S·k
    (token, expert) pairs are sorted by expert (a stable sort); each
    expert's contiguous rows take one product with its kernels (one host
    read of the group sizes per call); the outputs, weighted by the
    renormalised top-k gates, are added back to their tokens
    (``index_add``). Routing indices carry no gradient."""
    if cfg.quant_training == "int8" and "moe" in cfg.quant_train_targets:
        raise ValueError(RAGGED_MOE_REFUSAL)
    B, S, D = h.shape
    E, K = cfg.n_experts, cfg.top_k
    x = h.reshape(B * S, D)
    probs = _router_probs(x, lp)                              # [BS, E] fp32
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)      # [BS, K]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    flat_expert = expert_idx.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    tok_sorted = order // K                                   # pair → token
    xs = x.index_select(0, tok_sorted)
    sizes = torch.bincount(flat_expert, minlength=E).tolist()
    # unbind: its backward stacks the E per-expert gradients in one op.
    per_expert = {n: lp[f"{n}.kernel"].unbind(0) for n in ("gate", "up", "down")}
    ys = []
    for e, rows in enumerate(torch.split(xs, sizes)):
        if not sizes[e]:
            continue
        ke = {n: (dequantize_weight(k[e], h.dtype) if isinstance(k[e], QuantWeight) else k[e])
              for n, k in per_expert.items()}
        ys.append(torch.matmul(F.silu(rows @ ke["gate"]) * (rows @ ke["up"]), ke["down"]))
    y = torch.cat(ys)                                         # [BS·K, D]
    weights = gate_vals.reshape(-1)[order].to(h.dtype)
    out = torch.zeros_like(x).index_add(0, tok_sorted, y * weights[:, None])
    return out.reshape(B, S, D), _switch_aux(probs, expert_idx[:, 0], E, mesh)


def _layer_params(lp):
    """A block's layer params: the dict itself, or a layer stream's layer
    (a callable, called inside the checkpointed piece that reads it)."""
    return lp() if callable(lp) else lp


def _block_qkv(x: torch.Tensor, lp: dict, cfg: ModelConfig, positions: torch.Tensor,
               lora_scale: float = 1.0, mesh=None):
    """The block's q, k, v (after RoPE): JAX's tags "q", "k", "v"."""
    lp = _layer_params(lp)
    h = _norm(x, lp["attn_norm.scale"], lp.get("attn_norm.bias"), cfg)
    return _qkv(h, lp, cfg, positions, _train_dot(cfg, "attn"), lora_scale,
                model_axis(mesh, cfg))


def _block_attn(q, k, v, cfg: ModelConfig, sequence: Optional[int] = None,
                mesh=None) -> torch.Tensor:
    """Attention over the block's q, k, v → [B, S, H·HD]: JAX's tag
    "attn_out"."""
    B, S = q.shape[:2]
    attn = _attention(q, k, v, cfg.attention_impl, window=cfg.sliding_window,
                      sequence=sequence, mesh=mesh)
    return attn.reshape(B, S, -1)


def _block_attn_out(x, lp: dict, cfg: ModelConfig, positions, sequence=None,
                    lora_scale: float = 1.0, mesh=None) -> torch.Tensor:
    return _block_attn(*_block_qkv(x, lp, cfg, positions, lora_scale, mesh), cfg, sequence,
                       mesh)


def _block_tail(x: torch.Tensor, attn: torch.Tensor, lp: dict, cfg: ModelConfig,
                lora_scale: float = 1.0, mesh=None):
    """The output projection, residual and MLP over the block's input x and
    its attention output → (x, the MoE aux loss, or None for a dense MLP)."""
    lp = _layer_params(lp)
    tp = model_axis(mesh, cfg)
    x = x + _row_proj(attn, lp, "o", _train_dot(cfg, "attn"), lora_scale, tp)
    h = _norm(x, lp["mlp_norm.scale"], lp.get("mlp_norm.bias"), cfg)
    if cfg.is_moe:
        if cfg.moe_impl not in ("dense", "ragged"):
            raise ValueError(f"moe_impl={cfg.moe_impl!r} unknown; use 'dense' or 'ragged'")
        moe = _moe_mlp_ragged if cfg.moe_impl == "ragged" else _moe_mlp
        out, aux = moe(h, lp, cfg, mesh)
        return x + out, aux
    return x + _dense_mlp(h, lp, cfg, lora_scale, tp), None


def _block(x: torch.Tensor, lp: dict, cfg: ModelConfig,
           positions: torch.Tensor, sequence: Optional[int] = None,
           lora_scale: float = 1.0, mesh=None):
    """One transformer block. x: [B, S, D] → (x, the MoE aux loss, or None
    for a dense MLP). ``lp`` may hold LoRA adapters (``q.A``, ``q.B``, ...),
    scaled by ``lora_scale``, or be a layer stream's callable. ``mesh``
    (a :class:`~tpu_engine_torch.mesh_runtime.MeshRuntime`) reaches the
    attention across ranks and the MoE aux loss."""
    lp = _layer_params(lp)
    attn = _block_attn_out(x, lp, cfg, positions, sequence, lora_scale, mesh)
    return _block_tail(x, attn, lp, cfg, lora_scale, mesh)


# JAX's remat policies (``tpu_engine/models/transformer.py``
# ``_REMAT_POLICIES``).
REMAT_POLICIES = ("nothing_saveable", "dots_saveable", "dots_with_no_batch_dims_saveable",
                  "everything_saveable", "save_attn_out", "save_qkv_attn_out",
                  "offload_dots")
# The aten products a dots policy keeps: XLA's dot_general without batch
# dims lowers to these (a projection [B, S, in] @ [in, out] is one mm) ...
_DOTS_NO_BATCH = frozenset({"mm", "addmm", "_int_mm"})
# ... and with batch dims (attention's plain path, the MoE expert products).
_DOTS_BATCH = frozenset({"bmm", "baddbmm"})


def resolve_remat_policy(name: str) -> str:
    """Strict policy lookup: a typo raises rather than training with
    another memory profile."""
    if name not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {name!r}; valid: {sorted(REMAT_POLICIES)}"
        )
    return name


def _dots_policy(ops: frozenset):
    def policy(ctx, func, *args, **kwargs):
        if func.overloadpacket.__name__ in ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


class _DotsToHost(TorchDispatchMode):
    """The forward half of ``offload_dots``: each product without batch dims
    (:data:`_DOTS_NO_BATCH`) runs, and its output joins ``store`` in the
    device's :func:`~tpu_engine_torch.offload.host_stash`."""

    def __init__(self, store: collections.deque):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _DOTS_NO_BATCH:
            self.store.append(offload.host_stash(out.device).put(out))
        return out


class _DotsFromHost(TorchDispatchMode):
    """The recompute half: each such product returns its stored output,
    taken back to the device, in place of running; every other op runs."""

    def __init__(self, store: collections.deque):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in _DOTS_NO_BATCH:
            return offload.host_stash(args[0].device).get(self.store.popleft())
        return func(*args, **(kwargs or {}))


def _offload_dots_contexts():
    store: collections.deque = collections.deque()
    return _DotsToHost(store), _DotsFromHost(store)


def _remat_block(policy: str, x, lp: dict, cfg: ModelConfig, positions, sequence,
                 lora_scale: float, mesh=None):
    """:func:`_block` under the remat ``policy`` (:data:`REMAT_POLICIES`).

    ``offload_dots`` is JAX's ``offload_dot_with_no_batch_dims("device",
    "pinned_host")``: the selective checkpoint of
    ``dots_with_no_batch_dims_saveable`` with its cache in host memory (a
    pair of dispatch modes, as the selective checkpoint's own; a product's
    output is no saved tensor of the product, so a saved-tensor hook could
    not single it out). Like JAX's policies it never sees the flash
    kernels. The training program refuses it on the CPU, as JAX does; the
    forward takes it there with plain host copies."""
    if policy == "everything_saveable":
        return _block(x, lp, cfg, positions, sequence, lora_scale, mesh)
    if policy == "nothing_saveable":
        return checkpoint(_block, x, lp, cfg, positions, sequence, lora_scale, mesh,
                          use_reentrant=False)
    if policy in ("dots_saveable", "dots_with_no_batch_dims_saveable"):
        ops = _DOTS_NO_BATCH | (_DOTS_BATCH if policy == "dots_saveable" else frozenset())
        return checkpoint(_block, x, lp, cfg, positions, sequence, lora_scale, mesh,
                          use_reentrant=False,
                          context_fn=partial(create_selective_checkpoint_contexts,
                                             _dots_policy(ops)))
    if policy == "offload_dots":
        return checkpoint(_block, x, lp, cfg, positions, sequence, lora_scale, mesh,
                          use_reentrant=False, context_fn=_offload_dots_contexts)
    # The named policies: each piece of the block split at the tags is
    # checkpointed, so the tagged tensors (inputs of the next piece) are
    # kept and the rest is recomputed; the attention's own residuals (o,
    # lse) are not tagged and are recomputed, as in JAX.
    if policy == "save_qkv_attn_out":
        q, k, v = checkpoint(_block_qkv, x, lp, cfg, positions, lora_scale, mesh,
                             use_reentrant=False)
        attn = checkpoint(_block_attn, q, k, v, cfg, sequence, mesh, use_reentrant=False)
    else:
        attn = checkpoint(_block_attn_out, x, lp, cfg, positions, sequence, lora_scale, mesh,
                          use_reentrant=False)
    return checkpoint(_block_tail, x, attn, lp, cfg, lora_scale, mesh, use_reentrant=False)


def embed_tokens(params: dict[str, torch.Tensor], tokens: torch.Tensor,
                 compute_dtype=torch.bfloat16,
                 positions: Optional[torch.Tensor] = None, *,
                 cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """tokens [..., S] int → activations [..., S, D] in the compute dtype.

    The rows of an fp32 master table are gathered and then cast, which gives
    the same values as JAX's cast-then-gather while its backward scatters
    into fp32 rather than into a compute-dtype copy of the whole table. A
    table below fp32 (bf16 masters) is cast first, as in JAX, so that its
    gradient is summed in the compute dtype and rounded to the table's
    once.
    gpt2 adds the learned position rows at ``positions`` (default 0..S-1;
    decode passes its offsets); gemma multiplies by sqrt(d_model) rounded to
    the compute dtype first, as JAX's ``jnp.asarray(..., compute_dtype)``
    does. A serving row that runs past the table (its outputs discarded)
    reads the table's last row: JAX's gather fills NaN there, and on CUDA an
    out-of-range index is a device-side assert. On a ``mesh`` whose
    ``model`` axis splits the vocabulary the table is the rank's block
    (:func:`~tpu_engine_torch.parallel.tensor_parallel.vocab_embed`)."""
    def table(name):
        t = params[name]
        return t if t.dtype == torch.float32 else t.to(compute_dtype)

    tp = model_axis(mesh, cfg)
    if tp is not None and tp.vocab_split:
        x = vocab_embed(table("embed.embedding"), tokens, compute_dtype, tp)
    else:
        x = F.embedding(tokens, table("embed.embedding")).to(compute_dtype)
    if cfg.arch == "gemma":
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype, device=x.device)
    if "pos_embed.embedding" in params:
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=tokens.device)
        pos = table("pos_embed.embedding")
        x = x + F.embedding(positions.clamp(max=pos.shape[0] - 1), pos).to(compute_dtype)
    return x


def _head_grads_f32(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """(g @ wᵀ, xᵀ @ g) in fp32 for bf16 x [N, D], w [D, V] (an untied head,
    or a tied one's transposed view of the [V, D] table) and an fp32
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
        return f32_out(torch.mm, x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _head_grads_f32(x, w, g)
        return dx.to(x.dtype), dw.to(w.dtype)


def f32_out(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``op(a, b)``, ``op`` being ``torch.mm`` or ``torch.bmm``, with an fp32
    result (JAX's ``preferred_element_type=float32``). bf16 on the card
    takes the op's ``out_dtype=float32`` overload; on the CPU, where that
    overload does not exist, the operands are upcast (the same products,
    since bf16 values are exact in fp32)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return op(a, b)
    if a.is_cuda:
        return op(a, b, out_dtype=torch.float32)
    return op(a.float(), b.float())


def _matmul_f32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last dim with an fp32 result (:func:`f32_out`);
    bf16 on the card goes through :class:`_MatmulF32Out` for its backward."""
    x2 = x.reshape(-1, x.shape[-1])
    out = (_MatmulF32Out.apply(x2, w) if x.is_cuda and x.dtype != torch.float32
           else f32_out(torch.mm, x2, w))
    return out.reshape(*x.shape[:-1], w.shape[-1])


def unembed(params: dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
            mesh=None) -> torch.Tensor:
    """Final norm + LM head: [..., S, D] → logits [..., S, V] fp32. gpt2
    and gemma tie the head to the token embedding: its transposed view, so
    the table's fp32 gradient sums the gather's scatter and the head's
    product. An int8 head's scale multiplies the fp32 logits. On a ``mesh``
    whose ``model`` axis splits the vocabulary the head is column-parallel
    behind ``f``: the logits are the rank's block [..., S, V/model]."""
    bias = params.get("final_norm.bias")
    x = _norm(x, params["final_norm.scale"].to(x.dtype),
              None if bias is None else bias.to(x.dtype), cfg)
    tp = model_axis(mesh, cfg)
    if tp is not None and tp.vocab_split:
        x = copy_to(x, tp)
    head = (params["embed.embedding"].t() if cfg.arch in ("gpt2", "gemma")
            else params["lm_head.kernel"])
    if isinstance(head, QuantWeight):  # int8 head: scale the fp32 logits
        return _matmul_f32_out(x, head.q.to(x.dtype)) * head.scale
    return _matmul_f32_out(x, head.to(x.dtype))


def cast_layer_stack(params: dict, compute_dtype=torch.bfloat16) -> dict:
    """The stacked per-layer params (``layers.*``, without the prefix) cast
    to the compute dtype, once per call. Gradients flow back through the
    cast onto the fp32 masters. A :class:`QuantWeight` passes uncast: its
    codes cast at the product, and its fp32 scales must not round."""
    return {k[len("layers."):]: p if isinstance(p, QuantWeight) else p.to(compute_dtype)
            for k, p in params.items() if k.startswith("layers.")}


def inference_params(params: dict[str, torch.Tensor], compute_dtype=torch.bfloat16,
                     device=None) -> dict[str, torch.Tensor]:
    """Every leaf detached and cast once to the compute dtype (and moved to
    ``device``, if given), for the cached forward of ``generate`` and
    ``serving``. JAX casts the fp32 masters inside each jitted dispatch
    (``cast_layer_stack``, ``unembed``); eager torch would pay that as a
    pass over every weight per decode step. A cast is deterministic, so
    casting once gives the same numbers: ``cast_layer_stack`` and
    ``unembed`` then cast nothing, and the embedding rows equal the cast
    master rows. A :class:`QuantWeight` is only moved."""
    return {k: p.to(device) if isinstance(p, QuantWeight)
            else p.detach().to(device=device, dtype=compute_dtype) for k, p in params.items()}


def forward_hidden_and_aux(
    params: dict[str, torch.Tensor],
    tokens: torch.Tensor,
    cfg: ModelConfig,
    compute_dtype=torch.bfloat16,
    remat: bool = False,
    positions: Optional[torch.Tensor] = None,
    sequence: Optional[int] = None,
    remat_policy: str = "nothing_saveable",
    lora: Optional[dict[str, torch.Tensor]] = None,
    lora_scale: float = 1.0,
    layer_stream=None,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decoder stack only: tokens [B, S] → (hidden [B, S, D] in the compute
    dtype, before the final norm; the MoE aux loss averaged over layers, 0
    for dense).
    ``sequence`` is the ring size of ``attention_impl="ring"``, which
    raises ``ValueError`` without it. ``remat`` checkpoints each block
    under ``remat_policy``. ``lora``: the flat adapter dict of
    ``tpu_engine_torch/lora.py`` (``layers.<t>.A`` [L, in, r],
    ``layers.<t>.B`` [L, r, out]), cast to the compute dtype with the
    stack and applied inside each adapted projection. ``layer_stream``
    (JAX's hook of the same name; :class:`tpu_engine_torch.offload.HostParams`)
    gives layer i's params by ``layer_stream.layer(i)``, called inside the
    block's checkpoint: the stack is then never cast whole, and ``params``
    needs only the non-layer leaves on the device. ``mesh``
    (:class:`~tpu_engine_torch.mesh_runtime.MeshRuntime`, JAX's ``mesh``):
    ``tokens`` and ``positions`` are this rank's block of the sequence,
    attention runs across the ``sequence`` axis and the MoE aux loss's
    means over the mesh's microbatch."""
    _require_ported(cfg)
    policy = resolve_remat_policy(remat_policy) if remat else None
    B, S = tokens.shape
    if cfg.arch == "gpt2" and S > cfg.max_seq_len:
        # Learned position table: a gather past its end would fail or, on
        # the card, read out of range (RoPE models have no such bound).
        raise ValueError(
            f"seq_len {S} exceeds the learned position table "
            f"(max_seq_len={cfg.max_seq_len}) of gpt2-family model {cfg.name!r}"
        )
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = embed_tokens(params, tokens, compute_dtype, positions=positions, cfg=cfg, mesh=mesh)
    x, auxes = run_layers(params, x, cfg, positions, cfg.n_layers, compute_dtype, policy,
                          sequence, lora, lora_scale, layer_stream, mesh)
    if cfg.is_moe:
        return x, torch.stack(auxes).mean()
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def run_layers(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
               n_layers: int, compute_dtype=torch.bfloat16, policy: Optional[str] = None,
               sequence: Optional[int] = None, lora=None, lora_scale: float = 1.0,
               layer_stream=None, mesh=None):
    """The first ``n_layers`` blocks of the stacked leaves of ``params``
    (or of ``layer_stream``) over the activations ``x`` [B, S, D], each
    checkpointed under the remat ``policy`` (None: no checkpoint). Returns
    (x, the blocks' MoE aux losses, a list; Nones for a dense MLP). A
    pipeline stage runs its own block of layers through it
    (``tpu_engine_torch/parallel/pipeline.py``)."""
    if layer_stream is None:
        stack = cast_layer_stack(params, compute_dtype)
        if lora is not None:
            stack.update(cast_layer_stack(lora, compute_dtype))
        # One unbind per leaf: its backward stacks the L per-layer gradients
        # in a single op, where per-layer indexing would scatter into L full
        # copies.
        layers = {k: t.unbind(0) for k, t in stack.items()}
    auxes = []
    for i in range(n_layers):
        if layer_stream is None:
            lp = {k: t[i] for k, t in layers.items()}
        else:
            lp = partial(layer_stream.layer, i)
        if policy is not None:
            x, aux = _remat_block(policy, x, lp, cfg, positions, sequence, lora_scale, mesh)
        else:
            x, aux = _block(x, lp, cfg, positions, sequence, lora_scale, mesh)
        auxes.append(aux)
    return x, auxes


def forward_and_aux(params, tokens, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                    remat: bool = False, positions=None, sequence: Optional[int] = None,
                    remat_policy: str = "nothing_saveable"):
    """tokens [B, S] → (logits [B, S, V] fp32, aux loss scalar).
    ``sequence``: the ring size, needed only for ``attention_impl="ring"``
    (JAX's ``mesh``)."""
    x, aux = forward_hidden_and_aux(params, tokens, cfg, compute_dtype=compute_dtype,
                                    remat=remat, positions=positions, sequence=sequence,
                                    remat_policy=remat_policy)
    return unembed(params, x, cfg), aux


def forward(params, tokens, cfg: ModelConfig, compute_dtype=torch.bfloat16,
            remat: bool = False, positions=None, sequence: Optional[int] = None,
            remat_policy: str = "nothing_saveable") -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] fp32."""
    logits, _ = forward_and_aux(params, tokens, cfg, compute_dtype=compute_dtype,
                                remat=remat, positions=positions, sequence=sequence,
                                remat_policy=remat_policy)
    return logits


__all__ = [
    "ModelConfig", "MODEL_CONFIGS", "init_params", "param_count",
    "active_param_count", "train_flops_per_token", "embed_tokens", "unembed",
    "cast_layer_stack", "inference_params", "forward_hidden_and_aux", "run_layers",
    "forward_and_aux", "forward",
    "REMAT_POLICIES", "resolve_remat_policy",
]
