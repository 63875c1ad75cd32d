"""Autoregressive generation with a KV cache (port of ``tpu_engine/generate.py``:
the dense llama, gpt2, qwen and gemma archs, MoE, and int8 weight-only
quantized trees).

One cached forward serves prefill (T = prompt length) and decode (T = 1):
each block writes its new keys and values into the cache, then attends
over every cache lane under a position mask, with fp32 scores and softmax.
Attention here is two plain batched products over the cache, as in JAX
(``generate.py:237-253``, ``jnp.einsum`` outside any Pallas kernel); the
flash kernels are not on this path.

Deliberate differences from JAX, each giving the same numbers except the
first:

- **Sampling RNG.** ``generate`` takes a ``torch.Generator`` where JAX takes
  a key. The temperature, top-k and top-p masks equal JAX's; the draw is a
  Gumbel-max over the masked logits with noise from the generator, so a
  stream is reproducible for a generator seed but differs from JAX's.
- **One-time inference cast.** ``generate`` and ``speculative_generate``
  cast the parameters once per call (``inference_params``) where JAX casts
  inside every dispatch.
- **Cache layout and updates.** The cache is ``[L, B, KV, M, HD]`` (JAX:
  ``[L, B, M, KV, HD]``), so each head's lanes are one matrix the products
  read without a copy; query heads of a GQA group attend to their kv head
  through a view, where JAX repeats the cache. Buffers are written in place
  (JAX donates them) and ``length`` is a host integer.

MoE decode is JAX's: every expert runs on the new positions and the
outputs combine with the renormalised top-k gates, exact top-k with no
capacity (:func:`_moe_mlp_decode`). Projections and expert kernels may be
int8 (:class:`~tpu_engine_torch.quant.QuantWeight`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from tpu_engine_torch.models.config import ModelConfig
from tpu_engine_torch.models.transformer import (
    _dense_mlp,
    _expert_kernel,
    _layer_proj,
    _norm,
    _qkv,
    _require_ported,
    _router_probs,
    cast_layer_stack,
    embed_tokens,
    f32_out,
    inference_params,
    unembed,
)

_NEG_INF = -1e30


@dataclass
class KVCache:
    """Per-layer key/value cache.

    k/v: [L, B, KV, M, HD]; ``pos`` [M] holds the global position stored in
    each lane (-1 = empty); ``length`` is the number of positions already
    written. When ``ring`` is set (sliding-window models whose cache is
    smaller than the sequence) the buffer wraps: writes go to
    ``position % M`` and the attention mask reads ``pos``. Non-ring caches
    keep the classic contract: the caller never writes past ``M`` positions.
    An int8 cache (``init_cache(kv_quant=True)``) holds codes in k/v and the
    per-(lane, kv-head) absmax/127 scales in ``k_scale``/``v_scale``
    [L, B, KV, M, 1]."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    length: int
    ring: bool = False
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def ring_lanes(cfg: ModelConfig, max_len: int, chunk: Optional[int] = None) -> int:
    """Lane count for a KV buffer: ``max_len`` for full-context models, or
    the ring size ``min(max_len, window + chunk - 1)`` for sliding-window
    models (a chunk of T queries needs the window behind its oldest query
    resident). The serving pool copies a single-row ring cache into its own
    lanes and is right only because both sides size lanes by this."""
    if not cfg.sliding_window:
        return max_len
    chunk = max_len if chunk is None else chunk
    return min(max_len, cfg.sliding_window + chunk - 1)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               max_chunk: Optional[int] = None, kv_quant: bool = False,
               device="cuda") -> KVCache:
    """Allocate a cache able to hold ``max_len`` positions, or, for a
    sliding-window model, a ring of ``window + max_chunk - 1`` lanes.
    ``kv_quant=True`` stores int8 codes with per-(lane, kv-head) scales."""
    lanes = ring_lanes(cfg, max_len, max_chunk)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, lanes, cfg.head_dim)
    store = torch.int8 if kv_quant else dtype

    def zeros(shp, dt):
        return torch.zeros(shp, dtype=dt, device=device)

    return KVCache(
        k=zeros(shape, store), v=zeros(shape, store),
        pos=torch.full((lanes,), -1, dtype=torch.int64, device=device),
        length=0, ring=lanes < max_len,
        k_scale=zeros(shape[:-1] + (1,), torch.float32) if kv_quant else None,
        v_scale=zeros(shape[:-1] + (1,), torch.float32) if kv_quant else None,
    )


def _quantize_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation over the trailing (head_dim) axis:
    rows [..., HD] → (codes as fp32 in [-127, 127], fp32 scales [..., 1]).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    r = rows.float()
    scale = (r.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    return torch.round(r / scale).clamp(-127, 127), scale


def _hidden_lanes(key_pos: torch.Tensor, positions: torch.Tensor, window: int) -> torch.Tensor:
    """Lanes a query may not see: key_pos [M] (all rows in lockstep) or
    [B, M] (per-row, the serving pool), positions [B, T] → bool [B, T, M].
    A lane is visible iff it holds a real position (>= 0) at or before the
    query's, and inside the window for sliding-window models; ring lanes
    overwritten by later in-chunk positions are hidden by the same test."""
    kp = (key_pos if key_pos.dim() == 2 else key_pos[None])[:, None, :]
    q = positions[:, :, None]
    visible = (kp >= 0) & (kp <= q)
    if window:
        visible &= kp > q - window
    return ~visible


def _moe_mlp_decode(h: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    """Exact top-k MoE for decode (JAX ``_moe_mlp_decode``): h [B, T, D] →
    [B, T, D]. Every expert's MLP runs on the T new positions (a handful of
    products at decode sizes, every shape static); the outputs combine with
    the top-k gates renormalised to sum to 1 (floor 1e-9). int8 expert
    kernels are dequantized to the compute dtype first, as in JAX."""
    B, T, D = h.shape
    K = cfg.top_k
    probs = _router_probs(h, lp)                                  # [B, T, E] fp32
    x = h.reshape(B * T, D)
    gate_w, up_w, down_w = (_expert_kernel(lp, n, h.dtype) for n in ("gate", "up", "down"))
    act = F.silu(torch.matmul(x, gate_w)) * torch.matmul(x, up_w)  # [E, BT, F]
    expert_out = torch.matmul(act, down_w)                        # [E, BT, D]
    top_vals, top_idx = torch.topk(probs, K, dim=-1)
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    weights = torch.zeros_like(probs).scatter_(-1, top_idx, top_vals).to(h.dtype)
    out = torch.bmm(weights.reshape(B * T, 1, -1), expert_out.transpose(0, 1))
    return out.reshape(B, T, D)


def _decode_block(x, lp, k_cache, v_cache, write, hidden, positions, cfg: ModelConfig,
                  k_scale_c=None, v_scale_c=None) -> torch.Tensor:
    """One transformer block attending against the cache: the arch's norms,
    projections (gpt2's biases), qwen's qk-norm, RoPE (not gpt2) and MLP,
    as in the training block.

    x: [B, T, D]; k_cache/v_cache: [B, KV, M, HD], written in place by
    ``write(cache_arr, rows [B, KV, T, X])``; ``hidden`` [B|1, T, M] from
    :func:`_hidden_lanes`. ``k_scale_c``/``v_scale_c`` [B, KV, M, 1] are
    present for int8 caches: new rows are quantised before the write and
    the cache reads dequantise in the compute dtype."""
    B, T, _ = x.shape
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    q, k, v = _qkv(_norm(x, lp["attn_norm.scale"], lp.get("attn_norm.bias"), cfg), lp, cfg,
                   positions)
    k, v = k.transpose(1, 2), v.transpose(1, 2)

    if k_scale_c is not None:
        for arr, sc, rows in ((k_cache, k_scale_c, k), (v_cache, v_scale_c, v)):
            codes, s = _quantize_rows(rows)
            write(arr, codes)
            write(sc, s)
        kc = k_cache.to(x.dtype) * k_scale_c.to(x.dtype)
        vc = v_cache.to(x.dtype) * v_scale_c.to(x.dtype)
    else:
        write(k_cache, k)
        write(v_cache, v)
        kc, vc = k_cache, v_cache

    M = kc.shape[2]
    # Query head h = kv·G + g reads kv head kv (jnp.repeat's order).
    qg = q.reshape(B, T, KV, G, HD).permute(0, 2, 3, 1, 4).reshape(B * KV, G * T, HD)
    scores = f32_out(torch.bmm, qg, kc.reshape(B * KV, M, HD).transpose(1, 2)) * (1.0 / HD ** 0.5)
    scores = scores.view(B, KV, G, T, M).masked_fill_(hidden[:, None, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype).view(B * KV, G * T, M)
    attn = torch.bmm(probs, vc.reshape(B * KV, M, HD))
    attn = attn.view(B, KV, G, T, HD).permute(0, 3, 1, 2, 4).reshape(B, T, H * HD)
    x = x + _layer_proj(attn, lp, "o")
    h = _norm(x, lp["mlp_norm.scale"], lp.get("mlp_norm.bias"), cfg)
    return x + (_moe_mlp_decode(h, lp, cfg) if cfg.is_moe else _dense_mlp(h, lp, cfg))


def _run_layers(params, x, cache, write, hidden, positions, cfg: ModelConfig,
               compute_dtype) -> torch.Tensor:
    """Every block of the stack over x against ``cache`` (a :class:`KVCache`
    or the serving pool: any object with k/v and optional scales stacked
    [L, ...]). Returns the last block's output."""
    stack = cast_layer_stack(params, compute_dtype)
    for i in range(cfg.n_layers):
        lp = {name: t[i] for name, t in stack.items()}
        scales = (cache.k_scale[i], cache.v_scale[i]) if cache.k_scale is not None else ()
        x = _decode_block(x, lp, cache.k[i], cache.v[i], write, hidden, positions, cfg,
                          *scales)
    return x


@torch.inference_mode()
def forward_with_cache(params: dict[str, torch.Tensor], tokens: torch.Tensor,
                       cache: KVCache, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                       want_logits: bool = True) -> tuple[Optional[torch.Tensor], KVCache]:
    """Run ``tokens`` [B, T] through the stack against (and into) ``cache``.

    Returns (logits [B, T, V] fp32, or None with ``want_logits=False``; the
    cache with ``length`` advanced by T, its buffers updated in place).

    Non-ring caches: the caller keeps ``cache.length + T <= cache.max_len``
    (past it, the write's start clamps as ``lax.dynamic_update_slice``'s
    does). Ring caches wrap, and need at least ``window + T - 1`` lanes.
    """
    B, T = tokens.shape
    M = cache.max_len
    if cfg.arch == "gpt2" and not cache.ring and M > cfg.max_seq_len:
        raise ValueError(
            f"generation length {M} exceeds the learned position table "
            f"(max_seq_len={cfg.max_seq_len}) of gpt2-family model {cfg.name!r}")
    if cache.ring and M < cfg.sliding_window + T - 1:
        raise ValueError(
            f"chunk of {T} queries needs >= {cfg.sliding_window + T - 1} cache "
            f"slots (window {cfg.sliding_window}), cache has {M}; prefill in "
            "smaller chunks or allocate with a larger max_chunk")
    _require_ported(cfg)
    new_pos = cache.length + torch.arange(T, device=tokens.device)
    positions = new_pos[None].expand(B, T)
    if cache.ring and T > 1:
        # A chunk may wrap: lane p % M for each position (distinct, M >= T).
        # JAX writes this as a one-hot select; the lanes and what they hold
        # are the same.
        lanes = new_pos % M
        cache.pos[lanes] = new_pos

        def write(arr, rows):
            arr[:, :, lanes] = rows.to(arr.dtype)
    else:
        start = cache.length % M if cache.ring else cache.length
        start = max(0, min(start, M - T))
        cache.pos[start:start + T] = new_pos

        def write(arr, rows):
            arr[:, :, start:start + T] = rows

    hidden = _hidden_lanes(cache.pos, positions, cfg.sliding_window)
    x = embed_tokens(params, tokens, compute_dtype, positions=positions, cfg=cfg)
    x = _run_layers(params, x, cache, write, hidden, positions, cfg, compute_dtype)
    logits = unembed(params, x, cfg) if want_logits else None
    return logits, dataclasses.replace(cache, length=cache.length + T)


def _filter_logits(logits: torch.Tensor, temperature, top_k: Optional[int],
                   top_p) -> torch.Tensor:
    """Temperature → top-k → nucleus (top-p) masking, as JAX's
    ``_filtered_sample`` does before its draw: masked entries become -1e30.
    ``top_p`` keeps the tokens whose mass strictly before them (in sorted
    order) is below ``top_p``, so the top token always stays."""
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, _NEG_INF)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        kept_min = sorted_logits.masked_fill(~keep, torch.inf).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < kept_min, _NEG_INF)
    return logits


def _filtered_sample(logits: torch.Tensor, generator: torch.Generator, temperature,
                     top_k: Optional[int], top_p) -> torch.Tensor:
    """A categorical draw from the filtered logits [B, V] → ids [B]: the
    Gumbel-max of the masked logits, with uniform noise from ``generator``."""
    masked = _filter_logits(logits, temperature, top_k, top_p)
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    return (masked - torch.log(-torch.log(u.clamp_min(1e-20)))).argmax(dim=-1)


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None) -> torch.Tensor:
    """logits [B, V] fp32 → token ids [B]. ``temperature=0`` is greedy."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    return _filtered_sample(logits, generator, temperature, top_k, top_p)


@torch.inference_mode()
def generate(params: dict[str, torch.Tensor], prompt, cfg: ModelConfig, max_new_tokens: int,
             generator: Optional[torch.Generator] = None, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             compute_dtype=torch.bfloat16, kv_quant: bool = False,
             device="cuda") -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` [B, P].

    Returns [B, P + max_new_tokens] int64 on ``device``. One prefill pass
    over the prompt, then single-token decode steps. Greedy by default;
    pass ``temperature`` (and optionally ``top_k`` / ``top_p``) and a
    ``generator`` on ``device`` to sample (seed 0 if none is given).
    ``kv_quant`` stores the cache as int8."""
    params = inference_params(params, compute_dtype, device)
    prompt = torch.as_tensor(prompt, device=device).long()
    B, P = prompt.shape
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def sample(logits):
        return sample_token(logits[:, -1], generator, temperature, top_k, top_p)

    cache = init_cache(cfg, B, P + max_new_tokens, dtype=compute_dtype, max_chunk=P,
                       kv_quant=kv_quant, device=device)
    logits, cache = forward_with_cache(params, prompt, cache, cfg, compute_dtype)
    out = [sample(logits)]
    for _ in range(max_new_tokens - 1):
        logits, cache = forward_with_cache(params, out[-1][:, None], cache, cfg, compute_dtype)
        out.append(sample(logits))
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


@torch.inference_mode()
def speculative_generate(params: dict[str, torch.Tensor], draft_params: dict[str, torch.Tensor],
                         prompt, cfg: ModelConfig, draft_cfg: ModelConfig,
                         max_new_tokens: int, gamma: int = 4, compute_dtype=torch.bfloat16,
                         return_stats: bool = False, device="cuda") -> Any:
    """Speculative greedy decoding: the draft proposes ``gamma`` tokens one
    at a time, the target verifies them in one forward of ``gamma + 1``
    tokens, and the longest agreeing prefix plus the target's own next
    token is accepted. The output equals greedy decoding of the target
    wherever its chunked and one-token forwards agree on the argmax.

    Rejected positions leave stale lanes whose stored position exceeds
    every later query, so they stay masked until rewritten: the rewind is
    only ``length``. Batch 1. Returns [1, P + max_new_tokens], or
    ``(tokens, rounds)`` with ``return_stats`` (rounds = target forwards).
    The accepted count is read on the host once per round."""
    prompt = torch.as_tensor(prompt, device=device).long()
    if prompt.shape[0] != 1:
        raise ValueError("speculative_generate supports batch size 1")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    params = inference_params(params, compute_dtype, device)
    draft_params = inference_params(draft_params, compute_dtype, device)
    P = prompt.shape[1]
    total = P + max_new_tokens
    buf_len = total + gamma + 1  # room for one over-full final round
    cache = init_cache(cfg, 1, buf_len, dtype=compute_dtype,
                       max_chunk=max(P - 1, gamma + 1), device=device)
    dcache = init_cache(draft_cfg, 1, buf_len, dtype=compute_dtype,
                        max_chunk=max(P - 1, 1), device=device)
    out = torch.zeros((1, buf_len), dtype=torch.int64, device=device)
    out[:, :P] = prompt
    # Ingest the prompt minus its last token, which each round re-feeds so
    # its logits take part in the verification.
    if P > 1:
        _, cache = forward_with_cache(params, prompt[:, :-1], cache, cfg, compute_dtype,
                                      want_logits=False)
        _, dcache = forward_with_cache(draft_params, prompt[:, :-1], dcache, draft_cfg,
                                       compute_dtype, want_logits=False)
    out_len, rounds = P, 0
    while out_len < total:
        t_last = out[:, out_len - 1:out_len]
        # gamma + 1 draft steps: the last one's output is dropped, but it
        # writes the last proposal's K/V, which a fully accepted round needs.
        tok, proposals = t_last, []
        for _ in range(gamma + 1):
            logits, dcache = forward_with_cache(draft_params, tok, dcache, draft_cfg,
                                                compute_dtype)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            proposals.append(tok)
        chain = torch.cat([t_last] + proposals[:gamma], dim=1)  # [1, gamma + 1]
        logits, cache = forward_with_cache(params, chain, cache, cfg, compute_dtype)
        tgt = logits[0].argmax(dim=-1)  # [gamma + 1]
        accepted = int(torch.cumprod((chain[0, 1:] == tgt[:-1]).long(), 0).sum())
        out[0, out_len:out_len + gamma + 1] = tgt
        out_len += accepted + 1
        cache = dataclasses.replace(cache, length=out_len - 1)
        dcache = dataclasses.replace(dcache, length=out_len - 1)
        rounds += 1
    out = out[:, :total]
    return (out, rounds) if return_stats else out


__all__ = [
    "KVCache", "ring_lanes", "init_cache", "forward_with_cache", "sample_token",
    "generate", "speculative_generate",
]
