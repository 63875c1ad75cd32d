"""Multi-head causal attention: the plain PyTorch path and the dispatch to
the CUDA flash kernels (port of ``tpu_engine/ops/flash_attention.py`` and
the caller contract of ``flash_mha`` in ``tpu_engine/ops/_flash_pallas.py``).

Layout convention: q [B, S, H, D], k/v [B, S, KV, D] (GQA when KV < H).
"""

from __future__ import annotations

import torch

from tpu_engine_torch.ops import _flash_cuda


class FlashUnsupported(Exception):
    """A shape or config the flash kernels do not take; ``mha`` then runs
    the plain path, as the JAX dispatcher does for an untileable shape."""


def _xla_mha(q, k, v, causal: bool = True, window: int = 0):
    """Plain attention (the JAX ``_xla_mha``): fp32 scores, −1e9 mask, fp32
    softmax, probabilities cast to the input dtype, GQA by repeat."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)
    scale = 1.0 / (D ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(S, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        if window:
            mask &= pos[:, None] - pos[None, :] < window
        scores = torch.where(mask, scores, torch.full_like(scores, -1e9))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_mha(q, k, v, causal: bool = True, window: int = 0):
    """Flash attention on [B, S, H, D]; returns [B, S, H, D].

    Raises :class:`FlashUnsupported` for non-causal attention, S not a
    multiple of 64 or below 64, and (on the card) a head dim the CUDA build
    does not instantiate. ``window >= S`` is plain causal."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    if not causal or S % _flash_cuda.BLOCK or S < _flash_cuda.BLOCK:
        raise FlashUnsupported(f"no flash tiling for seq_len={S}, causal={causal}")
    if q.is_cuda and D not in _flash_cuda.SUPPORTED_HEAD_DIMS:
        raise FlashUnsupported(f"head_dim={D} not built (have {_flash_cuda.SUPPORTED_HEAD_DIMS})")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window >= S:
        window = 0
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)

    def to_bhsd(x):
        return x.transpose(1, 2).reshape(B * H, S, D)

    o = _flash_cuda.FlashAttention.apply(to_bhsd(q), to_bhsd(k), to_bhsd(v), window)
    return o.reshape(B, H, S, D).transpose(1, 2)


def mha(q, k, v, causal: bool = True, force_xla: bool = False, window: int = 0):
    """Multi-head attention dispatch: ``force_xla=True`` (or a shape the
    kernels do not take) → the plain path; otherwise the flash kernels on a
    CUDA tensor, or their plain versions on a CPU tensor."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("sliding-window attention requires causal=True")
    if force_xla:
        return _xla_mha(q, k, v, causal=causal, window=window)
    try:
        return flash_mha(q, k, v, causal=causal, window=window)
    except FlashUnsupported:
        return _xla_mha(q, k, v, causal=causal, window=window)
