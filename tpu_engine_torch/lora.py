"""LoRA: low-rank adaptation for fine-tuning (port of ``tpu_engine/lora.py``).

Adapters ride the stacked ``[L, ...]`` layout of the base kernels, in the
port's flat keys: ``layers.<t>.A`` ``[L, in, r]`` and ``layers.<t>.B``
``[L, r, out]`` for each adapted kernel ``layers.<t>.kernel``. The forward
adds ``(alpha/r)·(h@A)@B`` inside each adapted projection
(``models/transformer._proj``), so only rank-sized intermediates and
cotangents exist; the trainable state (gradients, optimizer moments) is the
adapter dict alone, and the base is frozen. ``merge_lora`` folds the
adapters into the kernels, ``W + (alpha/r)·A@B``, for serving.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from tpu_engine_torch.models.config import ModelConfig

# Kernels that can take adapters; MoE expert MLPs are 4-D ([L, E, in, out])
# and are not adaptable, so MoE models adapt attention only.
DENSE_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
ATTN_TARGETS = ("q", "k", "v", "o")


def target_shapes(cfg: ModelConfig) -> dict[str, tuple[int, int, int]]:
    """[L, in, out] shape of each adaptable kernel."""
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {
        "q": (L, D, H * HD),
        "k": (L, D, KV * HD),
        "v": (L, D, KV * HD),
        "o": (L, H * HD, D),
    }
    if cfg.arch == "gpt2":
        shapes.update({"fc": (L, D, F), "proj": (L, F, D)})
    elif not cfg.is_moe:
        shapes.update({"gate": (L, D, F), "up": (L, D, F), "down": (L, F, D)})
    return shapes


def validate_targets(cfg: ModelConfig, targets: Sequence[str]) -> tuple[str, ...]:
    allowed = target_shapes(cfg)
    bad = [t for t in targets if t not in allowed]
    if bad:
        raise ValueError(
            f"invalid lora_targets {bad} for model {cfg.name!r}; "
            f"valid: {sorted(allowed)}"
            + (" (MoE expert MLPs cannot take adapters)" if cfg.is_moe else "")
        )
    if not targets:
        raise ValueError("lora_targets must not be empty")
    return tuple(targets)


def init_lora_params(generator: torch.Generator, cfg: ModelConfig, rank: int,
                     targets: Sequence[str], device="cuda",
                     dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """A ~ N(0, 1/r) (the LoRA paper's), drawn from ``generator`` (which
    must live on ``device``), B = 0: the adapted model starts equal to the
    base. The numbers differ from JAX's for the same seed; parity tests move
    adapters with :func:`tpu_engine_torch.models.convert.lora_from_jax`."""
    shapes = target_shapes(cfg)
    out: dict[str, torch.Tensor] = {}
    for t in targets:
        L, i, o = shapes[t]
        a = torch.empty((L, i, rank), dtype=torch.float32, device=device)
        a.normal_(0.0, 1.0, generator=generator)
        out[f"layers.{t}.A"] = (a / rank ** 0.5).to(dtype).requires_grad_(True)
        out[f"layers.{t}.B"] = torch.zeros((L, rank, o), dtype=dtype,
                                           device=device).requires_grad_(True)
    return out


def adapter_targets(lora_params: dict[str, Any]) -> list[str]:
    """The adapted kernels' names, in the adapter dict's order."""
    return [k[len("layers."):-len(".A")] for k in lora_params if k.endswith(".A")]


@torch.no_grad()
def merge_lora(base_params: dict[str, Any], lora_params: dict[str, torch.Tensor],
               alpha: float, rank: int) -> dict[str, Any]:
    """Base params with ``W_t + (alpha/r)·A_t@B_t`` for each adapted target
    (in the kernel's dtype). A new dict sharing every unadapted leaf."""
    scale = alpha / rank
    merged = dict(base_params)
    for t in adapter_targets(lora_params):
        w = base_params[f"layers.{t}.kernel"]
        a = lora_params[f"layers.{t}.A"].to(w.dtype)
        b = lora_params[f"layers.{t}.B"].to(w.dtype)
        merged[f"layers.{t}.kernel"] = w + scale * torch.bmm(a, b)
    return merged


def lora_param_count(cfg: ModelConfig, rank: int, targets: Sequence[str]) -> int:
    shapes = target_shapes(cfg)
    return sum(shapes[t][0] * rank * (shapes[t][1] + shapes[t][2]) for t in targets)

