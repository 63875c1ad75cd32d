"""Weight bridge between the JAX package's parameter pytree and the port.

The JAX model keeps its parameters as a nested dict with every per-layer
weight stacked on a leading ``[L, ...]`` axis (``init_params`` in
``tpu_engine/models/transformer.py``). The port keeps the same leaves, same
shapes and same ``[in, out]`` kernel layout, in a flat dict keyed by the
dotted path (``"layers.q.kernel"``). Weights cross through numpy, so parity
tests never depend on the two frameworks' random generators agreeing.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

# The llama-arch leaves the port implements, in a fixed order.
LLAMA_KEYS = (
    "embed.embedding",
    "layers.attn_norm.scale",
    "layers.q.kernel",
    "layers.k.kernel",
    "layers.v.kernel",
    "layers.o.kernel",
    "layers.mlp_norm.scale",
    "layers.gate.kernel",
    "layers.up.kernel",
    "layers.down.kernel",
    "final_norm.scale",
    "lm_head.kernel",
)


def _np(x: Any) -> np.ndarray:
    """Any array (numpy, a JAX array, a bf16 array) as a float32 numpy copy."""
    return np.asarray(x, dtype=np.float32)


def _flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path + "."))
        else:
            out[path] = v
    return out


def params_from_jax(tree: dict, cfg, device="cuda",
                    dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """The JAX stacked pytree (numpy or JAX leaves) → the port's flat dict of
    leaf tensors on ``device`` that require grad."""
    if cfg.arch != "llama" or cfg.is_moe:
        raise NotImplementedError(
            f"params_from_jax: arch={cfg.arch!r} moe={cfg.is_moe} is not ported "
            "(slice 1 is the dense llama arch)"
        )
    flat = _flatten(tree)
    if set(flat) != set(LLAMA_KEYS):
        raise ValueError(
            f"unexpected parameter tree: missing {sorted(set(LLAMA_KEYS) - set(flat))}, "
            f"extra {sorted(set(flat) - set(LLAMA_KEYS))}"
        )
    return {
        k: torch.tensor(_np(flat[k]), dtype=dtype, device=device).requires_grad_(True)
        for k in LLAMA_KEYS
    }


def params_to_numpy(params: dict[str, torch.Tensor]) -> dict:
    """The port's flat parameters → the JAX-shaped nested dict of float32
    numpy arrays (for comparing updated weights across packages)."""
    out: dict = {}
    for path, t in params.items():
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy()
    return out
