"""Weight bridge between the JAX package's parameter pytree and the port.

The JAX model keeps its parameters as a nested dict with every per-layer
weight stacked on a leading ``[L, ...]`` axis (``init_params`` in
``tpu_engine/models/transformer.py``). The port keeps the same leaves, same
shapes and same ``[in, out]`` kernel layout, in a flat dict keyed by the
dotted path (``"layers.q.kernel"``), with each arch's leaves
(:func:`param_keys`). Weights cross through numpy, so parity tests never
depend on the two frameworks' random generators agreeing.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

# The leaves of each dense arch, as JAX's ``init_params`` makes them.
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
# gpt2: LayerNorm with bias, biased projections, a GELU fc/proj MLP, a learned
# position table, and the head tied to the token embedding.
GPT2_KEYS = (
    "embed.embedding",
    "pos_embed.embedding",
    *(f"layers.{name}.{leaf}" for name, leaves in (
        ("attn_norm", ("scale", "bias")), ("q", ("kernel", "bias")), ("k", ("kernel", "bias")),
        ("v", ("kernel", "bias")), ("o", ("kernel", "bias")), ("mlp_norm", ("scale", "bias")),
        ("fc", ("kernel", "bias")), ("proj", ("kernel", "bias"))) for leaf in leaves),
    "final_norm.scale",
    "final_norm.bias",
)
# qwen: llama plus per-head q/k RMSNorm scales; gemma: llama with the head
# tied to the token embedding.
QWEN_KEYS = LLAMA_KEYS + ("layers.q_norm.scale", "layers.k_norm.scale")
GEMMA_KEYS = tuple(k for k in LLAMA_KEYS if k != "lm_head.kernel")
_ARCH_KEYS = {"llama": LLAMA_KEYS, "gpt2": GPT2_KEYS, "qwen": QWEN_KEYS, "gemma": GEMMA_KEYS}


def param_keys(cfg) -> tuple[str, ...]:
    """The flat parameter names of ``cfg``'s dense arch; MoE is not ported."""
    if cfg.is_moe or cfg.arch not in _ARCH_KEYS:
        raise NotImplementedError(
            f"{cfg.name}: arch={cfg.arch!r} with n_experts={cfg.n_experts} is not ported "
            "(the dense llama, gpt2, qwen and gemma archs are)")
    return _ARCH_KEYS[cfg.arch]


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
    leaf tensors on ``device`` that require grad. The tree must hold exactly
    the leaves of ``cfg``'s arch (:func:`param_keys`)."""
    keys = param_keys(cfg)
    flat = _flatten(tree)
    if set(flat) != set(keys):
        raise ValueError(
            f"unexpected parameter tree: missing {sorted(set(keys) - set(flat))}, "
            f"extra {sorted(set(flat) - set(keys))}"
        )
    return {
        k: torch.tensor(_np(flat[k]), dtype=dtype, device=device).requires_grad_(True)
        for k in keys
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
