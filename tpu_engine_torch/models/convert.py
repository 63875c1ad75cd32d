"""Weight bridges of the port: to and from the JAX package's parameter
pytree, and to and from Hugging Face checkpoints (port of
``tpu_engine/models/convert.py``).

The JAX model keeps its parameters as a nested dict with every per-layer
weight stacked on a leading ``[L, ...]`` axis (``init_params`` in
``tpu_engine/models/transformer.py``). The port keeps the same leaves, same
shapes and same ``[in, out]`` kernel layout, in a flat dict keyed by the
dotted path (``"layers.q.kernel"``), with each arch's leaves
(:func:`param_keys`). Weights cross through numpy, so parity tests never
depend on the two frameworks' random generators agreeing.

The HF bridge maps ``LlamaForCausalLM`` (and Mistral, Gemma-1 and Qwen3,
which share its tensor layout) and ``GPT2LMHeadModel`` state dicts onto the
flat dict and back, in host numpy:

- llama-family ``nn.Linear`` weights are ``[out, in]`` and are transposed
  into the ``[in, out]`` kernels; gpt2's ``Conv1D`` weights are already
  ``[in, out]``, and its fused ``c_attn`` splits into q/k/v by columns;
- gemma ties the head to the embedding (no ``lm_head.kernel``); qwen3 adds
  per-head ``q_norm``/``k_norm`` scales; mistral is llama with a window;
- configs or tensors the model cannot represent (biases, RoPE scaling, a
  decoupled llama head dim, gemma-2 features, qwen2, MoE either way) raise
  ``ValueError`` rather than converting to a silently different model.

``transformers`` is needed only by :func:`hf_config_from` and
:func:`save_hf_checkpoint`, which import it when called.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from tpu_engine_torch.models.config import ModelConfig

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
# MoE (llama with experts): the router [L, D, E] beside the stacked expert
# kernels, gate/up [L, E, D, F] and down [L, E, F, D]; qwen and gemma take
# them the same way (qwen's q/k norms beside, gemma's head still tied).
MOE_KEYS = LLAMA_KEYS[:7] + ("layers.router.kernel",) + LLAMA_KEYS[7:]
QWEN_MOE_KEYS = MOE_KEYS + QWEN_KEYS[len(LLAMA_KEYS):]
GEMMA_MOE_KEYS = tuple(k for k in MOE_KEYS if k != "lm_head.kernel")
_ARCH_KEYS = {"llama": LLAMA_KEYS, "gpt2": GPT2_KEYS, "qwen": QWEN_KEYS, "gemma": GEMMA_KEYS}
_MOE_ARCH_KEYS = {"llama": MOE_KEYS, "qwen": QWEN_MOE_KEYS, "gemma": GEMMA_MOE_KEYS}


def param_keys(cfg) -> tuple[str, ...]:
    """The flat parameter names of ``cfg``'s arch: llama, gpt2, qwen and
    gemma, and llama, qwen and gemma with experts. gpt2 with experts is
    refused: JAX builds dense gpt2 parameters for it, and its block then
    looks for a router."""
    keys = _MOE_ARCH_KEYS if cfg.is_moe else _ARCH_KEYS
    if cfg.arch not in keys:
        raise NotImplementedError(
            f"{cfg.name}: arch={cfg.arch!r} with n_experts={cfg.n_experts} is not ported "
            "(llama, gpt2, qwen and gemma, and llama, qwen and gemma with experts, are)")
    return keys[cfg.arch]


def _np(x: Any) -> np.ndarray:
    """Any array (numpy, a JAX array, a bf16 array, a torch tensor on any
    device and of any float dtype) as float32 numpy."""
    if isinstance(x, torch.Tensor):  # bf16 and CUDA tensors have no numpy view
        x = x.detach().to("cpu", torch.float32).numpy()
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
                    dtype: torch.dtype = torch.float32) -> dict[str, Any]:
    """The JAX stacked pytree (numpy or JAX leaves) → the port's flat dict of
    leaf tensors on ``device`` that require grad. The tree must hold exactly
    the leaves of ``cfg``'s arch (:func:`param_keys`). A quantized site (a
    JAX ``QuantWeight``, anything with ``q`` and ``scale``) becomes the
    port's :class:`~tpu_engine_torch.quant.QuantWeight`, int8 codes and
    fp32 scales as they are."""
    from tpu_engine_torch.quant import QuantWeight

    keys = param_keys(cfg)
    flat = _flatten(tree)
    if set(flat) != set(keys):
        raise ValueError(
            f"unexpected parameter tree: missing {sorted(set(keys) - set(flat))}, "
            f"extra {sorted(set(flat) - set(keys))}"
        )

    def leaf(x):
        if hasattr(x, "q") and hasattr(x, "scale"):
            return QuantWeight(
                q=torch.tensor(np.asarray(x.q, dtype=np.int8), device=device),
                scale=torch.tensor(np.asarray(x.scale, dtype=np.float32), device=device))
        return torch.tensor(_np(x), dtype=dtype, device=device).requires_grad_(True)

    return {k: leaf(flat[k]) for k in keys}


def lora_from_jax(tree: dict, device="cuda",
                  dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """JAX's LoRA adapter tree (``{"layers": {t: {"A", "B"}}}``, numpy or
    JAX leaves) → the port's flat adapter dict (``layers.<t>.A``,
    ``layers.<t>.B``, ``tpu_engine_torch/lora.py``) on ``device``, requiring
    grad."""
    return {f"layers.{t}.{name}": torch.tensor(_np(ab[name]), dtype=dtype,
                                               device=device).requires_grad_(True)
            for t, ab in tree["layers"].items() for name in ("A", "B")}


def stage_block_np(flat: dict[str, Any], cfg, n_stages: int, index: int) -> dict[str, Any]:
    """Stage ``index``'s leaves of a flat tree of JAX's parameters (numpy,
    the port's keys): its block of every stacked ``layers.*`` leaf and the
    outer leaves it holds (``sharding.stage_keys``), what the program on a
    ``pipe`` mesh places on that rank."""
    from tpu_engine_torch import sharding

    first, per = sharding.stage_layers(cfg.n_layers, n_stages, index)
    return {k: flat[k][first:first + per] if k.startswith("layers.") else flat[k]
            for k in sharding.stage_keys(cfg, flat, n_stages, index)}


def model_block_np(flat: dict[str, Any], cfg, n_model: int, index: int) -> dict[str, Any]:
    """Rank ``index``'s ``model`` blocks of a flat numpy tree (the port's
    keys): model leaves, LoRA adapters (``layers.<t>.A``/``.B``) or an int8
    tree (a site anything with ``q`` and ``scale``: codes and scale split
    as ``QuantWeight.narrow`` splits them, returned as ``(q, scale)``), the
    numpy counterpart of ``tensor_parallel.model_block``."""
    from tpu_engine_torch import sharding

    logical = sharding.logical_axes(cfg)
    targets = [k[len("layers."):-len(".A")] for k in flat if k.endswith(".A")]
    logical.update(sharding.lora_logical_axes(logical, targets))
    dims = sharding.model_split(cfg, logical, n_model)

    def cut(a, d, contracted=False):
        if d is None or contracted:
            return np.asarray(a)
        per = a.shape[d] // n_model
        return np.take(np.asarray(a), np.arange(index * per, (index + 1) * per), axis=d)

    out: dict[str, Any] = {}
    for k, v in flat.items():
        d = dims.get(k)
        if hasattr(v, "q") and hasattr(v, "scale"):
            q = np.asarray(v.q)
            out[k] = (cut(q, d), cut(v.scale, d, d is not None and d == q.ndim - 2))
        else:
            out[k] = cut(v, d)
    return out


def params_to_numpy(params: dict[str, torch.Tensor]) -> dict:
    """The port's flat parameters → the JAX-shaped nested dict of float32
    numpy arrays (for comparing updated weights across packages)."""
    out: dict = {}
    for path, t in params.items():
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _np(t)
    return out


# ---------------------------------------------------------------------------
# Hugging Face configs
# ---------------------------------------------------------------------------


def config_from_hf(hf_config: Any) -> ModelConfig:
    """Map a ``transformers.LlamaConfig`` (or any object with the same
    attribute names; ``model_type`` routes gpt2, gemma and qwen3 configs to
    their own mappings) onto :class:`ModelConfig`. RoPE scaling and a
    ``head_dim`` decoupled from ``hidden_size // num_attention_heads`` are
    rejected, as are gemma-2/3 and qwen2 configs."""
    model_type = getattr(hf_config, "model_type", "")
    if model_type == "gpt2":
        return config_from_hf_gpt2(hf_config)
    if model_type == "gemma":
        return config_from_hf_gemma(hf_config)
    if model_type in ("gemma2", "gemma3", "gemma3_text"):
        raise ValueError(
            f"model_type={model_type!r} (logit softcapping / alternating "
            "local attention / pre-post norms) is not implemented; only "
            "Gemma-1 ('gemma') converts")
    if model_type == "qwen3":
        return config_from_hf_qwen3(hf_config)
    if model_type == "qwen2":
        raise ValueError(
            "model_type='qwen2' (attention qkv biases, no qk-norm) is not "
            "implemented; the Qwen3 family ('qwen3') converts")
    _reject_rope_scaling(hf_config)
    derived_hd = hf_config.hidden_size // hf_config.num_attention_heads
    explicit_hd = getattr(hf_config, "head_dim", None)
    if explicit_hd not in (None, derived_hd):
        raise ValueError(
            f"head_dim={explicit_hd} != hidden_size//num_attention_heads "
            f"({derived_hd}): decoupled head dims are not representable")
    return ModelConfig(
        name=getattr(hf_config, "name_or_path", "") or "hf-llama",
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=_kv_heads(hf_config),
        d_ff=hf_config.intermediate_size,
        max_seq_len=getattr(hf_config, "max_position_embeddings", 2048),
        rope_theta=getattr(hf_config, "rope_theta", 10_000.0),
        norm_eps=getattr(hf_config, "rms_norm_eps", 1e-5),
        # MistralConfig carries sliding_window (None = disabled); Llama has
        # no such attribute. The tensor layouts are otherwise the same.
        sliding_window=getattr(hf_config, "sliding_window", None) or 0,
    )


def _reject_rope_scaling(hf_config: Any) -> None:
    scaling = getattr(hf_config, "rope_scaling", None)
    if scaling:
        raise ValueError(
            f"rope_scaling={scaling!r} is not supported: converted weights "
            "would compute different RoPE frequencies than transformers")


def _kv_heads(hf_config: Any) -> int:
    return getattr(hf_config, "num_key_value_heads", None) or hf_config.num_attention_heads


def config_from_hf_qwen3(hf_config: Any) -> ModelConfig:
    """Map a ``transformers.Qwen3Config`` onto :class:`ModelConfig`
    (arch="qwen"): llama plus per-head qk-norm and a decoupled head_dim.
    Tied-embedding variants import by materialising the tie into the
    explicit head (``from_hf_llama``'s fallback)."""
    _reject_rope_scaling(hf_config)
    if getattr(hf_config, "use_sliding_window", False):
        # HF Qwen windows only layers >= max_window_layers; one global
        # window cannot represent that.
        raise ValueError(
            "use_sliding_window=True (layered windows via max_window_layers) "
            "is not representable; only full-attention Qwen3 converts")
    derived_hd = hf_config.hidden_size // hf_config.num_attention_heads
    hd = getattr(hf_config, "head_dim", None) or derived_hd
    return ModelConfig(
        name=getattr(hf_config, "name_or_path", "") or "hf-qwen3",
        arch="qwen",
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=_kv_heads(hf_config),
        head_dim_override=0 if hd == derived_hd else hd,
        d_ff=hf_config.intermediate_size,
        max_seq_len=getattr(hf_config, "max_position_embeddings", 32_768),
        rope_theta=getattr(hf_config, "rope_theta", 1_000_000.0),
        norm_eps=getattr(hf_config, "rms_norm_eps", 1e-6),
    )


def config_from_hf_gemma(hf_config: Any) -> ModelConfig:
    """Map a ``transformers.GemmaConfig`` onto :class:`ModelConfig`
    (arch="gemma"): decoupled head_dim, tied head, GeGLU, zero-centred
    RMSNorm. Gemma-2 features (logit softcapping) are rejected."""
    for attr in ("final_logit_softcapping", "attn_logit_softcapping"):
        if getattr(hf_config, attr, None):
            raise ValueError(
                f"{attr} is a Gemma-2 feature this architecture does not "
                "implement; refusing a silently-different model")
    act = getattr(hf_config, "hidden_activation", None) or "gelu_pytorch_tanh"
    if act not in ("gelu_pytorch_tanh", "gelu"):
        raise ValueError(f"hidden_activation={act!r} unsupported for gemma")
    return ModelConfig(
        name=getattr(hf_config, "name_or_path", "") or "hf-gemma",
        arch="gemma",
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=_kv_heads(hf_config),
        d_ff=hf_config.intermediate_size,
        max_seq_len=getattr(hf_config, "max_position_embeddings", 8192),
        rope_theta=getattr(hf_config, "rope_theta", 10_000.0),
        norm_eps=getattr(hf_config, "rms_norm_eps", 1e-6),
        head_dim_override=getattr(hf_config, "head_dim", 0) or 0,
    )


def config_from_hf_gpt2(hf_config: Any) -> ModelConfig:
    """Map a ``transformers.GPT2Config`` onto :class:`ModelConfig`
    (arch="gpt2"), rejecting variants whose attention math differs."""
    act = getattr(hf_config, "activation_function", "gelu_new")
    if act != "gelu_new":
        raise ValueError(f"activation_function={act!r} unsupported (need gelu_new)")
    if getattr(hf_config, "scale_attn_by_inverse_layer_idx", False):
        raise ValueError("scale_attn_by_inverse_layer_idx is not supported")
    if getattr(hf_config, "reorder_and_upcast_attn", False):
        raise ValueError("reorder_and_upcast_attn is not supported")
    if not getattr(hf_config, "scale_attn_weights", True):
        raise ValueError("scale_attn_weights=False is not supported")
    return ModelConfig(
        name=getattr(hf_config, "name_or_path", "") or "hf-gpt2",
        arch="gpt2",
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.n_embd,
        n_layers=hf_config.n_layer,
        n_heads=hf_config.n_head,
        n_kv_heads=hf_config.n_head,
        d_ff=hf_config.n_inner or 4 * hf_config.n_embd,
        max_seq_len=hf_config.n_positions,
        norm_eps=getattr(hf_config, "layer_norm_epsilon", 1e-5),
    )


def hf_config_from(cfg: ModelConfig) -> Any:
    """Inverse of :func:`config_from_hf`: the ``transformers`` config of
    this dense model (Llama, Mistral for a window, Gemma, Qwen3, GPT-2)."""
    if cfg.is_moe:
        raise ValueError("MoE models have no LlamaForCausalLM representation")
    if cfg.arch == "gpt2":
        from transformers import GPT2Config

        return GPT2Config(
            vocab_size=cfg.vocab_size, n_embd=cfg.d_model, n_layer=cfg.n_layers,
            n_head=cfg.n_heads, n_inner=cfg.d_ff, n_positions=cfg.max_seq_len,
            layer_norm_epsilon=cfg.norm_eps, activation_function="gelu_new",
            tie_word_embeddings=True)
    common = dict(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model, intermediate_size=cfg.d_ff,
        num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads, max_position_embeddings=cfg.max_seq_len,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps, tie_word_embeddings=False)
    if cfg.arch == "gemma":
        from transformers import GemmaConfig

        common.update(head_dim=cfg.head_dim, tie_word_embeddings=True,
                      hidden_activation="gelu_pytorch_tanh")
        return GemmaConfig(**common)
    if cfg.arch == "qwen":
        if cfg.sliding_window:
            raise ValueError(
                "a globally-windowed qwen model has no faithful Qwen3Config "
                "representation (HF windows only layers >= max_window_layers)")
        from transformers import Qwen3Config

        common.update(head_dim=cfg.head_dim, attention_bias=False)
        return Qwen3Config(**common)
    if cfg.sliding_window:
        from transformers import MistralConfig

        return MistralConfig(sliding_window=cfg.sliding_window, **common)
    from transformers import LlamaConfig

    return LlamaConfig(attention_bias=False, **common)


# ---------------------------------------------------------------------------
# Hugging Face state dicts
# ---------------------------------------------------------------------------

# Per-layer leaves of the llama layout: (port leaf under "layers.", HF name
# under "model.layers.{i}.", transposed). qwen adds its qk-norm scales.
_LLAMA_LAYER = (
    ("attn_norm.scale", "input_layernorm.weight", False),
    ("q.kernel", "self_attn.q_proj.weight", True),
    ("k.kernel", "self_attn.k_proj.weight", True),
    ("v.kernel", "self_attn.v_proj.weight", True),
    ("o.kernel", "self_attn.o_proj.weight", True),
    ("mlp_norm.scale", "post_attention_layernorm.weight", False),
    ("gate.kernel", "mlp.gate_proj.weight", True),
    ("up.kernel", "mlp.up_proj.weight", True),
    ("down.kernel", "mlp.down_proj.weight", True),
)
_QWEN_LAYER = (
    ("q_norm.scale", "self_attn.q_norm.weight", False),
    ("k_norm.scale", "self_attn.k_norm.weight", False),
)
# gpt2's per-layer leaves other than the fused c_attn: (port leaf, HF name
# under "transformer.h.{i}.").
_GPT2_LAYER = (
    ("attn_norm.scale", "ln_1.weight"), ("attn_norm.bias", "ln_1.bias"),
    ("o.kernel", "attn.c_proj.weight"), ("o.bias", "attn.c_proj.bias"),
    ("mlp_norm.scale", "ln_2.weight"), ("mlp_norm.bias", "ln_2.bias"),
    ("fc.kernel", "mlp.c_fc.weight"), ("fc.bias", "mlp.c_fc.bias"),
    ("proj.kernel", "mlp.c_proj.weight"), ("proj.bias", "mlp.c_proj.bias"),
)


class _Reader:
    """Reads a state dict one tensor at a time into ``dtype`` tensors on
    ``device`` and records which names it consumed. A stacked leaf is
    filled layer by layer, so the host holds one fp32 layer at a time."""

    def __init__(self, sd: Mapping[str, Any], n_layers: int, dtype: torch.dtype, device):
        self.sd, self.n_layers, self.dtype, self.device = sd, n_layers, dtype, device
        self.consumed: set[str] = set()

    def host(self, name: str, transpose: bool = False, cols: slice = slice(None)) -> np.ndarray:
        self.consumed.add(name)
        w = _np(self.sd[name])[..., cols]
        return w.T if transpose else w

    def leaf(self, name: str, transpose: bool = False) -> torch.Tensor:
        return torch.tensor(self.host(name, transpose), dtype=self.dtype, device=self.device)

    def stacked(self, fmt: str, transpose: bool = False, cols: slice = slice(None)) -> torch.Tensor:
        first = self.host(fmt.format(i=0), transpose, cols)
        out = torch.empty((self.n_layers, *first.shape), dtype=self.dtype, device=self.device)
        for i in range(self.n_layers):
            w = first if i == 0 else self.host(fmt.format(i=i), transpose, cols)
            out[i] = torch.from_numpy(np.ascontiguousarray(w))
        return out

    def refuse_leftovers(self, ignored, what: str) -> None:
        """Anything unconsumed would change the model's function: refuse it."""
        leftover = [k for k in self.sd if k not in self.consumed and not ignored(k)]
        if leftover:
            raise ValueError(
                f"state dict has {len(leftover)} tensors this converter would "
                f"drop (unsupported {what}?): {sorted(leftover)[:8]}")


def _refuse_moe(cfg: ModelConfig) -> None:
    """The HF bridge maps dense llama-layout models only."""
    if cfg.is_moe:
        raise ValueError("MoE models have no LlamaForCausalLM representation")


def _as_params(flat: dict[str, torch.Tensor], cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The flat dict in :func:`param_keys` order, leaves requiring grad."""
    return {k: flat[k].requires_grad_(True) for k in param_keys(cfg)}


def from_hf_llama(state_dict: Mapping[str, Any], cfg: ModelConfig,
                  dtype: torch.dtype = torch.float32, device="cuda") -> dict[str, torch.Tensor]:
    """HF ``LlamaForCausalLM.state_dict()`` (or Mistral's, Gemma's, Qwen3's)
    → the port's flat parameters on ``device`` in ``dtype``.

    Raises ``KeyError`` with the missing name if the state dict does not
    look like a llama checkpoint, and ``ValueError`` if it holds tensors the
    arch would drop (attention/MLP biases, an untied gemma head). Each leaf
    is cast to ``dtype`` as it is read."""
    _refuse_moe(cfg)
    param_keys(cfg)
    r = _Reader(state_dict, cfg.n_layers, dtype, device)
    layer = _LLAMA_LAYER + (_QWEN_LAYER if cfg.arch == "qwen" else ())
    flat = {"embed.embedding": r.leaf("model.embed_tokens.weight")}
    flat.update({f"layers.{leaf}": r.stacked(f"model.layers.{{i}}.{hf}", t)
                 for leaf, hf, t in layer})
    flat["final_norm.scale"] = r.leaf("model.norm.weight")
    sd = state_dict
    if cfg.arch == "gemma":
        # Gemma ties the head to the embedding; a state dict may still carry
        # the tied tensor. Consume it after checking that it is the tie
        # (tied torch tensors share storage: compare pointers first).
        if "lm_head.weight" in sd:
            head_t, embed_t = sd["lm_head.weight"], sd["model.embed_tokens.weight"]
            same = head_t is embed_t or (
                isinstance(head_t, torch.Tensor) and isinstance(embed_t, torch.Tensor)
                and head_t.data_ptr() == embed_t.data_ptr())
            if not same and not np.array_equal(_np(head_t), _np(embed_t)):
                raise ValueError(
                    "gemma checkpoint has an UNTIED lm_head.weight; this "
                    "architecture ties the head to the embedding")
            r.consumed.add("lm_head.weight")
    else:
        # Every other arch has an explicit head, the tied weight when the
        # export omitted it.
        name = "lm_head.weight" if "lm_head.weight" in sd else "model.embed_tokens.weight"
        flat["lm_head.kernel"] = r.leaf(name, transpose=True)
    # Rotary buffers are derived, not weights.
    r.refuse_leftovers(lambda k: "rotary" in k or "inv_freq" in k, "architecture variant")
    return _as_params(flat, cfg)


def from_hf_gpt2(state_dict: Mapping[str, Any], cfg: ModelConfig,
                 dtype: torch.dtype = torch.float32, device="cuda") -> dict[str, torch.Tensor]:
    """HF ``GPT2LMHeadModel.state_dict()`` → the port's flat parameters.
    Conv1D weights are already [in, out]; the fused ``c_attn`` [D, 3D] (and
    its bias [3D]) splits into q, k and v by columns."""
    param_keys(cfg)
    D = cfg.d_model
    r = _Reader(state_dict, cfg.n_layers, dtype, device)
    p = "transformer.h.{i}."
    flat = {"embed.embedding": r.leaf("transformer.wte.weight"),
            "pos_embed.embedding": r.leaf("transformer.wpe.weight")}
    for j, name in enumerate("qkv"):
        cols = slice(j * D, (j + 1) * D)
        flat[f"layers.{name}.kernel"] = r.stacked(p + "attn.c_attn.weight", cols=cols)
        flat[f"layers.{name}.bias"] = r.stacked(p + "attn.c_attn.bias", cols=cols)
    flat.update({f"layers.{leaf}": r.stacked(p + hf) for leaf, hf in _GPT2_LAYER})
    flat["final_norm.scale"] = r.leaf("transformer.ln_f.weight")
    flat["final_norm.bias"] = r.leaf("transformer.ln_f.bias")
    # Causal-mask buffers, and the head tied to wte.
    r.refuse_leftovers(lambda k: k.endswith(("attn.bias", "attn.masked_bias"))
                       or k == "lm_head.weight", "GPT-2 variant")
    return _as_params(flat, cfg)


def from_hf(state_dict: Mapping[str, Any], cfg: ModelConfig,
            dtype: torch.dtype = torch.float32, device="cuda") -> dict[str, torch.Tensor]:
    """Import by arch: GPT-2 state dicts for ``arch="gpt2"``, the llama
    tensor layout otherwise (llama, mistral, qwen3, and gemma, whose tied
    head :func:`from_hf_llama` handles)."""
    if cfg.arch == "gpt2":
        return from_hf_gpt2(state_dict, cfg, dtype, device)
    return from_hf_llama(state_dict, cfg, dtype, device)


def to_hf_llama(params: dict[str, torch.Tensor], cfg: ModelConfig) -> dict[str, np.ndarray]:
    """The port's flat parameters → the HF llama state-dict layout (float32
    numpy; wrap in torch tensors for ``load_state_dict``). gemma has no
    ``lm_head.weight``; qwen adds its qk-norm scales."""
    _refuse_moe(cfg)
    host = {k: _np(t) for k, t in params.items()}
    sd = {"model.embed_tokens.weight": host["embed.embedding"],
          "model.norm.weight": host["final_norm.scale"]}
    if "lm_head.kernel" in host:  # gemma ties the head
        sd["lm_head.weight"] = host["lm_head.kernel"].T
    layer = _LLAMA_LAYER + (_QWEN_LAYER if cfg.arch == "qwen" else ())
    for i in range(cfg.n_layers):
        for leaf, hf, transpose in layer:
            w = host[f"layers.{leaf}"][i]
            sd[f"model.layers.{i}.{hf}"] = w.T if transpose else w
    return sd


def to_hf_gpt2(params: dict[str, torch.Tensor], cfg: ModelConfig) -> dict[str, np.ndarray]:
    """The port's gpt2 parameters → the HF ``GPT2LMHeadModel`` state-dict
    layout (float32 numpy, Conv1D [in, out]; q, k and v fused into
    ``c_attn``, the head tied to ``wte``)."""
    host = {k: _np(t) for k, t in params.items()}
    sd = {"transformer.wte.weight": host["embed.embedding"],
          "transformer.wpe.weight": host["pos_embed.embedding"],
          "transformer.ln_f.weight": host["final_norm.scale"],
          "transformer.ln_f.bias": host["final_norm.bias"],
          "lm_head.weight": host["embed.embedding"]}
    for i in range(cfg.n_layers):
        pre = f"transformer.h.{i}."
        for hf, leaf in (("attn.c_attn.weight", "kernel"), ("attn.c_attn.bias", "bias")):
            sd[pre + hf] = np.concatenate([host[f"layers.{n}.{leaf}"][i] for n in "qkv"],
                                          axis=-1)
        for leaf, hf in _GPT2_LAYER:
            sd[pre + hf] = host[f"layers.{leaf}"][i]
    return sd


def save_hf_checkpoint(params: dict[str, torch.Tensor], cfg: ModelConfig, out_dir: str) -> str:
    """Write ``params`` as a loadable HF checkpoint directory (config.json and
    safetensors): ``LlamaForCausalLM``, ``MistralForCausalLM`` for a window,
    ``GemmaForCausalLM``, ``Qwen3ForCausalLM`` or ``GPT2LMHeadModel``.
    Returns ``out_dir``."""
    from transformers import (
        GemmaForCausalLM,
        GPT2LMHeadModel,
        LlamaForCausalLM,
        MistralForCausalLM,
    )

    hf_cfg = hf_config_from(cfg)
    if cfg.arch == "gpt2":
        model_cls, to_hf = GPT2LMHeadModel, to_hf_gpt2
    elif cfg.arch == "gemma":
        model_cls, to_hf = GemmaForCausalLM, to_hf_llama
    elif cfg.arch == "qwen":
        from transformers import Qwen3ForCausalLM

        model_cls, to_hf = Qwen3ForCausalLM, to_hf_llama
    elif cfg.sliding_window:
        model_cls, to_hf = MistralForCausalLM, to_hf_llama
    else:
        model_cls, to_hf = LlamaForCausalLM, to_hf_llama
    sd = {k: torch.tensor(v) for k, v in to_hf(params, cfg).items()}
    # On the meta device no second weight copy is allocated (or randomly
    # initialised) only to be overwritten: assign=True adopts these tensors.
    with torch.device("meta"):
        model = model_cls(hf_cfg)
    missing, unexpected = model.load_state_dict(sd, strict=False, assign=True)
    # Tied weights (gemma's and gpt2's lm_head) have no tensor of their own;
    # tie_weights() points them at the embedding after the load.
    tied = set(getattr(model_cls, "_tied_weights_keys", None) or [])
    bad = [m for m in missing if "rotary" not in m and "inv_freq" not in m and m not in tied]
    if unexpected or bad:
        raise ValueError(f"export mismatch: missing={missing} unexpected={unexpected}")
    model.tie_weights()
    model.save_pretrained(out_dir)
    return out_dir
