"""ZeRO stages as placements on the mesh (port of the pure half of
``tpu_engine/sharding.py``).

====== ============================ ============================ ==========================
stage  params                       gradients                    optimizer state
====== ============================ ============================ ==========================
0      replicated                   all-reduced (replicated)     replicated
1      replicated                   all-reduced (replicated)     sharded over ``fsdp``
2      replicated                   reduce-scattered to shards   sharded over ``fsdp``
3      sharded over ``fsdp``        reduce-scattered to shards   sharded over ``fsdp``
====== ============================ ============================ ==========================

Every leaf carries logical axis names (:func:`logical_axes`, JAX's tree
flattened to the port's dotted keys); :func:`logical_to_mesh_axes` maps
them to mesh axes for a stage. The port has no ``PartitionSpec``: a spec
is a tuple of mesh-axis names (or None), trailing Nones trimmed, the
entries of JAX's ``PartitionSpec``. The train program on a mesh
(``tpu_engine_torch/parallel/zero.py``) reads the dim where ``fsdp``
lands and shards that dim.

Where ``model`` falls (:func:`model_split`): JAX's GSPMD may split a dim
anywhere; the port computes with whole heads, whole experts and whole
vocabulary blocks, under one rule:

- ``n_heads``, ``d_ff`` (dense MLP) and ``n_experts`` (MoE) must divide
  by ``model``, else ``NotImplementedError``; heads split by whole heads;
- ``n_kv_heads`` divisible by ``model``: K and V split with their heads.
  ``model`` divisible by ``n_kv_heads``: K and V stay whole on every rank
  and each rank reads the one kv head its query heads read (``jnp.repeat``'s
  order, :func:`local_kv_heads`). Neither: ``NotImplementedError``;
- a vocabulary that does not divide by ``model`` (gpt2's 50257): the table
  and the head stay whole on every rank (no padding), and the rank computes
  every logit.

A leaf ``model`` leaves whole may get only part of its gradient on a rank
(:func:`model_partial`): qwen's q/k norm scales and whole K/V kernels
(used on the rank's heads alone), the MoE router (each rank's combine
covers its own experts), and LoRA's whole factors: A of a column-split
target (every rank's B columns pull on it) and B of a row-split one (its
term is applied to the rank's partial ``x·A`` before ``g`` sums it). Those
gradients are summed over ``model``; every other whole leaf gets the whole
gradient on every rank.

Where ``pipe`` falls (:func:`stage_keys`, :func:`resolve_pipeline_schedule`):
the ``layers`` → ``pipe`` rule of ``_PIPE_AXES`` gives stage p the
contiguous block of ``n_layers / pipe`` layers starting at p · L/P of every
stacked leaf; the outer leaves live on the stage that uses them (Megatron's
placement, where JAX replicates them over ``pipe``): the embedding and
gpt2's positions on the first stage, the final norm and the head on the
last, a tied table (gpt2, gemma) on both.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Optional, Sequence


class ShardingStage(IntEnum):
    """JAX's ``ShardingStage``: the ZeRO stage."""

    DISABLED = 0
    OPTIMIZER_STATE = 1
    GRADIENT_PARTITIONING = 2
    FULL_PARTITIONING = 3


# Tensor-parallel placement: which logical axes ride the "model" mesh axis,
# "expert" first (a spec may not reuse a mesh axis).
_TP_AXES = {"expert": "model", "vocab": "model", "heads": "model",
            "kv_heads": "model", "mlp": "model"}

# FSDP placement: which logical axes ride the "fsdp" mesh axis (params at
# stage 3; gradients at stage >= 2; optimizer state at stage >= 1).
_FSDP_AXES = {"embed": "fsdp"}

# Pipeline placement: the stacked-layer dimension over the "pipe" axis.
_PIPE_AXES = {"layers": "pipe"}

Spec = tuple[Optional[str], ...]


def logical_to_mesh_axes(logical: Sequence[Optional[str]], *, shard_fsdp: bool,
                         shard_tp: bool = True) -> Spec:
    """Map a tuple of logical axis names to a spec (JAX's function, with a
    tuple for its ``PartitionSpec``). Each mesh axis is used at most once;
    among tensor-parallel candidates the earlier in ``_TP_AXES`` wins."""
    priority = {name: i for i, name in enumerate(_TP_AXES)}
    tp_winner: Optional[str] = None
    if shard_tp:
        candidates = [ax for ax in logical if ax in _TP_AXES]
        if candidates:
            tp_winner = min(candidates, key=lambda a: priority[a])
    out: list[Optional[str]] = []
    used: set[str] = set()
    for ax in logical:
        mesh_ax: Optional[str] = None
        if ax is not None:
            if ax in _PIPE_AXES and _PIPE_AXES[ax] not in used:
                mesh_ax = _PIPE_AXES[ax]
            elif ax == tp_winner and _TP_AXES[ax] not in used:
                mesh_ax = _TP_AXES[ax]
            elif shard_fsdp and ax in _FSDP_AXES and _FSDP_AXES[ax] not in used:
                mesh_ax = _FSDP_AXES[ax]
        if mesh_ax is not None:
            used.add(mesh_ax)
        out.append(mesh_ax)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _specs(logical: dict[str, tuple], shard_fsdp: bool) -> dict[str, Spec]:
    return {k: logical_to_mesh_axes(lg, shard_fsdp=shard_fsdp) for k, lg in logical.items()}


def param_pspecs(logical: dict[str, tuple], stage: int) -> dict[str, Spec]:
    """Specs of the parameters under ``stage``: fsdp-sharded at stage 3."""
    return _specs(logical, stage >= ShardingStage.FULL_PARTITIONING)


def grad_pspecs(logical: dict[str, tuple], stage: int) -> dict[str, Spec]:
    """Specs of the gradients: reduce-scattered to fsdp shards at stage >= 2."""
    return _specs(logical, stage >= ShardingStage.GRADIENT_PARTITIONING)


def opt_state_pspecs(logical: dict[str, tuple], stage: int) -> dict[str, Spec]:
    """Specs of the optimizer-state leaves shaped like params: sharded at
    stage >= 1."""
    return _specs(logical, stage >= ShardingStage.OPTIMIZER_STATE)


def logical_axes(cfg) -> dict[str, tuple]:
    """The logical axes of each parameter of ``cfg`` (JAX's
    ``tpu_engine.models.transformer.logical_axes``), keyed as the port's
    flat parameter dict."""
    if cfg.arch == "gpt2":
        return {
            "embed.embedding": ("vocab", "embed"),
            "pos_embed.embedding": (None, "embed"),
            "layers.attn_norm.scale": ("layers", "embed"),
            "layers.attn_norm.bias": ("layers", "embed"),
            "layers.q.kernel": ("layers", "embed", "heads"),
            "layers.q.bias": ("layers", "heads"),
            "layers.k.kernel": ("layers", "embed", "heads"),
            "layers.k.bias": ("layers", "heads"),
            "layers.v.kernel": ("layers", "embed", "heads"),
            "layers.v.bias": ("layers", "heads"),
            "layers.o.kernel": ("layers", "heads", "embed"),
            "layers.o.bias": ("layers", "embed"),
            "layers.mlp_norm.scale": ("layers", "embed"),
            "layers.mlp_norm.bias": ("layers", "embed"),
            "layers.fc.kernel": ("layers", "embed", "mlp"),
            "layers.fc.bias": ("layers", "mlp"),
            "layers.proj.kernel": ("layers", "mlp", "embed"),
            "layers.proj.bias": ("layers", "embed"),
            "final_norm.scale": ("embed",),
            "final_norm.bias": ("embed",),
        }
    out = {
        "embed.embedding": ("vocab", "embed"),
        "layers.attn_norm.scale": ("layers", "embed"),
        "layers.q.kernel": ("layers", "embed", "heads"),
        "layers.k.kernel": ("layers", "embed", "kv_heads"),
        "layers.v.kernel": ("layers", "embed", "kv_heads"),
        "layers.o.kernel": ("layers", "heads", "embed"),
        "layers.mlp_norm.scale": ("layers", "embed"),
    }
    if cfg.arch == "qwen":
        out["layers.q_norm.scale"] = ("layers", None)
        out["layers.k_norm.scale"] = ("layers", None)
    if cfg.is_moe:
        out["layers.router.kernel"] = ("layers", "embed", None)
        out["layers.gate.kernel"] = ("layers", "expert", "embed", "mlp")
        out["layers.up.kernel"] = ("layers", "expert", "embed", "mlp")
        out["layers.down.kernel"] = ("layers", "expert", "mlp", "embed")
    else:
        out["layers.gate.kernel"] = ("layers", "embed", "mlp")
        out["layers.up.kernel"] = ("layers", "embed", "mlp")
        out["layers.down.kernel"] = ("layers", "mlp", "embed")
    out["final_norm.scale"] = ("embed",)
    if cfg.arch != "gemma":  # gemma ties the head to the embedding
        out["lm_head.kernel"] = ("embed", "vocab")
    return out


def lora_logical_axes(model_logical: dict[str, tuple],
                      targets: Sequence[str]) -> dict[str, tuple]:
    """The adapters' axes (JAX's ``lora_logical_axes``): A takes its
    target's (layers, in), B its (layers, out); the rank axis is never
    sharded."""
    out = {}
    for t in targets:
        lyr, in_ax, out_ax = model_logical[f"layers.{t}.kernel"]
        out[f"layers.{t}.A"] = (lyr, in_ax, None)
        out[f"layers.{t}.B"] = (lyr, None, out_ax)
    return out


def fsdp_dim(spec: Spec) -> Optional[int]:
    """The dim of a spec that ``fsdp`` shards, or None."""
    return spec.index("fsdp") if "fsdp" in spec else None


def model_dim(spec: Spec) -> Optional[int]:
    """The dim of a spec that ``model`` shards, or None."""
    return spec.index("model") if "model" in spec else None


def kv_heads(cfg) -> int:
    return cfg.n_heads if cfg.arch == "gpt2" else cfg.n_kv_heads  # gpt2's k, v are full width


def check_model_axis(cfg, n_model: int) -> None:
    """Refuse a model whose heads, MLP or experts do not split over
    ``n_model`` ranks by the module's rule. JAX's program does not train
    such a model either: its shardings need each split dim to divide by
    the axis (gpt2-xl's 25 heads at model=2 fail its jit)."""
    if n_model == 1:
        return
    kv = kv_heads(cfg)
    bad = [f"{name}={n}" for name, n, on in (
        ("n_heads", cfg.n_heads, True), ("d_ff", cfg.d_ff, not cfg.is_moe),
        ("n_experts", cfg.n_experts, cfg.is_moe)) if on and n % n_model]
    if kv % n_model and n_model % kv:
        bad.append(f"n_kv_heads={kv} (neither divides the other)")
    if bad:
        raise NotImplementedError(
            f"model {cfg.name!r} does not split over model={n_model}: {', '.join(bad)} "
            "(a rank holds whole heads, MLP columns and experts; JAX's program refuses "
            "it too, its shardings needing each split dim to divide by the axis)")


def model_split(cfg, logical: dict[str, tuple], n_model: int) -> dict[str, Optional[int]]:
    """The dim of each leaf that ``model`` splits over ``n_model`` ranks, or
    None for a leaf whole on every rank (the module's rule)."""
    if n_model == 1:
        return {k: None for k in logical}
    check_model_axis(cfg, n_model)
    whole = {"kv_heads": kv_heads(cfg) % n_model != 0,
             "vocab": cfg.vocab_size % n_model != 0}
    out = {}
    for k, lg in logical.items():
        d = model_dim(logical_to_mesh_axes(lg, shard_fsdp=False))
        out[k] = None if d is None or whole.get(lg[d], False) else d
    return out


def model_partial(cfg, logical: dict[str, tuple], n_model: int) -> frozenset:
    """The leaves ``model`` leaves whole whose gradient a rank gets only in
    part (summed over ``model``)."""
    if n_model == 1:
        return frozenset()
    split = model_split(cfg, logical, n_model)
    keys = {"layers.q_norm.scale", "layers.k_norm.scale", "layers.router.kernel",
            "layers.k.kernel", "layers.v.kernel", "layers.k.bias", "layers.v.bias"}
    base = logical_axes(cfg)
    kernels = model_split(cfg, base, n_model)
    whole_kv = {k for k in keys if k in base and kernels[k] is None}
    out = {k for k in keys if k in logical and split[k] is None}
    # LoRA's factors (lora_logical_axes: A (layers, in, None), B (layers,
    # None, out)); the kernel's own split says which factor is partial.
    for k in logical:
        target, _, factor = k.rpartition(".")
        if factor not in ("A", "B") or split[k] is not None:
            continue
        d = kernels[f"{target}.kernel"]
        if (d == 2 and factor == "A"          # column-split: B's columns pull on A
                or d == 1 and factor == "B"   # row-split: B's term sums over model
                or f"{target}.kernel" in whole_kv):  # whole K/V, a kv head a rank
            out.add(k)
    return frozenset(out)


def whole_shapes(cfg, lora_targets=(), lora_rank: int = 1) -> dict[str, tuple]:
    """The whole shape of every leaf of ``cfg`` (and of the adapters of
    ``lora_targets``, at ``lora_rank``), keyed as the port's flat dict."""
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, KV, HD, V, E = cfg.n_heads, kv_heads(cfg), cfg.head_dim, cfg.vocab_size, cfg.n_experts
    out = {}
    for k, lg in logical_axes(cfg).items():
        size = {"vocab": V, "embed": D, "layers": L, "heads": H * HD, "kv_heads": KV * HD,
                "mlp": F, "expert": E, None: None}
        shape = [size[a] for a in lg]
        if k == "pos_embed.embedding":
            shape[0] = cfg.max_seq_len
        elif k in ("layers.q_norm.scale", "layers.k_norm.scale"):
            shape[1] = HD
        elif k == "layers.router.kernel":
            shape[2] = E
        out[k] = tuple(shape)
    for t in lora_targets:
        lyr, i, o = out[f"layers.{t}.kernel"]
        out[f"layers.{t}.A"] = (lyr, i, lora_rank)
        out[f"layers.{t}.B"] = (lyr, lora_rank, o)
    return out


def local_kv_heads(cfg, n_model: int, index: int) -> tuple[int, int]:
    """(first, count) of the kv heads that rank ``index`` of ``n_model``
    reads: its own block where the kv heads split, else the one kv head of
    its query heads' group."""
    kv = kv_heads(cfg)
    if kv % n_model == 0:
        per = kv // n_model
        return index * per, per
    group = cfg.n_heads // kv
    return index * (cfg.n_heads // n_model) // group, 1


# ---------------------------------------------------------------------------
# Pipelines (``pipe``)
# ---------------------------------------------------------------------------

PIPELINE_SCHEDULES = ("auto", "gpipe", "1f1b", "zb")


def resolve_pipeline_schedule(cfg) -> str:
    """JAX's ``resolve_pipeline_schedule``: ``"auto"`` is zb where the
    microbatches outnumber the stages and the manual-vjp schedules support
    the config (no chunked exit loss, no int8 training's custom backward,
    no reduced-dtype gradient collectives), gpipe otherwise; an explicit
    schedule is kept."""
    if cfg.pipeline_schedule != "auto":
        return cfg.pipeline_schedule
    unsupported_manual = (
        bool(cfg.loss_chunk_size)
        or cfg.quant_training != "none"
        or (cfg.grad_allreduce_dtype is not None and cfg.grad_allreduce_dtype != "fp32")
    )
    if (cfg.mesh.pipe > 1 and cfg.gradient_accumulation_steps > cfg.mesh.pipe
            and not unsupported_manual):
        return "zb"
    return "gpipe"


def outer_stages(cfg, key: str, n_stages: int) -> tuple[int, ...]:
    """The stages that hold the non-layer leaf ``key``: the embedding (and
    gpt2's position table) on the first, the final norm and an untied head
    on the last, a tied table (gpt2, gemma) on both."""
    last = n_stages - 1
    if key == "embed.embedding":
        return (0, last) if cfg.arch in ("gpt2", "gemma") and last else (0,)
    if key == "pos_embed.embedding":
        return (0,)
    return (last,)


def stage_keys(cfg, keys, n_stages: int, index: int) -> list[str]:
    """The leaves of ``keys`` that stage ``index`` of ``n_stages`` holds:
    every stacked leaf (its block of layers) and the outer leaves it uses."""
    return [k for k in keys if k.startswith("layers.")
            or index in outer_stages(cfg, k, n_stages)]


def stage_layers(n_layers: int, n_stages: int, index: int) -> tuple[int, int]:
    """(first layer, layers) of stage ``index``: its contiguous block."""
    if n_layers % n_stages:
        raise ValueError(f"n_layers={n_layers} not divisible by pipeline stages={n_stages}")
    per = n_layers // n_stages
    return index * per, per
