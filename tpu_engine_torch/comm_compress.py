"""ZeRO++-style quantized and hierarchical collectives for stage 3 (port of
``tpu_engine/comm_compress.py``).

Three composable mechanisms cut the bytes the stage-3 step moves:

- **qwZ** (``comm_quant_weights``): each ``fsdp`` shard of a ``kernel`` or
  ``embedding`` leaf is block-quantized to int8 (per-block absmax/127
  scales) before the weight all-gather, so the ``fsdp`` collective moves
  one byte an element plus an fp32 scale a block; every rank dequantizes
  after the gather. The gather's backward is the exact fp32 reduce-scatter
  (a straight-through estimator).
- **hpZ** (``comm_secondary_weights``): ``state["hpz"]``, the int8 codes
  and scales of the rank's shards, refreshed from the primary shards after
  each update (:meth:`Compression.refresh`); the gathers read it instead of
  quantizing again.
- **qgZ** (``comm_quant_grads``): on a mesh of several slices
  (``dcn_data > 1``) a gradient is summed in fp32 inside its slice, then
  its block-quantized int8 codes and scales are all-gathered across the
  slices and summed after dequantizing. Rounding is stochastic and
  unbiased (:func:`stochastic_round`, a counter hash salted by the data,
  where JAX draws from a key), and the blocks are of the flattened
  gradient, where JAX's run along its last axis (padding each row to a
  whole block: a shard's row shorter than the block would cross the
  slices in more bytes than it holds).

JAX runs the step in one full-manual ``shard_map`` so that the operand's
dtype is the wire's. The port's collectives are explicit calls on plain
local tensors already (``parallel/collectives.py``): the gathers and their
backward live in the stage-3 layer stream (``parallel/zero.py``), which
asks :class:`Compression` for each leaf. The collective counters record
each call's dtype and whether its group crosses a slice, which
:func:`collective_stats` reads in place of JAX's HLO text.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from tpu_engine_torch.parallel import collectives
from tpu_engine_torch.parallel.collectives import all_reduce_, gather_dim
from tpu_engine_torch.quant_train import _data_salt, stochastic_round

# Leaf names whose (>= 2-D, fsdp-sharded) tensors ride the quantized
# gather; norm scales and biases gather full width.
_QUANT_LEAF_NAMES = ("kernel", "embedding")


# ---------------------------------------------------------------------------
# Blockwise int8 quantization (last-axis blocks, absmax/127 scales)
# ---------------------------------------------------------------------------


def _n_blocks(last: int, block: int) -> int:
    return -(-last // block)


def blockwise_quantize(x: torch.Tensor, block: int, stochastic: bool = False,
                       salt=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization in blocks of ``block`` along the last
    axis: ``(codes, scales)``, the codes int8 with the last axis padded to
    ``n_blocks * block``, the scales fp32 ``x.shape[:-1] + (n_blocks,)``.
    Round to nearest (half to even, as ``jnp.round``); ``stochastic``
    rounds by :func:`stochastic_round`, salted by the data (``salt``: an
    explicit one). A shard's codes keep its whole block grid, so gathered
    codes always reshape to ``(..., n_blocks, block)``."""
    last = x.shape[-1]
    nb = _n_blocks(last, block)
    pad = nb * block - last
    xf = x.float()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    xb = xf.reshape(*x.shape[:-1], nb, block)
    absmax = torch.amax(torch.abs(xb), dim=-1)
    scales = torch.clamp_min(absmax, 1e-30) / 127.0
    y = xb / scales[..., None]
    if stochastic or salt is not None:
        y = stochastic_round(y, _data_salt(xf) if salt is None else salt)
    else:
        y = torch.round(y)
    codes = torch.clamp(y, -127.0, 127.0).to(torch.int8)
    return codes.reshape(*x.shape[:-1], nb * block), scales


def blockwise_dequantize(codes: torch.Tensor, scales: torch.Tensor, block: int,
                         last: Optional[int] = None, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`blockwise_quantize`: trimmed to ``last`` elements
    on the final axis (default: the codes' padded extent)."""
    nb = codes.shape[-1] // block
    cb = codes.float().reshape(*codes.shape[:-1], nb, block)
    out = (cb * scales[..., None]).reshape(*codes.shape[:-1], nb * block)
    if last is not None and last != out.shape[-1]:
        out = out[..., :last]
    return out.to(dtype)


def _dequantize_gathered(codes_g: torch.Tensor, scales_g: torch.Tensor, *, gather_dim: int,
                         block: int, shard_last: int, global_last: int, dtype) -> torch.Tensor:
    """Dequantize codes gathered along ``gather_dim``. Gathered along the
    last axis, each shard brought its own padded block grid: dequantize,
    trim each segment to the shard's extent and join them."""
    if gather_dim != codes_g.ndim - 1:
        return blockwise_dequantize(codes_g, scales_g, block, last=global_last, dtype=dtype)
    n_shards = global_last // shard_last
    seg = codes_g.shape[-1] // n_shards
    full = blockwise_dequantize(codes_g, scales_g, block, dtype=dtype)
    full = full.reshape(*full.shape[:-1], n_shards, seg)[..., :shard_last]
    return full.reshape(*full.shape[:-2], n_shards * shard_last)


# ---------------------------------------------------------------------------
# Slices of the data axis
# ---------------------------------------------------------------------------


def data_slice_groups(data_size: int, dcn_data: int) -> tuple[list[list[int]], list[list[int]]]:
    """(intra-slice, cross-slice) groups of data indices: whole slices are
    the outer blocks of the data axis, so indices ``[s*k, (s+1)*k)`` share
    slice ``s`` (``k = data / dcn_data``); a cross group joins the same
    position of every slice."""
    if data_size % dcn_data != 0:
        raise ValueError(f"data axis {data_size} not divisible by dcn_data={dcn_data}")
    per = data_size // dcn_data
    intra = [list(range(s * per, (s + 1) * per)) for s in range(dcn_data)]
    cross = [[s * per + i for s in range(dcn_data)] for i in range(per)]
    return intra, cross


def slice_of_partition(mesh_shape: dict[str, int], dcn_data: int) -> list[int]:
    """Rank (partition) → slice for a mesh of slices: ranks are the
    row-major flattening of the mesh, whose outer data blocks are whole
    slices."""
    total = 1
    for v in mesh_shape.values():
        total *= v
    data = mesh_shape.get("data", 1)
    inner = total // data
    per_slice_data = data // dcn_data
    return [(p // inner) // per_slice_data if per_slice_data else 0 for p in range(total)]


# ---------------------------------------------------------------------------
# Per-leaf plans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LeafPlan:
    """How one parameter leaf moves through the compressed step."""

    fsdp_dim: Optional[int]  # the dim "fsdp" splits in the leaf's spec
    quantize: bool           # rides the int8 gather (qwZ/hpZ)
    global_last: int         # whole extent of the leaf's final axis
    shard_last: int          # a shard's extent of the final axis


def build_leaf_plans(pspecs: dict[str, tuple], shapes: dict[str, tuple], fsdp_size: int,
                     quant_weights: bool) -> dict[str, LeafPlan]:
    """A :class:`LeafPlan` a leaf, from its stage-3 spec (a tuple of mesh
    axes, ``sharding.param_pspecs``) and its whole shape."""
    plans = {}
    for key, spec in pspecs.items():
        shape = tuple(shapes[key])
        fsdp_dim = spec.index("fsdp") if "fsdp" in spec else None
        if fsdp_dim is not None and shape[fsdp_dim] % fsdp_size != 0:
            raise ValueError(
                f"comm compression: leaf {key} dim {fsdp_dim} ({shape[fsdp_dim]}) is not "
                f"divisible by the fsdp axis size {fsdp_size}")
        shard_last = shape[-1]
        if fsdp_dim == len(shape) - 1:
            shard_last = shape[-1] // fsdp_size
        quantize = (quant_weights and fsdp_dim is not None and len(shape) >= 2
                    and key.rsplit(".", 1)[-1] in _QUANT_LEAF_NAMES)
        plans[key] = LeafPlan(fsdp_dim, quantize, shape[-1], shard_last)
    return plans


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def enabled(cfg) -> bool:
    """True when any comm-compression mechanism is on for ``cfg``."""
    return bool(cfg.comm_quant_weights or cfg.comm_secondary_weights or cfg.comm_quant_grads)


def validate_config(cfg) -> None:
    """JAX's ``_validate_comm_compression`` (``tpu_engine/sharding.py``),
    with its messages."""
    if not enabled(cfg):
        return
    if cfg.comm_secondary_weights and not cfg.comm_quant_weights:
        raise ValueError(
            "comm_secondary_weights (hpZ) requires comm_quant_weights "
            "(qwZ): the secondary replica IS the quantized gather source")
    if cfg.sharding_stage != 3:
        raise ValueError(
            "comm compression requires sharding_stage=3 (the quantized "
            "all-gather replaces the ZeRO-3 fsdp weight gather; stages "
            "0-2 keep params replicated and gather nothing)")
    if cfg.pipeline_schedule in ("1f1b", "zb"):
        raise ValueError(
            f"comm compression with pipeline_schedule="
            f"{cfg.pipeline_schedule!r} is not supported (the manual "
            "per-stage vjp owns the grad collectives)")
    if cfg.grad_allreduce_dtype not in (None, "fp32"):
        raise ValueError(
            "comm compression with reduced-precision "
            f"grad_allreduce_dtype={cfg.grad_allreduce_dtype!r} "
            "is redundant and unsupported — qgZ already quantizes the "
            "cross-slice reduction")
    if cfg.lora_rank is not None:
        raise ValueError(
            "comm compression with LoRA is unsupported (adapter grads "
            "are rank-sized; there is nothing worth compressing)")
    if cfg.param_offload != "none":
        raise ValueError(
            "comm compression with param_offload is unsupported (the "
            "compressed gather sources device-resident shards)")
    if cfg.optimizer_offload == "disk":
        raise ValueError(
            "comm compression with optimizer_offload='disk' is "
            "unsupported (the disk tier drives its own grad path)")
    for ax in ("pipe", "sequence", "model"):
        if getattr(cfg.mesh, ax) > 1:
            raise ValueError(
                f"comm compression requires mesh.{ax}=1: the quantized "
                "collectives run in a full-manual shard_map over "
                "(data, fsdp) only")
    if cfg.attention_impl in ("flash", "ring", "ulysses"):
        raise ValueError(
            f"comm compression with attention_impl="
            f"{cfg.attention_impl!r} is unsupported (kernel attention "
            "is a shard_map region and cannot nest inside the "
            "compression region) — use 'auto' or 'xla'")


def validate_runtime(cfg, sizes: dict[str, int], model_cfg, attention_impl: str) -> None:
    """JAX's build-time refusals (``validate_runtime``) with its messages:
    the mesh's real extents, the resolved attention (the port's ``auto`` is
    the flash kernels on a card) and MoE."""
    for ax in ("pipe", "sequence", "model"):
        if sizes[ax] > 1:
            raise ValueError(
                f"comm compression requires a mesh with {ax}=1 (got "
                f"{sizes[ax]}): the quantized collectives run in a "
                "full-manual shard_map over (data, fsdp) only")
    if attention_impl != "xla":
        raise ValueError(
            "comm compression requires attention_impl='xla' (the "
            "flash/ring/ulysses kernels are shard_map regions and cannot "
            "nest inside the compression region)")
    if model_cfg.is_moe:
        raise ValueError(
            "comm compression does not support MoE models (the router aux "
            "loss is a batch mean whose per-shard decomposition differs "
            "from the global mean)")


# ---------------------------------------------------------------------------
# The mechanisms, bound to one program
# ---------------------------------------------------------------------------


class Compression:
    """The compressed collectives of one stage-3 program on ``runtime``.
    ``plans``: :func:`build_leaf_plans`. The layer stream calls
    :meth:`gather` for a leaf that :meth:`quantizes`, and the layout
    :meth:`reduce_data` for each gradient under qgZ."""

    def __init__(self, runtime, plans: dict[str, LeafPlan], block: int, *,
                 quant_weights: bool, secondary_weights: bool, quant_grads: bool):
        self.plans = plans
        self.block = int(block)
        self.quant_weights = quant_weights
        self.secondary_weights = secondary_weights
        self.quant_grads = quant_grads
        self.fsdp = runtime.group("fsdp")
        self.data = runtime.group("data")
        self.dcn_data = runtime.config.dcn_data
        self.intra, self.cross = runtime.slice_groups()

    def quantizes(self, key: str) -> bool:
        return self.plans[key].quantize

    def gather(self, src: torch.Tensor, key: str, dim: int, dtype, hpz=None,
               index: Optional[int] = None) -> torch.Tensor:
        """qwZ: the whole leaf (or layer ``index`` of it) from this rank's
        shard ``src``, its int8 codes and fp32 scales gathered over
        ``fsdp`` along ``dim`` and dequantized to ``dtype``. hpZ: the codes
        and scales are read from ``hpz`` instead."""
        plan = self.plans[key]
        if hpz is not None:
            codes, scales = hpz["codes"][key], hpz["scales"][key]
            if index is not None:
                codes, scales = codes[index], scales[index]
        else:
            codes, scales = blockwise_quantize(src, self.block)
        codes_g = gather_dim(codes, dim, self.fsdp)
        scales_g = gather_dim(scales, dim, self.fsdp)
        return _dequantize_gathered(codes_g, scales_g, gather_dim=dim, block=self.block,
                                    shard_last=plan.shard_last, global_last=plan.global_last,
                                    dtype=dtype)

    def reduce_data(self, g: torch.Tensor) -> torch.Tensor:
        """The sum of ``g`` over ``data``: qgZ across slices (fp32 inside
        the slice, int8 codes and scales across), a plain fp32 sum
        otherwise (one slice: no cross-slice link to compress)."""
        if self.data is None:
            return g
        if not self.quant_grads or self.dcn_data == 1:
            return all_reduce_(g.contiguous(), self.data)
        if self.intra is not None:
            g = all_reduce_(g.contiguous(), self.intra)
        flat = g.reshape(-1)
        codes, scales = blockwise_quantize(flat, self.block, stochastic=True)
        codes_x = gather_dim(codes.unsqueeze(0), 0, self.cross)
        scales_x = gather_dim(scales.unsqueeze(0), 0, self.cross)
        parts = blockwise_dequantize(codes_x, scales_x, self.block, last=flat.numel())
        return parts.sum(dim=0).reshape(g.shape)

    @torch.no_grad()
    def refresh(self, params: dict[str, torch.Tensor]) -> Optional[dict]:
        """hpZ: the secondary store, the codes and scales of the rank's
        shards of every quantized leaf (None without hpZ)."""
        if not self.secondary_weights:
            return None
        return refresh_hpz(params, self.block, [k for k in params if self.quantizes(k)])


@torch.no_grad()
def refresh_hpz(params: dict[str, torch.Tensor], block: int, keys) -> dict:
    """``{"codes": {key: int8}, "scales": {key: fp32}}`` of ``params``'s
    leaves ``keys``, each quantized as :func:`blockwise_quantize`."""
    codes, scales = {}, {}
    for k in keys:
        codes[k], scales[k] = blockwise_quantize(params[k], block)
    return {"codes": codes, "scales": scales}


# ---------------------------------------------------------------------------
# Wire accounting
# ---------------------------------------------------------------------------

_HLO_OPS = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
            "all_reduce": "all-reduce", "all_to_all": "all-to-all", "send": "collective-permute"}


def collective_stats(records: Optional[dict] = None) -> dict[str, Any]:
    """The wire bytes of the collectives counted since
    ``collectives.reset_moved`` (default: this rank's counters), as JAX's
    ``collective_stats`` reports them from HLO: ``total_wire_bytes``,
    ``cross_slice_bytes`` and an entry a (collective, dtype, group size,
    crossing) with its calls. The ring cost model is JAX's: an all-gather
    or reduce-scatter moves (g − 1)/g of its payload, an all-reduce twice
    that, a send its payload; the payload is the whole tensor the ring
    moves (the gather's output, the reduce-scatter's input). A collective
    whose group spans two slices counts in ``cross_slice_bytes``."""
    records = collectives.records if records is None else records
    ops, total, cross = [], 0, 0
    for (kind, dtype, g, crossing), (calls, wire, payload) in sorted(records.items()):
        total += wire
        if crossing:
            cross += wire
        ops.append({"op": _HLO_OPS[kind], "dtype": dtype, "bytes": int(wire),
                    "payload_bytes": int(payload), "group_size": g,
                    "cross_slice": crossing, "calls": calls})
    return {"total_wire_bytes": int(total), "cross_slice_bytes": int(cross), "collectives": ops}


def expected_volume_factors(block_size: int) -> dict[str, float]:
    """Analytic per-element wire reduction: int8 codes + fp32 per-block
    scales versus fp32 full width."""
    f = 4.0 / (1.0 + 4.0 / block_size)
    return {"weight_gather": f, "grad_cross_slice": f}
