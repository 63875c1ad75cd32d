"""AQT-style int8 quantised training (port of ``tpu_engine/quant_train.py``).

The targeted training products (the attention projections, the dense MLP,
the MoE expert products) run as int8 × int8 → int32 products:

- **per-channel symmetric scales over the contraction axes** of both
  operands: absmax over exactly the axes the einsum sums away, kept as
  size-1 dims, so each output element is the int32 dot of two int8 vectors
  rescaled by its row scale times its column scale;
- **int32 accumulation**: ``torch._int_mm``, the product JAX asks of XLA with
  ``preferred_element_type=jnp.int32`` (JAX computes it outside any Pallas
  kernel, so the port takes the library's product too);
- **dequantised by the outer product of the scales**, in fp32, then cast to
  the operands' dtype;
- **straight-through backward**: the two transpose products run through the
  same int8 product, their operands rounded stochastically (``floor(v +
  u)``), so the error is zero-mean and does not bias the master update.

The forward rounds to nearest (``torch.round``, half to even, as
``jnp.round``), so its codes and int32 sums equal JAX's exactly.

On a mesh (:func:`token_scales`) the weight gradient's product, which sums
over the tokens, takes its operands' absmax over every rank that holds a
part of the microbatch (a max all-reduce), as JAX's GSPMD program computes
it over the global batch; the other two products contract a feature dim a
rank holds whole. Under the compressed collectives JAX runs the loss in a
manual region, where each device's scales are its own, and so does the port.

The stochastic rounding's random numbers come from the data, as in JAX: a
salt is the bit pattern of the operand's fp32 sum, read on the device, so a
step is a pure function of its inputs (a restart reproduces it), layers and
steps draw different noise, and nothing is read on the host. JAX folds the
salt into a threefry key; the port hashes it with each element's index
(:mod:`tpu_engine_torch.counter_hash`), so the bits differ from JAX's while
the contract (unbiased, data-keyed, reproducible) is the same.

``torch._int_mm`` on the card wants more than 16 rows and a contraction and
column count that are multiples of 8. Every product here is flattened to
2-D ([M, K] row-major against a column-major [K, N]), batch labels (the MoE
expert axis) loop, and the rows, the contraction and the columns are padded
with zero codes, which add exactly nothing to the int32 sums. A shape the
product still refuses raises; nothing falls back to a float product.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_engine_torch.counter_hash import _M32, _mix32, _uniform
from tpu_engine_torch.parallel.collectives import all_reduce_

# Matmul groups a config can route through the int8 product: "attn" = the
# q/k/v/o projections; "mlp" = the dense MLP; "moe" = the per-expert
# products.
QUANT_TARGET_GROUPS = ("attn", "mlp", "moe")

# JAX's refusal of the "moe" target under ragged dispatch, at build and at
# the forward (``tpu_engine/train.py``, ``tpu_engine/models/transformer.py``).
RAGGED_MOE_REFUSAL = ("quant_training='int8' cannot quantize ragged MoE "
                      "(lax.ragged_dot takes no per-channel scales); use "
                      "moe_impl='dense' or drop 'moe' from quant_train_targets")

# Fixed base of the data-derived salt (JAX's base key): a constant, not a
# config seed, so the rounding does not depend on config plumbing.
_SR_BASE = 0x51AE7

# Elements hashed at a time by stochastic_round: bounds its int64
# temporaries to a few hundred MB on the largest operand.
_SR_CHUNK = 1 << 24

# Calls of torch._int_mm since the last reset_launches() (one per expert of
# a batched MoE product).
launches = {"int_mm": 0}


def reset_launches() -> None:
    launches["int_mm"] = 0


# The process group over which the weight gradient's product takes its
# token-contracted scales (None: this rank's own); :func:`token_scales`
# sets it for a mesh step.
_TOKEN_GROUP: list = [None]


@contextlib.contextmanager
def token_scales(group):
    """Within the block, the weight gradient's product reduces its
    operands' absmax over ``group`` (the ranks that split the tokens)."""
    prev, _TOKEN_GROUP[0] = _TOKEN_GROUP[0], group
    try:
        yield
    finally:
        _TOKEN_GROUP[0] = prev


def _data_salt(xf: torch.Tensor) -> torch.Tensor:
    """0-d int64 in [0, 2**32): the bit pattern of ``xf``'s fp32 sum, on
    ``xf``'s device."""
    bits = torch.sum(xf, dtype=torch.float32).view(torch.int32).to(torch.int64)
    return bits & _M32


def stochastic_round(y: torch.Tensor, salt) -> torch.Tensor:
    """Unbiased stochastic rounding ``floor(y + u)``, u in (0, 1) with mean
    exactly 1/2, drawn per element from a hash of (base, ``salt``, element
    index). ``salt`` is an int or a 0-d int64 tensor in [0, 2**32)."""
    key = _mix32(_mix32(torch.as_tensor(salt, dtype=torch.int64, device=y.device)
                        ^ _mix32(_SR_BASE)))
    flat = y.reshape(-1)
    out = torch.empty_like(flat)
    for start in range(0, flat.numel(), _SR_CHUNK):
        stop = min(start + _SR_CHUNK, flat.numel())
        idx = torch.arange(start, stop, dtype=torch.int64, device=y.device)
        out[start:stop] = torch.floor(flat[start:stop] + _uniform(_mix32(idx ^ key)))
    return out.view(y.shape)


def channel_quantize(x: torch.Tensor, axes: tuple[int, ...], stochastic: bool = False,
                     salt=None, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation with one scale per channel: absmax over
    the contraction ``axes``, kept as size-1 dims (and over the ranks of
    ``group``, whose parts of those axes it joins). Returns (codes int8,
    scales fp32) with ``x ≈ codes * scales``. ``stochastic`` rounds by
    :func:`stochastic_round`, salted by the data; an explicit ``salt`` draws
    another rounding of the same data (tests)."""
    xf = x.float()
    absmax = torch.amax(torch.abs(xf), dim=axes, keepdim=True)
    if group is not None:
        absmax = all_reduce_(absmax.contiguous(), group, op=dist.ReduceOp.MAX)
    scales = torch.clamp_min(absmax, 1e-30) / 127.0
    y = xf / scales
    if stochastic or salt is not None:
        y = stochastic_round(y, _data_salt(xf) if salt is None else salt)
    else:
        y = torch.round(y)
    return torch.clamp(y, -127.0, 127.0).to(torch.int8), scales


def _contraction_axes(spec: str) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Per-operand contraction axes of a two-operand einsum ``spec``: the
    positions of labels absent from the output. Batch labels (in the output,
    as ``e`` of the MoE products) stay per-channel."""
    operands, osub = spec.split("->")
    lsub, rsub = operands.split(",")
    return (tuple(i for i, c in enumerate(lsub) if c not in osub),
            tuple(i for i, c in enumerate(rsub) if c not in osub))


def _transpose_specs(spec: str) -> tuple[str, str]:
    """(dlhs spec, drhs spec) of ``l,r->o``: ``o,r->l`` and ``l,o->r``."""
    operands, osub = spec.split("->")
    lsub, rsub = operands.split(",")
    return f"{osub},{rsub}->{lsub}", f"{lsub},{osub}->{rsub}"


def _pad_to(n: int, multiple: int, least: int = 1) -> int:
    return max(-(-n // multiple) * multiple, least)


def int_mm(a: torch.Tensor, b_nk: torch.Tensor) -> torch.Tensor:
    """int8 ``a`` [M, K] times the transpose of int8 ``b_nk`` [N, K] → int32
    [M, N] by ``torch._int_mm``, its first operand row-major and its second
    column-major. Rows are padded to a multiple of 8 above 16, K and N to
    multiples of 8, all with zero codes."""
    M, K = a.shape
    N = b_nk.shape[0]
    Mp, Kp, Np = _pad_to(M, 8, 24), _pad_to(K, 8), _pad_to(N, 8)
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, K):
        b_nk = F.pad(b_nk, (0, Kp - K, 0, Np - N))
    launches["int_mm"] += 1
    out = torch._int_mm(a.contiguous(), b_nk.contiguous().t())
    return out[:M, :N]


def _codes_einsum(spec: str, ql: torch.Tensor, qr: torch.Tensor) -> torch.Tensor:
    """``einsum(spec, ql, qr)`` of int8 codes, summed in int32: each
    operand laid out as [batch, free, contraction], one :func:`int_mm` per
    batch index, the result permuted to the output's labels."""
    operands, osub = spec.split("->")
    lsub, rsub = operands.split(",")
    size = {**dict(zip(lsub, ql.shape)), **dict(zip(rsub, qr.shape))}
    batch = [c for c in osub if c in lsub and c in rsub]
    lfree = [c for c in osub if c in lsub and c not in rsub]
    rfree = [c for c in osub if c in rsub and c not in lsub]
    contr = [c for c in lsub if c not in osub]
    if sorted(contr) != sorted(c for c in rsub if c not in osub):
        raise ValueError(f"{spec!r}: every summed label must be in both operands")

    def arrange(t, sub, free):
        t = t.permute([sub.index(c) for c in batch + free + contr])
        return t.reshape(math.prod(size[c] for c in batch), math.prod(size[c] for c in free),
                         math.prod(size[c] for c in contr))

    a, b = arrange(ql, lsub, lfree), arrange(qr, rsub, rfree)
    out = torch.stack([int_mm(a[g], b[g]) for g in range(a.shape[0])])
    order = batch + lfree + rfree
    out = out.reshape([size[c] for c in order])
    return out.permute([order.index(c) for c in osub])


def _scales_outer(spec: str, sl: torch.Tensor, sr: torch.Tensor) -> torch.Tensor:
    """JAX's ``einsum(spec, sl, sr)`` of the keepdims scales, whose summed
    dims are size 1: the fp32 product of the two, each broadcast to the
    output's labels."""
    operands, osub = spec.split("->")
    lsub, rsub = operands.split(",")

    def to_out(s, sub):
        kept = [c for c in sub if c in osub]
        s = s.reshape([d for c, d in zip(sub, s.shape) if c in osub])
        s = s.permute([kept.index(c) for c in osub if c in kept])
        dims = iter(s.shape)
        return s.reshape([next(dims) if c in kept else 1 for c in osub])

    return to_out(sl, lsub) * to_out(sr, rsub)


def _quantized_dot(spec: str, lhs: torch.Tensor, rhs: torch.Tensor,
                   stochastic: bool, group=None) -> torch.Tensor:
    """One quantised einsum in fp32: int8 codes summed in int32, scaled by
    the outer product of the two operands' channel scales (their absmax
    over ``group`` too)."""
    laxes, raxes = _contraction_axes(spec)
    ql, sl = channel_quantize(lhs, laxes, stochastic=stochastic, group=group)
    qr, sr = channel_quantize(rhs, raxes, stochastic=stochastic, group=group)
    return _codes_einsum(spec, ql, qr).float() * _scales_outer(spec, sl, sr)


class _Int8Einsum(torch.autograd.Function):
    """Forward: round-to-nearest int8 product, cast to the operands'
    promoted dtype. Backward (straight-through): the two transpose products
    through the same int8 product with stochastic rounding; the weight
    gradient's (``l,o->r``, which sums over the tokens) takes its scales
    over :func:`token_scales`' group."""

    @staticmethod
    def forward(ctx, spec, lhs, rhs):
        ctx.spec = spec
        ctx.save_for_backward(lhs, rhs)
        out_dtype = torch.promote_types(lhs.dtype, rhs.dtype)
        return _quantized_dot(spec, lhs, rhs, stochastic=False).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs = ctx.saved_tensors
        dlhs_spec, drhs_spec = _transpose_specs(ctx.spec)
        dlhs = drhs = None
        if ctx.needs_input_grad[1]:
            dlhs = _quantized_dot(dlhs_spec, g, rhs, stochastic=True).to(lhs.dtype)
        if ctx.needs_input_grad[2]:
            drhs = _quantized_dot(drhs_spec, lhs, g, stochastic=True,
                                  group=_TOKEN_GROUP[0]).to(rhs.dtype)
        return None, dlhs, drhs


def int8_einsum(spec: str, lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Quantised stand-in for ``torch.einsum(spec, lhs, rhs)`` (JAX
    ``quant_train.int8_einsum``)."""
    return _Int8Einsum.apply(spec, lhs, rhs)


def make_dot(enabled: bool = True):
    """The dot hook ``dot(spec, lhs, rhs)``, or None (callers then take
    their plain product)."""
    return int8_einsum if enabled else None


def enabled(cfg) -> bool:
    """True when int8 quantised training is on for ``cfg``."""
    return getattr(cfg, "quant_training", "none") != "none"


def training_plan(cfg) -> dict[str, Any]:
    """The quantised-training surface of ``cfg`` as a plan dict (JAX's
    ``training_plan``)."""
    plan: dict[str, Any] = {
        "enabled": enabled(cfg),
        "mode": getattr(cfg, "quant_training", "none"),
        "targets": list(getattr(cfg, "quant_train_targets", ())),
    }
    if plan["enabled"]:
        plan["forward_rounding"] = "nearest"
        plan["backward_rounding"] = "stochastic (unbiased)"
        plan["accumulation"] = "int32 (torch._int_mm)"
        plan["mfu_note"] = (
            "MFU accounting basis unchanged (model FLOPs at the bf16 "
            "peak); the int8 tensor cores run at up to 2x bf16, so reported "
            "MFU may exceed the bf16-roofline fraction"
        )
    return plan


def check_targets(targets, quant_training: str, lora_rank: Optional[int],
                  moe_impl: Optional[str]) -> None:
    """JAX's ``_validate_quant_training`` (``tpu_engine/sharding.py``) for
    the fields the port has, with its messages."""
    bad = set(targets) - set(QUANT_TARGET_GROUPS)
    if bad:
        raise ValueError(
            f"unknown quant_train_targets {sorted(bad)}; valid groups: "
            f"{list(QUANT_TARGET_GROUPS)}"
        )
    if quant_training == "none":
        return
    if not targets:
        raise ValueError(
            "quant_training='int8' with empty quant_train_targets is a "
            "no-op; set targets or quant_training='none'"
        )
    if lora_rank is not None:
        raise ValueError(
            "quant_training='int8' with LoRA is unsupported: the "
            "rank-sized adapter matmuls bypass the quantized hook and "
            "stochastic-rounding noise on the frozen base would leak "
            "into merge-time semantics — fine-tune in bf16"
        )
    if moe_impl == "ragged" and "moe" in targets:
        raise ValueError(
            "quant_training='int8' with moe_impl='ragged' is "
            "unsupported (lax.ragged_dot takes no per-channel scales); "
            "use moe_impl='dense' or drop 'moe' from quant_train_targets"
        )
