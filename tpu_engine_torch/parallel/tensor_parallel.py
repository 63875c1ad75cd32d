"""Tensor and expert parallelism over the mesh's ``model`` axis (what JAX's
GSPMD program does with ``_TP_AXES``, ``tpu_engine/sharding.py``, written
as explicit collectives on a rank's blocks of the weights).

A rank holds the blocks :func:`~tpu_engine_torch.sharding.model_split`
gives it: whole heads of q, k, v and o, columns of the MLP, whole experts
and a block of the vocabulary. The activations between blocks are whole
on every rank of ``model``. Megatron's pair joins the two:

- :func:`copy_to` (``f``) before a column-parallel product: identity
  forward, all-reduce of the cotangent backward (each rank's product sees
  only its columns, so its input's gradient is a part);
- :func:`reduce_from` (``g``) after a row-parallel product: all-reduce
  forward, identity backward (every rank computes the same loss, so the
  cotangent is already whole).

``collectives._AllReduceSum`` (JAX's ``psum``, whose transpose is a
``psum``) is right for a sum over token ranks and wrong here: it would
multiply every gradient by ``model``.

The vocabulary-parallel embedding (:func:`vocab_embed`) looks up the ids
of the rank's block and sums over ``model``; the vocabulary-parallel loss
(:func:`vocab_ce_sums`) reduces the row max, Σexp and the target's logit
over ``model``, so ``logz`` (and the z-loss) is the global one. Decode
gathers the sampled rows' logits whole (:func:`gather_vocab`), so every
rank draws the same token from the same bytes. Every collective counts its
bytes in ``collectives.moved``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_engine_torch import sharding
from tpu_engine_torch.parallel.collectives import all_reduce_, gather_dim


@dataclass(frozen=True)
class ModelAxis:
    """This rank's place on ``model`` for one model config: the group, its
    size and this rank's index, whether K/V and the vocabulary split, and
    the kv heads the rank's query heads read (``kv_first``, ``kv_count``)."""

    group: object
    size: int
    index: int
    kv_split: bool
    vocab_split: bool
    kv_first: int
    kv_count: int


def model_axis(mesh, cfg) -> Optional[ModelAxis]:
    """The :class:`ModelAxis` of ``mesh`` (a
    :class:`~tpu_engine_torch.mesh_runtime.MeshRuntime`) for ``cfg``, or None
    without a mesh or with one ``model`` rank."""
    if mesh is None or mesh.axis_sizes["model"] == 1:
        return None
    n, i = mesh.axis_sizes["model"], mesh.coords["model"]
    sharding.check_model_axis(cfg, n)
    first, count = sharding.local_kv_heads(cfg, n, i)
    return ModelAxis(mesh.group("model"), n, i, sharding.kv_heads(cfg) % n == 0,
                     cfg.vocab_size % n == 0, first, count)


def model_block(params: dict, cfg, n_model: int, index: int) -> dict:
    """Rank ``index``'s blocks of ``params`` (views: a leaf on the host is
    not copied), by :func:`~tpu_engine_torch.sharding.model_split`: the
    model's leaves, LoRA's adapters (``layers.<t>.A``/``.B``) and int8
    :class:`~tpu_engine_torch.quant.QuantWeight` sites (codes and scale,
    ``QuantWeight.narrow``). A leaf that already has its block's size along
    the split dim (one :func:`~tpu_engine_torch.quant.load_quantized` read
    with ``mesh=``) is the rank's block and is kept."""
    logical = sharding.logical_axes(cfg)
    targets = [k[len("layers."):-len(".A")] for k in params if k.endswith(".A")]
    logical.update(sharding.lora_logical_axes(logical, targets))
    dims = sharding.model_split(cfg, logical, n_model)
    whole = sharding.whole_shapes(cfg, targets)
    out = {}
    for k, p in params.items():
        d = dims.get(k)
        if d is None:
            out[k] = p
            continue
        n = whole[k][d] // n_model
        if p.shape[d] == n:
            out[k] = p
        elif p.shape[d] == whole[k][d]:
            out[k] = p.narrow(d, index * n, n)
        else:
            raise ValueError(f"{k}: dim {d} of size {p.shape[d]} is neither whole "
                             f"({whole[k][d]}) nor a model block ({n})")
    return out


class _CopyToModel(torch.autograd.Function):
    """``f``: identity forward, the cotangent summed over ``model`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """``g``: the partial sums summed over ``model`` forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the cotangent times ``s`` backward."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def copy_to(x: torch.Tensor, tp: Optional[ModelAxis]) -> torch.Tensor:
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from(x: torch.Tensor, tp: Optional[ModelAxis]) -> torch.Tensor:
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def replicated_share(x: torch.Tensor, tp: Optional[ModelAxis]) -> torch.Tensor:
    """``x``, computed alike on every ``model`` rank, with its gradient
    divided by ``model``: where it meets parts summed over ``model`` (the
    MoE aux loss beside the router's combine), its whole gradient is then
    counted once."""
    return x if tp is None else _ScaleGrad.apply(x, 1.0 / tp.size)


def gather_vocab(logits: torch.Tensor, tp: Optional[ModelAxis]) -> torch.Tensor:
    """Logits [..., V/model] whole [..., V] on every rank (an all-gather,
    ranks in vocabulary order); no-op where the vocabulary is whole."""
    if tp is None or not tp.vocab_split:
        return logits
    return gather_dim(logits, logits.dim() - 1, tp.group)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, compute_dtype,
                tp: ModelAxis) -> torch.Tensor:
    """The rows of ``tokens`` from a vocabulary-parallel ``table`` [V/model,
    D]: each rank looks up the ids of its block, zeroes the rest, casts to
    the compute dtype and sums over ``model`` (exact: one rank holds each
    row)."""
    n = table.shape[0]
    local = tokens - tp.index * n
    inside = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table)
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
    return reduce_from(rows.to(compute_dtype), tp)


def vocab_ce_sums(logits: torch.Tensor, targets: torch.Tensor, tp: ModelAxis):
    """Raw CE sums (Σ log-likelihood, Σ logZ², valid count) of this rank's
    vocabulary block of the logits [..., V/model] fp32 against ``targets``
    [...]: the row max (no gradient), Σexp and the target's logit summed
    over ``model``; targets < 0 are excluded."""
    valid = (targets >= 0).float()
    logits = logits.float()
    n = logits.shape[-1]
    with torch.no_grad():
        m = all_reduce_(logits.amax(dim=-1), tp.group, op=dist.ReduceOp.MAX)
    total = reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1), tp)
    logz = m + torch.log(total)
    local = targets - tp.index * n
    inside = (local >= 0) & (local < n)
    hit = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None].long()).squeeze(-1)
    target = reduce_from(torch.where(inside, hit, torch.zeros_like(hit)), tp)
    ll = target - logz
    return torch.sum(ll * valid), torch.sum(logz * logz * valid), torch.sum(valid)
