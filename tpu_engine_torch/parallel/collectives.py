"""The collectives of the mesh program, on plain local tensors over the
process groups of :class:`~tpu_engine_torch.mesh_runtime.MeshRuntime`.

A group of None is a group of one rank: every function here then returns
its input (the collective would be a copy). Gathers and reduce-scatters
work along any dim: the tensor is laid out with that dim first for the
collective, which joins or splits dim 0 only.

:data:`moved` counts the bytes each kind of collective moved out of this
rank since :func:`reset_moved`, as the ring algorithms move them: an
all-gather or a reduce-scatter (n − 1)/n of the whole tensor, an all-reduce
twice that, an all-to-all (n − 1)/n of its input, a send its tensor (ring
attention's hops and the Ulysses swaps count here too).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


# The single-tensor collectives under their current names (older torch has
# only the ``*_tensor`` ones).
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all", "send")
moved: dict[str, int] = {k: 0 for k in KINDS}


def reset_moved() -> None:
    for k in KINDS:
        moved[k] = 0


def count(kind: str, t: torch.Tensor, share: float = 1.0) -> None:
    """Add ``share`` of ``t``'s bytes to ``moved[kind]``."""
    moved[kind] += int(t.numel() * t.element_size() * share)


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The shards of every rank of ``group`` joined along ``dim``, in the
    ranks' order."""
    if group is None:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((_size(group) * src.shape[0], *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _all_gather(out, src, group=group)
    count("all_gather", out, (_size(group) - 1) / _size(group))
    return out.movedim(0, dim)


def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group`` of ``t``, split along ``dim``: this rank's
    share, in the ranks' order."""
    if group is None:
        return t
    n = _size(group)
    src = t.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"dim {dim} of size {src.shape[0]} does not split over {n} ranks")
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=t.dtype, device=t.device)
    _reduce_scatter(out, src, op=dist.ReduceOp.SUM, group=group)
    count("reduce_scatter", src, (n - 1) / n)
    return out.movedim(0, dim)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum ``t`` (or reduce it by ``op``) over ``group`` in place; returns
    ``t``."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
        count("all_reduce", t, 2 * (_size(group) - 1) / _size(group))
    return t


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group that every rank then uses alike: its adjoint
    sums the ranks' cotangents (JAX's ``psum`` transposes to ``psum``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Differentiable sum over ``group``."""
    return x if group is None else _AllReduceSum.apply(x, group)
