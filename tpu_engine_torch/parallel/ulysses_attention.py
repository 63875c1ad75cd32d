"""Ulysses attention: all-to-all sequence parallelism over the ``sequence``
axis (port of ``tpu_engine/parallel/ulysses_attention.py``).

Where ring attention keeps the sequence sharded and rotates K/V blocks,
Ulysses swaps the sharded dimension for the duration of attention:

    [B, S/P, H, D]  --all_to_all-->  [B, S, H/P, D]
        (sequence-sharded)              (head-sharded)

Each rank then runs full-sequence causal attention over its head group
(the flash kernels, :func:`tpu_engine_torch.ops.flash_attention.mha`) and a
second all-to-all swaps back. The swap is linear: its backward is the
opposite swap.

Layout convention: q [B, S/P, H, D], k/v [B, S/P, KV, D] (GQA allowed), a
rank's shard of the sequence in its place in the group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_engine_torch.ops import flash_attention
from tpu_engine_torch.parallel import collectives


def _swap(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` split into P chunks along
    ``split_dim``, chunk j to rank j; the chunks received joined along
    ``concat_dim`` in the ranks' order."""
    n = dist.get_world_size(group)
    src = torch.stack(x.chunk(n, dim=split_dim), 0).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    collectives.count("all_to_all", src, (n - 1) / n)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim: int, concat_dim: int):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return _swap(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _swap(g, ctx.group, ctx.concat_dim, ctx.split_dim), None, None, None


def ulysses_mha_group(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                      causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention by head↔sequence all-to-all over
    ``group`` (the ``sequence`` axis); returns this rank's output shard
    [B, S/P, H, D]. The head count must divide by the group's size; GQA
    with too few KV heads to split expands them first, as JAX does."""
    P = dist.get_world_size(group)
    H, KV = q.shape[2], k.shape[2]
    if H % P != 0:
        raise ValueError(
            f"ulysses attention needs local head count {H} divisible by the "
            f"sequence axis size {P}"
        )
    if KV % P != 0:  # GQA with too few KV heads: expand before the swap
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)
    q, k, v = (_AllToAll.apply(t, group, 2, 1) for t in (q, k, v))
    out = flash_attention.mha(q, k, v, causal=causal)
    return _AllToAll.apply(out, group, 1, 2)
