"""Ring attention: sequence (context) parallelism, port of
``tpu_engine/parallel/ring_attention.py``.

Each rank of a ring of ``ring`` ranks holds one shard of the sequence. Q
stays put; the K/V shards rotate around the ring while every rank merges its
queries' attention over each visiting K/V block with an online log-sum-exp
update. After ``ring`` hops every Q block has attended to every K/V block.

The per-rank bodies (:func:`_ring_flash_local`, :func:`_ring_attention_local`)
are the JAX bodies with the rotation made a parameter: ``rotate(hop, k, v)``
returns the K/V block a rank holds at hop ``hop + 1`` given the one it holds
at hop ``hop``, the counterpart of ``lax.ppermute`` to the next rank. Rank r
at hop i holds block (r − i) mod ring. :func:`ring_mha` runs every rank in
one process on one device with :func:`in_process_rotation`;
:func:`ring_mha_group` runs this rank's body in a process group of ranks
(the mesh's ``sequence`` axis) with :func:`distributed_rotation`, whose
hops are NCCL (or ``gloo``) sends and receives; the bodies are the same.

Layout convention matches ``tpu_engine_torch.ops``: q [B, S, H, D], k/v
[B, S, KV, D] (GQA allowed: KV heads < Q heads).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from tpu_engine_torch.ops import _flash_cuda
from tpu_engine_torch.ops._flash_cuda import flash_fwd_lse
from tpu_engine_torch.parallel import collectives

_NEG_INF = -1e30

# rotate(hop, k_blk, v_blk) -> (k_next, v_next): what a rank holds at hop
# ``hop + 1``, given what it holds at hop ``hop``.
Rotation = Callable[[int, torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def in_process_rotation(k_shards: Sequence[torch.Tensor], v_shards: Sequence[torch.Tensor],
                        rank: int) -> Rotation:
    """The rotation of ``rank`` when every rank's K/V shard lives in this
    process: at hop i + 1 it holds shard (rank − i − 1) mod ring, which is
    what ``ppermute`` to the next rank delivers."""
    ring = len(k_shards)

    def rotate(hop: int, k_blk: torch.Tensor, v_blk: torch.Tensor):
        src = (rank - hop - 1) % ring
        return k_shards[src], v_shards[src]

    return rotate


def _send_recv(a: torch.Tensor, b: torch.Tensor, to: int, frm: int, group):
    """Send a and b to global rank ``to`` and receive their likes from
    ``frm``, all four posted at once."""
    a, b = a.contiguous(), b.contiguous()
    ra, rb = torch.empty_like(a), torch.empty_like(b)
    ops = [dist.P2POp(dist.isend, a, to, group), dist.P2POp(dist.irecv, ra, frm, group),
           dist.P2POp(dist.isend, b, to, group), dist.P2POp(dist.irecv, rb, frm, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    collectives.count("send", a, group=group)
    collectives.count("send", b, group=group)
    return ra, rb


class _Hop(torch.autograd.Function):
    """One hop of the ring: the K/V block goes to the next rank and the
    previous rank's arrives; the backward sends the arrived block's
    cotangents back to the previous rank and takes this rank's from the
    next."""

    @staticmethod
    def forward(ctx, k, v, group, nxt: int, prv: int):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _send_recv(k, v, nxt, prv, group)

    @staticmethod
    def backward(ctx, dk, dv):
        dk, dv = _send_recv(dk, dv, ctx.prv, ctx.nxt, ctx.group)
        return dk, dv, None, None, None


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with every block the ring delivered as an input
    of zero cotangent: each rank's backward then runs every hop's backward,
    where a block skipped under causality would otherwise leave its hop out
    of the graph and its neighbour waiting on a send that never comes."""

    @staticmethod
    def forward(ctx, out, *blocks):
        ctx.likes = [(b.shape, b.dtype, b.device) for b in blocks]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.likes))


class _DistributedRotation:
    def __init__(self, group):
        self.group = group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        self.nxt = dist.get_global_rank(group, (r + 1) % n)
        self.prv = dist.get_global_rank(group, (r - 1) % n)
        self.delivered: list[torch.Tensor] = []

    def __call__(self, hop: int, k_blk: torch.Tensor, v_blk: torch.Tensor):
        k_nxt, v_nxt = _Hop.apply(k_blk, v_blk, self.group, self.nxt, self.prv)
        self.delivered += [k_nxt, v_nxt]
        return k_nxt, v_nxt

    def tie(self, out: torch.Tensor) -> torch.Tensor:
        blocks = [b for b in self.delivered if b.requires_grad]
        return _Tie.apply(out, *blocks) if blocks and out.requires_grad else out


def distributed_rotation(group) -> Rotation:
    """The :data:`Rotation` of this rank in ``group`` (the ranks of the
    ring, in ring order): each hop sends the rank's K/V block to the next
    rank and receives the previous rank's with ``batch_isend_irecv``, an
    autograd function whose backward sends the K/V cotangents the other
    way. Every rank makes every hop, whether or not it then skips the
    block. The rotation keeps what it delivered; pass the ring's output
    through its ``tie`` (as :func:`ring_mha_group` does)."""
    return _DistributedRotation(group)


def _ring_flash_local(q, k, v, rank: int, ring: int, rotate: Rotation,
                      causal: bool) -> torch.Tensor:
    """Flash-kernel ring body: each hop's K/V block goes through the flash
    kernels (:func:`flash_fwd_lse`), and hops merge through their
    log-sum-exps; no [Sq, Sk] score tensor is made, per hop or in total.

    Hop cases under causality (kv_idx = global block index held this hop):
    strictly-future blocks are skipped (nothing is launched), the diagonal
    block runs the causal kernels and strictly-past blocks the unmasked
    ones. The merge differentiates end to end: the lse cotangent enters the
    kernels' backward through Δ′ (:class:`FlashAttentionLSE`)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    BH = B * H

    def to_bhsd(x):
        return x.transpose(1, 2).reshape(B * H, Sq, D).contiguous()

    def expand_kv(x):
        # GQA: the ring rotates COMPACT [B, Sk, KV, D] blocks (KV/H of the
        # bytes a rotation across cards moves); heads expand per hop.
        if KV != H:
            x = torch.repeat_interleave(x, H // KV, dim=2)
        return to_bhsd(x)

    qb = to_bhsd(q)
    # A finite floor for the running max, as in JAX: exp(m - m_new) is then
    # never exp(-inf - -inf), whose gradient is NaN.
    m = torch.full((BH, Sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((BH, Sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((BH, Sq, D), dtype=torch.float32, device=q.device)

    k_blk, v_blk = k, v
    for i in range(ring):
        if i:
            k_blk, v_blk = rotate(i - 1, k_blk, v_blk)
        kv_idx = (rank - i) % ring
        if causal and kv_idx > rank:
            continue  # a future block: fully masked, skipped outright
        o_i, lse_i = flash_fwd_lse(qb, expand_kv(k_blk), expand_kv(v_blk),
                                   causal=causal and kv_idx == rank)
        # LSE merge: out = Σ_i exp(lse_i)·o_i / Σ_i exp(lse_i), online with a
        # running max.
        m_new = torch.maximum(m, lse_i)
        c_old = torch.exp(m - m_new)
        c_new = torch.exp(lse_i - m_new)
        l = l * c_old + c_new
        o = o * c_old[..., None] + o_i.float() * c_new[..., None]
        m = m_new

    out = o / torch.clamp(l, min=1e-30)[..., None]  # [BH, Sq, D]
    return out.reshape(B, H, Sq, D).transpose(1, 2).to(q.dtype)


def _uses_kernels(Sq: int, Sk: int) -> bool:
    """The routing rule of ``_ring_attention_local``: the flash body for a
    shard that tiles (Sq a multiple of 64, at least 64, and Sk == Sq), the
    dense body otherwise."""
    block = _flash_cuda.BLOCK
    return Sq % block == 0 and Sq >= block and Sk == Sq


def _ring_attention_local(q, k, v, rank: int, ring: int, rotate: Rotation,
                          causal: bool = True) -> torch.Tensor:
    """Per-rank ring attention body.

    q: [B, Sq, H, D] the rank's query shard; k/v: [B, Sk, KV, D] its K/V
    shard. Returns [B, Sq, H, D]. A shard that tiles goes through the flash
    kernels (:func:`_ring_flash_local`); any other takes the dense einsum
    body below, which is JAX's own path for such shards."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if _uses_kernels(Sq, Sk):
        return _ring_flash_local(q, k, v, rank, ring, rotate, causal)

    def expand(x):
        # JAX expands before rotating; the in-process rotation holds the
        # compact shards, so this body expands per hop (the same values).
        return torch.repeat_interleave(x, H // KV, dim=2) if KV != H else x

    scale = 1.0 / (D ** 0.5)
    q32 = q.float()
    q_pos = rank * Sq + torch.arange(Sq, device=q.device)  # global query positions

    # Online-softmax accumulators (fp32).
    m = torch.full((B, H, Sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)

    k_blk, v_blk = k, v
    for i in range(ring):
        if i:
            k_blk, v_blk = rotate(i - 1, k_blk, v_blk)
        kv_idx = (rank - i) % ring  # which global block this rank holds
        s = torch.einsum("bqhd,bkhd->bhqk", q32, expand(k_blk).float()) * scale
        if causal:
            k_pos = kv_idx * Sk + torch.arange(Sk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]  # [Sq, Sk]
            s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        # Rows that have seen no valid key yet: m_new == _NEG_INF, so masked
        # entries give p = e^0 = 1; zero them explicitly.
        p = torch.where(s <= _NEG_INF / 2, torch.zeros_like(p), p)
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, expand(v_blk).float())
        m = m_new

    out = o / torch.clamp(l, min=1e-30)[..., None]  # [B, H, Sq, D]
    return out.transpose(1, 2).to(q.dtype)


def ring_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sequence: int,
             causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention over a ring of ``sequence`` ranks, on
    global [B, S, H, D] q and [B, S, KV, D] k/v.

    This is the one-process layout: S is split into ``sequence`` shards on
    q's device, each rank's body runs in turn with
    :func:`in_process_rotation`, and the results are concatenated. Autograd
    flows through the shards back into q, k and v. :func:`ring_mha_group`
    is the same ring with a rank a process (:func:`distributed_rotation`)."""
    S = q.shape[1]
    if sequence < 1 or S % sequence:
        raise ValueError(f"seq_len={S} must split into sequence={sequence} equal shards")
    qs = torch.chunk(q, sequence, dim=1)
    ks = torch.chunk(k, sequence, dim=1)
    vs = torch.chunk(v, sequence, dim=1)
    outs = [
        _ring_attention_local(qs[r], ks[r], vs[r], r, sequence,
                              in_process_rotation(ks, vs, r), causal)
        for r in range(sequence)
    ]
    return torch.cat(outs, dim=1)


def ring_mha_group(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   causal: bool = True) -> torch.Tensor:
    """Ring attention with this rank's shard: q [B, S/ring, H, D] and k/v
    [B, S/ring, KV, D] of the rank's place in ``group`` (the ring, in
    order); returns its output shard. The body is :func:`ring_mha`'s, its
    hops :func:`distributed_rotation`'s."""
    rotate = distributed_rotation(group)
    out = _ring_attention_local(q, k, v, dist.get_rank(group), dist.get_world_size(group),
                                rotate, causal)
    return rotate.tie(out)
