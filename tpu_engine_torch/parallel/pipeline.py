"""Pipeline parallelism over the mesh's ``pipe`` axis, one rank a stage
(port of ``tpu_engine/parallel/pipeline.py``), and the GPipe schedule.

JAX runs every stage in one SPMD program: a ``vmap`` over the stacked
stages inside one ``lax.scan`` of ticks, bubble lanes computed and masked
to zero, the buffer rolled one stage a tick. Here each stage is a rank of
its own and runs only its own work: a bubble is idle time on that rank,
not masked compute.

- **Layers.** The ``layers`` → ``pipe`` rule (``sharding._PIPE_AXES``)
  gives stage p the contiguous block of ``L / P`` layers from p · L/P of
  every stacked leaf (:func:`stage_layer_stack`, JAX's reshape to [P, L/P,
  ...] read at the rank's index). Inside a stage the other axes apply as
  without ``pipe``: ZeRO stages 0–3 over ``data`` and ``fsdp`` on the
  stage's own leaves (stage 3 re-gathers a layer on every microbatch
  visit, its bytes counted in ``collectives.moved["all_gather"]``),
  tensor and expert parallelism over ``model``, ring or Ulysses attention
  over ``sequence``.
- **Outer leaves** (Megatron's placement; JAX replicates them over
  ``pipe``): the embedding and gpt2's positions live on the first stage,
  the final norm and the head on the last, a tied table (gpt2, gemma) on
  both. The two partial gradients of a tied table are summed over the pair
  of end stages once a step (:meth:`Stage.reduce_tied`: one all-reduce of
  the table); the gradient norm counts it on the first stage only. Both
  placements give JAX's numbers; this one saves the all-reduce of every
  outer gradient over ``pipe`` (2 × 262 MB in fp32 for llama-1b a step).
- **Ticks.** A schedule is a table of ticks (:func:`run_table`): each tick
  a stage runs its ops (``F`` forward, ``BW`` combined backward, ``B``
  input-cotangent half, ``W`` weight-gradient half, each of one
  microbatch), then trades the boundary activations it made with the next
  stage and the input cotangents with the previous one. Every trade is
  posted as one ``batch_isend_irecv`` of all its sends and receives
  (:func:`exchange`): where a rank both sends and receives (1F1B's steady
  state) two blocking sends facing each other would hang under NCCL. Sends
  count under ``collectives.moved["send"]``.
- **GPipe** (:func:`pipeline_gpipe_grads`): every microbatch forward with
  its graph kept (checkpointed blocks as the program's remat policy keeps
  them), then autograd runs the reverse order, the cotangents returning by
  the same trades. The first stage embeds; the last takes the loss.
- **The loss** (``StageWork.loss``, the same objective as one device): a
  microbatch's cross-entropy (and z-loss) over the step's valid-target
  count, on the last stage; each stage adds its layers' MoE aux losses
  at JAX's weight ``router_aux_coef / (n_layers · accum)`` (over the token
  ranks, as without ``pipe``). The program sums both over the stages, so
  every rank reports the same loss and gradient norm; ``data``/``fsdp``
  gradients reduce once a step, after the last microbatch.
- **Faults.** A stage that fails leaves its peers waiting in a trade or a
  collective; the program has no recovery across stages (as JAX's one
  program has none).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from tpu_engine_torch import sharding
from tpu_engine_torch.parallel.collectives import all_reduce_, count, gather_dim


def stage_layer_stack(params: dict, n_stages: int, index: int, n_layers: int) -> dict:
    """Stage ``index``'s block of the stacked ``layers.*`` leaves (views):
    JAX's [P, L/P, ...] reshape read at one stage."""
    first, per = sharding.stage_layers(n_layers, n_stages, index)
    return {k: v.narrow(0, first, per) if k.startswith("layers.") else v
            for k, v in params.items()}


class Stage:
    """This rank's place on ``pipe``: its index and the stage count, its
    neighbours' global ranks, the ``pipe`` group and the group of the two
    end stages (a tied table's holders)."""

    def __init__(self, runtime, model_cfg):
        self.n = runtime.axis_sizes["pipe"]
        self.index = runtime.coords["pipe"]
        self.prev, self.next = runtime.stage_peers()
        self.group = runtime.group("pipe")
        self.ends = runtime.ends_group()
        self.model_cfg = model_cfg
        self.first, self.layers = sharding.stage_layers(model_cfg.n_layers, self.n, self.index)
        self.is_first, self.is_last = self.index == 0, self.index == self.n - 1
        # The first trade of a NCCL group must involve all of its ranks.
        all_reduce_(torch.zeros(1, device=runtime.device), self.group)

    def keys(self, keys) -> list[str]:
        return sharding.stage_keys(self.model_cfg, keys, self.n, self.index)

    def block(self, params: dict) -> dict:
        """This stage's leaves of the whole tree ``params``: its block of
        every stacked leaf and the outer leaves it holds."""
        own = set(self.keys(params))
        return stage_layer_stack({k: v for k, v in params.items() if k in own}, self.n,
                                 self.index, self.model_cfg.n_layers)

    def shapes(self, shapes: dict) -> dict:
        """The shapes of this stage's leaves from the whole shapes."""
        own = set(self.keys(shapes))
        return {k: (self.layers, *s[1:]) if k.startswith("layers.") else s
                for k, s in shapes.items() if k in own}

    def tied(self, keys) -> list[str]:
        """The leaves of ``keys`` held by both end stages (a tied table)."""
        return [k for k in keys if not k.startswith("layers.")
                and len(sharding.outer_stages(self.model_cfg, k, self.n)) > 1]

    def norm_skip(self, keys) -> frozenset:
        """The leaves this stage leaves out of the gradient norm: a tied
        table on the last stage (the first counts it)."""
        return frozenset(self.tied(keys)) if self.is_last else frozenset()

    def reduce_tied(self, grads: dict) -> dict:
        """A tied table's two partial gradients (the embedding's on the
        first stage, the head's on the last) summed over the end stages."""
        for k in self.tied(grads):
            grads[k] = all_reduce_(grads[k], self.ends)
        return grads

    @torch.no_grad()
    def whole(self, tree: dict, whole_shapes: dict) -> dict:
        """Every leaf whole on every stage from each stage's leaves (each
        already whole over ``model`` and ``fsdp``): the layer blocks
        gathered in stage order, an outer leaf sent from its first holder.
        Every rank walks the whole tree's keys in one order."""
        out = {}
        like = next(iter(tree.values()))
        for k, shape in whole_shapes.items():
            if k.startswith("layers."):
                out[k] = gather_dim(tree[k].detach().contiguous(), 0, self.group)
                continue
            owner = sharding.outer_stages(self.model_cfg, k, self.n)[0]
            buf = (tree[k].detach().clone(memory_format=torch.contiguous_format)
                   if self.index == owner else
                   torch.zeros(shape, dtype=like.dtype, device=like.device))
            out[k] = all_reduce_(buf, self.group)
        return out


def exchange(sends: list, recvs: list, group) -> list[torch.Tensor]:
    """Post every send (``(tensor, peer)``) and receive (``(like, peer)``:
    a tensor of the incoming shape and dtype) of one trade together, as one
    ``batch_isend_irecv``, and wait for all of them; returns the received
    tensors in ``recvs``' order. Peers are global ranks."""
    if not sends and not recvs:
        return []
    ops, out = [], []
    for t, peer in sends:
        t = t.contiguous()
        ops.append(dist.P2POp(dist.isend, t, peer, group))
        count("send", t)
    for like, peer in recvs:
        buf = torch.empty_like(like, memory_format=torch.contiguous_format)
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
        out.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


@dataclass
class StageWork:
    """What a schedule runs on one stage for one step, given by the train
    program: ``embed(m)`` (the first stage's input of microbatch m),
    ``layers(x)`` → (the stage's output, its weighted MoE aux loss or
    None), ``loss(y, m)`` (the last stage's loss term of microbatch m),
    ``like`` (a tensor of a boundary activation's shape and dtype) and the
    microbatch count ``M``."""

    embed: Callable
    layers: Callable
    loss: Callable
    like: torch.Tensor
    M: int


def _backward(outs: list, grads: list, inputs: Optional[list] = None):
    """Pull the cotangents ``grads`` back through ``outs`` (None entries
    dropped): into the parameters' gradients, or with ``inputs`` only to
    those (returned)."""
    pairs = [(o, g) for o, g in zip(outs, grads) if o is not None and o.requires_grad]
    if inputs is not None:
        return torch.autograd.grad([o for o, _ in pairs], inputs, [g for _, g in pairs])
    torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
    return None


def _one(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else torch.ones_like(t)


def run_table(table: list, stage: Stage, work: StageWork, keep_graph: bool,
              forward_only: bool = False):
    """Run this stage's column of ``table`` (``table[t][p]``: the ops of
    stage p at tick t, each ``(op, microbatch)``), trading with the
    neighbours after every tick. ``keep_graph``: the forward keeps its
    graph for the backward (GPipe); otherwise it runs without one and keeps
    only the stage's input in a ring of K = 2(P-1)+1 slots, and each
    backward recomputes the stage from it (1F1B, zero-bubble).
    ``forward_only``: forwards alone, no graph (the held-out loss). Returns
    (the summed loss terms, 0 off the last stage; the summed aux terms)."""
    P, p = stage.n, stage.index
    K = 2 * (P - 1) + 1
    dev = work.like.device
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
    ring: list = [None] * K                 # stage inputs by microbatch % K
    kept: dict[int, tuple] = {}             # GPipe: (input, outputs) with their graph
    stash: dict[int, torch.Tensor] = {}     # deferred W: output cotangents
    x_in: Optional[torch.Tensor] = None     # next F's input (received)
    dy_in: Optional[torch.Tensor] = None    # next backward's cotangent (received)

    def stage_out(x, m, grad: bool):
        """(y or the loss term on the last stage, the aux term)."""
        with torch.set_grad_enabled(grad):
            y, aux = work.layers(x)
            if stage.is_last:
                y = work.loss(y, m)
        return y, aux

    def input_of(m, x):
        if not stage.is_first:
            return x
        with torch.set_grad_enabled(keep_graph and not forward_only):
            return work.embed(m)

    def add_aux(aux):
        nonlocal aux_sum
        if aux is not None:
            aux_sum = aux_sum + aux.detach().float()

    def cotangents(y, aux, dy):
        return [y, aux], [torch.ones_like(y) if stage.is_last else dy, _one(aux)]

    for t, row in enumerate(table):
        send_y = send_dx = None
        for op, m in row[p]:
            if op == "F":
                x = input_of(m, x_in)
                if keep_graph:
                    x_g = x if stage.is_first or forward_only else x.detach().requires_grad_(True)
                    y, aux = stage_out(x_g, m, not forward_only)
                    if not forward_only:
                        kept[m] = (x_g, y, aux)
                    add_aux(aux)
                    if stage.is_last:
                        loss_sum = loss_sum + y.detach()
                    else:
                        send_y = y.detach()
                    continue
                ring[m % K] = x.detach()
                if not stage.is_last:  # the last stage computes at its backward
                    y, aux = stage_out(ring[m % K], m, False)
                    add_aux(aux)
                    send_y = y
            elif op == "BW":
                if keep_graph:
                    x_g, y, aux = kept.pop(m)
                    outs, grads = cotangents(y, aux, dy_in)
                    _backward(outs, grads)
                    send_dx = None if stage.is_first else x_g.grad
                    continue
                x_g = ring[m % K].requires_grad_(True)
                y, aux = stage_out(x_g, m, True)
                if stage.is_last:
                    loss_sum = loss_sum + y.detach()
                    add_aux(aux)
                outs, grads = cotangents(y, aux, dy_in)
                _backward(outs, grads)
                ring[m % K] = None
                dx = x_g.grad
                if stage.is_first:
                    _backward([work.embed(m)], [dx])
                else:
                    send_dx = dx
            elif op == "B":  # input cotangent alone; the W half is deferred
                x_g = ring[m % K].detach().requires_grad_(True)
                y, aux = stage_out(x_g, m, True)
                outs, grads = cotangents(y, aux, dy_in)
                (dx,) = _backward(outs, grads, [x_g])
                stash[m] = dy_in
                if stage.is_first:
                    _backward([work.embed(m)], [dx])
                else:
                    send_dx = dx
            elif op == "W":  # the deferred weight gradient, from the stash
                x = ring[m % K]
                y, aux = stage_out(x, m, True)
                outs, grads = cotangents(y, aux, stash.pop(m))
                _backward(outs, grads)
                ring[m % K] = None
            else:
                raise ValueError(f"unknown pipeline op {op!r}")
        # The trade after tick t: what this stage made, and what its next
        # tick needs (the neighbours' ops at t + 1 match these).
        nxt = table[t + 1][p] if t + 1 < len(table) else ()
        ops = {op for op, _ in nxt}
        sends, recvs = [], []
        if send_y is not None:
            sends.append((send_y, stage.next))
        if send_dx is not None:
            sends.append((send_dx, stage.prev))
        want_x = "F" in ops and not stage.is_first
        want_dy = bool(ops & {"BW", "B"}) and not stage.is_last
        if want_x:
            recvs.append((work.like, stage.prev))
        if want_dy:
            recvs.append((work.like, stage.next))
        got = exchange(sends, recvs, stage.group)
        x_in = got.pop(0) if want_x else None
        dy_in = got.pop(0) if want_dy else None
    if kept or stash:
        raise RuntimeError(f"pipeline stage {p}: work left at the end of the step "
                           f"(kept {sorted(kept)}, stash {sorted(stash)})")
    return loss_sum, aux_sum


def gpipe_table(n_stages: int, microbatches: int) -> list:
    """GPipe's ticks: M + P - 1 forward ticks (stage p runs microbatch
    t - p), then as many backward ticks in the reverse order (the last
    stage first: stage p runs microbatch t' - (P-1-p))."""
    P, M = n_stages, microbatches
    fwd = [[[("F", t - p)] if 0 <= t - p < M else [] for p in range(P)]
           for t in range(M + P - 1)]
    bwd = [[[("BW", t - (P - 1 - p))] if 0 <= t - (P - 1 - p) < M else [] for p in range(P)]
           for t in range(M + P - 1)]
    return fwd + bwd


def pipeline_gpipe_grads(stage: Stage, work: StageWork):
    """GPipe (JAX's ``pipeline_apply`` differentiated by autodiff): every
    microbatch forward, its graph kept, then the backward in reverse order.
    Returns (summed loss terms, summed aux terms) of this stage; the
    parameters' gradients accumulate through autograd."""
    return run_table(gpipe_table(stage.n, work.M), stage, work, keep_graph=True)


def eval_losses(stage: Stage, work: StageWork) -> torch.Tensor:
    """The summed loss terms of every microbatch forward through the
    stages, no graph (the held-out loss); 0 off the last stage."""
    with torch.no_grad():
        return run_table(gpipe_table(stage.n, work.M)[:work.M + stage.n - 1], stage, work,
                         keep_graph=True, forward_only=True)[0]
