"""The training step's placements on a mesh: ZeRO stages 0–3 over ``data``
and ``fsdp``, and the sequence shards of ``sequence`` (the port of what
JAX's GSPMD program does with the specs of ``tpu_engine/sharding.py``).

The port keeps plain local tensors and calls the collectives itself
(``collectives.py``) on the groups of
:class:`~tpu_engine_torch.mesh_runtime.MeshRuntime`:

- a rank takes ``micro_batch_size`` rows of each microbatch, the block of
  its (``data``, ``fsdp``) index, and ``seq_len / sequence`` positions of
  them, the block of its ``sequence`` index (JAX's ``P(None, BATCH_AXES,
  "sequence")``); the ranks of ``model`` take the same tokens;
- a leaf is first cut to the rank's ``model`` block
  (:func:`~tpu_engine_torch.sharding.model_split`: whole heads, columns,
  experts or vocabulary rows; the leaf itself where ``model`` leaves it
  whole); a shard holds the elements JAX's spec gives the rank of that
  block: a slice along the dim where
  :func:`~tpu_engine_torch.sharding.logical_to_mesh_axes` puts ``fsdp``,
  the ``fsdp`` index's block of it; gathers join along that dim;
- gradients are summed over every rank that holds a part of the step's
  tokens (``data``, ``fsdp``, ``sequence``): all-reduced, or at stage >= 2
  reduce-scattered over ``fsdp`` and all-reduced over the rest; a leaf
  ``model`` leaves whole whose gradient a rank gets in part
  (:func:`~tpu_engine_torch.sharding.model_partial`) is summed over
  ``model`` too;
- at stage >= 1 a rank updates its shards with its shards of the optimizer
  state; at stages 1 and 2 it then all-gathers the parameters;
- at stage 3 (:class:`ShardedParams`) each layer's shards are all-gathered
  inside its checkpointed block, in the forward and again in the
  recompute, and their gradients reduce-scattered in the backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_engine_torch import sharding
from tpu_engine_torch.mesh_runtime import TOKEN_AXES
from tpu_engine_torch.offload import GradSums, _Layer
from tpu_engine_torch.parallel.collectives import (
    all_reduce_,
    gather_dim,
    reduce_scatter_dim,
)
from tpu_engine_torch.parallel.tensor_parallel import model_block

class ZeroLayout:
    """Where each leaf of the trainable tree lives on this rank under a
    ZeRO ``stage``: the dim ``fsdp`` splits (:attr:`dims`, None for a leaf
    JAX replicates) and which of params, gradients and optimizer state are
    split."""

    def __init__(self, runtime, stage: int, logical: dict[str, tuple],
                 shapes: dict[str, tuple], model_cfg=None):
        self.stage = int(stage)
        sizes = runtime.axis_sizes
        self.n_fsdp, self.i_fsdp = sizes["fsdp"], runtime.coords["fsdp"]
        self.n_model, self.i_model = sizes["model"], runtime.coords["model"]
        self.fsdp = runtime.group("fsdp")
        self.model = runtime.group("model")
        self.tokens = runtime.group(TOKEN_AXES)
        self.rest = runtime.group(("data", "sequence"))
        # The same over ``model`` too, for the leaves of partial gradients.
        self.tokens_model = runtime.group((*TOKEN_AXES, "model"))
        self.rest_model = runtime.group(("data", "sequence", "model"))
        self.model_cfg = model_cfg
        self.mdims = sharding.model_split(model_cfg, logical, self.n_model)
        self.partial = sharding.model_partial(model_cfg, logical, self.n_model)
        specs = sharding.opt_state_pspecs(logical, sharding.ShardingStage.OPTIMIZER_STATE)
        self.dims = {k: (sharding.fsdp_dim(specs[k]) if self.n_fsdp > 1 else None)
                     for k in logical}
        for k, d in self.dims.items():  # fsdp and model never split one dim
            if d is not None and shapes[k][d] % self.n_fsdp:
                raise ValueError(f"{k}: dim {d} of size {shapes[k][d]} does not split "
                                 f"over fsdp={self.n_fsdp}")
        # A pipeline stage's (the program sets them): the pipe group, over
        # which the gradient norm's squares sum, and the leaves this stage
        # leaves out of the norm (a tied table counted on the first stage).
        self.pipe = None
        self.norm_skip: frozenset = frozenset()
        self.params_split = self.stage >= sharding.ShardingStage.FULL_PARTITIONING
        self.grads_split = self.stage >= sharding.ShardingStage.GRADIENT_PARTITIONING
        self.state_split = self.stage >= sharding.ShardingStage.OPTIMIZER_STATE

    # -- shards ---------------------------------------------------------------

    def shard(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's ``fsdp`` block of the ``model`` block ``t`` (a view)."""
        d = self.dims[key]
        if d is None:
            return t
        n = t.shape[d] // self.n_fsdp
        return t.narrow(d, self.i_fsdp * n, n)

    def place(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The trainable tree as this rank holds it, from whole leaves: its
        shards of its ``model`` blocks at stage 3 (no gradient: the stream's
        gathers carry it), its ``model`` blocks otherwise (the leaves
        themselves where ``model`` leaves them whole)."""
        blocks = (params if self.model is None else
                  model_block(params, self.model_cfg, self.n_model, self.i_model))
        if not self.params_split:
            return {k: p if blocks[k] is p else
                    blocks[k].detach().clone().requires_grad_(p.requires_grad)
                    for k, p in params.items()}
        return {k: self.shard(k, b).detach().clone() for k, b in blocks.items()}

    def state_like(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The leaves the optimizer state is shaped like: shards at stage >= 1."""
        if not self.state_split or self.params_split:
            return params
        return {k: self.shard(k, p) for k, p in params.items()}

    def whole(self, params: dict[str, torch.Tensor], fsdp: Optional[bool] = None,
              model: bool = True) -> dict[str, torch.Tensor]:
        """Whole leaves from what this rank holds: gathered over ``fsdp``
        where ``fsdp`` (default: at stage 3, where the params are split),
        then over ``model`` unless ``model`` is False (the rank's blocks)."""
        if self.params_split if fsdp is None else fsdp:
            params = {k: gather_dim(p.detach(), d, self.fsdp) if (d := self.dims[k]) is not None
                      else p for k, p in params.items()}
        if self.model is None or not model:
            return params
        return {k: gather_dim(p.detach(), d, self.model) if (d := self.mdims[k]) is not None
                else p for k, p in params.items()}

    # -- gradients and the update ------------------------------------------------

    def reduce_leaf(self, key: str, g: torch.Tensor, dim_offset: int = 0,
                    owned: bool = True) -> torch.Tensor:
        """A leaf's local gradient summed over the step's ranks: this rank's
        shard of the sum where the gradients are split, the whole sum
        otherwise; a leaf of :attr:`partial` gradients is summed over
        ``model`` too. ``dim_offset`` -1 for one layer of a stacked leaf; a
        gradient not ``owned`` is not summed in place."""
        d = self.dims[key]
        part = key in self.partial
        tokens = self.tokens_model if part else self.tokens
        rest = self.rest_model if part else self.rest
        if d is None or not self.grads_split:
            if tokens is not None and not owned:
                g = g.clone()
            return all_reduce_(g, tokens)
        g = reduce_scatter_dim(g, d + dim_offset, self.fsdp)
        if rest is None:
            return g
        if self.fsdp is None and not owned:
            g = g.clone()
        return all_reduce_(g.contiguous(), rest)

    def reduce_grads(self, grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The step's summed local gradients (stages 0–2) reduced over the
        ranks; stage 3's arrive reduced from the stream."""
        if self.params_split:
            return grads
        return {k: self.reduce_leaf(k, g) for k, g in grads.items()}

    def grad_norm(self, grads: dict[str, torch.Tensor], norm) -> torch.Tensor:
        """The global norm of the reduced gradients: each rank's own shards'
        squares summed over ``fsdp`` and its ``model`` blocks' over
        ``model``, each leaf held whole on those ranks counted once.
        ``norm`` is the one-rank norm of a list (``train.global_norm``). On
        a pipeline stage the squares of its leaves (:attr:`norm_skip` left
        out) sum over ``pipe``."""
        if self.pipe is None:
            return self._stage_norm(grads, norm)
        grads = {k: g for k, g in grads.items() if k not in self.norm_skip}
        sq = self._stage_norm(grads, norm).square().reshape(1)
        return all_reduce_(sq, self.pipe)[0].sqrt()

    def _stage_norm(self, grads: dict[str, torch.Tensor], norm) -> torch.Tensor:
        if self.model is not None:
            return self._grad_norm_model(grads, norm)
        split = [g for k, g in grads.items() if self.dims[k] is not None]
        if not self.grads_split or not split:  # every rank holds the whole of each
            return norm(list(grads.values()))
        whole = [g for k, g in grads.items() if self.dims[k] is None]
        sq = norm(split).square()
        all_reduce_(sq, self.fsdp)
        if whole:
            sq = sq + norm(whole).square()
        return sq.sqrt()

    def _grad_norm_model(self, grads: dict[str, torch.Tensor], norm) -> torch.Tensor:
        """:meth:`grad_norm` with ``model`` ranks: the squares of the leaves
        split over both axes, over ``fsdp`` alone, over ``model`` alone and
        over neither, each summed over its axes."""
        parts: dict[tuple, list] = {}
        for k, g in grads.items():
            key = (self.grads_split and self.dims[k] is not None, self.mdims[k] is not None)
            parts.setdefault(key, []).append(g)
        zero = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)

        def sq(key):
            return norm(parts[key]).square() if key in parts else zero

        by_fsdp = all_reduce_(torch.stack([sq((True, True)), sq((True, False))]), self.fsdp)
        by_model = all_reduce_(torch.stack([by_fsdp[0], sq((False, True))]), self.model)
        return (by_model.sum() + by_fsdp[1] + sq((False, False))).sqrt()

    def update_views(self, params: dict, grads: dict) -> tuple[dict, dict]:
        """(params, gradients) as the optimizer updates them: this rank's
        shards at stage >= 1 (views into whole leaves at stages 1 and 2)."""
        if not self.state_split:
            return params, grads
        p = params if self.params_split else {k: self.shard(k, t) for k, t in params.items()}
        g = grads if self.grads_split else {k: self.shard(k, t) for k, t in grads.items()}
        return p, g

    @torch.no_grad()
    def gather_updated(self, params: dict) -> None:
        """Stages 1 and 2: every leaf's updated shards all-gathered into the
        whole leaf of every rank."""
        if not self.state_split or self.params_split or self.fsdp is None:
            return
        for k, p in params.items():
            d = self.dims[k]
            if d is not None:
                p.copy_(gather_dim(self.shard(k, p), d, self.fsdp))


class _Gather(torch.autograd.Function):
    """A leaf (or one layer of it) gathered whole from the ranks' shards,
    cast to ``dtype`` first (None: as it is). ``anchor`` (a 0-d device
    tensor that requires grad) puts the gather on the graph; the backward
    rounds the cotangent to the master's dtype, reduces it over the step's
    ranks to this rank's shard (:meth:`ZeroLayout.reduce_leaf`) and adds it
    to the stream's :class:`~tpu_engine_torch.offload.GradSums`."""

    @staticmethod
    def forward(ctx, anchor, src, dtype, stream, key, index):
        ctx.stream, ctx.key, ctx.index, ctx.master = stream, key, index, src.dtype
        x = src if dtype is None else src.to(dtype)
        d = stream.layout.dims[key]
        off = 0 if index is None else -1
        out = x if d is None else gather_dim(x, d + off, stream.layout.fsdp)
        return out.view_as(out) if out is src else out

    @staticmethod
    def backward(ctx, g):
        layout = ctx.stream.layout
        off = 0 if ctx.index is None else -1
        g = layout.reduce_leaf(ctx.key, g.to(ctx.master), off, owned=False)
        ctx.stream.sums.add(ctx.key, g, ctx.index)
        return None, None, None, None, None, None


class ShardedParams:
    """Stage 3's layer stream (JAX's ``layer_stream`` hook; the seam of
    :class:`~tpu_engine_torch.offload.HostParams`): the shards of the
    non-layer leaves gathered once a loss call (:meth:`bind`), each layer's
    inside its checkpointed block (:meth:`layer`), cast to the compute
    dtype; their gradients reduce-scatter into :attr:`sums`."""

    def __init__(self, layout: ZeroLayout, device, compute_dtype):
        self.layout = layout
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.anchor = torch.zeros((), device=self.device, requires_grad=True)
        self.params: dict[str, torch.Tensor] = {}
        self.sums = GradSums(self.device)

    def bind(self, params: dict[str, torch.Tensor], layers: bool = True) -> dict:
        """Gather from ``params`` (this rank's shards): the non-layer leaves
        whole in the master dtype (the model casts them where JAX does),
        beside the layer shards, which :meth:`layer` streams. With
        ``layers=False`` every leaf is gathered here (LoRA's adapters,
        rank-sized, passed whole as ``lora``)."""
        self.params = params
        return {k: (p if layers and k.startswith("layers.")
                    else _Gather.apply(self.anchor, p, None, self, k, None))
                for k, p in params.items()}

    def fetch(self, key: str, index: int) -> torch.Tensor:
        return _Gather.apply(self.anchor, self.params[key][index], self.compute_dtype, self,
                             key, index)

    def layer(self, index: int) -> _Layer:
        return _Layer(self, index)


def local_rows(batch: torch.Tensor, runtime, micro: int) -> torch.Tensor:
    """This rank's rows of a global [accum, micro·dp, S] batch."""
    c = runtime.coords
    i = c["data"] * runtime.axis_sizes["fsdp"] + c["fsdp"]
    return batch[:, i * micro:(i + 1) * micro]


def sequence_block(runtime, S: int) -> Optional[tuple[int, int]]:
    """(first position, positions) of this rank's block of a sequence of
    ``S``, or None without a ``sequence`` axis."""
    n = runtime.axis_sizes["sequence"]
    if n == 1:
        return None
    per = S // n
    return runtime.coords["sequence"] * per, per
