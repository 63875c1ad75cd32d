"""Plant faults in the port's quantised training, LoRA, remat and offload
paths on one card and read what the checks of ``chip_smoke.py``'s
``train_int8``, ``train_lora``, ``remat`` and ``train_offload`` phases
measure for each, beside the sound code in the same run.
``INT8_LOGITS_REL``, ``INT8_LOSS_REL``, ``INT8_GRAD_COS``,
``INT8_BIAS_RATIO``, ``LORA_MERGED_REL``, ``REMAT_TAG_SHARE`` and
``DISK_LOSS_REL`` there are set from these readings.

    python3 train_faults.py

Each fault patches one function for the length of its reading:

- int8 (``chip_smoke.int8_readings``: ``train_int8``'s llama-1b in int8
  against bf16 on the same weights and batch; logits by relative norm
  error, first loss, each group's gradient cosine):
  ``int8_sound``; ``int8_scale_dropped``: the outer product of the scales
  left out of the dequantisation (``quant_train._scales_outer`` gives 1);
  ``int8_per_tensor``: one scale per operand in place of one per channel
  (``quant_train.channel_quantize`` reduces over every axis);
- the backward's rounding (``chip_smoke.int8_bias_reading``, the ratio of
  the error of the mean of 16 backward products to a single one's):
  ``bias_sound``; ``bias_nearest``: the backward rounds to nearest
  (``quant_train.stochastic_round`` is ``torch.round``), biased;
- LoRA (``chip_smoke.lora_merged_rel`` after ``train_lora``'s steps: the
  merged tree's logits against the adapter forward's): ``lora_sound``;
  ``lora_scale_dropped``: the projections add ``(h@A)@B`` without
  ``alpha/r`` (``transformer._proj``), while the merge keeps it;
- remat (``chip_smoke.remat_kept_bytes``: the bytes a forward keeps, over
  nothing_saveable's, as a share of the policy's tagged bytes):
  ``remat_sound``; ``remat_named_saves_nothing``: the named policies
  checkpoint the whole block (``transformer._remat_block``);
- where the state lives (``train_offload``'s llama-1b, at
  ``chip_smoke.OFFLOAD_L`` layers, for
  ``OFFLOAD_STEPS`` steps against the in-memory run: the largest relative
  gap of the losses, the leaves whose final weights differ, their largest
  gap): ``host_sound`` (the optimizer state on the host);
  ``host_moments_dropped``: the walk leaves one leaf's moments on the
  device, never copied back (``offload.UpdateWalk._store``);
  ``disk_sound``; ``disk_bias_off_by_one``: the host AdamW corrects its
  moments' bias one step ahead (``disk_offload.DiskAdamW.update``), which
  sets ``DISK_LOSS_REL``; and ``disk_overlap`` (sound, with
  ``disk_update_overlap``), whose step times beside ``disk_sound``'s say
  whether the overlap hides the host walk.

- the mesh (``chip_smoke.py``'s ``train_mesh``: llama-1b on two ranks, a
  process each, through NCCL on the one card, against the world-1 run at
  the same global batch; the largest relative gap of the losses and
  gradient norms, :func:`chip_smoke.mesh_rel`): ``mesh_sound`` (fsdp=2 at
  stage 3, and the ring over sequence=2); ``mesh_fsdp_skip_reduce_scatter``:
  one leaf's gradient left out of the fsdp reduce-scatter, each rank
  keeping its own share of its own rows' gradient
  (``parallel.zero.ZeroLayout.reduce_leaf``); ``mesh_ring_cotangents_dropped``:
  the ring's hops send no K/V cotangents back (``ring_attention._Hop.backward``
  returns zeros), which sets ``MESH_LOSS_REL``. (A ring of two ranks
  turns the same way both ways round, so a ring rotated the wrong way is
  no fault there.) On ``model`` (``tp2``: llama-1b at model=2; ``ep2``:
  moe-8x7b at 2 layers, 4 experts a rank): ``mesh_sound`` reads them too;
  ``mesh_tp_o_g_skipped``: rank 1 keeps its O projection's partial sums
  in place of their sum (``transformer._row_proj``; the all-reduce still
  runs, so the ranks' collectives pair); ``mesh_ep_router_sum_dropped``: the
  router's gradient, a part on each rank, is not summed over ``model``
  (``parallel.zero.ZeroLayout.reduce_leaf``). LoRA and Adafactor over
  ``model`` (``lora_tp2``, ``adafactor_tp2``) and the pipelines
  (``pipe_gpipe``, ``pipe_1f1b``, ``pipe_zb``: llama-1b on pipe=2, 4
  microbatches, each against ``w1_pipe``): ``mesh_sound`` reads them too;
  ``mesh_lora_partial_unsummed``: the gradient of o's B (a part on each
  rank: its LoRA term is applied to the rank's partial x·A) is not summed
  over ``model``; ``mesh_adafactor_mean_local``: Adafactor's factored means
  over a split dim stay the rank's own (the all-reduce runs, its sum is
  dropped), which the gap cannot see: the factored moment is invariant to
  a constant scale of its means, and the means over half of 2048 columns
  differ from the whole's by sampling alone (read as the sound run;
  ``tests/test_torch_tp_lora.py`` holds the reduction at 1e-6);
  ``mesh_pipe_cotangent_zero``: the last stage sends zeros in place of its
  input cotangents (``parallel.pipeline.exchange``; the trade still pairs).

- the compressed collectives (``chip_smoke.py``'s ``train_comm``: llama-1b
  at ``chip_smoke.COMM_L`` layers on two ranks; ``chip_smoke.comm_readings``):
  ``comm_sound``; ``qwz_dequant_before_wire``: the qwZ gather dequantizes
  its shard first and moves it full width (the rounding kept, so the loss
  cannot tell: the gather ratio does); ``qwz_scales_shifted``: each block
  dequantized with its neighbour's scale (the loss gap);
  ``hpz_stale``: hpZ's store never refreshed after the first one (the
  store's codes against the quantized shards); ``qgz_fp32_across``: the
  cross-slice sum moves fp32 (the cross-slice ratio);
  ``qgz_cross_unsummed``: each slice keeps its own gradient, the gather
  still run (the ranks' weights differ); ``bf16_rank1_unsummed``: rank 1
  keeps its own bf16 gradient (the ranks' weights differ). They set the
  ``COMM_*`` bounds.

- the mesh's state (``chip_smoke.py``'s ``train_mesh_state``: llama-1b at
  ``chip_smoke.STATE_L`` layers on two ranks, each run against its world-1
  run; ``state_sound``): ``host_shard_not_uploaded``: rank 1 gathers a zero
  buffer where its host shard should have been copied up
  (``parallel.zero._Gather``; the gather still pairs); ``disk_rank1_update_skipped``:
  rank 1's host walk uploads its masters unchanged
  (``disk_offload.DiskAdamW.update``); ``int8_rank1_grad_scales_dropped``:
  rank 1 dequantizes its weight gradient's product without the scales'
  outer product (``quant_train._quantized_dot``); ``int8_tp_absmax_local``:
  ``tp2_int8``'s o and down products quantised on each model rank with its
  own forward absmax (``transformer._split_dot``; the sum over model still
  runs), read also by the run's scale probe (``row_scales``: o's and
  down's operands whose scales differ from the whole operand's);
  ``moe_offset_dropped``:
  the sequence ranks' capacity offset left out, each rank placing its
  tokens from slot 0 (``transformer._rank_prefix``; the all-gather still
  runs); ``outer_leaves_unwritten``: the last stage saves its layer block
  alone (``checkpoint.TrainCheckpointManager._write``), read by the
  restore's bitwise check. They set ``STATE_LOSS_REL`` and
  ``STATE_INT8_LOSS_REL``.

``python3 train_faults.py --mesh`` reads the mesh alone (``--mesh --state``
only train_mesh_state's runs; ``--mesh --state tp2_int8 ...`` only the
runs named), ``--comm`` the
compressed collectives alone, ``--offload`` the placements alone (llama-1b
at ``chip_smoke.OFFLOAD_L`` layers). The readings are
printed and written to ``chiprun_out/train_faults.json``.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent


def _patched(patch):
    """A context with ``patch`` = (module, name, wrap) applied, or none."""
    if patch is None:
        return contextlib.nullcontext()
    module, name, wrap = patch
    return mock.patch.object(module, name, wrap(getattr(module, name)))


def _scales_dropped(real):
    def outer(spec, sl, sr):
        return real(spec, sl, sr).new_ones(())

    return outer


def _per_tensor(real):
    def quantize(x, axes, stochastic=False, salt=None):
        return real(x, tuple(range(x.dim())), stochastic=stochastic, salt=salt)

    return quantize


def _nearest(real):
    def rounding(y, salt):
        import torch

        return torch.round(y)

    return rounding


def _lora_scale_dropped(real):
    def proj(h, kernel, bias=None, lora_ab=None, lora_scale=1.0, dot=None):
        return real(h, kernel, bias, lora_ab, 1.0, dot)

    return proj


def _named_saves_nothing(real):
    def block(policy, *args):
        if policy in ("save_attn_out", "save_qkv_attn_out"):
            policy = "nothing_saveable"
        return real(policy, *args)

    return block


# The leaf whose moments the host-offload fault leaves on the device.
DROPPED_LEAF = "layers.gate.kernel"


def _moments_dropped(real):
    def store(self, key, src, dev):
        if key == DROPPED_LEAF:
            dev = {n: t for n, t in dev.items() if n == "p"}
        return real(self, key, src, dev)

    return store


def _bias_off_by_one(real):
    def update(self, grads, lr, step, emit):
        self.moment_steps += 1
        try:
            real(self, grads, lr, step, emit)
        finally:
            self.moment_steps -= 1

    return update


# The bound of train_mesh's two-rank runs against the world-1 run (losses
# and gradient norms, largest relative gap): set between the sound reading
# and the planted faults' (see the mesh readings below and CHANGES.md).
MESH_LOSS_REL = 2e-3
# ep2's own bound (moe-8x7b at model=2 against its world-1 run): its sound
# reading, 2.157e-3, lies past MESH_LOSS_REL; the router's gradient left
# unsummed over model reads 1.103e-2 (see CHANGES.md).
MESH_EP_LOSS_REL = 5e-3
# The leaf the fsdp fault leaves out of the reduce-scatter.
MESH_DROPPED_LEAF = "layers.gate.kernel"
# train_mesh_state's bounds against the world-1 runs (the state readings
# below; PERF.md §6): place2, disk2, moe_seq2 and pipe_ckpt by
# STATE_LOSS_REL (sound at most 4.694e-4, moe_seq2's; the nearest fault
# 1.935e-2, a host shard gathered unuploaded), int8_d2 (its backward's
# rounding drawn per rank) by STATE_INT8_LOSS_REL (sound 1.406e-4, the
# fault 1.110e8).
STATE_LOSS_REL = 2e-3
STATE_INT8_LOSS_REL = 2e-3


def _skip_reduce_scatter(real):
    def reduce_leaf(self, key, g, dim_offset=0, owned=True):
        d = self.dims[key]
        if key != MESH_DROPPED_LEAF or d is None or not self.grads_split:
            return real(self, key, g, dim_offset, owned)
        n = g.shape[d + dim_offset] // self.n_fsdp
        return g.narrow(d + dim_offset, self.i_fsdp * n, n)

    return reduce_leaf


def _cotangents_dropped(real):
    def backward(ctx, dk, dv):  # no send, no receive: on every rank alike
        return dk.new_zeros(dk.shape), dv.new_zeros(dv.shape), None, None, None

    return backward


def _o_g_skipped(real):
    def row_proj(h, lp, name, dot=None, lora_scale=1.0, tp=None):
        summed = real(h, lp, name, dot, lora_scale, tp)  # every rank's collective still runs
        if name != "o" or tp is None or tp.index != 1:
            return summed
        from tpu_engine_torch.models.transformer import _proj

        out = _proj(h, lp["o.kernel"], None, None, lora_scale, dot)  # rank 1 keeps its part
        bias = lp.get("o.bias")
        return out if bias is None else out + bias.to(out.dtype)

    return row_proj


MESH_ROUTER = "layers.router.kernel"
# The LoRA factor whose partial gradient the lora_tp2 fault leaves unsummed
# over model: B of a row-split target (its term rides inside g's sum). A of
# a column-split target would read as sound: B starts at zero, so A's
# gradient is zero until the last of three steps.
MESH_LORA_FACTOR = "layers.o.B"


def _sum_dropped(leaf):
    def wrap(real):
        def reduce_leaf(self, key, g, dim_offset=0, owned=True):
            if key != leaf or key not in self.partial:
                return real(self, key, g, dim_offset, owned)
            partial, self.partial = self.partial, self.partial - {key}
            try:
                return real(self, key, g, dim_offset, owned)
            finally:
                self.partial = partial

        return reduce_leaf

    return wrap


def _router_sum_dropped(real):
    return _sum_dropped(MESH_ROUTER)(real)


def _factored_mean_local(real):
    def mean(self, x, dim, key, keepdim=False, shift=0):
        out = x.mean(dim=dim, keepdim=keepdim)
        for d, group, n in self.splits.get(key, ()):
            if d == dim + shift:  # the collective still runs; its sum is discarded
                real(self, x, dim, key, keepdim, shift)
        return out

    return mean


def _last_stage_cotangent_zero(real):
    def exchange(sends, recvs, group):
        import torch
        import torch.distributed as dist

        if dist.get_rank() == dist.get_world_size() - 1:  # pipe=2: the last stage
            sends = [(torch.zeros_like(t), peer) for t, peer in sends]
        return real(sends, recvs, group)

    return exchange


# train_comm's bounds (chip_smoke.phase_train_comm), set between the sound
# readings and the planted faults' of ``--comm`` (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md): the largest relative loss gap of a compressed run to its
# uncompressed one (qwZ+hpZ 4.488e-5, qgZ 3.248e-5; each block read with
# its neighbour's scale 2.004e-3, each slice keeping its own gradient
# 3.458e-2), of the bf16 gradient reduction to the fp32 one (1.427e-5; rank
# 1 keeping its own 1.727e-2), the least ratio of the qwZ gather's fp32
# bytes to what its int8 codes and scales moved (3.9384; dequantized before
# the wire 0), and the least ratio of the cross-slice bytes of fp32 to
# those of qgZ (3.9385; fp32 across 1.0).
COMM_LOSS_REL = 5e-4
COMM_BF16_LOSS_REL = 5e-4
COMM_GATHER_RATIO_MIN = 3.5
COMM_CROSS_RATIO_MIN = 3.0


def _dequant_before_wire(real):
    def gather(self, src, key, dim, dtype, hpz=None, index=None):
        from tpu_engine_torch import comm_compress as cc
        from tpu_engine_torch.parallel.collectives import gather_dim

        codes, scales = cc.blockwise_quantize(src, self.block)
        local = cc.blockwise_dequantize(codes, scales, self.block, last=src.shape[-1],
                                        dtype=dtype)
        return gather_dim(local, dim, self.fsdp)  # the rounding kept, the wire full width

    return gather


def _scales_shifted(real):
    def gather(self, src, key, dim, dtype, hpz=None, index=None):
        import torch

        from tpu_engine_torch import comm_compress as cc

        real_q = cc.blockwise_quantize

        def shifted(x, block, *a, **kw):
            codes, scales = real_q(x, block, *a, **kw)
            return codes, torch.roll(scales, 1, dims=-1)  # each block reads its neighbour's

        cc.blockwise_quantize = shifted
        try:
            return real(self, src, key, dim, dtype, None, index)
        finally:
            cc.blockwise_quantize = real_q

    return gather


def _stale_hpz(real):
    def refresh(self, params):
        if getattr(self, "_first", None) is None:
            self._first = real(self, params)  # the store of the initial weights, kept
        return self._first

    return refresh


def _fp32_across(real):
    def reduce_data(self, g):
        from tpu_engine_torch.parallel.collectives import all_reduce_

        if self.intra is not None:
            g = all_reduce_(g.contiguous(), self.intra)
        return all_reduce_(g.contiguous(), self.cross)

    return reduce_data


def _cross_unsummed(real):
    def reduce_data(self, g):
        from tpu_engine_torch.parallel.collectives import all_reduce_

        own = all_reduce_(g.contiguous(), self.intra) if self.intra is not None else g.clone()
        real(self, g)  # the cross-slice gather still runs; its sum is dropped
        return own

    return reduce_data


def _bf16_rank1_unsummed(real):
    def reduce_leaf(self, key, g, dim_offset=0, owned=True):
        import torch.distributed as dist

        summed = real(self, key, g, dim_offset, owned)
        if self.comm_dtype is None or dist.get_rank() != 1:
            return summed
        return g.to(self.comm_dtype).float()  # rank 1 keeps its own bf16 gradient

    return reduce_leaf


def comm_fault(name: str):
    """The patch of the planted train_comm fault ``name``."""
    from tpu_engine_torch import comm_compress
    from tpu_engine_torch.parallel import zero

    return {"qwz_dequant_before_wire": (comm_compress.Compression, "gather",
                                        _dequant_before_wire),
            "qwz_scales_shifted": (comm_compress.Compression, "gather", _scales_shifted),
            "hpz_stale": (comm_compress.Compression, "refresh", _stale_hpz),
            "qgz_fp32_across": (comm_compress.Compression, "reduce_data", _fp32_across),
            "qgz_cross_unsummed": (comm_compress.Compression, "reduce_data", _cross_unsummed),
            "bf16_rank1_unsummed": (zero.ZeroLayout, "reduce_leaf", _bf16_rank1_unsummed)}[name]


COMM_FAULT_RUNS = {
    "comm_sound": None,
    "qwz_dequant_before_wire": ["fsdp2_fp32", "fsdp2_qwz"],
    "qwz_scales_shifted": ["fsdp2_fp32", "fsdp2_qwz"],
    "hpz_stale": ["fsdp2_fp32", "fsdp2_qwz"],
    "qgz_fp32_across": ["dcn_fp32", "dcn_qgz"],
    "qgz_cross_unsummed": ["dcn_fp32", "dcn_qgz"],
    "bf16_rank1_unsummed": ["data2_fp32", "data2_bf16"],
}


def comm_readings(cs, out: dict, steps: int = 3) -> None:
    """train_comm's readings (``chip_smoke.comm_readings``, and whether
    hpZ's store is the quantized shards) for the sound code and each
    planted fault, a two-rank job each."""
    for name, runs in COMM_FAULT_RUNS.items():
        ranks = cs.mesh_launch([], 2, steps, f"faults_{name}",
                               None if name == "comm_sound" else name,
                               comm=runs or list(cs.COMM_RUNS))
        r = out[name] = cs.comm_readings(ranks)
        if "fsdp2_qwz" in ranks[0]["comm"]:
            r["hpz_equal"] = [rk["comm"]["fsdp2_qwz"].get("hpz_equal") for rk in ranks]
        r["losses"] = {run: [rk["comm"][run]["losses"] for rk in ranks]
                       for run in ranks[0]["comm"]}
        print(f"{name}: {json.dumps(r)}", flush=True)


def _rank1() -> bool:
    import torch.distributed as dist

    return dist.get_rank() == 1


def _host_shard_not_uploaded(real):
    """Rank 1 gathers a zero buffer where its host shard should have been
    copied up (the gather still runs, so the ranks' collectives pair)."""
    def forward(ctx, anchor, src, dtype, stream, key, index):
        if src.device != anchor.device and _rank1():
            import torch

            src = torch.zeros(src.shape, dtype=src.dtype, device=anchor.device)
        return real(ctx, anchor, src, dtype, stream, key, index)

    return forward


def _disk_rank1_update_skipped(real):
    """Rank 1's host walk applies no update: it uploads its masters as they
    were and records the step as applied."""
    def update(self, grads, lr, step, emit):
        if not _rank1():
            return real(self, grads, lr, step, emit)
        for key, slab in self.slabs.items():
            emit(key, slab.master)
        self.step_on_disk = step

    return update


def _int8_rank1_grad_scales_dropped(real):
    """Rank 1 dequantizes its weight gradient's product without the scales'
    outer product (their max over the ranks still runs)."""
    def dot(spec, lhs, rhs, stochastic, group=None):
        if group is None or not _rank1():
            return real(spec, lhs, rhs, stochastic, group)
        from tpu_engine_torch import quant_train as qt

        with mock.patch.object(qt, "_scales_outer", lambda s, a, b: a.new_ones(())):
            return real(spec, lhs, rhs, stochastic, group)

    return dot


def _tp_absmax_local(real):
    """o's and down's forward absmax left to each model rank: every rank
    quantises its block with scales of its own (the partial products are
    still dequantised and summed over model)."""
    def split(dot, tp, row):
        return dot if row else real(dot, tp, row)

    return split


def _moe_offset_dropped(real):
    """The sequence ranks' capacity offset left out: each rank places its
    tokens from slot 0 (the all-gather of the counts still runs)."""
    def prefix(counts, seq):
        before, row = real(counts, seq)
        return before * 0, row

    return prefix


def _outer_leaves_unwritten(real):
    """The last stage writes its layer block alone: its outer leaves (the
    final norm, the head and their moments) are left out of its save."""
    def write(self, step, snap, splits, metrics, ready, t0):
        if _rank1():
            keep = {k for k, v in snap.items()
                    if not hasattr(v, "shape") or k.rsplit("/", 1)[-1].startswith("layers.")}
            snap = {k: v for k, v in snap.items() if k in keep}
            splits = {k: v for k, v in splits.items() if k in keep}
        return real(self, step, snap, splits, metrics, ready, t0)

    return write


def mesh_fault(name: str):
    """The patch of the planted mesh fault ``name`` (for :func:`_patched`)."""
    from tpu_engine_torch import checkpoint, quant_train, train
    from tpu_engine_torch import disk_offload as dsk
    from tpu_engine_torch.models import transformer
    from tpu_engine_torch.parallel import pipeline, ring_attention, zero

    return {"host_shard_not_uploaded": (zero._Gather, "forward", _host_shard_not_uploaded),
            "disk_rank1_update_skipped": (dsk.DiskAdamW, "update", _disk_rank1_update_skipped),
            "int8_rank1_grad_scales_dropped": (quant_train, "_quantized_dot",
                                               _int8_rank1_grad_scales_dropped),
            "int8_tp_absmax_local": (transformer, "_split_dot", _tp_absmax_local),
            "moe_offset_dropped": (transformer, "_rank_prefix", _moe_offset_dropped),
            "outer_leaves_unwritten": (checkpoint.TrainCheckpointManager, "_write",
                                       _outer_leaves_unwritten),
            "fsdp_skip_reduce_scatter": (zero.ZeroLayout, "reduce_leaf", _skip_reduce_scatter),
            "ring_cotangents_dropped": (ring_attention._Hop, "backward",
                                        _cotangents_dropped),
            "tp_o_g_skipped": (transformer, "_row_proj", _o_g_skipped),
            "ep_router_sum_dropped": (zero.ZeroLayout, "reduce_leaf",
                                      _router_sum_dropped),
            "lora_partial_unsummed": (zero.ZeroLayout, "reduce_leaf",
                                      _sum_dropped(MESH_LORA_FACTOR)),
            "adafactor_mean_local": (train.Adafactor, "_mean", _factored_mean_local),
            "pipe_cotangent_zero": (pipeline, "exchange", _last_stage_cotangent_zero)}[name]


def mesh_readings(cs, out: dict, steps: int = 3) -> None:
    """The mesh's readings (module docstring) into ``out``: each two-rank
    run's largest relative gap to its world-1 run, per rank."""
    w1 = cs.mesh_world1(["w1_2048", "w1_8192", "w1_moe", "w1_lora", "w1_ada", "w1_pipe"],
                        steps)
    for name, runs, fault in (
            ("mesh_sound", ["fsdp2", "ring2", "tp2", "ep2", "lora_tp2", "adafactor_tp2",
                            "pipe_gpipe", "pipe_1f1b", "pipe_zb"], None),
            ("mesh_fsdp_skip_reduce_scatter", ["fsdp2"], "fsdp_skip_reduce_scatter"),
            ("mesh_ring_cotangents_dropped", ["ring2"], "ring_cotangents_dropped"),
            ("mesh_tp_o_g_skipped", ["tp2"], "tp_o_g_skipped"),
            ("mesh_ep_router_sum_dropped", ["ep2"], "ep_router_sum_dropped"),
            ("mesh_lora_partial_unsummed", ["lora_tp2"], "lora_partial_unsummed"),
            ("mesh_adafactor_mean_local", ["adafactor_tp2"], "adafactor_mean_local"),
            ("mesh_pipe_cotangent_zero", ["pipe_zb"], "pipe_cotangent_zero")):
        ranks = cs.mesh_launch(runs, 2, steps, f"faults_{name}", fault)
        for run in runs:
            ref = w1[cs.MESH_RUNS[run][3]]
            r = out[f"{name}:{run}"] = {
                "rel": [cs.mesh_rel(rk["runs"][run], ref) for rk in ranks],
                "losses": [rk["runs"][run]["losses"] for rk in ranks],
                "grad_norms": [rk["runs"][run]["grad_norms"] for rk in ranks],
                "ref_losses": ref["losses"], "ref_grad_norms": ref["grad_norms"]}
            bound = MESH_EP_LOSS_REL if run == "ep2" else MESH_LOSS_REL
            print(f"{name} {run}: largest relative gap to the world-1 run, per rank, "
                  f"{[f'{x:.4e}' for x in r['rel']]} (bound {bound}); "
                  f"losses {r['losses']}, grad norms {r['grad_norms']}; world 1 "
                  f"{r['ref_losses']}, {r['ref_grad_norms']}", flush=True)


def state_readings(cs, out: dict, steps: int = 3, only=None) -> None:
    """train_mesh_state's readings: each run's largest relative gap to its
    world-1 run per rank, sound and under its planted fault, and
    pipe_ckpt's restore (bitwise on the ranks) sound and with the last
    stage's outer leaves unwritten. ``only``: the runs read (all of
    STATE_RUNS by default)."""
    import shutil
    import tempfile

    only = list(only or cs.STATE_RUNS)
    w1 = cs.mesh_world1(list(dict.fromkeys(cs.MESH_RUNS[r][3] for r in only)), steps)
    for name, runs, fault in (
            ("state_sound", list(cs.STATE_RUNS), None),
            ("state_host_shard_not_uploaded", ["place2"], "host_shard_not_uploaded"),
            ("state_disk_rank1_update_skipped", ["disk2"], "disk_rank1_update_skipped"),
            ("state_int8_rank1_grad_scales_dropped", ["int8_d2"],
             "int8_rank1_grad_scales_dropped"),
            ("state_int8_tp_absmax_local", ["tp2_int8"], "int8_tp_absmax_local"),
            ("state_moe_offset_dropped", ["moe_seq2"], "moe_offset_dropped"),
            ("state_outer_leaves_unwritten", ["pipe_ckpt"], "outer_leaves_unwritten")):
        runs = [r for r in runs if r in only]
        if not runs:
            continue
        work = tempfile.mkdtemp(prefix="train_faults_state_")
        try:
            ranks = cs.mesh_launch(runs, 2, steps, f"faults_{name}", fault, work=work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        for run in runs:
            ref = w1[cs.MESH_RUNS[run][3]]
            r = out[f"{name}:{run}"] = {
                "rel": [cs.mesh_rel(rk["runs"][run], ref) for rk in ranks],
                "losses": [rk["runs"][run]["losses"] for rk in ranks],
                "ref_losses": ref["losses"], "bound": cs.state_bound(run)}
            if run == "pipe_ckpt":
                r["ckpt_bitwise"] = [rk["runs"][run]["ckpt"]["bitwise"] for rk in ranks]
            if run == "tp2_int8":
                r["row_scales"] = [rk["runs"][run]["row_scales"] for rk in ranks]
            print(f"{name} {run}: largest relative gap to the world-1 run, per rank, "
                  f"{[f'{x:.4e}' for x in r['rel']]} (bound {r['bound']}); losses "
                  f"{r['losses']}; world 1 {r['ref_losses']}"
                  + (f"; restore bitwise {r['ckpt_bitwise']}" if "ckpt_bitwise" in r else "")
                  + (f"; o/down scales against the whole operand's {r['row_scales']}"
                     if "row_scales" in r else ""), flush=True)


def _offload_run(cs, extra: dict) -> tuple[list, dict, list]:
    """``train_offload``'s llama-1b (OFFLOAD_L layers) in one placement for
    OFFLOAD_STEPS steps: (losses, the final weights on the device, step
    seconds)."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory(prefix="train_faults_spill_") as spill:
        if extra.get("optimizer_offload") == "disk":
            extra = {**extra, "optimizer_spill_dir": spill}
        prog, state, _, losses, _, times, *_ = cs._run_steps(
            cs._llama_1b_cfg(**extra), cs.OFFLOAD_STEPS, "flash", model_cfg=cs._offload_model())
        state = prog.flush(state)
        if prog.disk is not None:  # its masters: the device holds them rounded to bf16
            params = {k: torch.from_numpy(w).cuda() for k, w in prog.disk.store.masters().items()}
        else:
            params = {k: p.detach().to("cuda", copy=True) for k, p in state["params"].items()}
        del prog, state
    torch.cuda.empty_cache()
    return losses, params, times


def _offload_reading(ref: tuple, got: tuple) -> dict:
    (rl, rp, _), (gl, gp, times) = ref, got
    diff = [k for k in rp if not gp[k].float().equal(rp[k].float())]
    return {"losses": gl, "step_s": times,
            "loss_rel": max(abs(a - b) / b for a, b in zip(gl, rl)),
            "leaves_differ": diff,
            "max_abs": max((float((gp[k].float() - rp[k].float()).abs().max()) for k in diff),
                           default=0.0)}


def offload_readings(cs, out: dict) -> None:
    """The placements' readings (module docstring) into ``out``."""
    from tpu_engine_torch import disk_offload as dsk
    from tpu_engine_torch import offload

    ref = _offload_run(cs, {})
    for name, extra, patch in (
            ("host_sound", {"optimizer_offload": "host"}, None),
            ("host_moments_dropped", {"optimizer_offload": "host"},
             (offload.UpdateWalk, "_store", _moments_dropped)),
            ("disk_sound", {"optimizer_offload": "disk"}, None),
            ("disk_bias_off_by_one", {"optimizer_offload": "disk"},
             (dsk.DiskAdamW, "update", _bias_off_by_one)),
            ("disk_overlap", {"optimizer_offload": "disk", "disk_update_overlap": True}, None)):
        with _patched(patch):
            r = out[name] = _offload_reading(ref, _offload_run(cs, extra))
        print(f"{name}: losses {r['losses']}, relative gap {r['loss_rel']:.4e} "
              f"(DISK_LOSS_REL {cs.DISK_LOSS_REL}), {len(r['leaves_differ'])} leaves differ, "
              f"largest gap {r['max_abs']:.4e}, step seconds {r['step_s']}", flush=True)


def _lora_run(cs, steps: int) -> float:
    """``train_lora``'s program for ``steps`` steps on its synthetic batch,
    then the merged tree's logits against the adapter forward's."""
    import torch

    from tpu_engine_torch.train import build_train_program

    prog = build_train_program(cs.lora_config(), device="cuda")
    state = prog.init()
    batch = prog.synthetic_batch(seed=0)
    for _ in range(steps):
        state, _ = prog.step(state, batch)
    rel = cs.lora_merged_rel(prog, state["params"], batch[0])
    del prog, state
    torch.cuda.empty_cache()
    return rel


def _remat_extra(cs) -> dict:
    """Each named policy's kept bytes over nothing_saveable's, as a share of
    its tagged bytes."""
    import torch

    from tpu_engine_torch.train import build_train_program

    kept = {}
    for policy in ("nothing_saveable", "save_attn_out", "save_qkv_attn_out"):
        prog = build_train_program(cs._llama_1b_cfg(remat_policy=policy), device="cuda")
        state = {"params": prog.init()["params"]}
        kept[policy] = cs.remat_kept_bytes(prog, state, prog.synthetic_batch(seed=0))
        del prog, state
        torch.cuda.empty_cache()
    return {p: (kept[p] - kept["nothing_saveable"]) / cs.remat_tagged_bytes(p)
            for p in ("save_attn_out", "save_qkv_attn_out")}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("train_faults: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpu_engine_torch import quant_train as qt
    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.ops import _flash_cuda as fc

    card = cs._card_line()
    print(card, flush=True)
    fc.build()
    fc._load()
    if sys.argv[1:2] == ["--mesh"]:
        out = {"card": card, "bounds": {"mesh_loss_rel": MESH_LOSS_REL,
                                        "mesh_ep_loss_rel": MESH_EP_LOSS_REL,
                                        "state_loss_rel": STATE_LOSS_REL,
                                        "state_int8_loss_rel": STATE_INT8_LOSS_REL}}
        if sys.argv[2:3] != ["--state"]:
            mesh_readings(cs, out)
        state_readings(cs, out, only=sys.argv[3:])
        _write(out)
        return 0
    if sys.argv[1:] == ["--comm"]:
        out = {"card": card, "bounds": {"comm_loss_rel": COMM_LOSS_REL,
                                        "comm_bf16_loss_rel": COMM_BF16_LOSS_REL,
                                        "comm_gather_ratio_min": COMM_GATHER_RATIO_MIN,
                                        "comm_cross_ratio_min": COMM_CROSS_RATIO_MIN}}
        comm_readings(cs, out)
        _write(out)
        return 0
    if sys.argv[1:] == ["--offload"]:
        out = {"card": card, "bounds": {"disk_loss_rel": cs.DISK_LOSS_REL}}
        offload_readings(cs, out)
        _write(out)
        return 0
    steps = 5
    out: dict = {"card": card, "bounds": {
        "int8_logits_rel": cs.INT8_LOGITS_REL, "int8_loss_rel": cs.INT8_LOSS_REL,
        "int8_grad_cos": cs.INT8_GRAD_COS, "int8_bias_ratio": cs.INT8_BIAS_RATIO,
        "lora_merged_rel": cs.LORA_MERGED_REL, "remat_tag_share": cs.REMAT_TAG_SHARE,
        "disk_loss_rel": cs.DISK_LOSS_REL}}
    int8_cfg = cs._llama_1b_cfg(quant_training="int8", quant_train_targets=cs.INT8_TARGETS)
    for name, patch in {"int8_sound": None,
                        "int8_scale_dropped": (qt, "_scales_outer", _scales_dropped),
                        "int8_per_tensor": (qt, "channel_quantize", _per_tensor)}.items():
        with _patched(patch):
            r = out[name] = cs.int8_readings(int8_cfg)
        torch.cuda.empty_cache()
        print(f"{name}: logits {r['logits_rel_err']:.4e}, first loss {r['loss_rel_err']:.4e}, "
              f"gradient cosines {r['grad_cos']}", flush=True)
    for name, patch in {"bias_sound": None,
                        "bias_nearest": (qt, "stochastic_round", _nearest)}.items():
        with _patched(patch):
            r = out[name] = cs.int8_bias_reading()
        print(f"{name}: single {r['single_rel_err']:.4e}, mean of {r['draws']} "
              f"{r['mean_rel_err']:.4e}, ratio {r['ratio']:.4f}", flush=True)
    for name, patch in {"lora_sound": None,
                        "lora_scale_dropped": (tfm, "_proj", _lora_scale_dropped)}.items():
        with _patched(patch):
            out[name] = _lora_run(cs, steps)
        print(f"{name}: merged against adapter logits {out[name]:.4e} after {steps} steps",
              flush=True)
    for name, patch in {"remat_sound": None,
                        "remat_named_saves_nothing": (tfm, "_remat_block",
                                                      _named_saves_nothing)}.items():
        with _patched(patch):
            out[name] = _remat_extra(cs)
        print(f"{name}: kept over nothing_saveable, as a share of the tagged bytes: "
              f"{out[name]}", flush=True)
    offload_readings(cs, out)
    out["bounds"].update(mesh_loss_rel=MESH_LOSS_REL, mesh_ep_loss_rel=MESH_EP_LOSS_REL,
                         state_loss_rel=STATE_LOSS_REL, state_int8_loss_rel=STATE_INT8_LOSS_REL)
    mesh_readings(cs, out)
    state_readings(cs, out)
    _write(out)
    return 0


def _write(out: dict) -> None:
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "train_faults.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
