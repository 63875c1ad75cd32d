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

``python3 train_faults.py --mesh`` reads the mesh alone, ``--offload`` the
placements alone (llama-1b at ``chip_smoke.OFFLOAD_L`` layers). The readings are
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


def mesh_fault(name: str):
    """The patch of the planted mesh fault ``name`` (for :func:`_patched`)."""
    from tpu_engine_torch import train
    from tpu_engine_torch.models import transformer
    from tpu_engine_torch.parallel import pipeline, ring_attention, zero

    return {"fsdp_skip_reduce_scatter": (zero.ZeroLayout, "reduce_leaf", _skip_reduce_scatter),
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
    if sys.argv[1:] == ["--mesh"]:
        out = {"card": card, "bounds": {"mesh_loss_rel": MESH_LOSS_REL,
                                        "mesh_ep_loss_rel": MESH_EP_LOSS_REL}}
        mesh_readings(cs, out)
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
    out["bounds"].update(mesh_loss_rel=MESH_LOSS_REL, mesh_ep_loss_rel=MESH_EP_LOSS_REL)
    mesh_readings(cs, out)
    _write(out)
    return 0


def _write(out: dict) -> None:
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "train_faults.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
