"""Plant faults in the port's quantised training, LoRA and remat paths on one
card and read what the checks of ``chip_smoke.py``'s ``train_int8``,
``train_lora`` and ``remat`` phases measure for each, beside the sound code
in the same run. ``INT8_LOGITS_REL``, ``INT8_LOSS_REL``, ``INT8_GRAD_COS``,
``INT8_BIAS_RATIO``, ``LORA_MERGED_REL`` and ``REMAT_TAG_SHARE`` there are
set from these readings.

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
  checkpoint the whole block (``transformer._remat_block``).

The readings are printed and written to ``chiprun_out/train_faults.json``.
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
    steps = 5
    out: dict = {"card": card, "bounds": {
        "int8_logits_rel": cs.INT8_LOGITS_REL, "int8_loss_rel": cs.INT8_LOSS_REL,
        "int8_grad_cos": cs.INT8_GRAD_COS, "int8_bias_ratio": cs.INT8_BIAS_RATIO,
        "lora_merged_rel": cs.LORA_MERGED_REL, "remat_tag_share": cs.REMAT_TAG_SHARE}}
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
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "train_faults.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
