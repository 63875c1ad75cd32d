"""Training throughput and MFU of the PyTorch port on one NVIDIA GPU (the
port of ``bench.py``'s training metric), and one serving line.

    python3 bench_torch.py                  # every config, on the card
    python3 bench_torch.py --device cpu --model gpt-tiny --seq 64 --windows 2 --iters 1

On the card it times ``TrainProgram.step`` for ``bench.py``'s on-chip
configs (``CONFIGS``): llama-1b at micro-batch 6 and 8 with bf16 Adam first
moments, at 4, and at 4 with loss chunks of 512, then gpt-125m at 16 and 4;
all at seq 2048, bf16 compute, fp32 masters, activation checkpointing and
attention "auto" (the flash kernels). As ``bench.py:_run`` does: three
warm-up steps, then the minimum over ``--windows`` windows of ``--iters``
steps, each window ended by ``torch.cuda.synchronize()`` and a host read of
the loss.

Output, one JSON line each:

- per config: tokens/s, step ms (and each window's), MFU = tokens/s ×
  ``train_flops_per_token`` / 989 TFLOP/s (H100 SXM dense bf16), peak
  memory, and the card's name and power limit;
- the serving line: decode tokens/s and TTFT p50/p99 of the
  ``ContinuousBatcher`` at llama-1b on ``chip_smoke.py``'s ``serve`` plan
  (``chip_smoke._serve_plan``, ``chip_smoke._serve_run``, bf16 pool);
- last, ``bench.py``'s headline ``{"metric", "value", "unit",
  "vs_baseline"}`` from the first config that ran, ``vs_baseline`` being
  MFU / 0.45.

A config is skipped only when it runs out of device memory, and the skip
is printed with the config; any other error fails the run. Without a card
the script exits non-zero unless ``--device cpu`` is given. On the CPU
(``--model`` names one model, at micro-batch 1) the lines carry no MFU and
no serving line is printed: the CPU measures neither.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

from tpu_engine_torch.profiler import PEAK_FLOPS_BF16

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = PEAK_FLOPS_BF16["h100"]   # H100 SXM dense bf16 (NVIDIA data sheet)
MFU_TARGET = 0.45          # bench.py's north-star MFU: vs_baseline = MFU / 0.45
SEQ = 2048
# bench.py:_candidates' on-chip list, in its order: (model, micro-batch,
# Adam first-moment dtype, loss chunk).
CONFIGS = [
    ("llama-1b", 6, "bf16", None),
    ("llama-1b", 8, "bf16", None),
    ("llama-1b", 4, None, None),
    ("llama-1b", 4, None, 512),
    ("gpt-125m", 16, None, None),
    ("gpt-125m", 4, None, None),
]


def time_config(model: str, micro_batch: int, moment_dtype, loss_chunk, seq: int, device: str,
                windows: int, iters: int) -> dict:
    """Build, warm up and time one config; returns its numbers."""
    import torch

    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.train import TrainConfig, build_train_program

    cfg = TrainConfig(model_name=model, micro_batch_size=micro_batch, seq_len=seq,
                      precision="bf16", moment_dtype=moment_dtype, loss_chunk_size=loss_chunk,
                      activation_checkpointing=True, attention_impl="auto")
    prog = build_train_program(cfg, device=device)
    state = prog.init()
    batch = prog.synthetic_batch(seed=0)
    on_card = device == "cuda"

    def sync(metrics) -> float:
        if on_card:
            torch.cuda.synchronize()
        return float(metrics["loss"])

    for _ in range(3):  # warm-up
        state, metrics = prog.step(state, batch)
    sync(metrics)
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            state, metrics = prog.step(state, batch)
        loss = sync(metrics)
        times.append((time.perf_counter() - t0) / iters)
    if not math.isfinite(loss):
        raise AssertionError(f"{model}: non-finite loss {loss}")
    step_s = min(times)
    tokens = math.prod(prog.global_batch_shape())
    flops_tok = tfm.train_flops_per_token(prog.model_config, seq)
    return {
        "config": {"model": model, "micro_batch": micro_batch, "seq_len": seq,
                   "moment_dtype": moment_dtype, "loss_chunk_size": loss_chunk,
                   "attention": prog.model_config.attention_impl},
        "tokens_per_s": tokens / step_s, "step_ms": step_s * 1e3,
        "step_ms_windows": [t * 1e3 for t in times], "loss": loss,
        "mfu": tokens / step_s * flops_tok / PEAK_BF16_FLOPS if on_card else None,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
    }


def serving_line() -> dict:
    """The batcher at llama-1b on chip_smoke.py's serve plan (bf16 pool)."""
    import chip_smoke as cs

    cfg, params = cs._llama_1b({})
    run = cs._serve_run(params, cfg, cs._serve_plan(cfg), "bench")
    return {"serving": cfg.name, "requests": len(run["tokens"]),
            "decode_tokens_per_s": run["decode_tokens_per_s"],
            "ttft_ms_p50": run["ttft_ms_p50"], "ttft_ms_p99": run["ttft_ms_p99"],
            "tokens_per_s": run["tokens_per_s"], "dispatch_ms": run["dispatch_ms"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--model", help="time only this model (micro-batch 1, at --seq)")
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10, help="steps per window")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device; pass --device cpu for a CPU run", file=sys.stderr)
        return 2
    if args.device == "cuda":
        import chip_smoke as cs

        card, kind = cs._card_line(), torch.cuda.get_device_name(0)
    else:
        card = kind = "cpu"
    print(card, flush=True)
    configs = CONFIGS if args.model is None else [(args.model, 1, None, None)]
    seq = SEQ if args.model is None else args.seq

    first = None
    for model, mb, moments, chunk in configs:
        if args.device == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        try:
            row = time_config(model, mb, moments, chunk, seq, args.device, args.windows,
                              args.iters)
        except torch.cuda.OutOfMemoryError as e:
            print(json.dumps({"skipped": {"model": model, "micro_batch": mb,
                                          "moment_dtype": moments, "loss_chunk_size": chunk},
                              "reason": f"out of device memory: {str(e).splitlines()[0]}"}),
                  flush=True)
            continue
        row.update(device=kind, card=card)
        print(json.dumps(row), flush=True)
        first = first or row
    if first is None:
        print("bench_torch: no config fit the device", file=sys.stderr)
        return 1
    if args.device == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({**serving_line(), "device": kind, "card": card}), flush=True)
        mfu = first["mfu"]
        headline = {"metric": f"mfu_{first['config']['model']}_singlechip",
                    "value": round(mfu * 100, 2), "unit": "% MFU",
                    "vs_baseline": round(mfu / MFU_TARGET, 3)}
    else:
        headline = {"metric": f"tokens_per_sec_{first['config']['model']}_cpu",
                    "value": round(first["tokens_per_s"], 1), "unit": "tokens/s",
                    "vs_baseline": 0.0}
    headline.update(tokens_per_sec=round(first["tokens_per_s"], 1),
                    step_time_ms=round(first["step_ms"], 2), device_kind=kind, card=card)
    print(json.dumps(headline), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
