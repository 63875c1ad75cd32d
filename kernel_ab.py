"""Time the flash-attention kernels (K1 forward, K2 dQ, K3 dK/dV) of two
checkouts of the port on one card, in turns, beside the library's attention
on the same data.

    python3 kernel_ab.py --base path/to/other/checkout [--rounds 2]

Each checkout's ``tpu_engine_torch/ops/_flash_cuda.py`` is loaded as a module
of its own, so each builds its own kernels from its own sources. Per round
the order is base, this tree, this tree, base. Shapes: causal at B·H 64,
S 2048, D 128 (llama-1b's training step), non-causal and causal at the
ring shard, B·H 16 (llama-1b at seq 8192 over a ring of 4), and causal and
non-causal at B·H 4·8, S 2048, D 256 (gemma-2b's training step). K2 and K3
of both trees take the same lse and Δ (this tree's K1 forward). Each
kernel's bound (``chip_smoke.kernel_bounds``) is printed beside its times.
Times are device times by CUDA events over 20 calls queued behind a spin,
so host gaps do not count. The library's times (timed only, never called by the port)
are ``scaled_dot_product_attention`` for K1 and
``_scaled_dot_product_flash_attention_backward`` (dq, dk and dv together, on
its own forward's outputs) for the pair K2 + K3. With ``--sweep``, also
equal work at other B·H and S (``SWEEP``), and the host time of one
``flash_fwd`` call at a small shape (mean of 200 calls without a sync).
Prints the card, then one line per tree, kernel and shape, then one JSON
line of every time.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = {  # name: (B·H, S, D, causal)
    "causal_bh64": (64, 2048, 128, True),
    "full_bh16": (16, 2048, 128, False),
    "causal_bh16": (16, 2048, 128, True),
    "causal_d256": (32, 2048, 256, True),
    "full_d256": (32, 2048, 256, False),
}
# The same non-causal work (B·H · S^2 fixed) cut into more, shorter heads:
# q, k and v grow from 12.6 MB (fits L2) to 101 MB (does not).
SWEEP = {f"full_bh{bh}_s{s}": (bh, s, 128, False)
         for bh, s in ((4, 4096), (64, 1024), (256, 512))}
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _load(tree: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        name, tree / "tpu_engine_torch" / "ops" / "_flash_cuda.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build()
    mod._load()
    return mod


def _device_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # the calls queue up behind it
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, required=True, help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sweep", action="store_true", help="also the shapes of SWEEP")
    args = ap.parse_args()
    shapes = {**SHAPES, **(SWEEP if args.sweep else {})}
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    trees = {"base": _load(args.base.resolve(), "flash_base"), "this": _load(ROOT, "flash_this")}
    data = {}
    for key, (bh, s, d, causal) in shapes.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn((bh, s, d), generator=g, device="cuda").bfloat16()
                       for _ in range(4))
        o, lse = trees["this"].flash_fwd(q, k, v, 0, causal)
        data[key] = (q, k, v, do, lse, trees["this"].flash_delta(o, do))

    def call(fc, kernel, key):
        q, k, v, do, lse, delta = data[key]
        causal = shapes[key][3]
        if kernel == "flash_fwd":
            return lambda: fc.flash_fwd(q, k, v, 0, causal)
        return lambda: getattr(fc, kernel)(q, k, v, do, lse, delta, 0, causal)

    def library(op, key):
        bh, s, d, causal = shapes[key]
        q, k, v, do = (x.view(1, bh, s, d) for x in data[key][:4])
        if op == "sdpa":
            return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        o, lse, cq, ck, mq, mk, seed, offset = (
            torch.ops.aten._scaled_dot_product_flash_attention(q, k, v, 0.0, causal, False)[:8])
        bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
        return lambda: bwd(do, q, k, v, o, lse, cq, ck, mq, mk, 0.0, causal, seed, offset)

    bwd_keys = [key for key in shapes if key in SHAPES]  # the backward at the main shapes
    jobs = [(kn, key) for key in shapes for kn in KERNELS if kn == "flash_fwd" or key in bwd_keys]
    from chip_smoke import kernel_bounds

    out = {"card": card, "ms": {t: {f"{kn}/{key}": [] for kn, key in jobs} for t in trees},
           "bound_ms": {f"{kn}/{key}": kernel_bounds(bh, s, d, 0, 2, causal)[kn]["bound_ms"]
                        for kn, key in jobs for bh, s, d, causal in [shapes[key]]}}
    # sdpa: the forward; flash_bwd: dq, dk and dv together.
    out["ms"]["library"] = {f"{op}/{key}": [] for op in ("sdpa", "flash_bwd") for key in shapes
                            if op == "sdpa" or key in bwd_keys}
    for _ in range(args.rounds):
        for tree in ("base", "this", "this", "base"):
            for kn, key in jobs:
                out["ms"][tree][f"{kn}/{key}"].append(_device_ms(call(trees[tree], kn, key)))
        for name in out["ms"]["library"]:
            out["ms"]["library"][name].append(_device_ms(library(*name.split("/"))))
    if args.sweep:
        q, k, v = (torch.randn((1, 128, 128), device="cuda").bfloat16() for _ in range(3))
        out["host_us_per_call"] = {}
        for tree, fc in trees.items():
            for _ in range(10):
                fc.flash_fwd(q, k, v)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fc.flash_fwd(q, k, v)
            out["host_us_per_call"][tree] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
        print(f"host us per flash_fwd call: {json.dumps(out['host_us_per_call'])}", flush=True)
    for tree, rows in out["ms"].items():
        for key, times in rows.items():
            bound = out["bound_ms"].get(key)
            print(f"{tree:8s} {key:34s} " + " ".join(f"{x:.4f}" for x in times)
                  + (f"  (bound {bound:.4f})" if bound else ""), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
