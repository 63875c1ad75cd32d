"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --steps 3  # fewer training steps

Phases, each of which must pass (the script exits non-zero otherwise):

1. build: compile the flash-attention kernels (K1 forward, K2 dQ, K3 dK/dV)
   from ``tpu_engine_torch/csrc`` with nvcc for sm_90a;
2. kernels: hold each kernel to its plain PyTorch version at the training
   shape (B·H 4·16, S 2048, D 128, bf16), on small fp32 cases with TF32 off,
   on a sliding-window case and a D=64 case; time each kernel beside its
   plain version, its bound and the ``scaled_dot_product_attention``
   yardstick (timed only, never called by the port);
3. model: a small llama through the flash kernels against the plain
   attention path, in fp32 and in bf16 compute; head: the LM head's
   backward against fp32 products;
4. train: a llama-1b training step at full width (seq 2048, bf16 compute,
   fp32 masters, AdamW, activation checkpointing, attention "auto"), with the
   kernel launch counts read around the run.

Output: the card's name and power limit, the phases' numbers, one JSON line
of per-kernel results, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Everything is also written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3

# Tolerances: kernel against its plain version on the same inputs. Each
# output is held elementwise (atol/rtol) and, since the elementwise bf16
# limits are as large as a typical attention output, also by its relative
# norm error ||got - want|| / ||want||. A dropped tile or a wrong row scale
# moves that by far more than bf16 rounding does: on an H100, rounding gives
# at most 2.8e-3 at the training shape, and dQ with its later half of rows
# scaled by 0.97 gives 1.2e-2, which the elementwise limits let pass. lse is
# fp32 in every kernel, so it is held to fp32 limits whatever the dtype.
TOL = {
    "bf16_out": dict(atol=3e-2, rtol=3e-2),   # o
    "bf16_grad": dict(atol=0.15, rtol=0.1),   # dq, dk, dv
    "fp32_out": dict(atol=2e-5, rtol=2e-5),   # o, and lse for both dtypes
    "fp32_grad": dict(atol=5e-4, rtol=5e-4),
}
REL = {"bf16": 6e-3, "fp32": 1e-5}
# Flash against the plain attention path through a small llama, by relative
# norm error of the logits and of dWq; and the LM head's backward against
# fp32 products.
MODEL_REL = {"bf16": 2e-2, "fp32": 1e-5}
HEAD_REL = 1e-4


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _close(name, got, want, tol, rel=None) -> tuple[float, float]:
    """Hold ``got`` to ``want`` elementwise within ``tol`` and, if ``rel`` is
    given, by relative norm error. Returns (max |err|, relative norm error)."""
    import torch

    got, want = got.float(), want.float()
    diff = got - want
    err = float(diff.abs().max())
    rel_err = float(diff.norm() / want.norm().clamp_min(1e-30))
    if not torch.allclose(got, want, **tol):
        bad = diff.abs() > tol["atol"] + tol["rtol"] * want.abs()
        raise AssertionError(f"{name}: max_abs_err {err:.3e}, {int(bad.sum())} elements "
                             f"outside atol={tol['atol']} rtol={tol['rtol']}")
    if rel is not None and not rel_err <= rel:
        raise AssertionError(f"{name}: relative norm error {rel_err:.3e} > {rel}")
    return err, rel_err


def _inputs(bh, s, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((bh, s, d), generator=g, device="cuda", dtype=torch.float32).to(dtype)
            for _ in range(4)]  # q, k, v, dO


def check_case(fc, bh, s, d, dtype, window, seed) -> dict:
    """Run K1, K2 and K3 and their plain versions on one case; raise if any
    result is outside its limits. Returns max |err| per output."""
    import torch

    q, k, v, do = _inputs(bh, s, d, dtype, seed)
    kind = "bf16" if dtype == torch.bfloat16 else "fp32"
    o, lse = fc.flash_fwd(q, k, v, window)
    delta = fc.flash_delta(o, do)
    dq = fc.flash_bwd_dq(q, k, v, do, lse, delta, window)
    dk, dv = fc.flash_bwd_dkv(q, k, v, do, lse, delta, window)
    torch.cuda.synchronize()
    po, plse = fc.flash_fwd_plain(q, k, v, window)
    pdq, pdk, pdv = fc.flash_bwd_plain(q, k, v, po, plse, do, window)
    label = f"bh{bh} s{s} d{d} {kind} w{window}"
    out, grad, rel = TOL[f"{kind}_out"], TOL[f"{kind}_grad"], REL[kind]
    checks = {"o": (o, po, out, rel), "lse": (lse, plse, TOL["fp32_out"], REL["fp32"]),
              "dq": (dq, pdq, grad, rel), "dk": (dk, pdk, grad, rel), "dv": (dv, pdv, grad, rel)}
    errs = {n: _close(f"{label} {n}", *c) for n, c in checks.items()}
    print(f"kernels {label}: " + " ".join(f"{n}={e:.3e} (rel {r:.2e})"
                                          for n, (e, r) in errs.items()), flush=True)
    return {n: e for n, (e, _) in errs.items()}


def kernel_bounds(bh, s, d, window, elem_bytes) -> dict:
    """Least time on the card for each kernel's work at this shape: FLOPs
    of the visible (q, k) pairs over the bf16 tensor-core peak, or bytes
    (each input read once, each output written once) over HBM bandwidth."""
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s))
    work = {  # (products of pairs·D, tensors of [BH,S,D] moved, row vectors moved)
        "flash_fwd": (2, 4, 1),      # q,k,v → o; lse
        "flash_bwd_dq": (3, 5, 2),   # q,k,v,dO → dq; lse, Δ
        "flash_bwd_dkv": (4, 6, 2),  # q,k,v,dO → dk,dv; lse, Δ
    }
    out = {}
    for name, (products, tensors, rows) in work.items():
        flops = 2.0 * products * bh * pairs * d
        nbytes = tensors * bh * s * d * elem_bytes + rows * bh * s * 4
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out[name] = {"flops": flops, "bytes": nbytes,
                     "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    return out


def phase_kernels(res: dict) -> None:
    import torch
    import torch.nn.functional as F

    from tpu_engine_torch.ops import _flash_cuda as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, H, S, D = 4, 16, 2048, 128
    main = check_case(fc, B * H, S, D, torch.bfloat16, 0, seed=0)
    for case in ((4, 256, 128, torch.float32, 0), (4, 256, 64, torch.float32, 37),
                 (8, 512, 128, torch.bfloat16, 100), (16, 1024, 64, torch.bfloat16, 0),
                 (2, 512, 64, torch.float32, 100)):
        check_case(fc, *case, seed=1)

    q, k, v, do = _inputs(B * H, S, D, torch.bfloat16, 0)
    o, lse = fc.flash_fwd(q, k, v)
    delta = fc.flash_delta(o, do)
    t = {
        "flash_fwd": _time_ms(lambda: fc.flash_fwd(q, k, v)),
        "flash_bwd_dq": _time_ms(lambda: fc.flash_bwd_dq(q, k, v, do, lse, delta)),
        "flash_bwd_dkv": _time_ms(lambda: fc.flash_bwd_dkv(q, k, v, do, lse, delta)),
    }
    plain = {
        "flash_fwd": _time_ms(lambda: fc.flash_fwd_plain(q, k, v), iters=3, warmup=1),
        "flash_bwd_dq": _time_ms(lambda: fc.flash_bwd_dq_plain(q, k, v, do, lse, delta),
                                 iters=3, warmup=1),
        "flash_bwd_dkv": _time_ms(lambda: fc.flash_bwd_dkv_plain(q, k, v, do, lse, delta),
                                  iters=3, warmup=1),
    }
    # Library yardstick on the same data, [B, H, S, D] views (timed only).
    ql, kl, vl = (x.view(B, H, S, D).detach().requires_grad_(True) for x in (q, k, v))
    dol = do.view(B, H, S, D)
    sdpa_fwd = _time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        torch.autograd.grad(out, (ql, kl, vl), dol)

    sdpa_both = _time_ms(sdpa_fwd_bwd)
    ours_both = _time_ms(lambda: fc.flash_bwd(q, k, v, *fc.flash_fwd(q, k, v), do))
    bounds = kernel_bounds(B * H, S, D, 0, 2)
    errs = {"flash_fwd": max(main["o"], main["lse"]), "flash_bwd_dq": main["dq"],
            "flash_bwd_dkv": max(main["dk"], main["dv"])}
    replaces = {
        "flash_fwd": "tpu_engine/ops/_flash_pallas.py:117",
        "flash_bwd_dq": "tpu_engine/ops/_flash_pallas.py:306",
        "flash_bwd_dkv": "tpu_engine/ops/_flash_pallas.py:341",
    }
    res["kernels"] = [
        {"name": name, "route": "cuda", "source": "tpu_engine_torch/csrc/flash_attention.cu",
         "replaces": replaces[name], "launches": None, "max_abs_err": errs[name],
         "ms": t[name], "plain_ms": plain[name], "bound_ms": bounds[name]["bound_ms"],
         "bound_by": bounds[name]["bound_by"],
         "library_ms": sdpa_fwd if name == "flash_fwd" else None}
        for name in t
    ]
    res["attention_fwd_bwd"] = {"kernels_ms": ours_both, "library_ms": sdpa_both,
                                "shape": [B, H, S, D]}
    for kr in res["kernels"]:
        print(f"time {kr['name']}: {kr['ms']:.4f} ms (plain {kr['plain_ms']:.3f}, bound "
              f"{kr['bound_ms']:.4f} by {kr['bound_by']}, library {kr['library_ms']})",
              flush=True)
    print(f"time fwd+bwd: kernels {ours_both:.4f} ms, sdpa {sdpa_both:.4f} ms", flush=True)


def phase_model(res: dict) -> None:
    """A small llama (GQA, remat) through the flash kernels vs the plain
    attention path, in fp32 (TF32 off) and in bf16 compute: logits and the
    gradient of the fp32 master Wq, each held by relative norm error (the
    gradients are of order 1e-6, so an absolute limit would say nothing)."""
    import torch

    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.models.config import ModelConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(name="llama-small", vocab_size=1024, d_model=256, n_layers=2,
                      n_heads=2, n_kv_heads=1, d_ff=512, max_seq_len=256)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen, device="cuda")
    no_abs = dict(atol=math.inf, rtol=0.0)
    res["model"] = {}
    for kind, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        out = {}
        for impl in ("xla", "flash"):
            params = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
            logits = tfm.forward(params, tokens, cfg.with_(attention_impl=impl),
                                 compute_dtype=dtype, remat=True)
            logits.square().mean().backward()
            out[impl] = (logits.detach(), params["layers.q.kernel"].grad)
        _, r_logits = _close(f"model {kind} logits", out["flash"][0], out["xla"][0], no_abs,
                             MODEL_REL[kind])
        _, r_grad = _close(f"model {kind} dWq", out["flash"][1], out["xla"][1], no_abs,
                           MODEL_REL[kind])
        res["model"][kind] = {"logits_rel_err": r_logits, "grad_rel_err": r_grad}
        print(f"model {kind}: flash vs plain relative norm error: logits {r_logits:.3e}, "
              f"dWq {r_grad:.3e}", flush=True)


def phase_head(res: dict) -> None:
    """The LM head's backward (bf16 operands, fp32 cotangent) at llama-1b's
    head width against the same products in fp32 (TF32 off), before the
    final rounding to bf16. Also records what one bf16 rounding of the
    cotangent would cost instead."""
    import torch

    from tpu_engine_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    N, D, V = 2048, 2048, 32000
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((N, D), generator=gen, device="cuda").bfloat16()
    w = (0.02 * torch.randn((D, V), generator=gen, device="cuda")).bfloat16()
    g = 1e-4 * torch.randn((N, V), generator=gen, device="cuda")
    dx, dw = tfm._head_grads_f32(x, w, g)
    ref_dx, ref_dw = g @ w.float().t(), x.float().t() @ g
    gb = g.bfloat16()
    no_abs = dict(atol=math.inf, rtol=0.0)
    out = {
        "dx_rel_err": _close("head dx", dx, ref_dx, no_abs, HEAD_REL)[1],
        "dw_rel_err": _close("head dw", dw, ref_dw, no_abs, HEAD_REL)[1],
        "dx_rel_err_bf16_cotangent": _close(
            "head dx (bf16 g)", torch.mm(gb, w.t(), out_dtype=torch.float32), ref_dx, no_abs)[1],
        "dw_rel_err_bf16_cotangent": _close(
            "head dw (bf16 g)", torch.mm(x.t(), gb, out_dtype=torch.float32), ref_dw, no_abs)[1],
    }
    res["head"] = out
    print("head backward vs fp32: " + " ".join(f"{k}={v:.3e}" for k, v in out.items()),
          flush=True)


def phase_train(res: dict, steps: int) -> None:
    import torch

    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.ops import _flash_cuda as fc
    from tpu_engine_torch.train import TrainConfig, build_train_program

    cfg = TrainConfig(model_name="llama-1b", micro_batch_size=4, gradient_accumulation_steps=1,
                      seq_len=2048, precision="bf16", param_dtype="fp32",
                      activation_checkpointing=True, attention_impl="auto",
                      learning_rate=3e-4, warmup_steps=2, total_steps=100)
    prog = build_train_program(cfg, device="cuda")
    assert prog.model_config.attention_impl == "flash", prog.model_config.attention_impl
    state = prog.init()
    batch = prog.synthetic_batch(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fc.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = prog.step(state, batch)
        losses.append(float(m["loss"]))  # host sync
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = dict(fc.launches)

    L = prog.model_config.n_layers
    micro = steps * cfg.gradient_accumulation_steps
    want = {"flash_fwd": 2 * L * micro, "flash_bwd_dq": L * micro, "flash_bwd_dkv": L * micro}
    tokens = math.prod(prog.global_batch_shape())
    step_s = min(times[1:]) if len(times) > 1 else times[0]
    flops_tok = tfm.train_flops_per_token(prog.model_config, cfg.seq_len)
    res["train"] = {
        "model": "llama-1b", "micro_batch": cfg.micro_batch_size, "seq_len": cfg.seq_len,
        "steps": steps, "losses": losses, "step_ms_each": [t * 1e3 for t in times],
        "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "mfu": tokens / step_s * flops_tok / PEAK_BF16_FLOPS,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts, "launches_expected": want,
    }
    print(f"train: losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"train: step {step_s * 1e3:.1f} ms (min of steps 2..{steps}), "
          f"{tokens / step_s:.0f} tokens/s, MFU {res['train']['mfu']:.4f} vs 989 TFLOP/s, "
          f"peak {res['train']['peak_mem_gib']:.2f} GiB, launches {counts}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(prog.model_config.vocab_size)) > 0.5:
        raise AssertionError(f"first loss {losses[0]} is not near ln(vocab)")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: {losses}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    res["train"]["profile"] = _profile_step(prog, state, batch)
    res["train"]["optimizer_ms"] = _time_optimizer(prog, state)


def _time_optimizer(prog, state) -> float:
    """Device time of the AdamW update alone over the llama-1b masters (CUDA
    events), on zero gradients at lr 0: the same tensors and passes as in a
    step, leaving the weights unchanged."""
    import torch

    params = state["params"]
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    ms = _time_ms(lambda: prog.tx.update(params, grads, state["opt_state"], 0.0),
                  iters=3, warmup=1)
    print(f"train: optimizer update {ms:.2f} ms", flush=True)
    return ms


def _profile_step(prog, state, batch) -> dict:
    """Device time of one more training step by kernel family, from
    torch.profiler (CUPTI). Families: the port's flash kernels, matrix
    products (cuBLAS/CUTLASS), and everything else (elementwise, norms,
    reductions, copies)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prog.step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    fam = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        ms = e.self_device_time_total / 1e3
        if "flash_fwd_" in name or "flash_bwd_d" in name:
            fam["flash"] += ms
        elif any(t in name for t in ("gemm", "nvjet", "cutlass", "sm90_xmma", "matmul")):
            fam["matmul"] += ms
        else:
            fam["other"] += ms
    busy = sum(fam.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    out = {
        "wall_ms": wall_ms, "device_ms": busy,
        "idle_share": (1 - busy / wall_ms) if busy else None,
        "families_ms": fam,
        "top": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3, "calls": e.count}
                for e in top],
    }
    print(f"profile: step wall {wall_ms:.1f} ms, device {busy:.1f} ms, families "
          + json.dumps({k: round(v, 2) for k, v in fam.items()}), flush=True)
    for t in out["top"]:
        print(f"profile:   {t['ms']:9.3f} ms {t['calls']:5d}x {t['name']}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5, help="llama-1b training steps")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from tpu_engine_torch.ops import _flash_cuda as fc

    card = _card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    res: dict = {"card": card, "failed": []}

    def run(name, fn, *a):
        t0 = time.perf_counter()
        try:
            fn(*a)
        except Exception:  # every phase runs; any failure fails the script
            traceback.print_exc()
            res["failed"].append(name)
        res.setdefault("phase_s", {})[name] = time.perf_counter() - t0

    def build():
        lib = fc.build()
        log = Path(str(lib) + ".log").read_text()
        res["build"] = {"library": str(lib.relative_to(ROOT))}
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error")):
                print(f"ptxas: {line.strip()}", flush=True)
        fc._load()

    run("build", build)
    if "build" not in res["failed"]:
        run("kernels", phase_kernels, res)
        run("model", phase_model, res)
        run("head", phase_head, res)
        run("train", phase_train, res, args.steps)
    for kr in res.get("kernels", []):
        kr["launches"] = res.get("train", {}).get("launches", {}).get(kr["name"])
    print(f"phases: {json.dumps(res.get('phase_s', {}))}", flush=True)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(res, indent=1))
    if res["failed"] or "kernels" not in res:
        print(f"chip_smoke: failed phases {res['failed']}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": res["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
