"""Run the flash-attention kernels under NVIDIA's ``compute-sanitizer`` on one
card: ``memcheck`` (out-of-bounds and misaligned device accesses) over the
ring's kernel cases, one ``train_ring`` step and the K1-K3 cases at D 128 and
D 256, and ``racecheck`` (shared-memory hazards) over the K2/K3 cases.

    python3 kernel_memcheck.py

It looks for the tool at ``$CUDA_HOME/bin/compute-sanitizer`` (default
``/usr/local/cuda``) and on ``PATH``. Without it, it says so and exits 0.
Otherwise it builds the kernels once in this process, then runs each
(tool, case) as ``compute-sanitizer --tool T python3 kernel_memcheck.py --case
C`` (the tool checks only the kernels whose names hold ``flash``; the
library's GEMMs and elementwise kernels run unchecked), and prints each run's
error summary. Each run's whole output is in ``chiprun_out/memcheck_<tool>_<case>.log``
and the summary in ``chiprun_out/kernel_memcheck.json``. A run that reports
an error, or that the tool could not start, exits 1 at the end.

The cases, all in bf16:

- ``ring``: ``ring_mha`` over 4 ranks in one process at S 8192, 16 query
  heads of 128 (16 and 4 kv heads), forward and backward: each rank's
  diagonal hop causal (K1-K3) and its past hops non-causal;
- ``train_ring``: one step of ``chip_smoke.py``'s ``train_ring`` at 2 of
  llama-1b's 16 layers (seq 8192 over the same ring, micro-batch 1);
- ``k123_d128`` / ``k123_d256``: K1, then K2 and K3 (``flash_fwd``,
  ``flash_bwd``) on [B·H, S, D] = [16, 2048, 128] and [8, 2048, 256],
  causal and non-causal.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RUNS = (("memcheck", "ring"), ("memcheck", "train_ring"), ("memcheck", "k123_d128"),
        ("memcheck", "k123_d256"), ("racecheck", "k123_d128"), ("racecheck", "k123_d256"))
CASE_TIMEOUT_S = 300


def _sanitizer() -> str | None:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "compute-sanitizer")
    return path if os.path.exists(path) else shutil.which("compute-sanitizer")


def _attention_case(d: int, heads: int) -> None:
    import torch

    from tpu_engine_torch.ops import _flash_cuda as fc

    g = torch.Generator(device="cuda").manual_seed(d)
    for causal in (True, False):
        q, k, v, do = (torch.randn((heads, 2048, d), generator=g, device="cuda").bfloat16()
                       for _ in range(4))
        o, lse = fc.flash_fwd(q, k, v, causal=causal)
        fc.flash_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()


def _ring_case() -> None:
    import torch

    from tpu_engine_torch.parallel.ring_attention import ring_mha

    g = torch.Generator(device="cuda").manual_seed(5)
    for kv_heads in (16, 4):
        q, do = (torch.randn((1, 8192, 16, 128), generator=g, device="cuda").bfloat16()
                 for _ in range(2))
        k, v = (torch.randn((1, 8192, kv_heads, 128), generator=g, device="cuda").bfloat16()
                for _ in range(2))
        xs = [t.requires_grad_(True) for t in (q, k, v)]
        torch.autograd.grad(ring_mha(*xs, 4), xs, do)
    torch.cuda.synchronize()


def _train_ring_case() -> None:
    import torch

    from tpu_engine_torch.models.config import MODEL_CONFIGS
    from tpu_engine_torch.train import TrainConfig, build_train_program

    cfg = TrainConfig(model_name="llama-1b", micro_batch_size=1, seq_len=8192, sequence=4,
                      precision="bf16", param_dtype="fp32", activation_checkpointing=True,
                      learning_rate=3e-5, warmup_steps=1, lr_schedule="constant")
    prog = build_train_program(cfg, MODEL_CONFIGS["llama-1b"].with_(n_layers=2), device="cuda")
    state = prog.init()
    state, m = prog.step(state, prog.synthetic_batch(0))
    print(f"train_ring step: loss {float(m['loss']):.4f}", flush=True)
    torch.cuda.synchronize()


def _run(cmd: list) -> tuple:
    try:
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=CASE_TIMEOUT_S, cwd=ROOT)
        return run.returncode, run.stdout + run.stderr
    except subprocess.TimeoutExpired as e:
        out = (e.stdout or b"") + (e.stderr or b"")
        return "timeout", out.decode(errors="replace") if isinstance(out, bytes) else str(out)


CASES = {"ring": _ring_case, "train_ring": _train_ring_case,
         "k123_d128": lambda: _attention_case(128, 16),
         "k123_d256": lambda: _attention_case(256, 8)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=sorted(CASES), help="run one case (under the tool)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("kernel_memcheck: no CUDA device", file=sys.stderr)
        return 2
    from tpu_engine_torch.ops import _flash_cuda as fc

    if args.case:
        fc.build()
        CASES[args.case]()
        print(f"case {args.case}: done, launches {dict(fc.launches)}", flush=True)
        return 0

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    tool = _sanitizer()
    report: dict = {"sanitizer": tool, "runs": []}
    print(f"compute-sanitizer: {tool or 'absent'}", flush=True)
    failed = False
    if tool is not None:
        ver = subprocess.run([tool, "--version"], capture_output=True, text=True, timeout=60)
        report["version"] = (ver.stdout + ver.stderr).strip()
        print(report["version"], flush=True)
        t0 = time.perf_counter()
        fc.build()  # once here: each case then loads the built library
        report["build_s"] = time.perf_counter() - t0
        # The kernel filter's spelling differs between releases; the first
        # that the tool takes is kept (none: every kernel is checked).
        filters = [["--kernel-name", "kns=flash"], ["--kernel-regex", "kns=flash"], []]
        for name, case in RUNS:
            t0 = time.perf_counter()
            while True:
                cmd = [tool, "--tool", name, *filters[0], "--print-limit", "50",
                       "--error-exitcode", "99", sys.executable, str(Path(__file__).resolve()),
                       "--case", case]
                rc, text = _run(cmd)
                if len(filters) > 1 and filters[0] and "case " not in text and (
                        filters[0][0] in text or "nrecognized" in text or "nknown" in text):
                    filters.pop(0)
                    continue
                break
            seconds = time.perf_counter() - t0
            (out_dir / f"memcheck_{name}_{case}.log").write_text(text)
            summary = re.findall(r"(?:ERROR|RACECHECK) SUMMARY:.*", text)
            done = f"case {case}: done" in text
            row = {"tool": name, "case": case, "rc": rc, "seconds": round(seconds, 1),
                   "filter": filters[0], "summary": summary, "case_done": done,
                   "tail": text[-1500:]}
            report["runs"].append(row)
            print(f"{name} {case}: rc {rc}, {seconds:.1f} s, case done {done}, "
                  f"{summary or 'no summary line'}", flush=True)
            if rc != 0 or not done or not summary or any(
                    not re.search(r"\b0 (errors|hazards)", s) for s in summary):
                failed = True
                print(text[-3000:], flush=True)
    (out_dir / "kernel_memcheck.json").write_text(json.dumps(report, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
