"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --steps 5  # more training steps (3, the least, by default)

(``--mesh-worker JOB RANK`` runs one rank of ``train_mesh``, ``train_pipe``,
``train_comm`` or ``serve_mesh``; the phase starts those processes itself.)

Phases, each of which must pass (the script exits non-zero otherwise).
The serving phases that launch no kernel of the port (``serve_mesh``,
``generate``, ``hf_bridge``, ``generate_gemma``) run first, on the card,
while nvcc compiles the kernels (and cuobjdump reads their SASS) on a
thread; the build phase then waits for it, and the script fails if one
of them loaded the kernels:

1. build: compile the flash-attention kernels (K1 forward, K2 dQ, K3 dK/dV,
   each causal and non-causal, head dims 16/32/64/128/256) from
   ``tpu_engine_torch/csrc`` with nvcc for sm_90a, one compiler per source,
   all at once; check that the Hopper kernels (``flash_fwd_sm90``: K1 in
   bf16 at every head dim; ``flash_bwd_dkv_sm90``: K3 at D 16, 32, 64 and
   128; ``flash_bwd_dq_sm90``: K2 at D 16, 32, 64 and 128; ``flash_bwd_dq_d256_sm90``,
   ``flash_bwd_dkv_d256_sm90``: K2 and K3 at D 256) are built from wgmma and
   TMA loads (``HGMMA``, ``UTMALDG`` in their SASS), spill nothing, and keep
   ``setmaxnreg`` (no ptxas C7508 warning); that the fp32 K1, K2 and K3
   (``flash_f32_tc.cu``, split TF32, every head dim, causal and not) are
   built from TF32 ``mma.sync`` (``F32_TC_HMMA`` in their SASS, and no other
   HMMA) and spill nothing;
2. kernels: hold each kernel to its plain PyTorch version at the training
   shape (B·H 4·16, S 2048, D 128, bf16), the non-causal kernels at the
   ring shard's shape (B·H 16, S 2048, D 128), on small fp32 cases with
   TF32 off, on sliding-window cases and at D 16, 32 and 64; at D 256
   in bf16 at gemma-2b's training shape (B·H 4·8, S 2048), causal and
   non-causal, and on window and fp32 cases; hold K1 alone, and K2 and K3 alone, on
   the edges of the Hopper kernels' tiles (ragged S, window edges, B·H 1 and
   256) at D 16, 32, 64, 128 and 256, K2 and K3 also to bitwise-equal
   results when run twice; show that an unbuilt head dim (80) raises; hold ``FlashAttentionLSE``'s backward under random (dO,
   dlse) to autograd through the plain forward; time each kernel beside its
   plain version, its bound and a library yardstick
   (``scaled_dot_product_attention`` for K1, the flash-attention backward
   op for K2 + K3; timed only, never called by the port), the causal
   kernels also at the ring shard, and the D 256 kernels at gemma-2b's
   shape; hold and time the kernels the bf16 paths do not launch
   (``OFF_PATH``: fp32 K1-K3 causal at D 128 and 256 and non-causal at the
   ring shard, bf16 at D 16, 32 and 64), fp32 K2 and K3 also to bitwise-equal
   results when run twice, fp32 bounds at the split-TF32 rate and at the FMA
   rate, and the K2 + K3 pair beside the library's backward
   (memory-efficient in fp32, flash in bf16); every bound is the longest of
   the tensor-core operations, the exps (one per visible pair, PEAK_EXP2)
   and the bytes;
3. model: a small llama, gpt2-124m, and qwen3-4b and gemma-2b at full width
   and 2 layers, through the flash kernels against the plain attention
   path, in fp32 and in bf16 compute (gemma-2b's fp32 flash pass, forward
   and backward, is the path whose launches the fp32 D 256 rows read);
   head: the LM head's backward against fp32 products;
4. train: a llama-1b training step at full width (seq 2048, bf16 compute,
   fp32 masters, AdamW, activation checkpointing, attention "auto"), with the
   kernel launch counts read around the run; then train_data: the same
   llama-1b at DATA_L of its layers trained from a token file of seeded ids
   through ``make_data_fn``
   (the native reader), an asynchronous checkpoint of step 2, and a fresh
   program restored from it whose step 3 is bitwise the uninterrupted one
   (save and restore GB/s, the reader's host tokens/s);
5. ring: ``ring_mha`` over 4 ranks against ``flash_mha`` at S 8192 (and a
   GQA case), output and gradients, and both timed;
6. train_ring: llama-1b at full width and depth with ring attention
   (seq 8192, sequence 4, micro-batch 1), with the launch counts of every
   kernel checked exactly; then the same steps with flash attention, to
   which the ring's losses, gradient norm and (in fp32 compute) initial
   gradients are held;
7. train_fp32: ``train_ring``'s llama-1b ring in fp32 compute
   (``TrainConfig(precision="fp32")``, TF32 off): every attention call on
   the fp32 kernels, the split-TF32 K1 and K3 causal and non-causal, with
   the launch counts checked exactly; train_tiny: qwen-tiny (D 32 heads)
   and gpt-tiny (D 16 heads) in bf16, the bf16 D 32 and D 16 kernels, launch
   counts checked exactly;
8. train_gemma: gemma-2b at full width and depth (seq 2048 × 4, bf16
   compute, fp32 masters, AdamW, checkpointing, flash attention through the
   D 256 kernels, loss chunks of 256 over the 256000-token vocabulary),
   with the launch counts checked exactly and the first loss held to the
   plain attention path's on the same weights and batch;
9. generate: llama-1b inference (seed-0 weights cast once to bf16):
   ``generate`` at batch 4, prompt 512, 128 new tokens, greedy, its cached
   logits held to the port's forward (bf16, and fp32 with TF32 off) and its
   streams teacher-forced through forward; ``speculative_generate`` at
   batch 1 with a 2-layer draft, its rounds reported;
10. generate_gemma: the same for gemma-2b at batch 4, prompt 512, 64 new
   tokens (no speculative run);
11. serve: ``ContinuousBatcher`` (8 slots of 2048 lanes, prefill chunk 256,
   8 tokens a dispatch, prefix cache of 1024 tokens) on a ``serve_forever``
   thread, 16 requests (prompts 32-1536, four sharing a 512-token prefix,
   four sampled), with the bf16 pool, the int8 pool and the bf16 pool again:
   every request done, no slot left busy, streams teacher-forced, prefix
   hits, the int8 pool's logits against the bf16 pool's, the repeat's tokens
   identical; TTFT, decode tokens/s, one decode dispatch timed and profiled.
   The serving path runs no kernel of the port: its attention is plain
   batched products over the cache, as in JAX;
12. serve_spec: the same batcher with a draft model (``spec_gamma`` 4, no
   prefix cache), serving ``serve``'s 16 prompts, all greedy, with the
   2-layer draft of ``generate`` and with llama-1b as its own draft: every
   request done and no slot left busy in either pool, streams
   teacher-forced, the own draft's mean accepted tokens per round at least
   SPEC_ACCEPT_MIN, and both pools on the accepted frontier after each of
   8 rounds driven directly; rounds, acceptance, TTFT and decode tokens/s
   beside the plain batcher's;
13. hf_bridge: llama-1b's bf16 weights through ``to_hf_llama`` and
   ``from_hf_llama`` on the card, bitwise equal, and forward's logits on a
   512-token prompt bitwise equal before and after;
14. train_moe: moe-8x7b (Mixtral-8x7B) at full width and 2 layers, seq 2048
   x 2, dense dispatch, bf16 compute, fp32 masters, AdamW, checkpointing,
   flash (the bf16 D 128 kernels): the loss falls, the aux loss is finite
   and positive at every step, K1/K2/K3 exactly 4/2/2 a step; then dense
   against ragged dispatch where nothing drops (capacity factor 4), in
   fp32 and bf16 compute, and one ragged step;
15. serve_moe: moe-8x7b at full width and SERVE_MOE_L of its 32 layers in
   weight-only int8, built on the card a layer at a time, served by the ``ContinuousBatcher`` (8
   slots of 2048 lanes, bf16 pool, 16 greedy requests, prompts 128-512, 64
   tokens each): the streams teacher-forced through forward with ragged
   dispatch and flash attention, the median gap within SERVE_MOE_TAU, and
   a shorter run in fp32 compute held by SERVE_MOE_FP32; K1 launched once a
   layer per teacher forward; weight bytes, peak memory, TTFT, decode
   tokens/s, one dispatch timed and profiled;
16. train_int8: ``train``'s llama-1b with the attention and MLP products
   in int8 (``quant_training="int8"``, ``torch._int_mm``): launch counts
   exact (``_int_mm`` 4 times per targeted product a microbatch, no bf16
   GEMM left on a targeted projection), held against the bf16 path (logits,
   first loss, each group's gradient cosine), the backward's stochastic
   rounding held unbiased, every einsum spec at sizes the card's int8 GEMM
   refuses unpadded; then one step of ``train_moe``'s moe-8x7b with the
   expert products in int8 too;
17. train_lora: llama-7b at full width and depth, frozen fp32 base, LoRA
   rank 16 on q/k/v/o, seq 2048 x 2: step 0's loss bitwise the base
   forward's, the loss falls, the base unchanged, adapter-sized optimizer
   state, ``merged_params``' logits against the adapter forward's;
18. train_opt: ``train``'s llama-1b with Adafactor, then Lion: the loss
   falls, optimizer-state bytes against AdamW's, the update timed alone;
19. remat: ``train``'s llama-1b for 3 steps under each remat policy:
   losses and gradient norms bitwise nothing_saveable's, exact launch
   counts, step time, peak memory and the bytes a forward keeps;
   ``offload_dots`` (the products' outputs in pinned host blocks of their
   exact size) with every initial gradient bitwise nothing_saveable's and
   fewer device bytes kept than dots_saveable's; the blocks unpinned after;
20. train_offload: ``train``'s llama-1b at 2 of its 16 layers for 3 steps
   in memory, with the optimizer state, the masters or both in pinned host
   memory (losses and parameters bitwise the in-memory run's), with bf16
   masters, and with the disk tier, serial (a spill under a temporary directory; the overlapped
   walk, ``disk_update_overlap``, is read by train_faults.py); step time,
   peak device and pinned bytes, bytes over the bus, its rate and the
   device-busy share of each;
21. train_7b: llama-7b at full width and depth, full gradients, seq 2048
   x 1, 3 steps in each configuration that fits the host (fp32 masters with
   the optimizer state on the host, or its first moments in bf16; both on
   the host; bf16 masters and bf16 first moments in memory), after the
   host's memory and each configuration's reckoned bytes;
22. train_window: ``train`` with ``sliding_window=1024``: every K1-K3
   launch windowed, the first loss held to the plain windowed path's;
23. train_mesh: llama-1b at full width and 2 of its 16 layers on a mesh
   through NCCL, 3 steps a run: at world 1 in this process, the mesh
   program at stage 3 bitwise the no-mesh program (seq 2048 × 4), and at
   seq 8192 × 1 (2 layers); then two ranks, a process each on the one card
   (``--mesh-worker``; each its own ``NCCL_HOSTID``): fsdp=2 at stage 3
   (seq 2048 × 2 a rank), a ring and Ulysses over sequence=2 (seq 8192 ×
   1, 2 layers), tensor parallelism at model=2 (``tp2``: 8 heads, 2752 MLP
   columns, 16000 vocabulary rows a
   rank, seq 2048 × 4), and ``train_moe``'s moe-8x7b at model=2 (``ep2``:
   4 experts a rank, seq 2048 × 2, held to its own world-1 run
   ``w1_moe``), LoRA on q/k/v/o and the MLP at model=2 (``lora_tp2``, 2
   layers, held to ``w1_lora``) and Adafactor at model=2 (``adafactor_tp2``,
   2 layers, held to ``w1_ada``), each held to the world-1 run at the same
   global batch by MESH_LOSS_REL (ep2: MESH_EP_LOSS_REL; train_faults.py),
   the ranks' losses and norms equal, launch counts exact per rank; step
   time, peak memory and the bytes each collective moved a step, per rank;
24. train_pipe: llama-1b at full width and 2 of its 16 layers on pipe=2
   (1 layer a rank, two ``--mesh-worker`` processes), seq 2048 × 1 × 4 microbatches,
   3 steps under each of gpipe, 1f1b and zb, held to the world-1 program
   at the same global batch by MESH_LOSS_REL, the ranks' losses and norms
   equal, K1-K3 launches exact per rank and schedule; step time, peak
   memory and bytes sent a step per rank, beside JAX's F-units of the
   schedule;
   then train_comm: llama-1b at full width and 2 layers on two ranks:
   fsdp=2 stage 3 with qwZ+hpZ against uncompressed, two slices of data=2
   with qgZ against fp32, data=2 with a bf16 gradient reduction against
   fp32, and (a)'s checkpoint restored at world 1 by ``restore_resharded``;
   held by train_faults.py's COMM_* bounds (loss gaps, the int8 gather's
   and the cross-slice byte ratios, hpZ's store, the ranks' weights);
   then train_mesh_state: llama-1b at full width and 2 layers on two
   ranks: fsdp=2 stage 3 with masters and moments in pinned host memory,
   fsdp=2 stage 3 with the disk tier, data=2 and model=2 with int8
   products (``tp2_int8``: o's and down's scales over both ranks, held in
   one more step to the whole operand's, all-gathered, bitwise),
   moe-8x7b at 1 layer over sequence=2 (dense dispatch, capacity factor
   0.5), and pipe=2 with a save, a bitwise restore on the ranks and a
   whole read at world 1; each held to its world-1 run by train_faults.py's
   STATE_LOSS_REL or STATE_INT8_LOSS_REL, launches exact per rank; step
   time, peak and pinned memory, host copies and collective bytes a step
   per rank;
   then train_job: the port's supervised ``TrainingJob`` at llama-1b's
   width and 2 layers (seq 2048 × 4, bf16 compute, fp32 masters, AdamW,
   flash), three jobs on one checkpoint directory under ``chiprun_out/``:
   (a) checkpoints every 4 steps and a NaN loss planted on step 6: one
   rollback to step 4 at lr_scale 0.5, COMPLETED at step 8, its losses
   bitwise a plain loop's before the NaN and a plain loop's restored from
   step 4 at lr_scale 0.5 after it, K1-K3 launches exact; while it runs
   a two-step ``TraceSession`` naming K1-K3, the profiler's MFU and the
   HBM estimate's terms beside the state's bytes (params and optimizer
   state within 0.1 %); (b) resumed there, without periodic checkpoints,
   read while its steps run: the fleet (one card, the job attributed to
   it, HBM total within 1 % of nvidia-smi's, a utilization above 0 and
   the health JAX's thresholds give that reading, no alert but the duty
   cycle's) and the nvidia-smi snapshot; then preempted through the
   simulated check, with an emergency save; (c) resumed at (b)'s step,
   COMPLETED, its compile recorded in the compile index;
   then train_fleet: the fleet's scheduling half as a user drives it: (a)
   ``python -m tpu_engine_torch.launcher --preset 1b --dry-run`` in a
   subprocess, exit 0 and a plan; (b) ``TPULauncher().launch`` of the 1b
   preset at fsdp=1 (llama-1b at 16 layers, 3 steps of 4 × 4 × 2048, train's
   learning rate on one repeated batch): COMPLETED, finite losses falling
   after step 0, K1 twice a layer a microbatch, K2 and K3 once (the path of
   the ``kernels`` line); (c) a ``FleetScheduler`` over the card's live
   fleet (``TPUManager().get_fleet_status``), one job at a time: job L
   (llama-1b's width at 2 layers, 2048 × 4, LOW, 8 steps, saving only when
   preempted and at its end) and, after its step 3, job H (HIGH, 4 steps):
   L preempted (one emergency save), H COMPLETED, L requeued, resumed from
   its emergency step and COMPLETED at 8, its losses after the resume
   bitwise a plain loop restored from that step; counters 1/1/2; both on
   the card's flash kernels; the goodput categories of each summing to its
   wall within 1 %, L's preempt drain, restore and queue wait above 0; the
   planner's gang of 1 on the one card (its predicted step beside the
   measured one, not gated); a llama-70b submission at fsdp=1 held by the
   HBM gate, then cancelled;
   then serve_fleet: the serving fleet over one ``FleetScheduler`` on the
   card's live fleet, llama-1b at full width and depth in bf16 (seed-0
   weights drawn by ``build_replica_engine`` on each replica's thread): (a)
   a ``ServingFleet`` of serve's batcher settings (8 slots x 2048 lanes,
   prefill chunk 256, a 1024-token prefix cache) and an armed
   ``FleetAutopilot``: 8 of serve's requests (32 tokens each) on one
   replica, the autopilot's ``rescale_serving`` firing on the 100 ms p99
   SLO's burn and the fleet at 2 replicas, 8 more; every request done, the
   shared-prefix ones routed by affinity to the replica holding the
   prefix, greedy streams teacher-forced within SERVE_TAU beside one plain
   ``ContinuousBatcher``'s; (b) a ``DisaggServingFleet`` (one prefill, one
   decode replica) serving 8 prompts with the fp32 wire and with the int8
   wire into a ``kv_quant`` pool: each request's trace shows every phase,
   its handoff's wire bytes the [L, T, KV, HD] arithmetic, streams within
   SERVE_TAU; two held requests moved by ``reshard.migrate_held_requests``
   and a prefix exported, parked in a ``HostKVTier`` and installed by
   ``rehydrate_from_host``, its first logits within SERVE_REL of a cold
   server's; (d) two ``SpecServingFleet``s under one
   ``SpecSpillController``, llama-1b as its own draft and the 2-layer
   draft, 8 requests each: the verify pool's own streams, the own draft's
   acceptance EMA above the floor, the 2-layer draft spilled by an audited
   ``DecisionRecord`` and canary probes after; (c) an interactive replica
   (NORMAL) and a batch replica of 106 x 4096 lanes (LOW) whose
   reservations leave less headroom than a CRITICAL job's estimate: the
   job (train_fleet's L shape, 3 steps, K1/K2/K3 counted: the
   ``serve_fleet`` column) is admitted only after the scheduler evicts the
   batch replica with 8 requests in flight, checkpoint-free; the replica
   queued while the job runs, readmitted after it, every request done,
   counters 1/1/1;
25. serve_mesh: the ContinuousBatcher at llama-1b's width and 2 layers on
   model=2 (two ranks, ``--mesh-worker`` processes, rank 0 submitting
   ``serve``'s 16 requests), with the bf16 and the int8 pool, and with the
   weights' int8 tree and the bf16 pool: every request done, the ranks'
   streams equal, greedy streams teacher-forced through the one-rank forward
   of the same tree within SERVE_TAU, prefix hits, each tree's
   teacher-forced decode logits on the ranks against the one-rank pool's
   within SERVE_TP_REL (serve_faults.py); TTFT, decode tokens/s and peak
   memory per rank.

Output: the card's name and power limit, the phases' numbers, one JSON line
of per-kernel results (``launches`` per training step, summed over
``D128_PATHS`` for the bf16 D 128 kernels, K1's
adding its launches per teacher forward of ``serve_moe``, from
``train_gemma`` for the bf16 D 256 ones, and over each ``OFF_PATH`` row's
paths for the others; ``launches_by_path`` per step of each; every row must
have launched), and
as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Everything is also written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

from tpu_engine_torch.profiler import PEAK_FLOPS_BF16

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = PEAK_FLOPS_BF16["h100"]   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12    # H100 SXM float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 (tensor cores)
# An fp32-accurate product on the tensor cores is three TF32 products (split
# TF32, csrc/tf32_split.cuh): the least time any fp32 kernel could take.
PEAK_SPLIT_TF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# The exp unit (MUFU): 16 exp2 results a clock per SM at compute capability
# 9.0 (CUDA C Programming Guide, arithmetic instruction throughput), on 132
# SMs at the 1.83 GHz behind PEAK_BF16_FLOPS (989e12 / (132 SMs x 4096 FLOP
# a clock)): 3.87e12 exp2 a second. Each of K1, K2 and K3 takes one exp per
# visible (q, k) pair, which bounds them below D 64, where the products per
# pair are few.
PEAK_EXP2 = 132 * 16 * 1.83e9

# Tolerances: kernel against its plain version on the same inputs. Each
# output is held elementwise (atol/rtol) and, since the elementwise bf16
# limits are as large as a typical attention output, also by its relative
# norm error ||got - want|| / ||want||. A dropped tile or a wrong row scale
# moves that by far more than bf16 rounding does: on an H100, rounding gives
# at most 2.8e-3 at the training shape, and dQ with its later half of rows
# scaled by 0.97 gives 1.2e-2, which the elementwise limits let pass. At
# D 256 the same holds (kernel_faults.py: readings in PERF.md). lse is fp32
# in every kernel, so it is held to fp32 limits whatever the dtype.
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
# bf16 flash may be at most this much further than bf16 plain from the fp32
# plain result (relative norm error of logits and dWq).
MODEL_BF16_RATIO = 1.5
HEAD_REL = 1e-4


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _time_ms(fn, iters: int = 10, warmup: int = 2, queue: bool = False) -> float:
    """Mean time of ``fn`` over ``iters`` calls, by CUDA events. With
    ``queue``, the calls are enqueued behind a spin of about 0.05 s on the
    card, so the events time the device's work alone and not the host's
    launch gaps (kernel times); without it, host time between launches
    counts too (times of host-bound work)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queue:
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, **kw) -> float:
    """Device time of ``fn``: :func:`_time_ms` with its calls queued."""
    return _time_ms(fn, queue=True, **kw)


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


def check_case(fc, bh, s, d, dtype, window, seed, causal=True) -> dict:
    """Run K1, K2 and K3 and their plain versions on one case; raise if any
    result is outside its limits. Returns max |err| per output."""
    import torch

    q, k, v, do = _inputs(bh, s, d, dtype, seed)
    kind = "bf16" if dtype == torch.bfloat16 else "fp32"
    o, lse = fc.flash_fwd(q, k, v, window, causal)
    delta = fc.flash_delta(o, do)
    dq = fc.flash_bwd_dq(q, k, v, do, lse, delta, window, causal)
    dk, dv = fc.flash_bwd_dkv(q, k, v, do, lse, delta, window, causal)
    torch.cuda.synchronize()
    po, plse = fc.flash_fwd_plain(q, k, v, window, causal)
    pdq, pdk, pdv = fc.flash_bwd_plain(q, k, v, po, plse, do, window, causal)
    label = f"bh{bh} s{s} d{d} {kind} w{window} {'causal' if causal else 'full'}"
    out, grad, rel = TOL[f"{kind}_out"], TOL[f"{kind}_grad"], REL[kind]
    checks = {"o": (o, po, out, rel), "lse": (lse, plse, TOL["fp32_out"], REL["fp32"]),
              "dq": (dq, pdq, grad, rel), "dk": (dk, pdk, grad, rel), "dv": (dv, pdv, grad, rel)}
    errs = {n: _close(f"{label} {n}", *c) for n, c in checks.items()}
    print(f"kernels {label}: " + " ".join(f"{n}={e:.3e} (rel {r:.2e})"
                                          for n, (e, r) in errs.items()), flush=True)
    return {n: e for n, (e, _) in errs.items()}


def kernel_bounds(bh, s, d, window, elem_bytes, causal=True, peak=PEAK_BF16_FLOPS) -> dict:
    """Least time on the card for each kernel's work at this shape, the
    largest of three: FLOPs of the visible (q, k) pairs over ``peak`` (the
    bf16 tensor-core peak by default), one exp per visible pair over
    PEAK_EXP2, or bytes (each input read once, each output written once)
    over HBM bandwidth. ``bound_by`` names the one that binds."""
    if causal:
        pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s))
    else:
        pairs = s * s
    work = {  # (products of pairs·D, tensors of [BH,S,D] moved, row vectors moved)
        "flash_fwd": (2, 4, 1),      # q,k,v → o; lse
        "flash_bwd_dq": (3, 5, 2),   # q,k,v,dO → dq; lse, Δ
        "flash_bwd_dkv": (4, 6, 2),  # q,k,v,dO → dk,dv; lse, Δ
    }
    out = {}
    for name, (products, tensors, rows) in work.items():
        flops = 2.0 * products * bh * pairs * d
        exps = float(bh * pairs)
        nbytes = tensors * bh * s * d * elem_bytes + rows * bh * s * 4
        times = {"operations": flops / peak, "exp": exps / PEAK_EXP2, "bytes": nbytes / PEAK_BYTES}
        by = max(times, key=times.get)
        out[name] = {"flops": flops, "exps": exps, "bytes": nbytes,
                     "bound_ms": times[by] * 1e3, "bound_by": by}
    return out


# The TPU kernel each CUDA kernel replaces. The causal form is listed under
# the kernel's name and the non-causal one under ``<name>_full``, as in
# ``_flash_cuda.launches``; both replace the same Pallas function.
REPLACES = {
    "flash_fwd": "tpu_engine/ops/_flash_pallas.py:117",
    "flash_bwd_dq": "tpu_engine/ops/_flash_pallas.py:306",
    "flash_bwd_dkv": "tpu_engine/ops/_flash_pallas.py:341",
}
# The source of each kernel at the timed shapes: bf16 at D 128 and at D 256
# (rows named ``<kernel>_d256``), all Hopper kernels.
SOURCE = {
    "flash_fwd": "tpu_engine_torch/csrc/flash_fwd_sm90.cu",
    "flash_bwd_dq": "tpu_engine_torch/csrc/flash_bwd_sm90.cu",
    "flash_bwd_dkv": "tpu_engine_torch/csrc/flash_bwd_sm90.cu",
}
SOURCE_D256 = {
    "flash_fwd": "tpu_engine_torch/csrc/flash_fwd_sm90.cu",
    "flash_bwd_dq": "tpu_engine_torch/csrc/flash_bwd_dq_d256_sm90.cu",
    "flash_bwd_dkv": "tpu_engine_torch/csrc/flash_bwd_dkv_d256_sm90.cu",
}
GEMMA_SHAPE = (4, 8, 2048, 256)  # gemma-2b's attention in train_gemma: B, H, S, D
# The kernels the bf16 training paths (train, train_ring, train_gemma) do not
# launch: fp32 K1-K3 (TrainConfig(precision="fp32") and every fp32 check),
# bf16 at D 32 and 16 (the tiny configs' heads) and bf16 at D 64 (gpt-125m's
# and gpt2-124m's heads). (row suffix, B·H, D, dtype, causal, the paths
# whose launches the row reads), timed at S 2048: causal at train's B·H for
# D 128, 32 and 16, at train_gemma's for D 256 and at bench_torch.py's
# gpt-125m micro-batch 16 (16 × 12 heads) for D 64, non-causal at the ring
# shard's.
OFF_PATH = (("fp32_d128", 64, 128, "fp32", True, ("train_fp32",)),
            ("fp32_d256", 32, 256, "fp32", True, ("model_fp32_gemma",)),
            ("fp32_d128_full", 16, 128, "fp32", False, ("train_fp32",)),
            ("bf16_d32", 64, 32, "bf16", True, ("train_tiny",)),
            ("bf16_d16", 64, 16, "bf16", True, ("train_tiny_d16",)),
            ("bf16_d64", 192, 64, "bf16", True, ("model_bf16_gpt2",)))
# The source of each OFF_PATH kernel, by dtype: fp32 K1-K3 are the
# split-TF32 kernels; bf16 at D 16 and 32 the Hopper K1, K2 and K3, and bf16
# at D 64 the Hopper kernels of D 128 (``SOURCE``).
SOURCE_OFF_PATH = {
    ("fp32", "flash_fwd"): "tpu_engine_torch/csrc/flash_f32_tc.cu",
    ("fp32", "flash_bwd_dq"): "tpu_engine_torch/csrc/flash_f32_tc.cu",
    ("fp32", "flash_bwd_dkv"): "tpu_engine_torch/csrc/flash_f32_tc.cu",
    ("bf16", "flash_fwd"): "tpu_engine_torch/csrc/flash_fwd_sm90.cu",
    ("bf16", "flash_bwd_dq"): "tpu_engine_torch/csrc/flash_bwd_sm90.cu",
    ("bf16", "flash_bwd_dkv"): "tpu_engine_torch/csrc/flash_bwd_sm90.cu",
}
# The split-TF32 kernels' symbol and its instantiations (K1, K2 and K3, head
# dims 16-256, causal and not), and the SASS of a TF32 mma.sync m16n8k8:
# every HMMA of those kernels must be one.
F32_TC_KERNELS = {"flash_fwd_f32_tc": 10, "flash_bwd_dq_f32_tc": 10, "flash_bwd_dkv_f32_tc": 10}
F32_TC_HMMA = "HMMA.1688.F32.TF32"
# The Hopper kernels' symbols and their instantiations (head dims x causal
# and not): K1 at D 16, 32, 64, 128 and 256; K2 and K3 at 16, 32, 64 and
# 128; K2 and K3 at 256.
SM90_KERNELS = {"flash_fwd_sm90": 10, "flash_bwd_dq_sm90": 8, "flash_bwd_dkv_sm90": 8,
                "flash_bwd_dq_d256_sm90": 2, "flash_bwd_dkv_d256_sm90": 2}
RING = 4          # ranks of the ring in the ring and train_ring phases
RING_SEQ = 8192   # sequence length of those phases (local shard 2048)
# The ring's training step against flash's at RING_SEQ, from the same
# weights and batch, with attention rounded to bf16 in two orders: the loss
# at the initial weights (step 0) and after one update (step 2), absolute;
# the gradient norm at the initial weights (step 1, where the step-0
# learning rate of 0 has left them), relative. Neither sees a fault in the
# ring's backward: on an H100, a backward that drops the lse cotangent moved
# the norm by 8e-5, and each parameter's bf16 gradient differs between ring
# and flash by 1e-2 to 3e-2 on the clean code, more than such a fault adds.
# So every parameter's gradient at the initial weights is also held to
# flash's in fp32 compute (TF32 off), by relative norm error: there the
# clean code agreed within 9e-6, and the same fault moved the Q and K
# projections' gradients by 2e-2 (halving the cotangent, by 1e-2). The
# attention itself is held to REL in the ring phase.
RING_LOSS_TOL = 5e-3
# train_gemma's first loss (step 0, initial weights) against the same
# weights and batch through the plain attention path: a coarse end-to-end
# check of the path (the kernels themselves are held by REL); both run the
# model in bf16 and differ in attention's rounding.
FIRST_LOSS_REL = 1e-2
RING_GRAD_NORM_REL = 1e-3
RING_PARAM_GRAD_REL = 1e-4
# Optimizer settings of both training phases: the learning rate is 0 at step
# 0 (warmup) and constant after. At a peak of 3e-4 the loss on the repeated
# batch rose again from the fourth step on; this rate keeps it falling.
TRAIN_LR = dict(learning_rate=3e-5, warmup_steps=1, lr_schedule="constant")

# Serving phases (generate, serve): llama-1b at full width and depth, seed-0
# random weights cast once to bf16. The cached path's logits (prefill, then
# one-token decode, teacher-forced) are held to the port's forward over the
# same tokens by relative norm error, in bf16 and in fp32 with TF32 off, and
# in bf16 also by max |error|. On an H100 (NVIDIA H100 80GB HBM3, 700 W) the
# first run measured 1.9e-2 and 4.6e-6, max |error| 0.11, and a prefix hit's
# first-token logits 2.1e-2 from forward: the bounds are about twice those.
# A greedy stream is held, teacher-forced through forward, to within
# SERVE_TAU of each position's largest logit: random weights leave top-2
# gaps below bf16's error, so the streams cannot be compared token by
# token. SERVE_TAU is about twice the largest gap of sound runs on the same
# card (0.090, the int8 pool's streams; bf16 pool 0.051, generate 0.033).
# Planted faults read 1.28 (the second-ranked token fed back) and 1.20
# (decode RoPE at position + 1; serve_faults.py).
SERVE_REL = {"bf16": 4e-2, "fp32": 2e-5}
SERVE_ABS = 0.25
SERVE_TAU = 0.2
# The int8 pool's logits against the full-precision pool's, as a share of
# max |logit|: JAX's bound, 2 %, taken in fp32 compute
# (tests/test_generate.py:360-372), held here in fp32 compute too. Sound
# readings on an H100: fp32 1.90e-2; bf16 3.25e-2, the size of bf16's own
# rounding through 16 layers (cached against forward: max |error| 0.11).
# Planted faults (serve_faults.py), fp32 / bf16: scales rounded to bf16
# 2.12e-2 / 3.25e-2 (bf16 compute rounds them anyway), scales x 127/128
# 3.22e-2 / 4.15e-2, dequantisation skipped 1.36 / 1.25. The bf16 bound
# lies midway between the sound reading and the scale fault's.
INT8_SHARE = {"fp32": 0.02, "bf16": 3.7e-2}
GEN = dict(batch=4, prompt=512, new=128)
SERVE_CFG = dict(max_slots=8, max_len=2048, prefill_chunk=256, prefill_pad_to=64,
                 chunk_steps=8, seed=0, prefix_cache_tokens=1024)
SERVE_SHARED = (2, 3, 10, 11)   # requests whose prompts share a 512-token prefix
SERVE_SAMPLED = (1, 6, 9, 14)   # requests at temperature 0.8; the rest are greedy
# serve_spec: SERVE_CFG's pool with a draft and no prefix cache (a
# speculative server refuses one; chunk_steps has no effect on it).
SPEC_CFG = dict(SERVE_CFG, prefix_cache_tokens=0, spec_gamma=4)
# The mean accepted tokens per round (of spec_gamma + 1) with llama-1b as its
# own draft, in bf16: the draft's one-token steps and the target's 5-token
# verify break near-ties differently, so a sound run accepts less than 5. On
# an H100 (NVIDIA H100 80GB HBM3, 700 W) the sound run read 4.932; planted
# faults (serve_faults.py) read 3.550 (the target's rewind keeping a rejected
# lane) and 1.146 (the draft one step short). The bound lies midway between
# the sound reading and the nearer fault's.
SPEC_ACCEPT_MIN = 4.2

# train_moe: Mixtral-8x7B (moe-8x7b) at full width with 2 of its 32 layers,
# seq 2048 x micro-batch 2, dense dispatch. Then dense against ragged
# dispatch at MOE_NO_DROP_CF, where each expert's capacity is the whole
# sequence and no token drops, so both compute one function: in fp32
# compute (TF32 off) the logits and every gradient are held to
# MODEL_REL["fp32"] (on an H100, NVIDIA H100 80GB HBM3 at 700 W: 4.5e-6 and
# at most 5.9e-6, no token rerouted). In bf16 the two round the combine
# differently (dense sums a token's two expert outputs in fp32, ragged adds
# them in bf16, as JAX's two paths do), which moves the second layer's
# router inputs and flips the experts of the tokens at a near-tie (30 of
# 4096 there): routing is discontinuous, a flipped token's logits move by
# tens of percent, and every gradient moves with them (4.6e-2 to 5.4e-2).
# So in bf16 only the logits of the tokens routed alike in every layer are
# held, to MODEL_REL["bf16"], the bound between two sound bf16 paths of a
# model (read 8.2e-3); the rerouted tokens and the gradients are reported.
MOE_TRAIN_LAYERS = 2
MOE_NO_DROP_CF = 4.0
# serve_moe: moe-8x7b at full width and SERVE_MOE_L of its 32 layers in
# weight-only int8 (built on the card, _moe_int8_tree; all 32 until PR 20
# cut it for the run's time limit, PERF.md §4), SERVE_CFG's pool without a
# prefix cache, 16 greedy requests (prompts 128-512, 64 tokens each). Each
# stream is teacher-forced through forward with ragged dispatch (exact
# top-k, as decode) and flash attention, giving each generated position's
# gap. Routing makes random layers chaotic in bf16: decode and forward
# round differently, experts flip at near-ties from the second layer on, a
# flipped token's later layers flip more, and attention spreads it (on an
# H100, 100 of 319 tokens rerouted in layer 16; 157 in layer 32 at full
# depth). So the largest gap of a sound bf16 run (6.7) nears the faults'
# (8.8-10.6); its median does not. The bf16 run is held by the median of
# its gaps to SERVE_MOE_TAU, and SERVE_MOE_FP32 holds a shorter run in fp32
# compute (TF32 off), where the two paths agree to ~1e-5 and experts rarely
# flip: the share of its positions within a gap of 0.1. Readings at 16
# layers on an H100 (NVIDIA H100 80GB HBM3, 700 W; serve_faults.py --moe):
# bf16 median 0.260 sound, 3.243 with the top-k gates not renormalised,
# 4.389 with the first expert alone, 4.862 with an expert kernel's scale
# left out; fp32 share 1.000 sound, at most 0.016 for a fault (at 32 layers:
# medians 1.35, 4.23, 4.69, 5.07, and SERVE_MOE_TAU 2.8). Each bound lies
# midway between the sound reading and the nearer fault's.
SERVE_MOE_L = 16
SERVE_MOE_CFG = dict(SERVE_CFG, prefix_cache_tokens=0)
SERVE_MOE_TAU = 1.75
SERVE_MOE_FP32 = dict(requests=8, tokens=16, gap=0.1, share=0.5)


def check_lse_backward(fc) -> dict:
    """``FlashAttentionLSE``'s backward under a random (dO, dlse) pair
    against autograd through the plain forward on the same inputs, causal
    and non-causal: at the ring shard's shape in bf16, and at a small fp32
    case. Returns max |err| per case and gradient."""
    import torch

    out = {}
    for bh, s, d, dtype in ((16, 2048, 128, torch.bfloat16), (4, 256, 64, torch.float32)):
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        for causal in (True, False):
            q, k, v, do = _inputs(bh, s, d, dtype, seed=3)
            dlse = torch.randn((bh, s), generator=torch.Generator(device="cuda").manual_seed(4),
                               device="cuda")
            xs = [t.requires_grad_(True) for t in (q.clone(), k.clone(), v.clone())]
            o, lse = fc.flash_fwd_lse(*xs, causal=causal)
            got = torch.autograd.grad((o, lse), xs, (do, dlse))
            ys = [t.requires_grad_(True) for t in (q.clone(), k.clone(), v.clone())]
            want = torch.autograd.grad(fc.flash_fwd_plain(*ys, causal=causal), ys, (do, dlse))
            label = f"lse bwd bh{bh} s{s} d{d} {kind} {'causal' if causal else 'full'}"
            errs = {n: _close(f"{label} {n}", a, b, TOL[f"{kind}_grad"], REL[kind])
                    for n, a, b in zip(("dq", "dk", "dv"), got, want)}
            print(f"kernels {label}: " + " ".join(f"{n}={e:.3e} (rel {r:.2e})"
                                                  for n, (e, r) in errs.items()), flush=True)
            out[label] = {n: e for n, (e, _) in errs.items()}
    return out


def check_sm90_sass(fc) -> dict:
    """Each Hopper kernel's instantiations (``SM90_KERNELS``: head dims x
    causal and not) must be built from wgmma (``HGMMA``) and TMA loads
    (``UTMALDG``): proof that bf16 K1, K2 and K3 at every head dim run the
    Hopper designs. Returns the count of each
    instruction per instantiation."""
    out = {}
    for symbol, want in SM90_KERNELS.items():
        found = fc.sass_op_counts(symbol, ("HGMMA", "UTMALDG"))
        print(f"sass {symbol}: {json.dumps(found)}", flush=True)
        if len(found) != want or not all(n["HGMMA"] and n["UTMALDG"] for n in found.values()):
            raise AssertionError(f"{symbol}: want {want} instantiations with HGMMA and UTMALDG, "
                                 f"found {found}")
        out.update(found)
    return out


def check_ptxas(fc, log: str) -> dict:
    """Registers and spilled bytes of every Hopper kernel, from the build's
    ``-Xptxas -v`` output. Raises if one spills or if ptxas ignored a
    ``setmaxnreg`` (warning C7508)."""
    out = {n: v for n, v in fc.ptxas_table(log).items() if any(k in n for k in SM90_KERNELS)}
    spills = {n: v for n, v in out.items() if v.get("spill_bytes")}
    if spills or "C7508" in log:
        raise AssertionError(f"Hopper kernels spill {spills} or ignore setmaxnreg (C7508: "
                             f"{'C7508' in log})")
    return out


def _instantiation(name: str):
    """(kernel, head dim, causal) of a mangled ``flash_*<D, kCausal>`` name,
    or None."""
    k = re.search(r"\d+(flash_\w+?)ILi(\d+)ELb([01])E", name)
    return (k[1], int(k[2]), k[3] == "1") if k else None


def check_ptxas_f32(fc, log: str) -> dict:
    """Registers and spilled bytes of the split-TF32 fp32 kernels K1, K2 and
    K3 (``F32_TC_KERNELS``, every head dim), from the build's ``-Xptxas -v``
    output, keyed ``<kernel><D, causal|full>``: each instantiation must be
    present and none may spill."""
    out = {}
    for inst, v in sorted((_instantiation(name), v) for name, v in fc.ptxas_table(log).items()
                          if _instantiation(name)):
        kernel, d, causal = inst
        if kernel not in F32_TC_KERNELS:
            continue
        label = f"{kernel}<{d}, {'causal' if causal else 'full'}>"
        out[label] = v
        print(f"ptxas fp32: {label}: {v.get('registers')} registers, "
              f"{v.get('spill_bytes')} bytes spilled (stores + loads)", flush=True)
    want = sum(F32_TC_KERNELS.values())
    spills = {n: v for n, v in out.items() if v.get("spill_bytes")}
    if len(out) != want or spills:
        raise AssertionError(f"split-TF32 kernels: want {want} instantiations and no spill, found "
                             f"{out}")
    return {"f32_tc": out}


def check_f32_sass(fc) -> dict:
    """Each split-TF32 kernel's instantiations (``F32_TC_KERNELS``) must
    multiply on the tensor cores in TF32: ``F32_TC_HMMA`` in their SASS,
    and no HMMA of another kind. Returns the counts per instantiation."""
    out = {}
    for symbol, want in F32_TC_KERNELS.items():
        found = fc.sass_op_counts(symbol, (F32_TC_HMMA, "HMMA"))
        print(f"sass {symbol}: {json.dumps(found)}", flush=True)
        if len(found) != want or not all(n[F32_TC_HMMA] and n[F32_TC_HMMA] == n["HMMA"]
                                         for n in found.values()):
            raise AssertionError(f"{symbol}: want {want} instantiations whose every HMMA is "
                                 f"{F32_TC_HMMA}, found {found}")
        out.update(found)
    return out


EDGE_DIMS = (16, 32, 64, 128, 256)  # head dims of check_fwd_edges and check_bwd_edges


def _edge_cases(dims=(64, 128)) -> list:
    """The edges of the Hopper kernels' tiles, bf16 at ``dims``: S 64, 192
    and 320, causal and not, which leave a ragged last 128-row tile (K1's Q
    tiles; at D 16 to 128 also K1's 128-key tiles, at D 64 and 128 K2's and
    K3's owned tiles, at D 16 and 32 a ragged 192-row owned tile of K2 and
    K3) and,
    at D 256, a ragged last 80-key tile of K1 at S 64 and 192;
    windows 37, 100, 128 and 200 at S 320 and 1024, which cut through the
    64-row tiles (K2's owned rows and K3's owned keys at D 256, the streamed
    tiles of K2 and K3), the 32-key halves of a streamed tile that K2's two
    warpgroups score at D 256, and K1's key tiles; B·H 1 and 256. (B·H, S,
    D, window, causal) each."""
    cases = []
    for d in dims:
        cases += [(4, s, d, 0, causal) for s in (64, 192, 320) for causal in (True, False)]
        cases += [(2, s, d, w, True) for s in (320, 1024) for w in (37, 100, 128, 200)]
        cases += [(bh, 512, d, 0, causal) for bh in (1, 256) for causal in (True, False)]
    return cases


def check_fwd_edges(fc) -> dict:
    """K1 alone against its plain version on ``_edge_cases`` at D 16, 32,
    64, 128 and 256. The limits are those of ``check_case``. Returns max
    |err| of o and lse per case."""
    import torch

    out = {}
    for bh, s, d, window, causal in _edge_cases(EDGE_DIMS):
        q, k, v, _ = _inputs(bh, s, d, torch.bfloat16, seed=6)
        o, lse = fc.flash_fwd(q, k, v, window, causal)
        torch.cuda.synchronize()
        po, plse = fc.flash_fwd_plain(q, k, v, window, causal)
        label = f"fwd bh{bh} s{s} d{d} w{window} {'causal' if causal else 'full'}"
        out[label] = {"o": _close(f"{label} o", o, po, TOL["bf16_out"], REL["bf16"])[0],
                      "lse": _close(f"{label} lse", lse, plse, TOL["fp32_out"], REL["fp32"])[0]}
    worst = {n: max(e[n] for e in out.values()) for n in ("o", "lse")}
    print(f"kernels K1 tile edges: {len(out)} cases, max |err| o {worst['o']:.3e}, "
          f"lse {worst['lse']:.3e}", flush=True)
    return out


def check_bwd_edges(fc) -> dict:
    """K2 and K3 alone against their plain versions on ``_edge_cases``, on
    the plain forward's lse and Δ (the limits of ``check_case``); and each
    run twice on the same inputs must give bitwise-equal dQ, dK and dV (no
    atomics: every gradient row is written once). Returns max |err| of dq,
    dk and dv per case. D 16, 32, 64, 128 and 256."""
    import torch

    out = {}
    for bh, s, d, window, causal in _edge_cases(EDGE_DIMS):
        q, k, v, do = _inputs(bh, s, d, torch.bfloat16, seed=7)
        po, plse = fc.flash_fwd_plain(q, k, v, window, causal)
        args = (q, k, v, do, plse, fc.flash_delta(po, do), window, causal)
        runs = [(fc.flash_bwd_dq(*args), *fc.flash_bwd_dkv(*args)) for _ in range(2)]
        torch.cuda.synchronize()
        label = f"bwd bh{bh} s{s} d{d} w{window} {'causal' if causal else 'full'}"
        for n, a, b in zip(("dq", "dk", "dv"), *runs):
            if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
                raise AssertionError(f"{label} {n}: two runs on the same inputs differ")
        want = (fc.flash_bwd_dq_plain(*args), *fc.flash_bwd_dkv_plain(*args))
        out[label] = {n: _close(f"{label} {n}", a, b, TOL["bf16_grad"], REL["bf16"])[0]
                      for n, a, b in zip(("dq", "dk", "dv"), runs[0], want)}
    worst = {n: max(e[n] for e in out.values()) for n in ("dq", "dk", "dv")}
    print(f"kernels K2/K3 tile edges: {len(out)} cases, deterministic, max |err| "
          + " ".join(f"{n} {e:.3e}" for n, e in worst.items()), flush=True)
    return out


def _library_bwd_ms(q, k, v, do, shape, causal: bool):
    """Time of the library's attention backward (dq, dk, dv) on the outputs
    of its own forward, same data, [B, H, S, D] views: the flash op in bf16;
    in fp32 the memory-efficient op (the one SDPA takes in fp32), reached
    through autograd of SDPA held to that backend, since the op's attn_bias
    argument cannot be left undefined from Python. None with the reason
    when this torch refuses. Timed only."""
    import torch
    import torch.nn.functional as F

    try:
        ql, kl, vl, dol = (x.view(*shape) for x in (q, k, v, do))
        if q.dtype == torch.float32:
            from torch.nn.attention import SDPBackend, sdpa_kernel

            xs = [x.detach().requires_grad_(True) for x in (ql, kl, vl)]
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                out = F.scaled_dot_product_attention(*xs, is_causal=causal)
            ms = _device_ms(lambda: torch.autograd.grad(out, xs, dol, retain_graph=True))
            bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward
        else:
            fwd = torch.ops.aten._scaled_dot_product_flash_attention
            bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
            o, lse, cq, ck, mq, mk, seed, offset = fwd(ql, kl, vl, 0.0, causal, False)[:8]
            ms = _device_ms(lambda: bwd(dol, ql, kl, vl, o, lse, cq, ck, mq, mk, 0.0, causal,
                                        seed, offset))
        return ms, str(bwd.default._schema)
    except (RuntimeError, TypeError, AttributeError) as e:
        print(f"library backward not timed: {e}", flush=True)
        return None, str(e)


def _cuda_kernel_names(fn) -> list:
    """The device kernels one call of ``fn`` runs, by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def check_unbuilt_head_dim(fc) -> dict:
    """A head dim with no CUDA build (80) must raise on the card, from the
    kernel wrapper and from ``mha``, and never run the plain path."""
    import torch

    from tpu_engine_torch.ops import flash_attention as tfa

    x = torch.zeros((1, 128, 2, 80), device="cuda", dtype=torch.bfloat16)
    xb = torch.zeros((2, 128, 80), device="cuda", dtype=torch.bfloat16)
    calls = {"flash_fwd": lambda: fc.flash_fwd(xb, xb, xb),
             "flash_fwd_lse": lambda: fc.flash_fwd_lse(xb, xb, xb, causal=False),
             "mha": lambda: tfa.mha(x, x, x)}
    out = {}
    for name, call in calls.items():
        try:
            call()
        except tfa.FlashUnsupported as e:
            raise AssertionError(f"{name} at an unbuilt head dim raised FlashUnsupported: {e}")
        except ValueError as e:
            out[name] = str(e)
        else:
            raise AssertionError(f"{name} ran at an unbuilt head dim")
    print(f"kernels unbuilt head dims raise: {out}", flush=True)
    return out


def phase_kernels(res: dict) -> None:
    import torch
    import torch.nn.functional as F

    from tpu_engine_torch.ops import _flash_cuda as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    B, H, S, D = 4, 16, 2048, 128
    RB = H  # the ring shard: batch 1, 16 heads, local S 2048
    main = check_case(fc, B * H, S, D, bf16, 0, seed=0)
    main_full = check_case(fc, RB, S, D, bf16, 0, seed=0, causal=False)
    GB, GH, GS, GD = GEMMA_SHAPE
    main256 = check_case(fc, GB * GH, GS, GD, bf16, 0, seed=0)
    main256_full = check_case(fc, GB * GH, GS, GD, bf16, 0, seed=0, causal=False)
    for bh, s, d, dtype, window, causal in (
            (4, 256, 128, f32, 0, True), (4, 256, 64, f32, 37, True),
            (8, 512, 128, bf16, 100, True), (16, 1024, 64, bf16, 0, True),
            (2, 512, 64, f32, 100, True),
            (4, 256, 128, f32, 0, False), (4, 192, 64, f32, 0, False),
            (16, 1024, 64, bf16, 0, False),
            # D 16 and 32: gpt-tiny's heads, and qwen-tiny's and gemma-tiny's
            (8, 512, 16, bf16, 0, True), (8, 512, 16, bf16, 0, False),
            (8, 512, 32, bf16, 0, True), (8, 512, 32, bf16, 0, False),
            (8, 256, 32, bf16, 50, True), (4, 256, 16, f32, 0, False),
            (4, 192, 16, f32, 20, True), (4, 192, 32, f32, 0, True),
            (4, 256, 32, f32, 0, False),
            # D 256: gemma's heads
            (8, 512, 256, bf16, 100, True), (8, 1024, 256, bf16, 0, False),
            (2, 256, 256, f32, 0, True), (2, 192, 256, f32, 50, True),
            (2, 320, 256, f32, 0, False),
            # fp32 (split TF32), so that every head dim runs causal, windowed
            # and non-causal; windows cut K1's 32-key and K3's 16-query tiles
            (4, 256, 16, f32, 0, True), (4, 320, 32, f32, 37, True),
            (4, 256, 64, f32, 0, True), (2, 320, 128, f32, 100, True),
            (2, 1024, 256, f32, 200, True), (1, 64, 128, f32, 0, False)):
        check_case(fc, bh, s, d, dtype, window, seed=1, causal=causal)
    res["fwd_edges"] = check_fwd_edges(fc)
    res["bwd_edges"] = check_bwd_edges(fc)
    res["lse_backward"] = check_lse_backward(fc)
    res["unbuilt_head_dim"] = check_unbuilt_head_dim(fc)

    q, k, v, do = _inputs(B * H, S, D, bf16, 0)
    o, lse = fc.flash_fwd(q, k, v)
    delta = fc.flash_delta(o, do)
    qf, kf, vf, dof = _inputs(RB, S, D, bf16, 0)
    of, lsef = fc.flash_fwd(qf, kf, vf, causal=False)
    deltaf = fc.flash_delta(of, dof)
    t = {
        "flash_fwd": _device_ms(lambda: fc.flash_fwd(q, k, v)),
        "flash_bwd_dq": _device_ms(lambda: fc.flash_bwd_dq(q, k, v, do, lse, delta)),
        "flash_bwd_dkv": _device_ms(lambda: fc.flash_bwd_dkv(q, k, v, do, lse, delta)),
        "flash_fwd_full": _device_ms(lambda: fc.flash_fwd(qf, kf, vf, causal=False)),
        "flash_bwd_dq_full": _device_ms(
            lambda: fc.flash_bwd_dq(qf, kf, vf, dof, lsef, deltaf, causal=False)),
        "flash_bwd_dkv_full": _device_ms(
            lambda: fc.flash_bwd_dkv(qf, kf, vf, dof, lsef, deltaf, causal=False)),
    }
    slow = dict(iters=3, warmup=1)
    plain = {
        "flash_fwd": _device_ms(lambda: fc.flash_fwd_plain(q, k, v), **slow),
        "flash_bwd_dq": _device_ms(lambda: fc.flash_bwd_dq_plain(q, k, v, do, lse, delta), **slow),
        "flash_bwd_dkv": _device_ms(lambda: fc.flash_bwd_dkv_plain(q, k, v, do, lse, delta),
                                  **slow),
        "flash_fwd_full": _device_ms(lambda: fc.flash_fwd_plain(qf, kf, vf, causal=False), **slow),
        "flash_bwd_dq_full": _device_ms(
            lambda: fc.flash_bwd_dq_plain(qf, kf, vf, dof, lsef, deltaf, causal=False), **slow),
        "flash_bwd_dkv_full": _device_ms(
            lambda: fc.flash_bwd_dkv_plain(qf, kf, vf, dof, lsef, deltaf, causal=False), **slow),
    }
    # Library yardstick on the same data, [B, H, S, D] views (timed only).
    ql, kl, vl = (x.view(B, H, S, D).detach().requires_grad_(True) for x in (q, k, v))
    dol = do.view(B, H, S, D)
    qfl, kfl, vfl = (x.view(1, RB, S, D) for x in (qf, kf, vf))
    library = {
        "flash_fwd": _device_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)),
        "flash_fwd_full": _device_ms(
            lambda: F.scaled_dot_product_attention(qfl, kfl, vfl, is_causal=False)),
    }

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        torch.autograd.grad(out, (ql, kl, vl), dol)

    sdpa_both = _device_ms(sdpa_fwd_bwd)
    ours_both = _device_ms(lambda: fc.flash_bwd(q, k, v, *fc.flash_fwd(q, k, v), do))
    # K1 causal at the ring shard, where train_ring's diagonal hops run it.
    ring_causal = {"ms": _device_ms(lambda: fc.flash_fwd(qf, kf, vf)),
                   "library_ms": _device_ms(
                       lambda: F.scaled_dot_product_attention(qfl, kfl, vfl, is_causal=True)),
                   "bound_ms": kernel_bounds(RB, S, D, 0, 2)["flash_fwd"]["bound_ms"],
                   "shape": [RB, S, D]}
    res["flash_fwd_ring_shard"] = ring_causal
    # K2 and K3 causal at the ring shard, where train_ring's diagonal hops
    # run them, beside their bounds and the library's causal backward.
    oc, lsec = fc.flash_fwd(qf, kf, vf)
    deltac = fc.flash_delta(oc, dof)
    shard_bounds = kernel_bounds(RB, S, D, 0, 2)
    ring_bwd = {name: {"ms": _device_ms(lambda fn=fn: fn(qf, kf, vf, dof, lsec, deltac)),
                       "bound_ms": shard_bounds[name]["bound_ms"]}
                for name, fn in (("flash_bwd_dq", fc.flash_bwd_dq),
                                 ("flash_bwd_dkv", fc.flash_bwd_dkv))}
    ring_bwd["pair_ms"] = ring_bwd["flash_bwd_dq"]["ms"] + ring_bwd["flash_bwd_dkv"]["ms"]
    ring_bwd["library_ms"] = _library_bwd_ms(qf, kf, vf, dof, (1, RB, S, D), True)[0]
    ring_bwd["shape"] = [RB, S, D]
    res["flash_bwd_ring_shard"] = ring_bwd
    # K2 + K3 against the library's flash backward, causal at the training
    # shape and non-causal at the ring shard.
    bwd_pair = {}
    for key, args, shape, causal in (
            ("causal", (q, k, v, do, lse, delta), (B, H, S, D), True),
            ("full", (qf, kf, vf, dof, lsef, deltaf), (1, RB, S, D), False)):
        lib_ms, schema = _library_bwd_ms(*args[:4], shape, causal)
        kernels_ms = t[f"flash_bwd_dq{'' if causal else '_full'}"] + \
            t[f"flash_bwd_dkv{'' if causal else '_full'}"]
        bwd_pair[key] = {"kernels_ms": kernels_ms, "library_ms": lib_ms,
                         "library_op": schema, "shape": list(shape)}
    res["backward_pair"] = bwd_pair
    bounds = kernel_bounds(B * H, S, D, 0, 2)
    bounds.update({f"{n}_full": b for n, b in
                   kernel_bounds(RB, S, D, 0, 2, causal=False).items()})
    errs = {}
    for suffix, m in (("", main), ("_full", main_full)):
        errs.update({f"flash_fwd{suffix}": max(m["o"], m["lse"]),
                     f"flash_bwd_dq{suffix}": m["dq"],
                     f"flash_bwd_dkv{suffix}": max(m["dk"], m["dv"])})
    res["kernels"] = [
        {"name": name, "route": "cuda", "source": SOURCE[name.removesuffix("_full")],
         "replaces": REPLACES[name.removesuffix("_full")], "launches": None,
         "max_abs_err": errs[name], "ms": t[name], "plain_ms": plain[name],
         "bound_ms": bounds[name]["bound_ms"], "bound_by": bounds[name]["bound_by"],
         "library_ms": library.get(name),
         "shape": [B * H if name in REPLACES else RB, S, D],
         "counter": name,
         "paths": list(D128_PATHS) + (["serve_moe"] if name == "flash_fwd" else [])}
        for name in t
    ] + _d256_rows(fc, res, main256, main256_full) + _off_path_rows(fc, res)
    res["attention_fwd_bwd"] = {"kernels_ms": ours_both, "library_ms": sdpa_both,
                                "shape": [B, H, S, D]}
    for kr in res["kernels"]:
        fma = f", FMA bound {kr['bound_fma_ms']:.4f}" if "bound_fma_ms" in kr else ""
        print(f"time {kr['name']} {kr['shape']}: {kr['ms']:.4f} ms (plain {kr['plain_ms']:.3f}, "
              f"bound {kr['bound_ms']:.4f} by {kr['bound_by']}{fma}, library {kr['library_ms']})",
              flush=True)
    print(f"time fwd+bwd: kernels {ours_both:.4f} ms, sdpa {sdpa_both:.4f} ms", flush=True)
    print(f"time flash_fwd (causal) {ring_causal['shape']}: {ring_causal['ms']:.4f} ms "
          f"(bound {ring_causal['bound_ms']:.4f}, library {ring_causal['library_ms']:.4f})",
          flush=True)
    print(f"time K2+K3 (causal) {ring_bwd['shape']}: dq {ring_bwd['flash_bwd_dq']['ms']:.4f} ms "
          f"(bound {ring_bwd['flash_bwd_dq']['bound_ms']:.4f}), dkv "
          f"{ring_bwd['flash_bwd_dkv']['ms']:.4f} ms (bound "
          f"{ring_bwd['flash_bwd_dkv']['bound_ms']:.4f}), pair {ring_bwd['pair_ms']:.4f} ms, "
          f"library {ring_bwd['library_ms']}", flush=True)
    for key, row in bwd_pair.items():
        print(f"time K2+K3 {key} {row['shape']}: kernels {row['kernels_ms']:.4f} ms, "
              f"library {row['library_ms']}", flush=True)


# The training paths of the bf16 D 128 kernels (K1 also serve_moe's teacher
# forwards); remat's launches are nothing_saveable's.
D128_PATHS = ("train", "train_job", "train_ring", "train_moe", "train_int8", "train_lora",
              "train_adafactor", "train_lion", "remat", "train_offload", "train_7b",
              "train_window", "train_mesh", "train_pipe", "train_data", "train_comm",
              "train_mesh_state", "train_fleet", "serve_fleet")


def _d256_rows(fc, res: dict, main: dict, main_full: dict) -> list:
    """The D 256 kernels (causal and non-causal) timed at gemma-2b's
    training shape beside their plain versions, bounds and the library's
    yardsticks (SDPA's forward; the flash backward op for K2 + K3, recorded
    as ``res["backward_pair_d256"]``). Their rows of the kernels line,
    named ``<kernel>_d256[_full]``, with the launches of ``train_gemma``."""
    import torch
    import torch.nn.functional as F

    B, H, S, D = GEMMA_SHAPE
    q, k, v, do = _inputs(B * H, S, D, torch.bfloat16, 0)
    ql, kl, vl = (x.view(B, H, S, D) for x in (q, k, v))
    slow = dict(iters=3, warmup=1)
    rows, pair = [], {}
    for causal, m in ((True, main), (False, main_full)):
        suffix = "" if causal else "_full"
        o, lse = fc.flash_fwd(q, k, v, causal=causal)
        bwd = (q, k, v, do, lse, fc.flash_delta(o, do))
        bounds = kernel_bounds(B * H, S, D, 0, 2, causal=causal)
        kernels = {
            "flash_fwd": (lambda: fc.flash_fwd(q, k, v, causal=causal),
                          lambda: fc.flash_fwd_plain(q, k, v, causal=causal),
                          _device_ms(lambda: F.scaled_dot_product_attention(
                              ql, kl, vl, is_causal=causal)), max(m["o"], m["lse"])),
            "flash_bwd_dq": (lambda: fc.flash_bwd_dq(*bwd, causal=causal),
                             lambda: fc.flash_bwd_dq_plain(*bwd, causal=causal), None, m["dq"]),
            "flash_bwd_dkv": (lambda: fc.flash_bwd_dkv(*bwd, causal=causal),
                              lambda: fc.flash_bwd_dkv_plain(*bwd, causal=causal), None,
                              max(m["dk"], m["dv"])),
        }
        for name, (kernel, plain, library, err) in kernels.items():
            rows.append({
                "name": f"{name}_d256{suffix}", "route": "cuda", "source": SOURCE_D256[name],
                "replaces": REPLACES[name], "launches": None, "max_abs_err": err,
                "ms": _device_ms(kernel), "plain_ms": _device_ms(plain, **slow),
                "bound_ms": bounds[name]["bound_ms"], "bound_by": bounds[name]["bound_by"],
                "library_ms": library, "shape": [B * H, S, D],
                "counter": name + suffix, "paths": ["train_gemma"] if causal else []})
        lib_ms, schema = _library_bwd_ms(q, k, v, do, (B, H, S, D), causal)
        pair["causal" if causal else "full"] = {
            "kernels_ms": rows[-2]["ms"] + rows[-1]["ms"], "library_ms": lib_ms,
            "library_op": schema, "shape": [B, H, S, D]}
    res["backward_pair_d256"] = pair
    for key, row in pair.items():
        print(f"time K2+K3 d256 {key} {row['shape']}: kernels {row['kernels_ms']:.4f} ms, "
              f"library {row['library_ms']}", flush=True)
    return rows


def _off_path_rows(fc, res: dict) -> list:
    """The ``OFF_PATH`` kernels at S 2048: each held to its plain version
    (:func:`check_case`) and timed beside it, its bound and, for K1, SDPA on
    the same data; fp32 K2 and K3 run twice to bitwise-equal dQ, dK and dV;
    the K2 + K3 pair beside the library's backward
    (``res["backward_pair_off_path"]``); and the kernels SDPA runs in fp32
    (``res["sdpa_fp32_kernels"]``). fp32 rows are bound at the split-TF32
    rate (``bound_ms``) and at the FMA rate (``bound_fma_ms``). Their rows of
    the kernels line, ``<kernel>_<suffix>``, read their launches on the
    row's paths."""
    import torch
    import torch.nn.functional as F

    S = 2048
    slow = dict(iters=3, warmup=1)
    rows, pairs = [], {}
    for suffix, bh, d, kind, causal, paths in OFF_PATH:
        dtype = torch.float32 if kind == "fp32" else torch.bfloat16
        errs = check_case(fc, bh, S, d, dtype, 0, seed=0, causal=causal)
        q, k, v, do = _inputs(bh, S, d, dtype, 0)
        o, lse = fc.flash_fwd(q, k, v, causal=causal)
        bwd = (q, k, v, do, lse, fc.flash_delta(o, do))
        if kind == "fp32":
            first, second = ((fc.flash_bwd_dq(*bwd, causal=causal),
                              *fc.flash_bwd_dkv(*bwd, causal=causal)) for _ in range(2))
            torch.cuda.synchronize()
            for n, a, b in zip(("dq", "dk", "dv"), first, second):
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    raise AssertionError(f"fp32 {n} {suffix}: two runs on the same inputs differ")
        bounds = kernel_bounds(bh, S, d, 0, q.element_size(), causal=causal,
                               peak=PEAK_SPLIT_TF32_FLOPS if kind == "fp32" else PEAK_BF16_FLOPS)
        fma = kernel_bounds(bh, S, d, 0, q.element_size(), causal=causal, peak=PEAK_FP32_FLOPS)
        ql, kl, vl = (x.view(1, bh, S, d) for x in (q, k, v))
        kernels = {
            "flash_fwd": (lambda: fc.flash_fwd(q, k, v, causal=causal),
                          lambda: fc.flash_fwd_plain(q, k, v, causal=causal),
                          _device_ms(lambda: F.scaled_dot_product_attention(
                              ql, kl, vl, is_causal=causal)), max(errs["o"], errs["lse"])),
            "flash_bwd_dq": (lambda: fc.flash_bwd_dq(*bwd, causal=causal),
                             lambda: fc.flash_bwd_dq_plain(*bwd, causal=causal), None, errs["dq"]),
            "flash_bwd_dkv": (lambda: fc.flash_bwd_dkv(*bwd, causal=causal),
                              lambda: fc.flash_bwd_dkv_plain(*bwd, causal=causal), None,
                              max(errs["dk"], errs["dv"])),
        }
        for name, (kernel, plain, library, err) in kernels.items():
            source = SOURCE[name] if (kind, d) == ("bf16", 64) else SOURCE_OFF_PATH[kind, name]
            rows.append({
                "name": f"{name}_{suffix}", "route": "cuda", "source": source,
                "replaces": REPLACES[name], "launches": None, "max_abs_err": err,
                "ms": _device_ms(kernel), "plain_ms": _device_ms(plain, **slow),
                "bound_ms": bounds[name]["bound_ms"], "bound_by": bounds[name]["bound_by"],
                "library_ms": library, "shape": [bh, S, d],
                "counter": name if causal else f"{name}_full", "paths": list(paths),
                **({"bound_fma_ms": fma[name]["bound_ms"]} if kind == "fp32" else {})})
        lib_ms, schema = _library_bwd_ms(q, k, v, do, (1, bh, S, d), causal)
        pairs[suffix] = {"kernels_ms": rows[-2]["ms"] + rows[-1]["ms"], "library_ms": lib_ms,
                         "library_op": schema, "shape": [1, bh, S, d],
                         "bound_ms": bounds["flash_bwd_dq"]["bound_ms"]
                         + bounds["flash_bwd_dkv"]["bound_ms"]}
        if suffix == "fp32_d128":
            res["sdpa_fp32_kernels"] = _cuda_kernel_names(
                lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal))
            print(f"kernels SDPA runs in fp32: {res['sdpa_fp32_kernels']}", flush=True)
        del q, k, v, do, o, lse, bwd
        torch.cuda.empty_cache()
    res["backward_pair_off_path"] = pairs
    for key, row in pairs.items():
        print(f"time K2+K3 {key} {row['shape']}: kernels {row['kernels_ms']:.4f} ms "
              f"(bound {row['bound_ms']:.4f}), library {row['library_ms']}", flush=True)
    return rows


def _flash_vs_plain(cfg, tokens, bf16_rel=None) -> dict:
    """``cfg`` (remat) from the same seed-1 weights through the plain
    attention path in fp32 (TF32 off; the reference) and in bf16, and
    through the flash kernels in bf16 and fp32: the logits
    and the fp32 master Wq's gradient, by relative norm error. Held: fp32
    flash to the reference within MODEL_REL["fp32"]; bf16 flash no further
    from the reference than MODEL_BF16_RATIO × bf16 plain (two roundings of
    one function); and, with ``bf16_rel``, bf16 flash to bf16 plain. The
    launch counts of each flash pass, forward and backward, are read around
    it (``launches``)."""
    import torch

    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.ops import _flash_cuda as fc

    out, launches = {}, {}
    for impl, kind in (("xla", "fp32"), ("xla", "bf16"), ("flash", "bf16"), ("flash", "fp32")):
        dtype = torch.float32 if kind == "fp32" else torch.bfloat16
        params = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
        fc.reset_launches()
        logits = tfm.forward(params, tokens, cfg.with_(attention_impl=impl),
                             compute_dtype=dtype, remat=True)
        logits.square().mean().backward()
        if impl == "flash":
            launches[kind] = dict(fc.launches)
        out[impl, kind] = {"logits": logits.detach(), "dWq": params["layers.q.kernel"].grad}
        del params, logits
    no_abs = dict(atol=math.inf, rtol=0.0)
    nums, fails = {}, []
    for part in ("logits", "dWq"):
        ref = out["xla", "fp32"][part]
        label = f"model {cfg.name} {part}"
        nums[f"fp32_{part}"] = _close(f"{label} fp32", out["flash", "fp32"][part], ref,
                                      no_abs, MODEL_REL["fp32"])[1]
        nums[f"bf16_{part}"] = _close(f"{label} bf16", out["flash", "bf16"][part],
                                      out["xla", "bf16"][part], no_abs, bf16_rel)[1]
        plain, flash = (_rel_err(out[impl, "bf16"][part], ref) for impl in ("xla", "flash"))
        nums[f"bf16_{part}_to_fp32"] = {"plain": plain, "flash": flash}
        if not flash <= MODEL_BF16_RATIO * plain:
            fails.append(f"{label}: bf16 flash {flash:.3e} from fp32, bf16 plain {plain:.3e}")
    print(f"model {cfg.name} ({cfg.arch}, {cfg.n_layers} layers, head dim {cfg.head_dim}), "
          "relative norm error: " + ", ".join(
              f"{part}: fp32 flash vs plain {nums[f'fp32_{part}']:.3e}, "
              f"bf16 flash vs plain {nums[f'bf16_{part}']:.3e}, bf16 to fp32 plain "
              f"{nums[f'bf16_{part}_to_fp32']['plain']:.3e} / flash "
              f"{nums[f'bf16_{part}_to_fp32']['flash']:.3e}" for part in ("logits", "dWq")),
          flush=True)
    if fails:
        raise AssertionError("; ".join(fails))
    nums["launches"] = launches
    return nums


def phase_model(res: dict) -> None:
    """A small llama (GQA, remat) through the flash kernels vs the plain
    attention path, in fp32 (TF32 off) and in bf16 compute: logits and the
    gradient of the fp32 master Wq, each held by relative norm error (the
    gradients are of order 1e-6, so an absolute limit would say nothing).
    Then the other archs at their full widths: gpt2-124m (all 12 layers,
    biases, learned positions, tied head, D 64), qwen3-4b at 2 layers
    (qk-norm, GQA, D 128) and gemma-2b at 2 layers (MQA, GeGLU, tied head,
    D 256), on 2 × 256 tokens. The llama case also holds bf16 flash to bf16 plain
    (MODEL_REL); for the archs that difference is reported, and bf16 is
    held against the fp32 reference (:func:`_flash_vs_plain`): qwen's
    per-head norm of q turns bf16 rounding into a 2.7e-2 difference of
    dWq between two sound bf16 paths."""
    import torch

    from tpu_engine_torch.models.config import MODEL_CONFIGS, ModelConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(name="llama-small", vocab_size=1024, d_model=256, n_layers=2,
                      n_heads=2, n_kv_heads=1, d_ff=512, max_seq_len=256)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen, device="cuda")
    res["model"] = _flash_vs_plain(cfg, tokens, bf16_rel=MODEL_REL["bf16"])
    res["model_archs"] = {}
    for name, layers in (("gpt2-124m", 12), ("qwen3-4b", 2), ("gemma-2b", 2)):
        acfg = MODEL_CONFIGS[name].with_(n_layers=layers)
        tokens = torch.randint(0, acfg.vocab_size, (2, 256), generator=gen, device="cuda")
        res["model_archs"][name] = _flash_vs_plain(acfg, tokens)
        torch.cuda.empty_cache()
    # gemma-2b's fp32 flash pass (one forward and backward at D 256) is the
    # path of the fp32 D 256 rows of the kernels line, gpt2-124m's bf16 pass
    # (12 layers at D 64) that of the bf16 D 64 rows.
    res["model_fp32_gemma"] = {"launches": res["model_archs"]["gemma-2b"]["launches"]["fp32"],
                               "steps": 1, "accum": 1}
    res["model_bf16_gpt2"] = {"launches": res["model_archs"]["gpt2-124m"]["launches"]["bf16"],
                              "steps": 1, "accum": 1}


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


def _run_steps(cfg, steps: int, want_impl: str, before=None, model_cfg=None):
    """Build ``cfg``'s program on the card (``model_cfg`` in place of its
    model name's, if given) and take ``steps`` steps on one synthetic
    batch, repeated, with every launch counter set to 0 just before.
    ``before(prog, state, batch)``, if given, runs on the initial state
    first. Returns (program, state, batch, losses, gradient norms, step
    seconds, launches (the flash kernels', their windowed ones as
    ``<kernel>_window``, and ``torch._int_mm``'s), what ``before``
    returned)."""
    import torch

    from tpu_engine_torch import quant_train as qt
    from tpu_engine_torch.ops import _flash_cuda as fc
    from tpu_engine_torch.train import build_train_program

    prog = build_train_program(cfg, model_cfg=model_cfg, device="cuda")
    if prog.model_config.attention_impl != want_impl:
        raise AssertionError(f"attention resolved to {prog.model_config.attention_impl!r}, "
                             f"want {want_impl!r}")
    state = prog.init()
    batch = prog.synthetic_batch(seed=0)
    first = before(prog, state, batch) if before else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fc.reset_launches()
    qt.reset_launches()
    losses, norms, times = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = prog.step(state, batch)
        losses.append(float(m["loss"]))  # host sync
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    windowed = {f"{name}_window": n for name, n in fc.windowed.items()}
    return (prog, state, batch, losses, norms, times,
            {**fc.launches, **windowed, **qt.launches}, first)


def _train(res: dict, key: str, cfg, steps: int, want_impl: str, want: dict,
           first_loss_ref=None, model_cfg=None, exact_first: bool = False,
           first_rel: float = FIRST_LOSS_REL):
    """Train ``cfg`` for ``steps`` steps (:func:`_run_steps`) and check the
    losses and the launch counts read just after. ``want`` is the launch
    count per microbatch of each kernel (and of ``int_mm``); a kernel
    missing from it must not launch at all. The first loss must lie near
    ln(vocab) or, with ``first_loss_ref(prog, state, batch)`` (the loss of
    the initial state by another path), within FIRST_LOSS_REL of what that
    returns (``exact_first``: equal to it; ``first_rel`` sets the bound).
    Returns (program, state, batch)."""
    import torch

    from tpu_engine_torch.models import transformer as tfm

    prog, state, batch, losses, norms, times, counts, ref = _run_steps(
        cfg, steps, want_impl, first_loss_ref, model_cfg)

    micro = steps * cfg.gradient_accumulation_steps
    want = {name: want.get(name, 0) * micro for name in counts}
    tokens = math.prod(prog.global_batch_shape())
    step_s = min(times[1:]) if len(times) > 1 else times[0]
    flops_tok = tfm.train_flops_per_token(prog.model_config, cfg.seq_len)
    out = res[key] = {
        "model": prog.model_config.name, "n_layers": prog.model_config.n_layers,
        "micro_batch": cfg.micro_batch_size, "seq_len": cfg.seq_len,
        "sequence": cfg.sequence, "steps": steps,
        "accum": cfg.gradient_accumulation_steps, "losses": losses, "grad_norms": norms,
        "step_ms_each": [t * 1e3 for t in times],
        "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "mfu": tokens / step_s * flops_tok / PEAK_BF16_FLOPS,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts, "launches_expected": want,
        "opt_state_bytes": prog.tx.state_bytes(state["opt_state"]) if "opt_state" in state else 0,
    }
    print(f"{key}: losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"{key}: step {step_s * 1e3:.1f} ms (min of steps 2..{steps}), "
          f"{tokens / step_s:.0f} tokens/s, MFU {out['mfu']:.4f} vs 989 TFLOP/s, "
          f"peak {out['peak_mem_gib']:.2f} GiB, launches {counts}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if ref is None and abs(losses[0] - math.log(prog.model_config.vocab_size)) > 0.5:
        raise AssertionError(f"first loss {losses[0]} is not near ln(vocab)")
    if ref is not None:
        out["first_loss_ref"] = ref
        print(f"{key}: first loss {losses[0]:.5f}, by the plain attention path {ref:.5f} "
              f"(relative {abs(losses[0] - ref) / ref:.2e}, bound {first_rel})", flush=True)
        if not abs(losses[0] - ref) <= first_rel * ref:
            raise AssertionError(f"first loss {losses[0]} vs the plain path's {ref}")
        if exact_first and losses[0] != ref:
            raise AssertionError(f"first loss {losses[0]!r} is not bitwise {ref!r}")
    if not all(b < a for a, b in zip(losses[1:], losses[2:])):
        raise AssertionError(f"loss did not fall at every step on a repeated batch: {losses}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    out["profile"] = _profile(lambda: prog.step(state, batch), key)
    out["optimizer_ms"] = _time_optimizer(prog, state, key)
    return prog, state, batch


def phase_train(res: dict, steps: int) -> None:
    """llama-1b, seq 2048, micro-batch 4, flash attention: per microbatch K1
    runs twice per layer (forward and the checkpoint's recompute), K2 and
    K3 once."""
    L = 16
    _train(res, "train", _llama_1b_cfg(), steps, "flash",
           {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L})


def _llama_1b_cfg(**kw):
    """``train``'s configuration (llama-1b, seq 2048 × micro-batch 4, bf16
    compute, fp32 masters, AdamW, checkpointing, flash), with ``kw``."""
    from tpu_engine_torch.train import TrainConfig

    return TrainConfig(**{**dict(model_name="llama-1b", micro_batch_size=4,
                                 gradient_accumulation_steps=1, seq_len=2048,
                                 precision="bf16", param_dtype="fp32",
                                 activation_checkpointing=True, attention_impl="auto",
                                 **TRAIN_LR), **kw})


def phase_train_gemma(res: dict, steps: int) -> None:
    """gemma-2b at full width and depth (18 layers, 8 query heads of 256,
    one kv head, GeGLU d_ff 16384, vocab 256000, tied head), seq 2048 ×
    micro-batch 4, bf16 compute, fp32 masters, AdamW, checkpointing, flash
    attention (the D 256 kernels), loss chunks of 256 positions. Per
    microbatch K1 runs twice per layer, K2 and K3 once. A tied head's
    logits at random init are far from ln(vocab) (each token's own row
    scores |e|²/rms(e)), so the first loss is held instead to the loss of
    the same initial weights and batch through the plain attention path."""
    from dataclasses import replace

    import torch

    from tpu_engine_torch.train import TrainConfig, build_train_program

    B, _, S, _ = GEMMA_SHAPE
    cfg = TrainConfig(model_name="gemma-2b", micro_batch_size=B, gradient_accumulation_steps=1,
                      seq_len=S, precision="bf16", param_dtype="fp32",
                      activation_checkpointing=True, attention_impl="auto",
                      loss_chunk_size=256, **TRAIN_LR)

    def plain_loss(prog, state, batch) -> float:
        plain = build_train_program(replace(cfg, attention_impl="xla"), device="cuda")
        return float(plain.eval_step(state, batch))

    L = 18
    _train(res, "train_gemma", cfg, steps, "flash",
           {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}, first_loss_ref=plain_loss)
    torch.cuda.empty_cache()


def _initial_grads(cfg, want_impl: str) -> dict:
    """Every parameter's gradient of ``cfg``'s training loss at its initial
    weights on the synthetic batch: the backward of a step, before its
    update."""
    from tpu_engine_torch.train import accumulate_grads, build_train_program

    prog = build_train_program(cfg, device="cuda")
    if prog.model_config.attention_impl != want_impl:
        raise AssertionError(f"attention resolved to {prog.model_config.attention_impl!r}")
    params = prog.init()["params"]
    return accumulate_grads(prog.loss_fn, params, prog.synthetic_batch(seed=0))[1]


def phase_train_ring(res: dict, steps: int) -> None:
    """llama-1b, seq 8192 over a ring of 4 (local shard 2048), micro-batch 1:
    per layer each rank runs its diagonal hop causal and its past hops
    unmasked, 4 causal and 6 non-causal hops, and skips the 6 future ones;
    K1 runs each twice (forward and the checkpoint's recompute).

    Then the same steps with flash attention over the whole sequence, the
    reference at full size: the two differ only in attention's bf16
    rounding (the ring merges per-hop bf16 outputs). From the same weights,
    their losses at steps 0 and 2 must agree within RING_LOSS_TOL, and
    their gradient norms at step 1 within RING_GRAD_NORM_REL: the ring's
    forward, its backward through the whole model, and the update it
    drives; and, in fp32 compute, every parameter's gradient at the initial
    weights within RING_PARAM_GRAD_REL."""
    from dataclasses import replace

    import torch

    from tpu_engine_torch.train import TrainConfig

    cfg = TrainConfig(model_name="llama-1b", micro_batch_size=1, gradient_accumulation_steps=1,
                      seq_len=RING_SEQ, sequence=RING, precision="bf16", param_dtype="fp32",
                      activation_checkpointing=True, attention_impl="auto", **TRAIN_LR)
    L, diag, past = 16, RING, RING * (RING - 1) // 2
    _train(res, "train_ring", cfg, steps, "ring",
           {"flash_fwd": 2 * L * diag, "flash_fwd_full": 2 * L * past,
            "flash_bwd_dq": L * diag, "flash_bwd_dq_full": L * past,
            "flash_bwd_dkv": L * diag, "flash_bwd_dkv_full": L * past})
    losses, norms, times = _run_steps(replace(cfg, sequence=1), steps, "flash")[3:6]
    ring, ring_norms = res["train_ring"]["losses"], res["train_ring"]["grad_norms"]
    diffs = [abs(a - b) for a, b in zip(ring, losses)]
    norm_rel = [abs(a - b) / b for a, b in zip(ring_norms, norms)]
    res["train_ring"]["flash_reference"] = {
        "losses": losses, "abs_diff": diffs, "grad_norms": norms, "grad_norm_rel_diff": norm_rel,
        "step_ms": min(times[1:] or times) * 1e3}
    print(f"train_ring: flash at seq {RING_SEQ}: losses {[round(x, 4) for x in losses]}, "
          f"grad norms {[round(x, 4) for x in norms]}, "
          f"step {res['train_ring']['flash_reference']['step_ms']:.1f} ms; "
          f"|ring - flash| losses {[f'{x:.2e}' for x in diffs]}, "
          f"grad norms (relative) {[f'{x:.2e}' for x in norm_rel]}", flush=True)
    for i in (0, 2):
        if not diffs[i] <= RING_LOSS_TOL:
            raise AssertionError(f"loss at step {i}: ring {ring[i]} vs flash {losses[i]}")
    if not norm_rel[1] <= RING_GRAD_NORM_REL:
        raise AssertionError(f"gradient norm at step 1: ring {ring_norms[1]} vs flash {norms[1]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    fp32 = replace(cfg, precision="fp32")
    ring_grads = _initial_grads(fp32, "ring")
    flash_grads = _initial_grads(replace(fp32, sequence=1), "flash")
    grad_rel = {k: float((g.float() - flash_grads[k].float()).norm()
                         / flash_grads[k].float().norm().clamp_min(1e-30))
                for k, g in ring_grads.items()}
    res["train_ring"]["flash_reference"]["param_grad_rel_err"] = grad_rel
    print("train_ring: initial fp32 gradients, ring vs flash, relative norm error: "
          + " ".join(f"{k}={e:.2e}" for k, e in grad_rel.items()), flush=True)
    worst = max(grad_rel, key=grad_rel.get)
    if not grad_rel[worst] <= RING_PARAM_GRAD_REL:
        raise AssertionError(f"gradient of {worst}: relative norm error {grad_rel[worst]:.3e} "
                             f"> {RING_PARAM_GRAD_REL}")


def phase_train_fp32(res: dict, steps: int) -> None:
    """``train_ring``'s llama-1b ring (seq 8192, sequence 4, micro-batch 1)
    in fp32 compute, ``TrainConfig(precision="fp32")`` with TF32 off: every
    attention call runs the split-TF32 fp32 kernels K1, K2 and K3, causal
    on the diagonal hops and non-causal on the past ones.
    The launch counts are those of ``train_ring``."""
    import torch

    from tpu_engine_torch.train import TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig(model_name="llama-1b", micro_batch_size=1, gradient_accumulation_steps=1,
                      seq_len=RING_SEQ, sequence=RING, precision="fp32", param_dtype="fp32",
                      activation_checkpointing=True, attention_impl="auto", **TRAIN_LR)
    L, diag, past = 16, RING, RING * (RING - 1) // 2
    _train(res, "train_fp32", cfg, steps, "ring",
           {"flash_fwd": 2 * L * diag, "flash_fwd_full": 2 * L * past,
            "flash_bwd_dq": L * diag, "flash_bwd_dq_full": L * past,
            "flash_bwd_dkv": L * diag, "flash_bwd_dkv_full": L * past})
    torch.cuda.empty_cache()


def phase_train_tiny(res: dict, steps: int) -> None:
    """qwen-tiny (2 layers, heads of 32; ``train_tiny``) and gpt-tiny (llama
    arch, 2 layers, 4 heads of 16; ``train_tiny_d16``) in bf16 at seq 256 ×
    micro-batch 8, flash attention: the bf16 D 32 and D 16 kernels (the
    Hopper K1, K2 and K3), K1 twice per layer (forward
    and the checkpoint's recompute), K2 and K3 once. A tiny model learns
    slowly at TRAIN_LR's rate, so these train at 1e-3 to see the loss fall
    at every step."""
    from tpu_engine_torch.train import TrainConfig

    L = 2
    for key, model in (("train_tiny", "qwen-tiny"), ("train_tiny_d16", "gpt-tiny")):
        cfg = TrainConfig(model_name=model, micro_batch_size=8, gradient_accumulation_steps=1,
                          seq_len=256, precision="bf16", param_dtype="fp32",
                          activation_checkpointing=True, attention_impl="auto",
                          **dict(TRAIN_LR, learning_rate=1e-3))
        _train(res, key, cfg, steps, "flash",
               {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L})


def phase_ring(res: dict) -> None:
    """``ring_mha`` over 4 ranks against ``flash_mha`` on the same causal
    inputs at S 8192 (and a GQA case): the output and the gradients of q,
    k and v under one random cotangent, by relative norm error, and the
    ring's launches; then both timed, forward and backward."""
    import torch

    from tpu_engine_torch.ops import _flash_cuda as fc
    from tpu_engine_torch.ops import flash_attention as tfa
    from tpu_engine_torch.parallel.ring_attention import ring_mha

    no_abs = dict(atol=math.inf, rtol=0.0)
    diag, past = RING, RING * (RING - 1) // 2
    want = {"flash_fwd": diag, "flash_fwd_full": past, "flash_bwd_dq": diag,
            "flash_bwd_dq_full": past, "flash_bwd_dkv": diag, "flash_bwd_dkv_full": past}
    impls = {"ring": lambda q, k, v: ring_mha(q, k, v, RING), "flash": tfa.flash_mha}
    res["ring"] = {}
    for label, kv_heads in (("mha", 16), ("gqa", 4)):
        g = torch.Generator(device="cuda").manual_seed(5)

        def rand(heads):
            return torch.randn((1, RING_SEQ, heads, 128), generator=g, device="cuda").bfloat16()

        q, k, v, do = rand(16), rand(kv_heads), rand(kv_heads), rand(16)
        got, counts = {}, {}
        for name, fn in impls.items():
            xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
            fc.reset_launches()
            o = fn(*xs)
            got[name] = (o.detach(), *torch.autograd.grad(o, xs, do))
            torch.cuda.synchronize()
            counts[name] = dict(fc.launches)
        errs = {n: _close(f"ring {label} {n}", a, b, no_abs, REL["bf16"])[1]
                for n, a, b in zip(("o", "dq", "dk", "dv"), got["ring"], got["flash"])}
        ring_counts = {n: c for n, c in counts["ring"].items() if c}
        if ring_counts != {n: c for n, c in want.items() if c}:
            raise AssertionError(f"ring {label} launches {counts['ring']} != {want}")
        res["ring"][label] = {"rel_err": errs, "launches": counts["ring"]}
        print(f"ring {label} (S {RING_SEQ}, ring {RING}, kv heads {kv_heads}) vs flash_mha, "
              "relative norm error: " + " ".join(f"{n}={e:.2e}" for n, e in errs.items()),
              flush=True)
        if label == "mha":
            def fwd_bwd(fn):
                xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
                torch.autograd.grad(fn(*xs), xs, do)

            res["ring"]["fwd_bwd_ms"] = {name: _time_ms(lambda fn=fn: fwd_bwd(fn), iters=5,
                                                        warmup=1)
                                         for name, fn in impls.items()}
            print(f"ring: fwd+bwd at S {RING_SEQ}: " + json.dumps(res["ring"]["fwd_bwd_ms"]),
                  flush=True)


def _llama_1b(state: dict):
    """llama-1b's inference parameters (seed 0, cast once to bf16, on the
    card), made on first use and kept in ``state`` for the next phase."""
    import torch

    from tpu_engine_torch.models import transformer as tfm

    if "params" not in state:
        cfg = tfm.MODEL_CONFIGS["llama-1b"]
        masters = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        state["cfg"], state["params"] = cfg, tfm.inference_params(masters)
    return state["cfg"], state["params"]


def _draft_2l(state: dict):
    """The speculative draft of the serving phases: llama-1b's width at 2
    layers, seed 2, cast once to bf16, kept in ``state``."""
    import torch

    from tpu_engine_torch.models import transformer as tfm

    if "draft" not in state:
        dcfg = _llama_1b(state)[0].with_(n_layers=2)
        state["draft"] = dcfg, tfm.inference_params(
            tfm.init_params(dcfg, torch.Generator(device="cuda").manual_seed(2), "cuda"))
    return state["draft"]


def _cached_logits(params, cfg, tokens, prompt: int, dtype):
    """Logits for tokens[:, :-1] by the cached path: one prefill of the first
    ``prompt`` tokens, then one-token decode steps, teacher-forced."""
    import torch

    from tpu_engine_torch import generate as tgen

    B, S = tokens.shape
    cache = tgen.init_cache(cfg, B, S, dtype=dtype)
    logits, cache = tgen.forward_with_cache(params, tokens[:, :prompt], cache, cfg, dtype)
    out = [logits]
    for t in range(prompt, S - 1):
        logits, cache = tgen.forward_with_cache(params, tokens[:, t:t + 1], cache, cfg, dtype)
        out.append(logits)
    return torch.cat(out, dim=1)


def _forward_logits(params, cfg, tokens, dtype):
    """The port's forward (plain attention) over ``tokens``."""
    import torch

    from tpu_engine_torch.models import transformer as tfm

    with torch.inference_mode():
        return tfm.forward(params, tokens, cfg, compute_dtype=dtype)


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def _stream_gaps(params, cfg, prompt: list, stream: list, dtype=None, pad_to: int = 1):
    """Teacher-forced through the port's forward in ``dtype`` (bf16 by
    default): each generated position's gap between its largest logit and
    the logit of the token the stream chose. ``pad_to`` pads the forward's
    input at its end to a multiple (the flash kernels take multiples of 64),
    which changes no earlier position under causal attention."""
    import torch

    toks = torch.tensor([list(prompt) + list(stream)], device="cuda")
    seq = toks[:, :-1]
    seq = torch.cat([seq, seq.new_zeros((1, -seq.shape[1] % pad_to))], dim=1)
    logits = _forward_logits(params, cfg, seq, dtype or torch.bfloat16)[
        0, len(prompt) - 1:toks.shape[1] - 1]
    chosen = logits.gather(1, toks[0, len(prompt):, None])[:, 0]
    return logits.max(dim=-1).values - chosen


def _stream_gap(params, cfg, prompt: list, stream: list, **kw) -> float:
    """The largest of :func:`_stream_gaps`."""
    return float(_stream_gaps(params, cfg, prompt, stream, **kw).max())


def _generate_and_hold(params, cfg, B: int, P: int, N: int):
    """``generate`` at batch B, prompt P, N new tokens, greedy, bf16, timed
    after a warm-up; its cached logits against forward (bf16, and fp32 with
    TF32 off over prompt 256 + 16 decode steps); its streams teacher-forced.
    Returns (prompt, tokens, seconds, numbers)."""
    import torch

    from tpu_engine_torch import generate as tgen

    bf16, f32 = torch.bfloat16, torch.float32
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    tgen.generate(params, prompt[:, :64], cfg, 4)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tgen.generate(params, prompt, cfg, N)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if not all(p.is_cuda and p.dtype == bf16 for p in params.values()) or not out.is_cuda:
        raise AssertionError("generate's parameters or tokens are not bf16 CUDA tensors")

    cached = _cached_logits(params, cfg, out, P, bf16)
    ref = _forward_logits(params, cfg, out[:, :-1], bf16)
    nums = {"logits_rel_err_bf16": _rel_err(cached, ref),
            "logits_max_abs_err_bf16": float((cached - ref).abs().max()),
            "max_abs_logit": float(ref.abs().max())}
    lg = ref[:, P - 1:]
    nums["greedy_max_gap"] = float(
        (lg.max(dim=-1).values - lg.gather(-1, out[:, P:, None])[..., 0]).max())
    del cached, ref, lg
    torch.backends.cuda.matmul.allow_tf32 = False
    p32 = {k: v.float() for k, v in params.items()}
    t32 = out[:, :256 + 17]
    nums["logits_rel_err_fp32"] = _rel_err(_cached_logits(p32, cfg, t32, 256, f32),
                                           _forward_logits(p32, cfg, t32[:, :-1], f32))
    del p32
    return prompt, out, gen_s, nums


def phase_generate(res: dict, state: dict) -> None:
    """``generate`` at batch 4, prompt 512, 128 new tokens, greedy, bf16
    (:func:`_generate_and_hold`); then ``speculative_generate`` at batch 1
    with a 2-layer draft of llama-1b's width, its rounds and its stream
    teacher-forced."""
    import torch

    from tpu_engine_torch import generate as tgen

    cfg, params = _llama_1b(state)
    B, P, N = GEN["batch"], GEN["prompt"], GEN["new"]
    prompt, out, gen_s, nums = _generate_and_hold(params, cfg, B, P, N)
    rel, max_abs, max_logit = (nums[k] for k in ("logits_rel_err_bf16",
                                                 "logits_max_abs_err_bf16", "max_abs_logit"))
    rel32, gap = nums["logits_rel_err_fp32"], nums["greedy_max_gap"]

    dcfg, draft = _draft_2l(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec, rounds = tgen.speculative_generate(params, draft, prompt[:1], cfg, dcfg, N,
                                             return_stats=True)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    spec_gap = _stream_gap(params, cfg, prompt[0].tolist(), spec[0, P:].tolist())
    out_row = res["generate"] = {
        "batch": B, "prompt": P, "new_tokens": N, "seconds": gen_s,
        "tokens_per_s": B * N / gen_s, "ms_per_token_step": gen_s / N * 1e3, **nums,
        "speculative": {"rounds": rounds, "seconds": spec_s, "max_gap": spec_gap,
                        "tokens_equal_to_greedy_row0": int((spec[0, P:] == out[0, P:]).sum())},
    }
    print(f"generate: batch {B}, prompt {P}, {N} new tokens in {gen_s:.3f} s "
          f"({B * N / gen_s:.1f} tokens/s, {gen_s / N * 1e3:.2f} ms a step)", flush=True)
    print(f"generate: cached vs forward logits, relative norm error bf16 {rel:.3e} "
          f"(bound {SERVE_REL['bf16']}; max |err| {max_abs:.3e}, bound {SERVE_ABS}, of max "
          f"|logit| {max_logit:.3f}), fp32 {rel32:.3e} "
          f"(bound {SERVE_REL['fp32']}); greedy streams teacher-forced: largest gap "
          f"{gap:.3e} (tau {SERVE_TAU})", flush=True)
    print(f"generate: speculative, batch 1, 2-layer draft, gamma 4: {rounds} rounds for {N} "
          f"tokens in {spec_s:.3f} s, largest gap {spec_gap:.3e}, "
          f"{out_row['speculative']['tokens_equal_to_greedy_row0']}/{N} equal to greedy",
          flush=True)
    for name, got, bound in (("bf16 logits", rel, SERVE_REL["bf16"]),
                             ("bf16 logits max |err|", max_abs, SERVE_ABS),
                             ("fp32 logits", rel32, SERVE_REL["fp32"]),
                             ("greedy gap", gap, SERVE_TAU), ("speculative gap", spec_gap,
                                                              SERVE_TAU)):
        if not got <= bound:
            raise AssertionError(f"generate {name}: {got:.3e} > {bound}")


def phase_generate_gemma(res: dict) -> None:
    """gemma-2b inference (seed-0 weights cast once to bf16; D 256 heads,
    MQA, the tied head): ``generate`` at batch 4, prompt 512, 64 new
    tokens, greedy, with its cached logits held to forward by relative norm
    error (SERVE_REL, bf16 and fp32) as ``generate`` is for llama-1b. Its
    max |error| and teacher-forced gaps are reported, not gated: at random
    init the tied head scores each token's own row near 25-40, where one
    bf16 step is 0.125-0.25, so llama-1b's absolute limits do not carry."""
    import torch

    from tpu_engine_torch.models import transformer as tfm

    cfg = tfm.MODEL_CONFIGS["gemma-2b"]
    params = tfm.inference_params(
        tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"))
    torch.cuda.empty_cache()
    B, P, N = GEN["batch"], GEN["prompt"], 64
    _, _, gen_s, nums = _generate_and_hold(params, cfg, B, P, N)
    res["generate_gemma"] = {"batch": B, "prompt": P, "new_tokens": N, "seconds": gen_s,
                             "tokens_per_s": B * N / gen_s,
                             "ms_per_token_step": gen_s / N * 1e3, **nums}
    print(f"generate_gemma: batch {B}, prompt {P}, {N} new tokens in {gen_s:.3f} s "
          f"({B * N / gen_s:.1f} tokens/s, {gen_s / N * 1e3:.2f} ms a step); cached vs "
          f"forward logits, relative norm error bf16 {nums['logits_rel_err_bf16']:.3e} "
          f"(bound {SERVE_REL['bf16']}; max |err| {nums['logits_max_abs_err_bf16']:.3e} of max "
          f"|logit| {nums['max_abs_logit']:.3f}), fp32 {nums['logits_rel_err_fp32']:.3e} "
          f"(bound {SERVE_REL['fp32']}); greedy gap {nums['greedy_max_gap']:.3e}", flush=True)
    for kind in ("bf16", "fp32"):
        if not nums[f"logits_rel_err_{kind}"] <= SERVE_REL[kind]:
            raise AssertionError(f"generate_gemma {kind} logits: "
                                 f"{nums[f'logits_rel_err_{kind}']:.3e} > {SERVE_REL[kind]}")


def _serve_plan(cfg) -> list:
    """16 requests from seed 0: prompt lengths 32-1536, 64-128 new tokens;
    SERVE_SHARED share a 512-token prefix, SERVE_SAMPLED sample at 0.8."""
    import numpy as np

    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    lengths, new = rng.integers(32, 1537, 16), rng.integers(64, 129, 16)
    prefix = rng.integers(1, V, 512).tolist()
    plan = []
    for i in range(16):
        if i in SERVE_SHARED:
            n = max(int(lengths[i]), 512 + 64)
            prompt = prefix + rng.integers(1, V, n - 512).tolist()
        else:
            prompt = rng.integers(1, V, int(lengths[i])).tolist()
        plan.append((prompt, int(new[i]), 0.8 if i in SERVE_SAMPLED else 0.0))
    return plan


def _serve_run(params, cfg, plan: list, key: str, mesh=None, **batcher) -> dict:
    """Serve ``plan`` with a ContinuousBatcher (SERVE_CFG, updated by
    ``batcher``) driven by ``serve_forever`` on a thread, as the router runs
    it. All requests are submitted before the thread starts: the first 8
    fill the slots and the rest queue, so what the server computes depends
    on the plan alone. Returns the streams, the first-token logits of
    prefix-cache hits, TTFT, throughput, the thread's device and stream,
    memory, and a timed and a profiled decode dispatch at 8 active slots: a
    ``decode_chunk``, or with a draft one ``speculative_round`` (its tokens
    counted at the run's mean acceptance). On a ``mesh`` (a rank of
    ``serve_mesh``) rank 0 submits and the other rank's thread serves until
    rank 0 stops; every rank times the dispatch (its collectives pair up)
    and none profiles it; the batcher's params (the rank's blocks) come
    back under ``"params"``."""
    import threading

    import numpy as np
    import torch

    from tpu_engine_torch import serving as tsrv

    main_dev, main_stream = torch.cuda.current_device(), torch.cuda.current_stream()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = tsrv.ContinuousBatcher(params, cfg, mesh=mesh, **{**SERVE_CFG, **batcher})
    lead = mesh is None or mesh.coords["model"] == 0
    first, hit_len, thread = {}, {}, {}
    real_first, real_step = srv._first_token, srv.step

    def first_token(logits, req):
        first[req.id] = logits.float().clone()
        return real_first(logits, req)

    def lookup(prompt):
        use, entry = real_lookup(prompt)
        hit_len[tuple(prompt)] = use
        return use, entry

    def step():
        thread.setdefault("device", torch.cuda.current_device())
        thread.setdefault("stream", torch.cuda.current_stream() == main_stream)
        return real_step()

    srv._first_token, srv.step = first_token, step
    if srv._prefix_cache is not None:
        real_lookup, srv._prefix_cache.lookup = srv._prefix_cache.lookup, lookup
    ids = ([srv.submit(p, max_new_tokens=m, temperature=t) for p, m, t in plan] if lead
           else list(range(len(plan))))
    stop = threading.Event()
    worker = threading.Thread(target=srv.serve_forever, args=(stop,), daemon=True)
    t0 = time.perf_counter()
    worker.start()
    if lead:
        results = [srv.wait(r, timeout=600) for r in ids]
    else:  # serves until rank 0 stops
        worker.join(timeout=SERVE_MESH_TIMEOUT_S)
        results = [srv.result(r) for r in ids]
    wall = time.perf_counter() - t0
    stats = srv.stats()
    stop.set()
    worker.join(timeout=60)
    pool, dpool = srv._cache, srv._draft_cache
    leak = {"active_slots": stats["active_slots"], "prefilling": stats["prefilling"],
            "queued": stats["queued"], "lengths": pool.lengths.tolist()}
    if dpool is not None:
        leak["draft_lengths"] = dpool.lengths.tolist()
    on_card = (pool.k.is_cuda and pool.lengths.is_cuda
               and all(p.is_cuda for p in srv.params.values()))
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in (pool.k, pool.v, pool.k_scale, pool.v_scale) if t is not None)

    # One decode dispatch for 8 active slots (greedy) from lane 1024, timed
    # on the host around a synchronize, then profiled.
    B = srv.max_slots
    z = torch.zeros(B, dtype=torch.int64, device="cuda")
    ones = torch.ones(B, dtype=torch.bool, device="cuda")
    if dpool is None:
        per_dispatch = srv.chunk_steps
        args = (srv.params, z, pool, ones, torch.zeros(B, device="cuda"), z, z, 0, cfg,
                srv.chunk_steps, srv._compute_dtype, mesh)
        decode = tsrv.decode_chunk
    else:
        per_dispatch = stats["spec_tokens_accepted"] / stats["spec_rounds"]
        args = (srv.params, srv._draft_params, z, pool, dpool, ones, cfg, srv._draft_cfg,
                srv.spec_gamma)
        decode = tsrv.speculative_round

    def dispatch():
        for p in (pool, dpool):
            if p is not None:
                p.lengths.fill_(1024)
        decode(*args)
        torch.cuda.synchronize()

    dispatch()
    times = []
    for _ in range(5 if mesh is None else 2):  # a mesh's dispatch waits on the wire
        t1 = time.perf_counter()
        dispatch()
        times.append((time.perf_counter() - t1) * 1e3)
    prof = (_profile(dispatch, f"serve {key} decode dispatch") if mesh is None
            else {"device_ms": float("nan"), "wall_ms": float("nan")})
    ttft = [r.get("ttft_ms", float("nan")) for r in results]
    tokens = [r["tokens"] for r in results]
    n_tok = sum(len(t) for t in tokens)
    out = {
        "kv_quant": srv.kv_quant, "statuses": [r["status"] for r in results], "tokens": tokens,
        "wall_s": wall, "tokens_generated": n_tok, "tokens_per_s": n_tok / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "ttft_ms": ttft, "prefix_cache": stats.get("prefix_cache"), "slot_state": leak,
        "on_card": on_card, "thread": thread, "main_device": main_dev,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "kv_bytes": kv_bytes,
        "dispatch_ms_each": times, "dispatch_ms": min(times),
        "decode_tokens_per_s": B * per_dispatch / (min(times) / 1e3),
        "dispatch_profile": prof, "device_ms_dispatch": prof["device_ms"],
        "device_busy_share": prof["device_ms"] / prof["wall_ms"],
        "device_busy_share_unprofiled_wall": prof["device_ms"] / min(times),
        "hits": {ids[i]: hit_len.get(tuple(p), 0) for i, (p, _, _) in enumerate(plan)},
        "first_logits": first, "tokens_per_dispatch_per_slot": per_dispatch,
        "spec": {k: v for k, v in stats.items() if k.startswith("spec_")},
    }
    if mesh is not None:
        out["params"] = srv.params
    prefix = {k: v for k, v in (out["prefix_cache"] or {}).items() if k != "entry_hits"}
    print(f"serve {key}: {len(ids)} requests, {n_tok} tokens in {wall:.2f} s "
          f"({out['tokens_per_s']:.1f} tokens/s), TTFT p50 {out['ttft_ms_p50']:.1f} ms, "
          f"p99 {out['ttft_ms_p99']:.1f} ms; decode dispatch ({per_dispatch:.3f} tokens a "
          f"slot, {B} active slots) {out['dispatch_ms']:.2f} ms "
          f"({out['decode_tokens_per_s']:.1f} tokens/s), device busy "
          f"{out['device_ms_dispatch']:.2f} ms: "
          f"{out['device_busy_share']:.3f} of the profiled wall, "
          f"{out['device_busy_share_unprofiled_wall']:.3f} of the unprofiled; peak "
          f"{out['peak_mem_gib']:.2f} GiB, KV pool {kv_bytes / 2**30:.3f} GiB; prefix cache "
          f"{json.dumps(prefix)}; {json.dumps(out['spec'])}", flush=True)
    return out


def _pool_logits(params, cfg, prompts: list, teacher, kv_quant: bool, dtype, mesh=None):
    """Logits of a slot pool (8 rows, SERVE_CFG's size, compute ``dtype``)
    fed each prompt by prefill and then ``teacher`` [8, K] one token per
    step: [K, 8, V]. ``mesh``: ``params`` are the rank's blocks, the pool
    its kv heads; the logits come back whole."""
    import torch

    from tpu_engine_torch import generate as tgen
    from tpu_engine_torch import serving as tsrv

    pool = tsrv.init_slot_cache(cfg, len(prompts), SERVE_CFG["max_len"], dtype,
                                prefill_chunk=SERVE_CFG["prefill_chunk"], kv_quant=kv_quant,
                                mesh=mesh)
    with torch.inference_mode():
        for slot, prompt in enumerate(prompts):
            c1 = tgen.init_cache(cfg, 1, len(prompt), dtype, kv_quant=kv_quant, mesh=mesh)
            _, c1 = tgen.forward_with_cache(params, torch.tensor([prompt], device="cuda"), c1,
                                            cfg, dtype, want_logits=False, mesh=mesh)
            tsrv._insert_prefill(pool, c1, slot, len(prompt))
        active = torch.ones(len(prompts), dtype=torch.bool, device="cuda")
        out = []
        for t in range(teacher.shape[1]):
            logits, pool = tsrv.decode_step(params, teacher[:, t], pool, active, cfg, dtype,
                                            mesh)
            out.append(logits)
    return torch.stack(out)


def _int8_pool_error(params, cfg, prompts: list, teacher, dtype) -> dict:
    """The int8 pool's logits against the full-precision pool's in compute
    ``dtype``: max |difference| as a share of max |logit|, and the relative
    norm error."""
    lq = _pool_logits(params, cfg, prompts, teacher, True, dtype)
    lf = _pool_logits(params, cfg, prompts, teacher, False, dtype)
    return {"share": float((lq - lf).abs().max() / lf.abs().max()), "rel": _rel_err(lq, lf)}


def phase_serve(res: dict, state: dict) -> None:
    """The continuous-batching server at llama-1b: 16 requests (SERVE_CFG,
    :func:`_serve_plan`) with the bf16 pool, the int8 pool and the bf16
    pool again. Checks: every request done and no slot left busy; pool and
    parameters on the card, the engine thread on the caller's device and
    stream; greedy streams of both pools teacher-forced within SERVE_TAU;
    prefix hits, and a hit's first-token logits within SERVE_REL of forward
    over its prompt; the int8 pool's logits within INT8_SHARE of max |logit|
    of the full-precision pool's, in bf16 and in fp32 compute; the repeat's
    tokens equal to the first run's."""
    import torch

    cfg, params = _llama_1b(state)
    plan = _serve_plan(cfg)
    runs = {key: _serve_run(params, cfg, plan, key, kv_quant=kv_quant)
            for key, kv_quant in (("bf16", False), ("int8", True), ("bf16_repeat", False))}
    bf = runs["bf16"]
    fails = []
    for key, r in runs.items():
        if r["statuses"] != ["done"] * len(plan):
            fails.append(f"{key}: statuses {r['statuses']}")
        if _slots_left_busy(r):
            fails.append(f"{key}: slots left busy {r['slot_state']}")
        if not r["on_card"]:
            fails.append(f"{key}: pool or parameters not on the card")
        if r["thread"] != {"device": r["main_device"], "stream": True}:
            fails.append(f"{key}: engine thread on {r['thread']}, want device {r['main_device']} "
                         "and the caller's stream")
    if runs["bf16_repeat"]["tokens"] != bf["tokens"]:
        fails.append("bf16 repeat: tokens differ from the first run")

    gaps = [_stream_gap(params, cfg, p, toks)
            for key in ("bf16", "int8")
            for (p, _, t), toks in zip(plan, runs[key]["tokens"]) if t == 0.0]
    hits = {rid: use for rid, use in bf["hits"].items() if use}
    hit_rel = {rid: _rel_err(bf["first_logits"][rid],
                             _forward_logits(params, cfg, torch.tensor([plan[rid][0]],
                                                                       device="cuda"),
                                             torch.bfloat16)[0, -1])
               for rid in hits}
    prompts = [p for p, _, _ in plan[:8]]
    teacher = torch.tensor([toks[:16] for toks in bf["tokens"][:8]], device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    int8 = {"bf16": _int8_pool_error(params, cfg, prompts, teacher, torch.bfloat16),
            "fp32": _int8_pool_error({k: v.float() for k, v in params.items()}, cfg, prompts,
                                     teacher, torch.float32)}
    if not max(gaps) <= SERVE_TAU:
        fails.append(f"greedy streams: largest teacher-forced gap {max(gaps):.3e} > {SERVE_TAU}")
    if not hits:
        fails.append("no prefix-cache hit")
    if hit_rel and not max(hit_rel.values()) <= SERVE_REL["bf16"]:
        fails.append(f"hit first-token logits vs forward {hit_rel} > {SERVE_REL['bf16']}")
    for kind, e in int8.items():
        if not e["share"] <= INT8_SHARE[kind]:
            fails.append(f"int8 pool logits ({kind}): {e['share']:.3e} of max |logit| > "
                         f"{INT8_SHARE[kind]}")
    print(f"serve checks: every request done in each run; greedy streams (bf16 and int8 "
          f"pools) teacher-forced, "
          f"largest gap {max(gaps):.3e} (tau {SERVE_TAU}); prefix hits {hits} (tokens), "
          "first-token logits vs forward "
          f"{json.dumps({k: round(v, 6) for k, v in hit_rel.items()})}"
          f" (bound {SERVE_REL['bf16']}); int8 pool vs full-precision pool, max |diff| of max "
          f"|logit| / relative norm: " + ", ".join(
              f"{k} {e['share']:.3e} (bound {INT8_SHARE[k]}) / {e['rel']:.3e}"
              for k, e in int8.items()) + "; repeat identical "
          f"{runs['bf16_repeat']['tokens'] == bf['tokens']}; engine thread {bf['thread']}",
          flush=True)
    for r in runs.values():
        r.pop("first_logits")
        r["hits"] = {str(k): v for k, v in r["hits"].items()}
    res["serve"] = {"config": SERVE_CFG, "runs": runs, "greedy_max_gap": max(gaps),
                    "hit_first_logits_rel_err": {str(k): v for k, v in hit_rel.items()},
                    "int8_vs_full_precision": int8, "card": res.get("card")}
    if fails:
        raise AssertionError("; ".join(fails))


def _slots_left_busy(r: dict) -> bool:
    leak = r["slot_state"]
    return bool(leak["active_slots"] or leak["prefilling"] or leak["queued"]
                or any(leak["lengths"]) or any(leak.get("draft_lengths", ())))


def _spec_plan(cfg) -> list:
    """:func:`_serve_plan`'s 16 prompts, all greedy (a speculative server
    refuses sampling)."""
    return [(p, m, 0.0) for p, m, _ in _serve_plan(cfg)]


def spec_frontier(params, cfg, dparams, dcfg, prompts: list, rounds: int = 8) -> dict:
    """``speculative_round`` driven directly on one slot per prompt, from a
    prefill of each prompt into both pools: after every round both pools
    must hold every token but the last emitted one, so each slot's length
    must equal its prompt plus the tokens accepted so far. Returns the
    rounds in which either pool was off that frontier, and the mean
    accepted tokens per round."""
    import torch

    from tpu_engine_torch import generate as tgen
    from tpu_engine_torch import serving as tsrv

    bf16, n = torch.bfloat16, len(prompts)
    pools = [tsrv.init_slot_cache(c, n, SPEC_CFG["max_len"], bf16,
                                  prefill_chunk=SPEC_CFG["prefill_chunk"]) for c in (cfg, dcfg)]
    first = []
    with torch.inference_mode():
        for slot, p in enumerate(prompts):
            toks = torch.tensor([p], device="cuda")
            for pool, pp, c in zip(pools, (params, dparams), (cfg, dcfg)):
                c1 = tgen.init_cache(c, 1, len(p), bf16)
                logits, c1 = tgen.forward_with_cache(pp, toks, c1, c, bf16,
                                                     want_logits=pool is pools[0])
                tsrv._insert_prefill(pool, c1, slot, len(p))
                if logits is not None:
                    first.append(logits[0, -1].argmax())
        frontier = torch.tensor([len(p) for p in prompts], device="cuda")
        toks, active = torch.stack(first), torch.ones(n, dtype=torch.bool, device="cuda")
        off, accepted = 0, 0
        for _ in range(rounds):
            tgt, n_acc, *pools = tsrv.speculative_round(params, dparams, toks, *pools, active,
                                                        cfg, dcfg, SPEC_CFG["spec_gamma"])
            frontier += n_acc
            off += not all(torch.equal(p.lengths, frontier) for p in pools)
            accepted += int(n_acc.sum())
            toks = tgt.gather(1, n_acc[:, None] - 1)[:, 0]
    return {"rounds": rounds, "rounds_off_frontier": off,
            "accepted_per_round": accepted / (rounds * n)}


def phase_serve_spec(res: dict, state: dict) -> None:
    """The batcher with a draft (SPEC_CFG) at llama-1b, serving
    :func:`_spec_plan` with the 2-layer draft and with llama-1b as its own
    draft. Checks: every request done and no slot left busy in either
    pool; greedy streams teacher-forced within SERVE_TAU; the own draft's
    mean accepted tokens per round at least SPEC_ACCEPT_MIN; both pools on
    the accepted frontier after every round (:func:`spec_frontier`, the
    plan's first 8 prompts, with each draft). Prints rounds,
    acceptance, TTFT and decode tokens/s beside the plain batcher's of the
    ``serve`` phase in this run."""
    cfg, params = _llama_1b(state)
    dcfg, draft = _draft_2l(state)
    plan = _spec_plan(cfg)
    runs = {key: _serve_run(params, cfg, plan, key, draft_params=dp, draft_cfg=dc, **SPEC_CFG)
            for key, dp, dc in (("draft_2l", draft, dcfg), ("own_draft", params, cfg))}
    fails, out = [], {}
    for key, r in runs.items():
        if r["statuses"] != ["done"] * len(plan):
            fails.append(f"{key}: statuses {r['statuses']}")
        if _slots_left_busy(r):
            fails.append(f"{key}: slots left busy {r['slot_state']}")
        gaps = [_stream_gap(params, cfg, p, toks) for (p, _, _), toks in zip(plan, r["tokens"])]
        out[key] = {**{k: r[k] for k in ("tokens_generated", "tokens_per_s", "ttft_ms_p50",
                                          "ttft_ms_p99", "dispatch_ms", "decode_tokens_per_s",
                                          "device_busy_share", "peak_mem_gib", "slot_state")},
                    **r["spec"], "accepted_per_round": r["tokens_per_dispatch_per_slot"],
                    "greedy_max_gap": max(gaps), "gaps": gaps}
        if not max(gaps) <= SERVE_TAU:
            fails.append(f"{key}: largest teacher-forced gap {max(gaps):.3e} > {SERVE_TAU}")
        dp, dc = (draft, dcfg) if key == "draft_2l" else (params, cfg)
        out[key]["frontier"] = spec_frontier(params, cfg, dp, dc, [p for p, _, _ in plan[:8]])
        if out[key]["frontier"]["rounds_off_frontier"]:
            fails.append(f"{key}: pools off the accepted frontier {out[key]['frontier']}")
    own = out["own_draft"]["accepted_per_round"]
    if not own >= SPEC_ACCEPT_MIN:
        fails.append(f"own draft: {own:.3f} accepted tokens a round < {SPEC_ACCEPT_MIN}")
    plain = res.get("serve", {}).get("runs", {}).get("bf16", {})
    for key, o in out.items():
        print(f"serve_spec {key}: {o['spec_rounds']} slot-rounds, {o['accepted_per_round']:.3f} "
              f"accepted tokens a round (of {SPEC_CFG['spec_gamma'] + 1}), largest gap "
              f"{o['greedy_max_gap']:.3e} (tau {SERVE_TAU}); {o['tokens_per_s']:.1f} tokens/s "
              f"end to end, decode {o['decode_tokens_per_s']:.1f} tokens/s, TTFT p50 "
              f"{o['ttft_ms_p50']:.1f} ms, p99 {o['ttft_ms_p99']:.1f} ms; frontier check "
              f"{json.dumps(o['frontier'])}", flush=True)
    if plain:
        print(f"serve_spec: plain batcher (serve bf16, sampled rows included): "
              f"{plain['tokens_per_s']:.1f} tokens/s end to end, decode "
              f"{plain['decode_tokens_per_s']:.1f} tokens/s, TTFT p50 {plain['ttft_ms_p50']:.1f} "
              f"ms, p99 {plain['ttft_ms_p99']:.1f} ms", flush=True)
    print(f"serve_spec checks: own draft {own:.3f} accepted a round (bound {SPEC_ACCEPT_MIN})",
          flush=True)
    res["serve_spec"] = {"config": SPEC_CFG, "runs": out, "accept_min": SPEC_ACCEPT_MIN,
                         "card": res.get("card"),
                         "plain": {k: plain.get(k) for k in ("tokens_per_s", "ttft_ms_p50",
                                                             "decode_tokens_per_s", "ttft_ms_p99")}}
    if fails:
        raise AssertionError("; ".join(fails))


def phase_hf_bridge(res: dict, state: dict) -> None:
    """llama-1b's bf16 inference weights on the card → ``to_hf_llama`` (HF
    layout, float32 numpy) → ``from_hf_llama`` back to bf16 on the card:
    every tensor bitwise equal, and forward's logits on one 512-token prompt
    bitwise equal before and after. No ``transformers`` is needed."""
    import torch

    from tpu_engine_torch.models import convert

    cfg, params = _llama_1b(state)
    t0 = time.perf_counter()
    sd = convert.to_hf_llama(params, cfg)
    t1 = time.perf_counter()
    back = convert.from_hf_llama(sd, cfg, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    same = list(back) == list(params) and all(
        back[k].dtype == params[k].dtype and back[k].is_cuda and torch.equal(back[k], params[k])
        for k in params)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))
    before = _forward_logits(params, cfg, tokens, torch.bfloat16)
    after = _forward_logits(back, cfg, tokens, torch.bfloat16)
    logits_same = torch.equal(before, after)
    res["hf_bridge"] = {"hf_tensors": len(sd), "to_hf_s": t1 - t0, "from_hf_s": t2 - t1,
                        "weights_bitwise_equal": same, "logits_bitwise_equal": logits_same}
    print(f"hf_bridge: {cfg.name}, {len(sd)} HF tensors; to_hf_llama {t1 - t0:.2f} s, "
          f"from_hf_llama {t2 - t1:.2f} s; weights bitwise equal {same}, logits of a "
          f"512-token prompt bitwise equal {logits_same}", flush=True)
    del sd, back
    if not (same and logits_same):
        raise AssertionError(f"hf_bridge: round trip not exact {res['hf_bridge']}")


def _route_recorder(routes: list, k: int):
    """A stand-in for ``transformer._router_probs`` that also appends each
    call's top-``k`` expert sets (sorted ids, [tokens, k]) to ``routes``."""
    import torch

    from tpu_engine_torch.models import transformer as tfm

    real = tfm._router_probs

    def record(h, lp):
        probs = real(h, lp)
        top = torch.topk(probs.detach().reshape(-1, probs.shape[-1]), k, dim=-1).indices
        routes.append(top.sort(dim=-1).values)
        return probs

    return record


def _moe_dense_vs_ragged(cfg, mcfg) -> dict:
    """The training loss's forward and backward at MOE_NO_DROP_CF from the
    seed-0 weights and batch, by dense and by ragged dispatch, in fp32
    (TF32 off) and in bf16 compute: loss, logits, every gradient, and the
    tokens whose top-k experts differ between the two in some layer."""
    from dataclasses import replace

    import torch

    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.train import accumulate_grads, build_train_program

    mcfg = mcfg.with_(capacity_factor=MOE_NO_DROP_CF)
    if mcfg.expert_capacity(cfg.seq_len) < cfg.seq_len:
        raise AssertionError("MOE_NO_DROP_CF leaves a capacity below the sequence")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for precision in ("fp32", "bf16"):
        params, runs = None, {}
        for impl in ("dense", "ragged"):
            prog = build_train_program(replace(cfg, precision=precision, moe_impl=impl),
                                       model_cfg=mcfg, device="cuda")
            if params is None:
                params = tfm.init_params(prog.model_config,
                                         torch.Generator(device="cuda").manual_seed(0), "cuda")
                batch = prog.synthetic_batch(seed=0)
            routes: list = []
            real, tfm._router_probs = tfm._router_probs, _route_recorder(routes, mcfg.top_k)
            try:
                loss, grads = accumulate_grads(prog.loss_fn, params, batch)
                loss = float(loss)
                with torch.no_grad():
                    logits = tfm.forward(params, batch[0], prog.model_config,
                                         compute_dtype=prog.config.compute_dtype())
            finally:
                tfm._router_probs = real
            runs[impl] = {"loss": loss, "logits": logits, "routes": routes[-mcfg.n_layers:],
                          "grads": grads}
        d, r = runs["dense"], runs["ragged"]
        differ = torch.stack([(a != b).any(dim=-1) for a, b in zip(d["routes"], r["routes"])])
        alike = ~differ.any(dim=0)
        V = d["logits"].shape[-1]
        out[precision] = {
            "loss": {"dense": d["loss"], "ragged": r["loss"]},
            "logits_rel_err": _rel_err(r["logits"], d["logits"]),
            "logits_rel_err_routed_alike": _rel_err(r["logits"].reshape(-1, V)[alike],
                                                    d["logits"].reshape(-1, V)[alike]),
            "tokens_rerouted_by_layer": differ.sum(dim=1).tolist(),
            "grad_rel_err": {k: _rel_err(g, d["grads"][k]) for k, g in r["grads"].items()},
        }
        del params, runs, d, r
        torch.cuda.empty_cache()
    return out


def _one_step(cfg, mcfg) -> dict:
    """One training step of ``cfg`` on ``mcfg`` from the seed-0 weights and
    batch (a fresh program), launches (the flash kernels' and
    ``torch._int_mm``'s) counted from 0 around it."""
    import torch

    from tpu_engine_torch import quant_train as qt
    from tpu_engine_torch.ops import _flash_cuda as fc
    from tpu_engine_torch.train import build_train_program

    prog = build_train_program(cfg, model_cfg=mcfg, device="cuda")
    state = prog.init()
    batch = prog.synthetic_batch(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launches()
    qt.reset_launches()
    t0 = time.perf_counter()
    state, m = prog.step(state, batch)
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    torch.cuda.synchronize()
    out = {"loss": loss, "grad_norm": norm, "step_ms": (time.perf_counter() - t0) * 1e3,
           "launches": {**fc.launches, **qt.launches},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    del state
    torch.cuda.empty_cache()
    return out


def phase_train_moe(res: dict, steps: int) -> None:
    """moe-8x7b (Mixtral-8x7B) at full width (d_model 4096, 32 query heads
    of 128, 8 kv heads, 8 experts of d_ff 14336, top 2, vocab 32000) and
    MOE_TRAIN_LAYERS layers, seq 2048 x micro-batch 2, bf16 compute, fp32
    masters, AdamW, checkpointing, flash attention (the bf16 D 128
    kernels), dense dispatch: the loss falls at every step, the aux loss of
    every step is finite and positive, and per step K1 runs 4 times (forward
    and the checkpoint's recompute), K2 and K3 twice. Then dense against
    ragged dispatch where nothing drops (:func:`_moe_dense_vs_ragged`,
    bounds at MOE_NO_DROP_CF) and one ragged step, whose loss must lie
    within FIRST_LOSS_REL of dense's bf16 loss on the same weights and
    batch, with the same launches."""
    from dataclasses import replace

    import torch

    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.train import TrainConfig, build_train_program

    L = MOE_TRAIN_LAYERS
    mcfg = tfm.MODEL_CONFIGS["moe-8x7b"].with_(n_layers=L)
    cfg = TrainConfig(model_name="moe-8x7b", micro_batch_size=2, gradient_accumulation_steps=1,
                      seq_len=2048, precision="bf16", param_dtype="fp32",
                      activation_checkpointing=True, attention_impl="auto", moe_impl="dense",
                      **TRAIN_LR)
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}

    def plain_loss(prog, state, batch) -> float:
        # At d_model 4096 the initial logits spread by 0.02·sqrt(4096): the
        # first loss lies near ln(vocab) + 0.82, past the plain check, so it
        # is held to the plain attention path's loss, aux included.
        plain = build_train_program(replace(cfg, attention_impl="xla"), model_cfg=mcfg,
                                    device="cuda")
        with torch.no_grad():
            loss = float(plain.loss_fn(state["params"], batch[0]))
        auxes.clear()  # the steps' aux losses are recorded from here on
        return loss

    auxes: list = []
    real = tfm.forward_hidden_and_aux

    def record_aux(*args, **kwargs):
        hidden, aux = real(*args, **kwargs)
        auxes.append(aux.detach())
        return hidden, aux

    tfm.forward_hidden_and_aux = record_aux
    try:
        _train(res, "train_moe", cfg, steps, "flash", want, first_loss_ref=plain_loss,
               model_cfg=mcfg)
    finally:
        tfm.forward_hidden_and_aux = real
    out = res["train_moe"]
    out["aux"] = [float(a) for a in auxes[:steps]]
    print(f"train_moe: aux losses {[round(a, 5) for a in out['aux']]}", flush=True)
    del auxes
    torch.cuda.empty_cache()
    fails = []
    if not all(math.isfinite(a) and a > 0 for a in out["aux"]):
        fails.append(f"aux losses {out['aux']} not finite and positive")

    cmp = out["dense_vs_ragged"] = _moe_dense_vs_ragged(cfg, mcfg)
    for precision, c in cmp.items():
        worst = max(c["grad_rel_err"], key=c["grad_rel_err"].get)
        print(f"train_moe: dense vs ragged at capacity factor {MOE_NO_DROP_CF} ({precision}): "
              f"loss {c['loss']['dense']:.6f} / {c['loss']['ragged']:.6f}, logits relative "
              f"{c['logits_rel_err']:.3e} (tokens routed alike "
              f"{c['logits_rel_err_routed_alike']:.3e}), tokens rerouted by layer "
              f"{c['tokens_rerouted_by_layer']}, largest gradient error {worst} "
              f"{c['grad_rel_err'][worst]:.3e}; "
              + " ".join(f"{k}={e:.2e}" for k, e in c["grad_rel_err"].items()), flush=True)
    f32, b16 = cmp["fp32"], cmp["bf16"]
    if not (max(f32["grad_rel_err"].values()) <= MODEL_REL["fp32"]
            and f32["logits_rel_err"] <= MODEL_REL["fp32"]):
        fails.append(f"fp32 dense vs ragged: logits {f32['logits_rel_err']:.3e}, gradients "
                     f"{max(f32['grad_rel_err'].values()):.3e} > {MODEL_REL['fp32']}")
    if not b16["logits_rel_err_routed_alike"] <= MODEL_REL["bf16"]:
        fails.append(f"bf16 dense vs ragged, tokens routed alike: logits "
                     f"{b16['logits_rel_err_routed_alike']:.3e} > {MODEL_REL['bf16']}")

    step = out["ragged_step"] = _one_step(replace(cfg, moe_impl="ragged"), mcfg)
    ref = b16["loss"]["dense"]
    print(f"train_moe: one ragged step: loss {step['loss']:.5f} (dense at capacity factor "
          f"{MOE_NO_DROP_CF}: {ref:.5f}), {step['step_ms']:.1f} ms, launches {step['launches']}",
          flush=True)
    if not abs(step["loss"] - ref) <= FIRST_LOSS_REL * ref:
        fails.append(f"ragged step loss {step['loss']} vs dense {ref}")
    if {k: v for k, v in step["launches"].items() if v} != want:
        fails.append(f"ragged step launches {step['launches']} != {want}")
    if fails:
        raise AssertionError("; ".join(fails))


def _moe_int8_tree(cfg, seed: int = 0) -> dict:
    """``cfg``'s (moe-8x7b's) weight-only int8 serving tree, built on the
    card one layer at a time: seeded random fp32 weights at JAX's init
    scales (normal 0.02; o and the down experts 0.02/sqrt(2L); norm scales
    1), each kernel quantized as it is drawn (``quantize_weight``), the
    embedding in bf16 and the router in fp32. Neither the fp32 tree (187
    GB) nor the bf16 one (93 GB) fits the card."""
    import torch

    from tpu_engine_torch.models.convert import param_keys
    from tpu_engine_torch.quant import QuantWeight, quantize_weight

    gen = torch.Generator(device="cuda").manual_seed(seed)
    L, D, V, F_, E = cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.d_ff, cfg.n_experts
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std, res_std = 0.02, 0.02 / (2 * L) ** 0.5

    def draw(shape, s):
        return torch.empty(shape, device="cuda").normal_(0.0, s, generator=gen)

    def int8(shape, s) -> QuantWeight:
        q = torch.empty((L, *shape), dtype=torch.int8, device="cuda")
        scale = torch.empty((L, *shape[:-2], 1, shape[-1]), device="cuda")
        for i in range(L):
            w = quantize_weight(draw(shape, s))
            q[i], scale[i] = w.q, w.scale
        return QuantWeight(q, scale)

    kernels = {"q": ((D, H * HD), std), "k": ((D, KV * HD), std), "v": ((D, KV * HD), std),
               "o": ((H * HD, D), res_std), "gate": ((E, D, F_), std), "up": ((E, D, F_), std),
               "down": ((E, F_, D), res_std)}
    tree: dict = {}
    for key in param_keys(cfg):
        name = key.split(".")[1]
        if key == "embed.embedding":
            tree[key] = draw((V, D), std).to(torch.bfloat16)
        elif key == "lm_head.kernel":
            tree[key] = quantize_weight(draw((D, V), std))
        elif key == "final_norm.scale":
            tree[key] = torch.ones(D, device="cuda")
        elif key.endswith("norm.scale"):
            tree[key] = torch.ones((L, D), device="cuda")
        elif key == "layers.router.kernel":
            tree[key] = draw((L, D, E), std)
        else:
            tree[key] = int8(*kernels[name])
    return tree


def _serve_moe_plan(cfg) -> list:
    """16 greedy requests from seed 0: prompts of 128-512 tokens, 64 new
    tokens each."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [(rng.integers(1, cfg.vocab_size, int(n)).tolist(), 64, 0.0)
            for n in rng.integers(128, 513, 16)]


def _streams(params, cfg, plan: list, **batcher) -> tuple[list, dict]:
    """Every request of ``plan`` served to its end by a batcher of
    SERVE_CFG updated by ``batcher``, driven by ``step`` on this thread;
    the token streams and the batcher's stats."""
    from tpu_engine_torch import serving as tsrv

    srv = tsrv.ContinuousBatcher(params, cfg, **{**SERVE_CFG, **batcher})
    ids = [srv.submit(p, max_new_tokens=m, temperature=t) for p, m, t in plan]
    while any(srv.result(r)["status"] not in ("done", "failed") for r in ids):
        srv.step()
    results = [srv.result(r) for r in ids]
    if any(r["status"] != "done" for r in results):
        raise AssertionError(f"statuses {[r['status'] for r in results]}")
    return [r["tokens"] for r in results], srv.stats()


def _moe_gaps(params, cfg, plan: list, tokens: list, dtype) -> dict:
    """Every generated position's teacher-forced gap (:func:`_stream_gaps`)
    through forward of ``params`` with ragged dispatch and flash attention
    in ``dtype``; their median, 90th and 99th percentiles, largest, and the
    share within SERVE_MOE_FP32's gap."""
    import torch

    teacher = cfg.with_(moe_impl="ragged", attention_impl="flash")
    gaps = torch.cat([_stream_gaps(params, teacher, p, t, dtype=dtype, pad_to=64)
                      for (p, _, _), t in zip(plan, tokens)]).float()
    q = torch.quantile(gaps, torch.tensor([0.5, 0.9, 0.99], device=gaps.device)).tolist()
    return {"median": q[0], "p90": q[1], "p99": q[2], "max": float(gaps.max()),
            "share_within": float((gaps <= SERVE_MOE_FP32["gap"]).float().mean()),
            "positions": gaps.numel()}


def _moe_fp32_check(params, cfg, plan: list) -> dict:
    """SERVE_MOE_FP32's run: its first requests with fewer tokens, one
    token a dispatch, served and teacher-forced in fp32 with TF32 off."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    short = [(p, SERVE_MOE_FP32["tokens"], t) for p, _, t in plan[:SERVE_MOE_FP32["requests"]]]
    tokens, _ = _streams(params, cfg, short, **dict(SERVE_MOE_CFG, chunk_steps=1,
                                                    compute_dtype=torch.float32))
    return _moe_gaps(params, cfg, short, tokens, torch.float32)


def phase_serve_moe(res: dict) -> None:
    """moe-8x7b at full width and SERVE_MOE_L of its 32 layers (8 experts,
    top 2) in weight-only int8 on one card (:func:`_moe_int8_tree`), served by the
    ContinuousBatcher (SERVE_MOE_CFG: 8 slots of 2048 lanes, bf16 pool, 8
    tokens a dispatch, on a ``serve_forever`` thread) for 16 greedy
    requests (:func:`_serve_moe_plan`). Decode runs every expert and
    combines with the renormalised top-k gates (JAX's MoE decode). Checks:
    every request done, no slot left busy, pool and parameters on the card;
    the median of the streams' teacher-forced gaps (forward of the same
    int8 tree, ragged dispatch, flash attention) within SERVE_MOE_TAU; K1
    launched once per layer per teacher forward, the counters set to 0
    before the batcher starts and read after the last teacher forward; and
    SERVE_MOE_FP32's run in fp32 compute (:func:`_moe_fp32_check`)."""
    import torch

    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.ops import _flash_cuda as fc
    from tpu_engine_torch.quant import dequantize_weight, quantized_param_bytes

    cfg = tfm.MODEL_CONFIGS["moe-8x7b"].with_(n_layers=SERVE_MOE_L)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = _moe_int8_tree(cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    nbytes = quantized_param_bytes(params)
    # The one-pass dequantisation against JAX's two steps (fp32 product,
    # then one rounding), on layer 0's gate experts.
    w = params["layers.gate.kernel"][0]
    dequant_exact = torch.equal(dequantize_weight(w, torch.bfloat16),
                                (w.q.float() * w.scale).to(torch.bfloat16))
    plan = _serve_moe_plan(cfg)
    fc.reset_launches()
    run = _serve_run(params, cfg, plan, "moe_int8", **SERVE_MOE_CFG)
    gaps = _moe_gaps(params, cfg, plan, run["tokens"], torch.bfloat16)
    counts = dict(fc.launches)
    want = {name: (cfg.n_layers * len(plan) if name == "flash_fwd" else 0) for name in counts}
    fp32 = _moe_fp32_check(params, cfg, plan)
    run.pop("first_logits")
    run["hits"] = {str(k): v for k, v in run["hits"].items()}
    out = res["serve_moe"] = {
        "config": SERVE_MOE_CFG, "run": run, "quantized_param_bytes": nbytes,
        "tree_build_s": build_s, "dequant_exact": dequant_exact, "gaps_bf16": gaps,
        "gaps_fp32": fp32, "tau": SERVE_MOE_TAU,
        "fp32_bound": SERVE_MOE_FP32, "launches": counts, "launches_expected": want,
        "steps": len(plan), "accum": 1, "card": res.get("card")}
    print(f"serve_moe: int8 tree {nbytes / 2**30:.2f} GiB (quantized_param_bytes {nbytes}), "
          f"built in {build_s:.1f} s, dequantisation exact {dequant_exact}; peak "
          f"{run['peak_mem_gib']:.2f} GiB; decode "
          f"{run['decode_tokens_per_s']:.1f} tokens/s ({run['dispatch_ms']:.1f} ms a dispatch of "
          f"{SERVE_MOE_CFG['chunk_steps']} tokens a slot, {run['dispatch_profile']['launches']} "
          f"launches, busy {run['device_busy_share']:.3f}); TTFT p50 "
          f"{run['ttft_ms_p50']:.1f} ms, p99 {run['ttft_ms_p99']:.1f} ms; teacher-forced gaps, "
          f"bf16: median {gaps['median']:.4f} (tau {SERVE_MOE_TAU}), p90 {gaps['p90']:.4f}, p99 "
          f"{gaps['p99']:.4f}, max {gaps['max']:.4f}; fp32 ({fp32['positions']} positions): "
          f"{fp32['share_within']:.4f} within {SERVE_MOE_FP32['gap']} (bound "
          f"{SERVE_MOE_FP32['share']}), max {fp32['max']:.4f}; launches {counts}", flush=True)
    fails = []
    if not dequant_exact:
        fails.append("dequantize_weight differs from (q.float() * scale).to(bf16)")
    if run["statuses"] != ["done"] * len(plan):
        fails.append(f"statuses {run['statuses']}")
    if _slots_left_busy(run):
        fails.append(f"slots left busy {run['slot_state']}")
    if not run["on_card"]:
        fails.append("pool or parameters not on the card")
    if not gaps["median"] <= SERVE_MOE_TAU:
        fails.append(f"median teacher-forced gap {gaps['median']:.4f} > {SERVE_MOE_TAU}")
    if not fp32["share_within"] >= SERVE_MOE_FP32["share"]:
        fails.append(f"fp32: {fp32['share_within']:.4f} of positions within "
                     f"{SERVE_MOE_FP32['gap']} < {SERVE_MOE_FP32['share']}")
    if counts != want:
        fails.append(f"launch counts {counts} != expected {want}")
    del params, run, w
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError("; ".join(fails))


# Quantised training, LoRA, the other optimizers and the remat policies
# (train_int8, train_lora, train_opt, remat). Every bound below is set from
# train_faults.py, which plants a fault in each and reads the same checks
# beside the sound code; the readings are written beside each bound.
#
# train_int8: train's llama-1b with the attention and MLP products in int8.
# The int8 path is held against the bf16 path on the same initial weights
# and batch: the logits by relative norm error (INT8_LOGITS_REL), the first
# loss (INT8_LOSS_REL, relative) and each targeted group's weight gradients
# by cosine (INT8_GRAD_COS). INT8_BIAS_RATIO holds the backward's rounding
# unbiased: over INT8_BIAS_DRAWS backward products of one projection (fp32
# operands, one element of each moved per draw, so the data-derived salts
# change), the error of the mean against the mean exact product, over the
# mean single-draw error, is about 1/sqrt(draws) when the draws' errors are
# zero-mean and independent, and about 1 when they are not. Readings on an
# H100 (NVIDIA H100 80GB HBM3, 700 W; train_faults.py), sound / per-tensor
# scales / the scales' outer product dropped: logits 0.122 / 0.310 / 1.23,
# first loss 1.5e-5 / 1.7e-4 / 1.7e-4 (random weights put every loss near
# ln(vocab) + 0.4), gradient cosines attn 0.984 / 0.912 / NaN and mlp 0.982
# / 0.889 / 0.004; the ratio 0.250 sound, 1.000 with the backward rounding
# to nearest. Each bound lies midway between the sound reading and the
# nearer fault's.
INT8_TARGETS = ("attn", "mlp")
INT8_LOGITS_REL = 0.21
INT8_LOSS_REL = 9e-5
INT8_GRAD_COS = 0.95
INT8_BIAS_DRAWS = 16
INT8_BIAS_RATIO = 0.62
# Every spec of the int8 product at sizes the card's int8 GEMM refuses
# unpadded (M <= 16 or K, N not multiples of 8; the MoE contraction b·c
# 26): the card's forward against the CPU's (the same codes, int32 sums
# and fp32 scaling), its gradients against fp32 products by cosine.
INT8_ODD_SPECS = (("bsi,io->bso", (3, 37, 100), (100, 52)),
                  ("bsi,io->bso", (1, 5, 60), (60, 7)),
                  ("ebcd,edf->ebcf", (3, 2, 13, 100), (3, 100, 52)),
                  ("ebcf,efd->ebcd", (3, 2, 13, 52), (3, 52, 100)))
# train_lora: llama-7b at full width and depth, its fp32 base frozen, LoRA
# rank 16 on q/k/v/o at alpha 32 (scale 2, so a dropped scale shows), seq
# 2048 x micro-batch 2, bf16 compute. At 1e-3 the loss on the repeated
# batch rose again at the fourth step; 1e-4 keeps it falling. After the
# steps, merged_params' bf16 logits are held to the adapter forward's by
# relative norm error, LORA_MERGED_REL: the merged kernels round W + 2·A@B
# to bf16 once where the adapter path adds 2·(h@A)@B to a bf16 product, and
# 32 layers amplify the difference, so MODEL_REL["bf16"] (2e-2, set on a
# 2-layer llama) is missed by sound code. Readings on an H100 (NVIDIA H100
# 80GB HBM3, 700 W; train_faults.py, 5 steps): sound 0.066, the LoRA scale
# left out of the projections 0.751; the bound lies midway.
LORA = dict(lora_rank=16, lora_alpha=32.0, lora_targets=("q", "k", "v", "o"))
LORA_LR = dict(learning_rate=1e-4, warmup_steps=1, lr_schedule="constant")
LORA_MERGED_REL = 0.4
# remat: train's llama-1b for REMAT_STEPS steps under each policy. Losses
# and gradient norms must equal nothing_saveable's bitwise. What a policy
# keeps is read as the device memory a microbatch's forward leaves
# allocated: a named policy must keep at least REMAT_TAG_SHARE of the bytes
# of its tagged tensors (bf16, every layer) more than nothing_saveable.
# offload_dots keeps the dots policies' products in pinned host memory: its
# every initial gradient must equal nothing_saveable's bitwise, and the
# device bytes a forward keeps must stay under REMAT_DOTS_KEPT_GIB
# (dots_saveable's 8.452 GiB on this path, PERF.md §5).
REMAT_STEPS = 3
REMAT_RUN = ("nothing_saveable", "everything_saveable", "dots_saveable",
             "dots_with_no_batch_dims_saveable", "save_qkv_attn_out", "save_attn_out",
             "offload_dots")
REMAT_TAG_SHARE = 0.5
REMAT_DOTS_KEPT_GIB = 8.452


def int8_readings(cfg, device="cuda") -> dict:
    """``cfg`` (int8) against the same configuration in bf16 on the seed's
    initial weights and synthetic batch: logits of the first microbatch by
    relative norm error, the first loss, and each targeted group's weight
    gradients by cosine."""
    from dataclasses import replace

    import torch

    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.train import accumulate_grads, build_train_program

    progs = {"bf16": build_train_program(replace(cfg, quant_training="none"), device=device),
             "int8": build_train_program(cfg, device=device)}
    mcfg = progs["bf16"].model_config
    params = tfm.init_params(mcfg, torch.Generator(device=device).manual_seed(cfg.seed), device)
    batch = progs["bf16"].synthetic_batch(seed=0)
    logits = {}
    with torch.no_grad():
        for name, prog in progs.items():
            hidden, _ = tfm.forward_hidden_and_aux(params, batch[0], prog.model_config,
                                                   compute_dtype=cfg.compute_dtype())
            logits[name] = tfm.unembed(params, hidden, prog.model_config)
    out = {"logits_rel_err": _rel_err(logits["int8"], logits["bf16"])}
    del logits
    loss, grads = {}, {}
    for name, prog in progs.items():
        summed, grads[name] = accumulate_grads(prog.loss_fn, params, batch)
        loss[name] = float(summed)
    out["loss"] = loss
    out["loss_rel_err"] = abs(loss["int8"] - loss["bf16"]) / loss["bf16"]
    groups = {"attn": ("q", "k", "v", "o"), "mlp": ("gate", "up", "down")}
    out["grad_cos"] = {}
    for group in cfg.quant_train_targets:
        a, b = (torch.cat([grads[n][f"layers.{t}.kernel"].flatten() for t in groups[group]])
                for n in ("int8", "bf16"))
        out["grad_cos"][group] = float(a @ b / (a.norm() * b.norm()))
    return out


def int8_bias_reading(draws: int = INT8_BIAS_DRAWS, shape=(4, 2048, 2048),
                      device="cuda") -> dict:
    """The backward's rounding bias at train's o projection (h [4, 2048,
    2048] @ W [2048, 2048], fp32 operands so no output rounding adds a bias
    of its own): dlhs of ``draws`` backward products, h, W and the cotangent
    each moved in one element per draw, against g @ Wᵀ in fp32 (TF32
    off)."""
    import torch

    from tpu_engine_torch import quant_train as qt

    gen = torch.Generator(device=device).manual_seed(7)
    h = torch.randn(shape, generator=gen, device=device)
    w = torch.randn(shape[-1], shape[-1], generator=gen, device=device) * 0.02
    g = torch.randn(shape, generator=gen, device=device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        mean_got = torch.zeros_like(g)
        mean_want = torch.zeros_like(g)
        single = []
        for i in range(draws):
            hi, wi, gi = h.clone(), w.clone(), g.clone()
            for t in (hi, wi, gi):
                t.view(-1)[0] += (i + 1) * 1e-3
            hi.requires_grad_(True)
            (got,) = torch.autograd.grad(qt.int8_einsum("bsi,io->bso", hi, wi), (hi,), gi)
            want = torch.matmul(gi, wi.t())
            single.append(_rel_err(got, want))
            mean_got += got / draws
            mean_want += want / draws
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    err_single = sum(single) / draws
    err_mean = _rel_err(mean_got, mean_want)
    return {"draws": draws, "single_rel_err": err_single, "mean_rel_err": err_mean,
            "ratio": err_mean / err_single}


def int8_odd_shapes() -> dict:
    """INT8_ODD_SPECS on the card against the CPU."""
    import torch

    from tpu_engine_torch import quant_train as qt

    out = {}
    gen = torch.Generator().manual_seed(11)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for spec, ls, rs in INT8_ODD_SPECS:
            lhs, rhs = torch.randn(ls, generator=gen), torch.randn(rs, generator=gen)
            want = qt.int8_einsum(spec, lhs, rhs)
            lc = lhs.cuda().requires_grad_(True)
            rc = rhs.cuda().requires_grad_(True)
            got = qt.int8_einsum(spec, lc, rc)
            fwd = _rel_err(got.detach().cpu(), want)
            got.square().sum().backward()
            la, ra = lhs.cuda().requires_grad_(True), rhs.cuda().requires_grad_(True)
            torch.einsum(spec, la, ra).square().sum().backward()
            cos = [float((a.grad.flatten() @ b.grad.flatten())
                         / (a.grad.norm() * b.grad.norm())) for a, b in ((lc, la), (rc, ra))]
            key = f"{spec} {list(ls)} {list(rs)}"
            out[key] = {"forward_rel_err": fwd, "grad_cos": cos}
            if not (fwd <= 1e-6 and min(cos) > 0.999):
                raise AssertionError(f"int8 product {key}: forward {fwd:.3e} against the "
                                     f"CPU's (bound 1e-6), gradient cosines {cos} (> 0.999)")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def phase_train_int8(res: dict, steps: int) -> None:
    """llama-1b as ``train`` with ``quant_training="int8"`` on the attention
    and MLP products: per microbatch ``torch._int_mm`` runs 4 times per
    targeted product (forward, the checkpoint's recompute, the two backward
    products: 4 x 7 x 16) and no targeted projection takes a bf16 GEMM; K1
    twice per layer, K2 and K3 once. Held against the bf16 path
    (:func:`int8_readings`), the backward's rounding held unbiased
    (:func:`int8_bias_reading`), every spec at odd sizes
    (:func:`int8_odd_shapes`); then one step of moe-8x7b at 2 layers (as
    ``train_moe``) with the expert products in int8 too, at their real
    capacities."""
    from dataclasses import replace
    from unittest import mock

    import torch

    from tpu_engine_torch.models import transformer as tfm

    L = 16
    cfg = _llama_1b_cfg(quant_training="int8", quant_train_targets=INT8_TARGETS)
    real, plain_calls = tfm._proj, []

    def counting(h, kernel, bias=None, lora_ab=None, lora_scale=1.0, dot=None):
        if dot is None:  # a float kernel's bf16 GEMM
            plain_calls.append(tuple(kernel.shape))
        return real(h, kernel, bias, lora_ab, lora_scale, dot)

    with mock.patch.object(tfm, "_proj", counting):
        _train(res, "train_int8", cfg, steps, "flash",
               {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "int_mm": 4 * 7 * L})
    out = res["train_int8"]
    out["plain_proj_calls"] = len(plain_calls)
    base = res.get("train", {})
    print(f"train_int8: step {out['step_ms']:.1f} ms, {out['tokens_per_s']:.0f} tokens/s, MFU "
          f"{out['mfu']:.4f}, peak {out['peak_mem_gib']:.2f} GiB; train (bf16): step "
          f"{base.get('step_ms', float('nan')):.1f} ms, MFU {base.get('mfu', float('nan')):.4f}, "
          f"peak {base.get('peak_mem_gib', float('nan')):.2f} GiB", flush=True)
    fails = []
    if plain_calls:
        fails.append(f"{len(plain_calls)} targeted projections took a bf16 GEMM")
    torch.cuda.empty_cache()
    r = out["vs_bf16"] = int8_readings(cfg)
    torch.cuda.empty_cache()
    print(f"train_int8: against bf16: logits {r['logits_rel_err']:.3e} (bound "
          f"{INT8_LOGITS_REL}), first loss {r['loss']['int8']:.5f} / {r['loss']['bf16']:.5f} "
          f"({r['loss_rel_err']:.2e}, bound {INT8_LOSS_REL}), gradient cosines "
          f"{r['grad_cos']} (bound {INT8_GRAD_COS})", flush=True)
    if not r["logits_rel_err"] <= INT8_LOGITS_REL:
        fails.append(f"int8 logits {r['logits_rel_err']:.3e} > {INT8_LOGITS_REL}")
    if not r["loss_rel_err"] <= INT8_LOSS_REL:
        fails.append(f"int8 first loss {r['loss_rel_err']:.3e} > {INT8_LOSS_REL}")
    if not all(c >= INT8_GRAD_COS for c in r["grad_cos"].values()):  # NaN fails
        fails.append(f"int8 gradient cosines {r['grad_cos']} < {INT8_GRAD_COS}")
    b = out["bwd_bias"] = int8_bias_reading()
    print(f"train_int8: backward rounding over {b['draws']} draws: single {b['single_rel_err']:.3e}, "
          f"mean {b['mean_rel_err']:.3e}, ratio {b['ratio']:.3f} (bound {INT8_BIAS_RATIO})",
          flush=True)
    if not b["ratio"] <= INT8_BIAS_RATIO:
        fails.append(f"backward rounding ratio {b['ratio']:.3f} > {INT8_BIAS_RATIO}")
    out["odd_shapes"] = int8_odd_shapes()
    print(f"train_int8: odd shapes {json.dumps(out['odd_shapes'])}", flush=True)

    mcfg = tfm.MODEL_CONFIGS["moe-8x7b"].with_(n_layers=MOE_TRAIN_LAYERS)
    mc = replace(cfg, model_name="moe-8x7b", micro_batch_size=2, moe_impl="dense",
                 quant_train_targets=("attn", "mlp", "moe"))
    torch.cuda.empty_cache()
    step = out["moe_step"] = _one_step(mc, mcfg)
    Lm, E = MOE_TRAIN_LAYERS, mcfg.n_experts
    want = {"flash_fwd": 2 * Lm, "flash_bwd_dq": Lm, "flash_bwd_dkv": Lm,
            "int_mm": 4 * (4 + 3 * E) * Lm}
    # Held to the bf16 first loss like the ragged step (FIRST_LOSS_REL).
    ref = res.get("train_moe", {}).get("losses", [None])[0]
    print(f"train_int8: moe-8x7b ({Lm} layers, capacity {mcfg.expert_capacity(2048)}) one int8 "
          f"step: loss {step['loss']:.5f} (bf16 train_moe's first: {ref}), {step['step_ms']:.1f} ms, "
          f"peak {step['peak_mem_gib']:.2f} GiB, launches {step['launches']}", flush=True)
    if {k: v for k, v in step["launches"].items() if v} != want:
        fails.append(f"moe int8 step launches {step['launches']} != {want}")
    if not math.isfinite(step["loss"]) or (
            ref is not None and not abs(step["loss"] - ref) <= FIRST_LOSS_REL * ref):
        fails.append(f"moe int8 step loss {step['loss']} vs bf16 {ref}")
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError("; ".join(fails))


def _checksum(params: dict) -> list:
    """(Σ x, Σ |x|) over every tensor, in float64."""
    import torch

    return [float(sum(t.sum(dtype=torch.float64) for t in params.values())),
            float(sum(t.abs().sum(dtype=torch.float64) for t in params.values()))]


def lora_merged_rel(prog, adapters, tokens) -> float:
    """``merged_params``' logits against the adapter forward's (both bf16,
    flash) on ``tokens``, by relative norm error."""
    import torch

    from tpu_engine_torch.models import transformer as tfm

    cfg, dtype = prog.model_config, prog.config.compute_dtype()
    with torch.no_grad():
        hidden, _ = tfm.forward_hidden_and_aux(prog.base_params, tokens, cfg, compute_dtype=dtype,
                                               lora=adapters,
                                               lora_scale=prog.config.lora_scale())
        want = tfm.unembed(prog.base_params, hidden, cfg)
        del hidden
        merged = prog.merged_params(adapters)
        got = tfm.forward(merged, tokens, cfg, compute_dtype=dtype)
        del merged
    rel = _rel_err(got, want)
    del got, want
    torch.cuda.empty_cache()
    return rel


def lora_config():
    from tpu_engine_torch.train import TrainConfig

    return TrainConfig(model_name="llama-7b", micro_batch_size=2, gradient_accumulation_steps=1,
                       seq_len=2048, precision="bf16", param_dtype="fp32",
                       activation_checkpointing=True, attention_impl="auto", **LORA, **LORA_LR)


def phase_train_lora(res: dict, steps: int) -> None:
    """llama-7b at full width and depth (32 layers, d_model 4096, 32 heads of
    128) with a frozen fp32 base from seed 0 and LoRA adapters (``LORA``),
    seq 2048 x micro-batch 2, bf16 compute, checkpointing, flash: step 0's
    loss equals the base forward's bitwise (B = 0), the loss falls, the
    base's checksum does not move, the optimizer state is adapter-sized,
    and ``merged_params``' logits agree with the adapter forward's within
    LORA_MERGED_REL. K1 twice per layer a microbatch, K2 and K3 once."""
    from dataclasses import replace

    import torch

    from tpu_engine_torch import lora as lora_mod
    from tpu_engine_torch.train import build_train_program

    cfg = lora_config()
    L = 32
    checks: dict = {}

    def base_loss(prog, state, batch) -> float:
        checks["base_sum"] = _checksum(prog.base_params)
        plain = build_train_program(replace(cfg, lora_rank=None), device="cuda")
        return float(plain.eval_step({"params": prog.base_params}, batch))

    prog, state, batch = _train(res, "train_lora", cfg, steps, "flash",
                                {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L},
                                first_loss_ref=base_loss, exact_first=True)
    out = res["train_lora"]
    n = lora_mod.lora_param_count(prog.model_config, cfg.lora_rank, cfg.lora_targets)
    out["adapter_params"] = n
    out["base_bytes"] = sum(t.numel() * t.element_size() for t in prog.base_params.values())
    out["base_checksum"] = [checks["base_sum"], _checksum(prog.base_params)]
    out["merged_logits_rel_err"] = lora_merged_rel(prog, state["params"], batch[0])
    print(f"train_lora: {n} adapter parameters, optimizer state {out['opt_state_bytes']} B, "
          f"base {out['base_bytes'] / 2**30:.2f} GiB, checksum {out['base_checksum'][0]} -> "
          f"{out['base_checksum'][1]}; merged against adapter logits "
          f"{out['merged_logits_rel_err']:.3e} (bound {LORA_MERGED_REL})", flush=True)
    fails = []
    if out["base_checksum"][0] != out["base_checksum"][1]:
        fails.append("the frozen base moved")
    if out["opt_state_bytes"] != 2 * 4 * n:
        fails.append(f"optimizer state {out['opt_state_bytes']} B is not two fp32 adapter moments")
    if not out["merged_logits_rel_err"] <= LORA_MERGED_REL:
        fails.append(f"merged logits {out['merged_logits_rel_err']:.3e} > {LORA_MERGED_REL}")
    del prog, state, batch
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError("; ".join(fails))


def phase_train_opt(res: dict, steps: int) -> None:
    """``train``'s llama-1b with Adafactor, then Lion: the loss falls, K1-K3
    launch as in ``train``; optimizer-state bytes against AdamW's, the
    update's device time alone."""
    import torch

    L = 16
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    for opt in ("adafactor", "lion"):
        _train(res, f"train_{opt}", _llama_1b_cfg(optimizer=opt), steps, "flash", want)
        torch.cuda.empty_cache()
    adamw = res.get("train", {}).get("opt_state_bytes")
    out = res["train_opt"] = {
        opt: {"opt_state_bytes": res[f"train_{opt}"]["opt_state_bytes"],
              "optimizer_ms": res[f"train_{opt}"]["optimizer_ms"],
              "step_ms": res[f"train_{opt}"]["step_ms"]}
        for opt in ("adafactor", "lion")}
    out["adamw"] = {k: res.get("train", {}).get(k) for k in ("opt_state_bytes", "optimizer_ms",
                                                             "step_ms")}
    print("train_opt: " + "; ".join(
        f"{o}: state {v['opt_state_bytes']} B, update {v['optimizer_ms']} ms, step "
        f"{v['step_ms']} ms" for o, v in out.items()), flush=True)
    n = res["train_adafactor"]["opt_state_bytes"]
    if adamw is not None and not (n < 0.1 * adamw / 2 and
                                  res["train_lion"]["opt_state_bytes"] * 2 == adamw):
        raise AssertionError(f"optimizer state: adafactor {n}, lion "
                             f"{res['train_lion']['opt_state_bytes']}, adamw {adamw}")


def remat_kept_bytes(prog, state, batch) -> int:
    """Device bytes one microbatch's forward leaves allocated for its
    backward (the loss and its graph alive)."""
    return remat_kept(prog, state, batch)["device"]


def remat_kept(prog, state, batch) -> dict:
    """Bytes one microbatch's forward leaves for its backward (the loss and
    its graph alive): allocated on the device, and, under offload_dots, the
    host copies of its products (the stash's blocks in use) and the bytes
    its blocks page-lock (``cudaHostRegister``, each block its tensor's
    size)."""
    import torch

    from tpu_engine_torch.offload import host_stash

    stash = host_stash(prog.device)
    torch.cuda.synchronize()
    before, host_before = torch.cuda.memory_allocated(), stash.in_use
    loss = prog.loss_fn(state["params"], batch[0])
    torch.cuda.synchronize()
    torch.empty(1, device="cuda")  # frees the blocks whose side-stream copies have ended
    kept = {"device": torch.cuda.memory_allocated() - before,
            "host": stash.in_use - host_before, "pinned": stash.nbytes}
    del loss
    return kept


def caching_pinned_bytes(nbytes: int):
    """The bytes torch's caching host allocator page-locks for one pinned
    tensor of ``nbytes`` (its ``allocated_bytes``, the rounded block), or
    None where this torch has no ``host_memory_stats``. The port does not
    use that allocator (``offload.HostArena``); this reads what it would
    cost."""
    import torch

    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return None
    before = stats().get("allocated_bytes.current", 0)
    t = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    got = stats().get("allocated_bytes.current", 0) - before
    del t
    return got


def remat_tagged_bytes(policy: str) -> int:
    """Bytes of the tensors a named policy keeps, bf16, every layer of
    ``train``'s llama-1b: attn_out, and q, k, v for save_qkv_attn_out."""
    from tpu_engine_torch.models import transformer as tfm

    c = tfm.MODEL_CONFIGS["llama-1b"]
    per_token = c.n_heads * c.head_dim
    if policy == "save_qkv_attn_out":
        per_token += c.n_heads * c.head_dim + 2 * c.n_kv_heads * c.head_dim
    return c.n_layers * 4 * 2048 * per_token * 2


def phase_remat(res: dict, steps: int = REMAT_STEPS) -> None:
    """``train``'s llama-1b under each of REMAT_RUN for ``steps`` steps:
    step time, peak memory and the bytes a forward keeps; losses and
    gradient norms bitwise nothing_saveable's; K1 once per layer a
    microbatch under everything_saveable (nothing recomputed), twice under
    the others (the dots policies never see the flash kernels, and the
    named ones recompute the attention's own residuals), K2 and K3 once;
    the kept bytes ordered, and each named policy keeping at least
    REMAT_TAG_SHARE of its tagged bytes more than nothing_saveable."""
    import torch

    from tpu_engine_torch.offload import host_stash

    L = 16
    out = res["remat"] = {"steps": steps, "accum": 1, "policies": {}}
    fails = []
    for policy in REMAT_RUN:
        cfg = _llama_1b_cfg(remat_policy=policy)
        prog, state, batch, losses, norms, times, counts, kept = _run_steps(
            cfg, steps, "flash", before=remat_kept)
        k1 = L if policy == "everything_saveable" else 2 * L
        want = {n: 0 for n in counts}
        want.update({"flash_fwd": k1 * steps, "flash_bwd_dq": L * steps,
                     "flash_bwd_dkv": L * steps})
        r = out["policies"][policy] = {
            "losses": losses, "grad_norms": norms, "step_ms": min(times[1:]) * 1e3,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "kept_gib": kept["device"] / 2**30, "kept_host_gib": kept["host"] / 2**30,
            "pinned_gib": kept["pinned"] / 2**30, "launches": counts}
        print(f"remat {policy}: step {r['step_ms']:.1f} ms, peak {r['peak_mem_gib']:.2f} GiB, "
              f"forward keeps {r['kept_gib']:.3f} GiB (host {r['kept_host_gib']:.3f}, pinned "
              f"{r['pinned_gib']:.3f}), losses {losses}", flush=True)
        if counts != want:
            fails.append(f"{policy}: launches {counts} != {want}")
        del prog, state, batch
        torch.cuda.empty_cache()
    out["launches"] = out["policies"]["nothing_saveable"]["launches"]
    ref = out["policies"]["nothing_saveable"]
    for policy, r in out["policies"].items():
        if (r["losses"], r["grad_norms"]) != (ref["losses"], ref["grad_norms"]):
            fails.append(f"{policy}: losses {r['losses']} / gradient norms {r['grad_norms']} "
                         f"are not nothing_saveable's {ref['losses']} / {ref['grad_norms']}")
    kept = [out["policies"][p]["kept_gib"] for p in (
        "everything_saveable", "dots_saveable", "dots_with_no_batch_dims_saveable",
        "save_qkv_attn_out", "save_attn_out", "nothing_saveable")]
    if kept != sorted(kept, reverse=True):
        fails.append(f"kept bytes out of order: {kept}")
    od = out["policies"]["offload_dots"]
    if not od["kept_gib"] < REMAT_DOTS_KEPT_GIB:
        fails.append(f"offload_dots keeps {od['kept_gib']:.3f} GiB on the device, not under "
                     f"{REMAT_DOTS_KEPT_GIB}")
    dots = out["policies"]["dots_with_no_batch_dims_saveable"]["kept_gib"] - ref["kept_gib"]
    od["host_over_dots"] = od["kept_host_gib"] / dots
    if not od["kept_host_gib"] >= REMAT_TAG_SHARE * dots:
        fails.append(f"offload_dots keeps {od['kept_host_gib']:.3f} GiB on the host, under "
                     f"{REMAT_TAG_SHARE} of the dots' {dots:.3f}")
    want = _initial_grads(_llama_1b_cfg(remat_policy="nothing_saveable"), "flash")
    got = _initial_grads(_llama_1b_cfg(remat_policy="offload_dots"), "flash")
    od["grads_bitwise"] = [k for k in want if not torch.equal(want[k], got[k])]
    del want, got
    _free()  # drops what the graphs left in the stash
    stash = host_stash("cuda")
    od["pinned_after_gib"] = stash.nbytes / 2**30
    stash.release()
    od["pinned_released_gib"] = stash.nbytes / 2**30
    print(f"remat offload_dots: every initial gradient bitwise nothing_saveable's: "
          f"{not od['grads_bitwise']}; host copies {od['kept_host_gib']:.3f} GiB, "
          f"{od['host_over_dots']:.3f} of the dots policies' extra; pinned "
          f"{od['pinned_gib']:.3f} GiB at the forward, {od['pinned_after_gib']:.3f} after the "
          f"phase, {od['pinned_released_gib']:.3f} once released", flush=True)
    if od["grads_bitwise"]:
        fails.append(f"offload_dots gradients differ from nothing_saveable's: {od['grads_bitwise']}")
    if stash.nbytes or stash.in_use:
        fails.append(f"offload_dots' stash holds {stash.nbytes} pinned bytes, {stash.in_use} "
                     "in use, after its release")
    # One MLP product of this path (bf16 [4, 2048, 5504]) through torch's
    # caching host allocator: the block it would pin.
    asked = 4 * 2048 * 5504 * 2
    od["caching_allocator"] = {"asked": asked, "pinned": caching_pinned_bytes(asked)}
    print(f"remat: torch's caching host allocator pins {od['caching_allocator']['pinned']} "
          f"bytes for a tensor of {asked}", flush=True)
    torch.cuda.empty_cache()
    for policy in ("save_qkv_attn_out", "save_attn_out"):
        extra = (out["policies"][policy]["kept_gib"] - ref["kept_gib"]) * 2**30
        need = REMAT_TAG_SHARE * remat_tagged_bytes(policy)
        out["policies"][policy]["extra_over_tagged"] = extra / remat_tagged_bytes(policy)
        if not extra >= need:
            fails.append(f"{policy} keeps {extra / 2**30:.3f} GiB over nothing_saveable, "
                         f"under {need / 2**30:.3f}")
    if fails:
        raise AssertionError("; ".join(fails))


# Where the training state lives (train_offload, train_7b): llama-1b as in
# train for OFFLOAD_STEPS steps in each placement; the host placements must
# give the in-memory run's losses and final parameters bitwise (the same
# arithmetic, moved). The disk tier's host AdamW (numpy) rounds otherwise:
# its losses are held to the in-memory run's by DISK_LOSS_REL, set from the
# sound and planted readings of train_faults.py.
OFFLOAD_STEPS = 3
# train_offload trains llama-1b at full width and 2 of its 16 layers: the
# disk tier's host walk (about 45 s a step at 16 layers) and the run's time
# limit, which the card's machines meet 23 % apart from call to call
# (PERF.md §4: cut to 8 layers, then to 2 when train_pipe came).
OFFLOAD_L = 2
OFFLOAD_PLACEMENTS = (
    ("memory", {}),
    ("optimizer_host", dict(optimizer_offload="host")),
    ("param_host", dict(param_offload="host")),
    ("both_host", dict(optimizer_offload="host", param_offload="host")),
    ("bf16_masters", dict(param_dtype="bf16")),
    ("disk", dict(optimizer_offload="disk")),
)
HOST_PLACEMENTS = ("optimizer_host", "param_host", "both_host")
DISK_LOSS_REL = 2e-4
# train_7b: llama-7b at full width and depth, seq 2048 x 1. A configuration
# runs only where its pinned bytes are at most PINNED_SHARE of the host's
# MemTotal: (a) fp32 masters, optimizer state on the host, else (a')
# the same with bf16 first moments; (b) masters too on the host, where it
# fits; (c) bf16 masters in memory with moment_dtype="bf16" (bf16 mu, fp32
# nu, as optax holds them; with both moments fp32, as optax holds them
# without moment_dtype, 12 bytes a parameter exceed the card).
PINNED_SHARE = 0.6
SEVEN_B = dict(model_name="llama-7b", micro_batch_size=1, gradient_accumulation_steps=1,
               seq_len=2048, precision="bf16", activation_checkpointing=True,
               attention_impl="auto", **TRAIN_LR)
# train_window: train's llama-1b with sliding_window=WINDOW (the windowed
# K1-K3 at D 128); its first loss held to the plain windowed path's.
WINDOW = 1024


def _offload_model():
    """``train_offload``'s model: llama-1b at OFFLOAD_L layers."""
    from tpu_engine_torch.models.config import MODEL_CONFIGS

    return MODEL_CONFIGS["llama-1b"].with_(n_layers=OFFLOAD_L)


def _placement(key: str, cfg, steps: int, want: dict, model_cfg=None):
    """``cfg``'s program (``model_cfg`` in place of its model name's, if
    given) for ``steps`` steps (:func:`_run_steps`): losses,
    step time (min of steps 2..), peak device memory, the page-locked host
    bytes behind the state, launch counts held to ``want`` per microbatch.
    The disk tier's last step is the profiled one (:func:`_transfers`; its
    steps take seconds): it runs ``steps - 1`` here. Returns (program,
    state, batch, readings)."""
    import torch

    from tpu_engine_torch.offload import pinned_bytes

    if cfg.optimizer_offload == "disk":
        steps -= 1
    prog, state, batch, losses, norms, times, counts, _ = _run_steps(cfg, steps, "flash",
                                                                     model_cfg=model_cfg)
    expect = {n: want.get(n, 0) * steps * cfg.gradient_accumulation_steps for n in counts}
    trees = [state["params"]] + [t for n, t in state.get("opt_state", {}).items() if n != "count"]
    r = {"losses": losses, "grad_norms": norms, "step_ms_each": [t * 1e3 for t in times],
         "step_ms": min(times[1:]) * 1e3, "steps": steps,
         "accum": cfg.gradient_accumulation_steps,
         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
         "pinned_gib": pinned_bytes(*trees) / 2**30, "launches": counts}
    if prog.disk is not None:
        r["spill_gib"] = prog.disk.store.spill_bytes() / 2**30
        r["walk_s"] = prog.disk.walk_s
    print(f"{key}: losses {losses}, step {r['step_ms']:.1f} ms, peak {r['peak_mem_gib']:.2f} GiB, "
          f"pinned {r['pinned_gib']:.2f} GiB" + (f", spill {r['spill_gib']:.2f} GiB, walk "
                                                  f"{r['walk_s']} s" if prog.disk else ""),
          flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{key}: non-finite loss {losses}")
    if counts != expect:
        raise AssertionError(f"{key}: launch counts {counts} != expected {expect}")
    return prog, state, batch, r


def _transfers(prog, state, batch, key: str, r: dict):
    """One more step under the profiler: the bytes the placement moved each
    way, the copies' device time and rate, the device-busy share. Returns
    the step's (state, metrics)."""
    before = prog.transfer_bytes()
    out = []
    prof = _profile(lambda: out.append(prog.step(state, batch)), key)
    after = prog.transfer_bytes()
    moved = {d: after[d] - before[d] for d in after}
    r["bytes_per_step"] = moved
    r["memcpy_ms"] = prof["memcpy_ms"]
    r["gb_per_s"] = {d: moved[d] / prof["memcpy_ms"][d] / 1e6 if prof["memcpy_ms"][d] else None
                     for d in moved}
    r["busy_share"] = None if prof["idle_share"] is None else 1 - prof["idle_share"]
    r["profile"] = prof
    print(f"{key}: a step moves {moved['h2d'] / 1e9:.3f} GB to the device at "
          f"{r['gb_per_s']['h2d']} GB/s, {moved['d2h'] / 1e9:.3f} GB back at "
          f"{r['gb_per_s']['d2h']} GB/s; device busy {r['busy_share']}", flush=True)
    return out[0]


def _free() -> None:
    """Collect what the caller dropped (host arenas unpin as they go) and
    return the device's cached blocks."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_train_offload(res: dict, steps: int = OFFLOAD_STEPS) -> None:
    """``train``'s llama-1b at OFFLOAD_L layers in each of OFFLOAD_PLACEMENTS: the host
    placements' losses and parameters bitwise the in-memory run's; bf16
    masters' and the disk tier's first loss bitwise its (the same bf16
    weights) and their losses falling, the disk tier's within DISK_LOSS_REL
    of it, its spill under a temporary directory (free space checked first,
    removed after). Per placement: step time, peak device memory, pinned
    host bytes, bytes over the bus and their rate, device-busy share, and
    the update alone (the disk tier's walk seconds)."""
    import os
    import shutil
    import tempfile

    import torch

    from tpu_engine_torch.models import transformer as tfm

    L = OFFLOAD_L
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    out = res["train_offload"] = {"steps": steps, "accum": 1, "layers": L, "placements": {}}
    n = tfm.param_count(_offload_model())
    root = tempfile.mkdtemp(prefix="chip_smoke_spill_")
    fails, ref = [], {}
    try:
        free = shutil.disk_usage(root).free
        out["spill_need_bytes"], out["spill_free_bytes"] = 12 * n, free
        print(f"train_offload: the disk tier's spill needs {12 * n} bytes; {free} free", flush=True)
        if free < 12 * n * 1.1:
            raise AssertionError(f"the disk tier needs {12 * n} bytes of disk, {free} free")
        for name, extra in OFFLOAD_PLACEMENTS:
            if extra.get("optimizer_offload") == "disk":
                extra = {**extra, "optimizer_spill_dir": os.path.join(root, name)}
            key = f"train_offload {name}"
            prog, state, batch, r = _placement(key, _llama_1b_cfg(**extra), steps, want,
                                               _offload_model())
            out["placements"][name] = r
            if prog.disk is not None:  # its last step is the profiled one
                state, m = _transfers(prog, state, batch, key, r)
                r["losses"].append(float(m["loss"]))
                r["walk_s"] = prog.disk.walk_s
            losses = r["losses"]
            if name == "memory":  # the reference, kept on the host: off the later peaks
                ref = {"losses": losses,
                       "params": {k: p.detach().cpu() for k, p in state["params"].items()}}
                out["launches"] = r["launches"]
            elif name in HOST_PLACEMENTS:
                diff = [k for k, p in state["params"].items()
                        if not torch.equal(p.cpu(), ref["params"][k])]
                r["bitwise"] = losses == ref["losses"] and not diff
                if not r["bitwise"]:
                    fails.append(f"{name}: losses {losses} vs {ref['losses']}, params differ "
                                 f"at {diff}")
            else:
                r["loss_rel"] = max(abs(a - b) / b for a, b in zip(losses, ref["losses"]))
                if not losses[2] < losses[1]:
                    fails.append(f"{name}: the loss did not fall: {losses}")
                if losses[0] != ref["losses"][0]:  # the same bf16 weights at step 0
                    fails.append(f"{name}: first loss {losses[0]!r} is not {ref['losses'][0]!r}")
                if name == "disk" and not r["loss_rel"] <= DISK_LOSS_REL:
                    fails.append(f"disk: losses {losses} vs {ref['losses']}: relative "
                                 f"{r['loss_rel']:.3e} > {DISK_LOSS_REL}")
                print(f"{key}: losses against the in-memory run's, relative "
                      f"{r['loss_rel']:.3e}", flush=True)
            if prog.disk is None:
                r["optimizer_ms"] = _time_optimizer(prog, state, key)
                _transfers(prog, state, batch, key, r)
            spill = prog.config.optimizer_spill_dir
            del prog, state, batch
            _free()
            if spill:
                shutil.rmtree(spill, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        ref.clear()
        _free()
    out["losses"] = {k: v["losses"] for k, v in out["placements"].items()}
    print("train_offload: " + json.dumps({k: {f: v.get(f) for f in (
        "step_ms", "peak_mem_gib", "pinned_gib", "gb_per_s", "busy_share")}
        for k, v in out["placements"].items()}, default=str), flush=True)
    if fails:
        raise AssertionError("; ".join(fails))


def _meminfo() -> dict:
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            if k in ("MemTotal", "MemAvailable"):
                out[k] = int(v.split()[0]) * 1024
    return out


def seven_b_plan(n: int, mem_total: int) -> dict:
    """Each train_7b configuration's reckoned bytes from the parameter count
    n (device: masters, gradients (fp32 for fp32 masters; one microbatch's
    bf16 gradient is its own fp32 sum), the bf16 stack the loss casts from
    fp32 masters, moments on the device; activations apart) and whether it
    runs (PINNED_SHARE)."""
    plans = {
        "a": (dict(optimizer_offload="host"), 4 * n + 4 * n + 2 * n, 8 * n),
        "a_prime": (dict(optimizer_offload="host", moment_dtype="bf16"), 10 * n, 6 * n),
        "b": (dict(optimizer_offload="host", param_offload="host"), 4 * n, 12 * n),
        "c": (dict(param_dtype="bf16", moment_dtype="bf16"), 2 * n + 2 * n + 2 * n + 4 * n, 0),
    }
    fits = {k: pinned <= PINNED_SHARE * mem_total for k, (_, _, pinned) in plans.items()}
    run = {"a": fits["a"], "a_prime": not fits["a"], "b": fits["b"], "c": True}
    return {k: {"extra": extra, "device_bytes": dev, "pinned_bytes": pinned, "runs": run[k]}
            for k, (extra, dev, pinned) in plans.items()}


def phase_train_7b(res: dict, steps: int = OFFLOAD_STEPS) -> None:
    """llama-7b at full width and depth (32 layers, d_model 4096), seq 2048
    x 1, full gradients: the host's memory and each configuration's
    reckoned bytes first (the in-memory fp32 program, 16 bytes a parameter,
    is not run: it exceeds the card), then each configuration that
    seven_b_plan runs for ``steps`` steps: losses finite and falling from
    step 1 to step 2, K1 twice and K2/K3 once a layer a microbatch, step 0's
    loss of (b) bitwise (a)'s where both run; step time, peak and pinned
    bytes, the bus's rate and the device-busy share."""
    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.train import TrainConfig

    mem = _meminfo()
    n = tfm.param_count(tfm.MODEL_CONFIGS["llama-7b"])
    plan = seven_b_plan(n, mem["MemTotal"])
    out = res["train_7b"] = {"steps": steps, "accum": 1, "meminfo": mem, "params": n,
                             "in_memory_fp32_bytes": 16 * n, "plan": plan, "runs": {}}
    print(f"train_7b: host MemTotal {mem['MemTotal'] / 2**30:.2f} GiB, MemAvailable "
          f"{mem['MemAvailable'] / 2**30:.2f} GiB; {n} parameters; in memory with fp32 masters "
          f"{16 * n / 1e9:.1f} GB (not run: over the card's 80 GB)", flush=True)
    for k, p in plan.items():
        print(f"train_7b ({k}) {p['extra']}: reckoned device {p['device_bytes'] / 2**30:.1f} GiB "
              f"+ activations, pinned {p['pinned_bytes'] / 2**30:.1f} GiB "
              f"({'runs' if p['runs'] else 'not run: pinned over ' + str(PINNED_SHARE) + ' of MemTotal'})",
              flush=True)
    L = 32
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    fails = []
    for k, p in plan.items():
        if not p["runs"]:
            continue
        key = f"train_7b ({k})"
        try:
            prog, state, batch, r = _placement(key, TrainConfig(**SEVEN_B, **p["extra"]), steps,
                                               want)
        except Exception as e:  # each configuration runs; any failure fails the phase
            traceback.print_exc()
            fails.append(f"{k}: {e}")
            _free()
            continue
        out["runs"][k] = r
        out.setdefault("launches", r["launches"])
        if not r["losses"][2] < r["losses"][1]:
            fails.append(f"{k}: the loss did not fall from step 1 to step 2: {r['losses']}")
        r["optimizer_ms"] = _time_optimizer(prog, state, key)
        _transfers(prog, state, batch, key, r)
        del prog, state, batch
        _free()
    runs = out["runs"]
    if "a" in runs and "b" in runs and runs["a"]["losses"][0] != runs["b"]["losses"][0]:
        fails.append(f"step 0: (a) {runs['a']['losses'][0]!r} != (b) {runs['b']['losses'][0]!r}")
    if fails:
        raise AssertionError("; ".join(fails))


def phase_train_window(res: dict, steps: int = OFFLOAD_STEPS) -> None:
    """``train``'s llama-1b with ``sliding_window=WINDOW`` (the config's
    override): K1 twice and K2/K3 once a layer a microbatch, every one of
    them windowed, and the first loss held to the plain windowed path's on
    the same weights and batch within MODEL_REL["bf16"]."""
    from dataclasses import replace

    from tpu_engine_torch.train import build_train_program

    cfg = _llama_1b_cfg(sliding_window=WINDOW)

    def plain_loss(prog, state, batch) -> float:
        if prog.model_config.sliding_window != WINDOW:
            raise AssertionError(f"the window resolved to {prog.model_config.sliding_window}")
        plain = build_train_program(replace(cfg, attention_impl="xla"), device="cuda")
        return float(plain.eval_step(state, batch))

    L = 16
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    want.update({f"{k}_window": v for k, v in want.items()})
    _train(res, "train_window", cfg, steps, "flash", want, first_loss_ref=plain_loss,
           first_rel=MODEL_REL["bf16"])
    _free()


# train_mesh: llama-1b at full width and depth on a mesh of ranks, a
# process each, joined through NCCL on the one card (two ranks need
# distinct NCCL_HOSTID values: NCCL refuses two ranks on one bus id of one
# host). World 1 holds the mesh program (stage 3, collectives of one rank)
# to the no-mesh one bitwise; the two-rank runs are held to the world-1 run
# at the same global batch by MESH_LOSS_REL (train_faults.py, set from its
# planted-fault readings).
# The run's time limit (PERF.md §4): llama-1b's 16 layers cut to 4, then
# to 2 (the runs at seq 2048 and the pipelines, as the two-rank ring and
# Ulysses runs and their world-1 run).
MESH_L = 2
MESH_SEQ_L = 2
MESH_SEQ = 8192
MESH_MOE = dict(model_name="moe-8x7b", moe_impl="dense")  # at MOE_TRAIN_LAYERS layers
MESH_LORA = dict(lora_rank=16, lora_alpha=32.0, lora_targets=("q", "k", "v", "o", "gate",
                                                              "up", "down"),
                 learning_rate=1e-4)
PIPE_M = 4  # microbatches of train_pipe: M > P, so "auto" resolves to zb
PIPE_SCHEDULES = ("gpipe", "1f1b", "zb")
MESH_RUNS = {
    # name: (ranks, mesh (None: no mesh), TrainConfig fields, the world-1
    # run it is held to, per-rank launches a microbatch)
    "nomesh": (1, None, dict(micro_batch_size=4, seq_len=2048), None, "flash"),
    "w1_2048": (1, {}, dict(micro_batch_size=4, seq_len=2048), "nomesh", "flash"),
    "w1_8192": (1, {}, dict(micro_batch_size=1, seq_len=MESH_SEQ), None, "flash"),
    "fsdp2": (2, dict(fsdp=2), dict(micro_batch_size=2, seq_len=2048), "w1_2048", "flash"),
    "ring2": (2, dict(sequence=2), dict(micro_batch_size=1, seq_len=MESH_SEQ), "w1_8192",
              "ring"),
    "ulysses2": (2, dict(sequence=2), dict(micro_batch_size=1, seq_len=MESH_SEQ,
                                           attention_impl="ulysses"), "w1_8192", "ulysses"),
    # Tensor parallelism: each rank 8 heads, 2752 MLP columns, 16000
    # vocabulary rows.
    "tp2": (2, dict(model=2), dict(micro_batch_size=4, seq_len=2048), "w1_2048", "flash"),
    # Expert parallelism: train_moe's moe-8x7b, 4 experts a rank.
    "w1_moe": (1, {}, dict(MESH_MOE, micro_batch_size=2, seq_len=2048), None, "flash"),
    "ep2": (2, dict(model=2), dict(MESH_MOE, micro_batch_size=2, seq_len=2048), "w1_moe",
            "flash"),
    # LoRA over model (the adapters of q, k, v, o and the MLP split with their
    # projections) and Adafactor over model (factored moments reduced over
    # the split dims), each held to its world-1 run (MESH_LAYERS layers).
    "w1_lora": (1, {}, dict(MESH_LORA, micro_batch_size=4, seq_len=2048), None, "flash"),
    "lora_tp2": (2, dict(model=2), dict(MESH_LORA, micro_batch_size=4, seq_len=2048), "w1_lora",
                 "flash"),
    "w1_ada": (1, {}, dict(optimizer="adafactor", micro_batch_size=4, seq_len=2048), None,
               "flash"),
    "adafactor_tp2": (2, dict(model=2), dict(optimizer="adafactor", micro_batch_size=4,
                                             seq_len=2048), "w1_ada", "flash"),
    # Pipelines (train_pipe): llama-1b's MESH_L layers over pipe=2, half a rank,
    # seq 2048 × 1 × PIPE_M microbatches, under each schedule.
    "w1_pipe": (1, {}, dict(micro_batch_size=1, seq_len=2048,
                            gradient_accumulation_steps=PIPE_M), None, "flash"),
    **{f"pipe_{s}": (2, dict(pipe=2), dict(micro_batch_size=1, seq_len=2048,
                                           gradient_accumulation_steps=PIPE_M,
                                           pipeline_schedule=s), "w1_pipe", "flash")
       for s in PIPE_SCHEDULES},
    # train_mesh_state (STATE_L layers; moe-8x7b at STATE_MOE_L): the state's
    # placements, int8 training, dense MoE over sequence and a pipeline's
    # checkpoint on two ranks, each held to its world-1 run.
    "w1_state": (1, {}, dict(micro_batch_size=4, seq_len=2048), None, "flash"),
    "place2": (2, dict(fsdp=2), dict(optimizer_offload="host", param_offload="host",
                                     micro_batch_size=2, seq_len=2048), "w1_state", "flash"),
    "disk2": (2, dict(fsdp=2), dict(optimizer_offload="disk", micro_batch_size=2,
                                    seq_len=2048), "w1_state", "flash"),
    "w1_int8": (1, {}, dict(quant_training="int8", micro_batch_size=4, seq_len=2048), None,
                "flash"),
    "int8_d2": (2, dict(data=2), dict(quant_training="int8", micro_batch_size=2, seq_len=2048),
                "w1_int8", "flash"),
    # int8 over model: o's and down's forward absmax, and the column
    # products' input-gradient absmax, reduced over both ranks.
    "tp2_int8": (2, dict(model=2), dict(quant_training="int8", micro_batch_size=4,
                                        seq_len=2048), "w1_int8", "flash"),
    "w1_moe_seq": (1, {}, dict(MESH_MOE, micro_batch_size=2, seq_len=4096), None, "flash"),
    "moe_seq2": (2, dict(sequence=2), dict(MESH_MOE, micro_batch_size=2, seq_len=4096),
                 "w1_moe_seq", "ring"),
    "pipe_ckpt": (2, dict(pipe=2), dict(micro_batch_size=4, seq_len=2048,
                                        pipeline_schedule="gpipe"), "w1_state", "flash"),
}
STATE_L = 2
STATE_MOE_L = 1
STATE_RUNS = ("place2", "disk2", "int8_d2", "tp2_int8", "moe_seq2", "pipe_ckpt")
# Layers of the runs not at MESH_L (the run's time limit, PERF.md §4).
MESH_LAYERS = {"w1_lora": 2, "lora_tp2": 2, "w1_ada": 2, "adafactor_tp2": 2,
               **{k: STATE_L for k in ("w1_state", "place2", "disk2", "w1_int8", "int8_d2",
                                       "tp2_int8", "pipe_ckpt")},
               "w1_moe_seq": STATE_MOE_L, "moe_seq2": STATE_MOE_L}
# Model fields changed in a run: moe_seq2's capacity factor cut so that each
# expert fills on the first sequence rank's tokens, and the buffer positions
# of the second rank's decide which of its tokens drop.
MESH_MODEL = {"w1_moe_seq": dict(capacity_factor=0.5), "moe_seq2": dict(capacity_factor=0.5)}
MESH_TIMEOUT_S = 300
SERVE_MESH_TIMEOUT_S = 600
# NCCL's socket transport between the ranks (the only one NCCL takes
# between "hosts"): 8 threads of 2 sockets and 16 MB buffers moved a 256 MB
# all-reduce in 159 ms against the defaults' 205 (nccl_probe.py --tune on
# an NVIDIA H100 80GB HBM3 at 700 W).
MESH_NCCL_ENV = {"NCCL_SOCKET_NTHREADS": "8", "NCCL_NSOCKS_PERTHREAD": "2",
                 "NCCL_BUFFSIZE": str(16 << 20)}


def _mesh_layers(name: str) -> int:
    if name in MESH_LAYERS:
        return MESH_LAYERS[name]
    if MESH_RUNS[name][2].get("model_name") == "moe-8x7b":
        return MOE_TRAIN_LAYERS
    return MESH_SEQ_L if MESH_RUNS[name][2]["seq_len"] == MESH_SEQ else MESH_L


def pipe_want(schedule: str, n_stages: int, micro: int, stage: int, layers: int) -> dict:
    """Launches a step of a pipeline stage of ``layers`` layers, from the
    schedule's tick table: GPipe's forward runs K1 once a layer and its
    backward the checkpoint's recompute (K1) and K2, K3; the recomputing
    schedules' forward runs K1 once a layer (none on the last stage, which
    computes at its backward's tick), and each backward (combined, or its
    B or W half) the stage's forward again, the recompute and K2, K3."""
    from tpu_engine_torch.parallel import pipeline, pipeline_1f1b, pipeline_zb

    table = {"gpipe": pipeline.gpipe_table, "1f1b": pipeline_1f1b.f1b_table,
             "zb": pipeline_zb.zb_table}[schedule](n_stages, micro)
    k1 = k23 = 0
    for row in table:
        for op, _ in row[stage]:
            if op == "F":
                k1 += 1 if schedule == "gpipe" or stage < n_stages - 1 else 0
            else:
                k1 += 1 if schedule == "gpipe" else 2
                k23 += 1
    return {"flash_fwd": k1 * layers, "flash_bwd_dq": k23 * layers,
            "flash_bwd_dkv": k23 * layers}


def _mesh_want(name: str, rank: int) -> dict:
    """Launches a step of ``name``'s rank ``rank``: K1 twice a layer (the
    forward and the checkpoint's recompute), K2 and K3 once (on the rank's
    heads under ``model``); the ring's rank 1 also runs its past hop
    unmasked (the ``_full`` kernels); a pipeline stage's by
    :func:`pipe_want`."""
    L = _mesh_layers(name)
    kw = MESH_RUNS[name][2]
    if MESH_RUNS[name][1] and MESH_RUNS[name][1].get("pipe", 1) > 1:
        P = MESH_RUNS[name][1]["pipe"]
        return pipe_want(kw["pipeline_schedule"], P, kw.get("gradient_accumulation_steps", 1),
                         rank, L // P)
    M = kw.get("gradient_accumulation_steps", 1)
    causal = {"flash_fwd": 2 * L * M, "flash_bwd_dq": L * M, "flash_bwd_dkv": L * M}
    if MESH_RUNS[name][4] == "ring" and rank == 1:
        return {**causal, **{f"{k}_full": v for k, v in causal.items()}}
    return causal


def _mesh_cfg(name: str, spill=None):
    """(the TrainConfig of ``name``, its model config: llama-1b, or
    moe-8x7b at MOE_TRAIN_LAYERS layers); ``spill``: the disk tier's
    directory, where the run spills."""
    from tpu_engine_torch.mesh_runtime import MeshConfig
    from tpu_engine_torch.models.config import MODEL_CONFIGS
    from tpu_engine_torch.train import TrainConfig

    _, mesh, kw, _, _ = MESH_RUNS[name]
    if kw.get("optimizer_offload") == "disk":
        kw = dict(kw, optimizer_spill_dir=spill)
    cfg = TrainConfig(**{**dict(model_name="llama-1b", gradient_accumulation_steps=1,
                                precision="bf16", param_dtype="fp32",
                                activation_checkpointing=True, attention_impl="auto",
                                sharding_stage=3, mesh=MeshConfig(**(mesh or {})),
                                **TRAIN_LR), **kw})
    return cfg, MODEL_CONFIGS[cfg.model_name].with_(n_layers=_mesh_layers(name),
                                                    **MESH_MODEL.get(name, {}))


def _mesh_runs(runs: list, steps: int, fault=None, work=None) -> dict:
    """Take ``steps`` steps of each of ``runs`` (names of MESH_RUNS) on one
    synthetic batch, in this process's group on cuda:0, every launch and
    collective counter set to 0 just before and read just after. ``fault``
    names a planted fault of train_faults.py, patched around each run.
    ``work``: the directory of the disk tier's spills (``<work>/<run>``)
    and of ``pipe_ckpt``'s checkpoint (:func:`_pipe_ckpt`)."""
    import contextlib

    import torch

    from tpu_engine_torch import offload
    from tpu_engine_torch.mesh_runtime import MeshRuntime
    from tpu_engine_torch.ops import _flash_cuda as fc
    from tpu_engine_torch.parallel import collectives
    from tpu_engine_torch.train import build_train_program

    def patch():
        if not fault:
            return contextlib.nullcontext()
        import train_faults

        return train_faults._patched(train_faults.mesh_fault(fault))

    device = torch.device("cuda", 0)
    out, runtimes = {}, {}  # one runtime a mesh shape, shared by its runs
    for name in runs:
        t_setup = time.perf_counter()
        cfg, model_cfg = _mesh_cfg(name, str(Path(work) / name) if work else None)
        with patch():
            runtime = None
            if MESH_RUNS[name][1] is not None:
                key = json.dumps(MESH_RUNS[name][1], sort_keys=True)
                if key not in runtimes:
                    runtimes[key] = MeshRuntime(cfg.mesh, device=device)
                runtime = runtimes[key]
            prog = build_train_program(cfg, model_cfg, device=device, runtime=runtime)
            state = prog.init()
            batch = prog.synthetic_batch(seed=0)
            torch.cuda.synchronize()
            t_setup = time.perf_counter() - t_setup
            torch.cuda.reset_peak_memory_stats()
            fc.reset_launches()
            collectives.reset_moved()
            losses, norms, times = [], [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                state, m = prog.step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            launches = dict(fc.launches)
            transfer = prog.transfer_bytes()
            peak = torch.cuda.max_memory_allocated()
            moved = dict(collectives.moved)
            probe = (_row_scale_probe(prog, state, batch, runtime.group("model"))
                     if name == "tp2_int8" else None)
        out[name] = {
            "losses": losses, "grad_norms": norms, "step_ms_each": [t * 1e3 for t in times],
            "peak_mem_gib": peak / 2**30,
            "launches": launches, "row_scales": probe,
            "moved_bytes_per_step": {k: v // steps for k, v in moved.items()},
            "impl": prog.model_config.attention_impl, "setup_s": t_setup,
            "mesh": runtime.axis_sizes if runtime is not None else None,
            "schedule": prog.pipeline_schedule,
            "pinned_gib": offload.pinned_bytes(
                state["params"], *(t for n, t in state.get("opt_state", {}).items()
                                   if n != "count")) / 2**30,
            "host_bytes_per_step": {k: v // steps for k, v in transfer.items()}}
        print(f"{name}: losses {losses}, step ms {out[name]['step_ms_each']}", flush=True)
        if name == "pipe_ckpt" and work is not None:
            with patch():
                out[name]["ckpt"] = _pipe_ckpt(prog, state, cfg, model_cfg, runtime, work)
        del prog, state, batch
        _free()
    return out


def _row_scale_probe(prog, state, batch, group) -> dict:
    """One more step of a model-split int8 run with the forward scales of
    every row-parallel product (o, down) held, bitwise, to those of the
    whole operand: each operand's block all-gathered over ``group`` along
    the dim it contracts, its absmax taken there. Counts the operands
    checked and those whose scales differ."""
    import torch
    import torch.distributed as dist

    from tpu_engine_torch import quant_train as qt
    from tpu_engine_torch.models import transformer as tfm

    plain_quantize, plain_row = qt.channel_quantize, tfm._row_proj
    inside, tally = [0], {"checked": 0, "differ": 0}

    def quantize(x, axes, *a, **kw):
        codes, scales = plain_quantize(x, axes, *a, **kw)
        if inside[0]:
            parts = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, x.contiguous(), group=group)
            whole = torch.cat(parts, dim=axes[0]).float()
            want = torch.clamp_min(torch.amax(torch.abs(whole), dim=axes, keepdim=True),
                                   1e-30) / 127.0
            tally["checked"] += 1
            tally["differ"] += int(not torch.equal(scales, want))
        return codes, scales

    def row_proj(*a, **kw):
        inside[0] += 1
        try:
            return plain_row(*a, **kw)
        finally:
            inside[0] -= 1

    qt.channel_quantize, tfm._row_proj = quantize, row_proj
    try:
        prog.step(state, batch)
        torch.cuda.synchronize()
    finally:
        qt.channel_quantize, tfm._row_proj = plain_quantize, plain_row
    return tally


def _pipe_ckpt(prog, state, cfg, model_cfg, runtime, work) -> dict:
    """``pipe_ckpt`` after its steps: a save of the state (each stage its
    block of layers and the outer leaves it holds), then a fresh program on
    the same ranks restored from it; whether the restore is bitwise the
    state saved, and crc32s of the whole params and moments (every stage's
    leaves gathered) for the world-1 read."""
    import torch

    from tpu_engine_torch import checkpoint as ck
    from tpu_engine_torch import reshard
    from tpu_engine_torch.train import build_train_program

    path = str(Path(work) / "pipe_ckpt")
    mgr = ck.TrainCheckpointManager(path, program=prog)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(state["step"], state, wait=True)
    save_s = time.perf_counter() - t0
    saved = {k: v.detach().clone() for k, v in ck.flatten_state(state).items()
             if isinstance(v, torch.Tensor)}
    nbytes = sum(v.numel() * v.element_size() for v in saved.values())
    whole = {"params": prog.whole_params(state),
             **{n: prog.whole_tree(state["opt_state"][n], split=prog.zero.state_split)
                for n in ("mu", "nu")}}
    sums = {part: reshard.leaf_checksums(tree) for part, tree in whole.items()}
    del whole
    prog2 = build_train_program(cfg, model_cfg, device=prog.device, runtime=runtime)
    like = ck.abstract_state_like(prog2)
    t0 = time.perf_counter()
    step, got = ck.TrainCheckpointManager(path, program=prog2).restore(like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    flat = {k: v for k, v in ck.flatten_state(got).items() if isinstance(v, torch.Tensor)} \
        if got is not None else {}
    bitwise = flat.keys() == saved.keys() and all(torch.equal(flat[k], saved[k]) for k in flat)
    del prog2, like, got, flat, saved
    return {"step": step, "bitwise": bitwise, "checksums": sums, "bytes": nbytes,
            "save_s": save_s, "restore_s": restore_s, "path": path}


def mesh_worker(job_path: str, rank: int) -> None:
    """One rank of ``train_mesh``, ``train_pipe``, ``train_comm`` or
    ``serve_mesh`` (``chip_smoke.py --mesh-worker JOB RANK``): joins the
    job's process group on cuda:0 through NCCL, takes its runs
    (:func:`_mesh_runs`, :func:`_comm_runs`) or serves (:func:`_mesh_serve`)
    and writes ``JOB.rank<R>.json``."""
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from tpu_engine_torch.mesh_runtime import initialize_distributed
    from tpu_engine_torch.ops import _flash_cuda as fc

    job = json.loads(Path(job_path).read_text())
    if not job.get("serve"):  # serving launches no kernel of the port
        fc._load()
    initialize_distributed(job["store"], job["world"], rank, device="cuda:0")
    out = {"rank": rank, "joined_s": time.time() - job["t0"]}
    if job.get("serve"):
        out["serve"] = _mesh_serve(job["serve"], rank, job.get("fault"))
    elif job.get("comm"):
        out["comm"] = _comm_runs(job, rank)
    else:
        out["runs"] = _mesh_runs(job["runs"], job["steps"], job.get("fault"), job.get("work"))
    Path(f"{job_path}.rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def mesh_world1(runs: list, steps: int) -> dict:
    """``runs`` at world 1 in this process (warm: no start-up, no second
    CUDA context): a one-rank NCCL group joined for them and left after."""
    import torch.distributed as dist

    from tpu_engine_torch.mesh_runtime import initialize_distributed

    store = _store_path("w1")
    initialize_distributed(f"file://{store}", 1, 0, device="cuda:0")
    try:
        return _mesh_runs(runs, steps)
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def _store_path(tag: str) -> Path:
    """A fresh file for a job's ``file://`` rendezvous store. A file, not a
    TCP port: a port found free and then closed can be taken by another
    socket before rank 0's store binds it (EADDRINUSE)."""
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / f"mesh_{tag}.store"
    path.unlink(missing_ok=True)
    return path


def mesh_launch(runs: list, world: int, steps: int, tag: str, fault=None,
                serve=None, comm=None, ckpt=None, work=None) -> list:
    """Run ``runs`` (or with ``serve``, :func:`_mesh_serve` in that mode;
    with ``comm``, those runs of COMM_RUNS through :func:`_comm_runs`,
    saving to ``ckpt``) on ``world`` rank processes (:func:`mesh_worker`)
    and return each rank's results. Every process is stopped on return; a
    rank that fails (its peers are stopped then: they would wait on it in a
    collective), or a job that outlives MESH_TIMEOUT_S
    (SERVE_MESH_TIMEOUT_S serving), raises with each failed rank's log
    tail."""
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    job_path = out_dir / f"mesh_{tag}.json"
    store = _store_path(tag)
    job_path.write_text(json.dumps({"runs": runs, "world": world, "steps": steps,
                                    "store": f"file://{store}", "fault": fault, "t0": time.time(),
                                    "serve": serve, "comm": comm, "ckpt": ckpt, "work": work}))
    procs = []
    for r in range(world):
        # GLOO_SOCKET_IFNAME: the checkpoint manager's gloo group, on the loopback.
        env = dict(os.environ, NCCL_HOSTID=f"mesh-rank-{r}", GLOO_SOCKET_IFNAME="lo",
                   **MESH_NCCL_ENV)
        log = open(out_dir / f"mesh_{tag}.rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                        "--mesh-worker", str(job_path), str(r)],
                                       stdout=log, stderr=subprocess.STDOUT, env=env), log))
    t0 = time.monotonic()
    deadline = t0 + (SERVE_MESH_TIMEOUT_S if serve else MESH_TIMEOUT_S)
    try:
        while any(p.poll() is None for p, _ in procs) and time.monotonic() < deadline:
            if any(p.returncode not in (None, 0) for p, _ in procs):
                break
            time.sleep(0.5)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        store.unlink(missing_ok=True)
    failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = "\n".join(f"rank {r} exited {procs[r][0].returncode}:\n"
                          + (out_dir / f"mesh_{tag}.rank{r}.log").read_text()[-3000:]
                          for r in failed)
        raise AssertionError(f"mesh job {tag} failed after {time.monotonic() - t0:.0f} s:\n"
                             f"{tails}")
    return [json.loads(Path(f"{job_path}.rank{r}.json").read_text()) for r in range(world)]


def mesh_rel(got: dict, ref: dict) -> float:
    """The largest relative gap between two runs' losses and gradient
    norms, step by step."""
    pairs = list(zip(got["losses"], ref["losses"])) + list(zip(got["grad_norms"],
                                                                ref["grad_norms"]))
    return max(abs(a - b) / abs(b) for a, b in pairs)


def phase_train_mesh(res: dict, steps: int) -> None:
    """llama-1b (d_model 2048, MESH_L of its 16 layers, 16 heads of 128),
    bf16 compute, fp32 masters, AdamW, checkpointing, flash kernels,
    ``steps`` steps each, a rank a process through NCCL on cuda:0: at world
    1 the no-mesh program and the mesh program at stage 3 (seq 2048 × 4;
    the losses must be bitwise equal), and the mesh program at seq 8192 × 1
    (MESH_SEQ_L layers), in this process; on two ranks, a process each
    (fsdp=2) at stage 3, seq 2048 × 2 a rank; a ring over sequence=2 and
    Ulysses over sequence=2, seq 8192 × 1 at MESH_SEQ_L layers; tensor
    parallelism at model=2, seq 2048 × 4
    (``tp2``); moe-8x7b at MOE_TRAIN_LAYERS layers on model=2,
    seq 2048 × 2 (``ep2``, held to ``w1_moe``, the same at world 1). Each
    two-rank run is held to the world-1 run at the same global batch within
    MESH_LOSS_REL (ep2: MESH_EP_LOSS_REL; losses and gradient norms of every
    step), its ranks must report the same losses and norms, its launches
    are checked exactly per rank, and its step time, peak memory and the
    bytes each collective moved a step are reported per rank."""
    out = res["train_mesh"] = {"steps": steps, "accum": 1, "runs": {}, "launches": {}}
    one = [{"runs": mesh_world1(["nomesh", "w1_2048", "w1_8192", "w1_moe", "w1_lora",
                                 "w1_ada"], steps)}]
    two = mesh_launch(["fsdp2", "ring2", "ulysses2", "tp2", "ep2", "lora_tp2",
                       "adafactor_tp2"], 2, steps, "w2")
    fails = mesh_checks(out, (one, two), steps)
    if fails:
        raise AssertionError("; ".join(fails))


def state_bound(name: str) -> float:
    """The bound of a mesh run's gap to its world-1 run (train_faults.py,
    each set from planted faults): MESH_LOSS_REL, ep2's
    MESH_EP_LOSS_REL, int8's STATE_INT8_LOSS_REL, the other
    train_mesh_state runs' STATE_LOSS_REL."""
    import train_faults as tf

    if name == "ep2":
        return tf.MESH_EP_LOSS_REL
    if name in ("int8_d2", "tp2_int8"):
        return tf.STATE_INT8_LOSS_REL
    if name in STATE_RUNS:
        return tf.STATE_LOSS_REL
    return tf.MESH_LOSS_REL


def mesh_checks(out: dict, groups, steps: int) -> list:
    """The checks of each mesh run of ``groups`` (each a list of the
    ranks' results): the ranks' losses and norms equal, attention as
    resolved, launches exact per rank, the loss falling, and the gap to
    the world-1 run within its bound; prints each run's numbers and
    records them in ``out``. Returns the failures."""
    fails = []
    one, two = groups
    for ranks in (one, two):
        for name in ranks[0]["runs"]:
            world, _, _, ref, impl = MESH_RUNS[name]
            runs = [r["runs"][name] for r in ranks]
            out["runs"][name] = runs
            bound = state_bound(name)
            if any((r["losses"], r["grad_norms"]) != (runs[0]["losses"], runs[0]["grad_norms"])
                   for r in runs):
                fails.append(f"{name}: the ranks' losses or gradient norms differ")
            for rank, run in enumerate(runs):
                if run["impl"] != impl:
                    fails.append(f"{name}: attention resolved to {run['impl']!r}")
                want = {k: v * steps for k, v in _mesh_want(name, rank).items()}
                got = {k: v for k, v in run["launches"].items() if v}
                if got != want:
                    fails.append(f"{name} rank {rank}: launches {got} != {want}")
                if name != "nomesh":
                    for k, v in run["launches"].items():
                        out["launches"][k] = out["launches"].get(k, 0) + v
                if not all(math.isfinite(x) for x in run["losses"]) or not all(
                        b < a for a, b in zip(run["losses"][1:], run["losses"][2:])):
                    fails.append(f"{name} rank {rank}: losses {run['losses']}")
                step = min(run["step_ms_each"][1:] or run["step_ms_each"])
                moved = {k: v for k, v in run["moved_bytes_per_step"].items() if v}
                print(f"train_mesh {name} rank {rank}: losses "
                      f"{[round(x, 5) for x in run['losses']]}, step {step:.1f} ms, peak "
                      f"{run['peak_mem_gib']:.2f} GiB, bytes moved a step {moved} ({_card_line()})",
                      flush=True)
                if ref is None:
                    continue
                ref_run = out["runs"][ref][0]
                rel = mesh_rel(run, ref_run)
                run["rel_to_" + ref] = rel
                bitwise = run["losses"] == ref_run["losses"]
                run["bitwise_to_" + ref] = bitwise
                print(f"train_mesh {name} rank {rank} against {ref}: losses bitwise {bitwise}, "
                      f"largest relative gap {rel:.3e} (bound {bound})", flush=True)
                if world == 1 and not bitwise:
                    fails.append(f"{name}: losses {run['losses']} not bitwise {ref}'s "
                                 f"{ref_run['losses']}")
                if not rel <= bound:
                    fails.append(f"{name} rank {rank}: relative gap {rel:.3e} to {ref}")
    return fails


def phase_train_mesh_state(res: dict, steps: int) -> None:
    """The training configurations of a mesh that hold its state apart, at
    llama-1b's width (d_model 2048, 16 heads of 128, d_ff 5504, vocab
    32000) and STATE_L layers, bf16 compute, fp32 masters, flash, ``steps``
    steps, two rank processes on cuda:0 through NCCL (as ``train_mesh``):
    ``place2`` (fsdp=2 at stage 3, masters and moments in each rank's
    pinned host memory, the shard uploaded before its gather), ``disk2``
    (fsdp=2 at stage 3, the disk tier spilling each rank's shards under a
    temporary directory), ``int8_d2`` (data=2, int8 products, the weight
    gradient's scales over both ranks), ``tp2_int8`` (model=2, int8
    products, o's and down's forward scales and the column products'
    input-gradient scales over both ranks), ``moe_seq2`` (moe-8x7b at
    STATE_MOE_L layer over sequence=2 by the ring, dense dispatch at
    capacity factor 0.5, seq 4096 × 2, the second rank's buffer positions
    after the first's) and ``pipe_ckpt`` (pipe=2, gpipe, one microbatch of
    4 × 2048; then a save, a bitwise restore on the ranks, and the checkpoint read
    whole at world 1 in this process, equal to the ranks' crc32s of the
    whole params and moments). Each run is held to its world-1 run at the
    same global batch (in this process) by its bound from train_faults.py
    (:func:`state_bound`), its launches exact per rank; prints step ms,
    peak and pinned GiB and the bytes each collective and the host copies
    moved a step per rank."""
    import shutil
    import tempfile

    import torch

    from tpu_engine_torch import checkpoint as ck
    from tpu_engine_torch import reshard
    from tpu_engine_torch.train import build_train_program

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_state_"))
    out = res["train_mesh_state"] = {"steps": steps, "accum": 1, "runs": {}, "launches": {},
                                     "card": _card_line(), "layers": STATE_L}
    free, total = torch.cuda.mem_get_info()
    host = _meminfo()
    print(f"train_mesh_state: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} "
          f"GiB; the card has {free / 2**30:.2f} of {total / 2**30:.2f} GiB free, the host "
          f"{host['MemAvailable'] / 2**30:.1f} of {host['MemTotal'] / 2**30:.1f} GiB", flush=True)
    try:
        one = [{"runs": mesh_world1(list(dict.fromkeys(MESH_RUNS[r][3] for r in STATE_RUNS)),
                                    steps)}]
        two = mesh_launch(list(STATE_RUNS), 2, steps, "state", work=str(work))
        fails = mesh_checks(out, (one, two), steps)
        for name in STATE_RUNS:
            for rank, run in enumerate(out["runs"].get(name, [])):
                print(f"train_mesh_state {name} rank {rank}: pinned {run['pinned_gib']:.3f} GiB, "
                      f"host copies a step {run['host_bytes_per_step']}, setup "
                      f"{run['setup_s']:.1f} s ({_card_line()})", flush=True)
        for rank, run in enumerate(out["runs"].get("place2", [])):
            if run["pinned_gib"] <= 0 or run["host_bytes_per_step"]["h2d"] <= 0:
                fails.append(f"place2 rank {rank}: nothing pinned or streamed")
        for rank, run in enumerate(out["runs"].get("tp2_int8", [])):
            probe = run["row_scales"]
            print(f"train_mesh_state tp2_int8 rank {rank}: o's and down's forward scales, "
                  f"{probe['checked']} operands held to the whole operand's absmax "
                  f"(all-gathered over model), {probe['differ']} differ", flush=True)
            if probe["checked"] == 0 or probe["differ"]:
                fails.append(f"tp2_int8 rank {rank}: row-parallel scales {probe}")
        ckpts = [run["ckpt"] for run in out["runs"].get("pipe_ckpt", [])]
        for rank, c in enumerate(ckpts):
            print(f"train_mesh_state pipe_ckpt rank {rank}: saved {c['bytes']} B in "
                  f"{c['save_s']:.2f} s, restored in {c['restore_s']:.2f} s, bitwise "
                  f"{c['bitwise']}", flush=True)
            if not c["bitwise"] or c["step"] != steps:
                fails.append(f"pipe_ckpt rank {rank}: restore step {c['step']}, bitwise "
                             f"{c['bitwise']}")
        if ckpts:  # the checkpoint read whole at world 1
            cfg, model_cfg = _mesh_cfg("w1_state")
            prog = build_train_program(cfg, model_cfg, device="cuda")
            t0 = time.perf_counter()
            step, state = ck.TrainCheckpointManager(ckpts[0]["path"]).restore(
                ck.abstract_state_like(prog))
            torch.cuda.synchronize()
            whole_s = time.perf_counter() - t0
            got = {"params": reshard.leaf_checksums(state["params"]),
                   **{n: reshard.leaf_checksums(state["opt_state"][n]) for n in ("mu", "nu")}}
            same = got == ckpts[0]["checksums"]
            out["pipe_ckpt_world1"] = {"step": step, "equal": same, "seconds": whole_s}
            print(f"train_mesh_state pipe_ckpt: read whole at world 1 in {whole_s:.2f} s, "
                  f"step {step}, params and moments equal the ranks' {same}", flush=True)
            if step != steps or not same:
                fails.append(f"pipe_ckpt at world 1: step {step}, equal {same}")
            del prog, state
        if fails:
            raise AssertionError("; ".join(fails))
    finally:
        shutil.rmtree(work, ignore_errors=True)
        _free()


JOB_L = 2            # llama-1b's layers in train_job
JOB_STEPS = 8        # job (a)'s last step
JOB_CKPT_EVERY = 4   # its checkpoint interval
JOB_NAN_STEP = 6     # the step whose loss is reported NaN
JOB_B_WARM = 10      # job (b)'s steps before the fleet is read under load
JOB_B_MAX = 60       # its steps at most: the simulated preemption after them
# The HBM estimate's params and optimizer-state terms against the bytes the
# program's state holds: equal up to the estimate's rounding to 1e-4 GiB.
JOB_HBM_REL = 1e-3


def _job_cfg(ck: str):
    """train_job's TrainConfig: ``train``'s llama-1b fields, the job's
    checkpoints on ``ck``, every step logged to ``ck``'s metrics file."""
    return _llama_1b_cfg(attention_impl="flash", checkpoint_dir=ck,
                         checkpoint_interval_steps=JOB_CKPT_EVERY, log_every_steps=1,
                         metrics_log_path=os.path.join(ck, "metrics.jsonl"), total_steps=100)


def _job_records(ck: str, job_id: str) -> list:
    with open(os.path.join(ck, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["job_id"] == job_id]


def _plain_losses(cfg, model_cfg, steps: range, restore_from=None, ck=None, lr_scale=1.0,
                  batch_fn=None):
    """A plain ``TrainProgram.step`` loop over ``steps`` on the synthetic
    batch of each step (or ``batch_fn(step)``), from a fresh init or
    restored from ``ck``'s ``restore_from`` (``lr_scale`` then set): its
    losses."""
    import torch

    from tpu_engine_torch import checkpoint as ckm
    from tpu_engine_torch.train import build_train_program

    prog = build_train_program(cfg, model_cfg, device="cuda")
    if restore_from is None:
        state = prog.init()
    else:
        mgr = ckm.TrainCheckpointManager(ck, program=prog)
        got, state = mgr.restore(ckm.abstract_state_like(prog), step=restore_from)
        if got != restore_from:
            raise AssertionError(f"plain restore of step {restore_from} gave {got}")
        state["lr_scale"] = lr_scale
    losses = []
    for i in steps:
        state, m = prog.step(state, batch_fn(i) if batch_fn else prog.synthetic_batch(i))
        losses.append(float(m["loss"]))
    del prog, state
    torch.cuda.empty_cache()
    return losses


def phase_train_job(res: dict) -> None:
    """The port's supervised ``TrainingJob`` (module docstring, train_job):
    job (a) drives ``train``'s path through the supervisor (every launch
    counter set to 0 just before it, read just after: K1 twice a layer a
    step, K2 and K3 once); its planted NaN comes through the step seam of
    ``tests/test_checkpoint_supervisor.py``. The trace is taken through
    its ``fleet_fn``, which the loop calls after each step's timing
    closes: after step 2 and after step 4 it waits while this thread
    starts and stops the capture (``TraceSession`` keeps a capture of the
    card on the main thread). The fleet and nvidia-smi are read from this
    thread while job (b)'s steps run (nvidia-smi's utilization is an
    average over its last sample period), after JOB_B_WARM steps; (b) is
    preempted once the reading is taken, or at JOB_B_MAX steps."""
    import shutil
    import threading

    import torch

    from tpu_engine_torch import compile_index, hbm_estimate, telemetry, tpu_manager
    from tpu_engine_torch.models.config import MODEL_CONFIGS
    from tpu_engine_torch.models import transformer as tfm
    from tpu_engine_torch.ops import _flash_cuda as fc
    from tpu_engine_torch.profiler import TraceSession
    from tpu_engine_torch.supervisor import JobStatus, TrainingJob
    from tpu_engine_torch.train import build_train_program

    ck = str(ROOT / "chiprun_out" / "train_job_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    os.makedirs(ck)
    trace_dir = str(ROOT / "chiprun_out" / "train_job_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    cfg = _job_cfg(ck)
    model_cfg = MODEL_CONFIGS["llama-1b"].with_(n_layers=JOB_L)
    out = res["train_job"] = {"steps": 0, "accum": 1, "card": _card_line(), "layers": JOB_L}
    fails = []
    t_phase = time.perf_counter()
    session = TraceSession()
    try:
        # (a) rollback. The program is built here so that its step can be
        # wrapped with the NaN.
        prog = build_train_program(cfg, model_cfg, device="cuda")
        real = prog.step
        seen = {"nan": False}

        def step(state, batch):
            new, metrics = real(state, batch)
            if new["step"] == JOB_NAN_STEP and not seen["nan"]:
                seen["nan"] = True
                metrics = dict(metrics, loss=torch.tensor(float("nan"), device="cuda"))
            return new, metrics

        asked = {2: threading.Event(), 4: threading.Event()}  # capture start, stop
        answered = {2: threading.Event(), 4: threading.Event()}

        def fleet_fn():
            n = holder["a"].current_step
            if seen["nan"]:
                return None
            torch.cuda.synchronize()
            if n in asked and not answered[n].is_set():
                asked[n].set()
                answered[n].wait(120)
            return None

        prog.step = step
        holder = {}
        torch.cuda.reset_peak_memory_stats()  # the job's own peak, not an earlier phase's
        fc.reset_launches()
        job_a = holder["a"] = TrainingJob("job-a", cfg, program=prog, max_steps=JOB_STEPS,
                                          stable_margin_steps=1, devices=[0], fleet_fn=fleet_fn)
        t0 = time.perf_counter()
        job_a.start()
        for n in (2, 4):  # the capture covers steps 3 and 4
            while not asked[n].wait(0.2) and job_a.is_alive:
                pass
            if asked[n].is_set():
                if n == 2:
                    session.start(trace_dir)
                else:
                    session.stop()
            answered[n].set()
        job_a.join(600)
        a_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(fc.launches)
        executed = JOB_NAN_STEP + (JOB_STEPS - 4)
        out.update(steps=executed, launches=launches, job_a_s=a_s)
        want = {"flash_fwd": 2 * JOB_L * executed, "flash_bwd_dq": JOB_L * executed,
                "flash_bwd_dkv": JOB_L * executed}
        got = {k: v for k, v in launches.items() if v}
        out["launches_expected"] = want
        if got != want:
            fails.append(f"job (a) launches {got} != {want}")
        d = job_a.describe()
        out["job_a"] = {k: d[k] for k in ("status", "rollback_count", "current_step",
                                          "tokens_per_sec", "last_step_time_s")}
        out["job_a"]["lr_scale"] = float(job_a._state["lr_scale"])
        print(f"train_job (a): {d['status']} at step {d['current_step']}, rollbacks "
              f"{d['rollback_count']}, lr_scale {job_a._state['lr_scale']}, {a_s:.1f} s, "
              f"launches {got}, error {job_a.error}", flush=True)
        if (job_a.status, job_a.rollback_count, out["job_a"]["lr_scale"],
                job_a.current_step) != (JobStatus.COMPLETED, 1, 0.5, JOB_STEPS):
            fails.append(f"job (a): {job_a.status} rollbacks {job_a.rollback_count} lr_scale "
                         f"{out['job_a']['lr_scale']} step {job_a.current_step}")

        traces = sorted(Path(trace_dir).glob("trace_*.json"))
        names = set()
        if traces:
            names = {e.get("name", "") for e in json.loads(traces[-1].read_text()).get(
                "traceEvents", []) if e.get("cat") == "kernel"}
        k123 = {k: sorted(n for n in names if k in n)
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        out["trace"] = {"files": [t.name for t in traces], "bytes": [t.stat().st_size
                                                                     for t in traces],
                        "kernels": len(names), "k1_k3": k123}
        print(f"train_job trace: {len(traces)} file(s), {len(names)} kernel names, "
              f"K1-K3 {k123}", flush=True)
        if not all(k123.values()):
            fails.append(f"the two-step trace names no launch of some of K1-K3: {k123}")

        # The profiler's MFU against tokens/s x flops per token / the peak.
        prof = d["profile"] or {}
        flops_tok = tfm.train_flops_per_token(prog.model_config, cfg.seq_len)
        tps = prof.get("tokens_per_sec_per_chip")
        mine = None if not tps else tps * flops_tok / PEAK_BF16_FLOPS
        out["mfu"] = {"profiler": prof.get("mfu"), "tokens_per_s": tps, "recomputed": mine,
                      "step_ms": prof.get("total"), "phases": prof.get("phases")}
        print(f"train_job MFU: profiler {prof.get('mfu')}, tokens/s {tps} x "
              f"{flops_tok:.4e} FLOP/token / {PEAK_BF16_FLOPS:.3e} = {mine}; its window's "
              f"step ms {prof.get('total')}, phases {prof.get('phases')} ({_card_line()})",
              flush=True)
        if prof.get("mfu") is None or abs(prof["mfu"] - mine) > 1e-3 * mine + 1e-4:
            fails.append(f"profiler MFU {prof.get('mfu')} vs recomputed {mine}")

        # The HBM estimate beside the state's bytes.
        est = hbm_estimate.estimate_job_hbm(cfg, 1, model_cfg=model_cfg)
        state = job_a._state
        held = {"params_gib": hbm_estimate.per_device_bytes(state["params"], False) / 2**30,
                "opt_gib": hbm_estimate.per_device_bytes(state["opt_state"], False) / 2**30}
        out["hbm"] = {"estimate": est.model_dump(), "state": held,
                      "max_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"train_job HBM estimate {est.model_dump()}; the state holds {held}; "
              f"max allocated {out['hbm']['max_allocated_gib']:.2f} GiB", flush=True)
        for k, v in held.items():
            if abs(getattr(est, k) - v) > JOB_HBM_REL * v:
                fails.append(f"estimate {k} {getattr(est, k)} vs the state's {v:.4f}")
        recs = {(r["kind"], r["step"], r["rollback"]): r for r in _job_records(ck, "job-a")}
        del prog, state
        job_a._state = None

        # (a)'s losses against plain loops: before the NaN from init; after
        # it from the stable step at lr_scale 0.5.
        before = [recs[("train", s, 0)]["loss"] for s in range(1, JOB_NAN_STEP)]
        after = [recs[("train", s, 1)]["loss"] for s in range(5, JOB_STEPS + 1)]
        plain_before = _plain_losses(cfg, model_cfg, range(JOB_NAN_STEP - 1))
        plain_after = _plain_losses(cfg, model_cfg, range(4, JOB_STEPS), restore_from=4, ck=ck,
                                    lr_scale=0.5)
        out["losses"] = {"before": before, "plain_before": plain_before, "after": after,
                         "plain_after": plain_after}
        print(f"train_job (a) losses before the NaN {before}, plain {plain_before}; after "
              f"the rollback {after}, plain from step 4 at lr_scale 0.5 {plain_after}",
              flush=True)
        if before != plain_before or after != plain_after:
            fails.append("job (a)'s losses are not bitwise the plain loops'")

        # (b) read under load, then preempted; (c) resumed: each builds its
        # own program. (b) saves only when preempted.
        taken = {}
        job_b = TrainingJob("job-b", dataclasses.replace(cfg, checkpoint_interval_steps=1000),
                            max_steps=JOB_STEPS + JOB_B_MAX + 10, watch_preemption=True,
                            simulate_preemption_check=lambda: "fleet" in taken
                            or holder["b"].current_step >= JOB_STEPS + JOB_B_MAX, devices=[0],
                            model_config=model_cfg, fleet_fn=lambda: taken.get("fleet"))
        holder["b"] = job_b
        t0 = time.perf_counter()
        job_b.start()
        while job_b.is_alive and job_b.current_step < JOB_STEPS + JOB_B_WARM:
            time.sleep(0.01)
        steps_read = [job_b.current_step]
        snap = telemetry.NvidiaSmiSource(min_interval_s=0).sample(torch.cuda.device_count())
        fleet = tpu_manager.TPUManager().get_fleet_status()
        steps_read.append(job_b.current_step)
        taken["fleet"] = fleet
        job_b.join(600)
        b_s = time.perf_counter() - t0

        # The fleet and nvidia-smi, read while (b)'s steps ran.
        card = fleet.devices[0] if fleet.devices else None
        smi_total_gib = snap.per_chip[0].get("hbm_total_gb", 0.0) if snap else 0.0
        out["fleet"] = fleet.model_dump(mode="json")
        out["fleet_steps"] = steps_read
        print(f"train_job fleet, read while job (b) took steps {steps_read[0]} to "
              f"{steps_read[1]}: {fleet.total_devices} device(s), sources "
              f"{fleet.telemetry_sources}, alerts {fleet.fleet_alerts}", flush=True)
        busy = None
        if card is not None:
            busy = (card.duty_cycle_pct is not None
                    and card.duty_cycle_pct >= tpu_manager.TPUManager.DUTY_WARNING_PCT)
            print(f"train_job fleet device 0: {card.device_kind}, HBM {card.hbm_used_gb:.2f} of "
                  f"{card.hbm_total_gb:.2f} GiB (nvidia-smi {smi_total_gib:.2f}), health "
                  f"{card.health_status.value}, duty {card.duty_cycle_pct}, "
                  f"{card.temperature_c} C, {card.power_draw_w} of {card.power_limit_w} W, "
                  f"throttle {card.throttle_score}, alerts {card.alerts}, jobs "
                  f"{[j.model_dump() for j in card.jobs]}", flush=True)
        health = tpu_manager.TPUHealthStatus
        if (card is None or fleet.total_devices != torch.cuda.device_count()
                or card.device_kind != torch.cuda.get_device_name(0)
                or abs(card.hbm_total_gb - smi_total_gib) > 0.01 * smi_total_gib
                or [j.job_id for j in card.jobs] != ["job-b"]):
            fails.append("fleet status: not one card holding job-b with the card's name and "
                         "memory")
        elif steps_read[1] <= steps_read[0] or not card.duty_cycle_pct:
            fails.append(f"fleet status: not read under load (steps {steps_read}, duty "
                         f"{card.duty_cycle_pct})")
        elif (card.health_status != (health.WARNING if busy else health.HEALTHY)
                or [a for a in card.alerts if "duty cycle" not in a]):
            fails.append(f"fleet status: {card.health_status.value} with alerts {card.alerts} "
                         f"at duty {card.duty_cycle_pct}")
        out["telemetry"] = None if snap is None else snap.per_chip
        print(f"train_job nvidia-smi snapshot: {out['telemetry']}", flush=True)
        if snap is None:
            fails.append("the nvidia-smi telemetry source returned no snapshot on the card")
        saved = job_b.ckpt.latest_step()
        out["job_b"] = {"status": job_b.status.value, "resumed_from_step": job_b.resumed_from_step,
                        "current_step": job_b.current_step, "saved": saved, "seconds": b_s,
                        "reason": job_b.preemption_reason}
        print(f"train_job (b): {out['job_b']}, error {job_b.error}", flush=True)
        if (job_b.status != JobStatus.PREEMPTED or job_b.resumed_from_step != JOB_STEPS
                or saved != job_b.current_step or saved >= JOB_STEPS + JOB_B_MAX):
            fails.append(f"job (b): {out['job_b']}")
        records = compile_index.get_index().stats()["records_total"]
        job_c = TrainingJob("job-c", cfg, max_steps=job_b.current_step + 2, devices=[0],
                            model_config=model_cfg)
        t0 = time.perf_counter()
        job_c.start()
        job_c.join(600)
        c_s = time.perf_counter() - t0
        entries = compile_index.get_index().entries()
        out["job_c"] = {"status": job_c.status.value, "resumed_from_step": job_c.resumed_from_step,
                        "current_step": job_c.current_step, "seconds": c_s,
                        "compile_index": entries}
        print(f"train_job (c): {job_c.status.value}, resumed from {job_c.resumed_from_step}, "
              f"step {job_c.current_step}, {c_s:.1f} s, error {job_c.error}; compile index "
              f"{[(e.get('label'), e['warm'], e['last_compile_s']) for e in entries]}",
              flush=True)
        if (job_c.status != JobStatus.COMPLETED or job_c.resumed_from_step != job_b.current_step
                or compile_index.get_index().stats()["records_total"] != records + 1):
            fails.append(f"job (c): {out['job_c']}")
        out["phase_s"] = time.perf_counter() - t_phase
        if fails:
            raise AssertionError("; ".join(fails))
    finally:
        if session.active:
            session.stop()
        shutil.rmtree(ck, ignore_errors=True)
        shutil.rmtree(trace_dir, ignore_errors=True)
        _free()


FLEET_L = 2              # llama-1b's layers in the scheduler's jobs of train_fleet (c)
FLEET_LOW_STEPS = 8      # job L's last step
FLEET_HIGH_STEPS = 4     # job H's
FLEET_PREEMPT_AT = 4     # L's first attempt's batch of this step waits to be preempted
FLEET_WAIT_S = 120.0     # the longest wait for any scheduler state of (c)


def _fleet_losses(path: str) -> dict:
    """{step: loss} of a job's metrics log (``kind == "train"``, newest wins)."""
    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f) if r.get("kind") == "train"}


def _await(pred, what: str, timeout: float = FLEET_WAIT_S, detail=None) -> None:
    """Wait for ``pred``; past ``timeout`` raise, naming ``what`` and what
    ``detail()`` says of the scheduler then."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"train_fleet: {what} not reached in {timeout:.0f} s"
                                 + (f": {detail()}" if detail else ""))
        time.sleep(0.02)


def phase_train_fleet(res: dict) -> None:
    """The fleet's scheduling half (module docstring, train_fleet): (a) the
    launcher's CLI dry run in a subprocess; (b) ``TPULauncher().launch`` of
    the 1b preset at fsdp=1, full depth, 3 steps (every launch counter set
    to 0 just before, read just after: K1 twice a layer a microbatch, K2
    and K3 once); (c) a ``FleetScheduler`` over the card's live fleet: L
    preempted by H, requeued and resumed bitwise, a llama-70b submission
    held by the HBM gate, the goodput account of L and H."""
    import shutil

    import torch

    from tpu_engine_torch import goodput, tracing
    from tpu_engine_torch.launcher import TPULauncher
    from tpu_engine_torch.mesh_runtime import MeshConfig
    from tpu_engine_torch.models.config import MODEL_CONFIGS
    from tpu_engine_torch.ops import _flash_cuda as fc
    from tpu_engine_torch.scheduler import FleetScheduler, JobPriority
    from tpu_engine_torch.tpu_manager import TPUManager
    from tpu_engine_torch.train import TrainConfig

    work = ROOT / "chiprun_out" / "train_fleet"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = res["train_fleet"] = {"card": _card_line()}
    fails = []
    t_phase = time.perf_counter()
    cli = None
    try:
        # (a) The CLI, as a user starts it: a process of its own, read after
        # (b) and (c), beside which it runs (its 10-15 s are imports and one
        # nvidia-smi read).
        t_cli = time.perf_counter()
        cli = subprocess.Popen([sys.executable, "-m", "tpu_engine_torch.launcher", "--preset",
                                "1b", "--dry-run"], cwd=ROOT, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
        # (b) The launcher at full width and depth: the 1b preset on one card
        # (fsdp=1), train's learning rate on one repeated batch so that the
        # loss can fall in 3 steps.
        launcher = TPULauncher()
        preset = launcher.presets()["1b"]
        cfg = dataclasses.replace(preset, mesh=MeshConfig(data=1, fsdp=1), log_every_steps=1,
                                  metrics_log_path=str(work / "launch.jsonl"), **TRAIN_LR)
        accum, micro = cfg.gradient_accumulation_steps, cfg.micro_batch_size
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = torch.randint(0, MODEL_CONFIGS["llama-1b"].vocab_size, (accum, micro, cfg.seq_len),
                              generator=gen, device="cuda")
        steps = 3
        torch.cuda.synchronize()
        fc.reset_launches()
        t0 = time.perf_counter()
        launched = launcher.launch(cfg, max_steps=steps, block=True, data_fn=lambda step: batch)
        torch.cuda.synchronize()
        launch_s = time.perf_counter() - t0
        launches = {k: v for k, v in fc.launches.items() if v}
        job = launcher.get_job(launched.job_id)
        L = MODEL_CONFIGS["llama-1b"].n_layers
        want = {"flash_fwd": 2 * L * steps * accum, "flash_bwd_dq": L * steps * accum,
                "flash_bwd_dkv": L * steps * accum}
        losses = [v for _, v in sorted(_fleet_losses(work / "launch.jsonl").items())]
        d = job.describe() if job is not None else {}
        impl = job.program.model_config.attention_impl if job and job.program else None
        out.update(steps=steps, accum=accum, launches=launches, launches_expected=want)
        out["launch"] = {"status": launched.status, "job": d.get("status"), "losses": losses,
                         "seconds": launch_s, "attention": impl,
                         "device": str(job.program.device) if job and job.program else None,
                         "last_step_time_s": d.get("last_step_time_s")}
        print(f"train_fleet (b) TPULauncher().launch(1b preset, fsdp=1, {steps} steps of "
              f"{accum} x {micro} x {cfg.seq_len}): {launched.status}, job {d.get('status')}, "
              f"{launch_s:.1f} s, losses {losses}, attention {impl}, launches {launches}, "
              f"error {launched.error or (job.error if job else None)}", flush=True)
        if (launched.status != "launched" or d.get("status") != "completed"
                or impl != "flash" or out["launch"]["device"] != "cuda:0"):
            fails.append(f"launch: {out['launch']}")
        if (len(losses) != steps or not all(math.isfinite(x) for x in losses)
                or not all(b < a for a, b in zip(losses[1:], losses[2:]))):
            fails.append(f"launch losses {losses}: not {steps} finite ones falling after step 0")
        if launches != want:
            fails.append(f"launch counts {launches} != {want}")
        if job is not None:
            launcher.delete_job(launched.job_id)
            job._state = job.program = None
        launcher.scheduler.shutdown()
        del job, launcher, batch
        _free()

        # (c) The scheduler over the card's live fleet.
        model_cfg = MODEL_CONFIGS["llama-1b"].with_(n_layers=FLEET_L)
        sched = FleetScheduler(max_concurrent_jobs=1, fleet_fn=TPUManager().get_fleet_status,
                               poll_interval_s=0.05)
        base = _llama_1b_cfg(attention_impl="flash", log_every_steps=1, total_steps=100)
        # L saves only when preempted and at its end; H keeps no checkpoint.
        lcfg = dataclasses.replace(base, metrics_log_path=str(work / "low.jsonl"),
                                   checkpoint_dir=str(work / "low_ckpt"),
                                   checkpoint_interval_steps=1000)
        shape = (1, base.micro_batch_size, base.seq_len)

        def fleet_batch(step: int):
            g = torch.Generator(device="cuda").manual_seed(1000 + step)
            return torch.randint(0, model_cfg.vocab_size, shape, generator=g, device="cuda")

        subs: dict = {}

        def where():
            fleet = sched._fleet()
            card = fleet.devices[0] if fleet and fleet.devices else None
            return {"subs": {n: (x.state.value, x.attempts, x.last_skip_reason,
                                 x.job.current_step if x.job else None,
                                 x.job.error if x.job else None) for n, x in subs.items()},
                    "card": None if card is None else (card.is_available, card.duty_cycle_pct,
                                                       round(card.hbm_used_gb, 2),
                                                       card.health_status.value)}

        def low_batch(step: int):
            # L's first attempt waits here at FLEET_PREEMPT_AT until the
            # scheduler has asked it to save (it may ask sooner): the
            # preemption then lands mid-run, whatever the card's speed.
            low = subs["low"]
            if step >= FLEET_PREEMPT_AT and low.attempts == 1:
                _await(lambda: low.job is not None and low.job.watcher.fired,
                       "the preemption request", detail=where)
            return fleet_batch(step)

        t0 = time.perf_counter()
        try:
            low = subs["low"] = sched.submit(
                lcfg, priority=JobPriority.LOW, job_kwargs={
                    "max_steps": FLEET_LOW_STEPS, "model_config": model_cfg,
                    "data_fn": low_batch})
            _await(lambda: low.job is not None and low.job.current_step >= 3,
                   "L's step 3", detail=where)
            high = sched.submit(base, priority=JobPriority.HIGH, job_kwargs={
                "max_steps": FLEET_HIGH_STEPS, "model_config": model_cfg,
                "data_fn": fleet_batch})
            _await(lambda: high.state.value in ("completed", "failed"), "H's end",
                   detail=where)
            high_attempt = high.job
            _await(lambda: low.state.value in ("completed", "failed"), "L's end",
                   detail=where)
            sched_s = time.perf_counter() - t0
            st = sched.stats()
            resumed = low.job.resumed_from_step
            jobs = {"low": low, "high": high}
            out["scheduler"] = {
                "seconds": sched_s,
                **{k: st[k] for k in ("preemptions_total", "requeues_total", "completed_total",
                                      "failed_total")},
                **{n: {"state": s.state.value, "attempts": s.attempts,
                       "preemptions": s.preemptions, "placement": s.placement,
                       "skip": s.last_skip_reason,
                       "attention": s.job.program.model_config.attention_impl
                       if s.job.program else None,
                       "device": str(s.job.program.device) if s.job.program else None,
                       "step": s.job.current_step, "resumed_from_step": s.job.resumed_from_step,
                       "error": s.job.error, "step_s": s.job.last_step_time_s}
                   for n, s in jobs.items()}}
            print(f"train_fleet (c) scheduler: {json.dumps(out['scheduler'])}", flush=True)
            if (st["preemptions_total"], st["requeues_total"], st["completed_total"]) != (1, 1, 2):
                fails.append(f"scheduler counters {st['preemptions_total']}/"
                             f"{st['requeues_total']}/{st['completed_total']} != 1/1/2")
            for n, s in jobs.items():
                o = out["scheduler"][n]
                if s.state.value != "completed" or o["attention"] != "flash" or \
                        o["device"] != "cuda:0":
                    fails.append(f"job {n}: {o}")
            if not (low.preemptions == 1 and low.attempts == 2 and resumed is not None
                    and 3 <= resumed < FLEET_LOW_STEPS
                    and low.job.current_step == FLEET_LOW_STEPS
                    and high_attempt.current_step == FLEET_HIGH_STEPS):
                fails.append(f"L preempted {low.preemptions}, attempts {low.attempts}, resumed "
                             f"from {resumed}, step {low.job.current_step}")
            else:
                got = _fleet_losses(work / "low.jsonl")
                after = [got[s] for s in range(resumed + 1, FLEET_LOW_STEPS + 1)]
                plain = _plain_losses(lcfg, model_cfg, range(resumed, FLEET_LOW_STEPS),
                                      restore_from=resumed, ck=low.config.checkpoint_dir,
                                      batch_fn=fleet_batch)
                out["low_losses"] = {"after_resume": after, "plain": plain,
                                     "resumed_from_step": resumed}
                print(f"train_fleet L losses after the resume from step {resumed} {after}, "
                      f"a plain loop restored there {plain}", flush=True)
                if after != plain:
                    fails.append("L's losses after the resume are not bitwise the plain loop's")

            # The goodput account of each trace (closed at its terminal state).
            rec = tracing.get_recorder()
            out["goodput"] = {}
            for n, s in jobs.items():
                dec = goodput.decompose_trace(rec, s.trace_id)
                cats = dec["categories"]
                out["goodput"][n] = {"wall_s": dec["wall_s"], "categories": cats}
                print(f"train_fleet goodput {n}: wall {dec['wall_s']:.2f} s, "
                      + ", ".join(f"{k} {v:.2f}" for k, v in cats.items() if v), flush=True)
                if abs(sum(cats.values()) - dec["wall_s"]) > 0.01 * dec["wall_s"]:
                    fails.append(f"goodput {n}: categories sum {sum(cats.values())} vs wall "
                                 f"{dec['wall_s']}")
                need = ("productive", "preempt_drain", "restore", "queue_wait") if n == "low" \
                    else ("productive",)
                if not all(cats[k] > 0 for k in need):
                    fails.append(f"goodput {n}: {need} not all above 0: {cats}")

            # The planner on the one-card fleet: a gang of 1, its prediction
            # beside the measured step (neither gated).
            fleet = sched._fleet()
            eligible = [d for d in fleet.devices if d.is_available] if fleet else []
            plan = sched.planner.plan(lcfg, devices=eligible or None, reserved=dict(sched._reserved),
                                      n_avail=1)
            cut = sched.planner.predict(lcfg, gang=1, model_cfg=model_cfg)
            best = plan.best
            out["placement"] = {
                "best": best.label if best else None, "gang": best.gang if best else None,
                "predicted_step_s_16_layers": best.predicted_step_time_s if best else None,
                "predicted_step_s_cut": cut.predicted_step_time_s,
                "measured_step_s": low.job.last_step_time_s, "evaluated": plan.evaluated}
            print(f"train_fleet placement: {json.dumps(out['placement'])} ({_card_line()})",
                  flush=True)
            if best is None or best.gang != 1:
                fails.append(f"planner on one card: {out['placement']}")

            # llama-70b at fsdp=1: held by the HBM gate, then cancelled. Its
            # factory refuses: were the gate to let it through, nothing is built.
            def never(sub):
                raise AssertionError("llama-70b admitted past the HBM gate")

            big = sched.submit(TrainConfig(model_name="llama-70b", mesh=MeshConfig(data=1),
                                           micro_batch_size=1, seq_len=4096), job_factory=never)
            try:
                _await(lambda: "GiB/device" in (big.last_skip_reason or ""), "the HBM gate",
                       timeout=60, detail=lambda: (big.state.value, big.last_skip_reason,
                                                   where()["card"]))
            except AssertionError as e:
                fails.append(str(e))
            out["hbm_gate"] = {"state": big.state.value, "skip": big.last_skip_reason,
                               "estimate_gib": big.estimate.device_total_gib
                               if big.estimate else None}
            print(f"train_fleet llama-70b at fsdp=1: {json.dumps(out['hbm_gate'])}", flush=True)
            sched.cancel(big.submission_id)
            if big.state.value != "cancelled":
                fails.append(f"llama-70b: {out['hbm_gate']}")
        finally:
            for s in list(sched._subs.values()):
                if s.job is not None and s.job.is_alive:
                    s.job.stop()
            sched.shutdown()
        stdout, stderr = cli.communicate(timeout=300)
        plan = json.loads(stdout) if cli.returncode == 0 else {}
        out["cli"] = {"rc": cli.returncode, "seconds": time.perf_counter() - t_cli,
                      "status": plan.get("status"),
                      "mesh": plan.get("plan", {}).get("mesh"),
                      "placement": plan.get("plan", {}).get("placement", {}).get("ranked_plans")}
        print(f"train_fleet (a) CLI --preset 1b --dry-run: rc {cli.returncode}, done within "
              f"{out['cli']['seconds']:.1f} s, status {out['cli']['status']}, mesh "
              f"{out['cli']['mesh']}", flush=True)
        if cli.returncode != 0 or plan.get("status") != "dry_run":
            fails.append(f"CLI dry run: rc {cli.returncode}, {stderr[-1500:]}")
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"train_fleet: {out['phase_s']:.1f} s", flush=True)
        if fails:
            raise AssertionError("; ".join(fails))
    finally:
        if cli is not None and cli.poll() is None:
            cli.kill()
            cli.communicate()
        shutil.rmtree(work, ignore_errors=True)
        _free()


# serve_fleet: the port's serving fleet (serving_fleet, disagg, reshard's
# serving half, prefix_plane, autopilot, spec_pool) over one FleetScheduler
# on the card's live fleet, llama-1b at full width and depth (seed-0
# weights drawn in bf16 by build_replica_engine on each replica's thread,
# the same weights as _llama_1b's). (a) unified replicas with serve's
# batcher settings, scaled from 1 to 2 by an armed FleetAutopilot on a
# 100 ms p99 SLO; (b) disaggregated pools, fp32 wire and int8 wire into a
# kv_quant decode pool, then held-request migration and a prefix through
# the host tier on engines stepped here; (d) speculative fleets with
# llama-1b as its own draft and the 2-layer draft; (c) a replica whose pool
# leaves less headroom than a CRITICAL training job's estimate, evicted by
# the scheduler's own admission and readmitted after the job.
FLEET_SPEC = dict(model_name="llama-1b", max_slots=8, max_len=2048, prefill_chunk=256,
                  decode_chunk_steps=8, seed=0)
FLEET_NEW = 32              # new tokens of every request of (a), (b) and (d)
FLEET_P99_SLO_MS = 100.0    # (a)'s p99 SLO, which one replica misses under 8 requests: the autopilot scales
FLEET_SERVE_WAIT_S = 240.0  # the longest wait for any state of serve_fleet
# (c): an interactive fleet (one replica of FLEET_SPEC, NORMAL) and a batch
# fleet (one replica of EVICT_SLOTS x EVICT_LEN lanes, LOW) on the card, then
# a CRITICAL job of train_fleet's L shape (llama-1b's width at FLEET_L
# layers, 2048 x 4, EVICT_STEPS steps) whose estimate by the scheduler's
# default estimator (the config's llama-1b, 16 layers) is 16.0 GiB. The
# scheduler's headroom is the live free memory less every running
# submission's reservation; the batch replica's 54.77 GiB leaves it below
# the job's estimate, and keeps it below the batch replica's own while the
# job and the interactive replica hold theirs. The arithmetic is in
# PERF.md's serve_fleet findings.
EVICT_SLOTS, EVICT_LEN = 106, 4096
EVICT_REQUESTS, EVICT_NEW = 8, 16
EVICT_STEPS = 3


def _fleet_await(pred, what: str, timeout: float = FLEET_SERVE_WAIT_S, tick=None,
                 detail=None) -> float:
    """Wait for ``pred``, calling ``tick`` every 0.25 s between reads; the
    seconds waited. Past ``timeout`` raise, naming ``what`` and
    ``detail()``."""
    t0 = last = time.perf_counter()
    while not pred():
        now = time.perf_counter()
        if now - t0 > timeout:
            raise AssertionError(f"serve_fleet: {what} not reached in {timeout:.0f} s"
                                 + (f": {detail()}" if detail else ""))
        if tick is not None and now - last >= 0.25:
            tick()
            last = now
        time.sleep(0.02)
    return time.perf_counter() - t0


def _fresh_reading(sched):
    """The scheduler's fleet view with nvidia-smi read now: the port's
    telemetry serves one nvidia-smi reading for 10 s, so a reading taken
    while the card idles lets the admissions of the next seconds see it
    idle (its duty cycle gates availability at 90 %)."""
    from tpu_engine_torch import telemetry

    for src in telemetry.sources():
        if isinstance(src, telemetry.NvidiaSmiSource):
            src._cached_at = float("-inf")
    return sched._fleet()


def _card_memory() -> dict:
    import torch

    free, total = torch.cuda.mem_get_info()
    return {"total_gib": total / 2**30, "used_gib": (total - free) / 2**30}


def _stopped(fleet, *pools) -> None:
    """Stop a fleet and wait until each replica thread of its pools (the
    fleet itself, or ``pools``) has torn its engine down and returned its
    memory."""
    fleet.stop()
    subs = [s for pool in (pools or (fleet,)) for s in pool._replicas.values()]
    _fleet_await(lambda: all(s.job is None or not s.job.is_alive for s in subs),
                 "the replicas' teardown")


def _one_replica(lo: int = 1, hi: int = 1):
    from tpu_engine_torch.serving_fleet import AutoscalerConfig, ReplicaAutoscaler

    return ReplicaAutoscaler(AutoscalerConfig(min_replicas=lo, max_replicas=hi,
                                              target_queue_per_replica=1e6, p99_slo_ms=1e9,
                                              scale_down_cooldown_s=1e9))


def _first_logits(srv, prompt: list):
    """The prefill logits row that seeds ``prompt``'s first token on a
    batcher stepped here."""
    rows = []
    real = srv._first_token

    def spy(logits, req):
        rows.append(logits.float().clone())
        return real(logits, req)

    srv._first_token = spy
    rid = srv.submit(prompt, max_new_tokens=1)
    while srv.result(rid)["status"] not in ("done", "failed"):
        srv.step()
    srv._first_token = real
    return rows[0]


def _drive(srv, rids) -> None:
    while not all(srv.result(r)["status"] in ("done", "failed") for r in rids):
        srv.step()


def _fleet_unified(out: dict, fails: list, sched, state: dict, plan: list) -> None:
    """(a): 8 requests on one replica; the autopilot sees the p99 SLO burn
    and scales the fleet to 2; 8 more, the shared-prefix ones pinned to the
    replica holding the prefix."""
    from tpu_engine_torch import autopilot, goodput, historian
    from tpu_engine_torch import serving as tsrv
    from tpu_engine_torch.serving_fleet import ServingFleet, ServingReplicaSpec

    cfg, params = _llama_1b(state)
    hist = historian.MetricHistorian()
    alerter = goodput.get_alerter()
    goodput.set_alerter(goodput.SLOBurnRateAlerter(goodput.get_ledger(),
                                                   p99_slo_ms=FLEET_P99_SLO_MS, historian=hist))
    fleet = ServingFleet(sched, ServingReplicaSpec(**FLEET_SPEC, prefix_cache_tokens=1024),
                         autoscaler=_one_replica(1, 2), submitter="serve-fleet-a")
    ap = autopilot.FleetAutopilot(
        autopilot.AutopilotConfig(trend_window_s=60.0, sustain_consults=2, cooldown_s=600.0),
        dry_run=False, historian=hist, scheduler=sched, serving_fleet=fleet)
    try:
        t0 = time.perf_counter()
        _fresh_reading(sched)
        fleet.start()
        a = out["a"] = {"first_replica_s": _fleet_await(
            lambda: len(fleet.running_replicas()) == 1, "(a)'s first replica")}
        fids = {}

        def submit(idx):
            for i in idx:
                prompt, _, temp = plan[i]
                fids[i] = fleet.submit_request(prompt, FLEET_NEW, temp)

        def done(idx):
            return all(fleet.result(fids[i])["status"] in ("done", "failed") for i in idx)

        submit(range(8))
        a["wave1_s"] = _fleet_await(lambda: done(range(8)), "(a)'s first 8 requests",
                                    tick=ap.tick)
        _fresh_reading(sched)
        a["scale_up_s"] = _fleet_await(lambda: len(fleet.running_replicas()) == 2,
                                       "the autopilot's second replica", tick=ap.tick,
                                       detail=lambda: ap.decisions(limit=4))
        submit(range(8, 16))
        a["wave2_s"] = _fleet_await(lambda: done(range(8, 16)), "(a)'s last 8 requests",
                                    tick=ap.tick)
        results = {i: fleet.result(f) for i, f in fids.items()}
        engines = fleet.running_replicas()
        served = [sum(r["replica"] == sid for r in results.values()) for sid in engines]
        rescale = [d for d in ap.decisions(limit=0) if d["rule"] == "rescale_serving"]
        shared = {i: results[i]["replica"] for i in SERVE_SHARED}
        holder = engines.get(shared[SERVE_SHARED[0]])
        a.update(seconds=time.perf_counter() - t0,
                 statuses=sorted({r["status"] for r in results.values()}),
                 served_per_replica=served, affinity_hits=fleet.router.affinity_hits,
                 shared_replicas=shared,
                 holder_prefix_hits=holder.stats()["prefix_cache"]["hits"] if holder else None,
                 rescale={k: sum((d["suppressed_reason"] or "fired") == k for d in rescale)
                          for k in {d["suppressed_reason"] or "fired" for d in rescale}},
                 autopilot=ap.stats(), fleet=fleet.status()["router"],
                 ttft_p50_ms=fleet.status()["ttft_p50_ms"],
                 ttft_p99_ms=fleet.status()["ttft_p99_ms"],
                 p99_ms=fleet.status()["p99_latency_ms"])
        if a["statuses"] != ["done"] or len(engines) != 2:
            fails.append(f"(a) statuses {a['statuses']}, {len(engines)} replicas")
        if a["rescale"].get("fired") != 1:
            fails.append(f"(a) rescale_serving never fired: {a['rescale']}")
        if (len(set(shared.values())) != 1 or not a["holder_prefix_hits"]
                or a["affinity_hits"] < len(SERVE_SHARED) - 1):
            fails.append(f"(a) shared prefix on {shared}, holder's prefix hits "
                         f"{a['holder_prefix_hits']}, affinity hits {a['affinity_hits']}")
        greedy = [i for i in range(16) if plan[i][2] == 0.0]
        gaps = [_stream_gap(params, cfg, plan[i][0], results[i]["tokens"]) for i in greedy]
        # One plain batcher (serve's settings) over the same 16 requests.
        srv = tsrv.ContinuousBatcher(params, cfg, **SERVE_CFG)
        rids = {i: srv.submit(p, max_new_tokens=FLEET_NEW, temperature=t)
                for i, (p, _, t) in enumerate(plan)}
        _drive(srv, rids.values())
        plain = {i: srv.result(r)["tokens"] for i, r in rids.items()}
        plain_gaps = [_stream_gap(params, cfg, plan[i][0], plain[i]) for i in greedy]
        del srv
        a.update(max_gap=max(gaps), plain_max_gap=max(plain_gaps),
                 identical_to_plain=sum(results[i]["tokens"] == plain[i] for i in greedy),
                 greedy=len(greedy))
        print(f"serve_fleet (a) unified: 2 replicas after the autopilot's rescale_serving "
              f"decisions {a['rescale']} ({a['scale_up_s']:.1f} s to the second after the first "
              f"8 requests' {a['wave1_s']:.1f} s), requests a replica "
              f"{served}, shared prefix on {sorted(set(shared.values()))} with "
              f"{a['affinity_hits']} affinity hits and {a['holder_prefix_hits']} prefix hits, "
              f"largest teacher-forced gap {a['max_gap']:.4f} (tau {SERVE_TAU}; one plain "
              f"batcher {a['plain_max_gap']:.4f}, {a['identical_to_plain']}/{len(greedy)} "
              f"greedy streams identical to its), TTFT p50 {a['ttft_p50_ms']} ms p99 "
              f"{a['ttft_p99_ms']} ms, {a['seconds']:.1f} s ({_card_line()})", flush=True)
        if a["max_gap"] > SERVE_TAU:
            fails.append(f"(a) teacher-forced gap {a['max_gap']} > {SERVE_TAU}")
    finally:
        _stopped(fleet)
        goodput.set_alerter(alerter)


def disagg_streams(sched, plan: list, wire_quant: bool, kv_quant: bool) -> dict:
    """(b)'s DisaggServingFleet serving ``plan``'s prompts greedily, its two
    pools (one replica each) sized by ``plan_serving_pool`` against the
    card's headroom: each request's tokens, TTFT, the phases its trace
    shows, and its handoff's wire bytes and resident length."""
    from tpu_engine_torch import tracing
    from tpu_engine_torch.disagg import DisaggServingFleet
    from tpu_engine_torch.placement import plan_serving_pool
    from tpu_engine_torch.serving_fleet import ServingReplicaSpec

    t0 = time.perf_counter()
    dev = _fresh_reading(sched).devices[0]
    pools = {}
    for role in ("prefill", "decode"):
        best = plan_serving_pool(
            FLEET_SPEC["model_name"], role, 1, max_len=FLEET_SPEC["max_len"],
            hbm_free_gib=(dev.hbm_free_gb - sched._reserved.get(dev.index, 0.0)) / 2,
            candidate_slots=(FLEET_SPEC["max_slots"],), inflight_handoffs=4,
            prefill_chunk=FLEET_SPEC["prefill_chunk"], kv_quant=kv_quant and role == "decode")[0]
        if not best.feasible:
            raise AssertionError(f"serve_fleet: no feasible {role} pool: {best.skip_reason}")
        pools[role] = best.max_slots
    fleet = DisaggServingFleet(
        sched, ServingReplicaSpec(**FLEET_SPEC, inflight_handoffs=pools["prefill"]),
        ServingReplicaSpec(**{**FLEET_SPEC, "max_slots": pools["decode"]}, kv_quant=kv_quant),
        prefill_autoscaler=_one_replica(), decode_autoscaler=_one_replica(),
        wire_quant=wire_quant)
    rec = tracing.get_recorder()
    try:
        fleet.start()
        _fleet_await(lambda: len(fleet.prefill.running_replicas()) == 1
                     and len(fleet.decode.running_replicas()) == 1, "(b)'s pools")
        up = time.perf_counter() - t0
        fids = [fleet.submit_request(p, FLEET_NEW) for p, _, _ in plan]
        outs = [fleet.wait(f, timeout=FLEET_SERVE_WAIT_S) for f in fids]
        rows = []
        for o in outs:
            events = {e["name"] for e in rec.events(trace_id=o["trace_id"], limit=0)}
            spans = rec.spans(trace_id=o["trace_id"], limit=0)
            hand = [s["attrs"] for s in spans if s["kind"] == "kv_handoff"]
            req = [s["attrs"] for s in spans if s["kind"] == "serving_request"]
            rows.append({
                "status": o["status"], "tokens": o["tokens"], "ttft_ms": o.get("ttft_ms"),
                "phases": {"prefilling": "route_prefill" in events,
                           "extracting": bool(hand),
                           "handoff": any(h.get("status") == "delivered" for h in hand),
                           "decoding": "route_decode" in events,
                           "done": any(r.get("status") == "done" for r in req)},
                "wire_bytes": [h.get("wire_bytes") for h in hand],
                "kv_tokens": [h.get("kv_tokens") for h in hand],
                "redispatches": o["redispatches"]})
        status = fleet.status()
        return {"rows": rows, "pools_up_s": up, "seconds": time.perf_counter() - t0, "slots": pools,
                "handoffs": status["handoffs_total"], "bytes": status["handoff_bytes_total"],
                "ttft_p50_ms": status["ttft_p50_ms"], "reprefills": status["reprefills_total"]}
    finally:
        _stopped(fleet, fleet.prefill, fleet.decode)


def _wire_bytes(cfg, tokens: int, quantized: bool) -> int:
    """K and V [L, T, KV, HD] on the wire: fp32, or int8 codes with fp32
    [L, T, KV, 1] scales."""
    n = 2 * cfg.n_layers * tokens * cfg.n_kv_heads
    return n * (cfg.head_dim + 4) if quantized else n * cfg.head_dim * 4


def _fleet_disagg(out: dict, fails: list, sched, state: dict, plan: list) -> None:
    """(b): both wires through the pools, then reshard's serving half on two
    engines stepped here: held requests migrated, a prefix moved through
    the host tier."""
    import numpy as np

    from tpu_engine_torch import reshard
    from tpu_engine_torch import serving as tsrv
    from tpu_engine_torch.prefix_plane import HostKVTier

    cfg, params = _llama_1b(state)
    b = out["b"] = {}
    prompts = [(p, n, 0.0) for p, n, _ in plan[:8]]
    for name, wire_quant, kv_quant in (("fp32_wire", False, False),
                                       ("int8_wire", True, True)):
        r = b[name] = disagg_streams(sched, prompts, wire_quant, kv_quant)
        gaps = [_stream_gap(params, cfg, p, row["tokens"])
                for (p, _, _), row in zip(prompts, r["rows"])]
        want = [_wire_bytes(cfg, len(p), wire_quant) for p, _, _ in prompts]
        r.update(max_gap=max(gaps), gaps=gaps, want_bytes=want)
        bad = [i for i, row in enumerate(r["rows"])
               if row["status"] != "done" or not all(row["phases"].values())
               or row["wire_bytes"] != [want[i]] or row["kv_tokens"] != [len(prompts[i][0])]]
        print(f"serve_fleet (b) {name}: pools of {r['slots']} slots (plan_serving_pool), "
              f"{r['handoffs']} handoffs, {r['bytes']} wire bytes "
              f"(the [L, T, KV, HD] arithmetic {sum(want)}), every phase seen by "
              f"{8 - len(bad)}/8, TTFT p50 {r['ttft_p50_ms']} ms, largest teacher-forced gap "
              f"{r['max_gap']:.4f} (tau {SERVE_TAU}), {r['seconds']:.1f} s", flush=True)
        if bad:
            fails.append(f"(b) {name}: requests {bad}: {[r['rows'][i] for i in bad]}")
        if r["max_gap"] > SERVE_TAU:
            fails.append(f"(b) {name}: teacher-forced gap {r['max_gap']} > {SERVE_TAU}")

    t0 = time.perf_counter()
    geom = dict(max_slots=4, max_len=FLEET_SPEC["max_len"],
                prefill_chunk=FLEET_SPEC["prefill_chunk"], prefix_cache_tokens=1024)
    src, dst, cold = (tsrv.ContinuousBatcher(params, cfg, **geom) for _ in range(3))
    shared = [plan[i][0] for i in SERVE_SHARED[:2]]
    held = [src.submit(p, max_new_tokens=1, hold_kv=True) for p in shared]
    _drive(src, held)
    moved = reshard.migrate_held_requests(src, dst, max_new_tokens=16)
    _drive(dst, moved["mapping"].values())
    streams = [src.result(h)["tokens"] + dst.result(moved["mapping"][h])["tokens"]
               for h in held]
    mig_gap = max(_stream_gap(params, cfg, p, s) for p, s in zip(shared, streams))
    key = max(src._prefix_cache._entries, key=len)
    tier = HostKVTier(budget_bytes=1 << 30)
    tier.put(key, src.export_prefix(list(key)))
    installed = reshard.rehydrate_from_host(tier, list(key), dst)
    probe = list(key) + np.random.default_rng(24).integers(1, cfg.vocab_size, 40).tolist()
    warm, want = _first_logits(dst, probe), _first_logits(cold, probe)
    rel = _rel_err(warm, want)
    b["reshard"] = {"migrated": moved["migrated"], "wire_bytes": moved["wire_bytes"],
                    "mttr_s": moved["mttr_s"], "max_gap": mig_gap, "prefix_tokens": len(key),
                    "installed": installed, "host_bytes": tier.total_bytes,
                    "warm_hits": dst.stats()["prefix_cache"]["hits"],
                    "cold_hits": cold.stats()["prefix_cache"]["hits"],
                    "first_logits_rel": rel, "seconds": time.perf_counter() - t0}
    print(f"serve_fleet (b) reshard: {moved['migrated']} held requests migrated "
          f"({moved['wire_bytes']} wire bytes, {moved['mttr_s']:.3f} s), largest teacher-forced "
          f"gap {mig_gap:.4f}; a {len(key)}-token prefix through the host tier "
          f"({tier.total_bytes} bytes, int8) into a fresh engine: first logits {rel:.4e} from a "
          f"cold server's (SERVE_REL {SERVE_REL['bf16']})", flush=True)
    if moved["migrated"] != 2 or src.held_requests() or mig_gap > SERVE_TAU:
        fails.append(f"(b) migration: {b['reshard']}")
    if not installed or b["reshard"]["warm_hits"] != 1 or rel > SERVE_REL["bf16"]:
        fails.append(f"(b) prefix through the host tier: {b['reshard']}")


def _fleet_spec(out: dict, fails: list, sched, state: dict, plan: list) -> None:
    """(d): a SpecServingFleet a draft, one spill controller over both."""
    from tpu_engine_torch import historian
    from tpu_engine_torch import serving as tsrv
    from tpu_engine_torch.serving_fleet import ServingReplicaSpec, build_replica_engine
    from tpu_engine_torch.spec_pool import SpecServingFleet, SpecSpillConfig, SpecSpillController

    cfg, params = _llama_1b(state)
    dcfg, dparams = _draft_2l(state)
    hist = historian.MetricHistorian()
    ctl = SpecSpillController(hist, SpecSpillConfig(window_s=120.0, sustain_consults=2,
                                                    cooldown_s=0.0, canary_every=2))

    def draft_2l(spec):
        if spec.pool_role == "draft":
            return tsrv.ContinuousBatcher(dparams, dcfg, max_slots=spec.max_slots,
                                          max_len=spec.max_len, prefill_chunk=spec.prefill_chunk,
                                          chunk_steps=spec.decode_chunk_steps)
        return build_replica_engine(spec)

    fleets = {name: SpecServingFleet(
        sched, ServingReplicaSpec(**FLEET_SPEC), ServingReplicaSpec(**FLEET_SPEC),
        verify_autoscaler=_one_replica(), draft_autoscaler=_one_replica(), historian=hist,
        spill=ctl, spec_gamma=4, submitter=f"serve-fleet-{name}", **kw)
        for name, kw in (("own", {}), ("2l", {"engine_factory": draft_2l}))}
    d = out["d"] = {}
    try:
        t0 = time.perf_counter()
        _fresh_reading(sched)
        for f in fleets.values():
            f.start()
        _fleet_await(lambda: all(len(f.draft.running_replicas()) == 1
                                 and len(f.verify.running_replicas()) == 1
                                 for f in fleets.values()), "(d)'s pools")
        prompts = [p for p, _, _ in plan[:8]]
        got = {}

        def serve(name, batch):
            fleet = fleets[name]
            fids = [fleet.submit_request(p, FLEET_NEW, tenant=name) for p in batch]
            for fid in fids:
                o = fleet.wait(fid, timeout=FLEET_SERVE_WAIT_S)
                r = fleet._requests[fid]
                own = fleet.verify.running_replicas()[r["verify_sid"]].result(r["verify_rid"])
                got.setdefault(name, []).append((o, own["tokens"]))

        serve("own", prompts)
        serve("2l", prompts[:4])
        for f in fleets.values():
            f.tick()
            f.tick()
        serve("2l", prompts[4:])
        for f in fleets.values():
            f.tick()
        fired = [(x.rule, x.target) for x in ctl.decisions if x.outcome == "fired"]
        for name, rows in got.items():
            gaps = [_stream_gap(params, cfg, p, o["tokens"]) for p, (o, _) in zip(prompts, rows)]
            d[name] = {
                "accept_ema": fleets[name].tenant_accept_rates()[name],
                "own_streams": all(o["tokens"] == own for o, own in rows),
                "done": all(o["status"] == "done" for o, _ in rows),
                "speculated": [o["speculated"] for o, _ in rows],
                "canary": [o["canary"] for o, _ in rows],
                "max_gap": max(gaps),
                "legs": {k: fleets[name].status()[k]
                         for k in ("draft_legs_total", "plain_legs_total")}}
        d.update(spilled=ctl.spilled(), fired=fired, seconds=time.perf_counter() - t0)
        print(f"serve_fleet (d) speculation: acceptance EMA own {d['own']['accept_ema']}, "
              f"2-layer {d['2l']['accept_ema']} (floor {ctl.cfg.accept_floor}); spilled "
              f"{d['spilled']} by {fired}; 2-layer requests speculated {d['2l']['speculated']}, "
              f"canaries {d['2l']['canary']}; largest teacher-forced gap own "
              f"{d['own']['max_gap']:.4f}, 2-layer {d['2l']['max_gap']:.4f}, "
              f"{d['seconds']:.1f} s", flush=True)
        if not all(d[n]["done"] and d[n]["own_streams"] and d[n]["max_gap"] <= SERVE_TAU
                   for n in ("own", "2l")):
            fails.append(f"(d) streams: {d}")
        if not (d["own"]["accept_ema"] > ctl.cfg.accept_floor and d["spilled"] == ["2l"]
                and fired == [("spill_low_acceptance", "2l")]
                and d["2l"]["canary"][4:] == [False, True, False, True]):
            fails.append(f"(d) spill: {d}")
    finally:
        for f in fleets.values():
            _stopped(f, f.draft, f.verify)


def _fleet_evict(out: dict, fails: list, sched, work) -> None:
    """(c): the scheduler's own admission evicts the batch replica for a
    CRITICAL training job (K1-K3 counted around its steps) and readmits it
    after the job's end."""
    import numpy as np
    import torch

    from tpu_engine_torch import tracing
    from tpu_engine_torch.hbm_estimate import estimate_job_hbm
    from tpu_engine_torch.models.config import MODEL_CONFIGS
    from tpu_engine_torch.ops import _flash_cuda as fc
    from tpu_engine_torch.scheduler import JobPriority
    from tpu_engine_torch.serving_fleet import ServingFleet, ServingReplicaSpec

    c = out["c"] = {}
    interactive = ServingFleet(sched, ServingReplicaSpec(**FLEET_SPEC),
                               autoscaler=_one_replica(), submitter="serve-fleet-interactive")
    fleet = ServingFleet(sched, ServingReplicaSpec(**{**FLEET_SPEC, "max_slots": EVICT_SLOTS,
                                                      "max_len": EVICT_LEN}),
                         autoscaler=_one_replica(), priority=JobPriority.LOW,
                         submitter="serve-fleet-batch")
    model_cfg = MODEL_CONFIGS["llama-1b"].with_(n_layers=FLEET_L)
    cfg = _llama_1b_cfg(attention_impl="flash", log_every_steps=1, total_steps=100,
                        metrics_log_path=str(work / "critical.jsonl"))
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = torch.randint(0, model_cfg.vocab_size, (1, cfg.micro_batch_size, cfg.seq_len),
                          generator=gen, device="cuda")
    before = sched.stats()
    job = None
    try:
        c["memory_before"] = _card_memory()
        for f in (interactive, fleet):  # one at a time: each admitted on its own reading
            _fresh_reading(sched)
            f.start()
            _fleet_await(lambda f=f: len(f.running_replicas()) == 1, "(c)'s replicas")
        (replica,) = fleet._replicas.values()
        dev = _fresh_reading(sched).devices[0]
        c.update(memory_serving=_card_memory(),
                 replica_estimates_gib=[s.estimate.device_total_gib for f in (interactive, fleet)
                                        for s in f._replicas.values()],
                 job_estimate_gib=estimate_job_hbm(cfg, 1).device_total_gib,
                 hbm_total_gb=dev.hbm_total_gb, hbm_used_gb=dev.hbm_used_gb,
                 reserved_gib=sched._reserved.get(dev.index, 0.0), available=dev.is_available,
                 duty_pct=dev.duty_cycle_pct)
        c["headroom_gib"] = dev.hbm_free_gb - c["reserved_gib"]
        rng = np.random.default_rng(3)
        prompts = [rng.integers(1, model_cfg.vocab_size, int(n)).tolist()
                   for n in rng.integers(256, 1025, EVICT_REQUESTS)]
        fids = [fleet.submit_request(p, EVICT_NEW) for p in prompts]
        torch.cuda.synchronize()
        fc.reset_launches()
        t_sub = time.perf_counter()
        crit = sched.submit(cfg, priority=JobPriority.CRITICAL, submitter="serve-fleet-critical",
                            job_kwargs={"max_steps": EVICT_STEPS, "model_config": model_cfg,
                                        "data_fn": lambda step: batch})
        c["evict_s"] = _fleet_await(lambda: replica.preemptions == 1, "the eviction",
                                    detail=lambda: (crit.last_skip_reason, replica.state.value))
        c["in_flight_at_eviction"] = sum(not fleet._requests[f]["done"] for f in fids)
        _fleet_await(lambda: crit.state.value == "running", "the CRITICAL job's admission",
                     detail=lambda: crit.last_skip_reason)
        c["admit_s"] = time.perf_counter() - t_sub
        c["memory_after_teardown"] = _card_memory()
        job = crit.job
        _fleet_await(lambda: crit.state.value in ("completed", "failed"), "the job's end",
                     tick=lambda: fleet.result(fids[0]))
        torch.cuda.synchronize()
        launches = {k: v for k, v in fc.launches.items() if v}
        _fleet_await(
            lambda: replica.state.value == "running" and len(fleet.running_replicas()) == 1,
            "the replica's readmission", tick=lambda: fleet.result(fids[0]),
            detail=lambda: (replica.state.value, replica.last_skip_reason))
        # The scheduler's own stamps: the pass that reaps the job may admit
        # the replica in the same breath.
        c["readmit_s"] = replica.last_admitted_at - crit.finished_at
        c["done_s"] = _fleet_await(
            lambda: all(fleet.result(f)["status"] in ("done", "failed") for f in fids),
            "the re-dispatched requests")
        events = tracing.get_recorder().events(trace_id=crit.trace_id, kind="scheduler", limit=0)
        c["job_skips"] = [e["attrs"]["reason"] for e in events if e["name"] == "admission_skip"]
        c["preempted"] = [e["attrs"].get("victim") for e in events
                          if e["name"] == "preempt_requested"]
        statuses = [fleet.result(f)["status"] for f in fids]
        losses = [v for _, v in sorted(_fleet_losses(work / "critical.jsonl").items())]
        st = sched.stats()
        L = model_cfg.n_layers
        want = {"flash_fwd": 2 * L * EVICT_STEPS, "flash_bwd_dq": L * EVICT_STEPS,
                "flash_bwd_dkv": L * EVICT_STEPS}
        out.update(steps=EVICT_STEPS, accum=cfg.gradient_accumulation_steps, launches=launches,
                   launches_expected=want)
        c.update(job=crit.state.value, job_error=job.error if job else None, losses=losses,
                 statuses=sorted(set(statuses)), replica_attempts=replica.attempts,
                 replica_checkpoint_dir=replica.config.checkpoint_dir,
                 interactive_running=len(interactive.running_replicas()),
                 counters={k: st[k] - before[k] for k in ("preemptions_total", "requeues_total",
                                                          "completed_total")},
                 seconds=time.perf_counter() - t_sub)
        print(f"serve_fleet (c) eviction: headroom {c['headroom_gib']:.2f} GiB (card "
              f"{c['hbm_total_gb']:.2f}, used {c['hbm_used_gb']:.2f}, reserved "
              f"{c['reserved_gib']:.2f}) against the job's {c['job_estimate_gib']:.2f} GiB; the job "
              f"skipped {c['job_skips']}; evicted {c['evict_s']:.2f} s after its submission with "
              f"{c['in_flight_at_eviction']} requests in flight, card used "
              f"{c['memory_after_teardown']['used_gib']:.2f} GiB after the teardown; job "
              f"{c['job']}, losses {losses}, launches {launches}; the replica readmitted "
              f"{c['readmit_s']:.3f} s after its end, requests {c['statuses']} "
              f"{c['done_s']:.1f} s later; counters {c['counters']} ({_card_line()})", flush=True)
        if not c["headroom_gib"] < c["job_estimate_gib"] or not c["available"]:
            fails.append(f"(c) the card before the job: {c}")
        if (c["in_flight_at_eviction"] < 1 or c["preempted"] != [replica.submission_id]
                or not any("GiB/device" in r for r in c["job_skips"])):
            fails.append(f"(c) the eviction: {c}")
        if c["job"] != "completed" or len(losses) != EVICT_STEPS or not all(
                b < a for a, b in zip(losses[1:], losses[2:])) or launches != want:
            fails.append(f"(c) the job: {c['job']}, {losses}, {launches} (want {want})")
        if (c["statuses"] != ["done"] or c["replica_attempts"] != 2
                or c["readmit_s"] < 0
                or c["replica_checkpoint_dir"] is not None or c["interactive_running"] != 1
                or c["counters"] != {"preemptions_total": 1, "requeues_total": 1,
                                     "completed_total": 1}):
            fails.append(f"(c) readmission: {c}")
    finally:
        _stopped(fleet)
        _stopped(interactive)
        if job is not None:
            job._state = job.program = None
        _free()


def phase_serve_fleet(res: dict) -> None:
    """The serving fleet (module docstring, serve_fleet): (a), (b) and (d)
    on one FleetScheduler over the card's live fleet, then (c) on the same
    scheduler; the CRITICAL job's K1-K3 launches are the bf16 D 128 rows'
    ``serve_fleet`` column."""
    import shutil

    from tpu_engine_torch.scheduler import FleetScheduler
    from tpu_engine_torch.tpu_manager import TPUManager

    work = ROOT / "chiprun_out" / "serve_fleet"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = res["serve_fleet"] = {"card": _card_line()}
    fails: list = []
    state: dict = {}
    t0 = time.perf_counter()
    sched = FleetScheduler(max_concurrent_jobs=8, fleet_fn=TPUManager().get_fleet_status,
                           poll_interval_s=0.05)
    try:
        plan = _serve_plan(_llama_1b(state)[0])
        for part in (_fleet_unified, _fleet_disagg, _fleet_spec):
            part(out, fails, sched, state, plan)
        state.clear()
        _free()
        _fleet_evict(out, fails, sched, work)
    finally:
        for s in list(sched._subs.values()):
            if s.job is not None and s.job.is_alive:
                s.job._stop.set()
        sched.shutdown()
        state.clear()
        shutil.rmtree(work, ignore_errors=True)
        _free()
    out["phase_s"] = time.perf_counter() - t0
    print(f"serve_fleet: {out['phase_s']:.1f} s", flush=True)
    if fails:
        raise AssertionError("; ".join(fails))

def phase_train_pipe(res: dict, steps: int) -> None:
    """llama-1b at full width and MESH_L of its 16 layers (d_model 2048, 16
    heads of 128, d_ff 5504, vocab 32000), bf16 compute, fp32 masters,
    AdamW, checkpointing, flash, on pipe=2 (MESH_L / 2 layers a rank): two
    rank processes on cuda:0 through NCCL, each with its own NCCL_HOSTID, seq 2048 × 1 ×
    PIPE_M microbatches a step, ``steps`` steps under each of gpipe, 1f1b
    and zb, each held to the world-1 program at the same global batch
    (``w1_pipe``, in this process) within MESH_LOSS_REL on losses and
    gradient norms; both ranks must report equal losses and norms, and each
    rank's K1-K3 launches must be exactly :func:`pipe_want`'s. Per rank and
    schedule: step time, peak memory, the bytes sent a step (boundary
    activations and their cotangents) and the other collectives' bytes, and
    JAX's ``schedule_account`` F-units of the schedule. On one shared card
    the other rank's work fills a stage's bubble, so these step times do
    not measure bubbles."""
    from tpu_engine_torch.parallel.pipeline_zb import schedule_account

    out = res["train_pipe"] = {"steps": steps, "accum": PIPE_M, "runs": {}, "launches": {},
                               "card": _card_line()}
    one = [{"runs": mesh_world1(["w1_pipe"], steps)}]
    two = mesh_launch([f"pipe_{s}" for s in PIPE_SCHEDULES], 2, steps, "pipe")
    fails = mesh_checks(out, (one, two), steps)
    for s in PIPE_SCHEDULES:
        acc = schedule_account(s, 2, PIPE_M)
        out.setdefault("account", {})[s] = acc
        for rank, run in enumerate(out["runs"].get(f"pipe_{s}", [])):
            if run["schedule"] != s:
                fails.append(f"pipe_{s} rank {rank}: ran {run['schedule']}")
            print(f"train_pipe {s} rank {rank}: step "
                  f"{min(run['step_ms_each'][1:] or run['step_ms_each']):.1f} ms, peak "
                  f"{run['peak_mem_gib']:.2f} GiB, sent a step "
                  f"{run['moved_bytes_per_step'].get('send', 0)} B, launches "
                  f"{ {k: v // steps for k, v in run['launches'].items() if v} } a step, "
                  f"JAX's F-units {acc['lane_cost']} (useful {acc['useful_cost']}, bubble "
                  f"{acc['bubble_fraction']:.3f}) ({_card_line()}; the two ranks share the "
                  "card: a bubble is filled by the other rank's work)", flush=True)
    if fails:
        raise AssertionError("; ".join(fails))


# serve_mesh's runs: (name, the weights' tree, the int8 pool): bf16 weights
# with the bf16 and the int8 pool, and a weight-only int8 tree (its sites
# split as JAX's quantize_pspecs) with the bf16 pool.
SERVE_MESH_RUNS = (("bf16", "bf16", False), ("int8", "bf16", True),
                   ("int8_weights", "int8", False))
# serve_mesh serves llama-1b at full width and 2 of its 16 layers: a decode
# step's 2 all-reduces a layer wait about 4.5 ms each on the wire between
# two ranks of one card (nccl_probe.py --latency), and the run's time limit
# holds the phase to about a minute (PERF.md §4: cut to 4 layers, then to 2
# when its third run, the int8 tree, came).
SERVE_MESH_L = 2
SERVE_MESH_TEACHER = (8, 16)  # rows and tokens of the teacher-forced decode


# -- train_data and train_comm ------------------------------------------------

# train_data: llama-1b's training from a token file of this many sequences
# of 2048 seeded ids (uint16), 4 a microbatch, through the native reader.
DATA_SEQS = 64
# llama-1b's layers in train_data: 2 of 16 (its 11.3 GB save at
# 16 layers took 18-26 s of the run's time limit; PERF.md §4).
DATA_L = 2
# The host reader's timing: batches read through a fresh reader.
DATA_READ_BATCHES = 16


def _params_host(prog, state) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in prog.whole_params(state).items()}


def phase_train_data(res: dict) -> None:
    """llama-1b at full width and DATA_L of its 16 layers (seq 2048 × 4,
    bf16 compute, fp32 masters, flash) trained from a token file of seeded
    ids: steps 1–2 from
    ``make_data_fn`` (the native reader), an asynchronous save of step 2
    (dispatch and write timed), the uninterrupted step 3; then a fresh
    program restored from the checkpoint takes step 3, whose loss and
    weights must be bitwise the uninterrupted ones. Prints the bytes
    written, save and restore GB/s, and the reader's host tokens/s beside
    what a step needs. The directory is removed after."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tpu_engine_torch import checkpoint as ck
    from tpu_engine_torch import data as tdata
    from tpu_engine_torch.ops import _flash_cuda as fc
    from tpu_engine_torch.train import build_train_program

    from tpu_engine_torch.models.config import MODEL_CONFIGS

    L = DATA_L
    cfg = _llama_1b_cfg()
    model_cfg = MODEL_CONFIGS["llama-1b"].with_(n_layers=L)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_data_"))
    out = res["train_data"] = {"steps": 2, "accum": 1, "n_layers": L}
    try:
        usage = shutil.disk_usage(work)
        out["disk_free_gib"] = usage.free / 2**30
        vocab = 32000
        toks = np.random.default_rng(0).integers(0, vocab, DATA_SEQS * cfg.seq_len)
        tdata.write_token_file(toks.astype(np.uint16), str(work / "tokens.bin"))
        prog = build_train_program(cfg, model_cfg, device="cuda")
        if prog.model_config.vocab_size != vocab:
            raise AssertionError(f"llama-1b's vocabulary is {prog.model_config.vocab_size}")
        ds = tdata.TokenFileDataset(str(work / "tokens.bin"), cfg.seq_len)
        data_fn = tdata.make_data_fn(prog, ds, seed=0)
        out["reader"] = data_fn.reader
        if data_fn.reader != "native":
            from tpu_engine_torch import native

            raise AssertionError(f"the data path runs the {data_fn.reader} reader: "
                                 f"{native.build_error()}")
        batches = [data_fn(i) for i in range(3)]
        data_fn.close()
        state = prog.init()
        torch.cuda.synchronize()
        fc.reset_launches()
        losses, times = [], []
        for b in batches[:2]:
            t0 = time.perf_counter()
            state, m = prog.step(state, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out["launches"] = dict(fc.launches)
        want = {"flash_fwd": 2 * L * 2, "flash_bwd_dq": L * 2, "flash_bwd_dkv": L * 2}
        if {k: v for k, v in out["launches"].items() if v} != want:
            raise AssertionError(f"train_data launches {out['launches']} != {want}")
        mgr = ck.TrainCheckpointManager(str(work / "ck"), program=prog)
        t0 = time.perf_counter()
        if not mgr.save(2, state):
            raise AssertionError("the save of step 2 was refused")
        dispatch_s = time.perf_counter() - t0
        state, m = prog.step(state, batches[2])  # races the save in flight
        loss3 = float(m["loss"])
        mgr.wait_until_finished()
        wait_s = time.perf_counter() - t0
        nbytes = mgr.last_save["bytes"]
        written = sum(f.stat().st_size for f in (work / "ck" / "2").iterdir())
        want_params = _params_host(prog, state)
        del prog, state, m
        _free()
        prog = build_train_program(cfg, model_cfg, device="cuda")
        like = ck.abstract_state_like(prog)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, state = ck.TrainCheckpointManager(str(work / "ck"), program=prog).restore(like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if step != 2 or state["step"] != 2:
            raise AssertionError(f"restored step {step}, state step {state['step']}")
        state, m = prog.step(state, batches[2])
        loss3_restored = float(m["loss"])
        got = _params_host(prog, state)
        diff = [k for k in want_params if not torch.equal(got[k], want_params[k])]
        t0 = time.perf_counter()
        reader = tdata.TokenFileDataset(str(work / "tokens.bin"), cfg.seq_len)
        reader.start(cfg.micro_batch_size, seed=1)
        for _ in range(DATA_READ_BATCHES):
            reader.next_batch()
        read_s = time.perf_counter() - t0
        reader.close()
        step_tokens = cfg.micro_batch_size * cfg.seq_len
        out.update(
            losses=losses + [loss3], loss3_restored=loss3_restored,
            step_ms_each=[t * 1e3 for t in times], state_bytes=nbytes, bytes_written=written,
            save_dispatch_s=dispatch_s, save_total_s=wait_s, restore_s=restore_s,
            save_gb_s=nbytes / wait_s / 1e9, restore_gb_s=nbytes / restore_s / 1e9,
            reader_tokens_per_s=DATA_READ_BATCHES * step_tokens / read_s,
            step_tokens_per_s=step_tokens / min(times), weights_differing=len(diff))
        print(f"train_data: reader {out['reader']}, losses {[round(x, 5) for x in losses]}, "
              f"step 3 {loss3!r} uninterrupted, {loss3_restored!r} restored; steps "
              f"{[round(t * 1e3, 1) for t in times]} ms; launches {out['launches']}", flush=True)
        print(f"train_data: state {nbytes} B, {written} B written; save dispatch "
              f"{dispatch_s * 1e3:.1f} ms, until written {wait_s:.2f} s "
              f"({out['save_gb_s']:.3f} GB/s, raced by step 3); restore {restore_s:.2f} s "
              f"({out['restore_gb_s']:.3f} GB/s, the page cache warm); reader "
              f"{out['reader_tokens_per_s']:.0f} tokens/s on the host against the step's "
              f"{out['step_tokens_per_s']:.0f}; disk free {out['disk_free_gib']:.1f} GiB",
              flush=True)
        if not all(math.isfinite(x) for x in losses + [loss3]):
            raise AssertionError(f"non-finite loss: {losses + [loss3]}")
        if abs(losses[0] - math.log(vocab)) > 0.5:
            raise AssertionError(f"first loss {losses[0]} is not near ln(vocab)")
        if loss3_restored != loss3 or diff:
            raise AssertionError(f"restored step 3 is not the uninterrupted one: loss "
                                 f"{loss3_restored!r} vs {loss3!r}, {len(diff)} weights differ "
                                 f"({diff[:3]})")
        if dispatch_s >= wait_s:
            raise AssertionError("the save was not asynchronous")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        _free()


# train_comm: llama-1b at full width and COMM_L layers, seq 2048 × 2 a rank,
# on two ranks of the one card; each run by (mesh, slices, fields).
COMM_L = 2
COMM_BLOCK = 256
_XLA = dict(attention_impl="xla")
COMM_RUNS = {
    "fsdp2_fp32": (dict(fsdp=2), None, _XLA),
    "fsdp2_qwz": (dict(fsdp=2), None, dict(_XLA, comm_quant_weights=True,
                                           comm_secondary_weights=True)),
    "dcn_fp32": (dict(data=2, dcn_data=2), [0, 1], _XLA),
    "dcn_qgz": (dict(data=2, dcn_data=2), [0, 1], dict(_XLA, comm_quant_grads=True)),
    "data2_fp32": (dict(data=2), None, {}),
    "data2_bf16": (dict(data=2), None, dict(grad_allreduce_dtype="bf16")),
}
COMM_PAIRS = (("fsdp2_qwz", "fsdp2_fp32"), ("dcn_qgz", "dcn_fp32"), ("data2_bf16", "data2_fp32"))
# The run whose checkpoint (d) restores at world 1.
COMM_SAVE = "fsdp2_qwz"


def _comm_cfg(name: str):
    from tpu_engine_torch.mesh_runtime import MeshConfig
    from tpu_engine_torch.models.config import MODEL_CONFIGS
    from tpu_engine_torch.train import TrainConfig

    mesh, _, kw = COMM_RUNS[name]
    cfg = TrainConfig(**{**dict(model_name="llama-1b", micro_batch_size=2,
                                gradient_accumulation_steps=1, seq_len=2048, precision="bf16",
                                param_dtype="fp32", activation_checkpointing=True,
                                sharding_stage=3, comm_quant_block_size=COMM_BLOCK,
                                mesh=MeshConfig(**mesh), **TRAIN_LR), **kw})
    return cfg, MODEL_CONFIGS["llama-1b"].with_(n_layers=COMM_L)


def _whole_checksums(prog, state) -> dict:
    from tpu_engine_torch import reshard

    return reshard.leaf_checksums(prog.whole_params(state))


def _comm_runs(job: dict, rank: int) -> dict:
    """One rank of ``train_comm``: each of ``job["comm"]`` for ``job["steps"]``
    steps on one synthetic batch, every counter set to 0 just before and
    read just after; the runs' collective records per step, checksums of
    the whole weights, hpZ's store against the quantized shards, and the
    checkpoint of COMM_SAVE (saved at its last step)."""
    import contextlib

    import torch

    from tpu_engine_torch import checkpoint as ck
    from tpu_engine_torch import comm_compress as cc
    from tpu_engine_torch import reshard
    from tpu_engine_torch.mesh_runtime import MeshRuntime
    from tpu_engine_torch.ops import _flash_cuda as fc
    from tpu_engine_torch.parallel import collectives
    from tpu_engine_torch.train import build_train_program

    fault = job.get("fault")
    if fault:
        import train_faults

        patch = train_faults._patched(train_faults.comm_fault(fault))
    else:
        patch = contextlib.nullcontext()
    device = torch.device("cuda", 0)
    steps, out, runtimes = job["steps"], {}, {}
    with patch:
        for name in job["comm"]:
            cfg, model_cfg = _comm_cfg(name)
            key = json.dumps(COMM_RUNS[name][:2])
            if key not in runtimes:
                runtimes[key] = MeshRuntime(cfg.mesh, device=device,
                                            slice_assignments=COMM_RUNS[name][1])
            prog = build_train_program(cfg, model_cfg, device=device, runtime=runtimes[key])
            state = prog.init()
            batch = prog.synthetic_batch(seed=0)
            torch.cuda.synchronize()
            fc.reset_launches()
            collectives.reset_moved()
            losses, norms, times = [], [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                state, m = prog.step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            stats = cc.collective_stats()
            r = out[name] = {
                "losses": losses, "grad_norms": norms, "step_ms_each": [t * 1e3 for t in times],
                "launches": dict(fc.launches), "impl": prog.model_config.attention_impl,
                "stats_per_step": {
                    "total_wire_bytes": stats["total_wire_bytes"] // steps,
                    "cross_slice_bytes": stats["cross_slice_bytes"] // steps,
                    "collectives": [dict(c, bytes=c["bytes"] // steps,
                                         payload_bytes=c["payload_bytes"] // steps,
                                         calls=c["calls"] // steps)
                                    for c in stats["collectives"]]},
                "checksums": _whole_checksums(prog, state)}
            if "hpz" in state:
                r["hpz_leaves"] = len(state["hpz"]["codes"])
                r["hpz_equal"] = all(
                    torch.equal(c, cc.blockwise_quantize(state["params"][k], COMM_BLOCK)[0])
                    for k, c in state["hpz"]["codes"].items())
            if name == COMM_SAVE and job.get("ckpt"):
                mgr = ck.TrainCheckpointManager(job["ckpt"], program=prog)
                mgr.save(steps, state, wait=True)
                if rank == 0:
                    reshard.write_topology(job["ckpt"], reshard.mesh_topology(prog.runtime))
            del prog, state, batch
            _free()
    return out


def comm_readings(ranks: list) -> dict:
    """The readings of a ``train_comm`` job (each rank's ``_comm_runs``):
    per pair (compressed, reference) the largest relative loss gap of any
    step, per rank; the qwZ gather's ratio of fp32 bytes to the bytes its
    int8 codes and fp32 scales moved over ``fsdp``; the cross-slice ratio
    (the fp32 run's cross-slice bytes over the compressed run's); and
    whether each data-parallel run's ranks hold bitwise the same weights."""
    r0 = ranks[0]["comm"]
    out = {}
    for comp, ref in COMM_PAIRS:
        if comp not in r0:
            continue
        gaps = [max(abs(a - b) / abs(b) for a, b in zip(rk["comm"][comp]["losses"],
                                                         rk["comm"][ref]["losses"]))
                for rk in ranks]
        out[f"{comp}:loss_rel"] = gaps
    for name in r0:
        if COMM_RUNS[name][0].get("data", 1) > 1:
            out[f"{name}:ranks_agree"] = all(rk["comm"][name]["checksums"] == r0[name]["checksums"]
                                             for rk in ranks)
    if "fsdp2_qwz" in r0:
        gathers = [c for c in r0["fsdp2_qwz"]["stats_per_step"]["collectives"]
                   if c["op"] == "all-gather" and not c["cross_slice"]]
        int8 = sum(c["bytes"] for c in gathers if c["dtype"] == "int8")
        fp32 = sum(c["bytes"] for c in gathers if c["dtype"] == "float32")
        out["gather_fp32_over_int8"] = 4 * int8 / (int8 + fp32) if int8 else 0.0
    if "dcn_qgz" in r0:
        out["cross_slice_ratio"] = (r0["dcn_fp32"]["stats_per_step"]["cross_slice_bytes"]
                                    / max(r0["dcn_qgz"]["stats_per_step"]["cross_slice_bytes"], 1))
    return out


def phase_train_comm(res: dict, steps: int) -> None:
    """llama-1b at full width and COMM_L layers on two ranks (processes on
    the one card, NCCL, each its own NCCL_HOSTID): (a) fsdp=2 at stage 3
    with qwZ+hpZ against the same mesh uncompressed; (b) data=2 as two
    slices (dcn_data=2, slices [0, 1]) with qgZ against fp32; (c) data=2
    with a bf16 gradient reduction against fp32 (flash attention; (a) and
    (b) run JAX's attention_impl='xla', as compression requires); (d) (a)'s
    checkpoint restored at world 1 through ``restore_resharded``, the
    parity gate passing and the weights the checksums (a) left. Gated by
    train_faults.py's COMM_* bounds; prints step ms, bytes a rank a step by
    collective and dtype, the ratios and the loss gaps."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from train_faults import (COMM_BF16_LOSS_REL, COMM_CROSS_RATIO_MIN, COMM_GATHER_RATIO_MIN,
                              COMM_LOSS_REL)

    from tpu_engine_torch import checkpoint as ck
    from tpu_engine_torch import reshard
    from tpu_engine_torch.train import build_train_program

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_comm_"))
    out = res["train_comm"] = {"steps": steps, "accum": 1, "n_layers": COMM_L}
    try:
        ranks = mesh_launch([], 2, steps, "comm", comm=list(COMM_RUNS), ckpt=str(work / "ck"))
        out["runs"] = {name: [rk["comm"][name] for rk in ranks] for name in COMM_RUNS}
        # The flash kernels launch on (c) alone (rank 0's count).
        out["launches"] = {}
        for name in ("data2_fp32", "data2_bf16"):
            for k, v in ranks[0]["comm"][name]["launches"].items():
                out["launches"][k] = out["launches"].get(k, 0) + v
        out["steps"] = 2 * steps
        rd = out["readings"] = comm_readings(ranks)
        fails = []
        for name, per_rank in out["runs"].items():
            r = per_rank[0]
            by = {}
            for c in r["stats_per_step"]["collectives"]:
                k = f"{c['op']} {c['dtype']}{' across' if c['cross_slice'] else ''}"
                by[k] = by.get(k, 0) + c["bytes"]
            print(f"train_comm {name}: losses {[round(x, 5) for x in r['losses']]}, step ms "
                  f"{[round(t, 1) for t in r['step_ms_each']]}, bytes a rank a step {by}, "
                  f"cross-slice {r['stats_per_step']['cross_slice_bytes']}", flush=True)
            if any(rk["losses"] != r["losses"] for rk in per_rank):
                fails.append(f"{name}: the ranks report different losses")
            if not all(math.isfinite(x) for x in r["losses"]):
                fails.append(f"{name}: non-finite loss {r['losses']}")
            want_impl = COMM_RUNS[name][2].get("attention_impl", "flash")
            if r["impl"] != want_impl:
                fails.append(f"{name}: attention {r['impl']} != {want_impl}")
            want = ({"flash_fwd": 2 * COMM_L * steps, "flash_bwd_dq": COMM_L * steps,
                     "flash_bwd_dkv": COMM_L * steps} if want_impl == "flash" else {})
            for rk in per_rank:
                if {k: v for k, v in rk["launches"].items() if v} != want:
                    fails.append(f"{name}: launches {rk['launches']} != {want}")
        print(f"train_comm readings: {json.dumps(rd)}; bounds: loss {COMM_LOSS_REL}, bf16 "
              f"{COMM_BF16_LOSS_REL}, gather >= {COMM_GATHER_RATIO_MIN} (block {COMM_BLOCK} "
              f"reckons {4 / (1 + 4 / COMM_BLOCK):.4f}), cross-slice >= {COMM_CROSS_RATIO_MIN}",
              flush=True)
        for comp, _ in COMM_PAIRS:
            bound = COMM_BF16_LOSS_REL if comp == "data2_bf16" else COMM_LOSS_REL
            if max(rd[f"{comp}:loss_rel"]) > bound:
                fails.append(f"{comp}: loss gap {rd[f'{comp}:loss_rel']} > {bound}")
        for k, v in rd.items():
            if k.endswith(":ranks_agree") and not v:
                fails.append(f"{k.split(':')[0]}: the ranks' weights differ")
        if rd["gather_fp32_over_int8"] < COMM_GATHER_RATIO_MIN:
            fails.append(f"qwZ gather ratio {rd['gather_fp32_over_int8']}")
        if rd["cross_slice_ratio"] < COMM_CROSS_RATIO_MIN:
            fails.append(f"cross-slice ratio {rd['cross_slice_ratio']}")
        for rk in out["runs"][COMM_SAVE]:
            if not rk.get("hpz_equal"):
                fails.append("hpZ's store is not the quantized shards")
        # (d) the checkpoint of (a) at world 1, in this process.
        cfg, model_cfg = _comm_cfg(COMM_SAVE)
        cfg = dataclasses.replace(cfg, mesh=type(cfg.mesh)(), comm_quant_weights=False,
                                  comm_secondary_weights=False)
        prog = build_train_program(cfg, model_cfg, device="cuda")
        mgr = ck.TrainCheckpointManager(str(work / "ck"), program=prog)
        like = ck.abstract_state_like(prog)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, state, report = reshard.restore_resharded(mgr, like, program=prog)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        nbytes = report["plan"]["total_bytes"]
        out["reshard"] = {"step": step, "parity_ok": report.get("parity_ok"),
                          "bytes": nbytes, "bytes_remapped": report.get("bytes_remapped"),
                          "seconds": restore_s, "gb_s": nbytes / restore_s / 1e9,
                          "src": report["plan"]["src_topology"]}
        print(f"train_comm reshard: step {step}, parity {report.get('parity_ok')}, "
              f"{nbytes} B from {report['plan']['src_topology']} to world 1 in "
              f"{restore_s:.2f} s ({out['reshard']['gb_s']:.3f} GB/s)", flush=True)
        if step != steps or not report.get("parity_ok"):
            fails.append(f"restore_resharded: step {step}, report {report}")
        elif _whole_checksums(prog, state) != out["runs"][COMM_SAVE][0]["checksums"]:
            fails.append("restore_resharded: the weights are not (a)'s")
        del prog, state, like
        if fails:
            raise AssertionError("; ".join(fails))
    finally:
        shutil.rmtree(work, ignore_errors=True)
        _free()


def _serve_mesh_model(state: dict):
    """llama-1b at SERVE_MESH_L layers: :func:`_llama_1b`'s weights, its
    first layers (views)."""
    cfg, params = _llama_1b(state)
    return cfg.with_(n_layers=SERVE_MESH_L), {
        k: v[:SERVE_MESH_L] if k.startswith("layers.") else v for k, v in params.items()}


def _mesh_teacher(cfg):
    """The teacher-forced decode of ``serve_mesh``: ``serve``'s first 8
    prompts and 16 tokens from seed 1 fed one a step ([8, 16])."""
    import numpy as np
    import torch

    rows, n = SERVE_MESH_TEACHER
    prompts = [p for p, _, _ in _serve_plan(cfg)[:rows]]
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (rows, n))
    return prompts, torch.tensor(toks, device="cuda")


def _mesh_serve(mode: str, rank: int, fault=None) -> dict:
    """One rank of ``serve_mesh`` on model=2 (cuda:0, NCCL): llama-1b's
    seed-0 bf16 weights at SERVE_MESH_L layers (and their weight-only int8
    tree) made whole and the batcher keeping the rank's blocks. ``mode``
    "serve": ``serve``'s 16 requests in each run of SERVE_MESH_RUNS
    (:func:`_serve_run`; rank 0 submits), then the teacher-forced decode
    of both trees; "teacher": the teacher-forced decodes alone. Rank 0
    saves each tree's decode logits (whole, [16, 8, V]) to
    ``chiprun_out/serve_mesh_logits_<tree>.pt``. ``fault`` names a planted
    fault of serve_faults.py, patched throughout."""
    import contextlib

    import torch

    from tpu_engine_torch import serving as tsrv
    from tpu_engine_torch.mesh_runtime import MeshConfig, MeshRuntime
    from tpu_engine_torch.quant import quantize_params

    patch = contextlib.nullcontext()
    if fault:
        import serve_faults

        patch = serve_faults._patched(serve_faults.mesh_fault(fault))
    rt = MeshRuntime(MeshConfig(model=2), device=torch.device("cuda", 0))
    cfg, params = _serve_mesh_model({})
    qparams = quantize_params(params)  # the whole int8 tree: the batcher cuts it
    out, blocks = {"runs": {}}, {}
    with patch:
        if mode == "serve":
            for key, tree, kv_quant in SERVE_MESH_RUNS:
                r = _serve_run(qparams if tree == "int8" else params, cfg, _serve_plan(cfg),
                               f"mesh {key} rank {rank}", mesh=rt, kv_quant=kv_quant)
                r.pop("first_logits")
                r["hits"] = {str(k): v for k, v in r["hits"].items()}
                blocks[tree] = r.pop("params")
                out["runs"][key] = r
        else:
            blocks = {tree: tsrv.ContinuousBatcher(qparams if tree == "int8" else params, cfg,
                                                   mesh=rt, **SERVE_CFG).params
                      for tree in ("bf16", "int8")}
        del params, qparams
        _free()
        prompts, teacher = _mesh_teacher(cfg)
        torch.cuda.reset_peak_memory_stats()
        logits = {tree: _pool_logits(block, cfg, prompts, teacher, False, torch.bfloat16,
                                     mesh=rt) for tree, block in sorted(blocks.items())}
    out["teacher_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    for tree, lg in logits.items():
        if rank == 0:
            torch.save(lg.cpu(), ROOT / "chiprun_out" / f"serve_mesh_logits_{tree}.pt")
        out[f"logits_checksum_{tree}"] = float(lg.double().sum())
    return out


def serve_mesh_rel(cfg, params, ranks: list, tree: str = "bf16") -> float:
    """The relative norm error of the ranks' teacher-forced decode logits
    of the ``tree`` weights ("bf16", or "int8": weight-only int8; saved by
    rank 0) against the one-rank pool's on the same tokens (``params``: the
    whole bf16 weights in this process, quantized for "int8"). The file is
    removed after."""
    import torch

    from tpu_engine_torch.quant import quantize_params

    path = ROOT / "chiprun_out" / f"serve_mesh_logits_{tree}.pt"
    mesh_logits = torch.load(path).cuda()
    path.unlink()
    prompts, teacher = _mesh_teacher(cfg)
    if tree == "int8":
        params = quantize_params(params)
    one = _pool_logits(params, cfg, prompts, teacher, False, torch.bfloat16)
    return _rel_err(mesh_logits, one)


def phase_serve_mesh(res: dict, state: dict) -> None:
    """The batcher on model=2 at llama-1b's width and SERVE_MESH_L layers
    (``mesh=``; two ranks, a process each on the one card through NCCL,
    each with 8 heads, 2752 MLP columns, 16000 vocabulary rows and 8 kv
    heads of the pool): ``serve``'s
    plan (SERVE_CFG: 8 slots, 16 requests, four sampled, a shared prefix)
    with the bf16 pool and the int8 pool, and with the weights' int8 tree
    (``quantize_params``, cut by the batcher as JAX's quantize_pspecs
    splits it) and the bf16 pool, rank 0 submitting. Checks: every request
    done on both ranks and no slot left busy; the two ranks' streams
    equal; the greedy streams teacher-forced through the one-rank forward
    of the same tree within SERVE_TAU; prefix hits; each tree's
    teacher-forced decode logits on the ranks against the one-rank pool's
    within SERVE_TP_REL (serve_faults.py, set from planted faults).
    Reports TTFT p50/p99 (rank 0), decode tokens/s and peak memory per
    rank."""
    from serve_faults import SERVE_TP_REL

    from tpu_engine_torch.quant import quantize_params

    cfg, params = _serve_mesh_model(state)
    ranks = mesh_launch([], 2, 0, "serve", serve="serve")
    plan = _serve_plan(cfg)
    rel = {tree: serve_mesh_rel(cfg, params, ranks, tree) for tree in ("bf16", "int8")}
    trees = {"bf16": params, "int8": quantize_params(params)}
    fails, gaps = [], {}
    out = res["serve_mesh"] = {"config": SERVE_CFG, "layers": SERVE_MESH_L, "teacher_rel": rel,
                               "serve_tp_rel": SERVE_TP_REL, "card": res.get("card"),
                               "ranks": [r["serve"] for r in ranks]}
    for key, tree, _ in SERVE_MESH_RUNS:
        runs = [r["serve"]["runs"][key] for r in ranks]
        for rank, run in enumerate(runs):
            if run["statuses"] != ["done"] * len(plan):
                fails.append(f"{key} rank {rank}: statuses {run['statuses']}")
            if _slots_left_busy(run):
                fails.append(f"{key} rank {rank}: slots left busy {run['slot_state']}")
            if not run["on_card"]:
                fails.append(f"{key} rank {rank}: pool or parameters not on the card")
            print(f"serve_mesh {key} rank {rank}: decode dispatch {run['dispatch_ms']:.2f} ms "
                  f"({run['decode_tokens_per_s']:.1f} tokens/s), peak "
                  f"{run['peak_mem_gib']:.2f} GiB, KV pool {run['kv_bytes'] / 2**30:.3f} GiB "
                  f"({_card_line()})", flush=True)
        if runs[1]["tokens"] != runs[0]["tokens"]:
            fails.append(f"{key}: rank 1's streams differ from rank 0's")
        if not any(runs[0]["hits"].values()):
            fails.append(f"{key}: no prefix-cache hit")
        gaps[key] = max(_stream_gap(trees[tree], cfg, p, toks)
                        for (p, _, t), toks in zip(plan, runs[0]["tokens"]) if t == 0.0)
        if not gaps[key] <= SERVE_TAU:
            fails.append(f"{key}: largest teacher-forced gap {gaps[key]:.3e} > {SERVE_TAU}")
        print(f"serve_mesh {key}: TTFT p50 {runs[0]['ttft_ms_p50']:.1f} ms, p99 "
              f"{runs[0]['ttft_ms_p99']:.1f} ms, {runs[0]['tokens_per_s']:.1f} tokens/s "
              f"end to end; ranks' streams equal {runs[1]['tokens'] == runs[0]['tokens']}; "
              f"greedy streams teacher-forced through the one-rank forward, largest gap "
              f"{gaps[key]:.3e} (SERVE_TAU {SERVE_TAU})", flush=True)
    out["greedy_max_gap"] = gaps
    for tree, r in rel.items():
        print(f"serve_mesh: teacher-forced decode logits of the {tree} weights on model=2 "
              f"against one rank, relative {r:.3e} (SERVE_TP_REL {SERVE_TP_REL})", flush=True)
        if not r <= SERVE_TP_REL:
            fails.append(f"{tree} weights: teacher-forced logits relative {r:.3e} > "
                         f"{SERVE_TP_REL}")
    if fails:
        raise AssertionError("; ".join(fails))


def _time_optimizer(prog, state, key: str) -> float:
    """Device time of the program's optimizer update alone over its
    trainable parameters (CUDA events), on zero gradients at lr 0: the same
    tensors, passes and copies (its walk) as in a step, leaving the weights
    unchanged."""
    import torch

    params = state["params"]
    grads = {k: torch.zeros(p.shape, dtype=torch.float32 if prog.host else p.dtype,
                            device=prog.device) for k, p in params.items()}
    ms = _time_ms(lambda: prog.tx.update(params, grads, state["opt_state"], 0.0, prog.walk),
                  iters=3, warmup=1)
    print(f"{key}: optimizer update {ms:.2f} ms", flush=True)
    return ms


def _profile(run, key: str) -> dict:
    """Wall and device time of one call of ``run``, the device's by kernel
    family, from torch.profiler (CUPTI). Families: the port's flash
    kernels, matrix products (cuBLAS/CUTLASS), and everything else
    (elementwise, norms, reductions, copies on the card). Copies between
    host and card (``memcpy_ms`` each way) are apart: they run on the copy
    engines beside the kernels, outside the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    fam = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    memcpy = {"h2d": 0.0, "d2h": 0.0}
    for e in kernels:
        name = e.key.lower()
        ms = e.self_device_time_total / 1e3
        way = "h2d" if "memcpy htod" in name else "d2h" if "memcpy dtoh" in name else None
        if way:  # copies between host and card run beside the kernels
            memcpy[way] += ms
            continue
        if "flash_fwd_" in name or "flash_bwd_d" in name:
            fam["flash"] += ms
        elif any(t in name for t in ("gemm", "nvjet", "cutlass", "sm90_xmma", "matmul")):
            fam["matmul"] += ms
        else:
            fam["other"] += ms
    busy = sum(fam.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    out = {
        "wall_ms": wall_ms, "device_ms": busy, "launches": sum(e.count for e in kernels),
        "idle_share": (1 - busy / wall_ms) if busy else None,
        "families_ms": fam, "memcpy_ms": memcpy,
        "top": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3, "calls": e.count}
                for e in top],
    }
    print(f"profile {key}: wall {wall_ms:.1f} ms, device {busy:.1f} ms, "
          f"{out['launches']} kernel launches, families "
          + json.dumps({k: round(v, 2) for k, v in fam.items()}), flush=True)
    for t in out["top"]:
        print(f"profile {key}:   {t['ms']:9.3f} ms {t['calls']:5d}x {t['name']}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3,
                    help="training steps of each training phase (at least 3)")
    ap.add_argument("--mesh-worker", nargs=2, metavar=("JOB", "RANK"),
                    help="run one rank of train_mesh (the phase starts these itself)")
    args = ap.parse_args()
    if args.mesh_worker:
        mesh_worker(args.mesh_worker[0], int(args.mesh_worker[1]))
        return 0
    if args.steps < 3:
        ap.error("--steps must be at least 3: step 0 has a learning rate of 0")

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

    t_start = time.perf_counter()
    compiled: dict = {}

    def compile_kernels():
        t0 = time.perf_counter()
        try:
            compiled["lib"] = fc.build()
            fc.sass_dump()  # kept for the build phase's SASS checks
        except Exception as e:  # raised again by the build phase
            compiled["error"] = e
        compiled["s"] = time.perf_counter() - t0

    # nvcc builds the kernels, and cuobjdump reads their SASS, on a thread
    # while the serving phases that launch no kernel of the port (plain
    # attention; the decode path has none) use the card; the build phase
    # then waits for it.
    compiling = threading.Thread(target=compile_kernels, name="nvcc", daemon=True)
    compiling.start()
    serving: dict = {}
    run("serve_mesh", phase_serve_mesh, res, serving)
    run("generate", phase_generate, res, serving)
    run("hf_bridge", phase_hf_bridge, res, serving)
    serving.clear()
    run("generate_gemma", phase_generate_gemma, res)
    _free()
    if fc._lib is not None:
        print("chip_smoke: a serving phase loaded the kernels during their build",
              file=sys.stderr)
        res["failed"].append("serving_before_build")

    def build():
        compiling.join()
        res["build_compile_s"] = compiled["s"]
        if "error" in compiled:
            raise compiled["error"]
        lib = compiled["lib"]
        log = Path(str(lib) + ".log").read_text()
        res["build"] = {"library": str(lib.relative_to(ROOT))}
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error",
                                       "warning", "setmaxnreg", "==")):
                print(f"ptxas: {line.strip()}", flush=True)
        res["build"]["ptxas"] = check_ptxas(fc, log)
        res["build"]["ptxas_f32"] = check_ptxas_f32(fc, log)
        res["build"]["sass"] = check_sm90_sass(fc)
        res["build"]["sass_f32"] = check_f32_sass(fc)
        fc._load()

    run("build", build)
    if "build" not in res["failed"]:
        run("kernels", phase_kernels, res)
        run("model", phase_model, res)
        run("head", phase_head, res)
        run("train", phase_train, res, args.steps)
        run("train_data", phase_train_data, res)
        run("train_job", phase_train_job, res)
        run("train_fleet", phase_train_fleet, res)
        run("serve_fleet", phase_serve_fleet, res)
        run("ring", phase_ring, res)
        run("train_ring", phase_train_ring, res, args.steps)
        run("train_fp32", phase_train_fp32, res, args.steps)
        run("train_tiny", phase_train_tiny, res, args.steps)
        run("train_gemma", phase_train_gemma, res, args.steps)
        run("train_moe", phase_train_moe, res, args.steps)
        run("train_int8", phase_train_int8, res, args.steps)
        run("train_lora", phase_train_lora, res, args.steps)
        run("train_opt", phase_train_opt, res, args.steps)
        run("remat", phase_remat, res)
        run("train_offload", phase_train_offload, res)
        run("train_7b", phase_train_7b, res)
        run("train_window", phase_train_window, res)
        run("train_mesh", phase_train_mesh, res, args.steps)
        run("train_pipe", phase_train_pipe, res, args.steps)
        run("train_mesh_state", phase_train_mesh_state, res, args.steps)
        run("train_comm", phase_train_comm, res, args.steps)
        serving = {}
        run("serve", phase_serve, res, serving)
        run("serve_spec", phase_serve_spec, res, serving)
        serving.clear()
        run("serve_moe", phase_serve_moe, res)
    # Launches per training step on the paths, each counted from 0 around its
    # own run of steps x accumulation microbatches: the bf16 D 128 kernels'
    # on D128_PATHS (K1's also per teacher forward of serve_moe), the bf16
    # D 256 kernels' on train_gemma, each
    # OFF_PATH row's on its own paths. A row that names paths must have
    # launched on them; non-causal bf16 D 256 (ring attention's past hops at
    # gemma's head dim) runs on no path and names none.
    idle = []
    for kr in res.get("kernels", []):
        kr["launches_by_path"] = {}
        for p in kr["paths"]:
            path = res.get(p, {})
            n = path.get("launches", {}).get(kr["counter"])
            kr["launches_by_path"][p] = None if n is None else n // (path["steps"] * path["accum"])
        kr["launches"] = sum(n or 0 for n in kr["launches_by_path"].values())
        if kr.pop("paths") and not kr["launches"]:
            idle.append(kr["name"])
    if idle:
        print(f"chip_smoke: kernels never launched on their paths: {idle}", file=sys.stderr)
        res["failed"].append("launches")
    print(f"phases: {json.dumps(res.get('phase_s', {}))}", flush=True)
    res["wall_s"] = time.perf_counter() - t_start
    print(f"wall: {res['wall_s']:.1f} s from the build's start; nvcc and cuobjdump "
          f"{res.get('build_compile_s', float('nan')):.1f} s beside serve_mesh, generate, "
          "hf_bridge and generate_gemma", flush=True)

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
