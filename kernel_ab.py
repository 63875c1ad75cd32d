"""Time the flash-attention kernels (K1 forward, K2 dQ, K3 dK/dV) of two
checkouts of the port on one card, in turns, beside the library's attention
on the same data.

    python3 kernel_ab.py --base path/to/other/checkout [--rounds 2] [--shapes causal_d32 ...]
    python3 kernel_ab.py --variant presplit_kv --dtype fp32
    python3 kernel_ab.py --variant k3_serial k3_stages4 --shapes causal_d32 causal_d16
    python3 kernel_ab.py --variant k2_serial k2_two_wg --kernels flash_bwd_dq --shapes causal_d32

With ``--variant NAME [NAME ...]`` each base is this tree with
``VARIANTS[NAME]``, a text patch of kernel sources, built under
``chip_checkout/kernel_ab/`` (git-ignored), all builds at once: designs
measured against the one the tree keeps. With
``--dtype fp32`` the inputs are fp32 (the split-TF32 K1, K2 and K3),
the bounds are at the split-TF32 rate and the library's time is SDPA's
forward only.

Each checkout's ``tpu_engine_torch/ops/_flash_cuda.py`` is loaded as a module
of its own, so each builds its own kernels from its own sources. Per round
the order is the bases, this tree twice, the bases in reverse. Shapes: causal at B·H 64,
S 2048, D 128 (llama-1b's training step), non-causal and causal at the
ring shard, B·H 16 (llama-1b at seq 8192 over a ring of 4), causal and
non-causal at B·H 4·8, S 2048, D 256 (gemma-2b's training step), and at
B·H 64, S 2048 the small heads: D 32 causal and non-causal (qwen-tiny's)
and D 16 causal (gpt-tiny's), and D 64 causal at B·H 16·12 (gpt-125m's
micro-batch 16); ``--shapes`` takes a subset. K2 and K3
of both trees take the same lse and Δ (this tree's K1 forward). Each
kernel's bound (``chip_smoke.kernel_bounds``: operations, the exp unit or
bytes, whichever is longest) is printed beside its times.
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
    "causal_d32": (64, 2048, 32, True),
    "full_d32": (64, 2048, 32, False),
    "causal_d16": (64, 2048, 16, True),
    "causal_d64": (192, 2048, 64, True),
}
# The same non-causal work (B·H · S^2 fixed) cut into more, shorter heads:
# q, k and v grow from 12.6 MB (fits L2) to 101 MB (does not).
SWEEP = {f"full_bh{bh}_s{s}": (bh, s, 128, False)
         for bh, s in ((4, 4096), (64, 1024), (256, 512))}
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

# Designs measured against the kept ones: (source under csrc/, [(text,
# replacement)]); a patch may name its own source as (source, text,
# replacement). The bf16 K1 and K3 at D 16 and 32 (flash_fwd_sm90.cu,
# flash_bwd_sm90.cu; the kept: K1 with two consumer warpgroups taking
# turns at the softmax, 128-key K/V tiles on a two-stage ring and four
# partial chains of the row max and sum; K3 with three consumer warpgroups
# (K and V in registers at D 16) and 64-query streamed tiles on a
# three-stage ring, tile i's scores run under tile i - 1's dV and dK
# products): k1_issue_turns, k1_three_wg, k1_no_turns, k1_stages3,
# k1_keys192, k1_chains1, k1_keys64, k3_own_smem, k3_two_wg, k3_two_wg_regs,
# k3_serial, k3_stream128, k3_stages4. The bf16 K2 at D 16 and 32
# (flash_bwd_sm90.cu; the kept: three consumer warpgroups, Q and dO in
# registers, 64-key K/V tiles on a four-stage ring, tile j's S and dP
# products issued ahead of tile j - 1's dQ product): k2_two_wg, k2_four_wg,
# k2_serial, k2_qdo_smem, k2_qdo_smem_d32, k2_stages2, k2_stages3,
# k2_stages6, k2_stages8, k2_lse_global, k2_turns, k2_fma_exp.
# The fp32 K1, K2 and K3
# (csrc/flash_f32_tc.cu; the kept: K1 with 32-key K/V tiles, each operand
# split into TF32 hi and lo as its fragment is loaded, each tile's P V summed into one temporary per
# accumulator register; K2: 16-key K/V tiles, two tiles' dS K summed into
# one temporary per accumulator register): (source under csrc/, [(text,
# replacement)]).
_KEYS16 = ("  static constexpr int kKeys = 32;",
           "  static constexpr int kKeys = 16;")
_PV = "        mma_split(pv[n], a, b);"
_RESCALE = ("#pragma unroll\n    for (int n = 0; n < NO; ++n)\n#pragma unroll\n"
            "      for (int e = 0; e < 4; ++e) "
            "acc[n][e] = fmaf(acc[n][e], corr[e >> 1], pv[n][e]);")
# d[64 x 192] (+)= A[64 x 16] * B[16 x 192], both K-major in shared memory,
# inserted before the m64n80 one.
_SS80 = "// d[64 x 80] (+)= A[64 x 16] * B[16 x 80], both from shared memory, K-major."
_SS192 = (
    "__device__ __forceinline__ void wgmma_ss(float (&d)[96], uint64_t a, uint64_t b, "
    "int scale_d) {\n  asm volatile(\n"
    "      \"{\\n.reg .pred p;\\nsetp.ne.b32 p, %98, 0;\\n\"\n"
    "      \"wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
    + ", ".join(f"%{i}" for i in range(96)) + "}, \"\n"
    "      \"%96, %97, p, 1, 1, 0, 0;\\n}\\n\"\n      : "
    + ", ".join(f"TPE_ACC8(d, {8 * i})" for i in range(12))
    + '\n      : "l"(a), "l"(b), "r"(scale_d));\n}\n')
# DqTiles<D>'s lines that the K2 variants patch.
_K2_WG = ("  static constexpr int kConsumers = D < 64 ? 3 : 2;\n"
          "  static constexpr int kOwnRows = 64 * kConsumers;  // Q rows a CTA owns")
_K2_PIPE = ("  static constexpr bool kPipelined = D < 64;\n"
            "  static constexpr int kStages = kPipelined ? 4 : 2;  // depth of the K/V ring")
_K2_REGS = ("  // back to the producer as soon as they are loaded.\n"
            "  static constexpr bool kOwnInRegs = D < 64;")
# K2's exps of one tile, P in place over s.
_K2_EXP = "            s[x] = fast_exp2(fmaf(s[x], scale2, nl[(x >> 1) & 1]));"
_K2_PROBS = ("        auto probs = [&]() {\n#pragma unroll\n"
             "          for (int x = 0; x < kStream / 2; ++x)\n" + _K2_EXP + "\n        };")
_K2_SKIP = "          mbar_wait(full(stage(j)), phase(j));\n          release(empty(stage(j)));"
_K2_LOOP = "    int it = 0;\n    for (int r = 0;; ++r) {\n      mbar_wait(full_q, r & 1);"
_K2_END = ("    if constexpr (T::kStagedOut)\n"
           "      if (tid == 0) tma_store_wait_read();  // shared memory outlives the last store's reads")
# 2^x on the FMA pipe: x = j + f, j = round(x) in t's low bits (t = x + 1.5
# 2^23), 2^f by a cubic (relative error 1.0e-4 on |f| <= 1/2), j added to
# the exponent bits.
_FMA_EXP2 = """__device__ __forceinline__ float fma_exp2(float x) {
  x = fmaxf(x, -125.0f);
  const float t = x + 12582912.0f;
  const float f = x - (t - 12582912.0f);
  const float p = fmaf(fmaf(fmaf(0.05500893f, f, 0.242211f), f, 0.69328296f), f, 1.0f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

"""
VARIANTS = {
    # K1 at D 16/32 with one chain of fmax and of adds a row (D 64's).
    "k1_chains1": ("flash_fwd_sm90.cu", [
        ("  static constexpr int kChains = D < 64 ? 4 : 1;",
         "  static constexpr int kChains = 1;")]),
    # K1 at D 16/32 with 64-key K/V tiles (half the scores a tile).
    "k1_keys64": ("flash_fwd_sm90.cu", [
        ("  static constexpr int kBlockN = D > 128 ? 80 : 128;",
         "  static constexpr int kBlockN = D > 128 ? 80 : D < 64 ? 64 : 128;")]),
    # K1 at D 16/32 with three consumer warpgroups (192-row Q tiles).
    "k1_three_wg": ("flash_fwd_sm90.cu", [
        ("  static constexpr int kConsumers = 2;",
         "  static constexpr int kConsumers = D < 64 ? 3 : 2;")]),
    # K1 at D 16/32 with 192-key K/V tiles (S m64n192, a wgmma added to
    # sm90.cuh).
    "k1_keys192": ("flash_fwd_sm90.cu", [
        ("  static constexpr int kBlockN = D > 128 ? 80 : 128;",
         "  static constexpr int kBlockN = D > 128 ? 80 : D < 64 ? 192 : 128;"),
        ("sm90.cuh", _SS80, _SS192 + "\n" + _SS80),
    ]),
    # K1 at D 16/32 with D 64's turns: at issuing the products, not at the
    # softmax.
    "k1_issue_turns": ("flash_fwd_sm90.cu", [
        ("  static constexpr bool kSoftmaxTurns = D < 64;",
         "  static constexpr bool kSoftmaxTurns = false;")]),
    # K3 at D 16 with S^T and dP^T reading K and V from shared memory.
    "k3_own_smem": ("flash_bwd_sm90.cu", [
        ("  static constexpr bool kOwnInRegs = D == 16;",
         "  static constexpr bool kOwnInRegs = false;")]),
    # K1 at D 16/32 with no turns between the consumer warpgroups.
    "k1_no_turns": ("flash_fwd_sm90.cu", [
        ("  static constexpr bool kTurns = true;", "  static constexpr bool kTurns = D >= 64;")]),
    # K1 at D 16/32 with a three-stage K/V ring.
    "k1_stages3": ("flash_fwd_sm90.cu", [
        ("  static constexpr int kStages = 2;  // depth of the K/V ring",
         "  static constexpr int kStages = D < 64 ? 3 : 2;  // depth of the K/V ring")]),
    # K3 at D 16/32 with two consumer warpgroups (128-key owned tiles).
    "k3_two_wg": ("flash_bwd_sm90.cu", [
        ("  static constexpr int kConsumers = D < 64 ? 3 : 2;",
         "  static constexpr int kConsumers = 2;")]),
    # The same with K and V in registers at D 32 too (240 registers).
    "k3_two_wg_regs": ("flash_bwd_sm90.cu", [
        ("  static constexpr int kConsumers = D < 64 ? 3 : 2;",
         "  static constexpr int kConsumers = 2;"),
        ("  static constexpr bool kOwnInRegs = D == 16;",
         "  static constexpr bool kOwnInRegs = D < 64;")]),
    # K3 at D 16/32 with D 64's loop: a tile's products, scores and dV/dK
    # products in turn, on a two-stage ring.
    "k3_serial": ("flash_bwd_sm90.cu", [
        ("  static constexpr bool kPipelined = D < 64;",
         "  static constexpr bool kPipelined = false;")]),
    # K3 at D 16/32 with a four-stage streamed ring.
    "k3_stages4": ("flash_bwd_sm90.cu", [
        ("  static constexpr int kStages = kPipelined ? 3 : 2;  // depth of the streamed ring",
         "  static constexpr int kStages = kPipelined ? 4 : 2;  // depth of the streamed ring")]),
    # K3 at D 16/32 with 128-query streamed tiles (K and V from shared
    # memory).
    "k3_stream128": ("flash_bwd_sm90.cu", [
        ("  static constexpr int kStream = 64;  // queries of a streamed tile",
         "  static constexpr int kStream = D < 64 ? 128 : 64;"),
        ("  static constexpr bool kOwnInRegs = D == 16;",
         "  static constexpr bool kOwnInRegs = false;")]),
    # K2 at D 16/32 with two consumer warpgroups (128-row owned tiles).
    "k2_two_wg": ("flash_bwd_sm90.cu", [(_K2_WG, _K2_WG.replace("D < 64 ? 3 : 2", "2"))]),
    # K2 at D 16/32 with four consumer warpgroups (256-row owned tiles, 112
    # registers each).
    "k2_four_wg": ("flash_bwd_sm90.cu", [
        (_K2_WG, _K2_WG.replace("D < 64 ? 3 : 2", "D < 64 ? 4 : 2"))]),
    # K2 at D 16/32 with D 64's loop: a tile's S and dP products, its dS and
    # its dQ product in turn, on a two-stage ring, Q and dO from shared
    # memory.
    "k2_serial": ("flash_bwd_sm90.cu", [
        (_K2_PIPE, _K2_PIPE.replace("kPipelined = D < 64;", "kPipelined = false;")),
        (_K2_REGS, _K2_REGS.replace("D < 64", "false"))]),
    # K2 at D 16, and at D 32, with S and dP reading Q and dO from shared
    # memory.
    "k2_qdo_smem": ("flash_bwd_sm90.cu", [(_K2_REGS, _K2_REGS.replace("D < 64", "D == 32"))]),
    "k2_qdo_smem_d32": ("flash_bwd_sm90.cu", [
        (_K2_REGS, _K2_REGS.replace("D < 64", "D == 16"))]),
    # K2 at D 16/32 with each consumer reading its rows' lse and delta from
    # global memory at the start of an owned tile (D 64's way).
    "k2_lse_global": ("flash_bwd_sm90.cu", [
        ("  static constexpr bool kRowsInSmem = kPipelined;",
         "  static constexpr bool kRowsInSmem = false;")]),
    # K2 at D 16/32 with the consumer warpgroups taking turns at the exps of
    # each streamed tile (named barriers 1-3 in a ring, as K1's turns; a
    # warpgroup that skips a tile passes its turn on).
    "k2_turns": ("flash_bwd_sm90.cu", [
        (_K2_PROBS, _K2_PROBS.replace("{\n#pragma", "{\n          named_sync(1 + c);\n#pragma")
         .replace("\n        };", "\n          named_arrive(1 + (c + 1) % T::kConsumers);\n        };")),
        (_K2_SKIP, _K2_SKIP.replace(
            "phase(j));", "phase(j));\n          named_sync(1 + c);\n"
            "          named_arrive(1 + (c + 1) % T::kConsumers);")),
        (_K2_LOOP,
         "    if (T::kPipelined && c == T::kConsumers - 1) named_arrive(1);\n" + _K2_LOOP),
        (_K2_END, "    if (T::kPipelined && c == 0) named_sync(1);\n" + _K2_END)]),
    # K2 at D 16/32 with a quarter of the exps (8 of a thread's 32 a tile)
    # on the FMA pipe.
    "k2_fma_exp": ("flash_bwd_sm90.cu", [
        ("// K2: dQ\n", "// K2: dQ\n" + _FMA_EXP2),
        (_K2_EXP, "          {\n            const float a = fmaf(s[x], scale2, nl[(x >> 1) & 1]);\n"
                  "            s[x] = (x & 7) >= 6 ? fma_exp2(a) : fast_exp2(a);\n          }")]),
    # K2 at D 16/32 with a K/V ring of two, three, six or eight stages.
    **{f"k2_stages{n}": ("flash_bwd_sm90.cu",
                         [(_K2_PIPE, _K2_PIPE.replace("? 4 : 2", f"? {n} : 2"))])
       for n in (2, 3, 6, 8)},
    # O += P V chained on the tensor cores across the whole sequence, with
    # no fp32 additions (the sums drift, see tf32_split.cuh).
    "k1_chained": ("flash_f32_tc.cu", [
        ("    float pv[NO][4] = {};\n",
         "#pragma unroll\n"
         "    for (int n = 0; n < NO; ++n)\n"
         "#pragma unroll\n"
         "      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];\n"),
        (_PV, "        mma_split(acc[n], a, b);"),
        (_RESCALE, ""),
    ]),
    # Each 8 keys' products summed from zero and added to O in fp32.
    "k1_kstep_sum": ("flash_f32_tc.cu", [
        (_PV, "        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n"
                 "        mma_split(d, a, b);\n"
                 "#pragma unroll\n"
                 "        for (int e = 0; e < 4; ++e) pv[n][e] += d[e];"),
    ]),
    # K3: each streamed tile's products summed into one temporary per
    # accumulator register (queries outer), where the kept design sums the
    # tile per 8 columns of output (columns outer) in four registers.
    "k3_tile_sums": ("flash_f32_tc.cu", [(
        """    SplitA xa[NQ];
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) acc_to_a(xa[kk], x[kk]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        SplitB b;
        load_b_permuted(b, Ct + kk * 8 * LD + n * 8, LD, g, t);
        mma_split(d, xa[kk], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += d[e];
    }""",
        """    float d[NO][4] = {};
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      SplitA xa;
      acc_to_a(xa, x[kk]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        SplitB b;
        load_b_permuted(b, Ct + kk * 8 * LD + n * 8, LD, g, t);
        mma_split(d[n], xa, b);
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += d[n][e];""")]),
    # 16-key K/V tiles, still split at each fragment load.
    "keys16": ("flash_f32_tc.cu", [_KEYS16]),
    # Each operand's lo rounded to nearest too, both halves masked (five
    # integer and fp32 operations a value where the kept split takes three).
    "split_rna": ("tf32_split.cuh", [(
        """    hi[e] = __float_as_uint(x) + 0x1000u;  // rounds to nearest once truncated
    lo[e] = __float_as_uint(x - __uint_as_float(hi[e] & 0xffffe000u));""",
        """    hi[e] = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo[e] = (__float_as_uint(x - __uint_as_float(hi[e])) + 0x1000u) & 0xffffe000u;""")]),
    # K2 with 32-key K/V tiles at D <= 128 (one CTA an SM at D 128, 135 KB;
    # D 256 keeps 16).
    "k2_keys32": ("flash_f32_tc.cu", [
        ("  static constexpr int kDqKeys = 16;",
         "  static constexpr int kDqKeys = D > 128 ? 16 : 32;")]),
    # K2 adding each 16-key tile's dS K to dQ in fp32, where the kept design
    # sums two tiles on the tensor cores first.
    "k2_tile_sums": ("flash_f32_tc.cu", [
        ("const bool add = ((u - u_lo) & 1) || u == u_hi;", "const bool add = true;")]),
    # K2's dQ += dS K chained on the tensor cores across the whole sequence,
    # with no fp32 additions (the sums drift, see tf32_split.cuh).
    "k2_chained": ("flash_f32_tc.cu", [
        ("const bool add = ((u - u_lo) & 1) || u == u_hi;", "const bool add = false;"),
        ("        mma_split(dq_sum[n], dsa[kk], b);", "        mma_split(dq_acc[n], dsa[kk], b);"),
    ]),
    # 16-key K/V tiles (so that two CTAs still fit an SM at D 128), each
    # split once into hi (in place) and lo (a buffer of its own) after it
    # lands; the fragments then load hi and lo with no arithmetic.
    "presplit_kv": ("flash_f32_tc.cu", [
        _KEYS16,
        ("kSmemFwd = kTile + 4 * sizeof(float) * kKeys * LD + kXchFwd;",
         "kSmemFwd = kTile + 6 * sizeof(float) * kKeys * LD + kXchFwd;"),
        ("  float* xch = Vs + 2 * T::kKeys * LD;",
         "  float* Klo = Vs + 2 * T::kKeys * LD;\n"
         "  float* Vlo = Klo + T::kKeys * LD;\n"
         "  float* xch = Vlo + T::kKeys * LD;"),
        ("    const float* Vt = Vs + st * T::kKeys * LD + c0;",
         "    {\n"
         "      uint32_t* kh = reinterpret_cast<uint32_t*>(Ks + st * T::kKeys * LD);\n"
         "      uint32_t* vh = reinterpret_cast<uint32_t*>(Vs + st * T::kKeys * LD);\n"
         "      for (int idx = tid; idx < T::kKeys * LD; idx += T::kFwdThreads) {\n"
         "        const float x = __uint_as_float(kh[idx]), y = __uint_as_float(vh[idx]);\n"
         "        kh[idx] = (kh[idx] + 0x1000u) & 0xffffe000u;\n"
         "        reinterpret_cast<uint32_t*>(Klo)[idx] =\n"
         "            __float_as_uint(x - __uint_as_float(kh[idx]));\n"
         "        vh[idx] = (vh[idx] + 0x1000u) & 0xffffe000u;\n"
         "        reinterpret_cast<uint32_t*>(Vlo)[idx] =\n"
         "            __float_as_uint(y - __uint_as_float(vh[idx]));\n"
         "      }\n"
         "    }\n"
         "    __syncthreads();\n"
         "    const float* Vt = Vs + st * T::kKeys * LD + c0;\n"
         "    const float* Ktl = Klo + c0;\n"
         "    const float* Vtl = Vlo + c0;"),
        ("        load_b_rows(b, Kt + n * 8 * LD + kk * 8, LD, g, t);",
         "        {\n"
         "          const int e = n * 8 * LD + kk * 8 + g * LD + t;\n"
         "          b.hi[0] = __float_as_uint(Kt[e]);\n"
         "          b.hi[1] = __float_as_uint(Kt[e + 4]);\n"
         "          b.lo[0] = __float_as_uint(Ktl[e]);\n"
         "          b.lo[1] = __float_as_uint(Ktl[e + 4]);\n"
         "        }"),
        ("        load_b_permuted(b, Vt + kk * 8 * LD + n * 8, LD, g, t);",
         "        {\n"
         "          const int e = (kk * 8 + 2 * t) * LD + n * 8 + g;\n"
         "          b.hi[0] = __float_as_uint(Vt[e]);\n"
         "          b.hi[1] = __float_as_uint(Vt[e + LD]);\n"
         "          b.lo[0] = __float_as_uint(Vtl[e]);\n"
         "          b.lo[1] = __float_as_uint(Vtl[e + LD]);\n"
         "        }"),
    ]),
}


def _variant_tree(name: str) -> Path:
    """A copy of this tree's package with ``VARIANTS[name]`` applied."""
    import shutil

    tree = ROOT / "chip_checkout" / "kernel_ab" / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "tpu_engine_torch", tree / "tpu_engine_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    source, patches = VARIANTS[name]
    for patch in patches:
        src = tree / "tpu_engine_torch" / "csrc" / (patch[0] if len(patch) == 3 else source)
        old, new = patch[-2:]
        text = src.read_text()
        if text.count(old) != 1:
            raise AssertionError(f"{name}: {old!r} occurs {text.count(old)} times")
        src.write_text(text.replace(old, new))
    return tree


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
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--base", type=Path, help="the other checkout's root")
    which.add_argument("--variant", nargs="+", choices=sorted(VARIANTS),
                       help="this tree with a design variant's patch as a base, one per name")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS))
    ap.add_argument("--shapes", nargs="+", choices=sorted(SHAPES), default=list(SHAPES),
                    help="the shapes to time (default: all of SHAPES)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sweep", action="store_true", help="also the shapes of SWEEP")
    args = ap.parse_args()
    shapes = {**{k: SHAPES[k] for k in args.shapes}, **(SWEEP if args.sweep else {})}
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    bases = ({"base": args.base.resolve()} if args.base
             else {name: _variant_tree(name) for name in args.variant})
    # Build every tree at once: each build runs its compilers in parallel.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(bases) + 1) as pool:
        loaded = pool.map(lambda kv: (kv[0], _load(kv[1], f"flash_{kv[0]}")),
                          [*bases.items(), ("this", ROOT)])
        trees = dict(loaded)
    fp32 = args.dtype == "fp32"
    torch.backends.cuda.matmul.allow_tf32 = False
    data = {}
    for key, (bh, s, d, causal) in shapes.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn((bh, s, d), generator=g, device="cuda")
                       for _ in range(4))
        if not fp32:
            q, k, v, do = (x.bfloat16() for x in (q, k, v, do))
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

    bwd_keys = [key for key in shapes if key in SHAPES]  # the backward at the chosen shapes
    jobs = [(kn, key) for key in shapes for kn in args.kernels
            if kn == "flash_fwd" or key in bwd_keys]
    from chip_smoke import PEAK_BF16_FLOPS, PEAK_SPLIT_TF32_FLOPS, kernel_bounds

    peak = PEAK_SPLIT_TF32_FLOPS if fp32 else PEAK_BF16_FLOPS
    out = {"card": card, "dtype": args.dtype, "base": str(args.base or args.variant),
           "ms": {t: {f"{kn}/{key}": [] for kn, key in jobs} for t in trees},
           "bound": {f"{kn}/{key}": kernel_bounds(bh, s, d, 0, 4 if fp32 else 2, causal,
                                                  peak)[kn]
                     for kn, key in jobs for bh, s, d, causal in [shapes[key]]}}
    # sdpa: the forward; flash_bwd: dq, dk and dv together (bf16 only: the
    # flash op takes no fp32).
    out["ms"]["library"] = {f"{op}/{key}": [] for op in ("sdpa", "flash_bwd") for key in shapes
                            if op == "sdpa" or (key in bwd_keys and not fp32)}
    for _ in range(args.rounds):
        for tree in (*bases, "this", "this", *reversed(bases)):
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
            bound = out["bound"].get(key)
            print(f"{tree:8s} {key:34s} " + " ".join(f"{x:.4f}" for x in times)
                  + (f"  (bound {bound['bound_ms']:.4f} by {bound['bound_by']})" if bound else ""),
                  flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
