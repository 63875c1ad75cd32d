// fp32 flash attention on Hopper's tensor cores in split TF32 (sm_90a):
// K1, the forward, K2, dQ, and K3, dK and dV, each causal (optionally
// sliding-window) and non-causal, at head dims 16, 32, 64, 128 and 256.
// Plain C entries, called by flash_attention.cu's tpe_flash_fwd,
// tpe_flash_bwd_dq and tpe_flash_bwd_dkv for every fp32 call.
//
// Layout as in flash_attention.cu: q, k, v, o, dO, dq, dk, dv are [BH, S, D]
// contiguous fp32; lse (natural log) and delta are [BH, S] fp32; S is a
// multiple of 64; scale = 1/sqrt(D).
//
// What each kernel replaces and what bounds it on the H100:
//
// K1 flash_fwd_f32_tc replaces _fwd_kernel (tpu_engine/ops/_flash_pallas.py,
//   launched by _flash_fwd): o = softmax(q k^T * scale) v and the row lse.
//   At B·H 64, S 2048, D 128, causal, it does 2 products over the visible
//   (q, k) pairs, 6.9e10 FLOP. An fp32-accurate product costs three TF32
//   products (tf32_split.cuh), so the least time is 6.9e10 * 3 / 495
//   TFLOP/s = 0.42 ms, against 0.08 ms to move its 269 MB: bound by
//   operations.
// K2 flash_bwd_dq_f32_tc replaces _bwd_dq_kernel (launched by _flash_bwd):
//   dQ = dS k, with P rebuilt from (q, k, lse) and dS = P (dO v^T - delta)
//   * scale. 3 products, 1.03e11 FLOP: 0.63 ms at the same shape, against
//   0.10 ms for its 337 MB.
// K3 flash_bwd_dkv_f32_tc replaces _bwd_dkv_kernel: dV = P^T dO and
//   dK = dS^T q, with P rebuilt from (q, k, lse) and dS = P (dO v^T - delta)
//   * scale. 4 products, 1.4e11 FLOP: 0.83 ms at the same shape, against
//   0.12 ms for its bytes.
//
// What the design does about what held the scalar-FMA fp32 kernels these
// replace at 5-15 % of the FMA rate:
//
// 1. Tensor cores. Every product is mma.sync m16n8k8 with TF32 operands,
//    each fp32 operand split into hi + lo and each product taken as three
//    (tf32_split.cuh). The ceiling moves from 67 TFLOP/s (FMA) to 165
//    (495 / 3). One warp owns 16 rows of the CTA's tile and keeps its
//    scores, probabilities and accumulators in registers. An accumulator is
//    not an A fragment in TF32 (its lane holds columns 2t, 2t + 1; A wants
//    t, t + 4), so P (K1), dS (K2) and P^T, dS^T (K3) become the next
//    product's A operand with the columns of each 8 taken in the order 0,
//    2, 4, 6, 1, 3, 5, 7 and the B operand's rows in the same order
//    (acc_to_a, load_b_permuted): no shuffles.
// 2. Bank conflicts. Every shared tile has rows of D + 4 floats. A B operand
//    read as rows g, columns t (K^T, and V^T in K2; in K3 Q^T and dO^T)
//    then falls on bank 4g + t, and one read as rows 2t, columns g (V; K in
//    K2; in K3 dO and Q) on bank 8t + g: 32 lanes, 32 banks, one wavefront
//    per load.
// 3. Occupancy and overlap. K1's CTA owns 64 Q rows and streams 32-key K/V
//    tiles; K2's owns 64 Q rows, keeps Q and dO in shared memory and
//    streams 16-key K/V tiles; K3's owns 64 keys and streams 16-query Q/dO
//    tiles (with their lse and delta). All double-buffer the streamed tiles
//    with cp.async, so the next tile loads while this one is multiplied. At
//    D 128 a K1 CTA is four warps and 101 KB, a K2 CTA four warps and 101
//    KB and a K3 CTA eight warps and 106 KB; two of any fit an SM.
// 4. No repeated work where one warp cannot hold a whole row. A warp of K3
//    holding both dK and dV of 16 keys would need two accumulators of D / 2
//    registers each, with no room left at D 128: K3's eight warps take one role
//    each. Warps 0-3 build P^T = exp(S^T - lse), hand it through shared
//    memory to the warp of the same keys among 4-7, and accumulate dV; warps
//    4-7 build dP^T, form dS^T from the P^T they receive, and accumulate dK.
//    Each takes two of the four products. K1 and K2 at D 256 would need 128
//    registers for o or dQ alone, so their eight warps are two column
//    groups: warps w and w + 4 own the same 16 rows, each takes the score
//    products (K2: S and dP) over its half of D and the output's columns of
//    that half, and the two add each other's partial scores, exchanged
//    through shared memory, in the same order, so both hold the same scores
//    (and in K2 the same dS). No product is computed twice and no tile is
//    loaded twice. One named barrier per pair of warps.
// 5. fp32 sums. The tensor cores truncate the sums they accumulate, which
//    along 2048 keys or queries drifts past the fp32 bound: a streamed
//    tile's products are summed from zero and added to dQ, dK and dV in
//    fp32, and to o with its rescaling in one fused multiply-add
//    (tf32_split.cuh). In K1 that costs nothing: the tile's sums are one
//    register per accumulator register, and the FMA replaces the rescale.
//    K2 sums two of its 16-key tiles the same way, one register per
//    accumulator register, before each addition: adding every tile ran
//    slower on an H100 (kernel_ab.py --variant k2_tile_sums). K3 sums a
//    tile per 8 columns of output, in four registers.
//
// Operands are split at each fragment load (two integer operations and one
// fp32 subtraction per value) rather than kept split in shared memory: that
// would double the tiles' bytes and the shared-memory reads, which by count
// already take two thirds of the time of the products they feed (a B
// fragment is 256 bytes, two cycles of the SM's shared-memory bandwidth, for
// three tensor-core cycles). On an H100, K1 with K and V split once per
// tile into shared memory (16-key tiles, so that two CTAs still fit an SM)
// ran 1.23-1.39x slower (kernel_ab.py --variant presplit_kv). The softmax,
// its exp2, lse, delta and every accumulation stay plain fp32, as in the
// Pallas kernel. No atomics: each output row is written once, so results
// are deterministic.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "flash_common.cuh"
#include "tf32_split.cuh"

namespace {

template <int D>
struct F32Tiles {
  static constexpr int LD = D + 4;  // floats per shared row (bank-conflict free)
  static constexpr size_t kTile = sizeof(float) * kBlock * LD;  // a [64, D] tile
  // K1 and K2: a warp owns 16 of the CTA's 64 Q rows; at D 256 two warps
  // share them, one for each half of D (column groups).
  static constexpr int kSplit = D > 128 ? 2 : 1;
  static constexpr int kFwdThreads = 128 * kSplit;
  static constexpr int DW = D / kSplit;  // a warp's columns: of the scores' sums, of o or dQ
  static constexpr int kKeys = 32;       // keys of a streamed K/V tile
  // Each warp's partial scores for its partner (column groups only).
  static constexpr size_t kXchFwd =
      kSplit > 1 ? sizeof(float) * 4 * kSplit * kKeys / 2 * 32 : 0;
  // K1: Q; K and V in two stages; the exchange.
  static constexpr size_t kSmemFwd = kTile + 4 * sizeof(float) * kKeys * LD + kXchFwd;
  // K2: Q and dO stay in shared memory while 16-key K/V tiles stream past
  // (two CTAs an SM at D 128).
  static constexpr int kDqKeys = 16;  // keys of a streamed K/V tile
  // Each warp's partial S and dP for its partner (column groups only).
  static constexpr size_t kXchDq =
      kSplit > 1 ? sizeof(float) * 4 * kSplit * 2 * (kDqKeys / 8) * 4 * 32 : 0;
  // K2: Q, dO; K and V in two stages; the exchange.
  static constexpr size_t kSmemDq = 2 * kTile + 4 * sizeof(float) * kDqKeys * LD + kXchDq;
  // K3: a warp owns 16 of the CTA's 64 keys and one of two roles (warps
  // 0-3: P^T and dV; warps 4-7: dS^T and dK).
  static constexpr int kBwdThreads = 256;
  static constexpr int kQueries = 16;  // queries of a streamed Q/dO tile
  // Each P^T warp's [16 x kQueries] P^T for its dS^T partner.
  static constexpr size_t kXchBwd = sizeof(float) * 4 * 16 * kQueries;
  // K3: K, V; Q and dO in two stages; lse and delta in two stages; the exchange.
  static constexpr size_t kSmemBwd =
      2 * kTile + 4 * sizeof(float) * kQueries * LD + 4 * sizeof(float) * kQueries + kXchBwd;
};

// Stage kRows rows of D floats from global memory into shared rows of LD
// floats, 16 bytes a copy.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int tid) {
  constexpr int kPerRow = D / 4, kCopies = kRows * kPerRow;
#pragma unroll
  for (int it = 0; it < (kCopies + kThreads - 1) / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    if (kCopies % kThreads != 0 && idx >= kCopies) break;
    const int r = idx / kPerRow, c = (idx % kPerRow) * 4;
    cp_async16(dst + r * F32Tiles<D>::LD + c, src + static_cast<size_t>(r) * D + c);
  }
}

// Named barriers of warps w and w ^ 4, one per pair (ids 1-4; 0 is
// __syncthreads): pair_arrive lets the pair's other warp through without
// waiting, pair_sync waits for both.
__device__ __forceinline__ void pair_arrive(int warp) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(1 + warp % 4) : "memory");
}
__device__ __forceinline__ void pair_sync(int warp) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + warp % 4) : "memory");
}

// Warps w and w ^ 4 (one pair of K1's column groups at D 256) add each
// other's partial accumulators: x is this warp's [N][4] partial, xch the CTA's
// exchange area of N * 4 * 32 floats a warp, written and read lane-major.
// Both warps add in the same order (own + partner's, and fp32 addition
// commutes), so both end with the same values.
template <int N>
__device__ __forceinline__ void add_partner(float (&x)[N][4], float* xch, int warp, int lane) {
  float* mine = xch + warp * N * 4 * 32;
  const float* theirs = xch + (warp ^ 4) * N * 4 * 32;
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32 + lane] = x[n][e];
  pair_sync(warp);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] += theirs[(n * 4 + e) * 32 + lane];
}

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------

template <int D, bool kCausal>
__global__ void __launch_bounds__(F32Tiles<D>::kFwdThreads)
flash_fwd_f32_tc(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int S, int window, float scale) {
  using T = F32Tiles<D>;
  constexpr int LD = T::LD, NK = T::kKeys / 8, NO = T::DW / 8;
  constexpr int kSub = kBlock / T::kKeys;  // streamed tiles per 64-key block
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBlock * LD;        // stages 0, 1
  float* Vs = Ks + 2 * T::kKeys * LD;  // stages 0, 1
  float* xch = Vs + 2 * T::kKeys * LD;

  const int n_blk = S / kBlock;
  int i, lo, hi;
  q_major_range<kCausal>(n_blk, window, i, lo, hi);
  const int u_lo = lo * kSub, u_hi = hi * kSub + kSub - 1;  // streamed tiles
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int c0 = (warp / 4) * T::DW;                       // this warp's columns
  const int qpos = i * kBlock + (warp % 4) * 16 + g;       // rows qpos, qpos + 8
  const float scale2 = scale * kLog2e;                     // base-2 logits
  const float* Qw = Qs + (warp % 4) * 16 * LD + c0;

  auto load_kv = [&](int u, int st) {
    const size_t off = base + static_cast<size_t>(u) * T::kKeys * D;
    load_rows<D, T::kKeys, T::kFwdThreads>(Ks + st * T::kKeys * LD, k + off, tid);
    load_rows<D, T::kKeys, T::kFwdThreads>(Vs + st * T::kKeys * LD, v + off, tid);
  };
  load_rows<D, kBlock, T::kFwdThreads>(Qs, q + base + static_cast<size_t>(i) * kBlock * D, tid);
  load_kv(u_lo, 0);
  cp_async_commit();

  float acc[NO][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // l: this lane's share
  for (int u = u_lo; u <= u_hi; ++u) {
    const int st = (u - u_lo) & 1;
    if (u < u_hi) {  // prefetch the next K/V tiles into the other stage
      load_kv(u + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + st * T::kKeys * LD + c0;
    const float* Vt = Vs + st * T::kKeys * LD + c0;

    // S = Q K^T over this warp's columns.
    float s[NK][4] = {};
#pragma unroll
    for (int kk = 0; kk < T::DW / 8; ++kk) {
      SplitA a;
      load_a(a, Qw + kk * 8, LD, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        SplitB b;
        load_b_rows(b, Kt + n * 8 * LD + kk * 8, LD, g, t);
        mma_split(s[n], a, b);
      }
    }
    if constexpr (T::kSplit > 1) add_partner<NK>(s, xch, warp, lane);

    const bool masked = kCausal && needs_mask(i, u / kSub, window);
    const int key0 = u * T::kKeys;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale2;
        if (masked && !visible(qpos + 8 * (e >> 1), key0 + n * 8 + 2 * t + (e & 1), window))
          x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the four lanes of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(fmaxf(m[r], mx[r]), kM2Floor);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);  // masked entries underflow to 0
        s[n][e] = p;
        l[e >> 1] += p;
      }

    // O = O * corr + P V over this warp's columns, keys of each 8 in
    // acc_to_a's order: the tile's 32 keys summed on the tensor cores from
    // zero, then added to the rescaled O in fp32 (tf32_split.cuh).
    float pv[NO][4] = {};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      SplitA a;
      acc_to_a(a, s[kk]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        SplitB b;
        load_b_permuted(b, Vt + kk * 8 * LD + n * 8, LD, g, t);
        mma_split(pv[n], a, b);
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], corr[e >> 1], pv[n][e]);
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  float* orow = o + base + static_cast<size_t>(qpos) * D + c0 + 2 * t;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<float2*>(orow + n * 8) = make_float2(acc[n][0] / l[0], acc[n][1] / l[0]);
    *reinterpret_cast<float2*>(orow + 8 * D + n * 8) =
        make_float2(acc[n][2] / l[1], acc[n][3] / l[1]);
  }
  if (c0 == 0 && t == 0) {
    float* row = lse + static_cast<size_t>(blockIdx.x) * S + qpos;
    row[0] = m[0] * kLn2 + logf(l[0]);
    row[8] = m[1] * kLn2 + logf(l[1]);
  }
}

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------

template <int D, bool kCausal>
__global__ void __launch_bounds__(F32Tiles<D>::kFwdThreads)
flash_bwd_dq_f32_tc(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int S, int window, float scale) {
  using T = F32Tiles<D>;
  constexpr int LD = T::LD, NK = T::kDqKeys / 8, NO = T::DW / 8;
  constexpr int kSub = kBlock / T::kDqKeys;  // streamed tiles per 64-key block
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kBlock * LD;
  float* Ks = dOs + kBlock * LD;          // stages 0, 1
  float* Vs = Ks + 2 * T::kDqKeys * LD;   // stages 0, 1
  float* xch = Vs + 2 * T::kDqKeys * LD;

  const int n_blk = S / kBlock;
  int i, lo, hi;
  q_major_range<kCausal>(n_blk, window, i, lo, hi);
  const int u_lo = lo * kSub, u_hi = hi * kSub + kSub - 1;  // streamed tiles
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int c0 = (warp / 4) * T::DW;                  // this warp's columns
  const int qpos = i * kBlock + (warp % 4) * 16 + g;  // rows qpos, qpos + 8
  const float scale2 = scale * kLog2e;
  const float* Qw = Qs + (warp % 4) * 16 * LD + c0;
  const float* dOw = dOs + (warp % 4) * 16 * LD + c0;
  // The rows' statistics: lse in base 2, and delta.
  const size_t rb = static_cast<size_t>(blockIdx.x) * S + qpos;
  const float lse2[2] = {lse[rb] * kLog2e, lse[rb + 8] * kLog2e};
  const float dl[2] = {delta[rb], delta[rb + 8]};

  auto load_kv = [&](int u, int st) {
    const size_t off = base + static_cast<size_t>(u) * T::kDqKeys * D;
    load_rows<D, T::kDqKeys, T::kFwdThreads>(Ks + st * T::kDqKeys * LD, k + off, tid);
    load_rows<D, T::kDqKeys, T::kFwdThreads>(Vs + st * T::kDqKeys * LD, v + off, tid);
  };
  const size_t qo = base + static_cast<size_t>(i) * kBlock * D;
  load_rows<D, kBlock, T::kFwdThreads>(Qs, q + qo, tid);
  load_rows<D, kBlock, T::kFwdThreads>(dOs, dout + qo, tid);
  load_kv(u_lo, 0);
  cp_async_commit();

  float dq_acc[NO][4] = {};
  float dq_sum[NO][4] = {};  // this pair of streamed tiles' dS K
  for (int u = u_lo; u <= u_hi; ++u) {
    const int st = (u - u_lo) & 1;
    if (u < u_hi) {  // prefetch the next K/V tiles into the other stage
      load_kv(u + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ktile = Ks + st * T::kDqKeys * LD + c0;
    const float* Vtile = Vs + st * T::kDqKeys * LD + c0;

    // S = Q K^T (x[0, NK)) and dP = dO V^T (x[NK, 2 NK)) over this warp's
    // columns.
    float x[2 * NK][4] = {};
#pragma unroll
    for (int kk = 0; kk < T::DW / 8; ++kk) {
      SplitA a;
      load_a(a, Qw + kk * 8, LD, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        SplitB b;
        load_b_rows(b, Ktile + n * 8 * LD + kk * 8, LD, g, t);
        mma_split(x[n], a, b);
      }
      load_a(a, dOw + kk * 8, LD, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        SplitB b;
        load_b_rows(b, Vtile + n * 8 * LD + kk * 8, LD, g, t);
        mma_split(x[NK + n], a, b);
      }
    }
    if constexpr (T::kSplit > 1) add_partner<2 * NK>(x, xch, warp, lane);

    // dS = P (dP - delta) * scale, P = exp(S * scale - lse), 0 where masked.
    const bool masked = kCausal && needs_mask(i, u / kSub, window);
    const int key0 = u * T::kDqKeys;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(fmaf(x[n][e], scale2, -lse2[r]));
        if (masked && !visible(qpos + 8 * r, key0 + n * 8 + 2 * t + (e & 1), window)) p = 0.0f;
        x[n][e] = p * (x[NK + n][e] - dl[r]) * scale;
      }

    // dQ += dS K over this warp's columns, keys of each 8 in acc_to_a's
    // order: two streamed tiles' keys (32, as K1's tiles) summed on the
    // tensor cores from zero, then added in fp32 (tf32_split.cuh).
    SplitA dsa[NK];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) acc_to_a(dsa[kk], x[kk]);
    const bool add = ((u - u_lo) & 1) || u == u_hi;  // the pair's second tile, or the last
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        SplitB b;
        load_b_permuted(b, Ktile + kk * 8 * LD + n * 8, LD, g, t);
        mma_split(dq_sum[n], dsa[kk], b);
      }
      if (add) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dq_acc[n][e] += dq_sum[n][e];
          dq_sum[n][e] = 0.0f;
        }
      }
    }
    __syncthreads();  // every warp is done with this stage (and the exchange) before reuse
  }

  float* row = dq + base + static_cast<size_t>(qpos) * D + c0 + 2 * t;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<float2*>(row + n * 8) = make_float2(dq_acc[n][0], dq_acc[n][1]);
    *reinterpret_cast<float2*>(row + 8 * D + n * 8) = make_float2(dq_acc[n][2], dq_acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV
// ---------------------------------------------------------------------------

template <int D, bool kCausal>
__global__ void __launch_bounds__(F32Tiles<D>::kBwdThreads)
flash_bwd_dkv_f32_tc(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int S, int window,
                     float scale) {
  using T = F32Tiles<D>;
  constexpr int LD = T::LD, NQ = T::kQueries / 8, NO = D / 8;
  constexpr int kSub = kBlock / T::kQueries;  // streamed tiles per 64-query block
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kBlock * LD;
  float* Qs = Vs + kBlock * LD;               // stages 0, 1
  float* dOs = Qs + 2 * T::kQueries * LD;     // stages 0, 1
  float* lse_s = dOs + 2 * T::kQueries * LD;  // [2][kQueries]
  float* delta_s = lse_s + 2 * T::kQueries;   // [2][kQueries]
  float* xch = delta_s + 2 * T::kQueries;     // [4][NQ * 4][32]: each pair's P^T

  const int n_blk = S / kBlock;
  const int j = blockIdx.y;  // low K blocks see the most Q blocks: launched first
  int lo, hi;
  k_major_range<kCausal>(j, n_blk, window, lo, hi);
  const int u_lo = lo * kSub, u_hi = hi * kSub + kSub - 1;  // streamed tiles
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const bool dv_role = warp < 4;                     // P^T and dV, else dS^T and dK
  const int kpos = j * kBlock + (warp % 4) * 16 + g;  // rows kpos, kpos + 8
  const float scale2 = scale * kLog2e;
  // S^T = K Q^T (P^T warps) or dP^T = V dO^T (dS^T warps): A is this warp's
  // 16 rows of K or V.
  const float* Aw = (dv_role ? Ks : Vs) + (warp % 4) * 16 * LD;
  float* xw = xch + (warp % 4) * NQ * 4 * 32;

  // Q, dO, lse and delta of streamed tile u into stage st.
  auto load_q_side = [&](int u, int st) {
    const size_t off = base + static_cast<size_t>(u) * T::kQueries * D;
    load_rows<D, T::kQueries, T::kBwdThreads>(Qs + st * T::kQueries * LD, q + off, tid);
    load_rows<D, T::kQueries, T::kBwdThreads>(dOs + st * T::kQueries * LD, dout + off, tid);
    const size_t rb = static_cast<size_t>(blockIdx.x) * S + u * T::kQueries;
    if (tid < T::kQueries / 4)
      cp_async16(lse_s + st * T::kQueries + tid * 4, lse + rb + tid * 4);
    else if (tid < T::kQueries / 2)
      cp_async16(delta_s + st * T::kQueries + (tid - T::kQueries / 4) * 4,
                 delta + rb + (tid - T::kQueries / 4) * 4);
  };
  const size_t ko = base + static_cast<size_t>(j) * kBlock * D;
  load_rows<D, kBlock, T::kBwdThreads>(Ks, k + ko, tid);
  load_rows<D, kBlock, T::kBwdThreads>(Vs, v + ko, tid);
  load_q_side(u_lo, 0);
  cp_async_commit();

  float acc[NO][4] = {};  // dV or dK
  for (int u = u_lo; u <= u_hi; ++u) {
    const int st = (u - u_lo) & 1;
    if (u < u_hi) {
      load_q_side(u + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs + st * T::kQueries * LD;
    const float* dOt = dOs + st * T::kQueries * LD;

    // Transposed scores, rows = this warp's keys, columns = the tile's
    // queries: S^T or dP^T.
    const float* Bt = dv_role ? Qt : dOt;
    float x[NQ][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      SplitA a;
      load_a(a, Aw + kk * 8, LD, g, t);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        SplitB b;
        load_b_rows(b, Bt + n * 8 * LD + kk * 8, LD, g, t);
        mma_split(x[n], a, b);
      }
    }

    const int q0 = u * T::kQueries;
    if (dv_role) {  // P^T, handed to the dS^T warp of the same rows
      const float* ls = lse_s + st * T::kQueries;
      const bool masked = kCausal && needs_mask(u / kSub, j, window);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n * 8 + 2 * t + (e & 1);  // row statistics belong to the query
          float p = exp2f(fmaf(x[n][e], scale2, -ls[qi] * kLog2e));
          if (masked && !visible(q0 + qi, kpos + 8 * (e >> 1), window)) p = 0.0f;
          x[n][e] = p;
          xw[(n * 4 + e) * 32 + lane] = p;
        }
      pair_arrive(warp);
    } else {  // dS^T = P^T (dP^T - delta) * scale
      const float* dls = delta_s + st * T::kQueries;
      pair_sync(warp);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[n][e] = xw[(n * 4 + e) * 32 + lane] * (x[n][e] - dls[n * 8 + 2 * t + (e & 1)]) * scale;
    }

    // dV += P^T dO or dK += dS^T Q, queries of each 8 in acc_to_a's order:
    // the tile's 16 queries summed on the tensor cores from zero, then added
    // in fp32 (tf32_split.cuh).
    const float* Ct = dv_role ? dOt : Qt;
    SplitA xa[NQ];
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
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  float* out = (dv_role ? dv : dk) + base + static_cast<size_t>(kpos) * D + 2 * t;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<float2*>(out + n * 8) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + 8 * D + n * 8) = make_float2(acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// Host launchers
// ---------------------------------------------------------------------------

// Grid (BH, S / 64): blockIdx.x walks the heads fastest, so the longest
// blocks of every head start before any shorter one.
template <typename K, typename... Args>
int launch(K kernel, size_t smem, int threads, int bh, int s, cudaStream_t st, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(bh, s / kBlock), threads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <int D, bool C>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s,
        int window, cudaStream_t st) {
  using T = F32Tiles<D>;
  return launch(flash_fwd_f32_tc<D, C>, T::kSmemFwd, T::kFwdThreads, bh, s, st, q, k, v, o, lse,
                s, window, softmax_scale(D));
}

template <int D, bool C>
int bwd_dq(const float* q, const float* k, const float* v, const float* dout, const float* lse,
           const float* delta, float* dq, int bh, int s, int window, cudaStream_t st) {
  using T = F32Tiles<D>;
  return launch(flash_bwd_dq_f32_tc<D, C>, T::kSmemDq, T::kFwdThreads, bh, s, st, q, k, v, dout,
                lse, delta, dq, s, window, softmax_scale(D));
}

template <int D, bool C>
int bwd_dkv(const float* q, const float* k, const float* v, const float* dout, const float* lse,
            const float* delta, float* dk, float* dv, int bh, int s, int window,
            cudaStream_t st) {
  using T = F32Tiles<D>;
  return launch(flash_bwd_dkv_f32_tc<D, C>, T::kSmemBwd, T::kBwdThreads, bh, s, st, q, k, v,
                dout, lse, delta, dk, dv, s, window, softmax_scale(D));
}

template <int D, typename F>
int with_causal(bool causal, F&& f) {
  return causal ? f(std::integral_constant<int, D>{}, std::true_type{})
                : f(std::integral_constant<int, D>{}, std::false_type{});
}

// Calls f(D, causal) as integral constants for a built head dim; refuses any
// other.
template <typename F>
int dispatch(int d, bool causal, F&& f) {
  switch (d) {
    case 16: return with_causal<16>(causal, f);
    case 32: return with_causal<32>(causal, f);
    case 64: return with_causal<64>(causal, f);
    case 128: return with_causal<128>(causal, f);
    case 256: return with_causal<256>(causal, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of its launch (0 = success). The shape
// checks are the caller's (flash_attention.cu's C entries).
int tpe_flash_fwd_f32_tc(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                         int s, int d, int window, int causal, void* stream) {
  return dispatch(d, causal != 0, [&](auto dc, auto cc) {
    return fwd<decltype(dc)::value, decltype(cc)::value>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), static_cast<float*>(lse), bh, s, window,
        static_cast<cudaStream_t>(stream));
  });
}

int tpe_flash_bwd_dq_f32_tc(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int s, int d,
                            int window, int causal, void* stream) {
  return dispatch(d, causal != 0, [&](auto dc, auto cc) {
    return bwd_dq<decltype(dc)::value, decltype(cc)::value>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dq), bh, s, window,
        static_cast<cudaStream_t>(stream));
  });
}

int tpe_flash_bwd_dkv_f32_tc(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int bh,
                             int s, int d, int window, int causal, void* stream) {
  return dispatch(d, causal != 0, [&](auto dc, auto cc) {
    return bwd_dkv<decltype(dc)::value, decltype(cc)::value>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), bh,
        s, window, static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
