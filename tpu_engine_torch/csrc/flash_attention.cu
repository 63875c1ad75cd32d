// Causal (optionally sliding-window) flash attention for Hopper (sm_90a):
// one forward kernel and two backward kernels, with a plain C interface
// loaded from Python through ctypes (tpu_engine_torch/ops/_flash_cuda.py).
//
// Layout: q, k, v, o, dO, dq, dk, dv are [BH, S, D] contiguous, bf16 or
// fp32; lse and delta are [BH, S] fp32. S is a multiple of 64; D is a
// template parameter, instantiated for 64 and 128. scale = 1/sqrt(D).
//
// What each kernel replaces, what bounds it on the H100, and what the design
// does about that:
//
// K1 flash_fwd replaces _fwd_kernel (tpu_engine/ops/_flash_pallas.py,
//   launched by _flash_fwd). It computes o = softmax(q k^T * scale) v and the
//   natural-log row lse. Bound: tensor-core operations. At the training shape
//   (BH 64, S 2048, D 128, causal) it does 2 causal S^2 D products, ~6.9e10
//   FLOP, ~69 us at 989 TFLOP/s, against ~40 us to move its ~134 MB.
// K2 flash_bwd_dq replaces _bwd_dq_kernel. It rebuilds P from (q, k, lse),
//   forms dS = P * (dO v^T - delta) * scale and accumulates dQ = dS k.
//   Bound: operations, 3 causal products, ~1.03e11 FLOP, ~104 us.
// K3 flash_bwd_dkv replaces _bwd_dkv_kernel. It accumulates dV = P^T dO and
//   dK = dS^T q. Bound: operations, 4 causal products, ~1.37e11 FLOP, ~139 us.
//
// Design, shared by the three. One 128-thread block (four warps) per
// (bh, 64-row tile): a Q tile for K1 and K2, a K tile for K3. A loop inside
// the block walks the tiles of the other side that the causal window lets it
// see -- the TPU's sequential inner grid axis -- and never visits a tile
// above the diagonal or outside the window; the visibility mask is evaluated
// only on the diagonal and window-edge tiles. Blocks with the longest loops
// are launched first. dQ and dK/dV are separate kernels with no atomics, so
// gradients are deterministic, as on the TPU.
//
// bf16 (the training path): each warp owns 16 rows of the block's tile and
// keeps its scores, probabilities and fp32 accumulators in registers. The
// products run on tensor cores through mma.sync m16n8k16 (bf16 in, fp32
// accumulate), with operands fed from shared memory by ldmatrix; an
// accumulator tile rounded to bf16 is already the A operand of the next
// product, so P and dS never touch shared memory. The tiles of the inner
// loop are double-buffered with cp.async, so the next tile loads while this
// one is multiplied. Tensor cores at this rate are limited by the shared-
// memory reads that feed mma.sync (about one ldmatrix per two mma); wgmma,
// TMA and warp specialisation, which remove that limit, are left for later.
//
// fp32 keeps the same tiling with plain fp32 FMA loops over tiles staged in
// shared memory (never TF32), so that the fp32 bounds hold; that path is for
// checking, not speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlock = 64;      // rows of a Q or K tile
constexpr int kThreads = 128;   // four warps, 16 tile rows each
constexpr float kNegInf = -1e30f;
constexpr float kM2Floor = -1e6f;  // running-max floor (base-2 units)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ bool visible(int qpos, int kpos, int window) {
  return qpos >= kpos && (window == 0 || qpos - kpos < window);
}

// Does the (Q tile i, K tile j) pair need the visibility mask? Only the
// diagonal tile and, with a window, the tiles straddling its lower edge.
__device__ __forceinline__ bool needs_mask(int i, int j, int window) {
  return i == j || (window != 0 && (i - j + 1) * kBlock - 1 >= window);
}

// The first K tile that Q tile i sees, and the last Q tile that sees K tile j
// (_n_kv_blocks / _k_index and _n_q_blocks / _q_index in the Pallas kernels).
__device__ __forceinline__ int first_k_tile(int i, int window) {
  if (window == 0) return 0;
  const int first = i * kBlock - (window - 1);
  return first > 0 ? first / kBlock : 0;
}
__device__ __forceinline__ int last_q_tile(int j, int n_blk, int window) {
  return window == 0 ? n_blk - 1 : min(n_blk - 1, j + (kBlock + window - 2) / kBlock);
}

// 1/sqrt(D), rounded once to fp32 as the JAX kernel's Python-side scale is.
float softmax_scale(int d) { return static_cast<float>(1.0 / std::sqrt(static_cast<double>(d))); }

// ===========================================================================
// bf16: tensor cores through mma.sync
// ===========================================================================
//
// Fragments of mma.m16n8k16 (PTX ISA), lane = 4 g + t: an fp32 accumulator
// tile c[4] of 16x8 holds (row g, cols 2t, 2t+1) in c[0..1] and (row g + 8,
// the same cols) in c[2..3]. The bf16 A operand of 16x16 holds the same
// positions of its left 8 columns in a[0..1] and of its right 8 in a[2..3],
// two values to a register; so two neighbouring accumulator tiles, rounded
// pairwise, are one A operand.

// Shared-memory tiles are [64][D + 8] bf16: the 16-byte skew per row puts the
// eight rows an ldmatrix reads on eight different bank groups.
template <int D>
struct Tile {
  static constexpr int LD = D + 8;
  static constexpr int SIZE = kBlock * LD;  // elements
  static constexpr size_t BYTES = sizeof(bf16) * SIZE;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] * b[16x8], bf16 operands, fp32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage a [64, D] tile from global memory into a skewed shared tile, 16 bytes
// a thread, neighbouring threads on neighbouring addresses.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int tid) {
  constexpr int kPerRow = D / 8;
#pragma unroll
  for (int it = 0; it < kBlock * kPerRow / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / kPerRow, c = (idx % kPerRow) * 8;
    cp_async16(dst + r * Tile<D>::LD + c, src + static_cast<size_t>(r) * D + c);
  }
}

// acc[16 x 8NT] = A[16 x K] * B^T, A and B row-major in shared memory with
// leading dimension ld, B holding 8NT rows of K.
template <int K, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* A, const bf16* B,
                                        int ld, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, A + (lane % 16) * ld + kk + (lane / 16) * 8);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];  // n-tiles n and n + 1 at depth kk
      ldsm_x4(b, B + (n * 8 + lane % 8 + (lane / 16) * 8) * ld + kk + ((lane / 8) % 2) * 8);
      mma(acc[n], a, b[0], b[1]);
      mma(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x 8NT] += A[16 x 16KT] * B, A as register fragments, B [16KT x 8NT]
// row-major in shared memory (read transposed by ldmatrix).
template <int KT, int NT>
__device__ __forceinline__ void mma_ab(float (&acc)[NT][4], const uint32_t (&a)[KT][4],
                                       const bf16* B, int ld, int lane) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, B + (kt * 16 + lane % 8 + ((lane / 8) % 2) * 8) * ld + n * 8 + (lane / 16) * 8);
      mma(acc[n], a[kt], b[0], b[1]);
      mma(acc[n + 1], a[kt], b[2], b[3]);
    }
}

// Accumulator tiles [16 x 8NT] -> bf16 A fragments [16 x 16(NT/2)].
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[NT / 2][4], const float (&c)[NT][4]) {
#pragma unroll
  for (int kt = 0; kt < NT / 2; ++kt) {
    a[kt][0] = pack_bf16(c[2 * kt][0], c[2 * kt][1]);
    a[kt][1] = pack_bf16(c[2 * kt][2], c[2 * kt][3]);
    a[kt][2] = pack_bf16(c[2 * kt + 1][0], c[2 * kt + 1][1]);
    a[kt][3] = pack_bf16(c[2 * kt + 1][2], c[2 * kt + 1][3]);
  }
}

// Write a warp's accumulator [16 x D] as bf16: dst points at the lane's row g;
// rows g and g + 8 are scaled by s0 and s1.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], float s0,
                                           float s1, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(dst + n * 8 + 2 * t) = pack_bf16(acc[n][0] * s0, acc[n][1] * s0);
    *reinterpret_cast<uint32_t*>(dst + 8 * D + n * 8 + 2 * t) =
        pack_bf16(acc[n][2] * s1, acc[n][3] * s1);
  }
}

template <int D>
struct SmemBf16 {
  static constexpr size_t fwd = 5 * Tile<D>::BYTES;       // Q; K, V x 2 stages
  static constexpr size_t bwd_dq = 6 * Tile<D>::BYTES;    // Q, dO; K, V x 2 stages
  static constexpr size_t bwd_dkv = 6 * Tile<D>::BYTES    // K, V; Q, dO x 2 stages
                                    + 2 * 2 * kBlock * sizeof(float);  // lse, delta x 2
};

// ---------------------------------------------------------------------------
// K1 (bf16): forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
               int S, int window, float scale) {
  using L = Tile<D>;
  constexpr int NT = kBlock / 8, DT = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + L::SIZE;      // stages 0, 1
  bf16* Vs = Ks + 2 * L::SIZE;  // stages 0, 1

  const int n_blk = S / kBlock;
  const int i = n_blk - 1 - blockIdx.y;  // longest loops first
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane & 3;
  const int qpos = i * kBlock + warp * 16 + (lane >> 2);  // rows qpos, qpos + 8
  const int lo = first_k_tile(i, window);
  const float scale2 = scale * kLog2e;  // base-2 logits

  load_tile_async<D>(Qs, q + base + static_cast<size_t>(i) * kBlock * D, tid);
  load_tile_async<D>(Ks, k + base + static_cast<size_t>(lo) * kBlock * D, tid);
  load_tile_async<D>(Vs, v + base + static_cast<size_t>(lo) * kBlock * D, tid);
  cp_async_commit();

  float acc[DT][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // l: this lane's share
  for (int j = lo; j <= i; ++j) {
    const int st = (j - lo) & 1;
    if (j < i) {  // prefetch the next K/V tiles into the other stage
      const size_t nxt = base + static_cast<size_t>(j + 1) * kBlock * D;
      load_tile_async<D>(Ks + (st ^ 1) * L::SIZE, k + nxt, tid);
      load_tile_async<D>(Vs + (st ^ 1) * L::SIZE, v + nxt, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[NT][4];
    mma_abt<D, NT>(s, Qs + warp * 16 * L::LD, Ks + st * L::SIZE, L::LD, lane);
    const bool masked = needs_mask(i, j, window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale2;
        if (masked && !visible(qpos + 8 * (e >> 1), j * kBlock + n * 8 + 2 * t + (e & 1), window))
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
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);  // masked entries underflow to 0
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    uint32_t pa[NT / 2][4];  // P rounds to bf16 for the P V product
    to_a<NT>(pa, s);
    mma_ab<NT / 2, DT>(acc, pa, Vs + st * L::SIZE, L::LD, lane);
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  store_rows<D>(o + base + static_cast<size_t>(qpos) * D, acc, 1.0f / l[0], 1.0f / l[1], lane);
  if (t == 0) {
    float* row = lse + static_cast<size_t>(blockIdx.x) * S + qpos;
    row[0] = m[0] * kLn2 + logf(l[0]);
    row[8] = m[1] * kLn2 + logf(l[1]);
  }
}

// ---------------------------------------------------------------------------
// K2 (bf16): dQ
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, int S, int window, float scale) {
  using L = Tile<D>;
  constexpr int NT = kBlock / 8, DT = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + L::SIZE;
  bf16* Ks = dOs + L::SIZE;     // stages 0, 1
  bf16* Vs = Ks + 2 * L::SIZE;  // stages 0, 1

  const int n_blk = S / kBlock;
  const int i = n_blk - 1 - blockIdx.y;
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane & 3;
  const int qpos = i * kBlock + warp * 16 + (lane >> 2);
  const int lo = first_k_tile(i, window);
  const float scale2 = scale * kLog2e;

  load_tile_async<D>(Qs, q + base + static_cast<size_t>(i) * kBlock * D, tid);
  load_tile_async<D>(dOs, dout + base + static_cast<size_t>(i) * kBlock * D, tid);
  load_tile_async<D>(Ks, k + base + static_cast<size_t>(lo) * kBlock * D, tid);
  load_tile_async<D>(Vs, v + base + static_cast<size_t>(lo) * kBlock * D, tid);
  cp_async_commit();

  const size_t rb = static_cast<size_t>(blockIdx.x) * S + qpos;
  const float lse2[2] = {lse[rb] * kLog2e, lse[rb + 8] * kLog2e};
  const float dl[2] = {delta[rb], delta[rb + 8]};

  float acc[DT][4] = {};
  for (int j = lo; j <= i; ++j) {
    const int st = (j - lo) & 1;
    if (j < i) {
      const size_t nxt = base + static_cast<size_t>(j + 1) * kBlock * D;
      load_tile_async<D>(Ks + (st ^ 1) * L::SIZE, k + nxt, tid);
      load_tile_async<D>(Vs + (st ^ 1) * L::SIZE, v + nxt, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * L::SIZE;

    float s[NT][4], dp[NT][4];
    mma_abt<D, NT>(s, Qs + warp * 16 * L::LD, Kt, L::LD, lane);
    mma_abt<D, NT>(dp, dOs + warp * 16 * L::LD, Vs + st * L::SIZE, L::LD, lane);
    const bool masked = needs_mask(i, j, window);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(fmaf(s[n][e], scale2, -lse2[r]));
        if (masked && !visible(qpos + 8 * r, j * kBlock + n * 8 + 2 * t + (e & 1), window))
          p = 0.0f;
        s[n][e] = p * (dp[n][e] - dl[r]) * scale;  // dS
      }
    uint32_t da[NT / 2][4];
    to_a<NT>(da, s);
    mma_ab<NT / 2, DT>(acc, da, Kt, L::LD, lane);
    __syncthreads();
  }
  store_rows<D>(dq + base + static_cast<size_t>(qpos) * D, acc, 1.0f, 1.0f, lane);
}

// ---------------------------------------------------------------------------
// K3 (bf16): dK and dV
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int window,
                   float scale) {
  using L = Tile<D>;
  constexpr int NH = 4;  // n-tiles of a half Q tile: 32 queries at a time
  constexpr int DT = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + L::SIZE;
  bf16* Qs = Vs + L::SIZE;        // stages 0, 1
  bf16* dOs = Qs + 2 * L::SIZE;   // stages 0, 1
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * L::SIZE);  // [2][64]
  float* delta_s = lse_s + 2 * kBlock;                          // [2][64]

  const int n_blk = S / kBlock;
  const int j = blockIdx.y;  // low K tiles see the most Q tiles: launched first
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane & 3;
  const int kpos = j * kBlock + warp * 16 + (lane >> 2);  // rows kpos, kpos + 8
  const int hi = last_q_tile(j, n_blk, window);
  const float scale2 = scale * kLog2e;

  // Q, dO, lse and delta of Q tile i into stage st.
  auto load_q_side = [&](int i, int st) {
    const size_t off = base + static_cast<size_t>(i) * kBlock * D;
    load_tile_async<D>(Qs + st * L::SIZE, q + off, tid);
    load_tile_async<D>(dOs + st * L::SIZE, dout + off, tid);
    const size_t rb = static_cast<size_t>(blockIdx.x) * S + i * kBlock;
    if (tid < 16)
      cp_async16(lse_s + st * kBlock + tid * 4, lse + rb + tid * 4);
    else if (tid < 32)
      cp_async16(delta_s + st * kBlock + (tid - 16) * 4, delta + rb + (tid - 16) * 4);
  };

  load_tile_async<D>(Ks, k + base + static_cast<size_t>(j) * kBlock * D, tid);
  load_tile_async<D>(Vs, v + base + static_cast<size_t>(j) * kBlock * D, tid);
  load_q_side(j, 0);
  cp_async_commit();

  float dk_acc[DT][4] = {}, dv_acc[DT][4] = {};
  for (int i = j; i <= hi; ++i) {
    const int st = (i - j) & 1;
    if (i < hi) {
      load_q_side(i + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + st * L::SIZE;
    const bf16* dOt = dOs + st * L::SIZE;
    const float* ls = lse_s + st * kBlock;
    const float* dls = delta_s + st * kBlock;
    const bool masked = needs_mask(i, j, window);

#pragma unroll 1
    for (int h = 0; h < 2; ++h) {  // not unrolled: keeps dK and dV in registers
      // Transposed tiles, rows = this warp's keys, cols = queries: S^T = K Q^T
      // and dP^T = V dO^T, so P^T and dS^T feed dV and dK untransposed.
      float s[NH][4], dp[NH][4];
      mma_abt<D, NH>(s, Ks + warp * 16 * L::LD, Qt + h * 32 * L::LD, L::LD, lane);
      mma_abt<D, NH>(dp, Vs + warp * 16 * L::LD, dOt + h * 32 * L::LD, L::LD, lane);
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = h * 32 + n * 8 + 2 * t + (e & 1);  // row statistics belong to the query
          float p = exp2f(fmaf(s[n][e], scale2, -ls[qi] * kLog2e));
          if (masked && !visible(i * kBlock + qi, kpos + 8 * (e >> 1), window)) p = 0.0f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dls[qi]) * scale;
        }
      uint32_t pa[NH / 2][4], da[NH / 2][4];
      to_a<NH>(pa, s);
      to_a<NH>(da, dp);
      mma_ab<NH / 2, DT>(dv_acc, pa, dOt + h * 32 * L::LD, L::LD, lane);
      mma_ab<NH / 2, DT>(dk_acc, da, Qt + h * 32 * L::LD, L::LD, lane);
    }
    __syncthreads();
  }
  const size_t out = base + static_cast<size_t>(kpos) * D;
  store_rows<D>(dk + out, dk_acc, 1.0f, 1.0f, lane);
  store_rows<D>(dv + out, dv_acc, 1.0f, 1.0f, lane);
}

// ===========================================================================
// fp32: plain FMA over tiles in shared memory
// ===========================================================================

template <int D>
struct SmemF32 {
  static constexpr size_t tile = 4 * kBlock * D;     // Q/K/V/dO tiles and [64, D] accumulators
  static constexpr size_t score = 4 * kBlock * kBlock;
  static constexpr size_t rows = 4 * kBlock;
  // K1: Q, K, V; S (P in place); O; m and l.
  static constexpr size_t fwd = 4 * tile + score + 2 * rows;
  // K2: Q, dO, K, V; S, dP (dS in place); dQ; lse and delta.
  static constexpr size_t bwd_dq = 5 * tile + 2 * score + 2 * rows;
  // K3: K, V, Q, dO; S^T (P^T in place), dP^T (dS^T in place); dK, dV; lse, delta.
  static constexpr size_t bwd_dkv = 6 * tile + 2 * score + 2 * rows;
};

struct Carver {
  unsigned char* p;
  __device__ float* take(size_t bytes) {
    float* r = reinterpret_cast<float*>(p);
    p += bytes;
    return r;
  }
};

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int tid) {
  for (int idx = tid; idx < kBlock * D / 4; idx += kThreads)
    reinterpret_cast<float4*>(dst)[idx] = reinterpret_cast<const float4*>(src)[idx];
}

// C[16, 64] = A[16, D] * B[64, D]^T for one warp. Each lane owns columns
// lane and lane + 32 of all 16 rows.
template <int D>
__device__ __forceinline__ void warp_abt_f32(const float* A, const float* B, float* C, int lane) {
  float acc[16][2] = {};
  for (int kk = 0; kk < D; ++kk) {
    const float b0 = B[lane * D + kk], b1 = B[(lane + 32) * D + kk];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float a = A[r * D + kk];
      acc[r][0] = fmaf(a, b0, acc[r][0]);
      acc[r][1] = fmaf(a, b1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    C[r * kBlock + lane] = acc[r][0];
    C[r * kBlock + lane + 32] = acc[r][1];
  }
}

// C[16, D] += A[16, 64] * B[64, D] for one warp. Each lane owns columns
// lane + 32 t of all 16 rows.
template <int D>
__device__ __forceinline__ void warp_ab_acc_f32(const float* A, const float* B, float* C,
                                                int lane) {
  constexpr int kT = D / 32;
  float acc[16][kT];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int c = 0; c < kT; ++c) acc[r][c] = C[r * D + lane + 32 * c];
  for (int kk = 0; kk < kBlock; ++kk) {
    float b[kT];
#pragma unroll
    for (int c = 0; c < kT; ++c) b[c] = B[kk * D + lane + 32 * c];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float a = A[r * kBlock + kk];
#pragma unroll
      for (int c = 0; c < kT; ++c) acc[r][c] = fmaf(a, b[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int c = 0; c < kT; ++c) C[r * D + lane + 32 * c] = acc[r][c];
}

// P and dS for one warp's 16 rows of a score tile, in place over S and dP.
// transposed = false (K2): rows are queries of tile i, columns keys of tile j.
// transposed = true  (K3): rows are keys of tile j, columns queries of tile i.
template <bool transposed>
__device__ __forceinline__ void p_ds_rows_f32(float* Sw, float* dPw, const float* lse_s,
                                              const float* delta_s, int i, int j, int warp,
                                              int lane, int window, float scale, bool masked) {
  const int r = lane >> 1, half = lane & 1;
  for (int c = half * 32; c < half * 32 + 32; ++c) {
    const int qi = transposed ? c : warp * 16 + r;  // row statistics belong to the query
    const int ki = transposed ? warp * 16 + r : c;
    float p = 0.0f;
    if (!masked || visible(i * kBlock + qi, j * kBlock + ki, window))
      p = expf(Sw[r * kBlock + c] * scale - lse_s[qi]);
    dPw[r * kBlock + c] = p * (dPw[r * kBlock + c] - delta_s[qi]) * scale;
    Sw[r * kBlock + c] = p;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int S, int window, float scale) {
  using L = SmemF32<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* Qs = cv.take(L::tile);
  float* Ks = cv.take(L::tile);
  float* Vs = cv.take(L::tile);
  float* Ss = cv.take(L::score);
  float* Os = cv.take(L::tile);
  float* ms = cv.take(L::rows);
  float* ls = cv.take(L::rows);

  const int n_blk = S / kBlock;
  const int i = n_blk - 1 - blockIdx.y;
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float scale2 = scale * kLog2e;

  load_tile_f32<D>(Qs, q + base + static_cast<size_t>(i) * kBlock * D, tid);
  for (int idx = tid; idx < kBlock * D; idx += kThreads) Os[idx] = 0.0f;
  if (tid < kBlock) {
    ms[tid] = kNegInf;
    ls[tid] = 0.0f;
  }
  // Lane pair (2r, 2r+1) owns row r of the warp's 16 rows, 32 columns each.
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r;
  const int qpos = i * kBlock + row;

  for (int j = first_k_tile(i, window); j <= i; ++j) {
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile_f32<D>(Ks, k + base + static_cast<size_t>(j) * kBlock * D, tid);
    load_tile_f32<D>(Vs, v + base + static_cast<size_t>(j) * kBlock * D, tid);
    __syncthreads();

    warp_abt_f32<D>(Qs + warp * 16 * D, Ks, Ss + warp * 16 * kBlock, lane);
    __syncwarp();
    const bool masked = needs_mask(i, j, window);
    float* srow = Ss + row * kBlock + half * 32;
    float mx = kNegInf;
    for (int c = 0; c < 32; ++c) {
      float x = srow[c] * scale2;
      if (masked && !visible(qpos, j * kBlock + half * 32 + c, window)) x = kNegInf;
      srow[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_old = ms[row];
    const float m_new = fmaxf(fmaxf(m_old, mx), kM2Floor);
    float sum = 0.0f;
    for (int c = 0; c < 32; ++c) {
      const float p = exp2f(srow[c] - m_new);
      sum += p;
      srow[c] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = exp2f(m_old - m_new);
    float* orow = Os + row * D + half * (D / 2);
    for (int c = 0; c < D / 2; ++c) orow[c] *= corr;
    __syncwarp();
    if (half == 0) {
      ms[row] = m_new;
      ls[row] = ls[row] * corr + sum;
    }
    __syncwarp();
    warp_ab_acc_f32<D>(Ss + warp * 16 * kBlock, Vs, Os + warp * 16 * D, lane);
    __syncwarp();
  }

  __syncthreads();
  float* og = o + base + static_cast<size_t>(i) * kBlock * D;
  for (int idx = tid; idx < kBlock * D; idx += kThreads)
    og[idx] = Os[idx] / fmaxf(ls[idx / D], 1e-30f);
  if (tid < kBlock)
    lse[static_cast<size_t>(blockIdx.x) * S + i * kBlock + tid] =
        ms[tid] * kLn2 + logf(fmaxf(ls[tid], 1e-30f));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int S, int window, float scale) {
  using L = SmemF32<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* Qs = cv.take(L::tile);
  float* dOs = cv.take(L::tile);
  float* Ks = cv.take(L::tile);
  float* Vs = cv.take(L::tile);
  float* Ss = cv.take(L::score);
  float* dPs = cv.take(L::score);
  float* dQs = cv.take(L::tile);
  float* lse_s = cv.take(L::rows);
  float* delta_s = cv.take(L::rows);

  const int n_blk = S / kBlock;
  const int i = n_blk - 1 - blockIdx.y;
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  const size_t rbase = static_cast<size_t>(blockIdx.x) * S + i * kBlock;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  load_tile_f32<D>(Qs, q + base + static_cast<size_t>(i) * kBlock * D, tid);
  load_tile_f32<D>(dOs, dout + base + static_cast<size_t>(i) * kBlock * D, tid);
  for (int idx = tid; idx < kBlock * D; idx += kThreads) dQs[idx] = 0.0f;
  if (tid < kBlock) {
    lse_s[tid] = lse[rbase + tid];
    delta_s[tid] = delta[rbase + tid];
  }
  float* Sw = Ss + warp * 16 * kBlock;
  float* dPw = dPs + warp * 16 * kBlock;

  for (int j = first_k_tile(i, window); j <= i; ++j) {
    __syncthreads();
    load_tile_f32<D>(Ks, k + base + static_cast<size_t>(j) * kBlock * D, tid);
    load_tile_f32<D>(Vs, v + base + static_cast<size_t>(j) * kBlock * D, tid);
    __syncthreads();

    warp_abt_f32<D>(Qs + warp * 16 * D, Ks, Sw, lane);
    warp_abt_f32<D>(dOs + warp * 16 * D, Vs, dPw, lane);
    __syncwarp();
    p_ds_rows_f32<false>(Sw, dPw, lse_s, delta_s, i, j, warp, lane, window, scale,
                         needs_mask(i, j, window));
    __syncwarp();
    warp_ab_acc_f32<D>(dPw, Ks, dQs + warp * 16 * D, lane);
    __syncwarp();
  }

  __syncthreads();
  float* g = dq + base + static_cast<size_t>(i) * kBlock * D;
  for (int idx = tid; idx < kBlock * D; idx += kThreads) g[idx] = dQs[idx];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int S, int window,
                  float scale) {
  using L = SmemF32<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* Ks = cv.take(L::tile);
  float* Vs = cv.take(L::tile);
  float* Qs = cv.take(L::tile);
  float* dOs = cv.take(L::tile);
  float* Ss = cv.take(L::score);
  float* dPs = cv.take(L::score);
  float* dKs = cv.take(L::tile);
  float* dVs = cv.take(L::tile);
  float* lse_s = cv.take(L::rows);
  float* delta_s = cv.take(L::rows);

  const int n_blk = S / kBlock;
  const int j = blockIdx.y;
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  load_tile_f32<D>(Ks, k + base + static_cast<size_t>(j) * kBlock * D, tid);
  load_tile_f32<D>(Vs, v + base + static_cast<size_t>(j) * kBlock * D, tid);
  for (int idx = tid; idx < kBlock * D; idx += kThreads) dKs[idx] = dVs[idx] = 0.0f;
  float* Sw = Ss + warp * 16 * kBlock;
  float* dPw = dPs + warp * 16 * kBlock;

  for (int i = j, hi = last_q_tile(j, n_blk, window); i <= hi; ++i) {
    __syncthreads();
    load_tile_f32<D>(Qs, q + base + static_cast<size_t>(i) * kBlock * D, tid);
    load_tile_f32<D>(dOs, dout + base + static_cast<size_t>(i) * kBlock * D, tid);
    if (tid < kBlock) {
      const size_t rb = static_cast<size_t>(blockIdx.x) * S + i * kBlock + tid;
      lse_s[tid] = lse[rb];
      delta_s[tid] = delta[rb];
    }
    __syncthreads();

    warp_abt_f32<D>(Ks + warp * 16 * D, Qs, Sw, lane);
    warp_abt_f32<D>(Vs + warp * 16 * D, dOs, dPw, lane);
    __syncwarp();
    p_ds_rows_f32<true>(Sw, dPw, lse_s, delta_s, i, j, warp, lane, window, scale,
                        needs_mask(i, j, window));
    __syncwarp();
    warp_ab_acc_f32<D>(Sw, dOs, dVs + warp * 16 * D, lane);
    warp_ab_acc_f32<D>(dPw, Qs, dKs + warp * 16 * D, lane);
    __syncwarp();
  }

  __syncthreads();
  float* gk = dk + base + static_cast<size_t>(j) * kBlock * D;
  float* gv = dv + base + static_cast<size_t>(j) * kBlock * D;
  for (int idx = tid; idx < kBlock * D; idx += kThreads) {
    gk[idx] = dKs[idx];
    gv[idx] = dVs[idx];
  }
}

// ---------------------------------------------------------------------------
// Host launchers
// ---------------------------------------------------------------------------

// Grid (BH, S / 64): blockIdx.x walks the heads fastest, so the longest
// tiles of every head start before any shorter one.
template <typename K, typename... Args>
int launch(K kernel, size_t smem, int bh, int s, cudaStream_t st, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(bh, s / kBlock), kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <int D>
int fwd(bool is_bf16, const void* q, const void* k, const void* v, void* o, void* lse, int bh,
        int s, int window, cudaStream_t st) {
  const float sc = softmax_scale(D);
  float* l = static_cast<float*>(lse);
  if (is_bf16)
    return launch(flash_fwd_bf16<D>, SmemBf16<D>::fwd, bh, s, st, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
                  l, s, window, sc);
  return launch(flash_fwd_f32<D>, SmemF32<D>::fwd, bh, s, st, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<float*>(o), l, s, window, sc);
}

template <int D>
int bwd_dq(bool is_bf16, const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int bh, int s, int window,
           cudaStream_t st) {
  const float sc = softmax_scale(D);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (is_bf16)
    return launch(flash_bwd_dq_bf16<D>, SmemBf16<D>::bwd_dq, bh, s, st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, dl,
                  static_cast<bf16*>(dq), s, window, sc);
  return launch(flash_bwd_dq_f32<D>, SmemF32<D>::bwd_dq, bh, s, st,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
                static_cast<float*>(dq), s, window, sc);
}

template <int D>
int bwd_dkv(bool is_bf16, const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int bh, int s, int window,
            cudaStream_t st) {
  const float sc = softmax_scale(D);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (is_bf16)
    return launch(flash_bwd_dkv_bf16<D>, SmemBf16<D>::bwd_dkv, bh, s, st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, dl,
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), s, window, sc);
  return launch(flash_bwd_dkv_f32<D>, SmemF32<D>::bwd_dkv, bh, s, st,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
                static_cast<float*>(dk), static_cast<float*>(dv), s, window, sc);
}

bool bad_shape(int bh, int s, int window) {
  return bh <= 0 || s <= 0 || s % kBlock != 0 || s / kBlock > 65535 || window < 0;
}

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of its launch (0 = success); a head dim
// other than 64 or 128 or a bad shape is refused before any launch.

int tpe_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                  int s, int d, int window, int is_bf16, void* stream) {
  if (bad_shape(bh, s, window)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (d == 64) return fwd<64>(is_bf16, q, k, v, o, lse, bh, s, window, st);
  if (d == 128) return fwd<128>(is_bf16, q, k, v, o, lse, bh, s, window, st);
  return cudaErrorInvalidValue;
}

int tpe_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, int bh, int s, int d,
                     int window, int is_bf16, void* stream) {
  if (bad_shape(bh, s, window)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (d == 64) return bwd_dq<64>(is_bf16, q, k, v, dout, lse, delta, dq, bh, s, window, st);
  if (d == 128) return bwd_dq<128>(is_bf16, q, k, v, dout, lse, delta, dq, bh, s, window, st);
  return cudaErrorInvalidValue;
}

int tpe_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                      int d, int window, int is_bf16, void* stream) {
  if (bad_shape(bh, s, window)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (d == 64) return bwd_dkv<64>(is_bf16, q, k, v, dout, lse, delta, dk, dv, bh, s, window, st);
  if (d == 128)
    return bwd_dkv<128>(is_bf16, q, k, v, dout, lse, delta, dk, dv, bh, s, window, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
