// Causal (optionally sliding-window) and non-causal flash attention for
// Hopper (sm_90a): one forward kernel and two backward kernels, with a plain C
// interface loaded from Python through ctypes
// (tpu_engine_torch/ops/_flash_cuda.py).
//
// Layout: q, k, v, o, dO, dq, dk, dv are [BH, S, D] contiguous, bf16 or
// fp32; lse and delta are [BH, S] fp32. S is a multiple of 64; D is a
// template parameter, instantiated for 16, 32, 64, 128 and 256 (every head
// of MODEL_CONFIGS; 256 is gemma's). scale = 1/sqrt(D).
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
// Each kernel has a causal and a non-causal form (the kCausal template flag,
// the causal=True/False branches of the Pallas kernels). Non-causal is ring
// attention's past hops (flash_fwd_lse(..., causal=False)): every tile pair is
// visited, no visibility mask is computed, and there is no window. At a ring
// shard (BH 16, S 2048, D 128) it does twice the causal work: K1 3.4e10 FLOP,
// ~35 us; K2 ~52 us; K3 ~69 us, all operations-bound. The lse cotangent of
// flash_fwd_lse needs no kernel change: it enters through delta
// (delta' = rowsum(dO o o) - dlse, _flash_bwd).
//
// Every bf16 call of K1 and K3, and bf16 K2 at D 64, 128 and 256, goes to a
// redesign for Hopper with TMA, wgmma and warp specialisation:
//   K1 at D 16, 32, 64, 128 and 256 -> flash_fwd_sm90.cu;
//   K3 at D 16, 32, 64 and 128      -> flash_bwd_sm90.cu;
//   K2 at D 64 and 128              -> flash_bwd_sm90.cu;
//   K2 at D 256                     -> flash_bwd_dq_d256_sm90.cu;
//   K3 at D 256                     -> flash_bwd_dkv_d256_sm90.cu.
// Every fp32 call (K1, K2 and K3) goes to flash_f32_tc.cu, on the tensor
// cores in split TF32 (each product three TF32 products, so that the fp32
// bounds hold; a single TF32 product would not).
//
// What is left here, with no fallback from those kernels to it: bf16 K2 at
// D 16 and 32 (the tiny configs' heads), flash_bwd_dq_bf16. One 128-thread
// block (four warps) per (bh, 64-row Q tile) walks the K tiles that its
// causal window lets it see -- the TPU's sequential inner grid axis -- and
// never visits a tile above the diagonal or outside the window; the
// visibility mask is evaluated only on the diagonal and window-edge tiles.
// Blocks with the longest loops are launched first. Each warp owns 16 rows
// of the tile and keeps its scores, dS and the fp32 dQ accumulator in
// registers. The products run on tensor cores through mma.sync m16n8k16
// (bf16 in, fp32 accumulate), with operands fed from shared memory by
// ldmatrix; an accumulator tile rounded to bf16 is already the A operand of
// the next product, so dS never touches shared memory. The K/V tiles are
// double-buffered with cp.async. Its bound is the exp unit (one exp per
// visible pair, PEAK_EXP2 in chip_smoke.py), not the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "flash_common.cuh"

// The Hopper kernels: K1 for bf16 at every head dim (flash_fwd_sm90.cu), K3
// at D 16, 32, 64 and 128 and K2 at D 64 and 128 (flash_bwd_sm90.cu), K2
// and K3 at D 256 (flash_bwd_dq_d256_sm90.cu, flash_bwd_dkv_d256_sm90.cu).
extern "C" int tpe_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                  void* lse, void* counters, int bh, int s, int d, int window,
                                  int causal, void* stream);
extern "C" int tpe_flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, void* counters, int bh, int s, int d, int window,
                                     int causal, void* stream);
extern "C" int tpe_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, void* counters, int bh, int s, int d,
                                      int window, int causal, void* stream);
extern "C" int tpe_flash_bwd_dq_d256_sm90(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, void* counters, int bh, int s, int window,
                                          int causal, void* stream);
extern "C" int tpe_flash_bwd_dkv_d256_sm90(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, void* counters, int bh, int s,
                                           int window, int causal, void* stream);
// fp32 K1, K2 and K3 on the tensor cores in split TF32 (flash_f32_tc.cu).
extern "C" int tpe_flash_fwd_f32_tc(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int bh, int s, int d, int window, int causal,
                                    void* stream);
extern "C" int tpe_flash_bwd_dq_f32_tc(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, int bh, int s, int d, int window, int causal,
                                       void* stream);
extern "C" int tpe_flash_bwd_dkv_f32_tc(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dk, void* dv, int bh, int s, int d, int window,
                                        int causal, void* stream);

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps, 16 tile rows each

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

// Write a warp's accumulator [16 x W] as bf16 into rows of W elements: dst
// points at the lane's row g, and row g + 8 follows 8 rows on.
template <int W>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[W / 8][4], int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    *reinterpret_cast<uint32_t*>(dst + n * 8 + 2 * t) = pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(dst + 8 * W + n * 8 + 2 * t) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int D>
constexpr size_t kSmemDq = 6 * Tile<D>::BYTES;  // Q, dO; K, V x 2 stages

// ---------------------------------------------------------------------------
// K2 (bf16): dQ
// ---------------------------------------------------------------------------

// Instantiated for D 16 and 32 (D 64 and 128: flash_bwd_sm90.cu; D 256:
// flash_bwd_dq_d256_sm90.cu).
template <int D, bool kCausal>
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
  int i, lo, hi;
  q_major_range<kCausal>(n_blk, window, i, lo, hi);
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane & 3;
  const int qpos = i * kBlock + warp * 16 + (lane >> 2);
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
  for (int j = lo; j <= hi; ++j) {
    const int st = (j - lo) & 1;
    if (j < hi) {
      const size_t nxt = base + static_cast<size_t>(j + 1) * kBlock * D;
      load_tile_async<D>(Ks + (st ^ 1) * L::SIZE, k + nxt, tid);
      load_tile_async<D>(Vs + (st ^ 1) * L::SIZE, v + nxt, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool masked = kCausal && needs_mask(i, j, window);
    const bf16* Kt = Ks + st * L::SIZE;
    const int key0 = j * kBlock;
    float s[NT][4], dp[NT][4];
    mma_abt<D, NT>(s, Qs + warp * 16 * L::LD, Kt, L::LD, lane);
    mma_abt<D, NT>(dp, dOs + warp * 16 * L::LD, Vs + st * L::SIZE, L::LD, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(fmaf(s[n][e], scale2, -lse2[r]));
        if (masked && !visible(qpos + 8 * r, key0 + n * 8 + 2 * t + (e & 1), window)) p = 0.0f;
        s[n][e] = p * (dp[n][e] - dl[r]) * scale;  // dS
      }
    uint32_t da[NT / 2][4];
    to_a<NT>(da, s);
    mma_ab<NT / 2, DT>(acc, da, Kt, L::LD, lane);
    __syncthreads();
  }
  store_rows<D>(dq + base + static_cast<size_t>(qpos) * D, acc, lane);
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

// The Hopper kernels take bf16 K1 at every head dim, K3 at D 16, 32, 64
// and 128 (and at D 256 in its own design), and K2 at D 64 and 128 (and at
// D 256 in its own design); bf16 K2 at D 16 and 32 is flash_bwd_dq_bf16.
template <int D>
constexpr bool kSm90Dq = D == 64 || D == 128;

template <int D, bool C>
int fwd(bool is_bf16, const void* q, const void* k, const void* v, void* o, void* lse,
        void* counters, int bh, int s, int window, cudaStream_t st) {
  if (is_bf16)  // the Hopper kernel, and no other (no fallback)
    return tpe_flash_fwd_sm90(q, k, v, o, lse, counters, bh, s, D, window, C, st);
  // fp32: the split-TF32 tensor-core kernel, and no other (no fallback).
  return tpe_flash_fwd_f32_tc(q, k, v, o, lse, bh, s, D, window, C, st);
}

template <int D, bool C>
int bwd_dq(bool is_bf16, const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* counters, int bh, int s,
           int window, cudaStream_t st) {
  if (is_bf16) {
    if constexpr (D == 256)  // the Hopper kernels, and no other (no fallback)
      return tpe_flash_bwd_dq_d256_sm90(q, k, v, dout, lse, delta, dq, counters, bh, s, window,
                                        C, st);
    else if constexpr (kSm90Dq<D>)
      return tpe_flash_bwd_dq_sm90(q, k, v, dout, lse, delta, dq, counters, bh, s, D, window, C,
                                   st);
    else
      return launch(flash_bwd_dq_bf16<D, C>, kSmemDq<D>, bh, s, st,
                    static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                    static_cast<const float*>(lse), static_cast<const float*>(delta),
                    static_cast<bf16*>(dq), s, window, softmax_scale(D));
  }
  // fp32: the split-TF32 tensor-core kernel, and no other (no fallback).
  return tpe_flash_bwd_dq_f32_tc(q, k, v, dout, lse, delta, dq, bh, s, D, window, C, st);
}

template <int D, bool C>
int bwd_dkv(bool is_bf16, const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, void* counters, int bh,
            int s, int window, cudaStream_t st) {
  if (is_bf16) {
    if constexpr (D == 256)  // the Hopper kernels, and no other (no fallback)
      return tpe_flash_bwd_dkv_d256_sm90(q, k, v, dout, lse, delta, dk, dv, counters, bh, s,
                                         window, C, st);
    else  // the Hopper kernel, and no other (no fallback)
      return tpe_flash_bwd_dkv_sm90(q, k, v, dout, lse, delta, dk, dv, counters, bh, s, D,
                                    window, C, st);
  }
  // fp32: the split-TF32 tensor-core kernel, and no other (no fallback).
  return tpe_flash_bwd_dkv_f32_tc(q, k, v, dout, lse, delta, dk, dv, bh, s, D, window, C, st);
}

// The (head dim, causal) pair as types, for dispatch from runtime values.
template <int D_, bool C_>
struct Variant {
  static constexpr int D = D_;
  static constexpr bool causal = C_;
};

template <int D, typename F>
int with_causal(bool causal, F&& f) {
  return causal ? f(Variant<D, true>{}) : f(Variant<D, false>{});
}

// Calls f(Variant<d, causal>{}) for a built head dim; refuses any other.
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

// A window needs the causal kernels: non-causal attention has no window.
bool bad_shape(int bh, int s, int window, int causal) {
  return bh <= 0 || s <= 0 || s % kBlock != 0 || s / kBlock > 65535 || window < 0 ||
         (!causal && window != 0);
}

}  // namespace

extern "C" {

// Each entry returns the cudaError_t of its launch (0 = success); a head dim
// other than 16, 32, 64, 128 or 256, or a bad shape, is refused before any
// launch.

// counters: the Hopper kernels' tile counters (two ints per kernel, see
// flash_fwd_sm90.cu, flash_bwd_sm90.cu, flash_bwd_dq_d256_sm90.cu and
// flash_bwd_dkv_d256_sm90.cu); the other kernels do not read them.
int tpe_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                  void* counters, int bh, int s, int d, int window, int causal, int is_bf16,
                  void* stream) {
  if (bad_shape(bh, s, window, causal)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return dispatch(d, causal != 0, [&](auto var) {
    using V = decltype(var);
    return fwd<V::D, V::causal>(is_bf16, q, k, v, o, lse, counters, bh, s, window, st);
  });
}

int tpe_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, void* counters, int bh, int s,
                     int d, int window, int causal, int is_bf16, void* stream) {
  if (bad_shape(bh, s, window, causal)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return dispatch(d, causal != 0, [&](auto var) {
    using V = decltype(var);
    return bwd_dq<V::D, V::causal>(is_bf16, q, k, v, dout, lse, delta, dq, counters, bh, s,
                                   window, st);
  });
}

int tpe_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, void* counters,
                      int bh, int s, int d, int window, int causal, int is_bf16, void* stream) {
  if (bad_shape(bh, s, window, causal)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return dispatch(d, causal != 0, [&](auto var) {
    using V = decltype(var);
    return bwd_dkv<V::D, V::causal>(is_bf16, q, k, v, dout, lse, delta, dk, dv, counters, bh, s,
                                    window, st);
  });
}

}  // extern "C"
