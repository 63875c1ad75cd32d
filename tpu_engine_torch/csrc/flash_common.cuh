// The tile schedule and the cp.async copies of the mma.sync flash kernels:
// flash_f32_tc.cu (fp32 K1-K3 in split TF32).
//
// The schedule works on 64-row blocks of the sequence: a Q-major kernel (K1,
// K2) owns Q block i and walks the K blocks [lo, hi] that its causal window
// lets it see; the K-major kernel (K3) owns K block j and walks the Q blocks
// that see it. The visibility mask is evaluated only on the blocks that
// straddle the diagonal or the window's lower edge.

#pragma once

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBlock = 64;         // rows of a scheduled Q or K block
constexpr float kNegInf = -1e30f;
constexpr float kM2Floor = -1e6f;  // running-max floor (base-2 units)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ bool visible(int qpos, int kpos, int window) {
  return qpos >= kpos && (window == 0 || qpos - kpos < window);
}

// Does the (Q block i, K block j) pair need the visibility mask? Only the
// diagonal block and, with a window, the blocks straddling its lower edge.
__device__ __forceinline__ bool needs_mask(int i, int j, int window) {
  return i == j || (window != 0 && (i - j + 1) * kBlock - 1 >= window);
}

// The first K block that Q block i sees, and the last Q block that sees K
// block j (_n_kv_blocks / _k_index and _n_q_blocks / _q_index in the Pallas
// kernels).
__device__ __forceinline__ int first_k_tile(int i, int window) {
  if (window == 0) return 0;
  const int first = i * kBlock - (window - 1);
  return first > 0 ? first / kBlock : 0;
}
__device__ __forceinline__ int last_q_tile(int j, int n_blk, int window) {
  return window == 0 ? n_blk - 1 : min(n_blk - 1, j + (kBlock + window - 2) / kBlock);
}

// The Q-major kernels' (K1, K2) row block and their range of K blocks [lo,
// hi]: causal blocks with the longest loops first, non-causal every K block.
template <bool kCausal>
__device__ __forceinline__ void q_major_range(int n_blk, int window, int& i, int& lo, int& hi) {
  i = kCausal ? n_blk - 1 - static_cast<int>(blockIdx.y) : static_cast<int>(blockIdx.y);
  lo = kCausal ? first_k_tile(i, window) : 0;
  hi = kCausal ? i : n_blk - 1;
}

// The K-major kernel's (K3) range of Q blocks [lo, hi] for K block j: causal
// from the diagonal to the last block the window lets see j, non-causal all.
template <bool kCausal>
__device__ __forceinline__ void k_major_range(int j, int n_blk, int window, int& lo, int& hi) {
  lo = kCausal ? j : 0;
  hi = kCausal ? last_q_tile(j, n_blk, window) : n_blk - 1;
}

// 1/sqrt(D), rounded once to fp32 as the JAX kernel's Python-side scale is.
inline float softmax_scale(int d) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(d)));
}

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

}  // namespace
