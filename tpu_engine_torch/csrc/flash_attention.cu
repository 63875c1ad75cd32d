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
// Every bf16 call goes to a redesign for Hopper with TMA, wgmma and warp
// specialisation:
//   K1 at D 16, 32, 64, 128 and 256 -> flash_fwd_sm90.cu;
//   K2 and K3 at D 16, 32, 64 and 128 -> flash_bwd_sm90.cu;
//   K2 at D 256 -> flash_bwd_dq_d256_sm90.cu;
//   K3 at D 256 -> flash_bwd_dkv_d256_sm90.cu.
// Every fp32 call (K1, K2 and K3) goes to flash_f32_tc.cu, on the tensor
// cores in split TF32 (each product three TF32 products, so that the fp32
// bounds hold; a single TF32 product would not). This file holds only the C
// entries: they check the shape and dispatch on (dtype, head dim, causal),
// with no fallback from one kernel to another.

#include <cuda_runtime.h>

// The Hopper kernels: K1 for bf16 at every head dim (flash_fwd_sm90.cu), K2
// and K3 at D 16, 32, 64 and 128 (flash_bwd_sm90.cu), K2 and K3 at D 256
// (flash_bwd_dq_d256_sm90.cu, flash_bwd_dkv_d256_sm90.cu).
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

constexpr int kBlock = 64;  // S must be a multiple (the kernels' streamed tiles)

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
    else  // the Hopper kernel, and no other (no fallback)
      return tpe_flash_bwd_dq_sm90(q, k, v, dout, lse, delta, dq, counters, bh, s, D, window, C,
                                   st);
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
// flash_bwd_dkv_d256_sm90.cu); the fp32 kernels do not read them.
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
