// K3 for Hopper (sm_90a) at head dim 256: the bf16 flash-attention dK and
// dV, causal (optionally sliding-window) and non-causal, built on TMA, wgmma
// and warp specialisation. tpe_flash_bwd_dkv (flash_attention.cu) sends every
// bf16 call at D 256 here and nowhere else; D 16 to 128 go to
// flash_bwd_sm90.cu, fp32 to flash_f32_tc.cu. Helpers are in sm90.cuh.
//
// It replaces _bwd_dkv_kernel (tpu_engine/ops/_flash_pallas.py:341, launched
// by _flash_bwd through pl.pallas_call). For each (bh, key j, query i), with
// P rebuilt from the saved natural-log lse:
//   P = exp(q k^T D^-1/2 - lse),  dS = P o (dO v^T - delta) D^-1/2,
//   dV = P^T dO,  dK = dS^T Q,
// accumulated in fp32 and written once in bf16. delta is rowsum(dO o O),
// less the lse cotangent when there is one (flash_delta, plain torch).
//
// Bound: tensor-core operations, 4 products of the visible (q, k) pairs x
// D: at gemma-2b's training shape (BH 32, S 2048, D 256, causal) 1.37e11
// FLOP, 139 us at 989 TFLOP/s, against about 25 us to move its inputs and
// outputs once.
//
// The obstacle at D 256 is registers. A consumer warpgroup's [64, 256] fp32
// accumulator costs 128 registers a thread, and a consumer has at most 240
// (setmaxnreg; producer 24: 128 x 24 + 256 x 240 = 384 x 168). The D 128
// design (flash_bwd_sm90.cu) gives each consumer warpgroup 64 keys and both
// of their accumulators, dK and dV: 256 registers at D 256. The mma.sync
// kernel it replaces split dK/dV's columns over two CTAs, each recomputing
// S^T and dP^T over the full D: 1.5x the products.
//
// Design: split by role, with no product done twice.
// - Work: a CTA owns 64 keys of one head and writes their dK and dV once,
//   with no atomics: results are deterministic. The queries stream through
//   a two-stage TMA ring in 64-row tiles, Q and dO with their 64 lse and
//   delta values on one full mbarrier per stage. Persistent CTAs, one per
//   SM, take owned tiles from a counter in device memory: causal the first
//   key tiles first (they see the most queries), in chunks of heads whose
//   q, k, v and dO fit in L2 together.
// - Roles: 384 threads, three warpgroups. The producer warpgroup gives up
//   registers; one of its threads issues every TMA load: K and V of the
//   owned tile, then the streamed tiles. Consumer warpgroup 0 owns dV: per
//   streamed tile i it computes S^T = K Q_i^T (m64n64, both operands K-major
//   in shared memory), builds P^T in registers (base 2, one FMA and one exp2
//   per score against lse log2e; the mask only on the diagonal tile and the
//   window-edge tiles) and accumulates dV += P^T dO_i (P^T as the register A
//   operand, dO_i MN-major, one m64n256 product per 16 queries). Consumer
//   warpgroup 1 owns dK: it computes dP^T = V dO_i^T, takes P^T from
//   warpgroup 0, builds dS^T = P^T o (dP^T - delta) D^-1/2 and accumulates
//   dK += dS^T Q_i. Each warpgroup does two products a tile, the same work;
//   each holds one accumulator (128 registers), its 32 scores and its 16
//   packed A fragments.
// - The hand-off: P^T goes from warpgroup 0 to warpgroup 1 through shared
//   memory in fp32, so dS^T is built from the same P as dV (no rounding
//   beyond the D 128 kernels'). Thread x of warpgroup 1 reads exactly what
//   thread x of warpgroup 0 wrote (the two accumulators share one layout),
//   as 16-byte vectors laid out [value / 4][thread], without bank
//   conflicts. Two buffers of 16 KB with a full and an empty mbarrier each
//   (128 arrivals: every thread orders its own writes or reads), so the
//   hand-off is one way and warpgroup 0 may run up to two tiles ahead.
// - Shared memory: owned K and V 64 KB, two stages of Q and dO 128 KB,
//   lse and delta 1 KB, the hand-off 32 KB: 230,400 bytes of the 232,448 a
//   block may opt in to, with the barriers and the 1024-byte alignment. So
//   dK and dV leave from registers: each thread writes its two rows' bf16
//   pairs straight to global memory (a staging tile would have to wait for
//   the K and V tiles to drain, and hold the next owned tile's loads until
//   the stores had read it). K and V go back to the producer after the last
//   S^T and dP^T products of the owned tile, so the next tile's K and V
//   load while the consumers finish this one.

#include "sm90.cuh"

namespace {

constexpr int D = 256;
constexpr int kRows = 64;      // owned keys, and the queries of a streamed tile
constexpr int kStages = 2;     // depth of the streamed ring
constexpr int kThreads = 384;  // producer and two consumer warpgroups
constexpr int kBoxes = D / kBoxCols;
constexpr int kBox = kRows * 128;      // one [64 rows][64 columns] box
constexpr int kTile = kBoxes * kBox;   // one [64, 256] bf16 tile
constexpr int kRowBytes = kRows * 4;   // 64 fp32 values of lse or delta
constexpr int kXBytes = 128 * 32 * 4;  // one hand-off: 32 fp32 values per thread
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs == 384 * 168, "registers");
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-byte-aligned base: K and V of the
// owned tile, Q and dO of each stage, lse and delta of each stage, the two
// hand-off buffers, then the mbarriers (K/V full and empty; full and empty
// per stage; hand-off full and empty per buffer) and the tile slot.
struct Smem {
  static constexpr int kV = kTile;
  static constexpr int kRing = 2 * kTile;                         // stage st: Q, then dO
  static constexpr int kRowsOff = kRing + kStages * 2 * kTile;    // stage st: lse, then delta
  static constexpr int kX = kRowsOff + kStages * 2 * kRowBytes;  // hand-off buffers
  static constexpr int kBars = kX + 2 * kXBytes;
  static constexpr int kBytes = kBars + 8 * (2 + 2 * kStages + 4) + 8 + 1024;
  static_assert(kBytes <= 232448, "the opt-in shared-memory limit of a block");
};

// The owned tiles of a launch, numbered in chunks of heads whose streamed
// tensors fit in L2 together; inside a chunk, causal K3 takes its first key
// tiles first. unpack gives owned tile j of head bh and its range [lo, hi]
// of streamed query tiles (_n_q_blocks / _q_index in the Pallas kernel).
template <bool kCausal>
struct Schedule {
  int n_blk, bh_count, chunk, total, window;
  __device__ Schedule(int S, int BH, int heads, int w)
      : n_blk(S / kRows), bh_count(BH), chunk(heads), total(BH * n_blk), window(w) {}
  __device__ void unpack(int u, int& j, int& bh, int& lo, int& hi) const {
    const int first_head = u / (chunk * n_blk) * chunk;
    const int heads = min(chunk, bh_count - first_head);
    const int w = u - first_head * n_blk;
    bh = first_head + w % heads;
    j = w / heads;
    lo = 0;
    hi = n_blk - 1;
    if (kCausal) {  // Q tiles from the diagonal to the window's end
      lo = j;
      if (window != 0) hi = min(hi, (j * kRows + kRows - 2 + window) / kRows);
    }
  }
};

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_d256_sm90(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const __grid_constant__ CUtensorMap lse_map,
                        const __grid_constant__ CUtensorMap delta_map, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int* __restrict__ counters, int S, int BH,
                        int heads_per_chunk, int window, float scale, float scale2) {
  using L = Smem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + L::kV;
  auto sQ = [&](int st) { return base + L::kRing + st * 2 * kTile; };
  auto sDo = [&](int st) { return sQ(st) + kTile; };
  auto sLse = [&](int st) { return base + L::kRowsOff + st * 2 * kRowBytes; };
  auto sDelta = [&](int st) { return sLse(st) + kRowBytes; };
  auto sX = [&](int b) { return base + L::kX + b * kXBytes; };
  const uint32_t full_kv = base + L::kBars, empty_kv = full_kv + 8;
  auto full = [&](int st) { return full_kv + 8 * (2 + st); };
  auto empty = [&](int st) { return full_kv + 8 * (2 + kStages + st); };
  auto x_full = [&](int b) { return full_kv + 8 * (2 + 2 * kStages + b); };
  auto x_empty = [&](int b) { return full_kv + 8 * (4 + 2 * kStages + b); };
  const uint32_t slot = full_kv + 8 * (6 + 2 * kStages);
  volatile int* tile_slot = reinterpret_cast<volatile int*>(smem_raw + (slot - smem_u32(smem_raw)));
  auto at = [&](uint32_t a) { return smem_raw + (a - smem_u32(smem_raw)); };
  const Schedule<kCausal> sched(S, BH, heads_per_chunk, window);

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, 8);  // one arrival per consumer warp
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(x_full(b), 128);  // every thread of warpgroup 0
      mbar_init(x_empty(b), 128);  // every thread of warpgroup 1
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer: one thread issues every load ----------------
    // Per owned tile: K and V, then Q, dO, lse and delta of each streamed
    // tile in order. The ring's position `it` runs on across the CTA's
    // tiles, so the next tile's first streamed tiles load while the
    // consumers finish this one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;
      for (int r = 0;; ++r) {
        mbar_wait(empty_kv, (r & 1) ^ 1);  // both warpgroups are done with K and V
        const int u = atomicAdd(&counters[0], 1);
        *tile_slot = u < sched.total ? u : -1;
        if (u >= sched.total) {
          mbar_arrive(full_kv);  // no load: wakes the consumers to stop
          // The last CTA to run out zeroes the counters for the next launch.
          if (atomicAdd(&counters[1], 1) == static_cast<int>(gridDim.x) - 1) {
            atomicExch(&counters[0], 0);
            atomicExch(&counters[1], 0);
          }
          break;
        }
        int j, bh, lo, hi;
        sched.unpack(u, j, bh, lo, hi);
        mbar_expect_tx(full_kv, 2 * kTile);
        for (int b = 0; b < kBoxes; ++b) {
          tma_load(sK + b * kBox, &k_map, full_kv, b * kBoxCols, j * kRows, bh);
          tma_load(sV + b * kBox, &v_map, full_kv, b * kBoxCols, j * kRows, bh);
        }
        for (int n = it; n <= it + hi - lo; ++n) {
          const int st = n % kStages, row = (lo + n - it) * kRows;
          mbar_wait(empty(st), ((n / kStages) & 1) ^ 1);  // the first round passes
          mbar_expect_tx(full(st), 2 * kTile + 2 * kRowBytes);
          for (int b = 0; b < kBoxes; ++b) {
            tma_load(sQ(st) + b * kBox, &q_map, full(st), b * kBoxCols, row, bh);
            tma_load(sDo(st) + b * kBox, &do_map, full(st), b * kBoxCols, row, bh);
          }
          tma_load_2d(sLse(st), &lse_map, full(st), row, bh);
          tma_load_2d(sDelta(st), &delta_map, full(st), row, bh);
        }
        it += hi - lo + 1;
      }
    }
  } else {
    // ---------------- consumers: warpgroup 0 dV, warpgroup 1 dK ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, lane = tid % 32, t = lane % 4;
    const int r_in = (tid / 32) * 16 + lane / 4;  // this thread's keys r_in and r_in + 8
    // The owned tile of this warpgroup's score product (K: S^T, V: dP^T).
    const uint32_t sOwn = c == 0 ? sK : sV;
    bf16* const out = c == 0 ? dv : dk;
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);  // this warp is done with the buffer
    };

    int it = 0;
    for (int r = 0;; ++r) {
      mbar_wait(full_kv, r & 1);
      const int u = *tile_slot;
      if (u < 0) break;
      int j, bh, lo, hi;
      sched.unpack(u, j, bh, lo, hi);
      const int key0 = j * kRows;
      float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1) of keys r_in, r_in + 8
#pragma unroll
      for (int x = 0; x < D / 2; ++x) acc[x] = 0.0f;

      for (int i = lo, n = it; i <= hi; ++i, ++n) {
        const int st = n % kStages, b = n % 2;
        const uint32_t xpar = (n / 2) & 1;
        mbar_wait(full(st), (n / kStages) & 1);
        // Transposed tiles, rows = the owned keys, columns = the queries of
        // tile i: P^T and dS^T are then the A operands of dV and dK.
        // Warpgroup 0: S^T = K Q_i^T; warpgroup 1: dP^T = V dO_i^T.
        const uint32_t sStr = c == 0 ? sQ(st) : sDo(st);
        float s[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
          wgmma_ss(s, kmajor_desc(sOwn + off), kmajor_desc(sStr + off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        if (i == hi) release(empty_kv);  // the next tile's K and V may load
        // This thread's columns (queries) are 8 nn + 2 t and 8 nn + 2 t + 1;
        // lse and delta belong to the query.
        const uint32_t xbuf = sX(b) + tid * 16;  // [value / 4][thread] float4s
        if (c == 0) {
          const float* ls = reinterpret_cast<const float*>(at(sLse(st)));
          const bool masked = kCausal && (i == j || (window != 0 && i * kRows + 63 - key0 >= window));
#pragma unroll
          for (int nn = 0; nn < 8; ++nn) {
            const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * nn + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int x = 4 * nn + e;
              float p = fast_exp2(fmaf(s[x], scale2, -((e & 1) ? l2.y : l2.x) * kLog2e));
              if (kCausal && masked) {
                const int qpos = i * kRows + 8 * nn + 2 * t + (e & 1);
                const int kpos = key0 + r_in + 8 * (e >> 1);
                if (!(qpos >= kpos && (window == 0 || qpos - kpos < window))) p = 0.0f;
              }
              s[x] = p;
            }
          }
          mbar_wait(x_empty(b), xpar ^ 1);  // warpgroup 1 has read this buffer's last P^T
#pragma unroll
          for (int v4 = 0; v4 < 8; ++v4)
            *reinterpret_cast<float4*>(at(xbuf + v4 * 128 * 16)) =
                make_float4(s[4 * v4], s[4 * v4 + 1], s[4 * v4 + 2], s[4 * v4 + 3]);
          mbar_arrive(x_full(b));
        } else {
          const float* dls = reinterpret_cast<const float*>(at(sDelta(st)));
          mbar_wait(x_full(b), xpar);
#pragma unroll
          for (int v4 = 0; v4 < 8; ++v4) {
            const float4 p = *reinterpret_cast<const float4*>(at(xbuf + v4 * 128 * 16));
            const float2 d2 = *reinterpret_cast<const float2*>(dls + 8 * v4 + 2 * t);
            s[4 * v4] = p.x * (s[4 * v4] - d2.x) * scale;
            s[4 * v4 + 1] = p.y * (s[4 * v4 + 1] - d2.y) * scale;
            s[4 * v4 + 2] = p.z * (s[4 * v4 + 2] - d2.x) * scale;
            s[4 * v4 + 3] = p.w * (s[4 * v4 + 3] - d2.y) * scale;
          }
          mbar_arrive(x_empty(b));
        }
        // dV += P^T dO_i (warpgroup 0), dK += dS^T Q_i (warpgroup 1).
        uint32_t a[4][4];
        to_a(a, s);
        const uint32_t sB = c == 0 ? sDo(st) : sQ(st);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) wgmma_rs(acc, a[kt], mnmajor_desc<kRows>(sB + kt * 16 * 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(a);
        release(empty(st));
      }
      it += hi - lo + 1;

#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_row<D>(out + (static_cast<size_t>(bh) * S + key0 + r_in + 8 * h) * D, acc, h, 1.0f,
                     t);
    }
  }
}

// --- host side -----------------------------------------------------------------

template <bool kCausal>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, int* counters, int bh, int s, int window,
           cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  CUtensorMap qm, km, vm, dom, lm, dlm;
  if (!make_map(&km, fn, k, bh, s, D, kRows) || !make_map(&vm, fn, v, bh, s, D, kRows) ||
      !make_map(&qm, fn, q, bh, s, D, kRows) || !make_map(&dom, fn, dout, bh, s, D, kRows) ||
      !make_row_map(&lm, fn, lse, bh, s, kRows) || !make_row_map(&dlm, fn, delta, bh, s, kRows))
    return kErrEncode;
  int ctas = 0;
  const cudaError_t e =
      persistent_grid(flash_bwd_dkv_d256_sm90<kCausal>, Smem::kBytes, bh * (s / kRows), &ctas);
  if (e != cudaSuccess) return e;
  const float scale = softmax_scale(D);
  flash_bwd_dkv_d256_sm90<kCausal><<<ctas, kThreads, Smem::kBytes, stream>>>(
      qm, km, vm, dom, lm, dlm, static_cast<bf16*>(dk), static_cast<bf16*>(dv), counters, s, bh,
      heads_per_chunk(bh, s, D, 4), window, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dk, dv: [bh, s, 256] bf16, contiguous, 16-byte aligned;
// lse, delta [bh, s] fp32, 16-byte aligned; s a multiple of 64. counters:
// two ints, zero before the first launch and left zero by every launch that
// completes; launches that share them must be ordered (one stream). The
// caller (flash_attention.cu) has checked the shape. Returns the cudaError_t
// of the launch, or a negative code for a tensor-map failure.
extern "C" int tpe_flash_bwd_dkv_d256_sm90(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, void* counters, int bh, int s,
                                           int window, int causal, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int* ctr = static_cast<int*>(counters);
  return causal ? launch<true>(q, k, v, dout, lse, delta, dk, dv, ctr, bh, s, window, st)
                : launch<false>(q, k, v, dout, lse, delta, dk, dv, ctr, bh, s, window, st);
}
