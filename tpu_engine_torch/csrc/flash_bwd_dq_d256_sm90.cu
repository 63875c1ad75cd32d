// K2 for Hopper (sm_90a) at head dim 256: the bf16 flash-attention dQ,
// causal (optionally sliding-window) and non-causal, built on TMA, wgmma
// and warp specialisation. tpe_flash_bwd_dq (flash_attention.cu) sends every
// bf16 call at D 256 here and nowhere else; D 16 to 128 go to
// flash_bwd_sm90.cu, fp32 to flash_f32_tc.cu. Helpers are in sm90.cuh.
//
// It replaces _bwd_dq_kernel (tpu_engine/ops/_flash_pallas.py:306, with
// _recompute_p :270 and _p_ds_tile :284, launched by _flash_bwd through
// pl.pallas_call). For each (bh, query row i, key j), with P rebuilt from
// the saved natural-log lse:
//   P = exp(q k^T D^-1/2 - lse),  dS = P o (dO v^T - delta) D^-1/2,
//   dQ = dS K,
// accumulated in fp32 and written once in bf16. delta is rowsum(dO o O),
// less the lse cotangent when there is one (flash_delta, plain torch).
//
// Bound: tensor-core operations, 3 products of the visible (q, k) pairs x
// D: at gemma-2b's training shape (BH 32, S 2048, D 256, causal) 1.03e11
// FLOP, 104 us at 989 TFLOP/s, against about 40 us to move its inputs and
// outputs once.
//
// The obstacle at D 256 is registers. A [64, 256] fp32 dQ accumulator is
// 128 registers a thread of one warpgroup; beside it the D 128 design
// (flash_bwd_sm90.cu: a warpgroup owns 64 rows, scores 64 keys and
// accumulates all of dQ's columns) would hold S and dP of 64 keys (64
// registers) and their packed A fragments: past the 240 a consumer has.
//
// Design: split dQ by columns, with no product done twice.
// - Work: a CTA owns 64 Q rows of one head and writes their dQ once, with
//   no atomics: results are deterministic. K and V stream through TMA rings
//   in 64-key tiles, from the window's first tile to the diagonal
//   (_n_kv_blocks / _k_index). Persistent CTAs, one per SM, take owned
//   tiles from a counter in device memory: causal the last Q tiles first
//   (they see the most keys), in chunks of heads whose q, k, v and dO fit
//   in L2 together.
// - Roles: 384 threads, three warpgroups. The producer warpgroup gives up
//   registers (setmaxnreg.dec); one of its threads issues every TMA load:
//   dO of the owned tile, its Q, then V and K of each streamed tile. The two
//   consumer warpgroups (setmaxnreg.inc) share the owned rows. Each loads
//   Q once per owned tile as register A fragments (ldmatrix). Per streamed
//   tile, warpgroup w scores keys 32 w .. 32 w + 31 over all 64 rows:
//   S_w = Q K_w^T (m64n32, Q from registers) and dP_w = dO V_w^T (m64n32,
//   both operands K-major in shared memory), 16 k-steps over D each; then
//   dS_w in registers (base 2: one FMA and one exp2 per score against lse
//   log2e; the mask only on the diagonal tile and the window-edge tiles),
//   rounded to bf16 into its half of a [64, 64] exchange tile. After a
//   barrier of the two warpgroups, each issues dQ[:, 128 w : 128 w + 128]
//   += dS K_j[:, 128 w : 128 w + 128] (m64n128 over the 64 keys, dS K-major
//   from the exchange tile, K_j MN-major). Each warpgroup holds 64
//   accumulator registers, 64 of Q and 32 of scores.
// - Rings: Q in registers frees its buffer, and a K tile is read longer
//   than a V tile (by dQ as well as S). So K has a ring of three slots,
//   which also carries each owned tile's Q ahead of its first K tile, and V
//   a ring of two, each slot handed back as soon as its last product is
//   done: V after dP, K after dQ, Q's slot once it is in registers. With
//   one two-stage ring for both, a tile's loads could start only once the
//   tile two back had finished its dQ product, and arrived late (PERF.md
//   has the two designs' times).
// - Overlap: a warpgroup issues the next tile's S and dP right behind this
//   tile's dQ product, so the tensor cores run them back to back. The
//   exchange tile is double-buffered: buffer n % 2 is written again only
//   after both warpgroups have passed tile n + 1's barrier, which each
//   reaches after its dQ product of tile n completed.
// - Shared memory: dO 32 KB, the K ring 96 KB, the V ring 64 KB, the
//   exchange 16 KB: 214,120 bytes with the barriers and the 1024-byte
//   alignment, of the 232,448 a block may opt in to. So dQ leaves from
//   registers: each thread writes its two rows' bf16 pairs straight to
//   global memory.

#include "sm90.cuh"

namespace {

constexpr int D = 256;
constexpr int kRows = 64;      // owned Q rows, and the keys of a streamed tile
constexpr int kHalf = 32;      // keys a consumer warpgroup scores per tile
constexpr int kKStages = 3;    // slots of the K ring, which also carries each owned tile's Q
constexpr int kVStages = 2;    // slots of the V ring
constexpr int kThreads = 384;  // producer and two consumer warpgroups
constexpr int kBoxes = D / kBoxCols;
constexpr int kBox = kRows * 128;     // one [64 rows][64 columns] box
constexpr int kTile = kBoxes * kBox;  // one [64, 256] bf16 tile
constexpr int kXBytes = kBox;         // one exchange tile: dS [64 rows][64 keys] bf16
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs == 384 * 168, "registers");
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kXBar = 1;  // named barrier of the two consumer warpgroups

// Shared memory, in bytes from a 1024-byte-aligned base: dO of the owned
// tile, the K ring, the V ring, the two exchange tiles, then the mbarriers
// (dO full and empty; full and empty per K slot; full and empty per V slot)
// and the tile slot.
struct Smem {
  static constexpr int kK = kTile;                  // K slot s: kK + s * kTile
  static constexpr int kV = kK + kKStages * kTile;  // V slot s: kV + s * kTile
  static constexpr int kX = kV + kVStages * kTile;  // exchange tiles
  static constexpr int kBars = kX + 2 * kXBytes;
  static constexpr int kBytes = kBars + 8 * (2 + 2 * kKStages + 2 * kVStages) + 8 + 1024;
  static_assert(kBytes <= 232448, "the opt-in shared-memory limit of a block");
};

// The owned tiles of a launch, numbered in chunks of heads whose streamed
// tensors fit in L2 together; inside a chunk, causal K2 takes its last Q
// tiles first. unpack gives owned tile i of head bh and its range [lo, hi]
// of streamed key tiles (_n_kv_blocks / _k_index in the Pallas kernel).
template <bool kCausal>
struct Schedule {
  int n_blk, bh_count, chunk, total, window;
  __device__ Schedule(int S, int BH, int heads, int w)
      : n_blk(S / kRows), bh_count(BH), chunk(heads), total(BH * n_blk), window(w) {}
  __device__ void unpack(int u, int& i, int& bh, int& lo, int& hi) const {
    const int first_head = u / (chunk * n_blk) * chunk;
    const int heads = min(chunk, bh_count - first_head);
    const int w = u - first_head * n_blk;
    bh = first_head + w % heads;
    i = kCausal ? n_blk - 1 - w / heads : w / heads;
    lo = 0;
    hi = n_blk - 1;
    if (kCausal) {  // K tiles from the window's start to the diagonal
      hi = i;
      const int first = i * kRows - (window - 1);
      lo = window != 0 && first > 0 ? first / kRows : 0;
    }
  }
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int window) {
  return qpos >= kpos && (window == 0 || qpos - kpos < window);
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_d256_sm90(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int* __restrict__ counters, int S, int BH, int heads_per_chunk, int window,
                       float scale, float scale2) {
  using L = Smem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sDo = base;
  auto sK = [&](int m) { return base + L::kK + (m % kKStages) * kTile; };  // K ring position m
  auto sV = [&](int m) { return base + L::kV + (m % kVStages) * kTile; };  // V ring position m
  auto sX = [&](int b) { return base + L::kX + b * kXBytes; };
  const uint32_t full_do = base + L::kBars, empty_do = full_do + 8;
  auto full_k = [&](int m) { return full_do + 8 * (2 + m % kKStages); };
  auto empty_k = [&](int m) { return full_do + 8 * (2 + kKStages + m % kKStages); };
  auto full_v = [&](int m) { return full_do + 8 * (2 + 2 * kKStages + m % kVStages); };
  auto empty_v = [&](int m) { return full_do + 8 * (2 + 2 * kKStages + kVStages + m % kVStages); };
  // The phase parity of ring position m (the slot's use count, mod 2); the
  // producer waits for the one before (^ 1), which a fresh barrier passes.
  auto k_par = [](int m) { return static_cast<uint32_t>((m / kKStages) & 1); };
  auto v_par = [](int m) { return static_cast<uint32_t>((m / kVStages) & 1); };
  // The producer passes each tile's number (-1: none left) to the consumers
  // in this slot, written before the arrival on full_do that reports it.
  const uint32_t slot = full_do + 8 * (2 + 2 * kKStages + 2 * kVStages);
  volatile int* tile_slot = reinterpret_cast<volatile int*>(smem_raw + (slot - smem_u32(smem_raw)));
  const Schedule<kCausal> sched(S, BH, heads_per_chunk, window);

  if (threadIdx.x == 0) {
    mbar_init(full_do, 1);
    mbar_init(empty_do, 8);  // one arrival per consumer warp
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(empty_k(s), 8);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(full_v(s), 1);
      mbar_init(empty_v(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer: one thread issues every load ----------------
    // Per owned tile: dO; Q into the K ring; then V and K of each streamed
    // tile in order. The rings' positions run on across the CTA's tiles, so
    // the next tile's Q and first K and V load while the consumers finish
    // this one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int mk = 0, mv = 0;  // the next K and V ring positions
      auto load_k = [&](const CUtensorMap* map, int row, int bh) {
        mbar_wait(empty_k(mk), k_par(mk) ^ 1);  // the first round passes
        mbar_expect_tx(full_k(mk), kTile);
        for (int b = 0; b < kBoxes; ++b)
          tma_load(sK(mk) + b * kBox, map, full_k(mk), b * kBoxCols, row, bh);
        ++mk;
      };
      for (int r = 0;; ++r) {
        mbar_wait(empty_do, (r & 1) ^ 1);  // both warpgroups are done with dO
        const int u = atomicAdd(&counters[0], 1);
        *tile_slot = u < sched.total ? u : -1;
        if (u >= sched.total) {
          mbar_arrive(full_do);  // no load: wakes the consumers to stop
          // The last CTA to run out zeroes the counters for the next launch.
          if (atomicAdd(&counters[1], 1) == static_cast<int>(gridDim.x) - 1) {
            atomicExch(&counters[0], 0);
            atomicExch(&counters[1], 0);
          }
          break;
        }
        int i, bh, lo, hi;
        sched.unpack(u, i, bh, lo, hi);
        mbar_expect_tx(full_do, kTile);
        for (int b = 0; b < kBoxes; ++b)
          tma_load(sDo + b * kBox, &do_map, full_do, b * kBoxCols, i * kRows, bh);
        load_k(&q_map, i * kRows, bh);
        for (int j = lo; j <= hi; ++j) {
          mbar_wait(empty_v(mv), v_par(mv) ^ 1);
          mbar_expect_tx(full_v(mv), kTile);
          for (int b = 0; b < kBoxes; ++b)
            tma_load(sV(mv) + b * kBox, &v_map, full_v(mv), b * kBoxCols, j * kRows, bh);
          ++mv;
          load_k(&k_map, j * kRows, bh);
        }
      }
    }
  } else {
    // ---------- consumers: keys 32 c .. of each tile, dQ's columns 128 c .. ----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, lane = tid % 32, t = lane % 4, g = lane / 4;
    const int r_in = (tid / 32) * 16 + g;  // this thread's rows r_in and r_in + 8
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);  // this warp is done with the buffer
    };
    // Q of the owned tile (K ring position m) as register A fragments, slice
    // kk in qa[kk]: by ldmatrix, lane l giving row 16 w + l % 8 + 8 ((l / 8)
    // % 2) and 16-byte chunk 2 (kk % 4) + l / 16 of the swizzled tile.
    uint32_t qa[D / 16][4];
    auto load_q = [&](int m) {
      const int mm = lane / 8, row = (tid / 32) * 16 + lane % 8 + 8 * (mm % 2);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int chunk = (kk % 4) * 2 + mm / 2;
        ldsm_x4(qa[kk], sK(m) + (kk / 4) * kBox + row * 128 + ((chunk ^ (row % 8)) * 16));
      }
    };
    // S = Q K^T (Q from registers) and dP = dO V^T of this warpgroup's 32
    // keys (rows 32 c .. of K ring position mk and V ring position mv).
    auto issue_scores = [&](float (&s)[16], float (&dp)[16], int mk, int mv) {
      mbar_wait(full_k(mk), k_par(mk));
      mbar_wait(full_v(mv), v_par(mv));
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_rs_k(s, qa[kk], kmajor_desc(sK(mk) + off + c * kHalf * 128), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_ss(dp, kmajor_desc(sDo + off), kmajor_desc(sV(mv) + off + c * kHalf * 128), kk > 0);
      }
      wgmma_commit();
    };

    int mk = 0, mv = 0;  // K and V ring positions of this owned tile's first streamed tile
    for (int r = 0;; ++r) {
      mbar_wait(full_do, r & 1);
      const int u = *tile_slot;
      if (u < 0) break;
      int i, bh, lo, hi;
      sched.unpack(u, i, bh, lo, hi);
      const int row0 = i * kRows;
      mbar_wait(full_k(mk), k_par(mk));
      load_q(mk);
      release(empty_k(mk));  // Q is in registers: the slot may take a K tile
      ++mk;
      float lse2[2], dl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = static_cast<size_t>(bh) * S + row0 + r_in + 8 * h;
        lse2[h] = lse[row] * kLog2e;
        dl[h] = delta[row];
      }
      // dQ[r_in, r_in + 8][128 c .. 128 c + 127], and this warpgroup's S
      // and dP: written by wgmma alone (the first dQ product overwrites acc),
      // so that no other instruction defines an accumulator while products
      // are in flight, which would make ptxas serialize them.
      float acc[64], s[16], dp[16];
      issue_scores(s, dp, mk, mv);
      for (int j = lo; j <= hi; ++j, ++mk, ++mv) {
        wgmma_wait<0>();  // S and dP of tile j
        fence_regs(s);
        fence_regs(dp);
        release(empty_v(mv));  // V_j is read: ring position mv + 2 may load
        if (j == hi) release(empty_do);  // the next tile's dO may load
        // dS = P (dP - delta) scale, in bf16 into this warpgroup's 32
        // columns of the exchange tile, in the 128-byte swizzle of a K-major
        // wgmma operand (row r's 16-byte chunk k lies at chunk k ^ (r % 8);
        // r % 8 is g). This thread's keys are key0 + 8 nn + 2 t and + 1.
        const int key0 = j * kRows + c * kHalf;
        const bool masked = kCausal && (j == i || (window != 0 && row0 + 63 - j * kRows >= window));
        const uint32_t xb = sX(mv % 2);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * nn + 2 * h + e;
              float p = fast_exp2(fmaf(s[x], scale2, -lse2[h]));
              if (masked && !visible(row0 + r_in + 8 * h, key0 + 8 * nn + 2 * t + e, window))
                p = 0.0f;
              ds[e] = p * (dp[x] - dl[h]) * scale;
            }
            st_shared_u32(xb + (r_in + 8 * h) * 128 + (((4 * c + nn) ^ g) * 16) + 4 * t,
                          pack_bf16(ds[0], ds[1]));
          }
        fence_async_shared();  // the writes are visible to wgmma's reads
        named_sync(kXBar);     // both halves of dS are in place
        // dQ[:, 128 c ..] += dS K_j[:, 128 c ..]; behind it the next tile's
        // S and dP, so that the tensor cores run them back to back.
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < kRows / 16; ++kt)
          wgmma_ss_mn(acc, kmajor_desc(xb + kt * 32),
                      mnmajor_desc<kRows>(sK(mk) + 2 * c * kBox + kt * 16 * 128), j > lo || kt > 0);
        wgmma_commit();
        if (j < hi) {
          issue_scores(s, dp, mk + 1, mv + 1);
          wgmma_wait<1>();  // the dQ product, committed first, is done
        } else {
          wgmma_wait<0>();
        }
        fence_regs(acc);
        release(empty_k(mk));  // K_j is read: ring position mk + 3 may load
      }
      wgmma_wait<0>();
      fence_regs(acc);

#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_row<128>(dq + (static_cast<size_t>(bh) * S + row0 + r_in + 8 * h) * D + 128 * c,
                       acc, h, 1.0f, t);
    }
  }
}

// --- host side -----------------------------------------------------------------

template <bool kCausal>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int* counters, int bh, int s, int window,
           cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  CUtensorMap qm, km, vm, dom;
  if (!make_map(&qm, fn, q, bh, s, D, kRows) || !make_map(&dom, fn, dout, bh, s, D, kRows) ||
      !make_map(&km, fn, k, bh, s, D, kRows) || !make_map(&vm, fn, v, bh, s, D, kRows))
    return kErrEncode;
  int ctas = 0;
  const cudaError_t e =
      persistent_grid(flash_bwd_dq_d256_sm90<kCausal>, Smem::kBytes, bh * (s / kRows), &ctas);
  if (e != cudaSuccess) return e;
  const float scale = softmax_scale(D);
  flash_bwd_dq_d256_sm90<kCausal><<<ctas, kThreads, Smem::kBytes, stream>>>(
      qm, km, vm, dom, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), counters, s, bh, heads_per_chunk(bh, s, D, 4), window, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq: [bh, s, 256] bf16, contiguous, 16-byte aligned; lse,
// delta [bh, s] fp32; s a multiple of 64. counters: two ints, zero before
// the first launch and left zero by every launch that completes; launches
// that share them must be ordered (one stream). The caller
// (flash_attention.cu) has checked the shape. Returns the cudaError_t of
// the launch, or a negative code for a tensor-map failure.
extern "C" int tpe_flash_bwd_dq_d256_sm90(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, void* counters, int bh, int s, int window,
                                          int causal, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int* ctr = static_cast<int*>(counters);
  return causal ? launch<true>(q, k, v, dout, lse, delta, dq, ctr, bh, s, window, st)
                : launch<false>(q, k, v, dout, lse, delta, dq, ctr, bh, s, window, st);
}
