// K2 and K3 for Hopper (sm_90a): the bf16 flash-attention backward at head
// dims 16, 32, 64 and 128, causal (optionally sliding-window) and
// non-causal, built on TMA, wgmma and warp specialisation.
// tpe_flash_bwd_dq and tpe_flash_bwd_dkv (flash_attention.cu) send every
// bf16 call at those head dims here and nowhere else; D 256 has its own
// files, and fp32 goes to flash_f32_tc.cu.
//
// They replace _bwd_dq_kernel and _bwd_dkv_kernel
// (tpu_engine/ops/_flash_pallas.py:306 and :341, launched by _flash_bwd
// through pl.pallas_call). For each (bh, query row i, key j), with P rebuilt
// from the saved natural-log lse:
//   P = exp(q k^T D^-1/2 - lse),  dS = P o (dO v^T - delta) D^-1/2,
//   K2: dQ = dS K;  K3: dV = P^T dO, dK = dS^T Q,
// accumulated in fp32 and written once in bf16. delta is rowsum(dO o O),
// less the lse cotangent when there is one (flash_delta, plain torch).
//
// Bound: tensor-core operations. K2 does 3 products of the visible (q, k)
// pairs x D, K3 does 4: at the training shape (BH 64, S 2048, D 128,
// causal) 1.03e11 and 1.37e11 FLOP, 104 and 139 us at 989 TFLOP/s, against
// about 45 and 55 us to move their inputs and outputs once.
//
// What the design does about it:
// - Work: a CTA owns 128 rows and writes their gradient once: K2 a Q tile
//   (dQ), K3 a K tile (dK and dV). The other side streams through a ring in
//   64-row tiles: K2's K and V tiles, K3's Q and dO tiles with their 64 lse
//   and delta values. No atomics on gradients: results are deterministic.
//   Persistent CTAs, one per SM, take owned tiles from a counter in device
//   memory, longest first (causal), in chunks of heads whose q, k, v and dO
//   fit in L2 together.
// - Roles: 384 threads, three warpgroups. The producer warpgroup gives up
//   registers (setmaxnreg.dec); one of its threads issues every TMA load:
//   the owned tiles, then the streamed tiles into a two-stage ring with a
//   full and an empty mbarrier per stage. The two consumer warpgroups take
//   the registers (setmaxnreg.inc) and own 64 rows each; they issue no copy
//   and no __syncthreads. They hand the owned tiles back after their last
//   S and dP products, so the next tile's loads start while they finish
//   this one.
// - TMA: q, k, v, dO and the outputs are 3-D tensor maps [BH, S, D] with
//   [rows][64 columns] boxes in the 128-byte swizzle; lse and delta are 2-D
//   maps [BH, S] with 64-value boxes. S is a multiple of 64, so a streamed
//   tile is never ragged; a ragged owned tile (S % 128 == 64; K2 and K3 at D
//   16 and 32, S % 192 != 0) has its upper 64 or 128 rows past S, zero-filled,
//   and the warpgroups that own them compute and store nothing.
// - wgmma, per streamed tile and consumer warpgroup: K2 issues
//   S = Q K_j^T and dP = dO V_j^T (m64n64, both operands K-major in shared
//   memory), builds dS in registers and issues dQ += dS K_j with dS as the
//   register A operand and K_j MN-major (transpose bit). K3 issues
//   S^T = K Q_i^T and dP^T = V dO_i^T, builds P^T and dS^T in place, and
//   issues dV += P^T dO_i and dK += dS^T Q_i. Every operand layout is one K1
//   uses: a streamed tile is read K-major for one product and MN-major for
//   the other.
// - P and dS in registers, base 2: one FMA and one exp2 per score against
//   lse log2e; only the diagonal tile and the window-edge tiles evaluate the
//   mask, and a warpgroup visits no tile above its diagonal or outside its
//   window (it hands such a stage straight back to the producer).
// - Epilogue: the fp32 accumulators in bf16, staged in shared memory and
//   written by TMA stores that run on while the next owned tile starts.
// - K3 at D 16 and 32 (DkvTiles<D>): the exp unit, not the tensor cores,
//   bounds it (one exp per visible pair, chip_smoke.kernel_bounds; at D 32
//   the products tie with it). Three consumer warpgroups (192 owned keys, a
//   third warp on each SM sub-partition to hide latency; 160 registers
//   each); each runs tile i's scores while tile i - 1's dV and dK products
//   are in flight, with S^T, dP^T and those products in three commit
//   groups so that P^T is taken as soon as S^T is done, on a three-stage
//   ring; each column's lse log2e and delta scale are taken once a tile
//   (one FFMA and one ex2.approx a score for P, one FFMA and one FMUL for
//   dS), and the mask is a pass of its own that only masked tiles run; at
//   D 16 the warpgroup's K and V rows are register A operands (ldmatrix,
//   once an owned tile), at D 32 they would spill. Tiles are one box of
//   [rows][D] in the 64- or 32-byte swizzle, and dK and dV are written from
//   registers. Measured on an H100 against it (kernel_ab.py's VARIANTS): D
//   64's serial loop, two consumer warpgroups, 128-query streamed tiles
//   (they spill), a four-stage ring, K and V from shared memory at D 16:
//   all slower or within noise. The first build, with the mask tested in
//   the exp loop of every tile, ran causal no faster than non-causal.
// - K2 at D 16 and 32 (DqTiles<D>): the exp unit bounds it too (the three
//   products come to 0.026 ms at D 32 against 0.035 of exps at S 2048, B·H
//   64). Three consumer warpgroups own 64 Q rows each (192 a CTA, 512
//   threads, 160 registers each); 64-key K/V tiles stream through a
//   four-stage ring; each warpgroup issues tile j's S and dP products
//   ahead of tile j - 1's dQ += dS K product, in three commit groups, and
//   takes P as soon as S is done and dS once dP is, while dQ's product
//   runs. The producer loads the owned rows' lse and delta by TMA with Q
//   and dO; each thread takes its rows' lse log2e and -delta scale once an
//   owned tile (one FFMA and one ex2.approx a score for P, one FFMA and one
//   FMUL for dS); the mask is a pass of its own that only masked tiles
//   run; the warpgroup's Q and dO rows are register A operands (ldmatrix,
//   once an owned tile); dQ is written from registers. Measured on an H100
//   against it (kernel_ab.py's VARIANTS): D 64's serial loop, two or four
//   consumer warpgroups (four spill), Q and dO from shared memory, a ring
//   of two, three, six or eight stages, lse and delta read from global
//   memory, turns at the exps, a quarter of the exps on the FMA pipe: all
//   slower or within noise.
#include "sm90.cuh"

namespace {

constexpr int kStream = 64;  // rows of a streamed tile: keys (K2) or queries (K3)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kOutBar = 1;  // named barriers 1 and 2: each warpgroup around its staging

// K2's tiles per head dim, 64-key streamed tiles at every D. At D 64 and
// 128 two consumer warpgroups own 64 Q rows each and run a tile's S and dP
// products, its dS and its dQ product in turn, on a two-stage ring, and dQ
// leaves through shared memory and TMA stores. At D 16 and 32 the products
// are small and the exp unit bounds the kernel: three consumer warpgroups
// run tile j's scores while tile j - 1's dQ product is in flight
// (kPipelined; a warpgroup holds two stages at once, and a ring of four
// lets the warpgroups drift apart by a tile or two), and dQ (16 or 32
// columns) is written from registers.
template <int D>
struct DqTiles {
  using W = Swizzle<D>;
  static constexpr int kConsumers = D < 64 ? 3 : 2;
  static constexpr int kOwnRows = 64 * kConsumers;  // Q rows a CTA owns
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // 128 x producer + 128 kConsumers x consumer within the allocation at
  // launch (384 x 168 at D 64 and 128; 512 x 128 at D 16 and 32).
  static constexpr int kProducerRegs = D < 64 ? 24 : 40;
  static constexpr int kConsumerRegs =
      D < 64 ? (kThreads * (65536 / kThreads / 8 * 8) - 128 * kProducerRegs) /
                   (128 * kConsumers) / 8 * 8
             : 232;
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                    kThreads * (65536 / kThreads / 8 * 8), "registers");
  static constexpr bool kPipelined = D < 64;
  static constexpr int kStages = kPipelined ? 4 : 2;  // depth of the K/V ring
  // At D 16 and 32 each consumer warpgroup holds its 64 rows of Q and dO
  // in registers (ldmatrix, once an owned tile; 8 or 16 registers), S and
  // dP take them as their register A operands, and the Q/dO buffer goes
  // back to the producer as soon as they are loaded.
  static constexpr bool kOwnInRegs = D < 64;
  // At D 16 and 32 the producer loads the owned rows' lse and delta by TMA
  // with Q and dO, so that no consumer waits on a global load at the start
  // of an owned tile; at D 64 and 128 the consumers read them.
  static constexpr bool kRowsInSmem = kPipelined;
  static constexpr bool kStagedOut = D >= 64;
  static constexpr int kOwnBox = kOwnRows * W::kRowBytes;    // one [kOwnRows rows][cols] box
  static constexpr int kStreamBox = kStream * W::kRowBytes;  // one [64 rows][cols] box
  static constexpr int kLseBytes = kOwnRows * 4;             // kOwnRows fp32 lse or delta values
  static_assert(kPipelined || !kOwnInRegs, "the serial loop reads Q and dO from shared memory");
};

// Shared memory of K2, in bytes from a 1024-byte-aligned base: Q and dO of
// the owned tile, K and V of each stage, each warpgroup's dQ staging (D 64
// and 128), the owned rows' lse and delta (D 16 and 32), then the mbarriers
// (Q full and empty; full and empty per stage) and the tile slot.
template <int D>
struct DqSmem {
  using T = DqTiles<D>;
  static constexpr int kBoxes = T::W::kBoxes;
  static constexpr int kOwnTile = kBoxes * T::kOwnBox;
  static constexpr int kStreamTile = kBoxes * T::kStreamBox;
  static constexpr int kDo = kOwnTile;
  static constexpr int kRing = 2 * kOwnTile;  // stage st: K, then V
  static constexpr int kOut = kRing + T::kStages * 2 * kStreamTile;
  static constexpr int kRows = kOut + (T::kStagedOut ? 2 * kStreamTile : 0);  // lse, then delta
  static constexpr int kRowRegion = (2 * T::kLseBytes + 1023) / 1024 * 1024;
  static constexpr int kBars = kRows + (T::kRowsInSmem ? kRowRegion : 0);
  static constexpr int kBytes = kBars + 8 * (2 + 2 * T::kStages) + 8 + 1024;
  static_assert(kBytes <= 232448, "the opt-in shared-memory limit of a block");
};

// K3's tiles per head dim, 64-query streamed tiles at every D. At D 64 and
// 128 each warpgroup runs a tile's products, its scores and its dV and dK
// products in turn, on a two-stage ring, and dK and dV leave through shared
// memory and TMA stores. At D 16 and 32 the products are small and the exp
// unit bounds the kernel (one exp per visible pair): there a warpgroup runs
// tile i's scores while tile i - 1's dV and dK products are in flight
// (kPipelined; it holds two stages at once, so the ring has three), and dK
// and dV (16 or 32 columns) are written from registers.
template <int D>
struct DkvTiles {
  using W = Swizzle<D>;
  // Consumer warpgroups, 64 keys each: three at D 16 and 32, where a third
  // warp on each SM sub-partition hides more of the exps' latency; two
  // above, whose consumers hold two D 128 accumulators (128 registers).
  static constexpr int kConsumers = D < 64 ? 3 : 2;
  static constexpr int kOwnRows = 64 * kConsumers;  // keys a CTA owns
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                    kThreads * (65536 / kThreads / 8 * 8), "registers");
  static constexpr int kStream = 64;  // queries of a streamed tile
  static constexpr bool kPipelined = D < 64;
  static constexpr int kStages = kPipelined ? 3 : 2;  // depth of the streamed ring
  // At D 16 each consumer warpgroup holds its 64 keys of K and V in
  // registers (ldmatrix, once an owned tile; 8 registers), S^T and dP^T
  // take them as their register A operands, and the K/V buffer goes back to
  // the producer as soon as they are loaded. At D 32 (16 registers) the
  // three consumer warpgroups' 160 registers spill.
  static constexpr bool kOwnInRegs = D == 16;
  static constexpr bool kStagedOut = D >= 64;
  static constexpr int kOwnBox = kOwnRows * W::kRowBytes;    // one [kOwnRows rows][cols] box
  static constexpr int kStreamBox = kStream * W::kRowBytes;  // one [kStream rows][cols] box
  static constexpr int kLseBytes = kStream * 4;              // kStream fp32 lse or delta values
};

// Shared memory of K3: K and V of the owned tile, Q and dO of each stage,
// lse and delta of each stage, each warpgroup's dK and dV staging (D 64 and
// 128), then the mbarriers (K/V full and empty; full and empty per stage)
// and the tile slot.
template <int D>
struct DkvSmem {
  using T = DkvTiles<D>;
  static constexpr int kBoxes = T::W::kBoxes;
  static constexpr int kOwnTile = kBoxes * T::kOwnBox;
  static constexpr int kStreamTile = kBoxes * T::kStreamBox;
  static constexpr int kV = kOwnTile;
  static constexpr int kRing = 2 * kOwnTile;  // stage st: Q, then dO
  static constexpr int kRows = kRing + T::kStages * 2 * kStreamTile;  // stage st: lse, then delta
  static constexpr int kRowRegion = (T::kStages * 2 * T::kLseBytes + 1023) / 1024 * 1024;
  static constexpr int kOut = kRows + kRowRegion;
  static constexpr int kBars = kOut + (T::kStagedOut ? 4 * kStreamTile : 0);
  static constexpr int kBytes = kBars + 8 * (2 + 2 * T::kStages) + 8 + 1024;
  static_assert(kBytes <= 232448, "the opt-in shared-memory limit of a block");
};

// The owned tiles of a launch, numbered in chunks of heads whose streamed
// tensors fit in L2 together, so that the tiles sharing a head's K and V
// (K2) or Q and dO (K3) run at about the same time. Inside a chunk, causal
// K2 takes its last Q tiles first and K3 its first K tiles: those see the
// most streamed tiles. unpack gives owned tile o of head bh and the CTA's
// range [lo, hi] of streamed tiles: those either warpgroup sees
// (_n_kv_blocks / _k_index, _n_q_blocks / _q_index in the Pallas kernels).
template <bool kCausal, bool kQMajor, int kStreamRows, int kOwnRows>
struct Schedule {
  int n_own, n_stream, bh_count, chunk, total, window;
  __device__ Schedule(int S, int BH, int heads, int w)
      : n_own((S + kOwnRows - 1) / kOwnRows), n_stream((S + kStreamRows - 1) / kStreamRows),
        bh_count(BH), chunk(heads), total(BH * n_own), window(w) {}
  __device__ void unpack(int u, int& o, int& bh, int& lo, int& hi) const {
    const int first_head = u / (chunk * n_own) * chunk;
    const int heads = min(chunk, bh_count - first_head);
    const int w = u - first_head * n_own;
    bh = first_head + w % heads;
    o = kCausal && kQMajor ? n_own - 1 - w / heads : w / heads;
    lo = 0;
    hi = n_stream - 1;
    if (kCausal && kQMajor) {  // K tiles from the window's start to the diagonal
      hi = min((o * kOwnRows + kOwnRows - 1) / kStreamRows, n_stream - 1);
      const int first = o * kOwnRows - (window - 1);
      lo = window != 0 && first > 0 ? first / kStreamRows : 0;
    } else if (kCausal) {  // Q tiles from the diagonal to the window's end
      lo = o * kOwnRows / kStreamRows;
      if (window != 0) hi = min(hi, (o * kOwnRows + kOwnRows - 2 + window) / kStreamRows);
    }
  }
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int window) {
  return qpos >= kpos && (window == 0 || qpos - kpos < window);
}

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------

template <int D, bool kCausal>
__global__ void __launch_bounds__(DqTiles<D>::kThreads, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap do_map,
                  const __grid_constant__ CUtensorMap dq_map, const float* __restrict__ lse,
                  const float* __restrict__ delta, int* __restrict__ counters, int S, int BH,
                  int heads_per_chunk, int window, float scale, float scale2,
                  bf16* __restrict__ dq_out, const __grid_constant__ CUtensorMap lse_map,
                  const __grid_constant__ CUtensorMap delta_map) {
  using L = DqSmem<D>;
  using T = DqTiles<D>;
  using W = Swizzle<D>;
  constexpr int kSt = T::kStages, kOwnRows = T::kOwnRows;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sDo = base + L::kDo;
  auto sK = [&](int st) { return base + L::kRing + st * 2 * L::kStreamTile; };
  auto sV = [&](int st) { return sK(st) + L::kStreamTile; };
  const uint32_t full_q = base + L::kBars, empty_q = full_q + 8;
  auto full = [&](int st) { return full_q + 8 * (2 + st); };
  auto empty = [&](int st) { return full_q + 8 * (2 + kSt + st); };
  // The producer passes each tile's number (-1: none left) to the consumers
  // in this slot, written before the arrival on full_q that reports it.
  const uint32_t slot = full_q + 8 * (2 + 2 * kSt);
  volatile int* tile_slot = reinterpret_cast<volatile int*>(smem_raw + (slot - smem_u32(smem_raw)));
  const Schedule<kCausal, true, kStream, kOwnRows> sched(S, BH, heads_per_chunk, window);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 4 * T::kConsumers);  // one arrival per consumer warp
    for (int st = 0; st < kSt; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * T::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer: one thread issues every load ----------------
    // Per owned tile: Q and dO, then K and V of each streamed tile in order.
    // The ring's position `it` runs on across the CTA's tiles, so the next
    // tile's first K and V load while the consumers finish this one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;
      for (int r = 0;; ++r) {
        mbar_wait(empty_q, (r & 1) ^ 1);  // every consumer warpgroup is done with Q and dO
        const int u = atomicAdd(&counters[0], 1);
        *tile_slot = u < sched.total ? u : -1;
        if (u >= sched.total) {
          mbar_arrive(full_q);  // no load: wakes the consumers to stop
          // The last CTA to run out zeroes the counters for the next launch.
          if (atomicAdd(&counters[1], 1) == static_cast<int>(gridDim.x) - 1) {
            atomicExch(&counters[0], 0);
            atomicExch(&counters[1], 0);
          }
          break;
        }
        int i, bh, lo, hi;
        sched.unpack(u, i, bh, lo, hi);
        mbar_expect_tx(full_q, 2 * L::kOwnTile + (T::kRowsInSmem ? 2 * T::kLseBytes : 0));
        for (int b = 0; b < L::kBoxes; ++b) {
          tma_load(sQ + b * T::kOwnBox, &q_map, full_q, b * W::kCols, i * kOwnRows, bh);
          tma_load(sDo + b * T::kOwnBox, &do_map, full_q, b * W::kCols, i * kOwnRows, bh);
        }
        if constexpr (T::kRowsInSmem) {
          tma_load_2d(base + L::kRows, &lse_map, full_q, i * kOwnRows, bh);
          tma_load_2d(base + L::kRows + T::kLseBytes, &delta_map, full_q, i * kOwnRows, bh);
        }
        for (int n = it; n <= it + hi - lo; ++n) {
          const int st = n % kSt, row = (lo + n - it) * kStream;
          mbar_wait(empty(st), ((n / kSt) & 1) ^ 1);  // the first round passes
          mbar_expect_tx(full(st), 2 * L::kStreamTile);
          for (int b = 0; b < L::kBoxes; ++b) {
            tma_load(sK(st) + b * T::kStreamBox, &k_map, full(st), b * W::kCols, row, bh);
            tma_load(sV(st) + b * T::kStreamBox, &v_map, full(st), b * W::kCols, row, bh);
          }
        }
        it += hi - lo + 1;
      }
    }
  } else {
    // ---------------- consumers: 64 Q rows per warpgroup ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs));
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, lane = tid % 32, t = lane % 4;
    const int r_in = (tid / 32) * 16 + lane / 4;  // this thread's rows r_in and r_in + 8
    const uint32_t sQc = sQ + c * 64 * W::kRowBytes, sDoc = sDo + c * 64 * W::kRowBytes;
    const uint32_t sOut = base + L::kOut + c * L::kStreamTile;  // [boxes][64 rows][128 B]
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);  // this warp is done with the buffer
    };
    // This warpgroup's rows of Q and dO as register A fragments (kOwnInRegs).
    uint32_t qa[T::kOwnInRegs ? D / 16 : 1][4], oa[T::kOwnInRegs ? D / 16 : 1][4];

    int it = 0;
    for (int r = 0;; ++r) {
      mbar_wait(full_q, r & 1);
      const int u = *tile_slot;
      if (u < 0) break;
      int i, bh, lo, hi;
      sched.unpack(u, i, bh, lo, hi);
      // This warpgroup's rows and the K tiles they see: up to its own
      // diagonal, from its own window start; none for rows past S.
      const int row0 = i * kOwnRows + c * 64;
      int lo_c = lo, hi_c = hi;
      if (kCausal) {
        hi_c = min(hi, T::kConsumers * i + c);
        const int first = row0 - (window - 1);
        if (window != 0 && first > 0) lo_c = first / kStream;
      }
      if (row0 >= S) lo_c = hi + 1;
      float lse2[2] = {0.0f, 0.0f}, dl[2] = {0.0f, 0.0f};
      if (row0 < S) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (T::kRowsInSmem) {
            const float* rows = reinterpret_cast<const float*>(
                smem_raw + (base + L::kRows - smem_u32(smem_raw)));
            lse2[h] = rows[c * 64 + r_in + 8 * h] * kLog2e;
            dl[h] = rows[kOwnRows + c * 64 + r_in + 8 * h];
          } else {
            const size_t row = static_cast<size_t>(bh) * S + row0 + r_in + 8 * h;
            lse2[h] = lse[row] * kLog2e;
            dl[h] = delta[row];
          }
        }
      }
      float acc[D / 2];
#pragma unroll
      for (int x = 0; x < D / 2; ++x) acc[x] = 0.0f;

      if constexpr (T::kPipelined) {
        // Tile j's S and dP products are issued ahead of tile j - 1's dQ
        // product, in three commit groups: P is taken as soon as S is done,
        // dS once dP is, both while dQ's product runs. Tile j - 1's stage
        // goes back once its dQ product is done.
        const float nl[2] = {-lse2[0], -lse2[1]};
        const float nd[2] = {-dl[0] * scale, -dl[1] * scale};
        if constexpr (T::kOwnInRegs) {
          load_a_frags<D>(qa, sQc, tid);
          load_a_frags<D>(oa, sDoc, tid);
          release(empty_q);  // Q, dO, lse and delta are in registers: the next tile's may load
        }
        float s[kStream / 2], dp[kStream / 2];
        uint32_t da[kStream / 16][4];
        auto stage = [&](int j) { return (it + j - lo) % kSt; };
        auto phase = [&](int j) { return ((it + j - lo) / kSt) & 1; };
        // S = Q K_j^T and dP = dO V_j^T; the caller commits.
        auto issue_s = [&](int st) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint64_t kd = kmajor_desc<D>(sK(st) + k16_offset<D>(kk, T::kStreamBox));
            if constexpr (T::kOwnInRegs)
              wgmma_rs_k(s, qa[kk], kd, kk > 0);
            else
              wgmma_ss(s, kmajor_desc<D>(sQc + k16_offset<D>(kk, T::kOwnBox)), kd, kk > 0);
          }
        };
        auto issue_dp = [&](int st) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint64_t vd = kmajor_desc<D>(sV(st) + k16_offset<D>(kk, T::kStreamBox));
            if constexpr (T::kOwnInRegs)
              wgmma_rs_k(dp, oa[kk], vd, kk > 0);
            else
              wgmma_ss(dp, kmajor_desc<D>(sDoc + k16_offset<D>(kk, T::kOwnBox)), vd, kk > 0);
          }
        };
        auto issue_dq = [&](int st) {  // dQ += dS K_j, K_j MN-major
#pragma unroll
          for (int kt = 0; kt < kStream / 16; ++kt)
            wgmma_rs(acc, da[kt], mnmajor_desc<kStream, D>(sK(st) + kt * 16 * W::kRowBytes));
          wgmma_commit();
        };
        // The mask where a key of tile j follows one of this warpgroup's
        // rows (the diagonal) or lies a window or more before one.
        auto masked = [&](int j) {
          return kCausal &&
                 (j * kStream == row0 || (window != 0 && row0 + 63 - j * kStream >= window));
        };
        // P in place over s: one FFMA and one exp2 a score against -lse log2e.
        auto probs = [&]() {
#pragma unroll
          for (int x = 0; x < kStream / 2; ++x)
            s[x] = fast_exp2(fmaf(s[x], scale2, nl[(x >> 1) & 1]));
        };
        // dS in place over dp, from -delta scale; then the mask, a pass of
        // its own that only masked tiles run.
        auto grads = [&](int j) {
#pragma unroll
          for (int x = 0; x < kStream / 2; ++x)
            dp[x] = s[x] * fmaf(dp[x], scale, nd[(x >> 1) & 1]);
          if (masked(j)) {
#pragma unroll
            for (int nn = 0; nn < kStream / 8; ++nn)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (!visible(row0 + r_in + 8 * (e >> 1), j * kStream + 8 * nn + 2 * t + (e & 1),
                             window))
                  dp[4 * nn + e] = 0.0f;
          }
        };
        // A tile above this warpgroup's diagonal or before its window:
        // waited on, then handed straight back.
        auto skip = [&](int j) {
          mbar_wait(full(stage(j)), phase(j));
          release(empty(stage(j)));
          if (!T::kOwnInRegs && j == hi) release(empty_q);
        };

        for (int j = lo; j <= min(lo_c - 1, hi); ++j) skip(j);
        if (lo_c <= hi_c) {
          mbar_wait(full(stage(lo_c)), phase(lo_c));
          fence_regs(acc);
          wgmma_fence();
          issue_s(stage(lo_c));
          wgmma_commit();
          issue_dp(stage(lo_c));
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(s);
          probs();
          wgmma_wait<0>();
          fence_regs(dp);
          if (!T::kOwnInRegs && lo_c == hi) release(empty_q);  // the next Q and dO may load
          grads(lo_c);
          to_a(da, dp);
          for (int j = lo_c + 1; j <= hi_c; ++j) {
            mbar_wait(full(stage(j)), phase(j));
            fence_regs(acc);
            fence_regs(da);
            wgmma_fence();
            issue_s(stage(j));
            wgmma_commit();
            issue_dp(stage(j));
            wgmma_commit();
            issue_dq(stage(j - 1));
            wgmma_wait<2>();  // tile j's S is done
            fence_regs(s);
            probs();
            wgmma_wait<1>();  // and its dP
            fence_regs(dp);
            if (!T::kOwnInRegs && j == hi) release(empty_q);
            grads(j);
            wgmma_wait<0>();  // tile j - 1's dQ product is done
            fence_regs(acc);
            fence_regs(da);
            release(empty(stage(j - 1)));
            to_a(da, dp);
          }
          fence_regs(acc);
          fence_regs(da);
          wgmma_fence();
          issue_dq(stage(hi_c));
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(da);
          release(empty(stage(hi_c)));
        }
        for (int j = max(lo_c, hi_c + 1); j <= hi; ++j) skip(j);
      } else {
        for (int j = lo, n = it; j <= hi; ++j, ++n) {
          const int st = n % kSt;
          mbar_wait(full(st), (n / kSt) & 1);
          if (j < lo_c || j > hi_c) {  // above this warpgroup's diagonal or outside its window
            release(empty(st));
            if (j == hi) release(empty_q);
            continue;
          }
          float s[32], dp[32];
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t own = (kk / 4) * T::kOwnBox + (kk % 4) * 32;
            const uint32_t str = (kk / 4) * T::kStreamBox + (kk % 4) * 32;
            wgmma_ss(s, kmajor_desc<D>(sQc + own), kmajor_desc<D>(sK(st) + str), kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t own = (kk / 4) * T::kOwnBox + (kk % 4) * 32;
            const uint32_t str = (kk / 4) * T::kStreamBox + (kk % 4) * 32;
            wgmma_ss(dp, kmajor_desc<D>(sDoc + own), kmajor_desc<D>(sV(st) + str), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);
          if (j == hi) release(empty_q);  // the next tile's Q and dO may load
          // dS = P (dP - delta) scale in place over s; the mask only on the
          // diagonal tile and the tiles that cross the window's edge.
          const bool masked = kCausal && (j == T::kConsumers * i + c ||
                                          (window != 0 && row0 + 63 - j * kStream >= window));
#pragma unroll
          for (int nn = 0; nn < 8; ++nn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int x = 4 * nn + e, h = e >> 1;
              float p = fast_exp2(fmaf(s[x], scale2, -lse2[h]));
              if (masked &&
                  !visible(row0 + r_in + 8 * h, j * kStream + 8 * nn + 2 * t + (e & 1), window))
                p = 0.0f;
              s[x] = p * (dp[x] - dl[h]) * scale;
            }
          uint32_t da[4][4];
          to_a(da, s);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kt = 0; kt < 4; ++kt)
            wgmma_rs(acc, da[kt], mnmajor_desc<kStream, D>(sK(st) + kt * 16 * W::kRowBytes));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(da);
          release(empty(st));
        }
      }
      it += hi - lo + 1;

      if (row0 < S) {
        if constexpr (T::kStagedOut) {
          // dQ through shared memory and one TMA store per box; the store
          // runs on while the next tile starts.
          if (tid == 0) tma_store_wait_read();  // the previous tile's store is out
          warpgroup_sync(kOutBar + c);
          stage_rows<D>(sOut, acc, tid);
          fence_async_shared();
          warpgroup_sync(kOutBar + c);
          if (tid == 0)
            for (int b = 0; b < L::kBoxes; ++b)
              tma_store(&dq_map, sOut + b * T::kStreamBox, b * kBoxCols, row0, bh);
        } else {
          // dQ from registers: this thread's bf16 pairs of rows row0 + r_in
          // and + 8 (S is a multiple of 64: none past S).
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store_row<D>(dq_out + (static_cast<size_t>(bh) * S + row0 + r_in + 8 * h) * D, acc,
                         h, 1.0f, t);
        }
      }
    }
    if constexpr (T::kStagedOut)
      if (tid == 0) tma_store_wait_read();  // shared memory outlives the last store's reads
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV
// ---------------------------------------------------------------------------

template <int D, bool kCausal>
__global__ void __launch_bounds__(DkvTiles<D>::kThreads, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const __grid_constant__ CUtensorMap lse_map,
                   const __grid_constant__ CUtensorMap delta_map,
                   const __grid_constant__ CUtensorMap dk_map,
                   const __grid_constant__ CUtensorMap dv_map, bf16* __restrict__ dk_out,
                   bf16* __restrict__ dv_out, int* __restrict__ counters, int S, int BH,
                   int heads_per_chunk, int window, float scale, float scale2) {
  using L = DkvSmem<D>;
  using T = DkvTiles<D>;
  using W = Swizzle<D>;
  constexpr int kS = T::kStream, kSt = T::kStages, kOwnRows = T::kOwnRows;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + L::kV;
  auto sQ = [&](int st) { return base + L::kRing + st * 2 * L::kStreamTile; };
  auto sDo = [&](int st) { return sQ(st) + L::kStreamTile; };
  auto sLse = [&](int st) { return base + L::kRows + st * 2 * T::kLseBytes; };
  auto sDelta = [&](int st) { return sLse(st) + T::kLseBytes; };
  const uint32_t full_kv = base + L::kBars, empty_kv = full_kv + 8;
  auto full = [&](int st) { return full_kv + 8 * (2 + st); };
  auto empty = [&](int st) { return full_kv + 8 * (2 + kSt + st); };
  const uint32_t slot = full_kv + 8 * (2 + 2 * kSt);
  volatile int* tile_slot = reinterpret_cast<volatile int*>(smem_raw + (slot - smem_u32(smem_raw)));
  auto smem_f32 = [&](uint32_t a) {
    return reinterpret_cast<const float*>(smem_raw + (a - smem_u32(smem_raw)));
  };
  const Schedule<kCausal, false, kS, kOwnRows> sched(S, BH, heads_per_chunk, window);

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, 4 * T::kConsumers);  // one arrival per consumer warp
    for (int st = 0; st < kSt; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * T::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer: one thread issues every load ----------------
    // Per owned tile: K and V, then Q, dO, lse and delta of each streamed
    // tile in order, on one full barrier per stage.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;
      for (int r = 0;; ++r) {
        mbar_wait(empty_kv, (r & 1) ^ 1);  // every consumer warpgroup is done with K and V
        const int u = atomicAdd(&counters[0], 1);
        *tile_slot = u < sched.total ? u : -1;
        if (u >= sched.total) {
          mbar_arrive(full_kv);
          if (atomicAdd(&counters[1], 1) == static_cast<int>(gridDim.x) - 1) {
            atomicExch(&counters[0], 0);
            atomicExch(&counters[1], 0);
          }
          break;
        }
        int j, bh, lo, hi;
        sched.unpack(u, j, bh, lo, hi);
        mbar_expect_tx(full_kv, 2 * L::kOwnTile);
        for (int b = 0; b < L::kBoxes; ++b) {
          tma_load(sK + b * T::kOwnBox, &k_map, full_kv, b * W::kCols, j * kOwnRows, bh);
          tma_load(sV + b * T::kOwnBox, &v_map, full_kv, b * W::kCols, j * kOwnRows, bh);
        }
        for (int n = it; n <= it + hi - lo; ++n) {
          const int st = n % kSt, row = (lo + n - it) * kS;
          mbar_wait(empty(st), ((n / kSt) & 1) ^ 1);
          mbar_expect_tx(full(st), 2 * L::kStreamTile + 2 * T::kLseBytes);
          for (int b = 0; b < L::kBoxes; ++b) {
            tma_load(sQ(st) + b * T::kStreamBox, &q_map, full(st), b * W::kCols, row, bh);
            tma_load(sDo(st) + b * T::kStreamBox, &do_map, full(st), b * W::kCols, row, bh);
          }
          tma_load_2d(sLse(st), &lse_map, full(st), row, bh);
          tma_load_2d(sDelta(st), &delta_map, full(st), row, bh);
        }
        it += hi - lo + 1;
      }
    }
  } else {
    // ---------------- consumers: 64 keys per warpgroup ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs));
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, lane = tid % 32, t = lane % 4;
    const int r_in = (tid / 32) * 16 + lane / 4;  // this thread's keys r_in and r_in + 8
    const uint32_t sKc = sK + c * 64 * W::kRowBytes, sVc = sV + c * 64 * W::kRowBytes;
    const uint32_t sOutK = base + L::kOut + c * 2 * L::kStreamTile;
    const uint32_t sOutV = sOutK + L::kStreamTile;
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    // This warpgroup's keys of K and V as register A fragments (kOwnInRegs).
    uint32_t ka[T::kOwnInRegs ? D / 16 : 1][4], va[T::kOwnInRegs ? D / 16 : 1][4];

    int it = 0;
    for (int r = 0;; ++r) {
      mbar_wait(full_kv, r & 1);
      const int u = *tile_slot;
      if (u < 0) break;
      int j, bh, lo, hi;
      sched.unpack(u, j, bh, lo, hi);
      // This warpgroup's keys and the Q tiles that see them: from its own
      // diagonal to its own window's end; none for keys past S.
      const int key0 = j * kOwnRows + c * 64;
      int lo_c = lo, hi_c = hi;
      if (kCausal) {
        lo_c = key0 / kS;
        if (window != 0) hi_c = min(hi, (key0 + 62 + window) / kS);
      }
      if (key0 >= S) lo_c = hi + 1;
      if constexpr (T::kOwnInRegs) {
        load_a_frags<D>(ka, sKc, tid);
        load_a_frags<D>(va, sVc, tid);
        release(empty_kv);  // K and V are in registers: the next tile's may load
      }
      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.0f;
      // Transposed tiles, rows = this warpgroup's keys, columns = the
      // queries of Q tile i: P^T and dS^T are then the A operands of dV
      // and dK untransposed.
      float s[kS / 2], dp[kS / 2];
      uint32_t pa[kS / 16][4], da[kS / 16][4];
      auto stage = [&](int i) { return (it + i - lo) % kSt; };
      auto phase = [&](int i) { return ((it + i - lo) / kSt) & 1; };
      // S^T = K Q_i^T and dP^T = V dO_i^T; the caller commits.
      auto issue_s = [&](int st) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint64_t q = kmajor_desc<D>(sQ(st) + k16_offset<D>(kk, T::kStreamBox));
          if constexpr (T::kOwnInRegs)
            wgmma_rs_k(s, ka[kk], q, kk > 0);
          else
            wgmma_ss(s, kmajor_desc<D>(sKc + k16_offset<D>(kk, T::kOwnBox)), q, kk > 0);
        }
      };
      auto issue_dp = [&](int st) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint64_t o = kmajor_desc<D>(sDo(st) + k16_offset<D>(kk, T::kStreamBox));
          if constexpr (T::kOwnInRegs)
            wgmma_rs_k(dp, va[kk], o, kk > 0);
          else
            wgmma_ss(dp, kmajor_desc<D>(sVc + k16_offset<D>(kk, T::kOwnBox)), o, kk > 0);
        }
      };
      auto issue_dkv = [&](int st) {  // dV += P^T dO_i, dK += dS^T Q_i
#pragma unroll
        for (int kt = 0; kt < kS / 16; ++kt)
          wgmma_rs(dv, pa[kt], mnmajor_desc<kS, D>(sDo(st) + kt * 16 * W::kRowBytes));
#pragma unroll
        for (int kt = 0; kt < kS / 16; ++kt)
          wgmma_rs(dk, da[kt], mnmajor_desc<kS, D>(sQ(st) + kt * 16 * W::kRowBytes));
        wgmma_commit();
      };
      // The mask where a query of tile i precedes one of this warpgroup's
      // keys (the diagonal) or lies a window or more past one.
      auto masked = [&](int i) {
        return kCausal &&
               (i * kS < key0 + 63 || (window != 0 && i * kS + kS - 1 - key0 >= window));
      };
      // lse and delta belong to the query, the column: this thread's columns
      // are 8 nn + 2 t and 8 nn + 2 t + 1.
      // D 16 and 32: P^T in place over s, one FFMA and one exp2 a score
      // against -lse log2e, taken once a column.
      auto probs = [&](int st) {
        const float* ls = smem_f32(sLse(st));
#pragma unroll
        for (int nn = 0; nn < kS / 8; ++nn) {
          const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * nn + 2 * t);
          const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * nn + e] = fast_exp2(fmaf(s[4 * nn + e], scale2, nl[e & 1]));
        }
      };
      // D 16 and 32: dS^T in place over dp, from -delta scale taken once a
      // column; then the mask, a pass of its own that only masked tiles run.
      auto grads = [&](int i, int st) {
        const float* dls = smem_f32(sDelta(st));
#pragma unroll
        for (int nn = 0; nn < kS / 8; ++nn) {
          const float2 d2 = *reinterpret_cast<const float2*>(dls + 8 * nn + 2 * t);
          const float nd[2] = {-d2.x * scale, -d2.y * scale};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * nn + e] = s[4 * nn + e] * fmaf(dp[4 * nn + e], scale, nd[e & 1]);
        }
        if (masked(i)) {
#pragma unroll
          for (int nn = 0; nn < kS / 8; ++nn)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!visible(i * kS + 8 * nn + 2 * t + (e & 1), key0 + r_in + 8 * (e >> 1), window))
                s[4 * nn + e] = dp[4 * nn + e] = 0.0f;
        }
      };
      // D 64 and 128: P^T and dS^T in place over s and dp, in one pass.
      auto scores = [&](int i, int st) {
        const float* ls = smem_f32(sLse(st));
        const float* dls = smem_f32(sDelta(st));
        const bool mask = masked(i);
#pragma unroll
        for (int nn = 0; nn < kS / 8; ++nn) {
          const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * nn + 2 * t);
          const float2 d2 = *reinterpret_cast<const float2*>(dls + 8 * nn + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * nn + e;
            const float lv = (e & 1) ? l2.y : l2.x, dlt = (e & 1) ? d2.y : d2.x;
            float p = fast_exp2(fmaf(s[x], scale2, -lv * kLog2e));
            const int qpos = i * kS + 8 * nn + 2 * t + (e & 1);
            if (mask && !visible(qpos, key0 + r_in + 8 * (e >> 1), window)) p = 0.0f;
            s[x] = p;
            dp[x] = p * (dp[x] - dlt) * scale;
          }
        }
      };
      // A tile below this warpgroup's diagonal or past its window: waited
      // on, then handed straight back.
      auto skip = [&](int i) {
        mbar_wait(full(stage(i)), phase(i));
        release(empty(stage(i)));
        if (!T::kOwnInRegs && i == hi) release(empty_kv);
      };

      if constexpr (T::kPipelined) {
        // Tile i's S^T and dP^T products are issued with tile i - 1's dV and
        // dK products, in three commit groups: P^T is taken as soon as S^T is
        // done, dS^T once dP^T is, both while the dV and dK products run.
        // Tile i - 1's stage goes back once its dV and dK products are done.
        for (int i = lo; i <= min(lo_c - 1, hi); ++i) skip(i);
        if (lo_c <= hi_c) {
          mbar_wait(full(stage(lo_c)), phase(lo_c));
          fence_regs(dk);
          fence_regs(dv);
          wgmma_fence();
          issue_s(stage(lo_c));
          wgmma_commit();
          issue_dp(stage(lo_c));
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(s);
          probs(stage(lo_c));
          wgmma_wait<0>();
          fence_regs(dp);
          if (!T::kOwnInRegs && lo_c == hi) release(empty_kv);  // the next K and V may load
          grads(lo_c, stage(lo_c));
          to_a(pa, s);
          to_a(da, dp);
          for (int i = lo_c + 1; i <= hi_c; ++i) {
            mbar_wait(full(stage(i)), phase(i));
            fence_regs(dk);
            fence_regs(dv);
            fence_regs(pa);
            fence_regs(da);
            wgmma_fence();
            issue_s(stage(i));
            wgmma_commit();
            issue_dp(stage(i));
            wgmma_commit();
            issue_dkv(stage(i - 1));
            wgmma_wait<2>();  // tile i's S^T is done
            fence_regs(s);
            probs(stage(i));
            wgmma_wait<1>();  // and its dP^T
            fence_regs(dp);
            if (!T::kOwnInRegs && i == hi) release(empty_kv);
            grads(i, stage(i));
            wgmma_wait<0>();  // tile i - 1's dV and dK are done
            fence_regs(dk);
            fence_regs(dv);
            fence_regs(pa);
            fence_regs(da);
            release(empty(stage(i - 1)));
            to_a(pa, s);
            to_a(da, dp);
          }
          fence_regs(dk);
          fence_regs(dv);
          fence_regs(pa);
          fence_regs(da);
          wgmma_fence();
          issue_dkv(stage(hi_c));
          wgmma_wait<0>();
          fence_regs(dk);
          fence_regs(dv);
          fence_regs(pa);
          fence_regs(da);
          release(empty(stage(hi_c)));
        }
        for (int i = max(lo_c, hi_c + 1); i <= hi; ++i) skip(i);
      } else {
        for (int i = lo; i <= hi; ++i) {
          if (i < lo_c || i > hi_c) {  // below this warpgroup's diagonal or past its window
            skip(i);
            continue;
          }
          const int st = stage(i);
          mbar_wait(full(st), phase(i));
          fence_regs(dk);
          fence_regs(dv);
          wgmma_fence();
          issue_s(st);
          issue_dp(st);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);
          if (!T::kOwnInRegs && i == hi) release(empty_kv);  // the next K and V may load
          scores(i, st);
          to_a(pa, s);
          to_a(da, dp);
          fence_regs(dk);
          fence_regs(dv);
          wgmma_fence();
          issue_dkv(st);
          wgmma_wait<0>();
          fence_regs(dk);
          fence_regs(dv);
          fence_regs(pa);
          fence_regs(da);
          release(empty(st));
        }
      }
      it += hi - lo + 1;

      if (key0 < S) {
        if constexpr (T::kStagedOut) {
          if (tid == 0) tma_store_wait_read();
          warpgroup_sync(kOutBar + c);
          stage_rows<D>(sOutK, dk, tid);
          stage_rows<D>(sOutV, dv, tid);
          fence_async_shared();
          warpgroup_sync(kOutBar + c);
          if (tid == 0)
            for (int b = 0; b < L::kBoxes; ++b) {
              tma_store(&dk_map, sOutK + b * T::kStreamBox, b * kBoxCols, key0, bh);
              tma_store(&dv_map, sOutV + b * T::kStreamBox, b * kBoxCols, key0, bh);
            }
        } else {
          // dK and dV from registers: this thread's bf16 pairs of keys
          // key0 + r_in and + 8 (S is a multiple of 64: none past S).
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t row = (static_cast<size_t>(bh) * S + key0 + r_in + 8 * h) * D;
            store_row<D>(dk_out + row, dk, h, 1.0f, t);
            store_row<D>(dv_out + row, dv, h, 1.0f, t);
          }
        }
      }
    }
    if constexpr (T::kStagedOut)
      if (tid == 0) tma_store_wait_read();
  }
}

// --- host side -----------------------------------------------------------------

template <int D, bool kCausal>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int* counters, int bh, int s, int window,
              cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  using T = DqTiles<D>;
  CUtensorMap qm, km, vm, dom, dqm{}, lm{}, dlm{};
  if (!make_map(&qm, fn, q, bh, s, D, T::kOwnRows) ||
      !make_map(&dom, fn, dout, bh, s, D, T::kOwnRows) ||
      !make_map(&km, fn, k, bh, s, D, kStream) || !make_map(&vm, fn, v, bh, s, D, kStream) ||
      (T::kStagedOut && !make_map(&dqm, fn, dq, bh, s, D, kStream)) ||
      (T::kRowsInSmem && (!make_row_map(&lm, fn, lse, bh, s, T::kOwnRows) ||
                          !make_row_map(&dlm, fn, delta, bh, s, T::kOwnRows))))
    return kErrEncode;
  int ctas = 0;
  const cudaError_t e = persistent_grid(flash_bwd_dq_sm90<D, kCausal>, DqSmem<D>::kBytes,
                                        bh * ((s + T::kOwnRows - 1) / T::kOwnRows), &ctas);
  if (e != cudaSuccess) return e;
  const float scale = softmax_scale(D);
  flash_bwd_dq_sm90<D, kCausal><<<ctas, T::kThreads, DqSmem<D>::kBytes, stream>>>(
      qm, km, vm, dom, dqm, static_cast<const float*>(lse), static_cast<const float*>(delta),
      counters, s, bh, heads_per_chunk(bh, s, D, 4), window, scale, scale * kLog2e,
      static_cast<bf16*>(dq), lm, dlm);
  return cudaGetLastError();
}

template <int D, bool kCausal>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int* counters, int bh, int s, int window,
               cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  using T = DkvTiles<D>;
  CUtensorMap qm, km, vm, dom, lm, dlm, dkm{}, dvm{};
  if (!make_map(&km, fn, k, bh, s, D, T::kOwnRows) ||
      !make_map(&vm, fn, v, bh, s, D, T::kOwnRows) ||
      !make_map(&qm, fn, q, bh, s, D, T::kStream) ||
      !make_map(&dom, fn, dout, bh, s, D, T::kStream) ||
      !make_row_map(&lm, fn, lse, bh, s, T::kStream) ||
      !make_row_map(&dlm, fn, delta, bh, s, T::kStream) ||
      (T::kStagedOut && (!make_map(&dkm, fn, dk, bh, s, D, kStream) ||
                         !make_map(&dvm, fn, dv, bh, s, D, kStream))))
    return kErrEncode;
  int ctas = 0;
  const cudaError_t e = persistent_grid(flash_bwd_dkv_sm90<D, kCausal>, DkvSmem<D>::kBytes,
                                        bh * ((s + T::kOwnRows - 1) / T::kOwnRows), &ctas);
  if (e != cudaSuccess) return e;
  const float scale = softmax_scale(D);
  flash_bwd_dkv_sm90<D, kCausal><<<ctas, T::kThreads, DkvSmem<D>::kBytes, stream>>>(
      qm, km, vm, dom, lm, dlm, dkm, dvm, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      counters, s, bh, heads_per_chunk(bh, s, D, 4), window, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq, dk, dv: [bh, s, d] bf16, contiguous, 16-byte aligned;
// lse, delta [bh, s] fp32, 16-byte aligned; s a multiple of 64. counters:
// two ints per kernel, zero before the first launch and left zero by every
// launch that completes; launches that share them must be ordered (one
// stream). d is 16, 32, 64 or 128; the caller (flash_attention.cu) has
// checked the shape. Each returns the cudaError_t of the launch, or a negative code for
// a tensor-map failure.
extern "C" int tpe_flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, void* counters, int bh, int s, int d, int window,
                                     int causal, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int* ctr = static_cast<int*>(counters);
  if (d == 16)
    return causal ? launch_dq<16, true>(q, k, v, dout, lse, delta, dq, ctr, bh, s, window, st)
                  : launch_dq<16, false>(q, k, v, dout, lse, delta, dq, ctr, bh, s, window, st);
  if (d == 32)
    return causal ? launch_dq<32, true>(q, k, v, dout, lse, delta, dq, ctr, bh, s, window, st)
                  : launch_dq<32, false>(q, k, v, dout, lse, delta, dq, ctr, bh, s, window, st);
  if (d == 64)
    return causal ? launch_dq<64, true>(q, k, v, dout, lse, delta, dq, ctr, bh, s, window, st)
                  : launch_dq<64, false>(q, k, v, dout, lse, delta, dq, ctr, bh, s, window, st);
  if (d == 128)
    return causal ? launch_dq<128, true>(q, k, v, dout, lse, delta, dq, ctr, bh, s, window, st)
                  : launch_dq<128, false>(q, k, v, dout, lse, delta, dq, ctr, bh, s, window, st);
  return cudaErrorInvalidValue;
}

extern "C" int tpe_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, void* counters, int bh, int s, int d,
                                      int window, int causal, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int* ctr = static_cast<int*>(counters);
  if (d == 16)
    return causal
               ? launch_dkv<16, true>(q, k, v, dout, lse, delta, dk, dv, ctr, bh, s, window, st)
               : launch_dkv<16, false>(q, k, v, dout, lse, delta, dk, dv, ctr, bh, s, window, st);
  if (d == 32)
    return causal
               ? launch_dkv<32, true>(q, k, v, dout, lse, delta, dk, dv, ctr, bh, s, window, st)
               : launch_dkv<32, false>(q, k, v, dout, lse, delta, dk, dv, ctr, bh, s, window, st);
  if (d == 64)
    return causal
               ? launch_dkv<64, true>(q, k, v, dout, lse, delta, dk, dv, ctr, bh, s, window, st)
               : launch_dkv<64, false>(q, k, v, dout, lse, delta, dk, dv, ctr, bh, s, window, st);
  if (d == 128)
    return causal
               ? launch_dkv<128, true>(q, k, v, dout, lse, delta, dk, dv, ctr, bh, s, window, st)
               : launch_dkv<128, false>(q, k, v, dout, lse, delta, dk, dv, ctr, bh, s, window, st);
  return cudaErrorInvalidValue;
}
