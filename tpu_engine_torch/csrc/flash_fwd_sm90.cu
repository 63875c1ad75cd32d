// K1 for Hopper (sm_90a): the bf16 flash-attention forward at head dims 16,
// 32, 64, 128 and 256, causal (optionally sliding-window) and non-causal,
// built on TMA, wgmma and warp specialisation. tpe_flash_fwd
// (flash_attention.cu) sends every bf16 call here and nowhere else; fp32
// goes to flash_f32_tc.cu. The helpers it shares with K2 and K3
// (flash_bwd_sm90.cu, flash_bwd_dkv_d256_sm90.cu) are in sm90.cuh.
//
// It replaces _fwd_kernel (tpu_engine/ops/_flash_pallas.py:117, launched by
// _flash_fwd through pl.pallas_call). Per (bh, row) it computes
// o = softmax(q k^T D^-1/2) v in bf16 and lse in fp32 (natural log), with
// the Pallas kernel's base-2 online softmax and its running-max floor -1e6.
//
// Bound: tensor-core operations. It does 2 products of the visible (q, k)
// pairs x D: at the training shape (BH 64, S 2048, D 128, causal) 6.9e10
// FLOP, 69.5 us at 989 TFLOP/s, against about 40 us to move q, k, v, o and
// lse once; at gemma-2b's (BH 32, S 2048, D 256, causal) the same 6.9e10
// FLOP against about 20 us. Only wgmma reaches that rate: mma.sync fed by
// ldmatrix stalls on shared-memory reads and on the copies its own warps
// issue.
//
// What the design does about it:
// - Work: one 128-row Q tile of one head at a time, with the K tiles it
//   sees. Persistent CTAs, one per SM, take tiles from a counter in device
//   memory, longest first, in chunks of heads whose q, k and v fit in L2
//   together (so a head's K and V are read from HBM about once).
// - Roles: 384 threads, three warpgroups. The producer warpgroup gives up
//   registers (setmaxnreg.dec); one of its threads issues every TMA load:
//   the Q tile, then K and V tiles into two-stage rings, with a full and an
//   empty mbarrier per buffer (K and V apart, so S = Q K^T can start before
//   V lands). It loads the next tile's Q and K while the consumers finish
//   the current one. The two consumer warpgroups take the registers
//   (setmaxnreg.inc) and own 64 Q rows each; they issue no copy and no
//   __syncthreads.
// - TMA: q, k, v and o are 3-D tensor maps [BH, S, D], so rows past S in a
//   ragged last tile read as zeros, are never taken from the next head, and
//   are never written. A box is [rows][64 columns] with the 128-byte
//   swizzle, so a D 128 tile is two boxes and a D 256 tile four. The maps
//   are __grid_constant__ parameters, encoded on each call by
//   cuTensorMapEncodeTiled, which is looked up with cudaGetDriverEntryPoint:
//   the library needs no link against libcuda.
// - wgmma: S = Q K^T has both operands K-major in shared memory. O += P V
//   takes P from registers: the fp32 S accumulator rounded pairwise to bf16
//   is the A operand, since the accumulator and the A fragment share one
//   layout; V is the B operand, MN-major, read with the transpose bit. Each
//   iteration issues S of K tile j and P V of tile j - 1 together and runs
//   tile j's softmax while P V is in flight; the two warpgroups take turns
//   at issuing (named barriers), so one's softmax overlaps the other's
//   products. A buffer goes back to the producer only after the product
//   that read it has completed.
// - Softmax in registers, base 2, one FMA and one exp2 per score; the row
//   max is reduced over the four lanes that share an accumulator row. Only
//   the tiles that cross a warpgroup's diagonal or window edge, and a ragged
//   last K tile (zero-filled keys score 0, not -inf), evaluate the mask, and
//   no tile above the diagonal or outside the window is visited.
//
// At D 16 and 32 the bound is not the tensor cores but the exp unit: one
// exp2 per visible pair at 16 a clock per SM (3.87e12 a second on the
// H100 SXM) takes twice as long as the products at D 32 and four times at
// D 16 (chip_smoke.kernel_bounds). The design is the D 64/128 one with
// what serves the exps: a tile is one box of [rows][D] in the 64- or
// 32-byte swizzle (Swizzle<D>, sm90.cuh); 128-key tiles give 64
// independent scores a thread a tile; the row max and row sum run in four
// partial chains a row (Tiles<D>::kChains) instead of one; one FFMA and
// one ex2.approx a score; o leaves from registers; and the two consumer
// warpgroups take turns at the softmax (kSoftmaxTurns), not at issuing the
// products, which are short at these D. Measured on an H100 against it
// (kernel_ab.py's VARIANTS): turns at the issue, at the exps alone or
// none; three consumer warpgroups (192-row Q tiles mask 11 % more causal
// scores); 64- or 192-key tiles; a three-stage ring; one chain; Q held in
// registers; and S of the next tile issued before the softmax with two S
// accumulators (ptxas serialised its wgmma, C7513): all slower or within
// noise.
//
// Tiles per head dim (Tiles<D>), set by registers and shared memory:
// - D 64 and 128: 128-key tiles (S of tile j is m64n128, 64 registers beside
//   O's 32 or 64), producer 40 registers, consumers 232. Epilogue:
//   o = acc / l in bf16, staged in shared memory and written by a TMA store
//   that runs on while the next tile starts.
// - D 256: O is a [64, 256] fp32 accumulator, 128 registers a thread. With
//   128-key tiles S (64), the P fragments in flight (32) and O would not fit
//   in a consumer's 255. So K and V tiles are 80 keys, as in
//   FlashAttention-3's published hdim-256 forward: S of tile j is m64n80 (40
//   registers) and P of tile j - 1 20, about 200 with the row state, inside
//   the 240 the consumers take (producer 24: 128 x 24 + 256 x 240 =
//   384 x 168). O += P V is one m64n256 product per 16 keys. Shared memory
//   bounds the tile: Q [128, 256] is 64 KB and two stages of 80-key K and V
//   160 KB, 230,488 bytes with the barriers and the alignment (96 keys would
//   need 256 KB); 80 keys take a fifth fewer, longer iterations than 64, and
//   at S 2048 the last tile is ragged (48 keys, masked). An o staging tile
//   (64 KB) no longer fits, and staging o in the Q tile would hold the next
//   tile's Q load until the store has read it. So o leaves from registers:
//   each thread writes its two rows' bf16 pairs straight to global memory
//   (rows past S are skipped), and Q goes back to the producer after the
//   tile's last S product, as at D 128. A key tile may lie wholly past the
//   diagonal for the first warpgroup's rows: it computes that tile masked to
//   zero rather than break the two warpgroups' turns.

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kM2Floor = -1e6f;  // running-max floor (base-2 units)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Tiles {
  // Consumer warpgroups, 64 Q rows each: three at D 16 and 32, where the
  // exps are the work and a third warp on each SM sub-partition hides more
  // of their latency; two above.
  static constexpr int kConsumers = 2;
  static constexpr int kBlockM = 64 * kConsumers;        // Q rows of a CTA
  static constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer warpgroup
  static constexpr int kBlockN = D > 128 ? 80 : 128;   // keys of a K/V tile: the n of S
  static constexpr int kProducerRegs = kConsumers == 3 || D > 128 ? 24 : 40;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : D > 128 ? 240 : 232;
  static constexpr int kStages = 2;  // depth of the K/V ring
  // The consumer warpgroups take turns (named barriers). At D 64 and up the
  // turns are at issuing the products, so that one's softmax overlaps the
  // other's products. At D 16 and 32 the products are short and the
  // softmax long: the turns are at the softmax, so that the exp unit serves
  // one warpgroup at a time while the other's products and waits fall in
  // between.
  static constexpr bool kTurns = true;
  static constexpr bool kSoftmaxTurns = D < 64;
  // o through shared memory and a TMA store (D 64 and 128), else from registers.
  static constexpr bool kStagedOut = D == 64 || D == 128;
  // Partial row maxima and sums a thread keeps per row: at D 16 and 32 the
  // softmax is the kernel's work, and one chain of fmax or add per row
  // would serialise it.
  static constexpr int kChains = D < 64 ? 4 : 1;
  // setmaxnreg moves registers between the warpgroups within what the
  // launch allocates (65536 / kThreads a thread, in steps of 8).
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                    kThreads * (65536 / kThreads / 8 * 8), "registers");
  static_assert(!kStagedOut || kConsumers == 2, "named barriers 3 and 4 stage o");
};

// Shared memory, in bytes from a 1024-byte-aligned base (the 128-byte
// swizzle repeats every 1024 bytes, and the wgmma descriptors assume it):
// the Q tile, then K and V of each stage, the o tile staged for its TMA
// store (D 64 and 128), then the mbarriers (Q full and empty; K and V full
// and empty, one per stage) and the tile slot.
template <int D>
struct Smem {
  using W = Swizzle<D>;
  static constexpr int kBoxes = W::kBoxes;
  static constexpr int kQBox = Tiles<D>::kBlockM * W::kRowBytes;    // one [Q rows][cols] box
  static constexpr int kKvBox = Tiles<D>::kBlockN * W::kRowBytes;  // one [keys][cols] box
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kKvTile = kBoxes * kKvBox;
  static constexpr int kStages = Tiles<D>::kStages;
  static constexpr int kOut = kQTile + 2 * kStages * kKvTile;  // o staging, 64 rows per warpgroup
  static constexpr int kBars = kOut + (Tiles<D>::kStagedOut ? kQTile : 0);
  static constexpr int kBytes = kBars + 8 * (3 + 4 * kStages) + 1024;  // + tile slot, alignment
  static_assert(kBytes <= 232448, "the opt-in shared-memory limit of a block");
};

// --- the kernel --------------------------------------------------------------

// Named barriers 1 to kConsumers order the consumer warpgroups' turns at
// issuing their products, in a ring (0 is __syncthreads); with two consumer
// warpgroups, 3 and 4 gather each around its o staging.
constexpr int kTurnBar = 1;
constexpr int kOutBar = 3;

// One step of the online softmax on the S tile of K tile j (kBlockN keys,
// N = kBlockN / 2 values a thread): mask it if the tile needs it, raise the
// running max m (base 2, floored), turn s into P in place, rescale this
// lane's share of l, and return the factor corr by which the output
// accumulator must be rescaled.
template <bool kCausal, int C, int N>
__device__ __forceinline__ void softmax_step(float (&s)[N], float (&m)[2], float (&l)[2][C],
                                             float (&corr)[2], bool masked, int j, int row0,
                                             int t, int S, int window, float scale2) {
  constexpr int kBlockN = 2 * N;
  if (masked) {
#pragma unroll
    for (int n = 0; n < N / 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = j * kBlockN + n * 8 + 2 * t + (e & 1);
        const int qpos = row0 + 8 * (e >> 1);
        bool vis = kpos < S;  // keys past S were zero-filled: they score 0
        if (kCausal) vis = vis && qpos >= kpos && (window == 0 || qpos - kpos < window);
        if (!vis) s[4 * n + e] = kNegInf;
      }
  }
  // C partial maxima a row (n % C), then their max.
  float part[2][C];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) part[r][c] = kNegInf;
#pragma unroll
  for (int n = 0; n < N / 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[e >> 1][n % C] = fmaxf(part[e >> 1][n % C], s[4 * n + e]);
  float mx[2], neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the four lanes of a quad share a row
    mx[r] = part[r][0];
#pragma unroll
    for (int c = 1; c < C; ++c) mx[r] = fmaxf(mx[r], part[r][c]);
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(fmaxf(m[r], mx[r] * scale2), kM2Floor);
    corr[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
#pragma unroll
    for (int c = 0; c < C; ++c) l[r][c] *= corr[r];
  }
#pragma unroll
  for (int n = 0; n < N / 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // masked scores underflow to 0
      const float p = fast_exp2(fmaf(s[4 * n + e], scale2, neg_m[e >> 1]));
      s[4 * n + e] = p;
      l[e >> 1][n % C] += p;
    }
}

// The tiles of a launch: Q tile i of head bh, with the K tiles [lo, hi] it
// sees (_n_kv_blocks / _k_index). They are numbered in chunks of heads whose
// q, k and v fit in L2 together, so that the Q tiles sharing a head's K and
// V run at about the same time; inside a chunk, longest first (causal: the
// last Q tiles first). Persistent CTAs take the next number from a counter
// in device memory, so each SM's share ends close to the mean; the last CTA
// to find none left sets the counter back to zero.
template <bool kCausal, int kBlockM, int kBlockN>
struct Schedule {
  int n_blk, n_kv, bh_count, chunk, total, window;
  __device__ Schedule(int S, int BH, int heads_per_chunk, int w)
      : n_blk((S + kBlockM - 1) / kBlockM), n_kv((S + kBlockN - 1) / kBlockN), bh_count(BH),
        chunk(heads_per_chunk), total(BH * n_blk), window(w) {}
  __device__ void unpack(int u, int& i, int& bh, int& lo, int& hi) const {
    const int first_head = u / (chunk * n_blk) * chunk;
    const int heads = min(chunk, bh_count - first_head);
    const int w = u - first_head * n_blk;
    bh = first_head + w % heads;
    i = kCausal ? n_blk - 1 - w / heads : w / heads;
    lo = 0;
    hi = n_kv - 1;
    if (kCausal) {
      hi = min((i * kBlockM + kBlockM - 1) / kBlockN, n_kv - 1);
      const int first = i * kBlockM - (window - 1);
      lo = window != 0 && first > 0 ? first / kBlockN : 0;
    }
  }
};

template <int D, bool kCausal>
__global__ void __launch_bounds__(Tiles<D>::kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap o_map, bf16* __restrict__ o,
               float* __restrict__ lse, int* __restrict__ counters, int S, int BH,
               int heads_per_chunk, int window, float scale2) {
  using L = Smem<D>;
  using T = Tiles<D>;
  using W = Swizzle<D>;
  constexpr int kBlockM = T::kBlockM, kBlockN = T::kBlockN, kConsumers = T::kConsumers;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  auto sK = [&](int st) { return base + L::kQTile + L::kKvTile * (2 * st); };
  auto sV = [&](int st) { return base + L::kQTile + L::kKvTile * (2 * st + 1); };
  // mbarriers: Q full and empty; K full, V full, K empty, V empty per stage.
  const uint32_t full_q = base + L::kBars, empty_q = full_q + 8;
  auto full_k = [&](int st) { return full_q + 8 * (2 + st); };
  auto full_v = [&](int st) { return full_q + 8 * (2 + kStages + st); };
  auto empty_k = [&](int st) { return full_q + 8 * (2 + 2 * kStages + st); };
  auto empty_v = [&](int st) { return full_q + 8 * (2 + 3 * kStages + st); };
  // The producer passes each tile's number (-1: none left) to the consumers
  // in this slot, written before the Q load that full_q reports.
  const uint32_t slot = full_q + 8 * (2 + 4 * kStages);
  volatile int* tile_slot = reinterpret_cast<volatile int*>(smem_raw + (slot - smem_u32(smem_raw)));
  const Schedule<kCausal, kBlockM, kBlockN> sched(S, BH, heads_per_chunk, window);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 4 * kConsumers);  // one arrival per consumer warp
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), 4 * kConsumers);
      mbar_init(empty_v(st), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer: one thread issues every load ----------------
    // Per tile, in order of use: Q; K of tile lo; then K of tile j and V of
    // tile j - 1; then V of tile hi. The ring's position `it` runs on across
    // the CTA's tiles, so the next tile's Q and first K load while the
    // consumers finish this one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;
      for (int r = 0;; ++r) {
        mbar_wait(empty_q, (r & 1) ^ 1);  // every consumer warpgroup is done with Q
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
        auto load = [&](const CUtensorMap* map, uint32_t full, uint32_t empty, uint32_t dst,
                        int round, int row) {
          mbar_wait(empty, (round & 1) ^ 1);  // the first round passes
          mbar_expect_tx(full, L::kKvTile);
          for (int b = 0; b < L::kBoxes; ++b)
            tma_load(dst + b * L::kKvBox, map, full, b * W::kCols, row, bh);
        };
        auto load_k = [&](int n) {  // the n-th K tile of the ring, tile j = lo + n - it
          const int st = n % kStages;
          load(&k_map, full_k(st), empty_k(st), sK(st), n / kStages, (lo + n - it) * kBlockN);
        };
        auto load_v = [&](int n) {
          const int st = n % kStages;
          load(&v_map, full_v(st), empty_v(st), sV(st), n / kStages, (lo + n - it) * kBlockN);
        };
        mbar_expect_tx(full_q, L::kQTile);
        for (int b = 0; b < L::kBoxes; ++b)
          tma_load(sQ + b * L::kQBox, &q_map, full_q, b * W::kCols, i * kBlockM, bh);
        load_k(it);
        for (int n = it + 1; n <= it + hi - lo; ++n) {
          load_k(n);
          load_v(n - 1);
        }
        load_v(it + hi - lo);
        it += hi - lo + 1;
      }
    }
  } else {
    // ---------------- consumers: 64 Q rows per warpgroup ----------------
    // Each iteration issues S of tile j and P V of tile j - 1 together, runs
    // tile j's softmax while P V is in flight, and hands the tensor cores to
    // the other warpgroup between the issue and the softmax.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs));
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, lane = tid % 32, t = lane % 4;
    const int row_in_tile = c * 64 + (tid / 32) * 16 + lane / 4;  // and + 8
    const bool ragged = S % kBlockN != 0;
    const uint32_t sQc = sQ + c * 64 * W::kRowBytes;
    const uint32_t sOc = base + L::kOut + c * (L::kQTile / 2);  // [boxes][64 rows][128 B]
    auto issue_s = [&](float (&s)[kBlockN / 2], int st) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, kmajor_desc<D>(sQc + k16_offset<D>(kk, L::kQBox)),
                 kmajor_desc<D>(sK(st) + k16_offset<D>(kk, L::kKvBox)), kk > 0);
      wgmma_commit();
    };
    auto issue_pv = [&](float (&acc)[D / 2], const uint32_t (&pa)[kBlockN / 16][4], int st) {
#pragma unroll
      for (int kt = 0; kt < kBlockN / 16; ++kt)
        wgmma_rs(acc, pa[kt], mnmajor_desc<kBlockN, D>(sV(st) + kt * 16 * W::kRowBytes));
      wgmma_commit();
    };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);  // this warp is done with the buffer
    };

    // Turns around the issue (at_softmax false) or around the softmax.
    auto take_turn = [&](bool at_softmax) {
      if (T::kTurns && at_softmax == T::kSoftmaxTurns) named_sync(kTurnBar + c);
    };
    auto pass_turn = [&](bool at_softmax) {
      if (T::kTurns && at_softmax == T::kSoftmaxTurns)
        named_arrive(kTurnBar + (c + 1) % kConsumers);
    };
    if (T::kTurns && c == kConsumers - 1) named_arrive(kTurnBar);  // warpgroup 0 goes first
    int it = 0;
    for (int r = 0;; ++r) {
      mbar_wait(full_q, r & 1);
      const int u = *tile_slot;
      if (u < 0) break;
      int i, bh, lo, hi;
      sched.unpack(u, i, bh, lo, hi);
      const int row0 = i * kBlockM + row_in_tile;
      const int wg_row0 = i * kBlockM + c * 64;  // this warpgroup's first row
      // The tile needs the mask if one of its keys lies past this
      // warpgroup's first row or as far as the window from its last one:
      // with square tiles (D <= 128), the diagonal tile and the tiles that
      // cross the window's edge (a test that runs faster there than the
      // general one).
      auto masked = [&](int j) {
        if constexpr (kBlockN == kBlockM)
          return (kCausal && (j == i || (window != 0 && (i - j + 1) * kBlockN - 1 >= window))) ||
                 (ragged && j == sched.n_kv - 1);
        else
          return (kCausal && (j * kBlockN + kBlockN - 1 > wg_row0 ||
                              (window != 0 && wg_row0 + 63 - j * kBlockN >= window))) ||
                 (ragged && j == sched.n_kv - 1);
      };
      float acc[D / 2];
#pragma unroll
      for (int x = 0; x < D / 2; ++x) acc[x] = 0.0f;
      float m[2] = {kNegInf, kNegInf}, l[2][T::kChains] = {};  // l: this lane's share
      float corr[2];
      uint32_t pa[kBlockN / 16][4];
      float s[kBlockN / 2];
      mbar_wait(full_k(it % kStages), (it / kStages) & 1);
      take_turn(false);
      fence_regs(acc);
      wgmma_fence();
      issue_s(s, it % kStages);
      pass_turn(false);
      wgmma_wait<0>();
      fence_regs(s);
      release(empty_k(it % kStages));
      if (lo == hi) release(empty_q);
      take_turn(true);
      softmax_step<kCausal, T::kChains>(s, m, l, corr, masked(lo), lo, row0, t, S, window,
                                        scale2);
      pass_turn(true);
      to_a(pa, s);

      for (int j = lo + 1, n = it + 1; j <= hi; ++j, ++n) {
        const int st = n % kStages, pst = (n - 1) % kStages;
        mbar_wait(full_k(st), (n / kStages) & 1);
        take_turn(false);
        fence_regs(acc);
        fence_regs(pa);
        wgmma_fence();
        issue_s(s, st);
        mbar_wait(full_v(pst), ((n - 1) / kStages) & 1);
        issue_pv(acc, pa, pst);
        pass_turn(false);
        wgmma_wait<1>();  // S of tile j is done; P V of tile j - 1 may not be
        fence_regs(s);
        release(empty_k(st));
        if (j == hi) release(empty_q);
        take_turn(true);
        softmax_step<kCausal, T::kChains>(s, m, l, corr, masked(j), j, row0, t, S, window,
                                          scale2);
        pass_turn(true);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        release(empty_v(pst));
#pragma unroll
        for (int x = 0; x < D / 2; ++x) acc[x] *= corr[(x >> 1) & 1];
        to_a(pa, s);
      }
      const int last = it + hi - lo;
      mbar_wait(full_v(last % kStages), (last / kStages) & 1);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_pv(acc, pa, last % kStages);
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty_v(last % kStages));
      it = last + 1;

      float row_l[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        row_l[h] = l[h][0];
#pragma unroll
        for (int x = 1; x < T::kChains; ++x) row_l[h] += l[h][x];
        row_l[h] += __shfl_xor_sync(0xffffffffu, row_l[h], 1);
        row_l[h] += __shfl_xor_sync(0xffffffffu, row_l[h], 2);
        row_l[h] = fmaxf(row_l[h], 1e-30f);
      }
      if constexpr (T::kStagedOut) {
        // o through shared memory, in the 128-byte swizzle of the o map, and
        // one TMA store per box; the store runs on while the next tile starts.
        if (tid == 0) tma_store_wait_read();  // the previous tile's store is out
        warpgroup_sync(kOutBar + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r_local = (tid / 32) * 16 + lane / 4 + 8 * h;
          const float inv = 1.0f / row_l[h];
#pragma unroll
          for (int n = 0; n < D / 8; ++n)
            st_shared_u32(sOc + (n / 8) * 64 * 128 + r_local * 128 +
                              (((n % 8) ^ (lane / 4)) * 16) + 4 * t,
                          pack_bf16(acc[4 * n + 2 * h] * inv, acc[4 * n + 2 * h + 1] * inv));
        }
        fence_async_shared();  // visible to the TMA
        warpgroup_sync(kOutBar + c);
        if (tid == 0)
          for (int b = 0; b < L::kBoxes; ++b)
            tma_store(&o_map, sOc + b * 64 * 128, b * kBoxCols, i * kBlockM + c * 64, bh);
      } else {
        // o from registers: this thread's bf16 pairs of rows row0 and
        // row0 + 8, none past S.
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (row0 + 8 * h < S)
            store_row<D>(o + (static_cast<size_t>(bh) * S + row0 + 8 * h) * D, acc, h,
                         1.0f / row_l[h], t);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (t == 0 && row < S)
          lse[static_cast<size_t>(bh) * S + row] = m[h] * kLn2 + logf(row_l[h]);
      }
    }
    if (T::kTurns && c == 0) named_sync(kTurnBar);  // the last warpgroup's last hand-over
    if constexpr (T::kStagedOut)
      if (tid == 0) tma_store_wait_read();  // shared memory outlives the last store's reads
  }
}

// --- host side -----------------------------------------------------------------

template <int D, bool kCausal>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int* counters,
           int bh, int s, int window, cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  using T = Tiles<D>;
  constexpr int kBlockM = T::kBlockM, kBlockN = T::kBlockN;
  CUtensorMap qm, km, vm, om{};
  if (!make_map(&qm, fn, q, bh, s, D, kBlockM) || !make_map(&km, fn, k, bh, s, D, kBlockN) ||
      !make_map(&vm, fn, v, bh, s, D, kBlockN) ||
      (T::kStagedOut && !make_map(&om, fn, o, bh, s, D, 64)))
    return kErrEncode;
  int ctas = 0;
  const cudaError_t e = persistent_grid(flash_fwd_sm90<D, kCausal>, Smem<D>::kBytes,
                                        bh * ((s + kBlockM - 1) / kBlockM), &ctas);
  if (e != cudaSuccess) return e;
  flash_fwd_sm90<D, kCausal><<<ctas, T::kThreads, Smem<D>::kBytes, stream>>>(
      qm, km, vm, om, static_cast<bf16*>(o), static_cast<float*>(lse), counters, s, bh,
      heads_per_chunk(bh, s, D, 3), window, softmax_scale(D) * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [bh, s, d] bf16, contiguous, 16-byte aligned; lse [bh, s] fp32;
// counters: two ints, zero before the first launch and left zero by every
// launch that completes; launches that share them must be ordered (one
// stream). d is 16, 32, 64, 128 or 256; the caller (tpe_flash_fwd) has checked the
// shape. Returns the cudaError_t of the launch, or a negative code for a
// tensor-map failure.
extern "C" int tpe_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                  void* lse, void* counters, int bh, int s, int d, int window,
                                  int causal, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int* counter = static_cast<int*>(counters);
  if (d == 16)
    return causal ? launch<16, true>(q, k, v, o, lse, counter, bh, s, window, st)
                  : launch<16, false>(q, k, v, o, lse, counter, bh, s, window, st);
  if (d == 32)
    return causal ? launch<32, true>(q, k, v, o, lse, counter, bh, s, window, st)
                  : launch<32, false>(q, k, v, o, lse, counter, bh, s, window, st);
  if (d == 64)
    return causal ? launch<64, true>(q, k, v, o, lse, counter, bh, s, window, st)
                  : launch<64, false>(q, k, v, o, lse, counter, bh, s, window, st);
  if (d == 128)
    return causal ? launch<128, true>(q, k, v, o, lse, counter, bh, s, window, st)
                  : launch<128, false>(q, k, v, o, lse, counter, bh, s, window, st);
  if (d == 256)
    return causal ? launch<256, true>(q, k, v, o, lse, counter, bh, s, window, st)
                  : launch<256, false>(q, k, v, o, lse, counter, bh, s, window, st);
  return cudaErrorInvalidValue;
}
