// Device and host helpers shared by the Hopper (sm_90a) flash-attention
// kernels: K1 (flash_fwd_sm90.cu), K2 and K3 (flash_bwd_sm90.cu), and K2 and
// K3 at D 256 (flash_bwd_dq_d256_sm90.cu, flash_bwd_dkv_d256_sm90.cu).
// mbarriers and TMA copies, wgmma descriptors and products, register fences,
// bf16 packing and row stores, and the host's tensor-map encoder.
//
// At D 64 and up, every tile these kernels copy is a box of [rows][64 bf16
// columns] with the 128-byte swizzle (one 128-byte row per tile row), so a
// D 128 tile is two boxes and a D 256 tile four; the swizzle repeats every
// 1024 bytes (8 rows), and the wgmma descriptors assume 1024-byte-aligned
// boxes. At D 32 and 16 a tile is one box of [rows][D] in the 64- or
// 32-byte swizzle (Swizzle<D>), which repeats every 512 or 256 bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBoxCols = 64;  // bf16 columns of a 128-byte swizzled row

// The swizzle of a [rows][D] bf16 tile. A box row is 128 bytes (64 columns)
// at D >= 64, else the whole row: 64 bytes at D 32, 32 at D 16. kMode is
// the layout type of a wgmma descriptor (bits 62-63): 1 for the 128-byte
// swizzle, 2 for 64, 3 for 32; an 8-row group of a box is 8 kRowBytes.
template <int D>
struct Swizzle {
  static constexpr int kRowBytes = D >= 64 ? 128 : 2 * D;
  static constexpr int kCols = kRowBytes / 2;  // bf16 columns of a box
  static constexpr int kBoxes = D / kCols;
  static constexpr int kK16 = kCols / 16;  // k16 slices of a box row
  static constexpr uint64_t kMode = D >= 64 ? 1 : D == 32 ? 2 : 3;
  static_assert(D == 16 || D == 32 || D % 64 == 0, "a head dim the swizzles tile");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA -----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One box of a 3-D map at (column c0, row c1, head c2) into shared memory,
// completing `bar`'s transaction count by the box's bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
// One box of a 2-D map at (column c0, row c1) into shared memory.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// One box of shared memory to a 3-D map at (column c0, row c1, head c2);
// rows past the map's bounds are not written. Tracked as a bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
// Makes this thread's shared-memory writes visible to TMA stores.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- named barriers ----------------------------------------------------------

// Barrier 0 is __syncthreads; a kernel numbers its own from 1.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// --- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets, all in 16-byte units, and the swizzle's layout type (kMode).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t mode) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}
// K-major operand (rows x D, D contiguous): 8-row groups 8 box rows apart
// (1024 bytes in the 128-byte swizzle); the leading offset is unused with a
// swizzle. A k16 slice inside a box starts 32 bytes on (k16_offset).
template <int D = 64>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  using W = Swizzle<D>;
  return smem_desc(addr, 16, 8 * W::kRowBytes, W::kMode);
}
// MN-major operand (a [Rows][D] tile read as k = rows, n = D): boxes Rows
// box rows apart (at D 128 and 256 the 64-column boxes; one box below),
// 8-row groups 8 box rows apart. A k16 slice (16 rows) starts 16 box rows on.
template <int Rows, int D = 64>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  using W = Swizzle<D>;
  return smem_desc(addr, Rows * W::kRowBytes, 8 * W::kRowBytes, W::kMode);
}
// Byte offset of k16 slice kk of a K-major [rows][D] tile whose boxes are
// box_bytes apart.
template <int D>
__device__ __forceinline__ uint32_t k16_offset(int kk, uint32_t box_bytes) {
  using W = Swizzle<D>;
  return (kk / W::kK16) * box_bytes + (kk % W::kK16) * 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int x = 0; x < N; ++x) asm volatile("" : "+f"(r[x])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int x = 0; x < M; ++x)
#pragma unroll
    for (int y = 0; y < N; ++y) asm volatile("" : "+r"(r[x][y])::"memory");
}

#define TPE_ACC8(d, i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], both from shared memory,
// K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : TPE_ACC8(d, 0), TPE_ACC8(d, 8), TPE_ACC8(d, 16), TPE_ACC8(d, 24), TPE_ACC8(d, 32),
        TPE_ACC8(d, 40), TPE_ACC8(d, 48), TPE_ACC8(d, 56)
      : "l"(a), "l"(b), "r"(scale_d));
}
// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : TPE_ACC8(d, 0), TPE_ACC8(d, 8), TPE_ACC8(d, 16), TPE_ACC8(d, 24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 32] (+)= A[64 x 16] * B[16 x 32], both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : TPE_ACC8(d, 0), TPE_ACC8(d, 8)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], both from shared memory: A
// K-major, B MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[64], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : TPE_ACC8(d, 0), TPE_ACC8(d, 8), TPE_ACC8(d, 16), TPE_ACC8(d, 24), TPE_ACC8(d, 32),
        TPE_ACC8(d, 40), TPE_ACC8(d, 48), TPE_ACC8(d, 56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x N] (+)= A[64 x 16] * B[16 x N]: A as bf16 register fragments, B
// K-major in shared memory. N = 64 and 32.
__device__ __forceinline__ void wgmma_rs_k(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : TPE_ACC8(d, 0), TPE_ACC8(d, 8), TPE_ACC8(d, 16), TPE_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs_k(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : TPE_ACC8(d, 0), TPE_ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[64 x 80] (+)= A[64 x 16] * B[16 x 80], both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[40], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : TPE_ACC8(d, 0), TPE_ACC8(d, 8), TPE_ACC8(d, 16), TPE_ACC8(d, 24), TPE_ACC8(d, 32)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x N] += A[64 x 16] * B[16 x N]: A as bf16 register fragments, B
// MN-major in shared memory (transpose bit set). N = 128, 64, 32, 16 and 256.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TPE_ACC8(d, 0), TPE_ACC8(d, 8), TPE_ACC8(d, 16), TPE_ACC8(d, 24), TPE_ACC8(d, 32),
        TPE_ACC8(d, 40), TPE_ACC8(d, 48), TPE_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TPE_ACC8(d, 0), TPE_ACC8(d, 8), TPE_ACC8(d, 16), TPE_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : TPE_ACC8(d, 0), TPE_ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : TPE_ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : TPE_ACC8(d, 0), TPE_ACC8(d, 8), TPE_ACC8(d, 16), TPE_ACC8(d, 24), TPE_ACC8(d, 32), TPE_ACC8(d, 40), TPE_ACC8(d, 48), TPE_ACC8(d, 56), TPE_ACC8(d, 64), TPE_ACC8(d, 72), TPE_ACC8(d, 80), TPE_ACC8(d, 88), TPE_ACC8(d, 96), TPE_ACC8(d, 104), TPE_ACC8(d, 112), TPE_ACC8(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef TPE_ACC8

// Four 8x8 bf16 matrices from shared memory, one row address per lane.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A warpgroup's 64 rows of a [rows][D] tile (D 16 or 32, one box in
// Swizzle<D>'s swizzle, `rows64` the address of the first of them) as the
// register A fragments of wgmma, slice kk in a[kk]: by ldmatrix, lane l
// giving row 16 w + l % 8 + 8 ((l / 8) % 2) and 16-byte chunk 2 kk + l / 16,
// whose place in the row the swizzle XORs with address bits 7 and up.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], uint32_t rows64, int tid) {
  using W = Swizzle<D>;
  static_assert(W::kBoxes == 1, "one box a row");
  const int lane = tid % 32, row = (tid / 32) * 16 + lane % 8 + 8 * ((lane / 8) % 2);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int chunk = 2 * kk + lane / 16;
    const int swizzled = chunk ^ ((row * W::kRowBytes >> 7) & (W::kRowBytes / 16 - 1));
    ldsm_x4(a[kk], rows64 + row * W::kRowBytes + swizzled * 16);
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator layout of wgmma m64nN, per thread (warp w of the warpgroup,
// lane = 4 g + t): d[4n + e] is row 16 w + g + 8 (e >> 1), column
// 8 n + 2 t + (e & 1). The bf16 A fragment of a k16 slice holds the same
// positions of two neighbouring n8 tiles, so an accumulator of N columns,
// rounded pairwise to bf16, is the A operand of a product of depth N:
// slice kt is pa[kt].
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&pa)[N / 8][4], const float (&s)[N]) {
#pragma unroll
  for (int kt = 0; kt < N / 8; ++kt)
#pragma unroll
    for (int h = 0; h < 4; ++h) pa[kt][h] = pack_bf16(s[8 * kt + 2 * h], s[8 * kt + 2 * h + 1]);
}

// An accumulator of D columns (this thread's rows r and r + 8 of a 64-row
// tile, r = 16 w + g) as bf16 into a [D / 64 boxes][64 rows][128 bytes]
// staging tile in the 128-byte swizzle of a TMA map.
template <int D>
__device__ __forceinline__ void stage_rows(uint32_t dst, const float (&acc)[D / 2], int tid) {
  const int lane = tid % 32, t = lane % 4, g = lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (tid / 32) * 16 + g + 8 * h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      st_shared_u32(dst + (n / 8) * 64 * 128 + r * 128 + (((n % 8) ^ g) * 16) + 4 * t,
                    pack_bf16(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]));
  }
}

// Row h (0: r, 1: r + 8) of this thread's share of an accumulator of D
// columns, times `scale`, as bf16 into `row`, the row's first column in
// global memory (lane = 4 g + t).
template <int D>
__device__ __forceinline__ void store_row(bf16* row, const float (&acc)[D / 2], int h,
                                          float scale, int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    *reinterpret_cast<uint32_t*>(row + 8 * n + 2 * t) =
        pack_bf16(acc[4 * n + 2 * h] * scale, acc[4 * n + 2 * h + 1] * scale);
}

// --- host side -----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Codes outside cudaError_t's range, negative (the Python wrapper names them).
constexpr int kErrNoEncoder = -1;  // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrEncode = -2;     // cuTensorMapEncodeTiled refused a tensor map

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A [BH, S, D] bf16 tensor as a 3-D map of [1][rows][cols] boxes: 64
// columns in the 128-byte swizzle at D >= 64, else all D columns in the 64-
// (D 32) or 32-byte (D 16) swizzle (Swizzle<D>); out-of-bounds rows read as
// zeros and are not written.
bool make_map(CUtensorMap* map, EncodeTiled fn, const void* ptr, int bh, int s, int d, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * sizeof(bf16),
                                 static_cast<cuuint64_t>(s) * d * sizeof(bf16)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(d < kBoxCols ? d : kBoxCols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = d >= kBoxCols ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : d == 32     ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [BH, S] fp32 tensor (lse, delta) as a 2-D map of [1][cols] boxes, no
// swizzle.
bool make_row_map(CUtensorMap* map, EncodeTiled fn, const void* ptr, int bh, int s, int cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(s) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(cols), 1};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device's SM count, asked of the runtime once per device.
cudaError_t sm_count(int* sms) {
  static int known[64] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 64 && known[device] > 0) {
    *sms = known[device];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess && device < 64) known[device] = *sms;
  return e;
}

// 1/sqrt(D) rounded once to fp32, as the JAX kernels' scale is.
float softmax_scale(int d) { return static_cast<float>(1.0 / std::sqrt(static_cast<double>(d))); }

// Sets a persistent kernel's dynamic shared memory and gives its grid: one
// CTA per SM at most, each walking its share of the tiles.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int smem, int tiles, int* ctas) {
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  *ctas = tiles < sms ? tiles : sms;
  return e;
}

// Heads per chunk of a tile order: as many as keep the chunk's `tensors`
// [S, D] bf16 tensors per head within kChunkBytes (about half of the H100's
// 50 MB L2), split evenly.
constexpr double kChunkBytes = 24.0 * (1 << 20);

int heads_per_chunk(int bh, int s, int d, int tensors) {
  const double head_bytes = static_cast<double>(tensors) * s * d * sizeof(bf16);
  const int chunks = static_cast<int>(std::ceil(bh * head_bytes / kChunkBytes));
  return chunks <= 1 ? bh : (bh + chunks - 1) / chunks;
}

}  // namespace
