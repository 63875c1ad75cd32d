// Split TF32 for the fp32 flash kernels (flash_f32_tc.cu): fp32 products
// on the tensor cores at fp32 accuracy.
//
// An fp32 value x is carried as two TF32 values, hi = tf32(x) and
// lo = tf32(x - hi). A TF32 mma reads 19 bits of each 32-bit operand (sign,
// exponent, 10 mantissa bits) and ignores the low 13, so neither half is
// masked before the mma: hi is x plus half a TF32 ulp (0x1000 on the bits),
// which the tensor cores then see rounded to nearest with ties away from
// zero (the rounding of cvt.rna.tf32.f32; CUTLASS's round_half_ulp_truncate),
// and lo is x - hi with hi's low bits cleared, which they see truncated
// towards zero. x - hi is exact and |lo| is at most half of hi's ulp, so hi
// + lo equals x to about 2^-21 relative; three integer and fp32 operations
// a value. A product is then three TF32 products accumulated in fp32, the
// small terms first:
//
//   a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b,
//
// dropping lo_a lo_b (about 2^-22 relative). Each TF32 product of two such
// values is exact in fp32, so the error per element is about 1e-6 relative,
// inside the fp32 bounds; one TF32 product alone (hi_a hi_b) is off by about
// 5e-4 relative and fails them. Rounding lo to nearest as well (five
// operations a value) gave the same errors on an H100 and ran 7-11 % slower
// (kernel_ab.py --variant split_rna).
//
// The tensor cores do not round the sums they accumulate to nearest: bits
// that fall below the accumulator's last place are cut, always towards
// zero. Along a long chain of products into one accumulator the cuts add up
// instead of cancelling: dK and dV summed over 2048 queries that way read
// 2.3e-5 from fp32 on an H100, twice the fp32 bound. So the kernels sum the
// sequence in fp32 registers with rounded additions, and the tensor cores
// sum from zero only 32 keys' products (K1's tile, two of K2's), one
// streamed tile of K3's (16 queries) or the D of one score.
//
// Fragments of mma.m16n8k8 with TF32 operands (PTX ISA), lane = 4 g + t:
// A (16x8) holds (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
// B (8x8) holds (row t, col g) and (t + 4, g); the fp32 accumulator C
// (16x8) holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

#pragma once

#include <cstdint>

namespace {

// An A operand (four values) or a B operand (two) as TF32 halves, each
// carrying low bits that the mma ignores.
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int e, float x) {
    hi[e] = __float_as_uint(x) + 0x1000u;  // rounds to nearest once truncated
    lo[e] = __float_as_uint(x - __uint_as_float(hi[e] & 0xffffe000u));
  }
};
using SplitA = Split<4>;
using SplitB = Split<2>;

// c[16x8] += a[16x8] * b[8x8], TF32 operands, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b at fp32 accuracy: three TF32 products, the small terms first.
__device__ __forceinline__ void mma_split(float (&c)[4], const SplitA& a, const SplitB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}


// The A operand of the [16 x 8] block at p of a row-major fp32 tile with
// rows of ld floats, split.
__device__ __forceinline__ void load_a(SplitA& a, const float* p, int ld, int g, int t) {
  a.set(0, p[g * ld + t]);
  a.set(1, p[(g + 8) * ld + t]);
  a.set(2, p[g * ld + t + 4]);
  a.set(3, p[(g + 8) * ld + t + 4]);
}

// An accumulator tile [16 x 8] as the A operand of the next product, with
// its 8 columns taken in the order 0, 2, 4, 6, 1, 3, 5, 7: the A fragment's
// column t is the accumulator's column 2t and its column t + 4 is 2t + 1,
// so no lane needs another's value. The B operand of that product must take
// its rows in the same order (load_b_permuted).
__device__ __forceinline__ void acc_to_a(SplitA& a, const float (&c)[4]) {
  a.set(0, c[0]);
  a.set(1, c[2]);
  a.set(2, c[1]);
  a.set(3, c[3]);
}

// B = M^T for a row-major tile M whose row n and column k are B's column n
// and row k (the K of S = Q K^T): rows g, columns t and t + 4.
__device__ __forceinline__ void load_b_rows(SplitB& b, const float* p, int ld, int g, int t) {
  b.set(0, p[g * ld + t]);
  b.set(1, p[g * ld + t + 4]);
}

// B = M for a row-major tile M (the V of O += P V), its 8 rows taken in
// acc_to_a's order: B's rows t and t + 4 are M's rows 2t and 2t + 1.
__device__ __forceinline__ void load_b_permuted(SplitB& b, const float* p, int ld, int g, int t) {
  b.set(0, p[2 * t * ld + g]);
  b.set(1, p[(2 * t + 1) * ld + g]);
}

}  // namespace
