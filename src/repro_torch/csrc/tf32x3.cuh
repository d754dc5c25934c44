// f32 products on the tensor cores of Hopper as three tf32 products, shared
// by the kernels that run f32 work on mma.sync (ssd_scan_tc.cu,
// lora_matmul_tf32.cu, flash_attention_tf32.cu).
//
// A tf32 operand keeps 10 of f32's 23 mantissa bits. Each f32 value x is
// split into x = hi + lo, both exact tf32 values (`split`: hi = tf32(x)
// rounded to nearest, lo = tf32(x - hi); `split_rz`: both truncated), and a
// product a.b is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b with f32 sums:
// the dropped lo.lo term is at f32's rounding, so the result keeps f32
// accuracy (one tf32 product alone misses the f32 tolerances of this
// repository by up to 16x). Small terms first.
//
// mma.sync, not wgmma: wgmma takes tf32 operands K-major only, and the
// operands of these kernels (W of X@W, V of P.V, xt of the SSD products)
// lie MN-major; mma.sync's fragments are built by hand, in any layout.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace repro {
namespace tf32x3 {

// f32 -> tf32, rounded to nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both exact tf32 values
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// x = hi + lo by truncation: hi = x with its 13 low mantissa bits cleared
// (an exact tf32 value), lo = x - hi (exact in f32) likewise truncated to
// tf32. Three integer and f32 operations where `split` takes two
// conversions, which the H100 runs at a small fraction of its f32 rate, so
// that in a kernel that splits every fragment it loads the conversions cost
// about as much as the products they feed. What it drops: |lo| < 2^-10 |x|
// (not 2^-11), so lo.lo, the term no product takes, is below 2^-20 of a.b,
// and lo keeps x's bits down to 2^-21; both far inside the f32 tolerances
// of this repository's kernels (tests/test_torch_f32_tc.py).
__device__ __forceinline__ void split_rz(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d (16 x 8, f32) += a (16 x 8, row) * b (8 x 8, col), tf32 operands:
//   a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   b0 (t, g), b1 (t + 4, g); d0 (g, 2t), d1 (g, 2t + 1), d2, d3 row g + 8;
// g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[n] += a * b_n to f32 accuracy for n < n_max, b_n given split as
// (hi b0, lo b0, hi b1, lo b1): the products term by term (lo.hi, hi.lo,
// hi.hi), so that no product waits for the one before.
template <int N>
__device__ __forceinline__ void mma3(float (&acc)[N][4],
                                     const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const float4 (&b)[N], int n_max = N) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < n_max)
      mma_tf32(acc[n], alo, __float_as_uint(b[n].x), __float_as_uint(b[n].z));
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < n_max)
      mma_tf32(acc[n], ahi, __float_as_uint(b[n].y), __float_as_uint(b[n].w));
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < n_max)
      mma_tf32(acc[n], ahi, __float_as_uint(b[n].x), __float_as_uint(b[n].z));
}

}  // namespace tf32x3
}  // namespace repro
