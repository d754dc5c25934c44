// Shared helpers of the hand-written kernels: element conversion between the
// storage type (float or bf16) and the f32 the kernels compute in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// f32 value after one rounding to the storage type (identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// p[0] + p[stride] + ... + p[(n - 1) * stride], added in that order, the
// loads issued BATCH at a time (a term past n is a predicated-off load of
// 0), so a batch goes out before the first add waits: a loop that adds
// each term as it comes waits a round trip a term (the split-K reductions
// read a few to a hundred terms). A larger BATCH holds more registers and
// waits fewer round trips.
template <int BATCH = 8>
__device__ __forceinline__ float sum_strided(const float* __restrict__ p,
                                             size_t stride, int n) {
  float s = 0.f;
  for (int i0 = 0; i0 < n; i0 += BATCH) {
    float v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      v[u] = i0 + u < n ? p[(size_t)(i0 + u) * stride] : 0.f;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) s += v[u];
  }
  return s;
}

}  // namespace repro
