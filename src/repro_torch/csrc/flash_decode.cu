// Flash decode (one query token per kv-head group over a KV cache; online
// softmax; linear or ring-buffer masking by a scalar position t) for Hopper
// (sm_90a), written by hand. It takes the place of the Pallas TPU kernel of
// src/repro/kernels/flash_decode.py (flash_decode).
//
// The TPU kernel gives one grid row to each (batch, kv head) and walks the
// cache blocks along its sequential grid axis with (m, l, acc) in scratch.
// Here that axis is split over blocks as well: at the serving cache of
// llama32-1b (8 sequences x 8 kv heads) one block per (batch, kv head) would
// fill 64 of the card's 132 SMs. Block (bh, split) owns a contiguous run of the
// slots that t can see; each of its four warps walks every fourth slot of that
// run with its own (m, l, acc) in registers (a warp reads one K row and one V
// row at a time, the 32 lanes side by side along D), the warps merge in shared
// memory, and the block writes its (m, l, acc) to a scratch buffer. A second,
// small kernel merges the splits of each (bh): every split is weighted by
// exp(m_split - m_all), so a split that saw no valid slot (m = -1e30, l = 0,
// acc = 0) adds exactly zero.
//
// Masking follows the TPU kernel: a ring buffer iff 0 < window <= slots, where
// slot j holds absolute position t - ((t - j) mod slots), valid iff that is
// >= 0 and > t - window; otherwise a linear cache, valid iff j <= t (and
// j > t - window when window > 0). Slots that are masked are not read at all
// (the TPU kernel reads them and scores them -1e30), and for a linear cache the
// splits cover only the run [max(0, t - window + 1), min(t, slots - 1)], so
// the bytes read follow t. l is clamped at 1e-20 before the division, so a
// query with no valid slot (t past the end of a linear cache and its window)
// gives zeros. Scores, softmax and the weighted sum are f32 for f32 and bf16
// caches alike.
//
// Bound on this card: bytes. Each valid K and V row is read once, the G
// queries of a group share it; the work is 4 G D operations per row read.

#include <cmath>

#include "common.cuh"

namespace {

using repro::ceil_div;
using repro::from_f32;
using repro::to_f32;

constexpr int NW = 4;                  // warps per block
constexpr int NT = 32 * NW;
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;                   // elements; the last dim is contiguous
};

__device__ __forceinline__ bool slot_valid(int j, int t, int slots, int window,
                                           bool ring) {
  if (ring) {
    int r = (t - j) % slots;
    if (r < 0) r += slots;
    return r <= t && r < window;       // abs >= 0 and abs > t - window
  }
  return j <= t && (window == 0 || j > t - window);
}

// E = elements of D per lane (D <= 32: one, lanes >= D idle); GM = most
// queries per group this instantiation holds.
template <typename T, int D, int GM>
__global__ void __launch_bounds__(NT)
flash_decode_split_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                          const T* __restrict__ V, float* __restrict__ part,
                          int Hkv, int G, int slots, int t, int window,
                          Strides qs, Strides ks, Strides vs, float sm_scale) {
  constexpr int E = D >= 32 ? D / 32 : 1;
  __shared__ float sm_m[NW][GM];
  __shared__ float sm_l[NW][GM];
  __shared__ float sm_acc[NW][GM][D];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const bool ring = window > 0 && window <= slots;

  // the run of slots t can see, cut into nsplit contiguous pieces
  int lo = 0, hi = slots - 1;
  if (!ring) {
    lo = window > 0 ? max(0, t - window + 1) : 0;
    hi = min(t, slots - 1);
  }
  const int len = max(0, hi - lo + 1);
  const int chunk = ceil_div(len, nsplit);
  const int j0 = lo + split * chunk;
  const int j1 = min(j0 + chunk, hi + 1);

  float qr[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      qr[g][e] = (g < G && d < D)
                     ? to_f32<T>(Q[b * qs.b + h * qs.h + g * qs.s + d])
                     : 0.f;
    }

  float m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const T* kp = K + b * ks.b + h * ks.h;
  const T* vp = V + b * vs.b + h * vs.h;
  for (int j = j0 + warp; j < j1; j += NW) {
    if (ring && !slot_valid(j, t, slots, window, true)) continue;
    float kv[E], vv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      kv[e] = d < D ? to_f32<T>(kp[j * ks.s + d]) : 0.f;
      vv[e] = d < D ? to_f32<T>(vp[j * vs.s + d]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s = fmaf(qr[g][e], kv[e], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      s *= sm_scale;
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * alpha + p;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e] * alpha);
    }
  }

  // merge the four warps
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      if (d < D) sm_acc[warp][g][d] = acc[g][e];
    }
  }
  __syncthreads();
  float* out = part + ((long long)bh * nsplit + split) * G * (D + 2);
  for (int idx = threadIdx.x; idx < G * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      a = fmaf(c, sm_acc[w][g][d], a);
      ll = fmaf(c, sm_l[w][g], ll);
    }
    out[g * (D + 2) + 2 + d] = a;
    if (d == 0) {
      out[g * (D + 2)] = mx;
      out[g * (D + 2) + 1] = ll;
    }
  }
}

// One block per (bh): out[g, d] = sum_s c_s acc_s / max(sum_s c_s l_s, 1e-20),
// c_s = exp(m_s - max_s m_s). The output is (B, Hkv, G, D), contiguous.
template <typename T>
__global__ void __launch_bounds__(NT)
flash_decode_merge_kernel(const float* __restrict__ part, T* __restrict__ O,
                          int G, int D, int nsplit) {
  const int bh = blockIdx.x;
  const float* base = part + (long long)bh * nsplit * G * (D + 2);
  for (int idx = threadIdx.x; idx < G * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    float mx = NEG_INF;
    for (int s = 0; s < nsplit; ++s)
      mx = fmaxf(mx, base[(s * G + g) * (D + 2)]);
    float a = 0.f, ll = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float* p = base + (s * G + g) * (D + 2);
      const float c = expf(p[0] - mx);
      ll = fmaf(c, p[1], ll);
      a = fmaf(c, p[2 + d], a);
    }
    O[((long long)bh * G + g) * D + d] = from_f32<T>(a / fmaxf(ll, 1e-20f));
  }
}

template <typename T, int D, int GM>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* part, int B, int Hkv, int G, int S, int t,
                   int window, int nsplit, Strides qs,
                   Strides ks, Strides vs, cudaStream_t stream) {
  const float sm_scale = 1.0f / sqrtf((float)D);
  const dim3 grid(B * Hkv, nsplit);
  flash_decode_split_kernel<T, D, GM><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part, Hkv, G, S, t, window, qs,
      ks, vs, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_merge_kernel<T><<<B * Hkv, NT, 0, stream>>>(
      part, static_cast<T*>(o), G, D, nsplit);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(const void* q, const void* k, const void* v, void* o,
                       float* part, int B, int Hkv, int G, int S, int t,
                       int window, int nsplit, Strides qs,
                       Strides ks, Strides vs, cudaStream_t stream) {
  if (G <= 2)
    return launch<T, D, 2>(q, k, v, o, part, B, Hkv, G, S, t, window, nsplit, qs, ks, vs, stream);
  if (G <= 4)
    return launch<T, D, 4>(q, k, v, o, part, B, Hkv, G, S, t, window, nsplit, qs, ks, vs, stream);
  if (G <= 8)
    return launch<T, D, 8>(q, k, v, o, part, B, Hkv, G, S, t, window, nsplit, qs, ks, vs, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, float* part, int B, int Hkv, int G, int S,
                       int t, int window, int nsplit,
                       Strides qs, Strides ks, Strides vs,
                       cudaStream_t stream) {
  switch (D) {
    case 16:
      return dispatch_g<T, 16>(q, k, v, o, part, B, Hkv, G, S, t, window, nsplit, qs, ks, vs, stream);
    case 32:
      return dispatch_g<T, 32>(q, k, v, o, part, B, Hkv, G, S, t, window, nsplit, qs, ks, vs, stream);
    case 64:
      return dispatch_g<T, 64>(q, k, v, o, part, B, Hkv, G, S, t, window, nsplit, qs, ks, vs, stream);
    case 128:
      return dispatch_g<T, 128>(q, k, v, o, part, B, Hkv, G, S, t, window, nsplit, qs, ks, vs, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues the two kernels on the given
// stream, does not synchronise, allocates nothing, returns the cudaError_t of
// the launches (0 on success). Logical shapes: q (B, Hkv, G, D), k and v
// (B, Hkv, S, D), each addressed through its (batch, head, row) strides in
// elements with the last dim contiguous; o (B, Hkv, G, D) contiguous; part is
// f32 scratch of B * Hkv * nsplit * G * (D + 2) elements; t is the position
// of the query token. Head dims 16, 32, 64, 128; G <= 8.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, void* o, void* part, int B,
    int Hkv, int G, int S, int D, long long q_b, long long q_h, long long q_g,
    long long k_b, long long k_h, long long k_s, long long v_b, long long v_h,
    long long v_s, int t, int window, int nsplit,
    int is_bf16, void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || S < 1 || nsplit < 1 || nsplit > 65535 ||
      window < 0)
    return -1;
  const Strides qs{q_b, q_h, q_g}, ks{k_b, k_h, k_s}, vs{v_b, v_h, v_s};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  return static_cast<int>(
      is_bf16 ? dispatch_d<__nv_bfloat16>(D, q, k, v, o, pp, B, Hkv, G, S, t,
                                          window, nsplit, qs, ks, vs, s)
              : dispatch_d<float>(D, q, k, v, o, pp, B, Hkv, G, S, t, window,
                                  nsplit, qs, ks, vs, s));
}
