// Flash attention (online softmax; causal and sliding-window masks; GQA) for
// Hopper (sm_90a), written by hand. It takes the place of the Pallas TPU
// kernel of src/repro/kernels/flash_attention.py (flash_attention).
//
// The TPU kernel walks the KV blocks along its innermost, sequential grid
// axis and keeps the running (m, l, acc) in scratch memory between grid
// steps. Here one thread block owns a tile of 64 queries of one head, loops
// over the KV tiles itself and keeps (m, l, acc) in registers. K and V are
// indexed by kv_head = q_head / group, so nothing is broadcast over the
// group; the tensors are addressed through strides, so the model's
// (batch, seq, head, dim) layout is read in place; ragged ends are masked,
// nothing is padded. Same rules as the TPU kernel: positions are 0..S-1,
// masked scores are -1e30, KV tiles that are wholly in the future, wholly
// behind the window or wholly past the end are skipped, and l is clamped at
// 1e-20 before the division.
//
// This is the simple version: f32 FMA on shared-memory tiles, no tensor
// cores. At the prefill shape (S = 1024, D = 64) the work is bound by
// operations, not bytes, so this version sits far above the card's bound.

#include <cmath>

#include "common.cuh"

namespace {

using repro::ceil_div;
using repro::from_f32;
using repro::to_f32;

constexpr int BQ = 64;        // queries per block
constexpr int BKV = 64;       // keys per step
constexpr int NT = 256;       // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;          // elements; the last dim is contiguous
};

// Thread (ty, tx) owns query rows ty + 16 i (i < 4); of the score tile the
// columns tx + 16 j (j < 4), of the output the dims tx + 16 jd (jd < D/16).
// The 16 threads of one row are 16 neighbouring lanes of a warp, so the row
// reductions are shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ Q, const T* __restrict__ Kp,
                       const T* __restrict__ V, T* __restrict__ O, int Hq,
                       int group, int Sq, int Skv, Strides qs, Strides ks,
                       Strides vs, Strides os, int causal, int window,
                       float sm_scale) {
  constexpr int DJ = D / 16;
  constexpr int LDQ = D + 1;
  constexpr int LDK = D + 1;
  constexpr int LDV = D;
  constexpr int LDP = BKV + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][LDQ]
  float* Ks = Qs + BQ * LDQ;         // [BKV][LDK]
  float* Vs = Ks + BKV * LDK;        // [BKV][LDV]
  float* Ps = Vs + BKV * LDV;        // [BQ][LDP]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // the last query tiles have the most keys under a causal mask: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const int kvh = h / group;
  const T* qp = Q + b * qs.b + h * qs.h;
  const T* kp = Kp + b * ks.b + kvh * ks.h;
  const T* vp = V + b * vs.b + kvh * vs.h;
  T* op = O + b * os.b + h * os.h;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int rr = idx / D, d = idx % D;
    const int row = q0 + rr;
    Qs[rr * LDQ + d] = row < Sq ? to_f32<T>(qp[row * qs.s + d]) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  }

  const int nkb = ceil_div(Skv, BKV);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BKV;
    // tile-level skip; the same for every thread of the block
    bool run = true;
    if (causal) run = run && (k0 <= q0 + BQ - 1);
    if (window) run = run && (k0 + BKV - 1 > q0 - window);
    if (!run) continue;

    __syncthreads();   // Q tile stored; previous step's K, V, P readers done
    for (int idx = tid; idx < BKV * D; idx += NT) {
      const int rr = idx / D, d = idx % D;
      const int key = k0 + rr;
      const bool ok = key < Skv;
      Ks[rr * LDK + d] = ok ? to_f32<T>(kp[key * ks.s + d]) : 0.f;
      Vs[rr * LDV + d] = ok ? to_f32<T>(vp[key * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        bool ok = k_pos < Skv;
        if (causal) ok = ok && (k_pos <= q_pos);
        if (window) ok = ok && (k_pos > q_pos - window);
        s[i][j] = ok ? s[i][j] * sm_scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();   // P tile complete

#pragma unroll 8
    for (int c = 0; c < BKV; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) vv[jd] = Vs[c * LDV + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd)
          acc[i][jd] = fmaf(pv[i], vv[jd], acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float l = fmaxf(l_i[i], 1e-20f);
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd)
      op[row * os.s + tx + 16 * jd] = from_f32<T>(acc[i][jd] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Hq, int Hkv, int Sq, int Skv, Strides qs, Strides ks,
                   Strides vs, Strides os, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem_bytes =
      sizeof(float) * (BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1));
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  // heads vary fastest: the heads of one GQA group, which share their K and V
  // tiles, are scheduled side by side
  const dim3 grid(B * Hq, ceil_div(Sq, BQ));
  const float sm_scale = 1.0f / sqrtf((float)D);
  kernel<<<grid, NT, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hq / Hkv, Sq, Skv, qs,
      ks, vs, os, causal, window, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, causal, window, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues one kernel on the given
// stream, does not synchronise, allocates nothing, returns the cudaError_t of
// the launch (0 on success). Logical shapes q, o: (B, Hq, Sq, D) and k, v:
// (B, Hkv, Skv, D), each addressed through its (batch, head, seq) strides in
// elements with the last dim contiguous. Head dims 16, 32, 64, 128.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long q_b, long long q_h,
    long long q_s, long long k_b, long long k_h, long long k_s, long long v_b,
    long long v_h, long long v_s, long long o_b, long long o_h, long long o_s,
    int causal, int window, int is_bf16, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1 ||
      ceil_div(Sq, BQ) > 65535)
    return -1;
  const Strides qs{q_b, q_h, q_s}, ks{k_b, k_h, k_s}, vs{v_b, v_h, v_s},
      os{o_b, o_h, o_s};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs,
                                          ks, vs, os, causal, window, s)
              : dispatch_d<float>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs,
                                  os, causal, window, s));
}
