// Fused LoRA products for Hopper (sm_90a), written by hand.
//
//   lora_matmul          Y = X @ W + s * (X @ A) @ B
//   lora_matmul_grouped  y[g] = x[g] @ W + s * (x[g] @ A[ids[g]]) @ B[ids[g]]
//
// They take the place of the two Pallas TPU kernels of
// src/repro/kernels/lora_matmul.py (lora_matmul, lora_matmul_grouped). What
// those kernels carry from one grid step to the next (the f32 tile of X@W and
// the running (rows, r) tile of X@A) lives here in the registers of one thread
// block that loops over K itself; X@A never reaches device memory, and the
// rank-r correction is added while the output tile is still in registers.
// Ragged edges are masked, nothing is padded or copied.
//
// Arithmetic (the same as the plain PyTorch versions beside the wrappers):
// all four inputs have one storage type T (float or bf16), products are
// accumulated in f32, X@A is rounded once to T before it meets B, and the sum
// is rounded once to T on the way out.
//
// These are simple versions: shared-memory tiles and FMA, no tensor cores, no
// asynchronous copies. At the serving shapes (M = 64 rows of a prefill chunk,
// one row per request in a decode tick) both functions are bound by the bytes
// of W on this card, and both kernels stay well above that bound: they are
// limited by the latency of their loads, not by the memory's rate.
// lora_matmul_grouped has a second, wide version below that moves 16 bytes
// per load where the shape allows it.

#include <cstdint>

#include "common.cuh"

namespace {

using repro::ceil_div;
using repro::from_f32;
using repro::round_to;
using repro::to_f32;

// ---------------------------------------------------------------------------
// lora_matmul: one block per (64, 64) output tile, K loop inside.
// 256 threads as 16 x 16; thread (ty, tx) owns rows ty + 16 i, columns
// tx + 16 j (i, j < 4) of the tile and columns tx + 16 c (c < RC) of the
// (64, r) tile of X@A. r <= 16 * RC.
// ---------------------------------------------------------------------------

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int NT = 256;

template <typename T, int RC>
__global__ void __launch_bounds__(NT)
lora_matmul_kernel(const T* __restrict__ X, const T* __restrict__ W,
                   const T* __restrict__ A, const T* __restrict__ B,
                   T* __restrict__ Y, int M, int K, int N, int r, float scale) {
  constexpr int RP = 16 * RC;          // r padded with zero columns
  constexpr int XS_LD = BM + 1;        // +1: conflict-free transposed store
  constexpr int XA_LD = RP + 1;
  constexpr int MAIN_FLOATS = BK * XS_LD + BK * BN + BK * RP;
  constexpr int EPI_FLOATS = BM * XA_LD + RP * BN;
  constexpr int SMEM_FLOATS = MAIN_FLOATS > EPI_FLOATS ? MAIN_FLOATS : EPI_FLOATS;
  __shared__ float smem[SMEM_FLOATS];
  float* Xs = smem;                    // [BK][XS_LD]  (k, row)
  float* Ws = Xs + BK * XS_LD;         // [BK][BN]
  float* As = Ws + BK * BN;            // [BK][RP]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][4];
  float xa[4][RC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < RC; ++c) xa[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int m = idx / BK, kk = idx % BK;
      const int gm = m0 + m, gk = k0 + kk;
      Xs[kk * XS_LD + m] =
          (gm < M && gk < K) ? to_f32<T>(X[(size_t)gm * K + gk]) : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += NT) {
      const int kk = idx / BN, n = idx % BN;
      const int gk = k0 + kk, gn = n0 + n;
      Ws[kk * BN + n] =
          (gk < K && gn < N) ? to_f32<T>(W[(size_t)gk * N + gn]) : 0.f;
    }
    for (int idx = tid; idx < BK * RP; idx += NT) {
      const int kk = idx / RP, c = idx % RP;
      const int gk = k0 + kk;
      As[kk * RP + c] =
          (gk < K && c < r) ? to_f32<T>(A[(size_t)gk * r + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xs[kk * XS_LD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const float av = As[kk * RP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) xa[i][c] = fmaf(xv[i], av, xa[i][c]);
      }
    }
    __syncthreads();   // tiles are free again (and, after the last pass, so
                       // is the memory the epilogue reuses)
  }

  // Epilogue: X@A, rounded once to T, meets this tile's columns of B.
  float* XAs = smem;                   // [BM][XA_LD]
  float* Bs = XAs + BM * XA_LD;        // [RP][BN]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < RC; ++c)
      XAs[(ty + 16 * i) * XA_LD + tx + 16 * c] = round_to<T>(xa[i][c]);
  for (int idx = tid; idx < RP * BN; idx += NT) {
    const int c = idx / BN, n = idx % BN;
    const int gn = n0 + n;
    Bs[c * BN + n] = (c < r && gn < N) ? to_f32<T>(B[(size_t)c * N + gn]) : 0.f;
  }
  __syncthreads();

  float ad[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ad[i][j] = 0.f;
  for (int c = 0; c < r; ++c) {
    float xv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = XAs[(ty + 16 * i) * XA_LD + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bs[c * BN + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ad[i][j] = fmaf(xv[i], bv[j], ad[i][j]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N)
        Y[(size_t)gm * N + gn] = from_f32<T>(acc[i][j] + scale * ad[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_lora_matmul(const void* x, const void* w, const void* a,
                               const void* b, void* y, int M, int K, int N,
                               int r, float scale, cudaStream_t stream) {
  const dim3 grid(ceil_div(N, BN), ceil_div(M, BM));
  const T* X = static_cast<const T*>(x);
  const T* W = static_cast<const T*>(w);
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  T* Y = static_cast<T*>(y);
  if (r <= 16)
    lora_matmul_kernel<T, 1><<<grid, NT, 0, stream>>>(X, W, A, B, Y, M, K, N, r, scale);
  else if (r <= 32)
    lora_matmul_kernel<T, 2><<<grid, NT, 0, stream>>>(X, W, A, B, Y, M, K, N, r, scale);
  else
    lora_matmul_kernel<T, 4><<<grid, NT, 0, stream>>>(X, W, A, B, Y, M, K, N, r, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// lora_matmul_grouped: the (G, M, K) activations are (G*M) rows, each with
// the adapter of its group. One block takes 8 rows and 32 output columns,
// loads the ids of its own rows and offsets the bank pointers by them: no
// gathered copy of the bank exists anywhere. 256 threads split K eight ways
// for the shared product x@W (one warp per K slice, 32 columns wide) and
// (256 / r) ways for x@A; both partial sums are reduced through shared
// memory. W is read once for all 8 rows of the block.
// ---------------------------------------------------------------------------

constexpr int G_RT = 8;       // rows per block
constexpr int G_BN = 32;      // output columns per block
constexpr int G_KG = 8;       // K slices of the x@W product
constexpr int G_KC = 1024;    // K chunk of x staged in shared memory
constexpr int G_RMAX = 64;    // largest rank

template <typename T>
__global__ void __launch_bounds__(NT)
lora_matmul_grouped_kernel(const T* __restrict__ X, const T* __restrict__ W,
                           const T* __restrict__ Abank,
                           const T* __restrict__ Bbank,
                           const int* __restrict__ ids, T* __restrict__ Y,
                           int rows, int rows_per_group, int K, int N, int r,
                           long long a_stride, long long b_stride, float scale) {
  __shared__ float xs[G_RT][G_KC];           // 32 KB
  __shared__ float red[G_RT][NT];            //  8 KB, both reductions
  __shared__ float xas[G_RT][G_RMAX + 1];
  __shared__ int row_id[G_RT];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * G_RT;
  const int n0 = blockIdx.x * G_BN;
  if (tid < G_RT) {
    const int row = row0 + tid;
    row_id[tid] = row < rows ? ids[row / rows_per_group] : 0;
  }

  // x@A: thread (kq, j) sums column j over k = kq, kq + kgroups, ...
  const int kgroups = NT / r;
  const bool xa_active = tid < kgroups * r;
  const int xa_j = tid % r;
  const int xa_kq = tid / r;
  // x@W: thread (kg, c) sums column n0 + c over k = kg, kg + G_KG, ...
  const int wc = tid % G_BN;
  const int wkg = tid / G_BN;
  const int col = n0 + wc;

  float pxa[G_RT], acc[G_RT];
#pragma unroll
  for (int rr = 0; rr < G_RT; ++rr) pxa[rr] = acc[rr] = 0.f;

  for (int kc0 = 0; kc0 < K; kc0 += G_KC) {
    const int kc_len = min(G_KC, K - kc0);
    __syncthreads();   // row_id visible; previous chunk's readers are done
    for (int idx = tid; idx < G_RT * G_KC; idx += NT) {
      const int rr = idx / G_KC, kk = idx % G_KC;
      const int row = row0 + rr;
      xs[rr][kk] = (row < rows && kk < kc_len)
                       ? to_f32<T>(X[(size_t)row * K + kc0 + kk]) : 0.f;
    }
    __syncthreads();

    if (xa_active) {
      for (int kk = xa_kq; kk < kc_len; kk += kgroups) {
        const size_t off = (size_t)(kc0 + kk) * r + xa_j;
#pragma unroll
        for (int rr = 0; rr < G_RT; ++rr) {
          const float av = to_f32<T>(Abank[(size_t)row_id[rr] * a_stride + off]);
          pxa[rr] = fmaf(xs[rr][kk], av, pxa[rr]);
        }
      }
    }
    if (col < N) {
#pragma unroll 8
      for (int kk = wkg; kk < kc_len; kk += G_KG) {
        const float wv = to_f32<T>(W[(size_t)(kc0 + kk) * N + col]);
#pragma unroll
        for (int rr = 0; rr < G_RT; ++rr) acc[rr] = fmaf(xs[rr][kk], wv, acc[rr]);
      }
    }
  }

  // reduce x@A over the k groups, round once to T
#pragma unroll
  for (int rr = 0; rr < G_RT; ++rr) red[rr][tid] = xa_active ? pxa[rr] : 0.f;
  __syncthreads();
  for (int idx = tid; idx < G_RT * r; idx += NT) {
    const int rr = idx / r, j = idx % r;
    float s = 0.f;
    for (int kq = 0; kq < kgroups; ++kq) s += red[rr][kq * r + j];
    xas[rr][j] = round_to<T>(s);
  }
  __syncthreads();

  // reduce x@W over the K slices, add the correction, store
#pragma unroll
  for (int rr = 0; rr < G_RT; ++rr) red[rr][tid] = acc[rr];
  __syncthreads();
  {
    const int rr = tid / G_BN;             // NT == G_RT * G_BN
    const int c = tid % G_BN;
    const int row = row0 + rr;
    const int gn = n0 + c;
    if (row < rows && gn < N) {
      float s = 0.f;
#pragma unroll
      for (int kg = 0; kg < G_KG; ++kg) s += red[rr][kg * G_BN + c];
      const T* Bp = Bbank + (size_t)row_id[rr] * b_stride;
      float ad = 0.f;
      for (int j = 0; j < r; ++j)
        ad = fmaf(xas[rr][j], to_f32<T>(Bp[(size_t)j * N + gn]), ad);
      Y[(size_t)row * N + gn] = from_f32<T>(s + scale * ad);
    }
  }
}

static_assert(NT == G_RT * G_BN, "store phase maps one thread to one output");
static_assert(NT == G_KG * G_BN, "x@W phase maps threads to (K slice, column)");

// ---------------------------------------------------------------------------
// lora_matmul_grouped, wide version: the same function and the same
// arithmetic for the shapes that 16-byte loads can serve (N and r multiples of
// the vector width, W and the bank 16-byte aligned). The first version above
// moves 2 bytes per load and is bound by load latency; here every load of W
// and of A moves 16 bytes. One warp per row computes that row's x@A (a warp
// reads 32 consecutive rows of A, 1 KB, per step) and reduces it by shuffles;
// for x@W a thread owns one 16-byte column vector and one of 64 K slices,
// and the slices are reduced by shuffles inside a warp and through shared
// memory across the 8 warps.
// ---------------------------------------------------------------------------

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&out)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

constexpr int W_CV = 4;              // 16-byte column vectors per block
constexpr int W_KG = NT / W_CV;      // K slices of the x@W product
constexpr unsigned FULL = 0xffffffffu;

template <typename T, int R>
__global__ void __launch_bounds__(NT)
lora_matmul_grouped_wide_kernel(const T* __restrict__ X, const T* __restrict__ W,
                                const T* __restrict__ Abank,
                                const T* __restrict__ Bbank,
                                const int* __restrict__ ids, T* __restrict__ Y,
                                int rows, int rows_per_group, int K, int N,
                                long long a_stride, long long b_stride,
                                float scale) {
  constexpr int VE = Vec<T>::N;
  constexpr int BNW = W_CV * VE;       // output columns per block
  constexpr int RV = R / VE;           // 16-byte vectors per row of A
  static_assert(R % VE == 0 && R <= G_RMAX, "rank must be whole vectors");
  static_assert(NT / 32 == G_RT, "one warp per row in the x@A phase");
  __shared__ float xs[G_RT][G_KC];              // 32 KB
  __shared__ float red[NT / 32][G_RT][BNW];     // <= 8 KB
  __shared__ float xas[G_RT][R];
  __shared__ int row_id[G_RT];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.y * G_RT;
  const int n0 = blockIdx.x * BNW;
  if (tid < G_RT) {
    const int row = row0 + tid;
    row_id[tid] = row < rows ? ids[row / rows_per_group] : 0;
  }
  const int cv = tid % W_CV;
  const int kg = tid / W_CV;
  const int col0 = n0 + cv * VE;       // N % VE == 0: a vector is in or out
  const bool col_ok = col0 < N;
  const bool row_ok = row0 + warp < rows;

  float pxa[R];
  float acc[G_RT][VE];
#pragma unroll
  for (int j = 0; j < R; ++j) pxa[j] = 0.f;
#pragma unroll
  for (int rr = 0; rr < G_RT; ++rr)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[rr][e] = 0.f;

  for (int kc0 = 0; kc0 < K; kc0 += G_KC) {
    const int kc_len = min(G_KC, K - kc0);
    __syncthreads();   // row_id visible; previous chunk's readers are done
    for (int idx = tid; idx < G_RT * G_KC; idx += NT) {
      const int rr = idx / G_KC, kk = idx % G_KC;
      const int row = row0 + rr;
      xs[rr][kk] = (row < rows && kk < kc_len)
                       ? to_f32<T>(X[(size_t)row * K + kc0 + kk]) : 0.f;
    }
    __syncthreads();

    if (row_ok) {      // x@A of row (row0 + warp), lanes stride over k
      const T* Ap = Abank + (size_t)row_id[warp] * a_stride + (size_t)kc0 * R;
#pragma unroll 4
      for (int kk = lane; kk < kc_len; kk += 32) {
        const float xv = xs[warp][kk];
#pragma unroll
        for (int jv = 0; jv < RV; ++jv) {
          float av[VE];
          load16(Ap + (size_t)kk * R + jv * VE, av);
#pragma unroll
          for (int e = 0; e < VE; ++e)
            pxa[jv * VE + e] = fmaf(xv, av[e], pxa[jv * VE + e]);
        }
      }
    }
    if (col_ok) {      // x@W, 8 rows against one column vector
#pragma unroll 4
      for (int kk = kg; kk < kc_len; kk += W_KG) {
        float wv[VE];
        load16(W + (size_t)(kc0 + kk) * N + col0, wv);
#pragma unroll
        for (int rr = 0; rr < G_RT; ++rr) {
          const float xv = xs[rr][kk];
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[rr][e] = fmaf(xv, wv[e], acc[rr][e]);
        }
      }
    }
  }

  // x@A: sum over the 32 lanes of the row's warp, round once to T
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float v = pxa[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    pxa[j] = v;
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) xas[warp][j] = round_to<T>(pxa[j]);
  }
  // x@W: lane = (kg % 8) * 4 + cv, so the K slices of a warp differ in lane
  // bits 2..4; the 8 warps meet in shared memory
#pragma unroll
  for (int rr = 0; rr < G_RT; ++rr)
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      float v = acc[rr][e];
      v += __shfl_xor_sync(FULL, v, 4);
      v += __shfl_xor_sync(FULL, v, 8);
      v += __shfl_xor_sync(FULL, v, 16);
      if (lane < W_CV) red[warp][rr][cv * VE + e] = v;
    }
  __syncthreads();

  for (int idx = tid; idx < G_RT * BNW; idx += NT) {
    const int rr = idx / BNW, c = idx % BNW;
    const int row = row0 + rr;
    const int gn = n0 + c;
    if (row < rows && gn < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) s += red[w][rr][c];
      const T* Bp = Bbank + (size_t)row_id[rr] * b_stride;
      float ad = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j)
        ad = fmaf(xas[rr][j], to_f32<T>(Bp[(size_t)j * N + gn]), ad);
      Y[(size_t)row * N + gn] = from_f32<T>(s + scale * ad);
    }
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int R>
cudaError_t launch_grouped_wide(const void* x, const void* w, const void* a,
                                const void* b, const void* ids, void* y,
                                int rows, int rows_per_group, int K, int N,
                                long long a_stride, long long b_stride,
                                float scale, cudaStream_t stream) {
  const dim3 grid(ceil_div(N, W_CV * Vec<T>::N), ceil_div(rows, G_RT));
  lora_matmul_grouped_wide_kernel<T, R><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const int*>(ids), static_cast<T*>(y), rows, rows_per_group,
      K, N, a_stride, b_stride, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_grouped(const void* x, const void* w, const void* a,
                           const void* b, const void* ids, void* y, int rows,
                           int rows_per_group, int K, int N, int r,
                           long long a_stride, long long b_stride, float scale,
                           cudaStream_t stream) {
  // the wide version where 16-byte loads fit, else the first version
  constexpr int VE = Vec<T>::N;
  const bool wide = N % VE == 0 && aligned16(w) && aligned16(a) &&
                    (a_stride * (long long)sizeof(T)) % 16 == 0;
  if (wide) {
    switch (r) {
      case 8:
        return launch_grouped_wide<T, 8>(x, w, a, b, ids, y, rows, rows_per_group, K, N, a_stride, b_stride, scale, stream);
      case 16:
        return launch_grouped_wide<T, 16>(x, w, a, b, ids, y, rows, rows_per_group, K, N, a_stride, b_stride, scale, stream);
      case 32:
        return launch_grouped_wide<T, 32>(x, w, a, b, ids, y, rows, rows_per_group, K, N, a_stride, b_stride, scale, stream);
      case 64:
        return launch_grouped_wide<T, 64>(x, w, a, b, ids, y, rows, rows_per_group, K, N, a_stride, b_stride, scale, stream);
      default:
        break;
    }
  }
  const dim3 grid(ceil_div(N, G_BN), ceil_div(rows, G_RT));
  lora_matmul_grouped_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const int*>(ids), static_cast<T*>(y), rows, rows_per_group,
      K, N, r, a_stride, b_stride, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes). Each function enqueues one kernel on
// the given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success). -1: arguments the kernels do not
// take.
extern "C" int lora_matmul_launch(const void* x, const void* w, const void* a,
                                  const void* b, void* y, int M, int K, int N,
                                  int r, float scale, int is_bf16,
                                  void* stream) {
  if (M < 1 || K < 1 || N < 1 || r < 1 || r > 64) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_lora_matmul<__nv_bfloat16>(x, w, a, b, y, M, K, N, r, scale, s)
              : launch_lora_matmul<float>(x, w, a, b, y, M, K, N, r, scale, s));
}

extern "C" int lora_matmul_grouped_launch(
    const void* x, const void* w, const void* a_bank, const void* b_bank,
    const void* ids, void* y, int rows, int rows_per_group, int K, int N, int r,
    long long a_stride, long long b_stride, float scale, int is_bf16,
    void* stream) {
  if (rows < 1 || rows_per_group < 1 || K < 1 || N < 1 || r < 1 || r > G_RMAX)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_grouped<__nv_bfloat16>(x, w, a_bank, b_bank, ids, y, rows,
                                              rows_per_group, K, N, r, a_stride,
                                              b_stride, scale, s)
              : launch_grouped<float>(x, w, a_bank, b_bank, ids, y, rows,
                                      rows_per_group, K, N, r, a_stride,
                                      b_stride, scale, s));
}
