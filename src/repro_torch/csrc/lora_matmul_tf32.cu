// lora_matmul on the tensor cores of Hopper (sm_90a), f32, written by hand:
//
//   Y = X @ W + s * (X @ A) @ B
//
// It takes the place of the Pallas TPU kernel lora_matmul of
// src/repro/kernels/lora_matmul.py for f32 inputs whose K, N and r are
// multiples of 4 (whole 16-byte copies), r <= 64, and whose pointers are
// 16-byte aligned; other f32 shapes stay on the SIMT kernel of
// lora_matmul.cu, bf16 on lora_matmul_tc.cu (the wrapper chooses by shape,
// dtype and alignment, never by failure).
//
// What bounds it on this card: at the calibrate path's shapes (M, K, N of
// 128 to 1024, r 8 or 16) the work is bound by operations: 2 M K N of them
// against 4 (M K + K N + M N) bytes. On the CUDA cores f32 runs at 67
// TFLOP/s; the tensor cores take tf32 operands only, so every product here
// is three tf32 products (csrc/tf32x3.cuh), 3 x 2 M K N at 495 TFLOP/s,
// which keeps f32 accuracy and is still 2.5x the CUDA cores' rate. The
// design:
//
//   * mma.sync m16n8k8 (wgmma takes tf32 only K-major, and W (K, N) lies
//     N-major); a block of four warps owns a 64 x 64 output tile, each warp
//     32 x 32 of it;
//   * X, W and A tiles (64 x 32, 32 x 64, 32 x r) in a three-stage ring of
//     16-byte cp.async copies (zero-filled past the ragged edges), rows
//     padded so that every fragment load is free of bank conflicts;
//   * each operand split into (hi, lo) by truncation (split_rz: three ALU
//     operations, where the rounding split takes two slow conversions),
//     once per use, in registers as each fragment is loaded from shared
//     memory (splitting each stage once in shared memory instead, into
//     fragment order, measured slower on the H100: PERF.md);
//   * X@A accumulates in the same K loop, also as three tf32 products, in
//     the blocks of the first N tile;
//   * split-K over blocks (the wrapper's tf32_plan), so that the calibrate
//     bench's 64 output tiles become at least 132 blocks; the f32 partial
//     sums go to a workspace and a reduce kernel adds the splits, applies
//     s * (X@A) @ B and stores Y once.
//
// Rounding order: that of the plain version and of the TPU kernel
// (kernels/ref.py): f32 sums; X@A is rounded to the activation dtype before
// it meets B, which in f32 is no rounding at all. Nothing carries over
// between calls and nothing synchronises with the host, so the call can be
// captured in a CUDA graph (the calibrate path's timer does).

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using repro::ceil_div;
using repro::sm90::cp_async16;
using repro::sm90::cp_async_commit;
using repro::sm90::cp_async_wait;
using repro::sm90::smem_u32;
using repro::tf32x3::mma3;
using repro::tf32x3::split_rz;

constexpr int BM = 64;                  // rows of a tile
constexpr int BN = 64;                  // columns of a tile
constexpr int BK = 32;                  // K per stage
constexpr int NT = 128;                 // 4 warps, 2 x 2, 32 x 32 each
constexpr int STAGES = 3;
constexpr int LDX = BK + 4;             // row g, column t: bank 4g + t
constexpr int LDW = BN + 8;             // row t, column g: bank 8t + g
constexpr int MAX_R = 64;
constexpr int KB = BK / 8;              // k blocks of a stage

// XT: n8 tiles of X@A per warp (r <= 16 XT); the two column warps take
// columns [8 XT wn, 8 XT (wn + 1)).
template <int XT>
struct Tile {
  static constexpr int RA = 16 * XT;             // columns of A staged
  static constexpr int LDA = RA + 8;             // 24, 40 or 72: conflict-free
  static constexpr int X_OFF = 0;
  static constexpr int W_OFF = BM * LDX;
  static constexpr int A_OFF = W_OFF + BK * LDW;
  static constexpr int STAGE = A_OFF + BK * LDA;  // floats
  static constexpr size_t BYTES = sizeof(float) * STAGES * STAGE;
};

// (hi, lo) of the b fragment at p: b0 = p[0], b1 = p[4 ld]
__device__ __forceinline__ float4 split_b(const float* p, int ld) {
  uint32_t h0, l0, h1, l1;
  split_rz(p[0], h0, l0);
  split_rz(p[4 * ld], h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(l0),
                     __uint_as_float(h1), __uint_as_float(l1));
}

// (hi, lo) of the a fragment whose element (g, t) is at p
__device__ __forceinline__ void split_a(const float* p, int ld,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_rz(p[0], hi[0], lo[0]);
  split_rz(p[8 * ld], hi[1], lo[1]);
  split_rz(p[4], hi[2], lo[2]);
  split_rz(p[8 * ld + 4], hi[3], lo[3]);
}

// One block: a (64, 64) tile of X@W (and, in the blocks of the first N
// tile, the (64, r) tile of X@A) over its K range; the f32 partial sums go
// to ws_y[split] and ws_xa[split].
template <int XT>
__global__ void __launch_bounds__(NT)
lora_matmul_tf32_split_kernel(const float* __restrict__ X,
                              const float* __restrict__ W,
                              const float* __restrict__ A,
                              float* __restrict__ ws_y,
                              float* __restrict__ ws_xa, int M, int K, int N,
                              int r, int iters_per_split) {
  using T = Tile<XT>;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int split_id = blockIdx.z;
  const int it0 = split_id * iters_per_split;
  const int n_it = min(iters_per_split, ceil_div(K, BK) - it0);   // >= 1
  const bool do_xa = blockIdx.x == 0;          // uniform over the block

  auto load = [&](int stage, int it) {
    float* sb = ring + stage * T::STAGE;
    const int k0 = (it0 + it) * BK;
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / NT; ++i) {        // X: 64 rows x 8
      const int c = tid + i * NT, row = c >> 3, q = c & 7;
      const int gm = m0 + row, gk = k0 + 4 * q;
      const bool ok = gm < M && gk < K;
      cp_async16(smem_u32(sb + T::X_OFF + row * LDX + 4 * q),
                 ok ? X + (size_t)gm * K + gk : X, ok);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / NT; ++i) {        // W: 32 rows x 16
      const int c = tid + i * NT, row = c >> 4, q = c & 15;
      const int gk = k0 + row, gn = n0 + 4 * q;
      const bool ok = gk < K && gn < N;
      cp_async16(smem_u32(sb + T::W_OFF + row * LDW + 4 * q),
                 ok ? W + (size_t)gk * N + gn : W, ok);
    }
    if (do_xa) {
#pragma unroll
      for (int i = 0; i < XT; ++i) {                    // A: 32 rows x 4 XT
        const int c = tid + i * NT, row = c / (4 * XT), q = c % (4 * XT);
        const int gk = k0 + row;
        const bool ok = gk < K && 4 * q < r;
        cp_async16(smem_u32(sb + T::A_OFF + row * T::LDA + 4 * q),
                   ok ? A + (size_t)gk * r + 4 * q : A, ok);
      }
    }
  };

  float acc[2][4][4];
  float xa[2][XT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < XT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xa[i][n][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<STAGES - 2>();        // this thread's copies of stage `it`
    __syncthreads();                    // everyone's; stage it - 1 is free
    if (it + STAGES - 1 < n_it)
      load((it + STAGES - 1) % STAGES, it + STAGES - 1);
    cp_async_commit();
    const float* sb = ring + (it % STAGES) * T::STAGE;
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      uint32_t ahi[2][4], alo[2][4];
      float4 bq[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        split_a(sb + T::X_OFF + (32 * wm + 16 * i + g) * LDX + 8 * kb + t,
                LDX, ahi[i], alo[i]);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        bq[n] = split_b(sb + T::W_OFF + (8 * kb + t) * LDW + 32 * wn + 8 * n +
                            g,
                        LDW);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma3<4>(acc[i], ahi[i], alo[i], bq);
      if (do_xa) {
        float4 bx[XT];
#pragma unroll
        for (int n = 0; n < XT; ++n)
          bx[n] = split_b(sb + T::A_OFF + (8 * kb + t) * T::LDA +
                              8 * (XT * wn + n) + g,
                          T::LDA);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma3<XT>(xa[i], ahi[i], alo[i], bx);
      }
    }
  }

  // f32 partials, two neighbouring columns per store
  float* py = ws_y + (size_t)split_id * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ra = m0 + 32 * wm + 16 * i + g, rb = ra + 8;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = n0 + 32 * wn + 8 * n + 2 * t;
      if (col >= N) continue;
      if (ra < M)
        *reinterpret_cast<float2*>(py + (size_t)ra * N + col) =
            make_float2(acc[i][n][0], acc[i][n][1]);
      if (rb < M)
        *reinterpret_cast<float2*>(py + (size_t)rb * N + col) =
            make_float2(acc[i][n][2], acc[i][n][3]);
    }
  }
  if (do_xa) {
    float* pa = ws_xa + (size_t)split_id * M * r;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ra = m0 + 32 * wm + 16 * i + g, rb = ra + 8;
#pragma unroll
      for (int n = 0; n < XT; ++n) {
        const int col = 8 * (XT * wn + n) + 2 * t;
        if (col >= r) continue;
        if (ra < M)
          *reinterpret_cast<float2*>(pa + (size_t)ra * r + col) =
              make_float2(xa[i][n][0], xa[i][n][1]);
        if (rb < M)
          *reinterpret_cast<float2*>(pa + (size_t)rb * r + col) =
              make_float2(xa[i][n][2], xa[i][n][3]);
      }
    }
  }
}

// The reduction over the splits and the epilogue: 2 rows x 512 columns at
// a time, four neighbouring columns per thread (16-byte loads and stores);
// a block steps over the row pairs gridDim.y apart, so any M fits the grid.
// X@A of the rows is summed over the splits in shared memory; each thread
// adds the splits of its X@W columns and the correction s * (X@A) @ B, and
// stores once.
constexpr int R_ROWS = 2;
constexpr int R_THREADS = 128;
constexpr int R_COLS = 4 * R_THREADS;

__device__ __forceinline__ void fma4(float4& d, float a, float4 b) {
  d.x = fmaf(a, b.x, d.x); d.y = fmaf(a, b.y, d.y);
  d.z = fmaf(a, b.z, d.z); d.w = fmaf(a, b.w, d.w);
}

__global__ void __launch_bounds__(R_THREADS)
lora_matmul_tf32_reduce_kernel(const float* __restrict__ ws_y,
                               const float* __restrict__ ws_xa,
                               const float* __restrict__ B,
                               float* __restrict__ Y, int M, int N, int r,
                               int splits, float scale) {
  __shared__ float xas[R_ROWS][MAX_R];
  const int tid = threadIdx.x;
  const int col = blockIdx.x * R_COLS + 4 * tid;
  const bool active = col < N;             // N % 4 == 0: all four or none
  for (int row0 = blockIdx.y * R_ROWS; row0 < M;
       row0 += gridDim.y * R_ROWS) {       // uniform over the block
    __syncthreads();                       // the last pair's xas is read
    for (int idx = tid; idx < R_ROWS * r; idx += R_THREADS) {
      const int rr = idx / r, j = idx % r;
      const int row = row0 + rr;
      float s = 0.f;
      if (row < M)
        for (int sp = 0; sp < splits; ++sp)
          s += ws_xa[((size_t)sp * M + row) * r + j];
      xas[rr][j] = s;
    }
    __syncthreads();
    if (!active) continue;
    float4 ad[R_ROWS];
#pragma unroll
    for (int rr = 0; rr < R_ROWS; ++rr)
      ad[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < r; ++j) {
      const float4 bv =
          *reinterpret_cast<const float4*>(B + (size_t)j * N + col);
#pragma unroll
      for (int rr = 0; rr < R_ROWS; ++rr) fma4(ad[rr], xas[rr][j], bv);
    }
#pragma unroll
    for (int rr = 0; rr < R_ROWS; ++rr) {
      const int row = row0 + rr;
      if (row >= M) break;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sp = 0; sp < splits; ++sp) {
        const float4 v = *reinterpret_cast<const float4*>(
            ws_y + ((size_t)sp * M + row) * N + col);
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      *reinterpret_cast<float4*>(Y + (size_t)row * N + col) =
          make_float4(s.x + scale * ad[rr].x, s.y + scale * ad[rr].y,
                      s.z + scale * ad[rr].z, s.w + scale * ad[rr].w);
    }
  }
}

template <int XT>
cudaError_t launch(const float* x, const float* w, const float* a,
                   const float* b, float* y, float* ws_y, float* ws_xa, int M,
                   int K, int N, int r, float scale, int splits,
                   int iters_per_split, cudaStream_t stream) {
  auto kernel = lora_matmul_tf32_split_kernel<XT>;
  const size_t bytes = Tile<XT>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(N, BN), ceil_div(M, BM), splits);
  kernel<<<grid, NT, bytes, stream>>>(x, w, a, ws_y, ws_xa, M, K, N, r,
                                      iters_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int row_pairs = ceil_div(M, R_ROWS);
  const dim3 rgrid(ceil_div(N, R_COLS), row_pairs < 65535 ? row_pairs : 65535);
  lora_matmul_tf32_reduce_kernel<<<rgrid, R_THREADS, 0, stream>>>(
      ws_y, ws_xa, b, y, M, N, r, splits, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues the split kernel and the
// reduction on the given stream, does not synchronise, allocates nothing,
// returns the cudaError_t of the launches (0 on success); -1: arguments the
// kernel does not take. x (M, K), w (K, N), a (K, r), b (r, N), y (M, N)
// contiguous f32; x, w, a, b, y and the workspaces 16-byte aligned; K, N, r
// multiples of 4, r <= 64. ws_y holds splits * M * N floats, ws_xa
// splits * M * r; the split plan (splits, iters_per_split: 32-deep K steps
// per split) comes from the wrapper's tf32_plan and covers ceil(K / 32)
// steps, none empty.
extern "C" int lora_matmul_tf32_launch(const void* x, const void* w,
                                       const void* a, const void* b, void* y,
                                       void* ws_y, void* ws_xa, int M, int K,
                                       int N, int r, float scale, int splits,
                                       int iters_per_split, void* stream) {
  const int n_iters = ceil_div(K, BK);
  if (M < 1 || K < 4 || N < 4 || r < 4 || r > MAX_R || K % 4 || N % 4 ||
      r % 4 || splits < 1 || iters_per_split < 1 || splits > 65535 ||
      ceil_div(M, BM) > 65535 || (splits - 1) * iters_per_split >= n_iters ||
      splits * iters_per_split < n_iters ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(ws_y) |
       reinterpret_cast<uintptr_t>(ws_xa)) % 16)
    return -1;
  const float* xx = static_cast<const float*>(x);
  const float* ww = static_cast<const float*>(w);
  const float* aa = static_cast<const float*>(a);
  const float* bb = static_cast<const float*>(b);
  float* yy = static_cast<float*>(y);
  float* wy = static_cast<float*>(ws_y);
  float* wa = static_cast<float*>(ws_xa);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r <= 16)
    return static_cast<int>(launch<1>(xx, ww, aa, bb, yy, wy, wa, M, K, N, r,
                                      scale, splits, iters_per_split, s));
  if (r <= 32)
    return static_cast<int>(launch<2>(xx, ww, aa, bb, yy, wy, wa, M, K, N, r,
                                      scale, splits, iters_per_split, s));
  return static_cast<int>(launch<4>(xx, ww, aa, bb, yy, wy, wa, M, K, N, r,
                                    scale, splits, iters_per_split, s));
}
