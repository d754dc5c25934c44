// lora_matmul on the tensor cores of Hopper (sm_90a), bf16, written by hand:
//
//   Y = X @ W + s * round_bf16(X @ A) @ B
//
// It takes the place of the Pallas TPU kernel lora_matmul of
// src/repro/kernels/lora_matmul.py for bf16 inputs whose K, N and r are
// multiples of 8 and whose pointers are 16-byte aligned; every other shape
// and f32 stay on the SIMT kernel of lora_matmul.cu (the wrapper chooses by
// shape, dtype and alignment, never by failure).
//
// What bounds it on this card: at the serving shapes (M = 64 rows of a
// prefill chunk, K in {2048, 8192}, N in {512, 2048, 8192}, r = 16) the
// function does 64 FLOP per byte of W, far below the ~295 at which the
// tensor cores and not device memory are the limit. So the design is about
// keeping enough bytes of W in flight on every SM:
//
//   * split-K over blocks: the grid is (N tiles, M tiles, K splits), sized
//     by the wrapper's plan so that at least one block runs per SM at every
//     serving shape (32 output tiles alone would leave 100 SMs idle);
//   * a ring of three shared-memory stages, each filled by 16-byte cp.async
//     (zero-filled past the ragged edges), two stages in flight while the
//     third is multiplied, two blocks per SM;
//   * the products on the tensor cores: wgmma m64nNk16 with X as the
//     K-major A operand and W (K, N) and A (K, r) read N-contiguous as
//     MN-major B operands through the transpose bit, so nothing is
//     transposed in memory. X@A is a second product over the same X tile,
//     with A's r columns padded to one 64-wide panel by zero chunks.
//
// Rounding contract (that of the TPU kernel, kernels/ref.py and the plain
// version): every product accumulates in f32; X@A is summed over ALL of K
// and rounded once to bf16; the correction is round_bf16(X@A) @ B in f32;
// X@W + s * correction is rounded once to bf16. With split-K the partial
// sums of X@W and X@A go to an f32 workspace, and a second small kernel adds
// the splits, rounds X@A, applies B and rounds the output: nothing is
// rounded before the reduction, and nothing carries over between calls
// (every workspace element is written before it is read, so there is no
// counter or semaphore to reset). No host synchronisation: the call can be
// captured in a CUDA graph.

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::ceil_div;
using namespace repro::sm90;
using bf16 = __nv_bfloat16;

constexpr int TBM = 64;                 // rows of a tile: one warpgroup
constexpr int TBK = 64;                 // K per stage: one 128-byte row
constexpr int STAGES = 3;
constexpr int NT = 128;                 // one warpgroup
constexpr int PANEL = 64 * 128;         // one 64 x 64 bf16 panel, bytes
constexpr int MAX_R = 64;               // X@A fits one panel

template <int BN>
struct Tile {
  static constexpr int X_OFF = 0;
  static constexpr int W_OFF = PANEL;                   // BN / 64 panels
  static constexpr int A_OFF = W_OFF + (BN / 64) * PANEL;
  static constexpr int STAGE = A_OFF + PANEL;
  static constexpr int SMEM = STAGES * STAGE + 1024;    // + alignment slack
};

// One block: a (64, BN) tile of X@W (and, in the blocks of the first N
// tile, the (64, r) tile of X@A) over its K range; the f32 partial sums
// go to ws_y[split] and ws_xa[split].
template <int BN>
__global__ void __launch_bounds__(NT, 2)
lora_matmul_tc_split_kernel(const bf16* __restrict__ X, const bf16* __restrict__ W,
                            const bf16* __restrict__ A, float* __restrict__ ws_y,
                            float* __restrict__ ws_xa, int M, int K, int N,
                            int r, int iters_per_split) {
  using T = Tile<BN>;
  constexpr int WCH = BN / 8;           // 16-byte chunks across a W row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base_1k(smem_raw);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * TBM;
  const int split = blockIdx.z;
  const int it0 = split * iters_per_split;
  const int n_it = min(iters_per_split, ceil_div(K, TBK) - it0);   // >= 1
  const bool do_xa = blockIdx.x == 0;   // uniform over the block

  // A thread keeps one chunk column of each tile and walks rows a multiple
  // of 8 apart, so its swizzled offset moves by whole 1024-byte atoms.
  const int xc = tid & 7, xr = tid >> 3;               // X and A: 16 rows a pass
  const int wc = tid % WCH, wr = tid / WCH;            // W: 8 or 16 rows a pass
  const uint32_t x_dst = T::X_OFF + swz128(xr, xc);
  const uint32_t w_dst = T::W_OFF + (wc >> 3) * PANEL + swz128(wr, wc & 7);
  const uint32_t a_dst = T::A_OFF + swz128(xr, xc);
  auto load = [&](int stage, int it) {
    const uint32_t sb = base + stage * T::STAGE;
    const int k0 = (it0 + it) * TBK;
#pragma unroll
    for (int j = 0; j < TBM / 16; ++j) {                 // X: 64 rows x 8
      const int gm = m0 + xr + 16 * j, gk = k0 + 8 * xc;
      const bool ok = gm < M && gk < K;
      cp_async16(sb + x_dst + j * 16 * 128,
                 ok ? X + (size_t)gm * K + gk : X, ok);
    }
#pragma unroll
    for (int j = 0; j < TBK * WCH / NT; ++j) {           // W: 64 k-rows
      const int gk = k0 + wr + j * (NT / WCH), gn = n0 + 8 * wc;
      const bool ok = gk < K && gn < N;
      cp_async16(sb + w_dst + j * (NT / WCH) * 128,
                 ok ? W + (size_t)gk * N + gn : W, ok);
    }
    if (do_xa) {
#pragma unroll
      for (int j = 0; j < TBK / 16; ++j) {               // A: 64 k-rows
        const int gk = k0 + xr + 16 * j;
        const bool ok = gk < K && 8 * xc < r;
        cp_async16(sb + a_dst + j * 16 * 128,
                   ok ? A + (size_t)gk * r + 8 * xc : A, ok);
      }
    }
  };

  float acc[BN / 2];
  float xa[32];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) xa[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<STAGES - 2>();        // this thread's copies of stage `it`
    fence_proxy_async();
    __syncthreads();                    // everyone's copies; stage it-1 free
    if (it + STAGES - 1 < n_it) load((it + STAGES - 1) % STAGES, it + STAGES - 1);
    cp_async_commit();

    const uint32_t sb = base + (it % STAGES) * T::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk) {
      const uint64_t da = desc128(sb + T::X_OFF + 32 * kk, 16, 1024);
      wgmma_ss<1>(acc, da, desc128(sb + T::W_OFF + 2048 * kk, PANEL, 1024));
      if (do_xa)
        wgmma_ss<1>(xa, da, desc128(sb + T::A_OFF + 2048 * kk, PANEL, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(xa);
  }

  // f32 partials, two neighbouring columns per store
  float* py = ws_y + (size_t)split * M * N;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int row = m0 + acc_row(tid, i), col = n0 + acc_col(tid, i);
    if (row < M && col < N)
      *reinterpret_cast<float2*>(py + (size_t)row * N + col) =
          make_float2(acc[i], acc[i + 1]);
  }
  if (do_xa) {
    float* pa = ws_xa + (size_t)split * M * r;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = m0 + acc_row(tid, i), col = acc_col(tid, i);
      if (row < M && col < r)
        *reinterpret_cast<float2*>(pa + (size_t)row * r + col) =
            make_float2(xa[i], xa[i + 1]);
    }
  }
}

// The reduction over the splits and the epilogue: 2 rows x 128 columns per
// block, one column per thread (small blocks, so that even N = 512 spreads
// over 128 of them). X@A of the rows is summed over the splits and rounded
// once to bf16 in shared memory; then each thread adds the splits of its
// X@W column, the correction with B, and rounds once.
constexpr int R_ROWS = 2;
constexpr int R_COLS = 128;

__global__ void __launch_bounds__(R_COLS)
lora_matmul_tc_reduce_kernel(const float* __restrict__ ws_y,
                             const float* __restrict__ ws_xa,
                             const bf16* __restrict__ B, bf16* __restrict__ Y,
                             int M, int N, int r, int splits, float scale) {
  __shared__ float xas[R_ROWS][MAX_R];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * R_ROWS;
  for (int idx = tid; idx < R_ROWS * r; idx += R_COLS) {
    const int rr = idx / r, j = idx % r;
    const int row = row0 + rr;
    float s = 0.f;
    if (row < M)
      for (int sp = 0; sp < splits; ++sp)
        s += ws_xa[((size_t)sp * M + row) * r + j];
    xas[rr][j] = repro::round_to<bf16>(s);
  }
  __syncthreads();
  const int col = blockIdx.x * R_COLS + tid;
  if (col >= N) return;
  float ad[R_ROWS];
#pragma unroll
  for (int rr = 0; rr < R_ROWS; ++rr) ad[rr] = 0.f;
  for (int j = 0; j < r; ++j) {
    const float bv = __bfloat162float(B[(size_t)j * N + col]);
#pragma unroll
    for (int rr = 0; rr < R_ROWS; ++rr) ad[rr] = fmaf(xas[rr][j], bv, ad[rr]);
  }
#pragma unroll
  for (int rr = 0; rr < R_ROWS; ++rr) {
    const int row = row0 + rr;
    if (row >= M) break;
    float s = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < splits; ++sp)
      s += ws_y[((size_t)sp * M + row) * N + col];
    Y[(size_t)row * N + col] = __float2bfloat16_rn(s + scale * ad[rr]);
  }
}

template <int BN>
cudaError_t launch(const void* x, const void* w, const void* a, const void* b,
                   void* y, float* ws_y, float* ws_xa, int M, int K, int N,
                   int r, float scale, int splits, int iters_per_split,
                   cudaStream_t stream) {
  auto kernel = lora_matmul_tc_split_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(N, BN), ceil_div(M, TBM), splits);
  kernel<<<grid, NT, Tile<BN>::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(a), ws_y, ws_xa, M, K, N, r, iters_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 rgrid(ceil_div(N, R_COLS), ceil_div(M, R_ROWS));
  lora_matmul_tc_reduce_kernel<<<rgrid, R_COLS, 0, stream>>>(
      ws_y, ws_xa, static_cast<const bf16*>(b), static_cast<bf16*>(y), M, N, r,
      splits, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues the split kernel and the
// reduction on the given stream, does not synchronise, allocates nothing,
// returns the cudaError_t of the launches (0 on success); -1: arguments
// the kernel does not take. x (M, K), w (K, N), a (K, r), b (r, N), y (M, N)
// contiguous bf16, 16-byte aligned; K, N, r multiples of 8, r <= 64.
// ws_y holds splits * M * N floats, ws_xa splits * M * r; the split plan
// (bn in {64, 128}, splits, iters_per_split: 64-deep K steps per split)
// comes from the wrapper and covers ceil(K / 64) steps, none empty.
extern "C" int lora_matmul_tc_launch(const void* x, const void* w,
                                     const void* a, const void* b, void* y,
                                     void* ws_y, void* ws_xa, int M, int K,
                                     int N, int r, float scale, int bn,
                                     int splits, int iters_per_split,
                                     void* stream) {
  const int n_iters = ceil_div(K, TBK);
  if (M < 1 || K < 8 || N < 8 || r < 8 || r > MAX_R || K % 8 || N % 8 ||
      r % 8 || splits < 1 || iters_per_split < 1 || splits > 65535 ||
      (splits - 1) * iters_per_split >= n_iters ||
      splits * iters_per_split < n_iters)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wy = static_cast<float*>(ws_y);
  float* wa = static_cast<float*>(ws_xa);
  if (bn == 128)
    return static_cast<int>(launch<128>(x, w, a, b, y, wy, wa, M, K, N, r, scale,
                                        splits, iters_per_split, s));
  if (bn == 64)
    return static_cast<int>(launch<64>(x, w, a, b, y, wy, wa, M, K, N, r, scale,
                                       splits, iters_per_split, s));
  return -1;
}
