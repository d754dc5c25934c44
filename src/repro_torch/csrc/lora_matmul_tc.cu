// lora_matmul on the tensor cores of Hopper (sm_90a), bf16, written by hand:
//
//   Y = X @ W + s * round_bf16(X @ A) @ B
//
// It takes the place of the Pallas TPU kernel lora_matmul of
// src/repro/kernels/lora_matmul.py for bf16 inputs whose K, N and r are
// multiples of 8 (r <= 256) and whose pointers are 16-byte aligned; every
// other shape and f32 stay on the SIMT kernel of lora_matmul.cu (the wrapper
// chooses by shape, dtype and alignment, never by failure).
//
// What bounds it on this card: at the serving shapes (M = 64 rows of a
// prefill chunk, K in {2048, 8192}, N in {512, 2048, 8192}, r = 16) the
// function does 64 FLOP per byte of W, far below the ~295 at which the
// tensor cores and not device memory are the limit. At r = 128 it stays a
// stream of W: X@A adds 2r/N of the operations (3.6 % at N = 7168) and A and
// B 3.6 MB to W's 102.8 MB. So the design is about keeping enough bytes of W
// in flight on every SM:
//
//   * split-K over blocks: the grid is (N tiles + rank panels, M tiles,
//     K splits), sized by the wrapper's plan so that at least one block runs
//     per SM at every serving shape (32 output tiles alone would leave 100
//     SMs idle);
//   * a ring of three shared-memory stages, each filled by 16-byte cp.async
//     (zero-filled past the ragged edges), two stages in flight while the
//     third is multiplied, two blocks per SM;
//   * the products on the tensor cores: wgmma m64nNk16 with X as the
//     K-major A operand and W (K, N) and A (K, r) read N-contiguous as
//     MN-major B operands through the transpose bit, so nothing is
//     transposed in memory;
//   * X@A in 64-rank panels, each in blocks of its own after the N tiles
//     along grid x: a panel block streams the X tile and its 64 columns of
//     A (zero chunks past r) through the ring in place of W. So a rank of
//     256 adds four short blocks per (M tile, split) and lengthens no block
//     of W, and every block keeps the registers and shared memory of two
//     blocks per SM.
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
constexpr int RP = 64;                  // ranks of one X@A panel
constexpr int MAX_R = 256;              // four panels

template <int BN>
struct Tile {
  static constexpr int X_OFF = 0;
  static constexpr int W_OFF = PANEL;   // BN / 64 panels of W, or A's panel
  static constexpr int STAGE = W_OFF + (BN / 64) * PANEL;
  static constexpr int SMEM = STAGES * STAGE + 1024;    // + alignment slack
};

// One block over its K range: for blockIdx.x < n_tiles the (64, BN) tile of
// X@W at columns blockIdx.x * BN, its f32 partial sums to ws_y[split]; past
// the N tiles the (64, 64) tile of X@A at ranks 64 * (blockIdx.x - n_tiles),
// its partial sums to ws_xa[split].
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
  const int n_tiles = ceil_div(N, BN);
  const bool do_w = blockIdx.x < n_tiles;   // uniform over the block
  const int n0 = blockIdx.x * BN;           // do_w: first column of W
  const int p0 = (blockIdx.x - n_tiles) * RP;   // !do_w: first rank of A
  const int m0 = blockIdx.y * TBM;
  const int split = blockIdx.z;
  const int it0 = split * iters_per_split;
  const int n_it = min(iters_per_split, ceil_div(K, TBK) - it0);   // >= 1

  // A thread keeps one chunk column of each tile and walks rows a multiple
  // of 8 apart, so its swizzled offset moves by whole 1024-byte atoms.
  const int xc = tid & 7, xr = tid >> 3;               // X and A: 16 rows a pass
  const int wc = tid % WCH, wr = tid / WCH;            // W: 8 or 16 rows a pass
  const uint32_t x_dst = T::X_OFF + swz128(xr, xc);
  const uint32_t w_dst = T::W_OFF + (wc >> 3) * PANEL + swz128(wr, wc & 7);
  const uint32_t a_dst = T::W_OFF + swz128(xr, xc);
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
    if (do_w) {
#pragma unroll
      for (int j = 0; j < TBK * WCH / NT; ++j) {         // W: 64 k-rows
        const int gk = k0 + wr + j * (NT / WCH), gn = n0 + 8 * wc;
        const bool ok = gk < K && gn < N;
        cp_async16(sb + w_dst + j * (NT / WCH) * 128,
                   ok ? W + (size_t)gk * N + gn : W, ok);
      }
    } else {
#pragma unroll
      for (int j = 0; j < TBK / 16; ++j) {               // A: 64 k-rows
        const int gk = k0 + xr + 16 * j, gr = p0 + 8 * xc;
        const bool ok = gk < K && gr < r;
        cp_async16(sb + a_dst + j * 16 * 128,
                   ok ? A + (size_t)gk * r + gr : A, ok);
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
      const uint64_t db = desc128(sb + T::W_OFF + 2048 * kk, PANEL, 1024);
      if (do_w)
        wgmma_ss<1>(acc, da, db);
      else
        wgmma_ss<1>(xa, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(xa);
  }

  // f32 partials, two neighbouring columns per store
  if (do_w) {
    float* py = ws_y + (size_t)split * M * N;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int row = m0 + acc_row(tid, i), col = n0 + acc_col(tid, i);
      if (row < M && col < N)
        *reinterpret_cast<float2*>(py + (size_t)row * N + col) =
            make_float2(acc[i], acc[i + 1]);
    }
  } else {
    float* pa = ws_xa + (size_t)split * M * r;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = m0 + acc_row(tid, i), col = p0 + acc_col(tid, i);
      if (row < M && col < r)
        *reinterpret_cast<float2*>(pa + (size_t)row * r + col) =
            make_float2(xa[i], xa[i + 1]);
    }
  }
}

// The reduction over the splits and the epilogue at r <= 64: 2 rows x 128
// columns per block, one column per thread (small blocks, so that even
// N = 512 spreads over 128 of them). X@A of the rows is summed over the
// splits and rounded once to bf16 in shared memory; then each thread adds
// the splits of its X@W column, the correction with B, and rounds once.
constexpr int R_ROWS = 2;
constexpr int R_COLS = 128;

__global__ void __launch_bounds__(R_COLS)
lora_matmul_tc_reduce_kernel(const float* __restrict__ ws_y,
                             const float* __restrict__ ws_xa,
                             const bf16* __restrict__ B, bf16* __restrict__ Y,
                             int M, int N, int r, int splits, float scale) {
  __shared__ float xas[R_ROWS][RP];
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

// At r > 64 the correction round_bf16(X@A) @ B is a product of depth r
// (235 MFLOP at r = 256, M = 64, N = 7168), and a loop of r dependent loads
// of B a thread costs r round trips (measured: the loop took 51 us at
// r = 128). So it runs on the tensor cores, after a small kernel that sums
// X@A over the splits once, rounds it once to bf16 and writes it (M, r)
// after ws_xa: one thread an element, its splits read eight at a time.
__global__ void __launch_bounds__(R_COLS)
lora_matmul_tc_xa_kernel(const float* __restrict__ ws_xa,
                         bf16* __restrict__ xab, int M, int r, int splits) {
  const int idx = blockIdx.x * R_COLS + threadIdx.x;
  if (idx < M * r)
    xab[idx] = __float2bfloat16_rn(
        repro::sum_strided(ws_xa + idx, (size_t)M * r, splits));
}

// Then one (64, 64) output tile a block (one warpgroup): B's (r, 64) tile
// (the MN-major operand) and the tile's rows of round_bf16(X@A) (the
// K-major operand, 64-rank panels) copied by cp.async, all at once, zeros
// past M, r and N; the splits of X@W summed while they land (two splits'
// loads at a time); wgmma m64n64k16 over ceil(r / 16) steps; each output
// rounded once.
__global__ void __launch_bounds__(NT)
lora_matmul_tc_reduce_tc_kernel(const float* __restrict__ ws_y,
                                const bf16* __restrict__ xab,
                                const bf16* __restrict__ B,
                                bf16* __restrict__ Y, int M, int N, int r,
                                int splits, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base_1k(smem_raw);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * RP, m0 = blockIdx.y * TBM;
  const int r16 = ceil_div(r, 16) * 16;       // depth of the products
  const uint32_t b_off = ceil_div(r16, RP) * PANEL;   // after X@A's panels

  // B[0:r16, n0:n0+64]: row j of the panel is rank j
  for (int idx = tid; idx < r16 * 8; idx += NT) {
    const int j = idx >> 3, c = idx & 7, gn = n0 + 8 * c;
    const bool ok = j < r && gn < N;
    cp_async16(base + b_off + swz128(j, c), ok ? B + (size_t)j * N + gn : B,
               ok);
  }
  // X@A[m0:m0+64, 0:r16]: chunk c of row m at panel c / 8
  for (int idx = tid; idx < TBM * (r16 / 8); idx += NT) {
    const int m = idx / (r16 / 8), c = idx % (r16 / 8);
    const bool ok = m0 + m < M && 8 * c < r;
    cp_async16(base + (c / 8) * PANEL + swz128(m, c % 8),
               ok ? xab + (size_t)(m0 + m) * r + 8 * c : xab, ok);
  }
  cp_async_commit();

  // X@W over the splits for this thread's outputs, while they land: the
  // loads of two splits go out before either is added
  float sy[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sy[i] = 0.f;
  for (int sp = 0; sp < splits; sp += 2) {
    float2 v[2][16];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* py = ws_y + (size_t)(sp + h) * M * N;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = m0 + acc_row(tid, i), col = n0 + acc_col(tid, i);
        v[h][i / 2] = sp + h < splits && row < M && col < N
            ? *reinterpret_cast<const float2*>(py + (size_t)row * N + col)
            : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        sy[i] += v[h][i / 2].x;
        sy[i + 1] += v[h][i / 2].y;
      }
  }

  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  float ad[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) ad[i] = 0.f;
  wgmma_fence();
  for (int kk = 0; kk < r16 / 16; ++kk)
    wgmma_ss<1>(ad,
                desc128(base + (kk / 4) * PANEL + 32 * (kk % 4), 16, 1024),
                desc128(base + b_off + 2048 * kk, PANEL, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(ad);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = m0 + acc_row(tid, i), col = n0 + acc_col(tid, i);
    if (row < M && col < N)
      *reinterpret_cast<uint32_t*>(Y + (size_t)row * N + col) =
          pack_bf16(sy[i] + scale * ad[i], sy[i + 1] + scale * ad[i + 1]);
  }
}
constexpr int RC_SMEM = 2 * (MAX_R / RP) * PANEL + 1024;

template <int BN>
cudaError_t launch(const void* x, const void* w, const void* a, const void* b,
                   void* y, float* ws_y, float* ws_xa, int M, int K, int N,
                   int r, float scale, int splits, int iters_per_split,
                   cudaStream_t stream) {
  auto kernel = lora_matmul_tc_split_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(N, BN) + ceil_div(r, RP), ceil_div(M, TBM), splits);
  kernel<<<grid, NT, Tile<BN>::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(a), ws_y, ws_xa, M, K, N, r, iters_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (r <= RP) {
    const dim3 rgrid(ceil_div(N, R_COLS), ceil_div(M, R_ROWS));
    lora_matmul_tc_reduce_kernel<<<rgrid, R_COLS, 0, stream>>>(
        ws_y, ws_xa, static_cast<const bf16*>(b), static_cast<bf16*>(y), M, N,
        r, splits, scale);
    return cudaGetLastError();
  }
  bf16* xab = reinterpret_cast<bf16*>(ws_xa + (size_t)splits * M * r);
  lora_matmul_tc_xa_kernel<<<ceil_div(M * r, R_COLS), R_COLS, 0, stream>>>(
      ws_xa, xab, M, r, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lora_matmul_tc_reduce_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             RC_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 rgrid(ceil_div(N, RP), ceil_div(M, TBM));
  const int smem = 2 * ceil_div(ceil_div(r, 16) * 16, RP) * PANEL + 1024;
  lora_matmul_tc_reduce_tc_kernel<<<rgrid, NT, smem, stream>>>(
      ws_y, xab, static_cast<const bf16*>(b), static_cast<bf16*>(y), M, N, r,
      splits, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues the split kernel and the
// reduction on the given stream, does not synchronise, allocates nothing,
// returns the cudaError_t of the launches (0 on success); -1: arguments
// the kernel does not take. x (M, K), w (K, N), a (K, r), b (r, N), y (M, N)
// contiguous bf16, 16-byte aligned; K, N, r multiples of 8, r <= 256.
// ws_y holds splits * M * N floats, ws_xa splits * M * r floats and, at
// r > 64, M * r bf16 after them (X@A summed and rounded); the split plan
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
      ceil_div(M, R_ROWS) > 65535 ||
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
