// lora_matmul on the tensor cores of Hopper (sm_90a), f32, written by hand:
//
//   Y = X @ W + s * (X @ A) @ B
//
// It takes the place of the Pallas TPU kernel lora_matmul of
// src/repro/kernels/lora_matmul.py for f32 inputs whose K, N and r are
// multiples of 4 (whole 16-byte copies), r <= 256, and whose pointers are
// 16-byte aligned; other f32 shapes stay on the SIMT kernel of
// lora_matmul.cu, bf16 on lora_matmul_tc.cu (the wrapper chooses by shape,
// dtype and alignment, never by failure).
//
// What bounds it on this card: at the calibrate path's shapes (M, K, N of
// 128 to 1024, r 8 or 16) the work is bound by operations: 2 M K N of them
// against 4 (M K + K N + M N) bytes. On the CUDA cores f32 runs at 67
// TFLOP/s; the tensor cores take tf32 operands only, so every product here
// is three tf32 products (csrc/tf32x3.cuh), 3 x 2 M K N at 495 TFLOP/s,
// which keeps f32 accuracy and is still 2.5x the CUDA cores' rate. At
// r = 128 over a prefill chunk (M = 64, K = N = 7168) it is a stream of W's
// 205.5 MB (61 us at 3.35 TB/s) with the three products close behind (40 us
// at 495 TFLOP/s); X@A adds 2r/N of the operations (3.6 %) and A and B
// 7.3 MB. The design:
//
//   * at r <= 64 (the calibrate path's probes) mma.sync m16n8k8 (wgmma
//     takes tf32 only K-major, and W (K, N) lies N-major); a block of four
//     warps owns a 64 x 64 output tile, each warp 32 x 32 of it; X, W and A
//     tiles (64 x 32, 32 x 64, 32 x r) in a three-stage ring of 16-byte
//     cp.async copies (zero-filled past the ragged edges), rows padded so
//     that every fragment load is free of bank conflicts; each operand
//     split into (hi, lo) by truncation (split_rz: three ALU operations,
//     where the rounding split takes two slow conversions), once per use,
//     in registers as each fragment is loaded from shared memory
//     (splitting each stage once in shared memory instead, into fragment
//     order, measured slower on the H100: PERF.md); X@A accumulates in the
//     same K loop, also as three tf32 products, in the blocks of the first
//     N tile;
//   * at r > 64 the split kernel is a wgmma one, the product taken
//     transposed, Y^T = W^T X^T, so that both tf32 operands are K-major:
//     W^T is the 64-row A operand, built in registers from the stage's W
//     tile (each element loaded and split once a block, where the mma.sync
//     kernel splits it once a warp row), and X's tile the B operand, copied
//     as 128-byte rows (128-byte swizzle) and split once a stage into a hi
//     and a lo panel; three wgmma m64n64k8 a k8 step; a two-stage ring, so
//     that four blocks fit an SM and the plan's splits give at least two a
//     SM (the call at (64, 7168, 7168) 0.119 ms, against 0.151 with the
//     mma.sync split kernel in its place; three stages with half the
//     splits measured slower: PERF.md). X@A runs in 64-rank panels, each
//     in blocks of their own after the N tiles along grid x: a panel block
//     streams 64 columns of A (zeros past r) in W's place, so a rank of 256
//     adds four blocks per (M tile, split) and lengthens no block of W;
//   * split-K over blocks (the wrapper's tf32_plan), so that the calibrate
//     bench's 64 output tiles become at least 132 blocks; the f32 partial
//     sums go to a workspace. At r <= 64 a reduce kernel adds the splits,
//     applies s * (X@A) @ B and stores Y once. At r > 64 the correction is
//     a product of depth r (a loop of r dependent loads of B a thread was
//     latency-bound in bf16: PERF.md), so a small kernel sums X@A over the
//     splits once, and a second takes (X@A) @ B on mma.sync, three tf32
//     products, one 64 x 64 tile a block, adding the X@W splits while its
//     operands land, and stores Y once.
//
// Rounding order: that of the plain version and of the TPU kernel
// (kernels/ref.py): f32 sums; the tensor cores' own f32 sums truncate at
// each k8 step, so each stage's 32 of K is summed on them from zero and
// added to the running sum by an ordinary f32 add (carried over all of
// K, the truncation drifted by about (K / 8) 2^-24 of the sum: 1.3e-4 of
// max |want| at K = 18944); X@A is rounded to the activation dtype before
// it meets B, which in f32 is no rounding at all; s * correction is added
// before the single store. Nothing carries over between calls and nothing
// synchronises with the host (the kernels of a call follow one another in
// stream order), so the call can be captured in a CUDA graph (the calibrate
// path's timer does).

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using repro::ceil_div;
using repro::sm90::acc_col;
using repro::sm90::acc_row;
using repro::sm90::cp_async16;
using repro::sm90::cp_async_commit;
using repro::sm90::cp_async_wait;
using repro::sm90::desc128;
using repro::sm90::fence_proxy_async;
using repro::sm90::fence_regs;
using repro::sm90::smem_base_1k;
using repro::sm90::smem_u32;
using repro::sm90::swz128;
using repro::sm90::wgmma_commit;
using repro::sm90::wgmma_fence;
using repro::sm90::wgmma_rs_tf32;
using repro::sm90::wgmma_wait;
using repro::tf32x3::mma3;
using repro::tf32x3::split_rz;

constexpr int BM = 64;                  // rows of a tile
constexpr int BN = 64;                  // columns of a tile
constexpr int BK = 32;                  // K per stage
constexpr int NT = 128;                 // 4 warps, 2 x 2, 32 x 32 each
constexpr int STAGES = 3;
constexpr int LDX = BK + 4;             // row g, column t: bank 4g + t
constexpr int LDW = BN + 8;             // row t, column g: bank 8t + g
constexpr int MAX_R = 256;
constexpr int RP = 64;                  // ranks of one X@A panel (r > 64)
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
    // the stage's products go to sums of their own, added to acc / xa
    // once a stage: the tensor cores' f32 accumulation truncates, so sums
    // carried over all of K drift by about (K / 8) 2^-24 of their size
    float sa[2][4][4], sx[2][XT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[i][n][e] = 0.f;
#pragma unroll
      for (int n = 0; n < XT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sx[i][n][e] = 0.f;
    }
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
      for (int i = 0; i < 2; ++i) mma3<4>(sa[i], ahi[i], alo[i], bq);
      if (do_xa) {
        float4 bx[XT];
#pragma unroll
        for (int n = 0; n < XT; ++n)
          bx[n] = split_b(sb + T::A_OFF + (8 * kb + t) * T::LDA +
                              8 * (XT * wn + n) + g,
                          T::LDA);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma3<XT>(sx[i], ahi[i], alo[i], bx);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] += sa[i][n][e];
      if (do_xa) {
#pragma unroll
        for (int n = 0; n < XT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) xa[i][n][e] += sx[i][n][e];
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

// The split kernel at r > 64, on wgmma: one block over its K range, for
// blockIdx.x < n_tiles the (64, 64) tile of X@W at columns 64 blockIdx.x,
// its f32 partial sums to ws_y[split]; past the N tiles the (64, 64) panel
// of X@A at ranks 64 (blockIdx.x - n_tiles), to ws_xa[split]. A stage holds
// X's tile as 64 rows of 128 bytes (128-byte swizzle; its hi panel, split
// in place, then its lo panel) and the streamed operand's 32 x 64 tile (W
// or A's panel; rows padded to LDW, so the A fragments' loads are free of
// bank conflicts: row t, column g at bank 8t + g). The accumulators hold
// (X@W)^T: row a column of W (or a rank), column a row of X.
constexpr int WG_XP = BM * 128;         // X's panel: 64 rows x 32 floats
constexpr int WG_W = BK * LDW * 4;      // W's tile: 32 x 72 floats, bytes
constexpr int WG_STAGE = 2 * WG_XP + (WG_W + 1023) / 1024 * 1024;
constexpr int WG_STAGES = 2;            // 51 KB: four blocks fit an SM
constexpr int WG_SMEM = WG_STAGES * WG_STAGE + 1024;   // + alignment slack

__global__ void __launch_bounds__(NT)
lora_matmul_tf32_wg_kernel(const float* __restrict__ X,
                           const float* __restrict__ W,
                           const float* __restrict__ A,
                           float* __restrict__ ws_y, float* __restrict__ ws_xa,
                           int M, int K, int N, int r, int iters_per_split) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base_1k(smem_raw);
  uint8_t* const sbase = smem_raw + (base - smem_u32(smem_raw));
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int split_id = blockIdx.z;
  const int it0 = split_id * iters_per_split;
  const int n_it = min(iters_per_split, ceil_div(K, BK) - it0);   // >= 1
  const int n_tiles = ceil_div(N, BN);
  const bool do_w = blockIdx.x < n_tiles;   // uniform over the block
  const float* const src = do_w ? W : A;
  const int ld = do_w ? N : r;
  const int n0 = do_w ? blockIdx.x * BN : (blockIdx.x - n_tiles) * RP;

  auto load = [&](int stage, int it) {
    const uint32_t sb = base + stage * WG_STAGE;
    const int k0 = (it0 + it) * BK;
#pragma unroll
    for (int i = 0; i < BM * 8 / NT; ++i) {           // X: 64 rows x 8
      const int c = tid + i * NT, row = c >> 3, q = c & 7;
      const int gm = m0 + row, gk = k0 + 4 * q;
      const bool ok = gm < M && gk < K;
      cp_async16(sb + swz128(row, q), ok ? X + (size_t)gm * K + gk : X, ok);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / NT; ++i) {      // W or A: 32 rows x 16
      const int c = tid + i * NT, row = c >> 4, q = c & 15;
      const int gk = k0 + row, gn = n0 + 4 * q;
      const bool ok = gk < K && gn < ld;
      cp_async16(sb + 2 * WG_XP + (row * LDW + 4 * q) * 4,
                 ok ? src + (size_t)gk * ld + gn : src, ok);
    }
  };

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < n_it) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<WG_STAGES - 2>();     // this thread's copies of stage `it`
    __syncthreads();                    // everyone's; stage it - 1 is free
    if (it + WG_STAGES - 1 < n_it)
      load((it + WG_STAGES - 1) % WG_STAGES, it + WG_STAGES - 1);
    cp_async_commit();
    const int stage = it % WG_STAGES;
    uint8_t* st = sbase + stage * WG_STAGE;
    // X -> its hi panel in place and its lo panel, four chunks a thread
#pragma unroll
    for (int i = 0; i < BM * 8 / NT; ++i) {
      const int c = tid + i * NT;
      const uint32_t off = swz128(c >> 3, c & 7);
      float4 v = *reinterpret_cast<float4*>(st + off);
      uint32_t h0, l0, h1, l1, h2, l2, h3, l3;
      split_rz(v.x, h0, l0); split_rz(v.y, h1, l1);
      split_rz(v.z, h2, l2); split_rz(v.w, h3, l3);
      *reinterpret_cast<uint4*>(st + off) = make_uint4(h0, h1, h2, h3);
      *reinterpret_cast<uint4*>(st + WG_XP + off) =
          make_uint4(l0, l1, l2, l3);
    }
    fence_proxy_async();                // the panels, to the tensor cores
    __syncthreads();
    const uint32_t sb = base + stage * WG_STAGE;
    const float* sw = reinterpret_cast<const float*>(st + 2 * WG_XP);
    // the A operand (W^T): warp w's 16 rows, columns 16 w .. 16 w + 15 of
    // the tile, every k8 step of the stage
    uint32_t ahi[KB][4], alo[KB][4];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const float* p = sw + (8 * kb + t) * LDW + 16 * warp + g;
      split_rz(p[0], ahi[kb][0], alo[kb][0]);
      split_rz(p[8], ahi[kb][1], alo[kb][1]);
      split_rz(p[4 * LDW], ahi[kb][2], alo[kb][2]);
      split_rz(p[4 * LDW + 8], ahi[kb][3], alo[kb][3]);
    }
    // the stage's products to a sum of its own, added to acc once a stage
    // (the tensor cores' f32 accumulation truncates: see the split kernel)
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const uint64_t dhi = desc128(sb + 32 * kb, 16, 1024);
      const uint64_t dlo = desc128(sb + WG_XP + 32 * kb, 16, 1024);
      wgmma_rs_tf32(part, alo[kb], dhi);
      wgmma_rs_tf32(part, ahi[kb], dlo);
      wgmma_rs_tf32(part, ahi[kb], dhi);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
  }
  // f32 partials, transposed back: acc element i is column (or rank)
  // n0 + acc_row, row m0 + acc_col
  float* py = do_w ? ws_y + (size_t)split_id * M * N
                   : ws_xa + (size_t)split_id * M * r;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int n = n0 + acc_row(tid, i);
    const int m = m0 + acc_col(tid, i);
    if (m < M && n < ld) py[(size_t)m * ld + n] = acc[i];
  }
}

// The reduction over the splits and the epilogue at r <= 64: 2 rows x 512
// columns at a time, four neighbouring columns per thread (16-byte loads
// and stores); a block steps over the row pairs gridDim.y apart, so any M
// fits the grid.
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
  __shared__ float xas[R_ROWS][RP];
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

// At r > 64: X@A summed over the splits once, (M, r) f32 after ws_xa, one
// thread an element, its splits read eight at a time.
__global__ void __launch_bounds__(R_THREADS)
lora_matmul_tf32_xa_kernel(const float* __restrict__ ws_xa,
                           float* __restrict__ xas, int M, int r,
                           int splits) {
  const int idx = blockIdx.x * R_THREADS + threadIdx.x;
  if (idx < M * r)
    xas[idx] = repro::sum_strided(ws_xa + idx, (size_t)M * r, splits);
}

// Then one (64, 64) output tile a block of four warps, each 32 x 32 of it
// as in the split kernel: the tile's rows of X@A (64 x r8, r8 = r rounded
// up to the k8 step; row g, column t at bank (r8 + 4) g + t, free of
// conflicts) and B's (r8, 64) tile (LDW) copied by cp.async, all at once,
// zeros past M, r and N; the splits of X@W summed while they land (two
// splits' loads at a time); (X@A) @ B as three tf32 products over r8 / 8
// k8 steps; each output Y = sum + s * correction, stored once.
__host__ __device__ __forceinline__ int corr_depth(int r) {
  return ceil_div(r, 8) * 8;
}
__host__ __device__ __forceinline__ int corr_smem(int r) {
  return (int)sizeof(float) * (BM * (corr_depth(r) + 4) + corr_depth(r) * LDW);
}

__global__ void __launch_bounds__(NT)
lora_matmul_tf32_correct_kernel(const float* __restrict__ ws_y,
                                const float* __restrict__ xas,
                                const float* __restrict__ B,
                                float* __restrict__ Y, int M, int N, int r,
                                int splits, float scale) {
  extern __shared__ float4 smem4[];
  float* const sxa = reinterpret_cast<float*>(smem4);
  const int r8 = corr_depth(r), lda = r8 + 4;
  float* const sb = sxa + BM * lda;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  for (int idx = tid; idx < BM * (r8 / 4); idx += NT) {   // X@A: 64 x r8
    const int m = idx / (r8 / 4), c = idx % (r8 / 4);
    const bool ok = m0 + m < M && 4 * c < r;
    cp_async16(smem_u32(sxa + m * lda + 4 * c),
               ok ? xas + (size_t)(m0 + m) * r + 4 * c : xas, ok);
  }
  for (int idx = tid; idx < r8 * (BN / 4); idx += NT) {   // B: r8 x 64
    const int j = idx / (BN / 4), q = idx % (BN / 4), gn = n0 + 4 * q;
    const bool ok = j < r && gn < N;
    cp_async16(smem_u32(sb + j * LDW + 4 * q),
               ok ? B + (size_t)j * N + gn : B, ok);
  }
  cp_async_commit();

  // X@W over the splits for this thread's outputs, while they land: the
  // loads of two splits go out before either is added
  float sy[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sy[i][n][e] = 0.f;
  for (int sp = 0; sp < splits; sp += 2) {
    float2 v[2][2][4][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* py = ws_y + (size_t)(sp + h) * M * N;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = m0 + 32 * wm + 16 * i + g + 8 * e;
            const int col = n0 + 32 * wn + 8 * n + 2 * t;
            v[h][i][n][e] = sp + h < splits && row < M && col < N
                ? *reinterpret_cast<const float2*>(py + (size_t)row * N + col)
                : make_float2(0.f, 0.f);
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sy[i][n][2 * e] += v[h][i][n][e].x;
            sy[i][n][2 * e + 1] += v[h][i][n][e].y;
          }
  }

  cp_async_wait<0>();
  __syncthreads();
  float ad[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ad[i][n][e] = 0.f;
  for (int kb = 0; kb < r8 / 8; ++kb) {
    uint32_t ahi[2][4], alo[2][4];
    float4 bq[4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      split_a(sxa + (32 * wm + 16 * i + g) * lda + 8 * kb + t, lda, ahi[i],
              alo[i]);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      bq[n] = split_b(sb + (8 * kb + t) * LDW + 32 * wn + 8 * n + g, LDW);
#pragma unroll
    for (int i = 0; i < 2; ++i) mma3<4>(ad[i], ahi[i], alo[i], bq);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 32 * wm + 16 * i + g + 8 * e;
        const int col = n0 + 32 * wn + 8 * n + 2 * t;
        if (row < M && col < N)                 // N % 4 == 0: col + 1 < N
          *reinterpret_cast<float2*>(Y + (size_t)row * N + col) = make_float2(
              sy[i][n][2 * e] + scale * ad[i][n][2 * e],
              sy[i][n][2 * e + 1] + scale * ad[i][n][2 * e + 1]);
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

// r > 64: the wgmma split kernel (the panel blocks after the N tiles), the
// X@A sum over the splits after ws_xa, the tensor-core correction
cudaError_t launch_wide(const float* x, const float* w, const float* a,
                        const float* b, float* y, float* ws_y, float* ws_xa,
                        int M, int K, int N, int r, float scale, int splits,
                        int iters_per_split, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lora_matmul_tf32_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WG_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(N, BN) + ceil_div(r, RP), ceil_div(M, BM), splits);
  lora_matmul_tf32_wg_kernel<<<grid, NT, WG_SMEM, stream>>>(
      x, w, a, ws_y, ws_xa, M, K, N, r, iters_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* xas = ws_xa + (size_t)splits * M * r;
  lora_matmul_tf32_xa_kernel<<<ceil_div(M * r, R_THREADS), R_THREADS, 0,
                               stream>>>(ws_xa, xas, M, r, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lora_matmul_tf32_correct_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             corr_smem(MAX_R));
  if (err != cudaSuccess) return err;
  lora_matmul_tf32_correct_kernel<<<dim3(ceil_div(N, BN), ceil_div(M, BM)),
                                    NT, corr_smem(r), stream>>>(
      ws_y, xas, b, y, M, N, r, splits, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues the split kernel and the
// reduction on the given stream, does not synchronise, allocates nothing,
// returns the cudaError_t of the launches (0 on success); -1: arguments the
// kernel does not take. x (M, K), w (K, N), a (K, r), b (r, N), y (M, N)
// contiguous f32; x, w, a, b, y and the workspaces 16-byte aligned; K, N, r
// multiples of 4, r <= 256. ws_y holds splits * M * N floats, ws_xa
// splits * M * r and, at r > 64, M * r after them (X@A summed over the
// splits); the split plan (splits, iters_per_split: 32-deep K steps per
// split) comes from the wrapper's tf32_plan and covers ceil(K / 32) steps,
// none empty.
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
  if (r <= RP)
    return static_cast<int>(launch<4>(xx, ww, aa, bb, yy, wy, wa, M, K, N, r,
                                      scale, splits, iters_per_split, s));
  return static_cast<int>(launch_wide(xx, ww, aa, bb, yy, wy, wa, M, K, N, r,
                                      scale, splits, iters_per_split, s));
}
