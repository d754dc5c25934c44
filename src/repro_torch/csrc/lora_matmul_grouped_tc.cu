// lora_matmul_grouped on the tensor cores of Hopper (sm_90a), bf16, written
// by hand:
//
//   y[g] = x[g] @ W + s * round_bf16(x[g] @ A[ids[g]]) @ B[ids[g]]
//
// It takes the place of the Pallas TPU kernel lora_matmul_grouped of
// src/repro/kernels/lora_matmul.py for bf16 inputs whose K, N and r are
// multiples of 8 (r <= 256) and whose pointers and bank strides are 16-byte
// aligned; every other case stays on the two SIMT kernels of lora_matmul.cu
// (the wrapper chooses by dtype, shape and alignment, never by failure).
//
// What bounds it on this card: in a decode tick the (G, 1, K) activations
// are G = 8 rows, one per request, so the shared product x@W does 16 FLOP
// per byte of W and the function is a stream of W (8 to 33.5 MB at the
// serving shapes of llama32-1b), far below the ~295 FLOP per byte at which
// the tensor cores and not device memory are the limit. At r = 128 each row
// also reads its own A and B: 8 rows at (K, N) = (7168, 896) read 14.7 MB of
// A beside W's 12.8 MB, so the stream is of W and A together. The design is
// the W-streaming design of lora_matmul_tc.cu:
//
//   * split-K over blocks: the grid is (N tiles [+ x@A blocks], row tiles,
//     K splits), sized by the wrapper's plan (grouped_plan) so that at least
//     one block runs per SM at every serving shape;
//   * a ring of three shared-memory stages, each filled by 16-byte cp.async
//     (W: whole 128-byte segments of each K row; zero-fill past the ragged
//     edges), two stages in flight while the third is used, two blocks per
//     SM;
//   * x@W on wgmma m64nNk16 with the rows of x as the 64-row K-major
//     operand and W (K, N) read N-contiguous as the MN-major operand through
//     the transpose bit. In decode 56 of the 64 rows are zeros: they are
//     written to shared memory once, before the loop, and never copied
//     again. Swapping the operands (W^T as the 64-row operand, the rows as
//     n = 8) would waste no tensor-core work, but the card has ~100 times
//     the operations this product needs, and this way reuses the operand
//     layout, descriptors and swizzle that lora_matmul_tc.cu already holds
//     to its plain version.
//
// x@A differs per row (each row has its own adapter), so it cannot ride on
// the shared product. It is computed once per (row, K split), never once per
// N tile, in units of at most 64 ranks: a row's whole rank where r <= 64
// (64 / r of them fit a unit's room), else one 64-rank chunk of it, so that
// r = 256 is four units of a row. In each split the units of a row tile are
// dealt round-robin to the blocks along N (unit u to block u mod nx), one
// unit's room of A a block and stage, and nx grows past the N tiles where
// the units need it; so a block carries at most one unit's run of A beyond
// its share of W. Each unit's slice of A[ids[row]] is read where it lies in
// the bank (through its stride, so the strided in-place bank of
// AdapterBank.gather needs no gathered copy) into the same ring stage as W,
// and multiplied on the CUDA cores with x taken from the stage's x tile,
// while the tensor cores run the stage's x@W.
//
// Rounding contract (that of the TPU kernel, kernels/ref.py and the plain
// version): every product accumulates in f32; x@A is summed over ALL of K
// and rounded once to bf16; the correction is round_bf16(x@A) @ B in f32;
// x@W + s * correction is rounded once to bf16. The partial sums of x@W and
// x@A go to an f32 workspace that the wrapper allocates, and a second small
// kernel adds the splits, rounds x@A, applies B[ids[row]] and rounds the
// output: nothing is rounded before the reduction, and nothing carries over
// between calls (every workspace element is written before it is read, so
// there is no counter to reset). No host synchronisation: the call can be
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
constexpr int RP = 64;                  // ranks of one x@A unit's room
constexpr int MAX_R = 256;
constexpr int MAX_UNITS = RP / 8;       // units a block: 64 / r at r = 8
constexpr int A_BYTES = TBK * RP * 2;   // the units' slices of A, a stage
constexpr int XA_SLOTS = A_BYTES / 16 / NT;   // x@A triples a thread

template <int BN>
struct Tile {
  static constexpr int X_OFF = 0;
  static constexpr int W_OFF = PANEL;                   // BN / 64 panels
  static constexpr int A_OFF = W_OFF + (BN / 64) * PANEL;
  static constexpr int STAGE = A_OFF + A_BYTES;
  static constexpr int SMEM = STAGES * STAGE + 1024;    // + alignment slack
};

// x@A units of a row tile: r <= 64 gives a unit a row (64 / r of them a
// block), r > 64 a unit a 64-rank chunk of a row (one a block); unit u is
// row u / chunks, ranks 64 * (u % chunks) on.
__host__ __device__ __forceinline__ int rank_chunks(int r) {
  return ceil_div(r, RP);
}
__host__ __device__ __forceinline__ int units_per_block(int r) {
  return r > RP ? 1 : RP / r;
}

// One block (bx, row tile, split): if bx < n_tiles, the (64, BN) tile of
// x@W at columns bx * BN; and the x@A units bx, bx + nx, ... of the tile
// (at most units_per_block(r) of them); both over the split's K range. The
// f32 partial sums go to ws_y[split] and ws_xa[split].
template <int BN>
__global__ void __launch_bounds__(NT, 2)
lora_matmul_grouped_tc_split_kernel(
    const bf16* __restrict__ X, const bf16* __restrict__ W,
    const bf16* __restrict__ Abank, const int* __restrict__ ids,
    float* __restrict__ ws_y, float* __restrict__ ws_xa, int rows,
    int rows_per_group, int K, int N, int r, long long a_stride,
    int iters_per_split, int n_tiles, int nx) {
  using T = Tile<BN>;
  constexpr int WCH = BN / 8;           // 16-byte chunks across a W row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base_1k(smem_raw);
  uint8_t* const sbase = smem_raw + (base - smem_u32(smem_raw));
  __shared__ const bf16* a_unit[MAX_UNITS];   // bank slice of each unit
  __shared__ int u_row[MAX_UNITS];            // its row in the tile

  const int tid = threadIdx.x;
  const int bx = blockIdx.x;
  const int m0 = blockIdx.y * TBM;
  const int split = blockIdx.z;
  const int it0 = split * iters_per_split;
  const int n_it = min(iters_per_split, ceil_div(K, TBK) - it0);   // >= 1
  const int rows_here = min(TBM, rows - m0);
  const bool do_w = bx < n_tiles;       // uniform over the block
  const int n0 = bx * BN;
  const int chunks = rank_chunks(r);
  const int units = rows_here * chunks;
  const int n_u = bx < units
      ? min(units_per_block(r), ceil_div(units - bx, nx)) : 0;
  const int uw = min(RP, r - RP * (bx % chunks));   // the units' width
  const int uc = uw / 8;                // 16-byte chunks across a unit's row
  const int xa_pairs = n_u * TBK * uc;  // (unit, k, chunk) triples a stage

  if (tid < n_u) {
    const int u = bx + tid * nx;
    u_row[tid] = u / chunks;
    a_unit[tid] = Abank + (size_t)ids[(m0 + u / chunks) / rows_per_group] *
                              a_stride + RP * (u % chunks);
  }
  // the x tile's rows past the last row are zeros in every stage, once
  for (int idx = tid; idx < STAGES * (TBM - rows_here) * 8; idx += NT) {
    const int s = idx / ((TBM - rows_here) * 8);
    const int rem = idx % ((TBM - rows_here) * 8);
    *reinterpret_cast<uint4*>(sbase + s * T::STAGE + T::X_OFF +
                              (rows_here + rem / 8) * 128 + (rem % 8) * 16) =
        make_uint4(0, 0, 0, 0);
  }
  __syncthreads();                      // a_unit, u_row visible to all

  // this thread's (unit, k, chunk) triples of x@A: the same in every stage
  const bf16* a_src[XA_SLOTS];          // A[ids[row]] at (kk, col0 + 8 c)
  int a_kk[XA_SLOTS];
  uint32_t x_off[XA_SLOTS];             // x[row][kk] in a stage's x tile
#pragma unroll
  for (int s = 0; s < XA_SLOTS; ++s) {
    const int idx = tid + s * NT;
    const int q = idx / (TBK * uc), rem = idx % (TBK * uc);
    const int kk = rem / uc, c = rem % uc;
    const bool mine = idx < xa_pairs;
    a_src[s] = mine ? a_unit[q] + (size_t)kk * r + 8 * c : Abank;
    a_kk[s] = kk;
    x_off[s] = mine ? T::X_OFF + swz128(u_row[q], kk >> 3) + (kk & 7) * 2
                    : T::X_OFF;
  }

  const int xc = tid & 7, xr = tid >> 3;               // X: 16 rows a pass
  const int wc = tid % WCH, wr = tid / WCH;            // W: 8 or 16 rows a pass
  const uint32_t x_dst = T::X_OFF + swz128(xr, xc);
  const uint32_t w_dst = T::W_OFF + (wc >> 3) * PANEL + swz128(wr, wc & 7);
  auto load = [&](int stage, int it) {
    const uint32_t sb = base + stage * T::STAGE;
    const int k0 = (it0 + it) * TBK;
#pragma unroll
    for (int j = 0; j < TBM / 16; ++j) {                 // X: the real rows
      const int lr = xr + 16 * j;
      if (lr < rows_here) {
        const int gk = k0 + 8 * xc;
        const bool ok = gk < K;
        cp_async16(sb + x_dst + j * 16 * 128,
                   ok ? X + (size_t)(m0 + lr) * K + gk : X, ok);
      }
    }
    if (do_w) {
#pragma unroll
      for (int j = 0; j < TBK * WCH / NT; ++j) {         // W: 64 k-rows
        const int gk = k0 + wr + j * (NT / WCH), gn = n0 + 8 * wc;
        const bool ok = gk < K && gn < N;
        cp_async16(sb + w_dst + j * (NT / WCH) * 128,
                   ok ? W + (size_t)gk * N + gn : W, ok);
      }
    }
    // A[ids[row]][k0 : k0 + 64, col0 : col0 + uw], dense (k, rank) a unit
#pragma unroll
    for (int s = 0; s < XA_SLOTS; ++s) {
      const int idx = tid + s * NT;
      if (idx < xa_pairs) {
        const bool ok = k0 + a_kk[s] < K;
        cp_async16(sb + T::A_OFF + idx * 16,
                   ok ? a_src[s] + (size_t)k0 * r : a_src[s], ok);
      }
    }
  };

  float acc[BN / 2];
  float xa[XA_SLOTS][8];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < XA_SLOTS; ++s)
#pragma unroll
    for (int e = 0; e < 8; ++e) xa[s][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<STAGES - 2>();        // this thread's copies of stage `it`
    fence_proxy_async();
    __syncthreads();                    // everyone's copies; stage it-1 free
    if (it + STAGES - 1 < n_it)
      load((it + STAGES - 1) % STAGES, it + STAGES - 1);
    cp_async_commit();

    const int stage = it % STAGES;
    const uint32_t sb = base + stage * T::STAGE;
    if (do_w) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TBK / 16; ++kk)
        wgmma_ss<1>(acc, desc128(sb + T::X_OFF + 32 * kk, 16, 1024),
                    desc128(sb + T::W_OFF + 2048 * kk, PANEL, 1024));
      wgmma_commit();
    }
    // x@A on the CUDA cores while the tensor cores run x@W
    const uint8_t* st = sbase + stage * T::STAGE;
#pragma unroll
    for (int s = 0; s < XA_SLOTS; ++s) {
      const int idx = tid + s * NT;
      if (idx < xa_pairs) {
        const float xv =
            __bfloat162float(*reinterpret_cast<const bf16*>(st + x_off[s]));
        const uint4 av =
            *reinterpret_cast<const uint4*>(st + T::A_OFF + idx * 16);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&av);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          xa[s][2 * e] = fmaf(xv, f.x, xa[s][2 * e]);
          xa[s][2 * e + 1] = fmaf(xv, f.y, xa[s][2 * e + 1]);
        }
      }
    }
    if (do_w) {
      wgmma_wait<0>();
      fence_regs(acc);
    }
  }
  cp_async_wait<0>();

  // f32 partials of x@W, two neighbouring columns per store
  if (do_w) {
    float* py = ws_y + (size_t)split * rows * N;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int row = m0 + acc_row(tid, i), col = n0 + acc_col(tid, i);
      if (row < rows && col < N)
        *reinterpret_cast<float2*>(py + (size_t)row * N + col) =
            make_float2(acc[i], acc[i + 1]);
    }
  }
  if (n_u == 0) return;                 // uniform over the block

  // x@A: each thread's partials over its k's go to shared memory (the ring
  // is free now), laid out (unit, k, rank); one thread per (unit, rank)
  // sums the 64 k's and writes the split's partial
  __syncthreads();
  float* red = reinterpret_cast<float*>(sbase);
#pragma unroll
  for (int s = 0; s < XA_SLOTS; ++s) {
    const int idx = tid + s * NT;
    if (idx < xa_pairs) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red[idx * 8 + e] = xa[s][e];
    }
  }
  __syncthreads();
  float* pa = ws_xa + (size_t)split * rows * r;
  for (int o = tid; o < n_u * uw; o += NT) {
    const int q = o / uw, j = o % uw;
    const float* p = red + (size_t)q * TBK * uw + j;
    float sum = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < TBK; ++kk) sum += p[kk * uw];
    const int u = bx + q * nx;
    pa[(size_t)(m0 + u / chunks) * r + RP * (u % chunks) + j] = sum;
  }
}

// The reduction over the splits and the epilogue: one row and 128 columns
// per block. x@A of the row is summed over the splits and rounded once to
// bf16 in shared memory, and each thread adds the splits of its x@W column.
// The correction reads the row's B[ids[row]] (r * 128 * 2 bytes a block,
// 64 KB at r = 256) with no reuse across rows, so its loads are spread for
// many in flight: eight rank groups (j = g, g + 8, ...) of sixteen threads,
// each thread a 16-byte load of 8 columns a rank; the groups' sums meet in
// shared memory, added in a fixed order, and each thread rounds its
// column's output once. Every loop over splits or ranks issues its loads
// in batches of eight before it adds any of them (sum_strided): a loop
// that adds each term as it comes waits a round trip a term; the first
// batch of B is in flight while the splits are summed.
constexpr int G_CG = 16;                // 8-column groups of a block
constexpr int G_RG = 8;                 // rank groups
constexpr int G_NT = G_CG * G_RG;
constexpr int G_COLS = 8 * G_CG;        // == G_NT: one output column a thread
constexpr int BATCH = 8;                // loads of B in flight a thread

__global__ void __launch_bounds__(G_NT)
lora_matmul_grouped_tc_reduce_kernel(
    const float* __restrict__ ws_y, const float* __restrict__ ws_xa,
    const bf16* __restrict__ Bbank, const int* __restrict__ ids,
    bf16* __restrict__ Y, int rows, int rows_per_group, int N, int r,
    long long b_stride, int splits, float scale) {
  __shared__ float xas[MAX_R];
  __shared__ __align__(16) float part[G_RG][G_COLS];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int c0 = blockIdx.y * G_COLS;
  const int col = c0 + tid;
  const int cg = tid % G_CG, rg = tid / G_CG;
  const int c8 = c0 + 8 * cg;
  const bool live8 = c8 < N;            // N % 8 == 0: all 8 columns or none
  const bf16* Bp = Bbank + (size_t)ids[row / rows_per_group] * b_stride +
                   (live8 ? c8 : 0);
  // this thread's ranks j0, j0 + 8, ... of B: one batch of loads
  uint4 bv[BATCH];
  auto load_b = [&](int j0) {
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int j = j0 + u * G_RG;
      bv[u] = live8 && j < r
          ? *reinterpret_cast<const uint4*>(Bp + (size_t)j * N)
          : make_uint4(0, 0, 0, 0);
    }
  };
  load_b(rg);           // the first batch, in flight over the sums

  for (int j = tid; j < r; j += G_NT)
    xas[j] = repro::round_to<bf16>(repro::sum_strided(
        ws_xa + (size_t)row * r + j, (size_t)rows * r, splits));
  // x@W over the splits, before the sync
  const float sy = col < N ? repro::sum_strided(ws_y + (size_t)row * N + col,
                                                (size_t)rows * N, splits)
                           : 0.f;
  __syncthreads();
  float ad[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) ad[e] = 0.f;
  for (int j0 = rg; j0 < r; j0 += BATCH * G_RG) {
    if (j0 != rg) load_b(j0);
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int j = j0 + u * G_RG;
      const float xv = j < r ? xas[j] : 0.f;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&bv[u]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        ad[2 * e] = fmaf(xv, f.x, ad[2 * e]);
        ad[2 * e + 1] = fmaf(xv, f.y, ad[2 * e + 1]);
      }
    }
  }
  float4* pp = reinterpret_cast<float4*>(&part[rg][8 * cg]);
  pp[0] = make_float4(ad[0], ad[1], ad[2], ad[3]);
  pp[1] = make_float4(ad[4], ad[5], ad[6], ad[7]);
  __syncthreads();
  if (col >= N) return;
  float corr = 0.f;
#pragma unroll
  for (int g = 0; g < G_RG; ++g) corr += part[g][tid];
  Y[(size_t)row * N + col] = __float2bfloat16_rn(sy + scale * corr);
}

template <int BN>
cudaError_t launch(const void* x, const void* w, const void* a, const void* b,
                   const void* ids, void* y, float* ws_y, float* ws_xa,
                   int rows, int rows_per_group, int K, int N, int r,
                   long long a_stride, long long b_stride, float scale,
                   int splits, int iters_per_split, int nx,
                   cudaStream_t stream) {
  auto kernel = lora_matmul_grouped_tc_split_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(nx, ceil_div(rows, TBM), splits);
  kernel<<<grid, NT, Tile<BN>::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(a), static_cast<const int*>(ids), ws_y, ws_xa,
      rows, rows_per_group, K, N, r, a_stride, iters_per_split,
      ceil_div(N, BN), nx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 rgrid(rows, ceil_div(N, G_COLS));
  lora_matmul_grouped_tc_reduce_kernel<<<rgrid, G_NT, 0, stream>>>(
      ws_y, ws_xa, static_cast<const bf16*>(b), static_cast<const int*>(ids),
      static_cast<bf16*>(y), rows, rows_per_group, N, r, b_stride, splits,
      scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues the split kernel and the
// reduction on the given stream, does not synchronise, allocates nothing,
// returns the cudaError_t of the launches (0 on success); -1: arguments the
// kernel does not take. x (rows, K) contiguous, w (K, N) contiguous, the
// banks a (E, K, r) and b (E, r, N) with each adapter's matrix contiguous
// and adapters a_stride / b_stride elements apart, y (rows, N); all bf16,
// 16-byte aligned, K, N, r and both strides multiples of 8, r <= 256; ids
// int32, one per group of rows_per_group rows. ws_y holds
// splits * rows * N floats, ws_xa splits * rows * r. The plan (bn in
// {64, 128}, splits, iters_per_split: 64-deep K steps per split, nx: blocks
// along N, at least the N tiles and enough that no block holds more than
// units_per_block(r) x@A units) comes from the wrapper's grouped_plan.
extern "C" int lora_matmul_grouped_tc_launch(
    const void* x, const void* w, const void* a_bank, const void* b_bank,
    const void* ids, void* y, void* ws_y, void* ws_xa, int rows,
    int rows_per_group, int K, int N, int r, long long a_stride,
    long long b_stride, float scale, int bn, int splits, int iters_per_split,
    int nx, void* stream) {
  const int n_iters = ceil_div(K, TBK);
  if (rows < 1 || rows_per_group < 1 || K < 8 || N < 8 || r < 8 ||
      r > MAX_R || K % 8 || N % 8 || r % 8 || a_stride % 8 || b_stride % 8 ||
      splits < 1 || iters_per_split < 1 || splits > 65535 ||
      ceil_div(rows, TBM) > 65535 ||
      (splits - 1) * iters_per_split >= n_iters ||
      splits * iters_per_split < n_iters || (bn != 64 && bn != 128) ||
      nx < ceil_div(N, bn) || ceil_div(N, G_COLS) > 65535 ||
      units_per_block(r) * nx < min(rows, TBM) * rank_chunks(r))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wy = static_cast<float*>(ws_y);
  float* wa = static_cast<float*>(ws_xa);
  if (bn == 128)
    return static_cast<int>(launch<128>(x, w, a_bank, b_bank, ids, y, wy, wa,
                                        rows, rows_per_group, K, N, r, a_stride,
                                        b_stride, scale, splits,
                                        iters_per_split, nx, s));
  return static_cast<int>(launch<64>(x, w, a_bank, b_bank, ids, y, wy, wa, rows,
                                     rows_per_group, K, N, r, a_stride,
                                     b_stride, scale, splits, iters_per_split,
                                     nx, s));
}
