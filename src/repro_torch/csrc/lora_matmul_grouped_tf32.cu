// lora_matmul_grouped on the tensor cores of Hopper (sm_90a), f32, written
// by hand:
//
//   y[g] = x[g] @ W + s * (x[g] @ A[ids[g]]) @ B[ids[g]]
//
// It takes the place of the Pallas TPU kernel lora_matmul_grouped of
// src/repro/kernels/lora_matmul.py for f32 inputs whose K, N and r are
// multiples of 4 (whole 16-byte copies), r <= 256, and whose pointers and
// bank strides are 16-byte aligned; other f32 shapes stay on the SIMT
// kernels of lora_matmul.cu, bf16 on lora_matmul_grouped_tc.cu (the wrapper
// chooses by dtype, shape and alignment, never by failure).
//
// What bounds it on this card: in a decode tick the (G, 1, K) activations
// are G <= 8 rows, one per request, so x@W does 2 G FLOP per 4-byte element
// of W: a stream of W (4 to 16.8 MB at the serving shapes of llama32-1b and
// qwen3-0.6b) at 3.35 TB/s, which the CUDA cores could still keep up with
// at 8 rows but not past ~40. The SIMT kernel it replaces left the card
// idle: one block per 16 columns and 8 rows walked all of K (32 blocks at
// N = 512, 128 at 2048, for 132 SMs), and every block recomputed x@A for
// its 8 rows, ~134 MB through the L2 for 16.8 MB of W. At r = 128 each row
// also reads its own A and B: 8 rows at (K, N) = (7168, 896) read 29.4 MB of
// A (14.7 MB of it distinct, from a bank of 4) beside W's 25.7 MB, so the
// stream is of W and A together. The design:
//
//   * split-K over blocks: the grid is (N tiles + x@A blocks, row tiles, K
//     splits), sized by the wrapper's plan (grouped_tf32_plan): at least
//     one block per SM at every serving shape, and no split deeper than
//     8 K steps of 32, since a block's stages run one after the other and
//     a long split made the slowest block (measured, PERF.md); each K step
//     lands in exactly one split;
//   * W (64 columns x 32 K rows a stage) and the rows of x move through a
//     four-stage ring of 16-byte cp.async copies (zero-filled past the
//     ragged edges) into shared memory whose rows are padded so that every
//     fragment load is free of bank conflicts;
//   * x@W on mma.sync m16n8k8 tf32 as three products of operands split by
//     truncation (csrc/tf32x3.cuh: split_rz, mma3), as lora_matmul_tf32.cu
//     does; not wgmma, which takes tf32 only K-major, while W (K, N) lies
//     N-major. The product is taken transposed, y^T = W^T x^T: 16 columns
//     of W are the m16 side of a product and the rows of x the n8 side, so
//     a decode tick's 8 rows fill the instruction with no padding (x as
//     the m16 side would waste half of every product on zero rows), and W,
//     read N-contiguous, is the A fragment whose four elements a thread
//     takes from two K rows of the stage. Warp w takes k8 block w of every
//     stage for all 64 columns: four independent chains of products a warp
//     (one warp a 16-column slice, all of K, was slower: one chain); the
//     four warps' sums meet in shared memory once, at the end;
//   * x@A differs per row (each row has its own adapter), so it cannot
//     ride on the shared product: it is a matrix-vector product per row,
//     taken on the CUDA cores in f32 (no tensor-core tile fits one row) by
//     blocks of its own after the W tiles, in units of at most 64 ranks: a
//     row's whole rank where r <= 64, else one 64-rank chunk of it (r = 256
//     is four units of a row). Each x@A block takes at most 32 / r units
//     of a row tile (one where r > 32), dealt round-robin
//     (grouped_tf32_xa_units mirrors the deal), so that no block streams
//     more bytes than a tile of W (a unit's 32 x 64 slice of A a stage is
//     W's 32 x 64), and no W block waits on ids (x@A in the W blocks, as
//     the bf16 kernel has it, made those blocks the slowest: measured,
//     PERF.md). It is computed once per (row, K split), never once per N
//     tile; A is read where it lies in the bank (through its stride, so
//     the strided in-place bank of AdapterBank.gather needs no gathered
//     copy);
//   * the f32 partial sums of x@W and x@A go to a workspace and a second
//     kernel adds the splits in a fixed order (deterministic), applies
//     s * (x@A) @ B[ids[row]] and stores y once. It is launched as a
//     programmatic dependent of the split kernel (griddepcontrol): it is
//     scheduled while the split blocks run, reads ids and (a first batch
//     of) its rows of B, and only then waits for the split grid. At r <= 64
//     a lane holds its r / 4 rank steps of B in registers; at r > 64 that
//     would grow with r, so a second reduce kernel reads B in rank groups,
//     16-byte loads in batches of eight, whatever r. (A single launch whose
//     last block per tile reduces would need a counter zeroed before every
//     call, that is another launch or state kept between calls.)
//
// Rounding order: that of the plain version and of the TPU kernel
// (kernels/ref.py): f32 sums; x@A is rounded to the activation dtype before
// it meets B, which in f32 is no rounding at all. Nothing carries over
// between calls (every workspace element is written before it is read) and
// nothing synchronises with the host, so the call can be captured in a CUDA
// graph (the serving twin's tick timer does).

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

constexpr int BN = 64;                  // columns of W a block: 4 warps x 16
constexpr int BK = 32;                  // K a stage
constexpr int NT = 128;
constexpr int STAGES = 4;
constexpr int LDW = BN + 8;             // row t, column g: bank 8t + g
constexpr int LDX = BK + 4;             // row g, column t: bank 4g + t
constexpr int MAX_R = 256;
constexpr int RP = 64;                  // ranks of one x@A unit, at most
constexpr int KB = BK / 8;              // k8 blocks a stage
constexpr int W_OFF = 0;                // floats into a stage
constexpr int X_OFF = BK * LDW;
constexpr int XA_COLS = 32;             // x@A units x r a block, r <= 32
constexpr int XA_SLOTS = BK * RP / 4 / NT;      // x@A (unit, k, 4 columns)
                                                // triples a thread, a stage
constexpr int RED_LD = BN + 4;          // the warps' sums: row 2t, column g
                                        // at bank 8t + g

// (hi, lo) of the b fragment (x^T) at p: b0 = x[g][t] = p[0], b1 = p[4]
__device__ __forceinline__ float4 split_x(const float* p) {
  uint32_t h0, l0, h1, l1;
  split_rz(p[0], h0, l0);
  split_rz(p[4], h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(l0),
                     __uint_as_float(h1), __uint_as_float(l1));
}

// (hi, lo) of the a fragment (W^T) whose element (g, t) = W[t][g] is at p:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
__device__ __forceinline__ void split_w(const float* p, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_rz(p[0], hi[0], lo[0]);
  split_rz(p[8], hi[1], lo[1]);
  split_rz(p[4 * LDW], hi[2], lo[2]);
  split_rz(p[4 * LDW + 8], hi[3], lo[3]);
}

// x@A units of a row tile: r <= 64 gives a unit a row, r > 64 a unit a
// 64-rank chunk of a row; unit u is row u / chunks, ranks 64 * (u % chunks)
// on; an x@A block holds at most units_per_block(r) of them.
__host__ __device__ __forceinline__ int rank_chunks(int r) {
  return ceil_div(r, RP);
}
__host__ __device__ __forceinline__ int units_per_block(int r) {
  return r <= XA_COLS ? XA_COLS / r : 1;
}

// One block (bx, row tile, split), of one of two kinds, both over the
// split's K range:
//   bx < n_tiles: the (8 NR, 64) tile of x@W at columns 64 bx. Warp w takes
//     the k8 block w of every stage for all 64 columns (four m16 tiles,
//     four independent chains of products), and the four warps' sums meet
//     in shared memory at the end, in warp order;
//   bx >= n_tiles: x@A of the tile's units j, j + nxa, ... (j = bx -
//     n_tiles, nxa = nx - n_tiles x@A blocks; at most units_per_block(r),
//     all of one width uw: r, or a 64-rank chunk), so that no block streams
//     more than about one tile of W's bytes and no W block waits on ids.
// The f32 partial sums go to ws_y[split] and ws_xa[split]. A stage holds W
// (BK x LDW; W blocks), the rows of x (8 NR x LDX) and the x@A units'
// slices of A (dense (unit, k, uw); x@A blocks).
template <int NR>
__global__ void __launch_bounds__(NT)
lora_matmul_grouped_tf32_split_kernel(
    const float* __restrict__ X, const float* __restrict__ W,
    const float* __restrict__ Abank, const int* __restrict__ ids,
    float* __restrict__ ws_y, float* __restrict__ ws_xa, int rows,
    int rows_per_group, int K, int N, int r, long long a_stride,
    int iters_per_split, int n_tiles, int nx, int stage_floats) {
  constexpr int RT = 8 * NR;            // rows of a row tile
  constexpr int A_OFF = X_OFF + RT * LDX;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  __shared__ const float* a_row[RP / 4];      // bank slice of each unit

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bx = blockIdx.x;
  const int m0 = blockIdx.y * RT;
  const int split = blockIdx.z;
  const int it0 = split * iters_per_split;
  const int n_it = min(iters_per_split, ceil_div(K, BK) - it0);   // >= 1
  const int rows_here = min(RT, rows - m0);
  const bool do_w = bx < n_tiles;       // uniform over the block
  const int n0 = bx * BN;
  const int xj = bx - n_tiles, nxa = nx - n_tiles;
  const int chunks = rank_chunks(r);
  const int units = rows_here * chunks;
  const int n_xa = !do_w && xj < units ? ceil_div(units - xj, nxa) : 0;
  if (!do_w && n_xa == 0) return;       // uniform over the block
  // the units' width: r, or (one unit a block) its 64-rank chunk; a W
  // block's is never used, but stays non-zero
  const int uw = min(RP, r - RP * (max(xj, 0) % chunks));
  const int rc = uw / 4;                // 16-byte chunks across a unit's row
  const int xa_pairs = n_xa * BK * rc;  // (unit, k, chunk) triples a stage

  const float* a_src[XA_SLOTS];         // A[ids[row]] at (kk, first + 4 c)
  int a_kk[XA_SLOTS];
  int x_at[XA_SLOTS];                   // x[row][kk] in a stage's x tile

  auto load_wx = [&](int stage, int it) {
    float* sb = ring + stage * stage_floats;
    const int k0 = (it0 + it) * BK;
#pragma unroll
    for (int i = 0; i < (RT * BK / 4 + NT - 1) / NT; ++i) {   // x: RT x 8
      const int c = tid + i * NT;
      if (c < RT * BK / 4) {
        const int row = c / (BK / 4), q = c % (BK / 4);
        const int gm = m0 + row, gk = k0 + 4 * q;
        const bool ok = gm < rows && gk < K;
        cp_async16(smem_u32(sb + X_OFF + row * LDX + 4 * q),
                   ok ? X + (size_t)gm * K + gk : X, ok);
      }
    }
    if (do_w) {
#pragma unroll
      for (int i = 0; i < BK * BN / 4 / NT; ++i) {         // W: 32 x 16
        const int c = tid + i * NT, row = c / (BN / 4), q = c % (BN / 4);
        const int gk = k0 + row, gn = n0 + 4 * q;
        const bool ok = gk < K && gn < N;
        cp_async16(smem_u32(sb + W_OFF + row * LDW + 4 * q),
                   ok ? W + (size_t)gk * N + gn : W, ok);
      }
    }
  };
  // A[ids[row]][k0 : k0 + 32, first : first + uw], dense (k, uw) a unit
  auto load_a = [&](int stage, int it) {
    float* sb = ring + stage * stage_floats;
    const int k0 = (it0 + it) * BK;
#pragma unroll
    for (int s = 0; s < XA_SLOTS; ++s) {
      const int idx = tid + s * NT;
      if (idx < xa_pairs) {
        const bool ok = k0 + a_kk[s] < K;
        cp_async16(smem_u32(sb + A_OFF + 4 * idx),
                   ok ? a_src[s] + (size_t)k0 * r : a_src[s], ok);
      }
    }
  };

  float acc[4][NR][4];
  float4 xa[XA_SLOTS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
#pragma unroll
  for (int s = 0; s < XA_SLOTS; ++s) xa[s] = make_float4(0.f, 0.f, 0.f, 0.f);

  // The prologue: W and x of the first STAGES - 1 stages go out first, in
  // the first copy group with the A of stage 0 (x@A blocks read the
  // adapters' ids in between); groups 1 .. STAGES - 2 hold the A of stages
  // 1 .. STAGES - 2, and every later group one whole stage, so waiting for
  // group `it` finds stage `it` complete.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < n_it) load_wx(s, s);
  // the reduction kernel may be scheduled from here on (it waits for this
  // grid's completion before it reads the partials)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (!do_w) {                          // uniform over the block
    if (tid < n_xa) {
      const int u = xj + tid * nxa;
      a_row[tid] = Abank + (size_t)ids[(m0 + u / chunks) / rows_per_group] *
                               a_stride + RP * (u % chunks);
    }
    __syncthreads();                    // a_row visible to every thread
  }
  // this thread's (unit, k, chunk) triples of x@A: the same in every stage
#pragma unroll
  for (int s = 0; s < XA_SLOTS; ++s) {
    const int idx = tid + s * NT;
    const int q = idx / (BK * rc), rem = idx % (BK * rc);
    const int kk = rem / rc, c = rem % rc;
    const bool mine = idx < xa_pairs;
    a_src[s] = mine ? a_row[q] + (size_t)kk * r + 4 * c : Abank;
    a_kk[s] = kk;
    x_at[s] = X_OFF + ((xj + q * nxa) / chunks) * LDX + kk;
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) load_a(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<STAGES - 2>();        // this thread's copies of stage `it`
    __syncthreads();                    // everyone's; stage it - 1 is free
    if (it + STAGES - 1 < n_it) {
      load_wx((it + STAGES - 1) % STAGES, it + STAGES - 1);
      load_a((it + STAGES - 1) % STAGES, it + STAGES - 1);
    }
    cp_async_commit();
    const float* sb = ring + (it % STAGES) * stage_floats;
    if (do_w) {                         // k8 block `warp` of the stage
      float4 xb[NR];
#pragma unroll
      for (int n = 0; n < NR; ++n)
        xb[n] = split_x(sb + X_OFF + (8 * n + g) * LDX + 8 * warp + t);
      uint32_t whi[4][4], wlo[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_w(sb + W_OFF + (8 * warp + t) * LDW + 16 * i + g, whi[i],
                wlo[i]);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma3<NR>(acc[i], whi[i], wlo[i], xb);
    } else {                            // x@A on the CUDA cores, in f32
#pragma unroll
      for (int s = 0; s < XA_SLOTS; ++s) {
        const int idx = tid + s * NT;
        if (idx < xa_pairs) {
          const float xv = sb[x_at[s]];
          const float4 av =
              *reinterpret_cast<const float4*>(sb + A_OFF + 4 * idx);
          xa[s].x = fmaf(xv, av.x, xa[s].x);
          xa[s].y = fmaf(xv, av.y, xa[s].y);
          xa[s].z = fmaf(xv, av.z, xa[s].z);
          xa[s].w = fmaf(xv, av.w, xa[s].w);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free from here on

  if (do_w) {
    // each warp's sums over its k8 blocks: acc[i][n] holds d0 (row 8n + 2t,
    // column 16i + g), d1 (row + 1), d2 (column + 8), d3 (both); rows of
    // RED_LD floats (bank 8t + g: no conflict)
    float* red = ring + warp * RT * RED_LD;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        const int row = 8 * n + 2 * t, col = 16 * i + g;
        red[row * RED_LD + col] = acc[i][n][0];
        red[(row + 1) * RED_LD + col] = acc[i][n][1];
        red[row * RED_LD + col + 8] = acc[i][n][2];
        red[(row + 1) * RED_LD + col + 8] = acc[i][n][3];
      }
    __syncthreads();
    // the four warps' sums in warp order, four columns a thread, 16-byte
    // stores of the split's partial
    float* py = ws_y + (size_t)split * rows * N;
    for (int idx = tid; idx < RT * BN / 4; idx += NT) {
      const int row = idx / (BN / 4), col = 4 * (idx % (BN / 4));
      if (row >= rows_here || n0 + col >= N) continue;   // N % 4 == 0
      float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) {
        const float4 v = *reinterpret_cast<const float4*>(
            ring + (w * RT + row) * RED_LD + col);
        s4.x += v.x; s4.y += v.y; s4.z += v.z; s4.w += v.w;
      }
      *reinterpret_cast<float4*>(py + (size_t)(m0 + row) * N + n0 + col) =
          s4;
    }
    return;
  }

  // x@A: each thread's partials over its k's go to shared memory, laid out
  // (unit, k, column); each (unit, column) output is summed by `lanes`
  // neighbouring lanes, BK / lanes k's each, then by a shuffle tree (a
  // fixed order), and the split's partial written
#pragma unroll
  for (int s = 0; s < XA_SLOTS; ++s) {
    const int idx = tid + s * NT;
    if (idx < xa_pairs) reinterpret_cast<float4*>(ring)[idx] = xa[s];
  }
  __syncthreads();
  const int outs = n_xa * uw;           // <= 64
  int lanes = 32;                       // a power of two, lanes * outs <= NT
  while (lanes * outs > NT) lanes >>= 1;
  const int o = tid / lanes, part = tid % lanes;
  float sum = 0.f;
  if (o < outs) {
    const int q = o / uw, j = o % uw;
    const float* p = ring + (size_t)q * BK * uw + j;
    for (int kk = part * (BK / lanes); kk < (part + 1) * (BK / lanes); ++kk)
      sum += p[kk * uw];
  }
  for (int off = lanes / 2; off > 0; off >>= 1)   // uniform over the warp
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (o < outs && part == 0) {
    const int q = o / uw, j = o % uw;
    const int u = xj + q * nxa;
    ws_xa[((size_t)split * rows + m0 + u / chunks) * r + RP * (u % chunks) +
          j] = sum;
  }
}

// The reduction over the splits and the epilogue at r <= 64: one row and
// 128 columns a block, four neighbouring columns (16-byte loads and
// stores) for four neighbouring lanes, lane `part` of them summing the
// splits part, part + 4,
// ... of x@W and the rank steps part, part + 4, ... of the correction, so
// that no thread waits on more than a few rounds of loads; a shuffle tree
// joins the four (fixed order, so the result does not depend on the
// schedule). x@A of the row is summed over the splits the same way, by
// `xl` lanes a rank column, into shared memory.
constexpr int R_PARTS = 4;
constexpr int R_COLS = 4 * NT / R_PARTS;    // 128
constexpr int B_AHEAD = RP / R_PARTS;       // rank steps of B a lane holds

__global__ void __launch_bounds__(NT)
lora_matmul_grouped_tf32_reduce_kernel(
    const float* __restrict__ ws_y, const float* __restrict__ ws_xa,
    const float* __restrict__ Bbank, const int* __restrict__ ids,
    float* __restrict__ Y, int rows, int rows_per_group, int N, int r,
    long long b_stride, int splits, float scale) {
  __shared__ float xas[RP];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int part = tid % R_PARTS;
  const int col = blockIdx.y * R_COLS + 4 * (tid / R_PARTS);
  const bool active = col < N;          // N % 4 == 0: all four or none
  // Launched while the split kernel runs: what it does not write (ids and
  // this lane's rows of B[ids[row]]) is read before the wait for it.
  const float* Bp = Bbank + (size_t)ids[row / rows_per_group] * b_stride +
                    (active ? col : 0);
  float4 bq[B_AHEAD];
#pragma unroll
  for (int i = 0; i < B_AHEAD; ++i) {
    const int j = part + R_PARTS * i;
    if (active && j < r)
      bq[i] = *reinterpret_cast<const float4*>(Bp + (size_t)j * N);
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // x@A of the row: `xl` lanes (a power of two, xl * r <= NT) a column
  int xl = 32;
  while (xl * r > NT) xl >>= 1;
  const int jx = tid / xl, qx = tid % xl;
  float sa = 0.f;
  if (jx < r) {
#pragma unroll 8
    for (int sp = qx; sp < splits; sp += xl)
      sa += ws_xa[((size_t)sp * rows + row) * r + jx];
  }
  for (int off = xl / 2; off > 0; off >>= 1)      // uniform over the warp
    sa += __shfl_xor_sync(0xffffffffu, sa, off);
  if (jx < r && qx == 0) xas[jx] = sa;
  // this lane's splits of x@W
  float4 sy = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active) {
#pragma unroll 8
    for (int sp = part; sp < splits; sp += R_PARTS) {
      const float4 v = *reinterpret_cast<const float4*>(
          ws_y + ((size_t)sp * rows + row) * N + col);
      sy.x += v.x; sy.y += v.y; sy.z += v.z; sy.w += v.w;
    }
  }
  __syncthreads();
  float4 ad = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active) {
#pragma unroll
    for (int i = 0; i < B_AHEAD; ++i) {
      const int j = part + R_PARTS * i;
      if (j < r) {
        const float xv = xas[j];
        ad.x = fmaf(xv, bq[i].x, ad.x); ad.y = fmaf(xv, bq[i].y, ad.y);
        ad.z = fmaf(xv, bq[i].z, ad.z); ad.w = fmaf(xv, bq[i].w, ad.w);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < R_PARTS; off <<= 1) {   // every lane takes part
    sy.x += __shfl_xor_sync(0xffffffffu, sy.x, off);
    sy.y += __shfl_xor_sync(0xffffffffu, sy.y, off);
    sy.z += __shfl_xor_sync(0xffffffffu, sy.z, off);
    sy.w += __shfl_xor_sync(0xffffffffu, sy.w, off);
    ad.x += __shfl_xor_sync(0xffffffffu, ad.x, off);
    ad.y += __shfl_xor_sync(0xffffffffu, ad.y, off);
    ad.z += __shfl_xor_sync(0xffffffffu, ad.z, off);
    ad.w += __shfl_xor_sync(0xffffffffu, ad.w, off);
  }
  if (active && part == 0)
    *reinterpret_cast<float4*>(Y + (size_t)row * N + col) =
        make_float4(sy.x + scale * ad.x, sy.y + scale * ad.y,
                    sy.z + scale * ad.z, sy.w + scale * ad.w);
}

// The reduction over the splits and the epilogue at r > 64: one row and 64
// columns a block. The correction reads the row's B[ids[row]] (r * 256
// bytes a block, 64 KB at r = 256) with no reuse across rows, so its loads
// are spread for many in flight and no thread's registers grow with r:
// eight rank groups (j = g, g + 8, ...) of sixteen threads, each thread a
// 16-byte load of 4 columns a rank, in batches of eight loads, the first
// batch read before the wait for the split grid; the groups' sums meet in
// shared memory, added in a fixed order. The r sums of x@A and the 64 of
// x@W over the splits are dealt over all the threads, one sum after
// another, each by common.cuh::sum_strided in split order: past 8 splits
// (28 at (K, N) = (7168, 896), the deepest K split being 8 steps) with its
// loads 32 at a time, since 8 at a time waited 4 round trips a sum; up to
// 8 splits 8 at a time (both measured faster where they are used, PERF.md).
constexpr int G_CG = 16;                // 4-column groups of a block
constexpr int G_RG = NT / G_CG;         // rank groups: 8
constexpr int G_COLS = 4 * G_CG;        // 64
constexpr int BATCH = 8;                // loads of B in flight a thread
constexpr int SUM_BATCH = 32;           // loads of a deep split sum in flight

__global__ void __launch_bounds__(NT)
lora_matmul_grouped_tf32_reduce_wide_kernel(
    const float* __restrict__ ws_y, const float* __restrict__ ws_xa,
    const float* __restrict__ Bbank, const int* __restrict__ ids,
    float* __restrict__ Y, int rows, int rows_per_group, int N, int r,
    long long b_stride, int splits, float scale) {
  __shared__ float xas[MAX_R];
  __shared__ float sys[G_COLS];
  __shared__ __align__(16) float part[G_RG][G_COLS];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int c0 = blockIdx.y * G_COLS;
  const int cg = tid % G_CG, rg = tid / G_CG;
  const int c4 = c0 + 4 * cg;
  const bool live4 = c4 < N;            // N % 4 == 0: all 4 columns or none
  const float* Bp = Bbank + (size_t)ids[row / rows_per_group] * b_stride +
                    (live4 ? c4 : 0);
  // this thread's ranks j0, j0 + 8, ... of B: one batch of loads
  float4 bv[BATCH];
  auto load_b = [&](int j0) {
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int j = j0 + u * G_RG;
      bv[u] = live4 && j < r
          ? *reinterpret_cast<const float4*>(Bp + (size_t)j * N)
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load_b(rg);           // the first batch, before the wait and over the sums
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  auto sum = [&](const float* p, size_t stride) {
    return splits > 8 ? repro::sum_strided<SUM_BATCH>(p, stride, splits)
                      : repro::sum_strided(p, stride, splits);
  };
  // sum j < r: x@A's rank j; else x@W's column c0 + j - r (zero past N)
  for (int j = tid; j < r + G_COLS; j += NT) {
    if (j < r)
      xas[j] = sum(ws_xa + (size_t)row * r + j, (size_t)rows * r);
    else
      sys[j - r] = c0 + j - r < N
          ? sum(ws_y + (size_t)row * N + c0 + j - r, (size_t)rows * N)
          : 0.f;
  }
  __syncthreads();
  float4 ad = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = rg; j0 < r; j0 += BATCH * G_RG) {
    if (j0 != rg) load_b(j0);
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int j = j0 + u * G_RG;
      const float xv = j < r ? xas[j] : 0.f;
      ad.x = fmaf(xv, bv[u].x, ad.x); ad.y = fmaf(xv, bv[u].y, ad.y);
      ad.z = fmaf(xv, bv[u].z, ad.z); ad.w = fmaf(xv, bv[u].w, ad.w);
    }
  }
  *reinterpret_cast<float4*>(&part[rg][4 * cg]) = ad;
  __syncthreads();
  const int col = c0 + tid;             // threads < G_COLS: a column each
  if (tid >= G_COLS || col >= N) return;
  float corr = 0.f;
#pragma unroll
  for (int g = 0; g < G_RG; ++g) corr += part[g][tid];
  Y[(size_t)row * N + col] = sys[tid] + scale * corr;
}

template <int NR>
cudaError_t launch(const float* x, const float* w, const float* a,
                   const float* b, const int* ids, float* y, float* ws_y,
                   float* ws_xa, int rows, int rows_per_group, int K, int N,
                   int r, long long a_stride, long long b_stride, float scale,
                   int splits, int iters_per_split, int nx,
                   cudaStream_t stream) {
  constexpr int RT = 8 * NR;
  auto kernel = lora_matmul_grouped_tf32_split_kernel<NR>;
  // the stage of A holds the most x@A units a block gets (first row tile)
  const int a_cols = ceil_div((rows < RT ? rows : RT) * rank_chunks(r),
                              nx - ceil_div(N, BN)) *
                     (r < RP ? r : RP);                              // <= 64
  const int stage_floats = X_OFF + RT * LDX + BK * a_cols;
  const int bytes = (int)sizeof(float) * STAGES * stage_floats;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(nx, ceil_div(rows, RT), splits);
  kernel<<<grid, NT, bytes, stream>>>(x, w, a, ids, ws_y, ws_xa, rows,
                                      rows_per_group, K, N, r, a_stride,
                                      iters_per_split, ceil_div(N, BN), nx,
                                      stage_floats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // programmatic dependent launch: the reduction is scheduled once every
  // split block has started, reads what does not depend on them, and
  // waits (griddepcontrol.wait) for the split grid's completion
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows, ceil_div(N, r <= RP ? R_COLS : G_COLS));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto reduce = r <= RP ? lora_matmul_grouped_tf32_reduce_kernel
                        : lora_matmul_grouped_tf32_reduce_wide_kernel;
  err = cudaLaunchKernelEx(&cfg, reduce, static_cast<const float*>(ws_y),
                           static_cast<const float*>(ws_xa), b, ids, y, rows,
                           rows_per_group, N, r, b_stride, splits, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues the split kernel and the
// reduction on the given stream, does not synchronise, allocates nothing,
// returns the cudaError_t of the launches (0 on success); -1: arguments the
// kernel does not take. x (rows, K) contiguous, w (K, N) contiguous, the
// banks a (E, K, r) and b (E, r, N) with each adapter's matrix contiguous
// and adapters a_stride / b_stride elements apart, y (rows, N); all f32,
// 16-byte aligned (the workspaces too), K, N, r and both strides multiples
// of 4, r <= 256; ids int32, one per group of rows_per_group rows. ws_y
// holds splits * rows * N floats, ws_xa splits * rows * r. The plan (rt:
// rows of a row tile, 8, 16 or 32; splits, iters_per_split: 32-deep K
// steps a split, none empty; nx: blocks along N, the N tiles of 64 and
// after them enough x@A blocks that none holds more than units_per_block(r)
// x@A units) comes from the wrapper's grouped_tf32_plan.
extern "C" int lora_matmul_grouped_tf32_launch(
    const void* x, const void* w, const void* a_bank, const void* b_bank,
    const void* ids, void* y, void* ws_y, void* ws_xa, int rows,
    int rows_per_group, int K, int N, int r, long long a_stride,
    long long b_stride, float scale, int rt, int splits, int iters_per_split,
    int nx, void* stream) {
  const int n_iters = ceil_div(K, BK);
  const int rows_tile = rows < rt ? rows : rt;
  if (rows < 1 || rows_per_group < 1 || K < 4 || N < 4 || r < 4 ||
      r > MAX_R || K % 4 || N % 4 || r % 4 || a_stride % 4 || b_stride % 4 ||
      (rt != 8 && rt != 16 && rt != 32) || splits < 1 ||
      iters_per_split < 1 || splits > 65535 || ceil_div(rows, rt) > 65535 ||
      (splits - 1) * iters_per_split >= n_iters ||
      splits * iters_per_split < n_iters || nx <= ceil_div(N, BN) ||
      units_per_block(r) * (nx - ceil_div(N, BN)) <
          rows_tile * rank_chunks(r) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(a_bank) |
       reinterpret_cast<uintptr_t>(b_bank) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(ws_y) |
       reinterpret_cast<uintptr_t>(ws_xa)) % 16)
    return -1;
  const float* xx = static_cast<const float*>(x);
  const float* ww = static_cast<const float*>(w);
  const float* aa = static_cast<const float*>(a_bank);
  const float* bb = static_cast<const float*>(b_bank);
  const int* ii = static_cast<const int*>(ids);
  float* yy = static_cast<float*>(y);
  float* wy = static_cast<float*>(ws_y);
  float* wa = static_cast<float*>(ws_xa);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rt == 8)
    return static_cast<int>(launch<1>(xx, ww, aa, bb, ii, yy, wy, wa, rows,
                                      rows_per_group, K, N, r, a_stride,
                                      b_stride, scale, splits,
                                      iters_per_split, nx, s));
  if (rt == 16)
    return static_cast<int>(launch<2>(xx, ww, aa, bb, ii, yy, wy, wa, rows,
                                      rows_per_group, K, N, r, a_stride,
                                      b_stride, scale, splits,
                                      iters_per_split, nx, s));
  return static_cast<int>(launch<4>(xx, ww, aa, bb, ii, yy, wy, wa, rows,
                                    rows_per_group, K, N, r, a_stride,
                                    b_stride, scale, splits, iters_per_split,
                                    nx, s));
}
