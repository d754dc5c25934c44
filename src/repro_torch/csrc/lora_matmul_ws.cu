// lora_matmul for Hopper (sm_90a), bf16, at prefill-sized M, written by hand
// as a warp-specialised persistent kernel:
//
//   Y = X @ W + s * round_bf16(X @ A) @ B
//
// It takes the place of the Pallas TPU kernel lora_matmul of
// src/repro/kernels/lora_matmul.py for bf16 inputs with M >= WS_MIN_ROWS
// (kernels/lora_matmul.py), K, N multiples of 8, r a multiple of 8 up to 64,
// and 16-byte aligned pointers; smaller M stays on lora_matmul_tc.cu, larger
// ranks on lora_matmul_tc.cu as well (the wrapper chooses by dtype, shape and
// alignment alone, never by failure).
//
// What bounds it on this card: over a prefill chunk (M = 1024 or 4096 rows
// of qwen2-7b's projections) the function does 500 to 2,000 FLOP per byte
// it must move, far past the ~295 at which the tensor cores and not device
// memory are the limit. So the design keeps a wgmma in flight on every SM,
// and keeps the slabs it reads from L2 few enough for L2 to feed it:
//
//   * a block of three warpgroups: a producer whose one elected thread
//     issues every TMA copy and gives its registers up (setmaxnreg 40), and
//     two consumers of 64 output rows each of a 128 x 256 tile, raised to
//     232 registers;
//   * a ring of four stages, each the X slab (128 rows x 64 of K, K-major),
//     the W slab (64 of K x 256, MN-major, four 64-column panels) and A's
//     slab (64 of K x 64 ranks, zeros past r), guarded by a full and an
//     empty mbarrier; TMA boxes of 64 bf16 with the 128-byte swizzle, the
//     layout the wgmma descriptors read; rows and columns past M, N, K and
//     r arrive as zeros. Four stages keep three K steps of loads in flight
//     behind the one being multiplied; they fit because B's tile comes
//     through the ring and the output goes out from registers;
//   * clusters of two CTAs on neighbouring M tiles of one N tile: each
//     loads two of the W slab's four panels and multicasts them into both,
//     so a CTA pulls 34 KB from L2 a K step instead of 50 (a 128 x 256 x 64
//     step on its own would want ~12 TB/s of L2 across the card at the
//     tensor cores' rate); a stage is free once the consumers of both CTAs
//     have read it (its empty barrier counts 16 warps, 8 of them arriving
//     from the peer); a single M tile runs alone, unclustered;
//   * each consumer issues a K step's four k16 products of X @ W (n = 256)
//     and of X @ A (n = 16, 32 or 64: r rounded up) as one group and waits
//     for the group before it (wgmma_wait<1>), so one group is always in
//     flight; a stage is released when the group that read it has landed;
//   * X @ A accumulates in f32 registers over all of K, as the TPU kernel's
//     xa scratch does, and is rounded once to bf16 into the A fragments of
//     the correction product;
//   * epilogue: per 64-column chunk of the tile, round(X@A) @ B[:, chunk]
//     on the tensor cores (B's tile loaded by the producer after the tile's
//     last K slab, as the tile's last step of the ring), acc + s * that in
//     f32, rounded once to bf16 and stored as pairs of columns (rows and
//     columns past M and N left out);
//   * a persistent grid of as many clusters as the card holds at once
//     (cudaOccupancyMaxActiveClusters), each walking the work units
//     u = cluster, cluster + clusters, ...; the tiles are dealt in runs of
//     GM = 8 M tiles, M fastest, so that the clusters in flight share W's
//     and X's slabs in L2;
//   * waves of whole tiles, then the last, partial wave (or every tile,
//     where there are fewer tiles than clusters) split along K into as many
//     units as fill the card: each writes f32 partials of X @ W and X @ A
//     to a workspace, and a reduce kernel adds the splits, rounds X @ A
//     once, applies B and rounds the output once. Nothing is rounded before
//     the reduction.
//
// The dealing order, tile sizes and splits are mirrored in Python by
// repro_torch.kernels.lora_matmul.ws_plan and ws_units (tested on the CPU).
//
// Rounding contract (that of the TPU kernel, kernels/ref.py and the plain
// version): every product accumulates in f32; X@A is summed over ALL of K
// and rounded once to bf16; the correction is round_bf16(X@A) @ B in f32;
// X@W + s * correction is rounded once to bf16. No host synchronisation and
// no counter carried between calls: the call can be captured in a CUDA
// graph.

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums (the encoder: the CUDA driver's)

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::ceil_div;
using namespace repro::sm90;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;                 // rows of a tile: two consumers
constexpr int BN = 256;                 // columns of a tile
constexpr int BK = 64;                  // K of a stage: one 128-byte row
constexpr int NT = 384;                 // producer + two consumer warpgroups
constexpr int PANEL = 64 * 128;         // 64 rows x 64 bf16, bytes
constexpr int GM = 8;                   // M tiles of a dealing group
constexpr int MAX_R = 64;               // ranks of the X@A beside X@W
constexpr int STAGES = 4;
// setmaxnreg moves registers within what the block was launched with (168
// a thread at 384 threads, __launch_bounds__(NT, 1)): an increase beyond
// it waits forever. The producer at 24 spills; the consumers at 232 hold a
// 64 x 256 accumulator and X@A's up to 32 columns (at 64 ptxas serialises
// the products, C7512)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 168 * NT,
              "setmaxnreg within the block's launch registers");

// An instantiation's shared-memory layout: XN columns of X@A (r rounded up
// to 16, 32 or 64). A stage holds a K step's slabs, or, as a tile's last
// step, B's (XN x 256) tile for the epilogue at its start.
template <int XN>
struct Cfg {
  static constexpr int X_OFF = 0;                     // 128 rows x 64 of K
  static constexpr int W_OFF = 2 * PANEL;             // BN / 64 panels
  static constexpr int A_OFF = W_OFF + (BN / 64) * PANEL;
  static constexpr int STAGE = A_OFF + PANEL;
  static constexpr int BPANEL = XN * 128;             // one 64-column panel
  static constexpr int BAR_OFF = STAGES * STAGE;
  // full and empty of each stage
  static constexpr int N_BARS = 2 * STAGES;
  static constexpr int BYTES = BAR_OFF + 8 * N_BARS + 1024;  // + alignment
  static_assert((BN / 64) * BPANEL <= STAGE, "B's tile fits a stage");
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// The schedule (ws_plan in the Python mirror). A cluster of `cl` CTAs (1, or
// 2 along M) takes a group tile: `cl` M tiles of 128 rows side by side, one
// N tile of 256 columns. The first `dp` group tiles are units of all of K;
// each of the last `tail` is cut into `splits` units of `ips` K steps (the
// last takes the rest), whose f32 partials a reduce kernel sums.
struct Plan {
  int M, K, N, r;
  int mt, nt, cl, mg;                   // M tiles, N tiles, cluster, M groups
  int dp, tail, splits, ips, kst, units;
  float scale;
};

// Group tile t: its M group and N tile. The tiles go in runs of GM / cl M
// groups (fewer in the last run), M fastest, so that the clusters in flight
// share W's and X's slabs in L2.
__host__ __device__ __forceinline__ void tile_of(const Plan& p, int t,
                                                 int& mg, int& nt) {
  const int run = GM / p.cl;
  const int group = run * p.nt;
  const int g = t / group, in = t - g * group;
  const int first = g * run;
  const int size = p.mg - first < run ? p.mg - first : run;
  mg = first + in % size;
  nt = in / size;
}

// Work unit u of a cluster: its group tile, its K steps [k0, k0 + n), and
// for a split unit its split and its index among the tail's tiles.
struct Unit {
  int mg, nt, k0, n, split, tt;         // split -1: a unit of all of K
};

__device__ __forceinline__ Unit unit_of(const Plan& p, int u) {
  Unit w;
  int t = u;
  w.split = -1;
  w.tt = 0;
  w.k0 = 0;
  w.n = p.kst;
  if (u >= p.dp) {
    const int v = u - p.dp;
    w.split = v / p.tail;
    w.tt = v - w.split * p.tail;
    t = p.dp + w.tt;
    w.k0 = w.split * p.ips;
    w.n = min(p.ips, p.kst - w.k0);
  }
  tile_of(p, t, w.mg, w.nt);
  return w;
}

// X@A's A fragments (bf16, the layout of the A operand from registers):
// ranks 16 kk .. 16 kk + 15 are the accumulator's column blocks 2 kk, 2 kk + 1
template <int XN>
__device__ __forceinline__ void pack_xa(uint32_t (&f)[XN / 16][4],
                                        const float (&xa)[XN / 2]) {
#pragma unroll
  for (int kk = 0; kk < XN / 16; ++kk) {
    f[kk][0] = pack_bf16(xa[8 * kk + 0], xa[8 * kk + 1]);
    f[kk][1] = pack_bf16(xa[8 * kk + 2], xa[8 * kk + 3]);
    f[kk][2] = pack_bf16(xa[8 * kk + 4], xa[8 * kk + 5]);
    f[kk][3] = pack_bf16(xa[8 * kk + 6], xa[8 * kk + 7]);
  }
}

template <int XN>
__global__ void __launch_bounds__(NT, 1)
lora_matmul_ws_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw,
                      const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      bf16* __restrict__ Y, float* __restrict__ ws_y,
                      float* __restrict__ ws_xa, const Plan p) {
  using C = Cfg<XN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = smem_base_1k(smem_raw);
  const uint32_t bars = base + C::BAR_OFF;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };
  const bool pair = p.cl == 2;
  const int cr = pair ? (int)cluster_rank() : 0;
  const int ci = blockIdx.x / p.cl, n_clusters = gridDim.x / p.cl;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      // lane 0 of each consumer warp of each CTA of the cluster: a stage's
      // W slab comes from both CTAs, so both must have read it
      mbar_init(empty(st), 8 * p.cl);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (pair) cluster_sync();             // the peer's barriers exist

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // ---- producer: one thread issues every copy ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tx);
      tma_prefetch_map(&tw);
      tma_prefetch_map(&ta);
      tma_prefetch_map(&tb);
      unsigned q = 0;
      for (int u = ci; u < p.units; u += n_clusters) {
        const Unit w = unit_of(p, u);
        const int mt = w.mg * p.cl + cr;
        for (int it = 0; it < w.n; ++it, ++q) {
          const int st = q % STAGES;
          mbar_wait(empty(st), ((q / STAGES) & 1) ^ 1);
          const uint32_t sb = base + st * C::STAGE;
          const int k = (w.k0 + it) * BK;
          // X and A this CTA's own; W's four panels, two from each CTA of
          // a pair, each landing in both
          mbar_arrive_expect_tx(full(st), C::STAGE);
          tma_load_2d(sb + C::X_OFF, &tx, full(st), k, mt * BM);
          if (pair) {
#pragma unroll
            for (int j = 2 * cr; j < 2 * cr + 2; ++j)
              tma_load_2d_multicast(sb + C::W_OFF + j * PANEL, &tw, full(st),
                                    w.nt * BN + 64 * j, k, 3);
          } else {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_2d(sb + C::W_OFF + j * PANEL, &tw, full(st),
                          w.nt * BN + 64 * j, k);
          }
          tma_load_2d(sb + C::A_OFF, &ta, full(st), 0, k);
        }
        if (w.split < 0) {
          // B[:, tile] for the epilogue: the tile's last step of the ring
          // (each CTA its own copy; the peer's consumers release it too)
          const int st = q % STAGES;
          mbar_wait(empty(st), ((q / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(full(st), (BN / 64) * C::BPANEL);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(base + st * C::STAGE + j * C::BPANEL, &tb, full(st),
                        w.nt * BN + 64 * j, 0);
          ++q;
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each of the 128-row tile ----
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int wt = threadIdx.x & 127;
    const bool lane0 = (threadIdx.x & 31) == 0;
    // a stage is free once every consumer warp of the cluster has read it
    auto release = [&](int st) {
      if (!lane0) return;
      mbar_arrive(empty(st));
      if (pair) mbar_arrive_cluster(empty(st), cr ^ 1);
    };
    unsigned q = 0;
    for (int u = ci; u < p.units; u += n_clusters) {
      const Unit w = unit_of(p, u);
      const int m0 = (w.mg * p.cl + cr) * BM + 64 * cw, n0 = w.nt * BN;
      float acc[BN / 2];
      float xa[XN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < XN / 2; ++i) xa[i] = 0.f;

      int prev = -1;                    // the stage of the group in flight
      for (int it = 0; it < w.n; ++it, ++q) {
        const int st = q % STAGES;
        mbar_wait(full(st), (q / STAGES) & 1);
        const uint32_t sb = base + st * C::STAGE;
        const uint32_t sx = sb + C::X_OFF + cw * PANEL;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dx = desc128(sx + 32 * kk, 16, 1024);
          wgmma_ss<1>(acc, dx,
                      desc128(sb + C::W_OFF + 2048 * kk, PANEL, 1024));
          wgmma_ss<1>(xa, dx, desc128(sb + C::A_OFF + 2048 * kk, PANEL, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();                // the group before this one landed
        if (prev >= 0) release(prev);
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(xa);
      if (prev >= 0) release(prev);

      if (w.split >= 0) {
        // f32 partials of the tail's tile, row-major 128 x 256 (and
        // 128 x r of X@A) a tile, two neighbouring columns a store
        const size_t tile = (size_t)w.split * p.tail * p.cl + w.tt * p.cl + cr;
        float* py = ws_y + tile * BM * BN;
        float* pa = ws_xa + tile * BM * p.r;
#pragma unroll
        for (int i = 0; i < BN / 2; i += 2) {
          const int row = 64 * cw + acc_row(wt, i), col = acc_col(wt, i);
          *reinterpret_cast<float2*>(py + row * BN + col) =
              make_float2(acc[i], acc[i + 1]);
        }
#pragma unroll
        for (int i = 0; i < XN / 2; i += 2) {
          const int row = 64 * cw + acc_row(wt, i), col = acc_col(wt, i);
          if (col < p.r)
            *reinterpret_cast<float2*>(pa + row * p.r + col) =
                make_float2(xa[i], xa[i + 1]);
        }
        continue;
      }

      // epilogue: round(X@A) once, then per 64-column chunk the correction
      // on the tensor cores (B from the tile's last ring stage), acc + s *
      // correction rounded once and stored, rows past M and columns past N
      // left out
      uint32_t xf[XN / 16][4];
      pack_xa<XN>(xf, xa);
      const int st = q % STAGES;
      mbar_wait(full(st), (q / STAGES) & 1);
      ++q;
      const uint32_t sb = base + st * C::STAGE;
#pragma unroll
      for (int j = 0; j < BN / 64; ++j) {
        float c[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) c[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < XN / 16; ++kk)
          wgmma_rs(c, xf[kk],
                   desc128(sb + j * C::BPANEL + 2048 * kk, PANEL, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(c);
        if (j == BN / 64 - 1) release(st);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int row = m0 + acc_row(wt, i);
          const int col = n0 + 64 * j + acc_col(wt, i);
          if (row < p.M && col < p.N)
            *reinterpret_cast<uint32_t*>(Y + (size_t)row * p.N + col) =
                pack_bf16(acc[32 * j + i] + p.scale * c[i],
                          acc[32 * j + i + 1] + p.scale * c[i + 1]);
        }
      }
    }
  }
  // no CTA leaves while its peer may still arrive on its barriers
  if (pair) cluster_sync();
}

// The reduction of the tail's split units and their epilogue: R_ROWS rows
// of one tail tile a block, four neighbouring columns a thread (16-byte
// loads of the partials, eight splits' loads out at once). X@A of the rows
// is summed over the splits and rounded once to bf16 in shared memory; each
// thread then adds the splits of its columns, the correction with B, and
// rounds once.
constexpr int R_ROWS = 4;
constexpr int R_THREADS = BN / 4;

__device__ __forceinline__ float4 sum4_strided(const float* __restrict__ p,
                                               size_t stride, int n) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < n; i0 += 8) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = i0 + u < n ? *reinterpret_cast<const float4*>(
                              p + (size_t)(i0 + u) * stride)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      s.x += v[u].x;
      s.y += v[u].y;
      s.z += v[u].z;
      s.w += v[u].w;
    }
  }
  return s;
}

__global__ void __launch_bounds__(R_THREADS)
lora_matmul_ws_reduce_kernel(const float* __restrict__ ws_y,
                             const float* __restrict__ ws_xa,
                             const bf16* __restrict__ B, bf16* __restrict__ Y,
                             const Plan p) {
  __shared__ float xas[R_ROWS][MAX_R];
  const int tid = threadIdx.x;
  const int tile = blockIdx.z;                        // among the tail's
  int mg, nt;
  tile_of(p, p.dp + tile / p.cl, mg, nt);
  const int row0 = (mg * p.cl + tile % p.cl) * BM, lr0 = blockIdx.y * R_ROWS;
  const size_t tiles = (size_t)p.tail * p.cl;         // a split's tiles
  const float* pa = ws_xa + (size_t)tile * BM * p.r;
  for (int idx = tid; idx < R_ROWS * p.r; idx += R_THREADS) {
    const int rr = idx / p.r, j = idx % p.r;
    xas[rr][j] = repro::round_to<bf16>(repro::sum_strided(
        pa + (lr0 + rr) * p.r + j, tiles * BM * p.r, p.splits));
  }
  __syncthreads();
  const int lc = 4 * tid, col = nt * BN + lc;
  if (col >= p.N) return;                             // N % 8 == 0: all 4 in
  float ad[R_ROWS][4] = {};
  for (int j = 0; j < p.r; ++j) {
    const uint2 raw =
        *reinterpret_cast<const uint2*>(B + (size_t)j * p.N + col);
    const __nv_bfloat162 b01 =
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b23 =
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    const float bv[4] = {__low2float(b01), __high2float(b01), __low2float(b23),
                         __high2float(b23)};
#pragma unroll
    for (int rr = 0; rr < R_ROWS; ++rr)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ad[rr][c] = fmaf(xas[rr][j], bv[c], ad[rr][c]);
  }
  const float* py = ws_y + (size_t)tile * BM * BN;
#pragma unroll
  for (int rr = 0; rr < R_ROWS; ++rr) {
    const int row = row0 + lr0 + rr;
    if (row >= p.M) break;
    const float4 s = sum4_strided(py + (lr0 + rr) * BN + lc, tiles * BM * BN,
                                  p.splits);
    uint2 out;
    out.x = pack_bf16(s.x + p.scale * ad[rr][0], s.y + p.scale * ad[rr][1]);
    out.y = pack_bf16(s.z + p.scale * ad[rr][2], s.w + p.scale * ad[rr][3]);
    *reinterpret_cast<uint2*>(Y + (size_t)row * p.N + col) = out;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver (the library links no -lcuda),
// looked up once
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A 2-D map over a row-major bf16 (rows, cols) matrix, boxes of 64 columns
// x `box_rows` rows with the 128-byte swizzle; outside the matrix a load
// reads zeros and a store writes nothing.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
              int box_rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int XN>
int launch(const void* x, const void* w, const void* a, const void* b,
           void* y, float* ws_y, float* ws_xa, const Plan& p, int blocks,
           cudaStream_t stream) {
  using C = Cfg<XN>;
  CUtensorMap tx, tw, ta, tb;
  if (!make_map(&tx, x, p.M, p.K, BM) || !make_map(&tw, w, p.K, p.N, BK) ||
      !make_map(&ta, a, p.K, p.r, BK) || !make_map(&tb, b, p.r, p.N, XN))
    return -2;
  auto kernel = lora_matmul_ws_kernel<XN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = C::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tx, tw, ta, tb,
                           static_cast<bf16*>(y), ws_y, ws_xa, p);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || p.tail == 0) return err;
  const dim3 rgrid(1, BM / R_ROWS, p.tail * p.cl);
  lora_matmul_ws_reduce_kernel<<<rgrid, R_THREADS, 0, stream>>>(
      ws_y, ws_xa, static_cast<const bf16*>(b), static_cast<bf16*>(y), p);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues the persistent kernel
// and, where the plan splits a tail, the reduction on the given stream; does
// not synchronise, allocates nothing, returns the cudaError_t of the
// launches (0 on success); -1: arguments the kernel does not take; -2: the
// CUDA driver refused a tensor map. x (M, K), w (K, N), a (K, r), b (r, N),
// y (M, N) contiguous bf16, 16-byte aligned; K, N, r multiples of 8,
// r <= 64. The plan (cl, dp, tail, splits, iters_per_split: ws_plan) and
// `blocks` (the persistent grid: cl times the clusters, at most the units)
// come from the wrapper. With a tail, ws_y holds splits * tail * cl tiles
// of 128 x 256 floats and ws_xa as many of 128 x r.
extern "C" int lora_matmul_ws_launch(const void* x, const void* w,
                                     const void* a, const void* b, void* y,
                                     void* ws_y, void* ws_xa, int M, int K,
                                     int N, int r, float scale, int cl,
                                     int dp, int tail, int splits,
                                     int iters_per_split, int blocks,
                                     void* stream) {
  Plan p{};
  p.M = M;
  p.K = K;
  p.N = N;
  p.r = r;
  p.scale = scale;
  p.cl = cl;
  p.kst = ceil_div(K, BK);
  p.dp = dp;
  p.tail = tail;
  p.splits = splits;
  p.ips = iters_per_split;
  if (M < 1 || K < 8 || N < 8 || r < 8 || r > MAX_R || K % 8 || N % 8 ||
      r % 8 || (cl != 1 && cl != 2) || dp < 0 || tail < 0 || splits < 1 ||
      iters_per_split < 1 || (tail > 0) != (splits > 1) ||
      (tail > 0 && ((splits - 1) * iters_per_split >= p.kst ||
                    splits * iters_per_split < p.kst)))
    return -1;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(y)) % 16)
    return -1;
  p.mt = ceil_div(M, BM);
  p.nt = ceil_div(N, BN);
  p.mg = ceil_div(p.mt, cl);
  if ((long long)p.mg * p.nt != (long long)dp + tail ||
      (long long)tail * splits * cl > 65535)
    return -1;
  p.units = dp + tail * splits;
  if (blocks < cl || blocks % cl || blocks / cl > p.units) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wy = static_cast<float*>(ws_y);
  float* wa = static_cast<float*>(ws_xa);
  if (r <= 16) return launch<16>(x, w, a, b, y, wy, wa, p, blocks, s);
  if (r <= 32) return launch<32>(x, w, a, b, y, wy, wa, p, blocks, s);
  return launch<64>(x, w, a, b, y, wy, wa, p, blocks, s);
}

// The clusters of two CTAs of the kernel that the card holds at once (the
// persistent grid's pairs; 0 on an error).
extern "C" int lora_matmul_ws_max_pairs() {
  auto kernel = lora_matmul_ws_kernel<MAX_R>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Cfg<MAX_R>::BYTES) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Cfg<MAX_R>::BYTES;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n
                                                                         : 0;
}
