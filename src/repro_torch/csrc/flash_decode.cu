// Flash decode (one query token per kv-head group over a KV cache; online
// softmax; linear or ring-buffer masking by a scalar position t) for Hopper
// (sm_90a), written by hand. It takes the place of the Pallas TPU kernel of
// src/repro/kernels/flash_decode.py (flash_decode).
//
// The TPU kernel gives one grid row to each (batch, kv head) and walks the
// cache blocks along its sequential grid axis with (m, l, acc) in scratch.
// Here that axis is split over blocks as well: at the serving cache of
// llama32-1b (8 sequences x 8 kv heads) one block per (batch, kv head) would
// fill 64 of the card's 132 SMs. Block (bh, split) owns a contiguous piece of
// the run of slots that t can see; the wrapper takes the number of pieces
// from the length of that run (no piece shorter than 64 slots or than what
// the block's four warps take in one round of tiles, and at most 8 pieces),
// so a short run is one piece. The pieces of one (bh) are one thread-block
// cluster: each block leaves its (m, l, acc) in its own shared memory, and
// after a cluster barrier block 0 of the cluster reads the others' through
// distributed shared memory and writes the output. So a call is one
// launch, with no scratch in device memory and nothing that outlives the
// call: every piece is weighted by 2^(m_piece - m_all), so a piece that saw
// no valid slot (m = -1e30, l = 0, acc = 0) adds exactly zero.
//
// Bound on this card: bytes. Each valid K and V row is read once and the G
// queries of a group share it: 4 G D operations per 4 D bytes (bf16), G per
// byte (4 for llama32-1b), far below the ~295 at which the tensor cores
// become the limit. What counts is that the copies are wide, many and early,
// and that little work sits between a tile's arrival and the next:
//
//   * every K and V row is copied with 16-byte cp.async into shared memory:
//     a warp takes a tile of slots (32 at D = 64 bf16) and puts every copy
//     of it in flight before it uses any (8 KB a warp, 32 KB a block); the
//     first tile's copies go out before q is read, so the two latencies
//     overlap; where a warp has more than one tile, a second buffer takes
//     the next tile's copies while one is used. Prefetching the tile into
//     registers was measured first: the bf16 instantiation needed all 255
//     registers and spilled, and took 17.3 us at the serving cache, t = 511
//     (H100 80GB HBM3, 700 W; chip_smoke.py);
//   * one max and one rescale per tile and query, not one per slot, in the
//     exp2 domain (log2(e)/sqrt(D) folded into the score);
//   * bf16: the products on the tensor cores after all (mma.sync m16n8k16).
//     With the copies fixed, the work between them bound the kernel: on the
//     CUDA cores a 32-slot tile takes about 1,200 instructions a warp
//     (scores reduced over lanes by shuffles, bf16 unpacking, the weighted
//     sum), on mma.sync about 200 (PERF.md has the times). The queries are the
//     16-row operand (rows G..15 zero), K and V are read from the staged
//     tile by ldmatrix, and P keeps f32 accuracy as a bf16 high part plus a
//     bf16 low part (two products), so the kernel rounds where the f32 plain
//     version rounds, not where the TPU kernel rounds P to bf16;
//   * f32: the CUDA cores (the tensor cores would round the inputs to TF32).
//     A row is D / 4 lanes, its partial dot products are reduced over those
//     lanes only, for all G queries of the group.
//
// Masking follows the TPU kernel: a ring buffer iff 0 < window <= slots, where
// slot j holds absolute position t - ((t - j) mod slots), valid iff that is
// >= 0 and > t - window; otherwise a linear cache, valid iff j <= t (and
// j > t - window when window > 0). Slots that are masked are not read at all
// (the TPU kernel reads them and scores them -1e30); for a linear cache the
// pieces cover only the run [max(0, t - window + 1), min(t, slots - 1)], so
// the bytes read follow t; for a ring buffer the run is every slot. l is
// clamped at 1e-20 before the division, so a query with no valid slot (t past
// the end of a linear cache and its window) gives zeros. Scores, softmax and
// the weighted sum are f32 for f32 and bf16 caches alike.
//
// Every shape the TPU kernel takes, up to head dim 256:
//
//   * head dims: the kernel is compiled for a few padded widths (bf16 16,
//     32, 64, 112, 128, 256; f32 16, 32, 64, 128, 256) and takes the row
//     length d <= that width at run time; the copies of a row's 16-byte
//     chunks past d are zero-filled (no source bytes), q's dims past d are
//     zeros, and only the first d dims of the output are written. d is a
//     whole number of 16-byte chunks (the wrapper pads a row that is not
//     with zero columns); the scale 1/sqrt of the true head dim comes from
//     the wrapper;
//   * any number G of queries a group: bf16 takes 16 queries into the two
//     halves of one m16 tile (8 where the head dim is above 128: the
//     merge's shared memory), f32 up to 8; a larger group is cut into
//     chunks of that many along the grid's z axis, each of which reads its
//     piece of K and V (from L2 after the first);
//   * t as a Python int or as one int32 or int64 on the card (t_dev): the
//     kernel reads t through the pointer (no cast kernel before it), and
//     the wrapper sizes the split from the cache length rather than from
//     t, so nothing is read back.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using repro::ceil_div;
using repro::from_f32;
using repro::to_f32;

constexpr int NW = 4;                  // warps per block
constexpr int MAX_SPLITS = 8;          // blocks of a cluster (portable size)
constexpr int NT = 32 * NW;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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

// 16 bytes of an f32 cache as four values
__device__ __forceinline__ void unpack(const uint4& v, float (&out)[4]) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}

// f32: loads of a warp tile, fewer for the largest groups, whose scores
// and accumulators take more registers
template <int GM>
__host__ __device__ constexpr int tile_steps() { return GM <= 4 ? 8 : 4; }

// f32: lanes that hold one row of the padded width D (16-byte chunks of
// four values, at most a warp), and chunks each of them holds
template <int D>
__host__ __device__ constexpr int f32_lpr() { return D / 4 < 32 ? D / 4 : 32; }
template <int D>
__host__ __device__ constexpr int f32_cpl() { return D / 4 / f32_lpr<D>(); }

// bf16 (tensor cores): slots of a warp tile, whatever D and G
constexpr int MMA_TS = 32;

// one tile buffer of a warp, K and V, in bytes
template <typename T, int D, int GM>
__host__ __device__ constexpr int tile_bytes() {
  return std::is_same<T, __nv_bfloat16>::value
             ? 2 * MMA_TS * (2 * D + 16)
             : 2 * tile_steps<GM>() * 32 * 16 * f32_cpl<D>();
}

// slots of a warp tile
template <typename T, int D, int GM>
__host__ __device__ constexpr int tile_slots() {
  return std::is_same<T, __nv_bfloat16>::value
             ? MMA_TS
             : (32 / f32_lpr<D>()) * tile_steps<GM>();
}

// tile buffers a warp may hold: two, unless two would pass 160 KB a block
// (bf16 at D = 256)
template <typename T, int D, int GM>
__host__ __device__ constexpr int max_buffers() {
  return 2 * NW * tile_bytes<T, D, GM>() <= 160 * 1024 ? 2 : 1;
}

// the run of slots position t can see: [lo, lo + len)
struct Run {
  int lo, len;
};
__host__ __device__ inline Run valid_run(int t, int slots, int window) {
  if (window > 0 && window <= slots) return {0, slots};   // a ring buffer
  const int lo = window > 0 && t - window + 1 > 0 ? t - window + 1 : 0;
  const int hi = t < slots - 1 ? t : slots - 1;
  return {lo, hi >= lo ? hi - lo + 1 : 0};
}

// tile buffers a warp uses: two when its piece of a run of `len` slots
// takes more than one round of tiles (the next tile's copies then go out
// while one is used) and two fit, else one
template <typename T, int D, int GM>
__host__ __device__ inline int tile_buffers(int len, int nsplit) {
  return ceil_div(len, nsplit) > NW * tile_slots<T, D, GM>()
             ? max_buffers<T, D, GM>() : 1;
}

// two bf16 of the cache as the b32 an mma operand register holds
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// two 8x8 b16 matrices from shared memory (rows addressed by lanes 0-15),
// as mma fragments; .trans: each matrix transposed on the way
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D = the padded head dim this instantiation holds, dt <= D the row length
// at run time; GM = most queries of a group a block holds (the block takes
// queries g0 = GM * blockIdx.z onwards); nbuf = tile buffers a warp uses
// (the launch sized the dynamic shared memory for them).
template <typename T, int D, int GM>
__global__ void __launch_bounds__(NT)
flash_decode_split_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                          const T* __restrict__ V, T* __restrict__ O, int Hkv,
                          int G, int slots, int t_arg,
                          const void* __restrict__ t_dev, int t_is64,
                          int window, int dt,
                          int nbuf, Strides qs, Strides ks, Strides vs,
                          float scale_log2) {
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  __shared__ float sm_m[NW][GM];
  __shared__ float sm_l[NW][GM];
  __shared__ float sm_acc[NW][GM][D];
  __shared__ float blk_m[GM];          // the block's piece, read by block 0
  __shared__ float blk_l[GM];          // of the cluster
  __shared__ float blk_acc[GM][D];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int g0 = GM * blockIdx.z;      // this block's queries of the group
  const int Gc = min(GM, G - g0);
  const int t = !t_dev ? t_arg
                 : t_is64 ? static_cast<int>(*static_cast<const long long*>(t_dev))
                          : *static_cast<const int*>(t_dev);
  const bool ring = window > 0 && window <= slots;
  const T* qb = Q + b * qs.b + h * qs.h + g0 * qs.s;

  // the run of slots t can see, cut into nsplit contiguous pieces
  const Run run = valid_run(t, slots, window);
  const int chunk = ceil_div(run.len, nsplit);
  const int j0 = run.lo + split * chunk;
  const int j1 = min(j0 + chunk, run.lo + run.len);
  constexpr int BUF = tile_bytes<T, D, GM>();
  // one buffer a warp (bf16 at D = 256): the next tile's copies wait until
  // this one is used; else two, and nbuf == 1 only when the piece takes one
  // round of tiles, so the prefetch below never fires
  constexpr bool ONE_BUF = max_buffers<T, D, GM>() == 1;
  auto valid = [&](int j) {
    return j < j1 && (!ring || slot_valid(j, t, slots, window, true));
  };

  if constexpr (MMA) {
    // bf16: both products on the tensor cores (mma.sync m16n8k16), the
    // queries as the 16-row operand (rows g and g + 8 of a thread: queries
    // g and, where GM = 16, g + 8; the others zero), a warp tile of 32
    // slots staged with a padded pitch so that ldmatrix reads it without
    // bank conflicts. S = q K^T: B = K rows as they lie (slot-major), 4
    // n-tiles of 8 slots x D/16 k-steps. O += P V: P from S's accumulator
    // registers, split into a bf16 high and low part (two products, so P
    // keeps about 16 bits, as the f32 plain version does), B = V through
    // ldmatrix.trans. A thread holds two slots or two dims of each 8-wide
    // tile of its rows.
    constexpr int RH = GM / 8;           // row halves of the m16 tile in use
    constexpr int PITCH = 2 * D + 16;    // bytes a staged row
    constexpr int CH = D / 8;            // 16-byte chunks a row
    constexpr int KSTEPS = D / 16;
    static_assert(RH == 1 || RH == 2, "one m16 tile");
    const int g = lane / 4, c = lane % 4;
    extern __shared__ uint4 kv_smem[];
    const uint32_t tiles = repro::sm90::smem_u32(kv_smem) +
                           warp * nbuf * BUF;   // [buf][K|V][slot]
    const T* kb = K + b * ks.b + h * ks.h;
    const T* vb = V + b * vs.b + h * vs.h;
    // masked rows and the chunks past dt are zero-filled, not read
    auto copy_tile = [&](int jt, int buf) {
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int i = lane + 32 * u, slot = i / CH, ch = i % CH;
        const int j = jt + slot;
        const bool ok = valid(j) && 8 * ch < dt;
        const uint32_t dst = tiles + buf * BUF + slot * PITCH + ch * 16;
        repro::sm90::cp_async16(dst, ok ? kb + j * ks.s + ch * 8 : kb, ok);
        repro::sm90::cp_async16(dst + MMA_TS * PITCH,
                                ok ? vb + j * vs.s + ch * 8 : vb, ok);
      }
      repro::sm90::cp_async_commit();
    };
    int jt = j0 + warp * MMA_TS;
    if (jt < j1) copy_tile(jt, 0);       // warp-uniform
    // q as the A operand: [k half][row half]: query g + 8 rh, dims
    // 16 kk + 8 hh + 2c, + 1
    uint32_t qa[KSTEPS][2][RH];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int rh = 0; rh < RH; ++rh) {
          const int d = 16 * kk + 8 * hh + 2 * c, gq = g + 8 * rh;
          const T* qp = qb + gq * qs.s + d;
          qa[kk][hh][rh] = gq < Gc && d < dt ? pack2(qp[0], qp[1]) : 0u;
        }
    float m[RH], l[RH];
#pragma unroll
    for (int rh = 0; rh < RH; ++rh) {
      m[rh] = NEG_INF;
      l[rh] = 0.f;
    }
    float o[CH][4];
#pragma unroll
    for (int dn = 0; dn < CH; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;

    for (int buf = 0; jt < j1; jt += NW * MMA_TS) {
      const int next = jt + NW * MMA_TS;
      if constexpr (ONE_BUF) {
        repro::sm90::cp_async_wait<0>();
      } else {                           // the next tile's copies go out first
        if (next < j1) copy_tile(next, buf ^ 1);
        else repro::sm90::cp_async_commit();
        repro::sm90::cp_async_wait<1>();
      }
      __syncwarp();                      // the lanes' copies, for ldmatrix
      const uint32_t kt = tiles + buf * BUF;
      const uint32_t vt = kt + MMA_TS * PITCH;
      // S (16 x 32): 4 n-tiles of 8 slots; this thread: rows g (e 0, 1)
      // and g + 8 (e 2, 3), slots 8 nt + 2c, 2c + 1
      float sc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t bk[2];
          ldsm_x2(bk, kt + (8 * nt + (lane & 7)) * PITCH +
                          (2 * kk + ((lane >> 3) & 1)) * 16);
          const uint32_t a[4] = {qa[kk][0][0], RH > 1 ? qa[kk][0][RH - 1] : 0u,
                                 qa[kk][1][0], RH > 1 ? qa[kk][1][RH - 1] : 0u};
          mma_16816(sc[nt], a, bk);
        }
      }
      float mt[RH];
#pragma unroll
      for (int rh = 0; rh < RH; ++rh) mt[rh] = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2 * RH; ++e) {
          const float x = valid(jt + 8 * nt + 2 * c + (e & 1))
                              ? sc[nt][e] * scale_log2 : NEG_INF;
          sc[nt][e] = x;
          mt[e >> 1] = fmaxf(mt[e >> 1], x);
        }
      float alpha[RH];
#pragma unroll
      for (int rh = 0; rh < RH; ++rh) {
        mt[rh] = fmaxf(mt[rh], __shfl_xor_sync(FULL, mt[rh], 1));
        mt[rh] = fmaxf(mt[rh], __shfl_xor_sync(FULL, mt[rh], 2));
        const float m_new = fmaxf(m[rh], mt[rh]);
        alpha[rh] = exp2f(m[rh] - m_new);
        m[rh] = m_new;
        l[rh] *= alpha[rh];
      }
#pragma unroll
      for (int dn = 0; dn < CH; ++dn)
#pragma unroll
        for (int e = 0; e < 2 * RH; ++e) o[dn][e] *= alpha[e >> 1];
      // P as the A operand of two k-steps of 16 slots, high and low parts:
      // [n-tile][row half]
      uint32_t ph[4][2], pl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          if (rh >= RH) {
            ph[nt][rh] = pl[nt][rh] = 0u;
            continue;
          }
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = sc[nt][2 * rh + e];
            p[e] = x > 0.5f * NEG_INF ? exp2f(x - m[rh]) : 0.f;
            l[rh] += p[e];
          }
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p[0], p[1]);
          const float2 hf = __bfloat1622float2(hi);
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(p[0] - hf.x, p[1] - hf.y);
          ph[nt][rh] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[nt][rh] = *reinterpret_cast<const uint32_t*>(&lo);
        }
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) {
        const uint32_t ah[4] = {ph[2 * kq][0], ph[2 * kq][1],
                                ph[2 * kq + 1][0], ph[2 * kq + 1][1]};
        const uint32_t al[4] = {pl[2 * kq][0], pl[2 * kq][1],
                                pl[2 * kq + 1][0], pl[2 * kq + 1][1]};
#pragma unroll
        for (int dn = 0; dn < CH; ++dn) {
          uint32_t bv[2];
          ldsm_x2_trans(bv, vt + (16 * kq + (lane & 15)) * PITCH + dn * 16);
          mma_16816(o[dn], ah, bv);
          mma_16816(o[dn], al, bv);
        }
      }
      __syncwarp();                      // done with buf before it refills
      if constexpr (ONE_BUF) {
        if (next < j1) copy_tile(next, 0);
      } else {
        buf ^= 1;
      }
    }
    // l over the four lanes of a query; o: each (query, dim) in one lane
#pragma unroll
    for (int rh = 0; rh < RH; ++rh) {
      l[rh] += __shfl_xor_sync(FULL, l[rh], 1);
      l[rh] += __shfl_xor_sync(FULL, l[rh], 2);
      const int gq = g + 8 * rh;
      if (gq < Gc) {
        if (c == 0) {
          sm_m[warp][gq] = m[rh];
          sm_l[warp][gq] = l[rh];
        }
#pragma unroll
        for (int dn = 0; dn < CH; ++dn) {
          sm_acc[warp][gq][8 * dn + 2 * c] = o[dn][2 * rh];
          sm_acc[warp][gq][8 * dn + 2 * c + 1] = o[dn][2 * rh + 1];
        }
      }
    }
  } else {
    // f32 on the CUDA cores: a row of K or V is LPR lanes, each holding CPL
    // 16-byte chunks of VE values (chunk li + LPR cc of the row)
    constexpr int VE = 4;                // values per 16-byte copy
    constexpr int LPR = f32_lpr<D>();    // lanes per row
    constexpr int CPL = f32_cpl<D>();    // chunks per lane
    constexpr int RPW = 32 / LPR;        // rows per warp copy
    constexpr int STEPS = tile_steps<GM>();
    constexpr int TS = RPW * STEPS;      // slots per warp tile
    static_assert(LPR >= 4 && LPR <= 32 && 32 % LPR == 0, "head dim");
    const int rg = lane / LPR;           // row of the warp copy
    const int li = lane % LPR;           // first 16-byte chunk of the lane
    float m[GM], l[GM], acc[GM][CPL][VE];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[g][cc][e] = 0.f;
    }

    // The warp's tile buffers, (K, V) x STEPS x CPL x 32 lanes of 16 bytes.
    // A lane copies its own 16-byte slices and reads only those back, so a
    // wait on its own copies is all the synchronisation there is.
    extern __shared__ uint4 kv_smem[];
    const uint32_t tiles = repro::sm90::smem_u32(kv_smem) + warp * nbuf * BUF;
    const uint4* my = kv_smem + warp * nbuf * BUF / 16 + lane;
    const T* kp = K + b * ks.b + h * ks.h;
    const T* vp = V + b * vs.b + h * vs.h;
    // masked rows and the chunks past dt are zero-filled, not read
    auto copy_tile = [&](int jt, int buf) {
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const int j = jt + st * RPW + rg;
        const bool row_ok = valid(j);
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          const int col = (li + LPR * cc) * VE;
          const bool ok = row_ok && col < dt;
          const uint32_t dst =
              tiles + ((((buf * 2) * STEPS + st) * CPL + cc) * 32 + lane) * 16;
          repro::sm90::cp_async16(dst, ok ? kp + j * ks.s + col : kp, ok);
          repro::sm90::cp_async16(dst + STEPS * CPL * 32 * 16,
                                  ok ? vp + j * vs.s + col : vp, ok);
        }
      }
      repro::sm90::cp_async_commit();
    };

    int jt = j0 + warp * TS;
    if (jt < j1) copy_tile(jt, 0);       // warp-uniform
    // q, once the first tile's copies are in flight
    float qr[GM][CPL][VE];
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          const int col = (li + LPR * cc) * VE + e;
          qr[g][cc][e] = g < Gc && col < dt
                             ? to_f32<T>(qb[g * qs.s + col]) * scale_log2
                             : 0.f;
        }

    for (int buf = 0; jt < j1; jt += NW * TS) {
      const int next = jt + NW * TS;
      if constexpr (ONE_BUF) {
        repro::sm90::cp_async_wait<0>();
      } else {                           // the next tile's copies go out first
        if (next < j1) copy_tile(next, buf ^ 1);
        else repro::sm90::cp_async_commit();
        repro::sm90::cp_async_wait<1>();
      }
      const uint4* kt = my + (buf * 2) * STEPS * CPL * 32;
      const uint4* vt = kt + STEPS * CPL * 32;
      // scores of the tile (log2 domain), reduced over the row's lanes
      float s[STEPS][GM];
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const bool ok = valid(jt + st * RPW + rg);
        float kf[CPL][VE];
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) unpack(kt[(st * CPL + cc) * 32], kf[cc]);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float x = 0.f;
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
            for (int e = 0; e < VE; ++e) x = fmaf(qr[g][cc][e], kf[cc][e], x);
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            x += __shfl_xor_sync(FULL, x, off);
          s[st][g] = ok ? x : NEG_INF;
        }
      }
      // one max and one rescale per tile and query
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float mt = s[0][g];
#pragma unroll
        for (int st = 1; st < STEPS; ++st) mt = fmaxf(mt, s[st][g]);
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, off));
        const float m_new = fmaxf(m[g], mt);
        const float alpha = exp2f(m[g] - m_new);
        m[g] = m_new;
        l[g] *= alpha;
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[g][cc][e] *= alpha;
      }
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        float vf[CPL][VE];
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) unpack(vt[(st * CPL + cc) * 32], vf[cc]);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float p = s[st][g] > 0.5f * NEG_INF ? exp2f(s[st][g] - m[g])
                                                    : 0.f;
          l[g] += p;
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
            for (int e = 0; e < VE; ++e)
              acc[g][cc][e] = fmaf(p, vf[cc][e], acc[g][cc][e]);
        }
      }
      if constexpr (ONE_BUF) {
        if (next < j1) copy_tile(next, 0);
      } else {
        buf ^= 1;
      }
    }

    // the warp's rows: sum l and acc over the row groups (m is warp-uniform)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1) {
        l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            acc[g][cc][e] += __shfl_xor_sync(FULL, acc[g][cc][e], off);
      }
      if (g < Gc && rg == 0) {
        if (li == 0) {
          sm_m[warp][g] = m[g];
          sm_l[warp][g] = l[g];
        }
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            sm_acc[warp][g][(li + LPR * cc) * VE + e] = acc[g][cc][e];
      }
    }
  }
  __syncthreads();

  // merge the four warps: the output itself (one piece) or this piece's
  // (m, l, acc), left in shared memory for block 0 of the cluster. The
  // output is (B, Hkv, G, dt), contiguous
  T* ob = O + ((long long)bh * G + g0) * dt;
  for (int idx = threadIdx.x; idx < Gc * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    if (d >= dt) continue;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = exp2f(sm_m[w][g] - mx);
      a = fmaf(c, sm_acc[w][g][d], a);
      ll = fmaf(c, sm_l[w][g], ll);
    }
    if (nsplit == 1) {
      ob[g * dt + d] = from_f32<T>(a / fmaxf(ll, 1e-20f));
      continue;
    }
    blk_acc[g][d] = a;
    if (d == 0) {
      blk_m[g] = mx;
      blk_l[g] = ll;
    }
  }
  if (nsplit == 1) return;             // uniform over the grid

  // block 0 of the cluster merges the pieces:
  // out[g, d] = sum_s c_s acc_s / max(sum_s c_s l_s, 1e-20),
  // c_s = 2^(m_s - max_s m_s). The remote reads of a step are independent,
  // so they overlap: a loop that waited on one read of distributed shared
  // memory per piece would put nsplit round trips in series
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                      // every piece is in shared memory
  if (split == 0) {                    // uniform over the block
    // each piece's m and l, one remote read each, all in flight together;
    // then its weight c_s / max(sum_s c_s l_s, 1e-20) per query
    __shared__ float w_m[MAX_SPLITS][GM];
    __shared__ float w_l[MAX_SPLITS][GM];
    for (int i = threadIdx.x; i < nsplit * Gc; i += NT) {
      const int sp = i / Gc, g = i % Gc;
      w_m[sp][g] = cluster.map_shared_rank(&blk_m[0], sp)[g];
      w_l[sp][g] = cluster.map_shared_rank(&blk_l[0], sp)[g];
    }
    __syncthreads();
    if (threadIdx.x < Gc) {
      const int g = threadIdx.x;
      float mx = NEG_INF, ll = 0.f;
      for (int sp = 0; sp < nsplit; ++sp) mx = fmaxf(mx, w_m[sp][g]);
      for (int sp = 0; sp < nsplit; ++sp) {
        w_m[sp][g] = exp2f(w_m[sp][g] - mx);
        ll = fmaf(w_m[sp][g], w_l[sp][g], ll);
      }
      const float inv = 1.f / fmaxf(ll, 1e-20f);
      for (int sp = 0; sp < nsplit; ++sp) w_m[sp][g] *= inv;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < Gc * D; idx += NT) {
      const int g = idx / D, d = idx % D;
      if (d >= dt) continue;
      float a = 0.f;
#pragma unroll
      for (int sp = 0; sp < MAX_SPLITS; ++sp)
        if (sp < nsplit)
          a = fmaf(w_m[sp][g],
                   cluster.map_shared_rank(&blk_acc[0][0], sp)[g * D + d], a);
      ob[g * dt + d] = from_f32<T>(a);
    }
  }
  cluster.sync();                      // keep the pieces alive until read
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, Hkv, G, S, t;
  const void* t_dev;                   // t on the card, or null
  int t_is64;                          // t_dev's type: int64, else int32
  int window, nsplit, dt;
  float scale_log2;
  Strides qs, ks, vs;
};

template <typename T, int D, int GM>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = flash_decode_split_kernel<T, D, GM>;
  constexpr int BUF = tile_bytes<T, D, GM>();
  // a t on the card is not read here: the buffers are sized for the
  // longest run, every slot
  const int len = a.t_dev ? a.S : valid_run(a.t, a.S, a.window).len;
  const int nbuf = tile_buffers<T, D, GM>(len, a.nsplit);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      max_buffers<T, D, GM>() * NW * BUF);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.Hkv, a.nsplit, ceil_div(a.G, GM));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = nbuf * NW * BUF;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;        // the pieces of one (bh)
  attr[0].val.clusterDim.y = a.nsplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.Hkv, a.G, a.S, a.t,
      a.t_dev, a.t_is64, a.window, a.dt, nbuf, a.qs, a.ks, a.vs,
      a.scale_log2);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// queries a block holds: bf16 16 (8 above D = 128, where 16 would pass the
// 48 KB of static shared memory of the merge), f32 2, 4 or 8
template <typename T, int D>
cudaError_t dispatch_g(const Args& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if constexpr (D > 128) {
      return launch<T, D, 8>(a, stream);
    } else {
      if (a.G <= 8) return launch<T, D, 8>(a, stream);
      return launch<T, D, 16>(a, stream);
    }
  } else {
    if (a.G <= 2) return launch<T, D, 2>(a, stream);
    if (a.G <= 4) return launch<T, D, 4>(a, stream);
    return launch<T, D, 8>(a, stream);
  }
}

// the narrowest padded width that holds the row length dt
template <typename T>
cudaError_t dispatch_d(const Args& a, cudaStream_t stream) {
  const int dt = a.dt;
  if (dt <= 16) return dispatch_g<T, 16>(a, stream);
  if (dt <= 32) return dispatch_g<T, 32>(a, stream);
  if (dt <= 64) return dispatch_g<T, 64>(a, stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (dt <= 112) return dispatch_g<T, 112>(a, stream);
  }
  if (dt <= 128) return dispatch_g<T, 128>(a, stream);
  return dispatch_g<T, 256>(a, stream);
}

// every K and V row starts on a 16-byte boundary
bool rows_aligned(const void* p, Strides st, int es) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (st.b * es) % 16 == 0 &&
         (st.h * es) % 16 == 0 && (st.s * es) % 16 == 0;
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues the kernel (one launch;
// grid (B * Hkv, nsplit, query chunks), clusters of the nsplit pieces of
// one (b, h)) on the given stream, does not synchronise, allocates nothing,
// returns the cudaError_t of the launch (0 on success); -1: arguments the
// kernel does not take. Logical shapes: q (B, Hkv, G, D), k and v
// (B, Hkv, S, D), each addressed through its (batch, head, row) strides in
// elements with the last dim contiguous, every row of k and v 16-byte
// aligned; o (B, Hkv, G, D) contiguous; D (the row length) up to 256 and a
// whole number of 16-byte chunks; any G >= 1; t is the position of the
// query token, read from t_dev (one int32, or int64 where t_is64, on the
// card) where that is not null; scale the softmax's 1/sqrt(head dim);
// nsplit in 1..8.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, void* o, int B,
    int Hkv, int G, int S, int D, long long q_b, long long q_h, long long q_g,
    long long k_b, long long k_h, long long k_s, long long v_b, long long v_h,
    long long v_s, int t, const void* t_dev, int t_is64, int window,
    int nsplit, float scale, int is_bf16, void* stream) {
  const int es = is_bf16 ? 2 : 4;
  const Strides qs{q_b, q_h, q_g}, ks{k_b, k_h, k_s}, vs{v_b, v_h, v_s};
  if (B < 1 || Hkv < 1 || G < 1 || S < 1 || nsplit < 1 ||
      nsplit > MAX_SPLITS || window < 0 || D < 1 || D > 256 ||
      (D * es) % 16 != 0 || !rows_aligned(k, ks, es) ||
      !rows_aligned(v, vs, es))
    return -1;
  const Args a{q, k, v, o, B, Hkv, G, S, t, t_dev, t_is64 ? 1 : 0, window,
               nsplit, D, 1.4426950408889634f * scale, qs, ks, vs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch_d<__nv_bfloat16>(a, s)
                                  : dispatch_d<float>(a, s));
}
