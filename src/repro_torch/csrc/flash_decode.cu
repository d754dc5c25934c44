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

// bf16 (tensor cores): slots of a warp tile, whatever D and G
constexpr int MMA_TS = 32;

// one tile buffer of a warp, K and V, in bytes
template <typename T, int D, int GM>
__host__ __device__ constexpr int tile_bytes() {
  return std::is_same<T, __nv_bfloat16>::value
             ? 2 * MMA_TS * (2 * D + 16)
             : 2 * tile_steps<GM>() * 32 * 16;
}

// slots of a warp tile
template <typename T, int D, int GM>
__host__ __device__ constexpr int tile_slots() {
  return std::is_same<T, __nv_bfloat16>::value
             ? MMA_TS
             : (32 / (D / (16 / (int)sizeof(T)))) * tile_steps<GM>();
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

// tile buffers a warp needs: two when its piece takes more than one round
// of tiles (the next tile's copies then go out while one is used), else one
template <typename T, int D, int GM>
__host__ __device__ inline int tile_buffers(int len, int nsplit) {
  return ceil_div(len, nsplit) > NW * tile_slots<T, D, GM>() ? 2 : 1;
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

// GM = most queries per group this instantiation holds.
template <typename T, int D, int GM>
__global__ void __launch_bounds__(NT)
flash_decode_split_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                          const T* __restrict__ V, T* __restrict__ O, int Hkv,
                          int G, int slots, int t, int window, Strides qs,
                          Strides ks, Strides vs, float scale_log2) {
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
  const bool ring = window > 0 && window <= slots;

  // the run of slots t can see, cut into nsplit contiguous pieces
  const Run run = valid_run(t, slots, window);
  const int chunk = ceil_div(run.len, nsplit);
  const int j0 = run.lo + split * chunk;
  const int j1 = min(j0 + chunk, run.lo + run.len);
  // this warp's tile buffers in the dynamic shared memory
  const int nbuf = tile_buffers<T, D, GM>(run.len, nsplit);
  constexpr int BUF = tile_bytes<T, D, GM>();
  auto valid = [&](int j) {
    return j < j1 && (!ring || slot_valid(j, t, slots, window, true));
  };

  if constexpr (MMA) {
    // bf16: both products on the tensor cores (mma.sync m16n8k16), the
    // queries as the 16-row operand (rows G..15 zero), a warp tile of 32
    // slots staged with a padded pitch so that ldmatrix reads it without
    // bank conflicts. S = q K^T: B = K rows as they lie (slot-major), 4
    // n-tiles of 8 slots x D/16 k-steps. O += P V: P from S's accumulator
    // registers, split into a bf16 high and low part (two products, so P
    // keeps about 16 bits, as the f32 plain version does), B = V through
    // ldmatrix.trans. A thread holds one query (lane / 4) and two slots or
    // two dims of each 8-wide tile.
    constexpr int PITCH = 2 * D + 16;    // bytes a staged row
    constexpr int CH = D / 8;            // 16-byte chunks a row
    constexpr int KSTEPS = D / 16;
    const int g = lane / 4, c = lane % 4;
    extern __shared__ uint4 kv_smem[];
    const uint32_t tiles = repro::sm90::smem_u32(kv_smem) +
                           warp * nbuf * BUF;   // [buf][K|V][slot]
    const T* kb = K + b * ks.b + h * ks.h;
    const T* vb = V + b * vs.b + h * vs.h;
    // masked rows are zero-filled, not read
    auto copy_tile = [&](int jt, int buf) {
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int i = lane + 32 * u, slot = i / CH, ch = i % CH;
        const int j = jt + slot;
        const bool ok = valid(j);
        const uint32_t dst = tiles + buf * BUF + slot * PITCH + ch * 16;
        repro::sm90::cp_async16(dst, ok ? kb + j * ks.s + ch * 8 : kb, ok);
        repro::sm90::cp_async16(dst + MMA_TS * PITCH,
                                ok ? vb + j * vs.s + ch * 8 : vb, ok);
      }
      repro::sm90::cp_async_commit();
    };
    int jt = j0 + warp * MMA_TS;
    if (jt < j1) copy_tile(jt, 0);       // warp-uniform
    // q as the A operand: rows lane / 4 < G, dims 2c, 2c+1 (+8) of a k-step
    uint32_t qa[KSTEPS][2];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int d = 16 * kk + 8 * hh + 2 * c;
        const T* qp = Q + b * qs.b + h * qs.h + g * qs.s + d;
        qa[kk][hh] = g < G ? pack2(qp[0], qp[1]) : 0u;
      }
    float m = NEG_INF, l = 0.f;
    float o[CH][4];
#pragma unroll
    for (int dn = 0; dn < CH; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;

    for (int buf = 0; jt < j1; jt += NW * MMA_TS, buf ^= 1) {
      if (jt + NW * MMA_TS < j1) copy_tile(jt + NW * MMA_TS, buf ^ 1);
      else repro::sm90::cp_async_commit();
      repro::sm90::cp_async_wait<1>();
      __syncwarp();                      // the lanes' copies, for ldmatrix
      const uint32_t kt = tiles + buf * BUF;
      const uint32_t vt = kt + MMA_TS * PITCH;
      // S (16 x 32): 4 n-tiles of 8 slots; this thread: query g, slots
      // 8 nt + 2c, 2c + 1
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
          const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
          mma_16816(sc[nt], a, bk);
        }
      }
      float mt = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = valid(jt + 8 * nt + 2 * c + e)
                              ? sc[nt][e] * scale_log2 : NEG_INF;
          sc[nt][e] = x;
          mt = fmaxf(mt, x);
        }
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
      const float m_new = fmaxf(m, mt);
      const float alpha = exp2f(m - m_new);
      m = m_new;
      l *= alpha;
#pragma unroll
      for (int dn = 0; dn < CH; ++dn) {
        o[dn][0] *= alpha;
        o[dn][1] *= alpha;
      }
      // P as the A operand of two k-steps of 16 slots, high and low parts
      uint32_t ph[2][2], pl[2][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = sc[nt][e] > 0.5f * NEG_INF ? exp2f(sc[nt][e] - m) : 0.f;
          l += p[e];
        }
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p[0], p[1]);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(p[0] - hf.x, p[1] - hf.y);
        ph[nt / 2][nt % 2] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[nt / 2][nt % 2] = *reinterpret_cast<const uint32_t*>(&lo);
      }
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) {
        const uint32_t ah[4] = {ph[kq][0], 0u, ph[kq][1], 0u};
        const uint32_t al[4] = {pl[kq][0], 0u, pl[kq][1], 0u};
#pragma unroll
        for (int dn = 0; dn < CH; ++dn) {
          uint32_t bv[2];
          ldsm_x2_trans(bv, vt + (16 * kq + (lane & 15)) * PITCH + dn * 16);
          mma_16816(o[dn], ah, bv);
          mma_16816(o[dn], al, bv);
        }
      }
      __syncwarp();                      // done with buf before it refills
    }
    // l over the four lanes of a query; o: each (query, dim) in one lane
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    if (g < G) {
      if (c == 0) {
        sm_m[warp][g] = m;
        sm_l[warp][g] = l;
      }
#pragma unroll
      for (int dn = 0; dn < CH; ++dn) {
        sm_acc[warp][g][8 * dn + 2 * c] = o[dn][0];
        sm_acc[warp][g][8 * dn + 2 * c + 1] = o[dn][1];
      }
    }
  } else {
    // f32 on the CUDA cores: a row of K or V is LPR lanes of VE values
    constexpr int VE = 4;                // values per 16-byte copy
    constexpr int LPR = D / VE;          // lanes per row
    constexpr int RPW = 32 / LPR;        // rows per warp copy
    constexpr int STEPS = tile_steps<GM>();
    constexpr int TS = RPW * STEPS;      // slots per warp tile
    static_assert(LPR >= 4 && LPR <= 32 && 32 % LPR == 0, "head dim");
    const int rg = lane / LPR;           // row of the warp copy
    const int li = lane % LPR;           // 16-byte slice of the row
    float m[GM], l[GM], acc[GM][VE];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[g][e] = 0.f;
    }

    // The warp's two tile buffers, (K, V) x STEPS x 32 lanes of 16 bytes. A
    // lane copies its own 16-byte slices and reads only those back, so a
    // wait on its own copies is all the synchronisation there is.
    extern __shared__ uint4 kv_smem[];
    const uint32_t tiles = repro::sm90::smem_u32(kv_smem) + warp * nbuf * BUF;
    const uint4* my = kv_smem + warp * nbuf * BUF / 16 + lane;
    const T* kp = K + b * ks.b + h * ks.h + li * VE;
    const T* vp = V + b * vs.b + h * vs.h + li * VE;
    // masked rows are zero-filled, not read
    auto copy_tile = [&](int jt, int buf) {
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const int j = jt + st * RPW + rg;
        const bool ok = valid(j);
        const uint32_t dst =
            tiles + (((buf * 2) * STEPS + st) * 32 + lane) * 16;
        repro::sm90::cp_async16(dst, ok ? kp + j * ks.s : kp, ok);
        repro::sm90::cp_async16(dst + STEPS * 32 * 16, ok ? vp + j * vs.s : vp,
                                ok);
      }
      repro::sm90::cp_async_commit();
    };

    int jt = j0 + warp * TS;
    if (jt < j1) copy_tile(jt, 0);       // warp-uniform
    // q, once the first tile's copies are in flight
    float qr[GM][VE];
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < VE; ++e)
        qr[g][e] = g < G ? to_f32<T>(Q[b * qs.b + h * qs.h + g * qs.s +
                                       li * VE + e]) * scale_log2
                         : 0.f;

    for (int buf = 0; jt < j1; jt += NW * TS, buf ^= 1) {
      // the next tile's copies go out before this one is used
      if (jt + NW * TS < j1) copy_tile(jt + NW * TS, buf ^ 1);
      else repro::sm90::cp_async_commit();
      repro::sm90::cp_async_wait<1>();
      const uint4* kt = my + (buf * 2) * STEPS * 32;
      const uint4* vt = kt + STEPS * 32;
      // scores of the tile (log2 domain), reduced over the row's lanes
      float s[STEPS][GM];
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const bool ok = valid(jt + st * RPW + rg);
        float kf[VE];
        unpack(kt[st * 32], kf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < VE; ++e) x = fmaf(qr[g][e], kf[e], x);
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
        for (int e = 0; e < VE; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        float vf[VE];
        unpack(vt[st * 32], vf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float p = s[st][g] > 0.5f * NEG_INF ? exp2f(s[st][g] - m[g])
                                                    : 0.f;
          l[g] += p;
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }

    // the warp's rows: sum l and acc over the row groups (m is warp-uniform)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1) {
        l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
        for (int e = 0; e < VE; ++e)
          acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
      }
      if (g < G && rg == 0) {
        if (li == 0) {
          sm_m[warp][g] = m[g];
          sm_l[warp][g] = l[g];
        }
#pragma unroll
        for (int e = 0; e < VE; ++e) sm_acc[warp][g][li * VE + e] = acc[g][e];
      }
    }
  }
  __syncthreads();

  // merge the four warps: the output itself (one piece) or this piece's
  // (m, l, acc), left in shared memory for block 0 of the cluster
  for (int idx = threadIdx.x; idx < G * D; idx += NT) {
    const int g = idx / D, d = idx % D;
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
      O[((long long)bh * G + g) * D + d] = from_f32<T>(a / fmaxf(ll, 1e-20f));
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
  // c_s = 2^(m_s - max_s m_s); the output is (B, Hkv, G, D), contiguous.
  // The remote reads of a step are independent, so they overlap: a loop
  // that waited on one read of distributed shared memory per piece would
  // put nsplit round trips in series
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                      // every piece is in shared memory
  if (split == 0) {                    // uniform over the block
    // each piece's m and l, one remote read each, all in flight together;
    // then its weight c_s / max(sum_s c_s l_s, 1e-20) per query
    __shared__ float w_m[MAX_SPLITS][GM];
    __shared__ float w_l[MAX_SPLITS][GM];
    for (int i = threadIdx.x; i < nsplit * G; i += NT) {
      const int sp = i / G, g = i % G;
      w_m[sp][g] = cluster.map_shared_rank(&blk_m[0], sp)[g];
      w_l[sp][g] = cluster.map_shared_rank(&blk_l[0], sp)[g];
    }
    __syncthreads();
    if (threadIdx.x < G) {
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
    for (int idx = threadIdx.x; idx < G * D; idx += NT) {
      const int g = idx / D, d = idx % D;
      float a = 0.f;
#pragma unroll
      for (int sp = 0; sp < MAX_SPLITS; ++sp)
        if (sp < nsplit)
          a = fmaf(w_m[sp][g],
                   cluster.map_shared_rank(&blk_acc[0][0], sp)[g * D + d], a);
      O[((long long)bh * G + g) * D + d] = from_f32<T>(a);
    }
  }
  cluster.sync();                      // keep the pieces alive until read
}

template <typename T, int D, int GM>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hkv, int G, int S, int t, int window, int nsplit,
                   Strides qs, Strides ks, Strides vs, cudaStream_t stream) {
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  auto kernel = flash_decode_split_kernel<T, D, GM>;
  constexpr int BUF = tile_bytes<T, D, GM>();
  const int smem =
      NW * BUF * tile_buffers<T, D, GM>(valid_run(t, S, window).len, nsplit);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * NW * BUF);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv, nsplit);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;        // the pieces of one (bh)
  attr[0].val.clusterDim.y = nsplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      Hkv, G, S, t, window, qs, ks, vs, scale_log2);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(const void* q, const void* k, const void* v, void* o,
                       int B, int Hkv, int G, int S, int t,
                       int window, int nsplit, Strides qs,
                       Strides ks, Strides vs, cudaStream_t stream) {
  if (G > 8) return cudaErrorInvalidValue;
  // bf16: one m16 tile holds every group size
  if (std::is_same<T, __nv_bfloat16>::value)
    return launch<T, D, 8>(q, k, v, o, B, Hkv, G, S, t, window, nsplit, qs, ks, vs, stream);
  if (G <= 2)
    return launch<T, D, 2>(q, k, v, o, B, Hkv, G, S, t, window, nsplit, qs, ks, vs, stream);
  if (G <= 4)
    return launch<T, D, 4>(q, k, v, o, B, Hkv, G, S, t, window, nsplit, qs, ks, vs, stream);
  if (G <= 8)
    return launch<T, D, 8>(q, k, v, o, B, Hkv, G, S, t, window, nsplit, qs, ks, vs, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int Hkv, int G, int S,
                       int t, int window, int nsplit,
                       Strides qs, Strides ks, Strides vs,
                       cudaStream_t stream) {
  switch (D) {
    case 16:
      return dispatch_g<T, 16>(q, k, v, o, B, Hkv, G, S, t, window, nsplit, qs, ks, vs, stream);
    case 32:
      return dispatch_g<T, 32>(q, k, v, o, B, Hkv, G, S, t, window, nsplit, qs, ks, vs, stream);
    case 64:
      return dispatch_g<T, 64>(q, k, v, o, B, Hkv, G, S, t, window, nsplit, qs, ks, vs, stream);
    case 128:
      return dispatch_g<T, 128>(q, k, v, o, B, Hkv, G, S, t, window, nsplit, qs, ks, vs, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// every K and V row starts on a 16-byte boundary
bool rows_aligned(const void* p, Strides st, int es) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (st.b * es) % 16 == 0 &&
         (st.h * es) % 16 == 0 && (st.s * es) % 16 == 0;
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues the kernel (one launch;
// grid (B * Hkv, nsplit), clusters of the nsplit pieces of one (b, h)) on
// the given stream, does not synchronise, allocates nothing, returns the
// cudaError_t of the launch (0 on success); -1: arguments the kernel does
// not take. Logical shapes: q (B, Hkv, G, D), k and v (B, Hkv, S, D), each
// addressed through its (batch, head, row) strides in elements with the
// last dim contiguous, every row of k and v 16-byte aligned; o
// (B, Hkv, G, D) contiguous; t is the position of the query token; nsplit
// in 1..8. Head dims 16, 32, 64, 128; G <= 8.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, void* o, int B,
    int Hkv, int G, int S, int D, long long q_b, long long q_h, long long q_g,
    long long k_b, long long k_h, long long k_s, long long v_b, long long v_h,
    long long v_s, int t, int window, int nsplit,
    int is_bf16, void* stream) {
  const int es = is_bf16 ? 2 : 4;
  const Strides qs{q_b, q_h, q_g}, ks{k_b, k_h, k_s}, vs{v_b, v_h, v_s};
  if (B < 1 || Hkv < 1 || G < 1 || S < 1 || nsplit < 1 ||
      nsplit > MAX_SPLITS || window < 0 || !rows_aligned(k, ks, es) ||
      !rows_aligned(v, vs, es))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Hkv, G, S, t,
                                          window, nsplit, qs, ks, vs, s)
              : dispatch_d<float>(D, q, k, v, o, B, Hkv, G, S, t, window,
                                  nsplit, qs, ks, vs, s));
}
