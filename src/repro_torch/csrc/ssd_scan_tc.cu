// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a) on the tensor cores,
// written by hand. It takes the place of the Pallas TPU kernel of
// src/repro/kernels/ssd_scan.py (ssd_intra_chunk). Per (batch, chunk, head),
// with cum = cumsum(a):
//
//   y[i]      = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xt_j     (cl, hp)
//   state     = sum_j exp(cum_last - cum_j) B_j (x) xt_j                (ns, hp)
//   dec[i, 0] = exp(cum_i),  dec[i, 1] = exp(cum_last)
//
// All of it to f32 accuracy. Bound on this card: operations at the f32
// CUDA-core rate (mamba2-370m's width: 2.24 GFLOP against 45 MB); on the
// tensor cores, with three products for each, the operations and the bytes
// bound it about equally. What the design does about it:
//
// - C . B^T depends on (batch, chunk) only. Two launches: the scores kernel
//   computes every 64 x 64 tile S = C_i B_j^T (j tile <= i tile) once and
//   writes it split into tf32 fragments (2 x 16 KB a tile) to a workspace;
//   the heads kernel's block owns one 64-row tile i of one (batch, chunk)
//   for a group of HG heads (kernels/ssd_scan.py::ssd_plan picks HG), takes
//   the S tile of each j tile up to the diagonal into shared memory with
//   one 16-byte copy a fragment, and every head of the group multiplies it
//   by its xt_j. The heads' sums stay in registers (8 warps: 16 rows and
//   half the head dim each).
// - All three products (C B^T, (S o decay) xt, B^T (w o xt)) run on the
//   tensor cores as mma.sync.m16n8k8 with tf32 operands, split three ways
//   for f32 accuracy: x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and
//   d += lo.hi + hi.lo + hi.hi (one tf32 product misses the 1e-4 tolerance
//   by up to 16x). mma.sync, not wgmma: wgmma takes tf32 operands K-major
//   only, and xt (the b operand of both products with it) and B (the a
//   operand of the state product) are MN-major as they lie; mma.sync's
//   fragments are built in shared memory by hand, in any layout. xt is split
//   once per tile into (hi, lo) fragments, read back with one 16-byte load
//   per three products.
// - The decay: within the diagonal tile, the segment form exp(cum_i - cum_j)
//   where j <= i (for j > i the segment may be positive and its exp inf; a
//   select drops it). Off the diagonal, where a <= 0 on the whole chunk,
//   it factorises at ref = cum[i0 - 1], the last row before the tile:
//   exp(cum_i - ref) exp(ref - cum_j), both factors <= 1 for i >= i0 > j;
//   the second scales xt_j as it is split, the first the heads' sums once,
//   before the diagonal tile is added. Where cum rises somewhere every tile
//   takes the segment form.
// - The chunk's cum is a warp scan per head, summed in f64 and kept as an
//   (hi, lo) pair of f32, so that cum_i - cum_j keeps its digits at the end
//   of a steep chunk; rows past cl repeat cum_last, so every exp argument
//   stays finite.
// - Tiles of C, B and xt come in through two-stage rings of 16-byte
//   cp.async copies (zero-filled past the ragged edges).
// - The state is a second tile kind: block (batch, chunk, group, 64 rows of
//   ns) splits each tile of B once for the group's heads and multiplies it
//   by each head's w o xt, w = exp(cum_last - cum_j). The y tiles are dealt
//   longest first.
//
// What holds it back (measured on the H100, PERF.md): a block walks its j
// tiles and heads in steps of one xt tile each, and the steps' copies, the
// split of xt into fragments and the two barriers a step take longer than
// the step's products; the fragments read from shared memory (3 KB a warp
// for 12 products) are the next limit.
//
// Takes cl <= 256, hp <= 128, hp and ns multiples of 4 and 16-byte aligned
// xt, B, C (the wrapper's ssd_intra_chunk_version; other shapes go to the
// SIMT kernel of csrc/ssd_scan.cu).

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
using repro::tf32x3::split;

constexpr int TI = 64;          // rows of a tile (i, j and state rows n)
constexpr int NW = 8;           // warps: rows 16 (w % 4).., column half w / 4
constexpr int NT = NW * 32;
constexpr int KC = 32;          // ns columns of C and B per stage (scores)
constexpr int LDK = KC + 4;     // padded rows: fragment loads conflict-free
constexpr int LDB = TI + 4;     // a raw tile of B for the state: 64 columns
constexpr int MAX_CL = 256;
// a 64 x 64 a operand split into fragments: (row group, k block, lane)
constexpr int SA_SLOTS = 4 * 8 * 32;

constexpr int cmax(int x, int y) { return x > y ? x : y; }

// exp(cum_i - cum_j) from (hi, lo) pairs
__device__ __forceinline__ float decay(float2 ci, float2 cj) {
  return __expf((ci.x - cj.x) + (ci.y - cj.y));
}

// 16-byte copies of a (64 x 4Q) tile of a row-major matrix into shared
// memory (row stride ld floats): global row r0 + row, columns c0 + 4q..;
// rows >= rows_ok or columns >= cols_ok are zero-filled. cols_ok, c0 and
// the row stride are multiples of 4.
template <int Q>
__device__ __forceinline__ void stage_tile(float* dst, int ld,
                                           const float* src, long long stride,
                                           long long r0, long long rows_ok,
                                           int c0, int cols_ok, int tid) {
  for (int c = tid; c < TI * Q; c += NT) {
    const int row = c / Q, q = c % Q;
    const int col = c0 + 4 * q;
    const bool ok = r0 + row < rows_ok && col < cols_ok;
    cp_async16(smem_u32(dst + row * ld + 4 * q),
               ok ? src + (r0 + row) * stride + col : src, ok);
  }
}

// The scores S = C_i . B_j^T of one (batch * chunk, i tile, j tile <= i
// tile), 64 x 64, to f32 accuracy, written as split a fragments (hi, then
// lo, SA_SLOTS float4s each) for the heads' products: block (bc, pair), pair
// = it (it + 1) / 2 + jt. Warps: 16 rows and 32 columns each, ns walked in
// KC-wide chunks of C_i and B_j through a two-stage cp.async ring.
__global__ void __launch_bounds__(NT)
ssd_scores_tc_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                     float4* __restrict__ ws, int cl, int ns, int n_pairs) {
  __shared__ __align__(16) float ring[2][2 * TI * LDK];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, w16 = 16 * rg;
  const int half = warp >> 2;
  const long long bc = blockIdx.x / n_pairs;
  const int pair = blockIdx.x % n_pairs;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= pair) ++it;
  const int jt = pair - it * (it + 1) / 2;
  const long long row0 = bc * cl;
  const int nkc = ceil_div(ns, KC);
  auto load = [&](int kc) {
    float* buf = ring[kc & 1];
    stage_tile<KC / 4>(buf, LDK, Cm, ns, row0 + it * TI, row0 + cl, kc * KC,
                       ns, tid);
    stage_tile<KC / 4>(buf + TI * LDK, LDK, Bm, ns, row0 + jt * TI, row0 + cl,
                       kc * KC, ns, tid);
    cp_async_commit();
  };
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // on the diagonal tile, columns past the warp's last row are j > i
  const int n_max = jt == it ? min(4, max(0, w16 / 8 + 2 - 4 * half)) : 4;
  load(0);
  for (int kc = 0; kc < nkc; ++kc) {
    if (kc + 1 < nkc) {
      load(kc + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Cs = ring[kc & 1];
    const float* Bs = Cs + TI * LDK;
#pragma unroll
    for (int k = 0; k < KC; k += 8) {
      uint32_t ahi[4], alo[4];
      const float* c0 = Cs + (w16 + g) * LDK + k + t;
      split(c0[0], ahi[0], alo[0]);
      split(c0[8 * LDK], ahi[1], alo[1]);
      split(c0[4], ahi[2], alo[2]);
      split(c0[8 * LDK + 4], ahi[3], alo[3]);
      // b operand B_j^T: element (k, n) = B[n][k]
      float4 bq[4];
      const float* b0 = Bs + (32 * half + g) * LDK + k + t;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split(b0[8 * n * LDK], bh0, bl0);
        split(b0[8 * n * LDK + 4], bh1, bl1);
        bq[n] = make_float4(__uint_as_float(bh0), __uint_as_float(bl0),
                            __uint_as_float(bh1), __uint_as_float(bl1));
      }
      mma3<4>(acc, ahi, alo, bq, n_max);
    }
    __syncthreads();                   // the ring stage is reloaded next
  }
  // acc (rows g, g + 8; columns 2t, 2t + 1 of tile 4 half + n) -> the a
  // fragments of k block 4 half + n: (g, t), (g + 8, t), (g, t + 4),
  // (g + 8, t + 4), from lanes 4g + t / 2 and 4g + 2 + t / 2
  float4* out = ws + (bc * n_pairs + pair) * (2 * SA_SLOTS);
  const int src1 = (lane & ~3) | (t >> 1), src2 = src1 + 2;
  const bool odd = t & 1;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float x0 = __shfl_sync(0xffffffffu, acc[n][0], src1);
    const float x1 = __shfl_sync(0xffffffffu, acc[n][1], src1);
    const float x2 = __shfl_sync(0xffffffffu, acc[n][2], src1);
    const float x3 = __shfl_sync(0xffffffffu, acc[n][3], src1);
    const float z0 = __shfl_sync(0xffffffffu, acc[n][0], src2);
    const float z1 = __shfl_sync(0xffffffffu, acc[n][1], src2);
    const float z2 = __shfl_sync(0xffffffffu, acc[n][2], src2);
    const float z3 = __shfl_sync(0xffffffffu, acc[n][3], src2);
    uint32_t hi[4], lo[4];
    split(odd ? x1 : x0, hi[0], lo[0]);
    split(odd ? x3 : x2, hi[1], lo[1]);
    split(odd ? z1 : z0, hi[2], lo[2]);
    split(odd ? z3 : z2, hi[3], lo[3]);
    const int slot = (rg * 8 + 4 * half + n) * 32 + lane;
    out[slot] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                            __uint_as_float(hi[2]), __uint_as_float(hi[3]));
    out[SA_SLOTS + slot] =
        make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                    __uint_as_float(lo[2]), __uint_as_float(lo[3]));
  }
}

template <int HPC>
struct Smem {
  static constexpr int LDX = HPC + 4;   // row of a raw xt tile
  // floats of a ring stage: a tile of B (state) or of xt
  static constexpr int RING = cmax(TI * LDB, TI * LDX);
  // floats: the split a operand (hi, lo), the split xt tile, two ring
  // stages, then per head the rows' scale of xt (hg x clp), cum (hg x clp
  // pairs) and a flag
  static constexpr int FIXED = 8 * SA_SLOTS + 4 * 32 * HPC + 2 * RING;
  static size_t floats(int hg, int clp) { return FIXED + 3 * hg * clp + hg; }
};

// HPC: head-dim columns held per tile (32, 64 or 128), hp <= HPC; HG: heads
// per block, whose accumulators live in registers (HG * HPC <= 128: more
// spills at the 128 registers two blocks of 256 threads an SM allow).
template <int HPC, int HG>
__global__ void __launch_bounds__(NT, 2)
ssd_intra_chunk_tc_kernel(const float* __restrict__ xt,
                          const float* __restrict__ a,
                          const float* __restrict__ Bm,
                          const float4* __restrict__ ws,
                          float* __restrict__ y, float* __restrict__ st,
                          float* __restrict__ dec, int cl, int nh, int hp,
                          int ns, int n_groups, int n_it) {
  using L = Smem<HPC>;
  constexpr int LDX = L::LDX, RING = L::RING;
  constexpr int NX = HPC / 16;    // n tiles of 8 head-dim columns a warp
  constexpr int P0 = HPC / 2;     // head-dim columns of one half
  extern __shared__ float4 smem4[];
  float4* sa_hi = smem4;                          // [SA_SLOTS]
  float4* sa_lo = sa_hi + SA_SLOTS;
  // the split xt tile: float4s (hi, lo of rows t and t + 4) per (k block,
  // t) row of HPC, column p stored at p ^ 2t (conflict-free fragment loads)
  float4* xb = sa_lo + SA_SLOTS;                  // [8 kb][4 t][HPC]
  float* ring = reinterpret_cast<float*>(xb + 32 * HPC);
  float* usc = ring + 2 * RING;                   // [HG][clp]
  const int clp = n_it * TI;      // cl rounded up to whole tiles
  // cum as an f32 pair (hi, lo), summed in f64: cum_i - cum_j loses no
  // digits to cancellation at the end of a steep chunk (|cum| in the
  // hundreds), and costs three f32 adds
  float2* cum = reinterpret_cast<float2*>(usc + HG * clp);   // [HG][clp]
  int* mono = reinterpret_cast<int*>(cum + HG * clp);  // [HG]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, w16 = 16 * rg;   // this warp's 16 rows of a tile
  const int half = warp >> 2;               // and its half of the columns

  // block -> (rank of the tile kind, batch * chunk, head group)
  const int n_bcg = (int)(gridDim.x / (unsigned)(n_it + ceil_div(ns, TI)));
  const int r = blockIdx.x / n_bcg;
  const int rem = blockIdx.x % n_bcg;
  const long long bc = rem / n_groups;
  const int h0 = (rem % n_groups) * HG;
  const int nhg = min(HG, nh - h0);
  const long long row0 = bc * cl;                   // first row of the chunk
  const long long xs = (long long)nh * hp;          // row stride of xt
  const int n_pairs = n_it * (n_it + 1) / 2;        // (i, j <= i) tiles

  // ---- cum per head of the group: a warp scan each; mono: a <= 0 on the
  // whole chunk, so cum never rises and both factors of a factorised
  // decay stay <= 1
  for (int hh = warp; hh < nhg; hh += NW) {
    const int per = clp / 32;                       // 2..8 rows a lane
    double v[MAX_CL / 32];
    double run = 0.0;
    bool down = true;
#pragma unroll
    for (int q = 0; q < MAX_CL / 32; ++q) {
      const int i = lane * per + q;
      if (q < per) {
        const float ai = i < cl ? a[(row0 + i) * nh + h0 + hh] : 0.f;
        down = down && ai <= 0.f;
        run += (double)ai;
        v[q] = run;
      }
    }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    const double base = incl - run;
#pragma unroll
    for (int q = 0; q < MAX_CL / 32; ++q)
      if (q < per) {
        const double c = base + v[q];
        const float hi = (float)c;
        cum[hh * clp + lane * per + q] = make_float2(hi, (float)(c - hi));
      }
    const bool all_down = __all_sync(0xffffffffu, down);
    if (lane == 0) mono[hh] = all_down;
  }
  __syncthreads();

  // the raw xt tile of head h0 + hh, rows jt * 64..: this thread copies
  // the 16 bytes at column 4 (tid % (HPC / 4)) of every (NT / (HPC / 4))-th
  // row
  constexpr int XQ = HPC / 4, XR = NT / XQ;
  auto load_x = [&](float* buf, int hh, int jt) {
    const int q = tid % XQ, r0 = tid / XQ;
    const bool col_ok = 4 * q < hp;
    const float* src =
        xt + (row0 + jt * TI + r0) * xs + (h0 + hh) * (long long)hp + 4 * q;
#pragma unroll
    for (int k = 0; k < TI / XR; ++k) {
      const bool ok = col_ok && jt * TI + r0 + k * XR < cl;
      cp_async16(smem_u32(buf + (r0 + k * XR) * LDX + 4 * q),
                 ok ? src + k * XR * xs : xt, ok);
    }
  };
  // raw xt tile of head hh, rows jt * 64.. scaled by usc, -> split b
  // operand fragments in xb: this thread does column tid % HPC of every
  // (NT / HPC)-th (k block, t) row
  constexpr int SR = NT / HPC;
  auto split_x = [&](const float* raw, int hh, int jt) {
    const float* u = usc + hh * clp + jt * TI;
    const int p = tid % HPC, r0 = tid / HPC;
#pragma unroll
    for (int k = 0; k < 32 / SR; ++k) {
      const int row = r0 + k * SR, t4 = row & 3;
      const int j = 8 * (row >> 2) + t4;
      uint32_t bh0, bl0, bh1, bl1;
      split(raw[j * LDX + p] * u[j], bh0, bl0);
      split(raw[(j + 4) * LDX + p] * u[j + 4], bh1, bl1);
      xb[row * HPC + (p ^ (2 * t4))] =
          make_float4(__uint_as_float(bh0), __uint_as_float(bl0),
                      __uint_as_float(bh1), __uint_as_float(bl1));
    }
  };
  // this thread's b fragments of k block kk, its half's n tiles
  auto load_b = [&](float4 (&bq)[NX], int kk) {
    const float4* b0 = xb + (kk * 4 + t) * HPC + P0 * half + (g ^ (2 * t));
#pragma unroll
    for (int n = 0; n < NX; ++n) bq[n] = b0[8 * n];
  };
  auto load_a = [&](uint32_t (&ahi)[4], uint32_t (&alo)[4], int kk) {
    const float4 h = sa_hi[(rg * 8 + kk) * 32 + lane];
    const float4 l = sa_lo[(rg * 8 + kk) * 32 + lane];
    ahi[0] = __float_as_uint(h.x); ahi[1] = __float_as_uint(h.y);
    ahi[2] = __float_as_uint(h.z); ahi[3] = __float_as_uint(h.w);
    alo[0] = __float_as_uint(l.x); alo[1] = __float_as_uint(l.y);
    alo[2] = __float_as_uint(l.z); alo[3] = __float_as_uint(l.w);
  };

  if (r < n_it) {
    // =================== y rows [i0, i0 + 64) for the group's heads
    const int it = n_it - 1 - r;                    // longest tiles first
    const int i0 = it * TI;
    for (int idx = tid; idx < TI * nhg; idx += NT) {     // dec
      const int row = idx / nhg, hh = idx % nhg;
      if (i0 + row < cl)
        *reinterpret_cast<float2*>(dec + ((row0 + i0 + row) * nh + h0 + hh) * 2) =
            make_float2(expf(cum[hh * clp + i0 + row].x),
                        expf(cum[hh * clp + clp - 1].x));
    }
    // Off the diagonal, with cum never rising (mono), the decay factorises
    // at ref = cum[i0 - 1], the last row before this tile: exp(cum_i - cum_j)
    // = exp(cum_i - ref) exp(ref - cum_j), both factors <= 1 for every
    // i >= i0 > j. The second scales xt_j as it is split, the first the
    // heads' sums once, before the diagonal tile is added (in the segment
    // form, as is every tile where cum rises somewhere).
    for (int idx = tid; idx < nhg * clp; idx += NT) {
      const int hh = idx / clp, j = idx % clp;
      const float2* ch = cum + hh * clp;
      usc[idx] = mono[hh] && j < i0 ? decay(ch[i0 - 1], ch[j]) : 1.f;
    }
    // (the first step synchronises before any of it is read)
    const int n_steps = (it + 1) * nhg;   // one xt tile a (j tile, head)
    auto load = [&](int s) {
      load_x(ring + (s & 1) * RING, s % nhg, s / nhg);
      cp_async_commit();
    };
    auto advance = [&](int s) {          // step s's tile in, s + 1's going
      if (s + 1 < n_steps) {
        load(s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    };
    float yacc[HG][NX][4];
#pragma unroll
    for (int hh = 0; hh < HG; ++hh)
#pragma unroll
      for (int n = 0; n < NX; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[hh][n][e] = 0.f;
    const int ia = i0 + w16 + g, ib = ia + 8;       // this thread's two rows
    load(0);
    int s = 0;
    for (int jt = 0; jt <= it; ++jt) {
      // ---- the scores S = C_i . B_j^T of this (i, j) tile, split into
      // fragments by the scores kernel, shared by the group's heads; the
      // last head's product of the j tile before is done by all
      __syncthreads();
      {
        const float4* src = ws + (bc * n_pairs + it * (it + 1) / 2 + jt) *
                                     (2 * SA_SLOTS);
        for (int q = tid; q < 2 * SA_SLOTS; q += NT)
          cp_async16(smem_u32(sa_hi + q), src + q, true);
        cp_async_commit();
        cp_async_wait<0>();
      }
      // ---- per head: y_i += sum_j S_ij exp(cum_i - cum_j) xt_j
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        if (hh >= nhg) break;
        advance(s);
        const float2* ch = cum + hh * clp;
        split_x(ring + (s & 1) * RING, hh, jt);
        __syncthreads();
        if (jt < it && mono[hh]) {
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            uint32_t ahi[4], alo[4];
            load_a(ahi, alo, kk);
            float4 bq[NX];
            load_b(bq, kk);
            mma3<NX>(yacc[hh], ahi, alo, bq);
          }
        } else {
          if (jt == it && it > 0 && mono[hh]) {
            // the sums of the tiles before times exp(cum_i - ref)
            const float va = decay(ch[ia], ch[i0 - 1]);
            const float vb = decay(ch[ib], ch[i0 - 1]);
#pragma unroll
            for (int n = 0; n < NX; ++n) {
              yacc[hh][n][0] *= va;
              yacc[hh][n][1] *= va;
              yacc[hh][n][2] *= vb;
              yacc[hh][n][3] *= vb;
            }
          }
          // the segment form exp(cum_i - cum_j), only where j <= i (for
          // j > i the segment may be positive and its exp inf)
          const float2 cia = ch[ia], cib = ch[ib];
          const int k_max = jt == it ? w16 / 8 + 2 : 8;
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            if (kk < k_max) {
              uint32_t ahi[4], alo[4];
              load_a(ahi, alo, kk);
              const int ja = jt * TI + 8 * kk + t, jb = ja + 4;
              const float2 cja = ch[ja], cjb = ch[jb];
              float sv[4];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                sv[e] = __uint_as_float(ahi[e]) + __uint_as_float(alo[e]);
              split(ja <= ia ? sv[0] * decay(cia, cja) : 0.f, ahi[0], alo[0]);
              split(ja <= ib ? sv[1] * decay(cib, cja) : 0.f, ahi[1], alo[1]);
              split(jb <= ia ? sv[2] * decay(cia, cjb) : 0.f, ahi[2], alo[2]);
              split(jb <= ib ? sv[3] * decay(cib, cjb) : 0.f, ahi[3], alo[3]);
              float4 bq[NX];
              load_b(bq, kk);
              mma3<NX>(yacc[hh], ahi, alo, bq);
            }
          }
        }
        ++s;
      }
    }
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      if (hh >= nhg) break;
      float* yh = y + (long long)(h0 + hh) * hp;
#pragma unroll
      for (int n = 0; n < NX; ++n) {
        const int p = P0 * half + 8 * n + 2 * t;
        if (p >= hp) continue;
        if (ia < cl)
          *reinterpret_cast<float2*>(yh + (row0 + ia) * xs + p) =
              make_float2(yacc[hh][n][0], yacc[hh][n][1]);
        if (ib < cl)
          *reinterpret_cast<float2*>(yh + (row0 + ib) * xs + p) =
              make_float2(yacc[hh][n][2], yacc[hh][n][3]);
      }
    }
  } else {
    // =================== state rows [n0, n0 + 64) for the group's heads:
    // state[n][p] = sum_j B[j][n] (exp(cum_last - cum_j) xt[j][p])
    const int n0 = (r - n_it) * TI;
    const int per_jt = 1 + nhg;          // the tile of B, then xt per head
    const int n_steps = n_it * per_jt;
    auto load = [&](int s) {
      float* buf = ring + (s & 1) * RING;
      const int jt = s / per_jt, q = s % per_jt;
      if (q == 0)
        stage_tile<TI / 4>(buf, LDB, Bm, ns, row0 + jt * TI, row0 + cl, n0,
                           ns, tid);
      else
        load_x(buf, q - 1, jt);
      cp_async_commit();
    };
    auto advance = [&](int s) {
      if (s + 1 < n_steps) {
        load(s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    };
    const bool active = n0 + w16 < ns;   // a warp past ns only loads
    // xt_j scaled by exp(cum_last - cum_j) as it is split
    for (int idx = tid; idx < nhg * clp; idx += NT) {
      const float2* ch = cum + (idx / clp) * clp;
      usc[idx] = decay(ch[clp - 1], ch[idx % clp]);
    }
    float sacc[HG][NX][4];
#pragma unroll
    for (int hh = 0; hh < HG; ++hh)
#pragma unroll
      for (int n = 0; n < NX; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[hh][n][e] = 0.f;
    load(0);
    int s = 0;
    for (int jt = 0; jt < n_it; ++jt) {
      advance(s);
      {
        // a operand A[n][j] = B[j][n], split into fragments once for the
        // group's heads
        const float* Bs = ring + (s & 1) * RING;
        for (int slot = tid; slot < SA_SLOTS; slot += NT) {
          const int r2 = slot >> 8, kb = (slot >> 5) & 7, ln = slot & 31;
          const float* b0 = Bs + (8 * kb + (ln & 3)) * LDB + 16 * r2 + (ln >> 2);
          uint32_t hi[4], lo[4];
          split(b0[0], hi[0], lo[0]);
          split(b0[8], hi[1], lo[1]);
          split(b0[4 * LDB], hi[2], lo[2]);
          split(b0[4 * LDB + 8], hi[3], lo[3]);
          sa_hi[slot] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                                    __uint_as_float(hi[2]), __uint_as_float(hi[3]));
          sa_lo[slot] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                                    __uint_as_float(lo[2]), __uint_as_float(lo[3]));
        }
      }
      __syncthreads();                   // the ring stage is reloaded next
      ++s;
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        if (hh >= nhg) break;
        advance(s);
        split_x(ring + (s & 1) * RING, hh, jt);
        __syncthreads();
        if (active) {
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            uint32_t ahi[4], alo[4];
            load_a(ahi, alo, kk);
            float4 bq[NX];
            load_b(bq, kk);
            mma3<NX>(sacc[hh], ahi, alo, bq);
          }
        }
        ++s;
      }
    }
    if (active) {
      const int na = n0 + w16 + g, nb = na + 8;
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        if (hh >= nhg) break;
        float* sh = st + ((bc * nh + h0 + hh) * ns) * (long long)hp;
#pragma unroll
        for (int n = 0; n < NX; ++n) {
          const int p = P0 * half + 8 * n + 2 * t;
          if (p >= hp) continue;
          if (na < ns)
            *reinterpret_cast<float2*>(sh + (long long)na * hp + p) =
                make_float2(sacc[hh][n][0], sacc[hh][n][1]);
          if (nb < ns)
            *reinterpret_cast<float2*>(sh + (long long)nb * hp + p) =
                make_float2(sacc[hh][n][2], sacc[hh][n][3]);
        }
      }
    }
  }
}

template <int HPC, int HG>
cudaError_t launch(const float* xt, const float* a, const float* B,
                   const float* C, float* y, float* st, float* dec,
                   float4* ws, int b, int nc, int cl, int nh, int hp, int ns,
                   cudaStream_t stream) {
  const int n_it = ceil_div(cl, TI);
  const int n_groups = ceil_div(nh, HG);
  const int n_pairs = n_it * (n_it + 1) / 2;
  ssd_scores_tc_kernel<<<(unsigned)((long long)b * nc * n_pairs), NT, 0,
                         stream>>>(B, C, ws, cl, ns, n_pairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t bytes = sizeof(float) * Smem<HPC>::floats(HG, n_it * TI);
  auto kernel = ssd_intra_chunk_tc_kernel<HPC, HG>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)b * nc * n_groups * (n_it + ceil_div(ns, TI));
  kernel<<<(unsigned)blocks, NT, bytes, stream>>>(
      xt, a, B, ws, y, st, dec, cl, nh, hp, ns, n_groups, n_it);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues one kernel on the given
// stream, does not synchronise, allocates nothing, returns the cudaError_t of
// the launch (0 on success; -1 for arguments outside what it takes). All
// tensors f32 and contiguous: xt (b, nc, cl, nh, hp), a (b, nc, cl, nh),
// B and C (b, nc, cl, ns) in; y (b, nc, cl, nh, hp), st (b, nc, nh, ns, hp),
// dec (b, nc, cl, nh, 2) out. cl <= 256, hp <= 128, hp % 4 == ns % 4 == 0,
// xt, B, C 16-byte aligned; hg heads per block: 1, 2 or 4 with
// hg * (hp rounded up to 32, 64 or 128) <= 128.
extern "C" int ssd_intra_chunk_tc_launch(const void* xt, const void* a,
                                         const void* B, const void* C, void* y,
                                         void* st, void* dec, void* ws, int b,
                                         int nc, int cl, int nh, int hp,
                                         int ns, int hg, void* stream) {
  const int hpc = hp <= 32 ? 32 : hp <= 64 ? 64 : 128;
  if (b < 1 || nc < 1 || cl < 1 || cl > MAX_CL || nh < 1 || hp < 1 ||
      hp > 128 || hp % 4 || ns < 1 || ns % 4 ||
      (hg != 1 && hg != 2 && hg != 4) || hg * hpc > 128 ||
      (reinterpret_cast<uintptr_t>(xt) | reinterpret_cast<uintptr_t>(B) |
       reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(ws)) %
          16 ||
      (long long)b * nc * ceil_div(nh, hg) * (ceil_div(cl, TI) +
                                              ceil_div(ns, TI)) > 2147483647LL)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xt);
  const float* aa = static_cast<const float*>(a);
  const float* bb = static_cast<const float*>(B);
  const float* cc = static_cast<const float*>(C);
  float* yy = static_cast<float*>(y);
  float* ss = static_cast<float*>(st);
  float* dd = static_cast<float*>(dec);
  float4* w = static_cast<float4*>(ws);
#define REPRO_SSD_LAUNCH(P, H) \
  return (int)launch<P, H>(x, aa, bb, cc, yy, ss, dd, w, b, nc, cl, nh, hp, \
                           ns, s)
  switch (hpc * 16 + hg) {
    case 32 * 16 + 1: REPRO_SSD_LAUNCH(32, 1);
    case 32 * 16 + 2: REPRO_SSD_LAUNCH(32, 2);
    case 32 * 16 + 4: REPRO_SSD_LAUNCH(32, 4);
    case 64 * 16 + 1: REPRO_SSD_LAUNCH(64, 1);
    case 64 * 16 + 2: REPRO_SSD_LAUNCH(64, 2);
    default: REPRO_SSD_LAUNCH(128, 1);
  }
#undef REPRO_SSD_LAUNCH
}
