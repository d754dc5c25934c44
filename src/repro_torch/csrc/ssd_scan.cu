// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a), written by hand. It
// takes the place of the Pallas TPU kernel of src/repro/kernels/ssd_scan.py
// (ssd_intra_chunk). Per (batch, chunk, head), with cum = cumsum(a):
//
//   y[i]      = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xt_j     (cl, hp)
//   state     = sum_j exp(cum_last - cum_j) B_j (x) xt_j                (ns, hp)
//   dec[i, 0] = exp(cum_i),  dec[i, 1] = exp(cum_last)
//
// All of it in f32. The TPU kernel holds a whole chunk in one grid cell: at
// mamba2-370m's width (chunk 256, ns 128, hp 64) that is xt, B, C and two
// 256 x 256 matrices, far more than the 227 KB of shared memory a block may
// use here. So the cell is cut: block (b, c, h, tile) owns either 64 rows i
// of y (tile < n_itiles) or 64 rows n of the state (the other tiles). Every
// block recomputes the chunk's cum (a scan over the chunk's a in shared
// memory). A y block walks the 64-wide j tiles up to its diagonal only; per
// tile it builds C_i . B_j over ns in 64-wide slices, scales it by the
// segment decay exp(cum_i - cum_j), written in that form because
// exp(cum_i) exp(-cum_j) overflows over a long chunk, and only where j <= i
// (for j > i the segment is positive and its exp may be inf), and
// accumulates the product with xt_j into a (64, hp) tile in registers. A
// state block weights each B_j row by exp(cum_last - cum_j) and accumulates
// B_w^T xt over the chunk. B and C are indexed by batch, not copied over the
// heads; xt, y and dec are addressed in the model's (b, nc, cl, nh, .) layout,
// not transposed. Ragged ends (cl, ns or hp not multiples of the tiles) are
// masked.
//
// Bound on this card: operations. This simple version uses f32 FMA on shared
// memory tiles, no tensor cores, and recomputes C_i . B_j for every head
// although it depends on the batch and chunk only.

#include <cmath>

#include "common.cuh"

namespace {

using repro::ceil_div;

constexpr int BT = 64;        // rows of a tile (i, j, and state rows n)
constexpr int NT = 256;       // 16 x 16 threads
constexpr int LD = BT + 1;    // padded row of a 64-wide tile

// HPJ: columns of hp per thread; hp <= 16 HPJ.
template <int HPJ>
__global__ void __launch_bounds__(NT)
ssd_intra_chunk_kernel(const float* __restrict__ xt, const float* __restrict__ a,
                       const float* __restrict__ Bm, const float* __restrict__ Cm,
                       float* __restrict__ y, float* __restrict__ st,
                       float* __restrict__ dec, int cl, int nh, int hp, int ns,
                       int n_itiles) {
  constexpr int HPP = 16 * HPJ;
  extern __shared__ float smem[];
  float* cum = smem;                  // [cl]
  float* tot = cum + cl;              // [NT] scan scratch
  float* tA = tot + NT;               // [BT][LD]
  float* tB = tA + BT * LD;           // [BT][LD]
  float* tP = tB + BT * LD;           // [BT][LD]
  float* tX = tP + BT * LD;           // [BT][HPP]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long bch = blockIdx.x;   // (b * nc + c) * nh + h
  const int h = (int)(bch % nh);
  const long long bc = bch / nh;
  const long long row0 = bc * cl;     // first row of this chunk in (b*nc*cl)

  // ---- cum = cumsum(a) over the chunk: serial runs, then a block scan
  {
    const int per = ceil_div(cl, NT);
    const int s0 = tid * per;
    float run = 0.f;
    for (int q = 0; q < per; ++q) {
      const int i = s0 + q;
      if (i < cl) run += a[(row0 + i) * nh + h];
    }
    tot[tid] = run;
    __syncthreads();
    for (int off = 1; off < NT; off <<= 1) {
      const float v = tid >= off ? tot[tid - off] : 0.f;
      __syncthreads();
      tot[tid] += v;
      __syncthreads();
    }
    float base = tid > 0 ? tot[tid - 1] : 0.f;
    for (int q = 0; q < per; ++q) {
      const int i = s0 + q;
      if (i < cl) {
        base += a[(row0 + i) * nh + h];
        cum[i] = base;
      }
    }
    __syncthreads();
  }
  const float cum_last = cum[cl - 1];

  float acc[4][HPJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < HPJ; ++jd) acc[i][jd] = 0.f;

  if ((int)blockIdx.y < n_itiles) {
    // ---------------- y rows [i0, i0 + BT); the longest tiles start first
    const int i0 = (n_itiles - 1 - (int)blockIdx.y) * BT;
    for (int j0 = 0; j0 <= i0; j0 += BT) {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int k0 = 0; k0 < ns; k0 += BT) {
        __syncthreads();              // previous readers of tA, tB, tX, tP done
        for (int idx = tid; idx < BT * BT; idx += NT) {
          const int r = idx / BT, kk = idx % BT;
          const int n = k0 + kk;
          const int ri = i0 + r, rj = j0 + r;
          tA[r * LD + kk] = (ri < cl && n < ns) ? Cm[(row0 + ri) * ns + n] : 0.f;
          tB[r * LD + kk] = (rj < cl && n < ns) ? Bm[(row0 + rj) * ns + n] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < BT; ++kk) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = tA[(ty + 16 * i) * LD + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = tB[(tx + 16 * j) * LD + kk];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
        }
      }
      for (int idx = tid; idx < BT * HPP; idx += NT) {
        const int r = idx / HPP, p = idx % HPP;
        const int rj = j0 + r;
        tX[r * HPP + p] =
            (rj < cl && p < hp) ? xt[((row0 + rj) * nh + h) * hp + p] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = i0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rj = j0 + tx + 16 * j;
          const bool ok = ri < cl && rj <= ri;
          tP[(ty + 16 * i) * LD + tx + 16 * j] =
              ok ? s[i][j] * expf(cum[ri] - cum[rj]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < BT; ++c) {
        float pv[4], xv[HPJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = tP[(ty + 16 * i) * LD + c];
#pragma unroll
        for (int jd = 0; jd < HPJ; ++jd) xv[jd] = tX[c * HPP + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jd = 0; jd < HPJ; ++jd)
            acc[i][jd] = fmaf(pv[i], xv[jd], acc[i][jd]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ri = i0 + ty + 16 * i;
      if (ri >= cl) continue;
#pragma unroll
      for (int jd = 0; jd < HPJ; ++jd) {
        const int p = tx + 16 * jd;
        if (p < hp) y[((row0 + ri) * nh + h) * hp + p] = acc[i][jd];
      }
    }
    if (tid < BT && i0 + tid < cl) {
      const long long o = ((row0 + i0 + tid) * nh + h) * 2;
      dec[o] = expf(cum[i0 + tid]);
      dec[o + 1] = expf(cum_last);
    }
  } else {
    // ---------------- state rows [n0, n0 + BT): B_w^T xt over the chunk
    const int n0 = ((int)blockIdx.y - n_itiles) * BT;
    for (int j0 = 0; j0 < cl; j0 += BT) {
      __syncthreads();
      for (int idx = tid; idx < BT * BT; idx += NT) {
        const int r = idx / BT, nn = idx % BT;
        const int rj = j0 + r, n = n0 + nn;
        tA[r * LD + nn] = (rj < cl && n < ns)
                              ? Bm[(row0 + rj) * ns + n] * expf(cum_last - cum[rj])
                              : 0.f;
      }
      for (int idx = tid; idx < BT * HPP; idx += NT) {
        const int r = idx / HPP, p = idx % HPP;
        const int rj = j0 + r;
        tX[r * HPP + p] =
            (rj < cl && p < hp) ? xt[((row0 + rj) * nh + h) * hp + p] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < BT; ++c) {
        float bv[4], xv[HPJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = tA[c * LD + ty + 16 * i];
#pragma unroll
        for (int jd = 0; jd < HPJ; ++jd) xv[jd] = tX[c * HPP + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jd = 0; jd < HPJ; ++jd)
            acc[i][jd] = fmaf(bv[i], xv[jd], acc[i][jd]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + ty + 16 * i;
      if (n >= ns) continue;
#pragma unroll
      for (int jd = 0; jd < HPJ; ++jd) {
        const int p = tx + 16 * jd;
        if (p < hp) st[(bch * ns + n) * hp + p] = acc[i][jd];
      }
    }
  }
}

template <int HPJ>
cudaError_t launch(const float* xt, const float* a, const float* B,
                   const float* C, float* y, float* st, float* dec, int b,
                   int nc, int cl, int nh, int hp, int ns,
                   cudaStream_t stream) {
  const size_t smem_bytes =
      sizeof(float) * ((size_t)cl + NT + 3 * BT * LD + BT * 16 * HPJ);
  auto kernel = ssd_intra_chunk_kernel<HPJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const int n_itiles = ceil_div(cl, BT);
  const int n_stiles = ceil_div(ns, BT);
  const dim3 grid((unsigned)((long long)b * nc * nh), n_itiles + n_stiles);
  kernel<<<grid, NT, smem_bytes, stream>>>(xt, a, B, C, y, st, dec, cl, nh,
                                           hp, ns, n_itiles);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues one kernel on the given
// stream, does not synchronise, allocates nothing, returns the cudaError_t of
// the launch (0 on success). All tensors f32 and contiguous: xt (b, nc, cl,
// nh, hp), a (b, nc, cl, nh), B and C (b, nc, cl, ns) in; y (b, nc, cl, nh,
// hp), st (b, nc, nh, ns, hp), dec (b, nc, cl, nh, 2) out. hp <= 128,
// cl <= 16384.
extern "C" int ssd_intra_chunk_launch(const void* xt, const void* a,
                                      const void* B, const void* C, void* y,
                                      void* st, void* dec, int b, int nc,
                                      int cl, int nh, int hp, int ns,
                                      void* stream) {
  if (b < 1 || nc < 1 || cl < 1 || nh < 1 || hp < 1 || ns < 1 || cl > 16384 ||
      ceil_div(cl, BT) + ceil_div(ns, BT) > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xt);
  const float* aa = static_cast<const float*>(a);
  const float* bb = static_cast<const float*>(B);
  const float* cc = static_cast<const float*>(C);
  float* yy = static_cast<float*>(y);
  float* ss = static_cast<float*>(st);
  float* dd = static_cast<float*>(dec);
  if (hp <= 16) return (int)launch<1>(x, aa, bb, cc, yy, ss, dd, b, nc, cl, nh, hp, ns, s);
  if (hp <= 32) return (int)launch<2>(x, aa, bb, cc, yy, ss, dd, b, nc, cl, nh, hp, ns, s);
  if (hp <= 64) return (int)launch<4>(x, aa, bb, cc, yy, ss, dd, b, nc, cl, nh, hp, ns, s);
  if (hp <= 128) return (int)launch<8>(x, aa, bb, cc, yy, ss, dd, b, nc, cl, nh, hp, ns, s);
  return -1;
}
