// Flash attention on the tensor cores of Hopper (sm_90a), f32, written by
// hand. It takes the place of the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py for f32 inputs whose head dim is 16,
// 32, 64 or 72, 80, ..., 128 and whose pointers and strides allow 16-byte
// copies; other f32 inputs stay on the SIMT kernel of flash_attention.cu,
// bf16 on flash_attention_ws.cu and flash_attention_tc.cu (the wrapper
// chooses by shape, dtype and alignment, never by failure).
//
// What bounds it on this card: at the calibrate path's shapes (S = 128 to
// 512, D = 32 or 64, causal) attention does hundreds of FLOP per byte it
// must move, so it is bound by operations. The tensor cores take tf32
// operands only; every product here is three tf32 products
// (csrc/tf32x3.cuh), which keeps f32 accuracy. An mma.sync takes tens of
// clocks from issue to result and reaches its rate only with several warps
// on each of an SM's four schedulers and several independent sums in each
// warp, and the causal query tiles are few and unequal, so the design is
// about the longest tile's chain of steps:
//
//   * a block of four warps owns 16 queries of one head (the calibrate
//     bench's 8 heads x 512 queries are 256 blocks, two to an SM); a step
//     stages 64 keys, warp w takes keys [16 w, 16 (w + 1)) of them with its
//     own online softmax, and the four warps' (m, l, O) are merged once at
//     the end; the heaviest query tiles start first;
//   * K and V in a two-stage ring of 16-byte cp.async copies (zero-filled
//     past the ends), the next step's in flight during this step's work;
//     rows padded so that every fragment load is free of bank conflicts;
//   * Q split into tf32 (hi, lo) fragments once per block; each K and V
//     element split once per step, in registers as its warp loads it (the
//     warps' keys are disjoint), by truncation (split_rz: three ALU
//     operations, where the rounding split takes two slow conversions);
//   * S = Q K^T on mma.sync m16n8k8 into eight independent sums a warp (by
//     term and k-block parity, so that the products' latency overlaps), and
//     O += P V (wgmma takes tf32 only K-major, and V lies D-major);
//   * the online softmax in f32 registers, row max and row sum over the
//     four lanes of a row by shuffles; P leaves S's accumulator layout (row
//     g, columns 2t, 2t + 1) and enters P V in the a-fragment layout (row g,
//     columns t, t + 4) by quad shuffles, split into (hi, lo) on the way.
//
// Head dims 72 to 120 (multiples of 8; kimi-k2-1t-a32b's 112) run the
// D = 128 instantiation with the true head dim d at run time: the copies of
// columns d..127 are zero-filled (cp.async with no source bytes), so they
// add nothing to a score and P V gives zeros there, which are not stored;
// the scale is 1/sqrt(d). Such a call does 128/d of the products it needs.
//
// The rules are the TPU kernel's: positions 0..S-1; masked scores -1e30
// (causal keeps j <= i, a window keeps j > i - window, keys past Skv are
// masked); tiles wholly in the future, wholly behind the window or wholly
// past the end are not visited; l clamped at 1e-20; kv_head = q_head /
// group, no broadcast copy; the (batch, seq, head, dim) layout read in
// place through strides. The softmax runs in base 2: s = q.k log2(e) /
// sqrt(D), p = 2^(s - m), which is the TPU kernel's exp(q.k / sqrt(D) - m')
// up to f32 rounding; a masked score stays -1e30, so p is 1 while every
// score of a row so far is masked and 0 after, as the TPU kernel's exp
// gives.

#include <cmath>
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
using repro::tf32x3::mma_tf32;
using repro::tf32x3::split_rz;

constexpr int BQ = 16;          // queries a block (one m16 tile)
constexpr int NW = 4;           // warps a block, one quarter of the keys each
constexpr int NT = 32 * NW;
constexpr int BKV = 16;         // keys a warp takes a step
constexpr int SK = NW * BKV;    // keys a step
constexpr int NS = BKV / 8;     // n tiles of a warp's S
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;            // elements; the last dim is contiguous
};

template <int D>
struct Cfg {
  static constexpr int KB = D / 8;                 // k blocks of Q K^T
  static constexpr int OC = D / 8 < 4 ? D / 8 : 4; // n tiles of O a chunk
  static constexpr int NOC = D / 8 / OC;           // chunks of O
  static constexpr int LDK = D + 4;                // K[g][t]: bank 4g + t
  static constexpr int LDV = D + 8;                // V[t][g]: bank 8t + g
  // floats: a ring stage holds the raw K rows of a step, then its V rows;
  // the Q fragments (k block, lane) as hi float4, lo float4
  static constexpr int STAGE = SK * (LDK + LDV);
  static constexpr int QF = KB * 32 * 8;
  static constexpr int FLOATS = 2 * STAGE + QF;
  // the merge: warps 1..3's m, l (two rows) and O, per lane
  static constexpr int PART = (4 + D / 2) * 32;
  static_assert((NW - 1) * PART <= 2 * STAGE, "the merge reuses the ring");
  static_assert(BQ <= SK, "Q is staged where stage 1's raw K lies");
};

template <int D>
__global__ void __launch_bounds__(NT)
flash_attention_tf32_kernel(const float* __restrict__ Q,
                            const float* __restrict__ Kp,
                            const float* __restrict__ V, float* __restrict__ O,
                            int Hq, int group, int Sq, int Skv, Strides qs,
                            Strides ks, Strides vs, Strides os, int causal,
                            int window, int dt, float c_log2) {
  using C = Cfg<D>;
  constexpr int KB = C::KB, OC = C::OC, NOC = C::NOC;
  constexpr int LDK = C::LDK, LDV = C::LDV, STAGE = C::STAGE;
  constexpr int DQ = D / 4;                        // 16-byte chunks a row
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float4* qf = smem4 + 2 * STAGE / 4;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the last query tiles have the most keys under a causal mask: first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const int kvh = h / group;
  const float* qp = Q + b * qs.b + h * qs.h;
  const float* kp = Kp + b * ks.b + kvh * ks.h;
  const float* vp = V + b * vs.b + kvh * vs.h;
  float* op = O + b * os.b + h * os.h;

  // ---- the keys the block visits: [kv_lo, kv_hi)
  const int q_last = min(q0 + BQ - 1, Sq - 1);
  const int kv_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_lo = window ? max(0, q0 - window + 1) : 0;
  const int step0 = kv_lo / SK, step1 = ceil_div(kv_hi, SK);

  auto load = [&](int stage, int step) {
    float* kr = ring + stage * STAGE;
    float* vr = kr + SK * LDK;
    const int k0 = step * SK;
#pragma unroll 4
    for (int c = tid; c < SK * DQ; c += NT) {
      const int row = c / DQ, q = c % DQ;
      const int key = k0 + row;
      const bool ok = key < Skv && 4 * q < dt;
      cp_async16(smem_u32(kr + row * LDK + 4 * q),
                 ok ? kp + key * ks.s + 4 * q : kp, ok);
      cp_async16(smem_u32(vr + row * LDV + 4 * q),
                 ok ? vp + key * vs.s + 4 * q : vp, ok);
    }
    cp_async_commit();
  };

  // ---- Q (16 rows, staged where stage 1's raw K goes) and the first
  // step's K and V in flight together; Q split into a fragments once
  float* qraw = ring + STAGE;
  for (int c = tid; c < BQ * DQ; c += NT) {
    const int row = c / DQ, q = c % DQ;
    const bool ok = q0 + row < Sq && 4 * q < dt;
    cp_async16(smem_u32(qraw + row * LDK + 4 * q),
               ok ? qp + (q0 + row) * qs.s + 4 * q : qp, ok);
  }
  cp_async_commit();
  if (step0 < step1) load(0, step0);
  cp_async_wait<0>();
  __syncthreads();
  for (int s = tid; s < KB * 32; s += NT) {
    const float* x0 = qraw + g * LDK + 8 * (s / 32) + t;
    uint32_t hi[4], lo[4];
    split_rz(x0[0], hi[0], lo[0]);
    split_rz(x0[8 * LDK], hi[1], lo[1]);
    split_rz(x0[4], hi[2], lo[2]);
    split_rz(x0[8 * LDK + 4], hi[3], lo[3]);
    qf[2 * s] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                            __uint_as_float(hi[2]), __uint_as_float(hi[3]));
    qf[2 * s + 1] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                                __uint_as_float(lo[2]), __uint_as_float(lo[3]));
  }
  // (the first step's barrier orders these reads before stage 1 is loaded)

  float m[2] = {NEG_INF, NEG_INF};       // rows g and g + 8, base 2
  float l[2] = {0.f, 0.f};               // this lane's part of the row sums
  float o[NOC][OC][4];
#pragma unroll
  for (int cc = 0; cc < NOC; ++cc)
#pragma unroll
    for (int n = 0; n < OC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[cc][n][e] = 0.f;
  const int ia = q0 + g, ib = ia + 8;

  for (int step = step0; step < step1; ++step) {
    const int st = (step - step0) & 1;
    cp_async_wait<0>();
    __syncthreads();                     // this step's tiles in; the other
                                         // stage's readers are done
    if (step + 1 < step1) load(st ^ 1, step + 1);

    // this warp's keys [kw, kw + BKV): skipped where every row masks them
    const int kw = step * SK + warp * BKV;
    if (kw >= kv_hi || (window && kw + BKV - 1 <= q0 - window)) continue;
    const float* kr = ring + st * STAGE + warp * BKV * LDK;
    const float* vr = ring + st * STAGE + SK * LDK + warp * BKV * LDV;

    // ---- S = Q K^T (16 x 16): the small terms and hi.hi in separate sums,
    // by k-block parity, so that eight chains of products overlap
    float sl[2][NS][4], sh[2][NS][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sl[p][n][e] = sh[p][n][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const float4 hq = qf[2 * (kb * 32 + lane)];
      const float4 lq = qf[2 * (kb * 32 + lane) + 1];
      const uint32_t ahi[4] = {__float_as_uint(hq.x), __float_as_uint(hq.y),
                               __float_as_uint(hq.z), __float_as_uint(hq.w)};
      const uint32_t alo[4] = {__float_as_uint(lq.x), __float_as_uint(lq.y),
                               __float_as_uint(lq.z), __float_as_uint(lq.w)};
#pragma unroll
      for (int n = 0; n < NS; ++n) {     // b0 K[8n + g][8kb + t], b1 + 4
        const float* k0 = kr + (8 * n + g) * LDK + 8 * kb + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_rz(k0[0], bh0, bl0);
        split_rz(k0[4], bh1, bl1);
        mma_tf32(sl[kb & 1][n], alo, bh0, bh1);
        mma_tf32(sh[kb & 1][n], ahi, bh0, bh1);
        mma_tf32(sl[kb & 1][n], ahi, bl0, bl1);
      }
    }
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[n][e] = (sl[0][n][e] + sl[1][n][e]) + (sh[0][n][e] + sh[1][n][e]);

    // ---- masks, the online softmax (rows ia: e 0, 1; ib: e 2, 3)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ia : ib;
        const int j = kw + 8 * n + 2 * t + (e & 1);
        bool ok = j < Skv;
        if (causal) ok = ok && j <= i;
        if (window) ok = ok && j > i - window;
        sc[n][e] = ok ? sc[n][e] * c_log2 : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      alpha[rr] = exp2f(m[rr] - m_new);
      m[rr] = m_new;
      l[rr] *= alpha[rr];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = exp2f(sc[n][e] - m[e >> 1]);
        l[e >> 1] += sc[n][e];
      }
#pragma unroll
    for (int cc = 0; cc < NOC; ++cc)
#pragma unroll
      for (int n = 0; n < OC; ++n) {
        o[cc][n][0] *= alpha[0];
        o[cc][n][1] *= alpha[0];
        o[cc][n][2] *= alpha[1];
        o[cc][n][3] *= alpha[1];
      }

    // ---- O += P V: P's key block n from S's layout (g, 2t | 2t + 1) to
    // the a fragment's (g, t | t + 4), from lanes 4g + t / 2 and
    // 4g + 2 + t / 2
    const int src1 = (lane & ~3) | (t >> 1), src2 = src1 + 2;
    const bool odd = t & 1;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float x[4], z[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = __shfl_sync(0xffffffffu, sc[n][e], src1);
        z[e] = __shfl_sync(0xffffffffu, sc[n][e], src2);
      }
      uint32_t phi[4], plo[4];
      split_rz(odd ? x[1] : x[0], phi[0], plo[0]);
      split_rz(odd ? x[3] : x[2], phi[1], plo[1]);
      split_rz(odd ? z[1] : z[0], phi[2], plo[2]);
      split_rz(odd ? z[3] : z[2], phi[3], plo[3]);
#pragma unroll
      for (int cc = 0; cc < NOC; ++cc) {
        float4 bv[OC];
#pragma unroll
        for (int d = 0; d < OC; ++d) {   // b0 V[8n + t][8 dt + g], b1 + 4 rows
          const float* v0 = vr + (8 * n + t) * LDV + 8 * (cc * OC + d) + g;
          uint32_t bh0, bl0, bh1, bl1;
          split_rz(v0[0], bh0, bl0);
          split_rz(v0[4 * LDV], bh1, bl1);
          bv[d] = make_float4(__uint_as_float(bh0), __uint_as_float(bl0),
                              __uint_as_float(bh1), __uint_as_float(bl1));
        }
        mma3<OC>(o[cc], phi, plo, bv);
      }
    }
  }

  // ---- merge warps 1..3's (m, l, O) into warp 0's, then O / l
  __syncthreads();                       // every warp is done with the ring
  if (warp > 0) {
    float* part = ring + (warp - 1) * C::PART;
    part[0 * 32 + lane] = m[0];
    part[1 * 32 + lane] = m[1];
    part[2 * 32 + lane] = l[0];
    part[3 * 32 + lane] = l[1];
#pragma unroll
    for (int cc = 0; cc < NOC; ++cc)
#pragma unroll
      for (int n = 0; n < OC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(4 + (cc * OC + n) * 4 + e) * 32 + lane] = o[cc][n][e];
  }
  __syncthreads();
  if (warp != 0) return;
  float f[NW][2];                        // each warp's factor a row
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float mw[NW];
    mw[0] = m[rr];
    float m_all = m[rr];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      mw[w] = ring[(w - 1) * C::PART + rr * 32 + lane];
      m_all = fmaxf(m_all, mw[w]);
    }
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      f[w][rr] = exp2f(mw[w] - m_all);
      const float lw =
          w == 0 ? l[rr] : ring[(w - 1) * C::PART + (2 + rr) * 32 + lane];
      lsum += lw * f[w][rr];
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    l[rr] = 1.f / fmaxf(lsum, 1e-20f);
  }
#pragma unroll
  for (int cc = 0; cc < NOC; ++cc)
#pragma unroll
    for (int n = 0; n < OC; ++n) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        float acc = o[cc][n][e] * f[0][rr];
#pragma unroll
        for (int w = 1; w < NW; ++w)
          acc += ring[(w - 1) * C::PART + (4 + (cc * OC + n) * 4 + e) * 32 +
                      lane] * f[w][rr];
        v[e] = acc * l[rr];
      }
      const int col = 8 * (cc * OC + n) + 2 * t;
      if (col >= dt) continue;           // dt is a multiple of 8
      if (ia < Sq)
        *reinterpret_cast<float2*>(op + ia * os.s + col) = make_float2(v[0], v[1]);
      if (ib < Sq)
        *reinterpret_cast<float2*>(op + ib * os.s + col) = make_float2(v[2], v[3]);
    }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int Hq, int Hkv, int Sq, int Skv, Strides qs,
                   Strides ks, Strides vs, Strides os, int causal, int window,
                   int dt, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * Cfg<D>::FLOATS;
  auto kernel = flash_attention_tf32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  // heads vary fastest: the heads of one GQA group, which read the same K
  // and V, are scheduled side by side
  const dim3 grid(B * Hq, ceil_div(Sq, BQ));
  // 1/sqrt of the true head dim, not of the template's
  const float c_log2 = 1.4426950408889634f / sqrtf((float)dt);
  kernel<<<grid, NT, bytes, stream>>>(q, k, v, o, Hq, Hq / Hkv, Sq, Skv, qs,
                                      ks, vs, os, causal, window, dt, c_log2);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues one kernel on the given
// stream, does not synchronise, allocates nothing, returns the cudaError_t of
// the launch (0 on success; -1 for arguments the kernel does not take).
// Logical shapes q, o: (B, Hq, Sq, D) and k, v: (B, Hkv, Skv, D), f32, each
// addressed through its (batch, head, seq) strides in elements with the last
// dim contiguous; pointers 16-byte aligned and strides multiples of 4. Head
// dims 16, 32, 64 and 72, 80, ..., 128.
extern "C" int flash_attention_tf32_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long q_b, long long q_h,
    long long q_s, long long k_b, long long k_h, long long k_s, long long v_b,
    long long v_h, long long v_s, long long o_b, long long o_h, long long o_s,
    int causal, int window, void* stream) {
  const long long strides[12] = {q_b, q_h, q_s, k_b, k_h, k_s,
                                 v_b, v_h, v_s, o_b, o_h, o_s};
  bool ok = B >= 1 && Hq >= 1 && Hkv >= 1 && Hq % Hkv == 0 && Sq >= 1 &&
            Skv >= 1 && ceil_div(Sq, BQ) <= 65535 &&
            (long long)B * Hq <= 2147483647LL &&
            ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
             16) == 0;
  for (long long s : strides) ok = ok && s % 4 == 0;
  if (!ok) return -1;
  const Strides qs{q_b, q_h, q_s}, ks{k_b, k_h, k_s}, vs{v_b, v_h, v_s},
      os{o_b, o_h, o_s};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(o);
  switch (D) {
    case 16:
      return (int)launch<16>(qq, kk, vv, oo, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, causal, window, D, s);
    case 32:
      return (int)launch<32>(qq, kk, vv, oo, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, causal, window, D, s);
    case 64:
      return (int)launch<64>(qq, kk, vv, oo, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, causal, window, D, s);
    default:
      if (D >= 72 && D <= 128 && D % 8 == 0)
        return (int)launch<128>(qq, kk, vv, oo, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, causal, window, D, s);
      return -1;
  }
}
