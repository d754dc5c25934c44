// Flash attention on the tensor cores of Hopper (sm_90a), bf16, written by
// hand. It takes the place of the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py for bf16 inputs whose head dim is 16
// or 32 (no model path at full width) and whose pointers and strides allow
// 16-byte copies; head dims 64 and 128 go to the warp-specialised kernel of
// flash_attention_ws.cu, f32 to flash_attention_tf32.cu, and every other
// shape to the SIMT kernel of flash_attention.cu (the wrapper chooses by
// shape, dtype and alignment, never by failure).
//
// What bounds it on this card: attention at prefill shapes does hundreds
// of FLOP per byte it must move, so it is bound by operations, and only the
// tensor cores (wgmma) reach the card's bf16 rate. The design:
//
//   * a block of two warpgroups owns 128 queries of one head (64 each) and
//     walks the KV tiles of 64 keys that its mask leaves, so every K and V
//     tile read from L2 serves 128 queries (with 64, the re-reads of K and
//     V from L2 set the pace); a warpgroup skips the work of a tile that
//     lies wholly outside its own rows' mask; at these head dims two or
//     more blocks share an SM, so one warpgroup's softmax overlaps
//     another's products;
//   * Q, K and V tiles in shared memory as 128-byte-swizzled panels, filled
//     by 16-byte cp.async (zero-filled past the ragged ends); K and V in a
//     two-stage ring, the next tile's copies in flight during this tile's
//     work;
//   * S = Q K^T by wgmma with both operands in shared memory (K is
//     (key, d) with d contiguous: a K-major B operand, no transpose);
//   * the online softmax on the S accumulator in registers: row max and
//     row sum over the four threads that share a row, by two shuffles;
//   * P rounded to bf16 (as the TPU kernel does, p.astype(v.dtype)) and
//     kept in registers in the A-fragment layout; O += P V by wgmma with P
//     from registers and V as an MN-major B operand (transpose bit).
//
// The rules are the SIMT kernel's and the TPU kernel's: positions 0..S-1;
// masked scores -1e30; element masks only on tiles that cross the diagonal,
// the window edge or the end; tiles wholly in the future, wholly behind the
// window or wholly past the end are not visited; l clamped at 1e-20; the
// heaviest query tiles start first; kv_head = q_head / group, no broadcast
// copy; the (batch, seq, head, dim) layout read in place through strides.
// The softmax runs in base 2 on the raw scores s = q.k: the row max m is
// taken over s, and p = 2^(s c - m c) with c = log2(e) / sqrt(D) is one
// fused multiply-add and one exp2, which is exp(s / sqrt(D) - m / sqrt(D))
// up to f32 rounding. A masked score is -1e30 before the exp, as in the TPU
// kernel; its p is written out as what the TPU kernel's exp gives for it:
// 1 while every score of the row so far is masked (m = -1e30), else 0.

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::ceil_div;
using namespace repro::sm90;
using bf16 = __nv_bfloat16;

constexpr int NWG = 2;                  // warpgroups per block
constexpr int BQ = 64 * NWG;            // queries per block, 64 a warpgroup
constexpr int BKV = 64;                 // keys per tile
constexpr int NT = 128 * NWG;
constexpr int PANEL = 64 * 128;         // 64 rows x 64 bf16, bytes
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;                    // elements; the last dim is contiguous
};

template <int D>
struct Smem {
  static constexpr int DP = D < 64 ? 64 : D;    // panel width in shared memory
  static constexpr int TILE = (DP / 64) * PANEL;
  static constexpr int Q_OFF = 0;               // warpgroup w's Q at +w
  static constexpr int KV_OFF = NWG * TILE;     // stage s: K at +2s, V at +2s+1
  static constexpr int BYTES = (NWG + 4) * TILE + 1024;  // + alignment slack
};

// Rows [row0, row0 + 64) of a (seq, D) matrix into a tile of 64-wide panels;
// rows at or past `rows` and the chunks past D are written as zeros. A
// thread keeps one chunk column and walks rows RP apart (a multiple of 8, so
// its swizzled offset only moves by whole 1024-byte atoms). All NT threads
// of the block take part.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* p,
                                          long long stride, int row0, int rows,
                                          int tid) {
  constexpr int CH = Smem<D>::DP / 8;           // chunks per smem row
  constexpr int RP = NT / CH;                   // rows per pass: 32 or 16
  const int cc = tid % CH, rr = tid / CH;
  const uint32_t dst = tile + (cc >> 3) * PANEL + swz128(rr, cc & 7);
  const bf16* src = p + (row0 + rr) * stride + 8 * cc;
#pragma unroll
  for (int j = 0; j < 64 / RP; ++j) {
    const bool ok = cc < D / 8 && row0 + rr + j * RP < rows;
    cp_async16(dst + j * RP * 128, ok ? src + j * RP * stride : p, ok);
  }
}

// 2^x on the special function unit (inputs are <= 0 here; results that
// would be denormal flush to zero, as exp of a masked score does anyway)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_attention_tc_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ Kp,
                          const bf16* __restrict__ V, bf16* __restrict__ O,
                          int Hq, int group, int Sq, int Skv, Strides qs,
                          Strides ks, Strides vs, Strides os, int causal,
                          int window, float scale_log2) {
  using S = Smem<D>;
  constexpr int DP = S::DP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base_1k(smem_raw);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;              // warpgroup: rows qw .. qw + 63
  const int wt = tid & 127;             // thread within the warpgroup
  const uint32_t sQ = base + S::Q_OFF + wg * S::TILE;
  // the last query tiles have the most keys under a causal mask: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const int kvh = h / group;
  const bf16* qp = Q + b * qs.b + h * qs.h;
  const bf16* kp = Kp + b * ks.b + kvh * ks.h;
  const bf16* vp = V + b * vs.b + kvh * vs.h;
  bf16* op = O + b * os.b + h * os.h;

  // the KV tiles this block visits: not wholly in the future (causal), not
  // wholly behind the window, not past the end
  const int nkb = ceil_div(Skv, BKV);
  int kb_end = nkb;
  if (causal) kb_end = min(nkb, (q0 + BQ - 1) / BKV + 1);
  int kb_begin = 0;
  if (window) kb_begin = max(0, q0 - window + 1) / BKV;

#pragma unroll
  for (int w = 0; w < NWG; ++w)
    load_tile<D>(base + S::Q_OFF + w * S::TILE, qp, qs.s, q0 + 64 * w, Sq, tid);
  if (kb_begin < kb_end) {
    load_tile<D>(base + S::KV_OFF, kp, ks.s, kb_begin * BKV, Skv, tid);
    load_tile<D>(base + S::KV_OFF + S::TILE, vp, vs.s, kb_begin * BKV, Skv, tid);
  }
  cp_async_commit();

  // this thread's two rows: qw + r_lo and qw + r_lo + 8
  const int qw = q0 + 64 * wg;
  const int r_lo = 16 * (wt >> 5) + ((wt & 31) >> 2);
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sum
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int st = (kb - kb_begin) & 1;
    const uint32_t sK = base + S::KV_OFF + 2 * st * S::TILE;
    const uint32_t sV = sK + S::TILE;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();                    // tile kb landed; stage st^1 is free
    if (kb + 1 < kb_end) {
      const uint32_t nK = base + S::KV_OFF + 2 * (st ^ 1) * S::TILE;
      load_tile<D>(nK, kp, ks.s, (kb + 1) * BKV, Skv, tid);
      load_tile<D>(nK + S::TILE, vp, vs.s, (kb + 1) * BKV, Skv, tid);
    }
    cp_async_commit();
    // the tile may lie wholly outside this warpgroup's rows' mask (the
    // other warpgroup's diagonal or window edge); the choice is uniform
    // over the warpgroup, as wgmma needs
    const int k0 = kb * BKV;
    if ((causal && k0 > qw + 63) || (window && k0 + BKV - 1 <= qw - window))
      continue;

    // S = Q K^T over the D / 16 steps of the head dim
    float s[32];
    wgmma_fence();
    wgmma_ss_set<0>(s, desc128(sQ, 16, 1024), desc128(sK, 16, 1024));
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * PANEL + 32 * (kk & 3);
      wgmma_ss<0>(s, desc128(sQ + off, 16, 1024), desc128(sK + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // mask where the tile crosses the diagonal, the window edge or the end;
    // online softmax per row
    const bool edge = (k0 + BKV > Skv) || (causal && k0 + BKV - 1 > qw) ||
                      (window && k0 <= qw + 63 - window);
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q_pos = qw + r_lo + 8 * hh;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          if (edge) {
            const int k_pos = k0 + acc_col(wt, i);
            bool ok = k_pos < Skv;
            if (causal) ok = ok && (k_pos <= q_pos);
            if (window) ok = ok && (k_pos > q_pos - window);
            s[i] = ok ? s[i] : NEG_INF;
          }
          mx = fmaxf(mx, s[i]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hh], mx);
      alpha[hh] = exp2_fast((m_run[hh] - m_new) * scale_log2);
      m_run[hh] = m_new;
      const float mc = m_new * scale_log2;
      const float p_masked = m_new == NEG_INF ? 1.f : 0.f;
      float sum = 0.f;
      if (edge) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            const float p = exp2_fast(fmaf(s[i], scale_log2, -mc));
            s[i] = s[i] == NEG_INF ? p_masked : p;
            sum += s[i];
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            s[i] = exp2_fast(fmaf(s[i], scale_log2, -mc));
            sum += s[i];
          }
        }
      }
      l_run[hh] = l_run[hh] * alpha[hh] + sum;
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // P (bf16) in the A-fragment layout: keys 16 kk .. 16 kk + 15 are the
    // accumulator's column blocks 2 kk and 2 kk + 1
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V over the 4 steps of 16 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(o, pa[kk], desc128(sV + 2048 * kk, PANEL, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 2);
    l_run[hh] = 1.f / fmaxf(l_run[hh], 1e-20f);
  }
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int col = acc_col(wt, i);
    if (col >= D) continue;                     // padding columns (D < 64)
    const int hh = (i >> 1) & 1;
    const int row = qw + r_lo + 8 * hh;
    if (row >= Sq) continue;
    *reinterpret_cast<__nv_bfloat162*>(op + row * os.s + col) =
        __floats2bfloat162_rn(o[i] * l_run[hh], o[i + 1] * l_run[hh]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Hq, int Hkv, int Sq, int Skv, Strides qs, Strides ks,
                   Strides vs, Strides os, int causal, int window,
                   cudaStream_t stream) {
  auto kernel = flash_attention_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
  if (err != cudaSuccess) return err;
  // heads vary fastest: the heads of one GQA group, which share their K and V
  // tiles, are scheduled side by side
  const dim3 grid(B * Hq, ceil_div(Sq, BQ));
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kernel<<<grid, NT, Smem<D>::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Hq, Hq / Hkv, Sq,
      Skv, qs, ks, vs, os, causal, window, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues one kernel on the given
// stream, does not synchronise, allocates nothing, returns the cudaError_t
// of the launch (0 on success); -1: arguments the kernel does not take.
// Logical shapes q, o: (B, Hq, Sq, D) and k, v: (B, Hkv, Skv, D), bf16,
// each addressed through its (batch, head, seq) strides in elements with
// the last dim contiguous; pointers 16-byte aligned, strides multiples of
// 8; head dims 16 and 32.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long q_b, long long q_h,
    long long q_s, long long k_b, long long k_h, long long k_s, long long v_b,
    long long v_h, long long v_s, long long o_b, long long o_h, long long o_s,
    int causal, int window, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1 ||
      ceil_div(Sq, BQ) > 65535)
    return -1;
  const long long strides[12] = {q_b, q_h, q_s, k_b, k_h, k_s,
                                 v_b, v_h, v_s, o_b, o_h, o_s};
  for (long long st : strides)
    if (st % 8) return -1;
  const Strides qs{q_b, q_h, q_s}, ks{k_b, k_h, k_s}, vs{v_b, v_h, v_s},
      os{o_b, o_h, o_s};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, causal, window, s);
    case 32:
      return launch<32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, causal, window, s);
    default:
      return -1;
  }
}
