// Flash attention for Hopper (sm_90a), bf16, every head dim that is a
// multiple of 8 from 8 to 256, written by hand as a warp-specialised
// persistent kernel. It takes the place of the Pallas TPU kernel
// flash_attention of src/repro/kernels/flash_attention.py for bf16 inputs
// whose pointers and strides allow TMA (16-byte aligned bases, strides in
// whole 16-byte steps); the wrapper chooses it by dtype, head dim and
// alignment alone, never by failure.
//
// What bounds it on this card: a causal prefill on (4, 1024) tokens does
// ~1000 FLOP (D = 64) to ~4000 FLOP (D = 256) per byte it must move, so it
// is bound by operations, and only wgmma reaches the card's bf16 rate. The
// design keeps the tensor cores fed while the softmax runs on the CUDA cores
// and the special function unit:
//
//   * a block of three warpgroups: one producer, whose one elected thread
//     issues every TMA copy and which gives its registers up (setmaxnreg
//     down to 24), and two consumers of 64 query rows each (a work item is
//     128 queries of one head), raised to 240 registers;
//   * Q loaded once per work item into one of the Q buffers, the next
//     item's as soon as its buffer is free, between this item's K/V tiles;
//     K and V tiles of BKV keys in a ring of stages, each with a full and an
//     empty mbarrier: the TMA unit counts the bytes of a tile down on its
//     full barrier; a consumer warp arrives on K's empty barrier once the
//     product that read K has completed, and on V's once the product that
//     read V has; TMA boxes are rows x 64 bf16 with the 128-byte swizzle,
//     the layout the wgmma descriptors read (a row of D bf16 is D / 64 such
//     panels); rows past the end of q, k or v arrive as zeros;
//   * ping-pong: the two consumers take turns at the tensor cores through
//     two named barriers; in its turn a consumer issues S_j = Q K_j^T and
//     O += P_{j-1} V_{j-1}, then hands the turn over and runs the softmax of
//     S_j while the other consumer's products run;
//   * overlap inside a consumer: it waits for S_j alone (wgmma_wait<1>)
//     and runs the softmax of S_j while its own P V product is still in
//     flight; O is rescaled by the previous tile's factor just before the
//     next P V is issued, so O is never touched while a product writes it;
//   * the softmax kept short, since it, not the tensor cores, set the pace
//     of the first version on the card: the masks of a tile as two bounds
//     per row on the column index (only on tiles that cross the diagonal,
//     the window edge or the end), the row max and row sum as trees, the
//     thread's two rows side by side so that their dependent chains
//     interleave, a row whose scores are all masked so far handled by its
//     exponent's scale (0) instead of a select per element, and O's
//     rescale skipped where no row's maximum moved (D >= 128);
//   * a persistent grid: one block per SM walks the work items (batch,
//     head, query tile) heaviest first (most KV tiles under the mask), in
//     rounds of one item a block that run forward and backward in turn
//     (the blocks that took the heaviest items of a round take the
//     lightest of the next), the heads of a GQA group side by side so that
//     their K and V tiles come from L2.
//
// Four instantiations, by what fits one block's 232,448 bytes of shared
// memory and a consumer thread's 240 registers (o holds D / 2 floats, S
// BKV / 2, P BKV / 4 words):
//
//     D     BKV  stages  Q buffers  shared memory
//     64    128    3        2       128 KB
//     128   128    2        2       192 KB
//     192    64    2        2       192 KB
//     256    64    2        1       192 KB
//
// With two Q buffers the epilogue (O scaled by 1/l, rounded once to bf16,
// written over the consumer's rows of its Q buffer and stored by one TMA
// copy) runs while the producer already loads the next item's Q, K and V.
// With one (D = 256: a Q tile is 64 KB) the consumers free the buffer as
// soon as their last S product has landed, and write O from registers
// straight to device memory, so that the next item's Q loads during the
// last P V and the epilogue.
//
// The rules are those of flash_attention_tc.cu and of the TPU kernel: positions 0..S-1; masked scores -1e30, element masks only on
// tiles that cross the diagonal, the window edge or the end; tiles wholly
// masked for the whole work item are not visited; p of a score that is
// masked while every score of its row so far is masked is 1 (what the TPU
// kernel's exp gives), else 0; P rounded to bf16 before P V; the softmax in
// base 2 on the raw scores with 1/sqrt(D) folded into one FMA; l clamped at
// 1e-20; kv_head = q_head / group, no broadcast copy; q, k, v and o read
// and written in place through their (batch, head, seq) strides.
//
// A head dim runs the narrowest instantiation that holds it: 8 to 56 on
// D = 64, 72 to 120 (kimi-k2-1t-a32b's 112 among them) on D = 128, 136 to
// 184 on D = 192, 200 to 248 on D = 256. The tensor maps are encoded with
// the tensor's true head dim, so TMA fills a box's columns past it with
// zeros on a load (they add nothing to Q K^T, and P V writes zeros there)
// and clips them on the store; the softmax scale is 1/sqrt of the true
// head dim. Such a call does D/d of the products its head dim needs. A row
// of a multiple of 8 bf16 is a whole number of TMA's 16-byte steps.
//
// The order of the work items and the KV tiles each visits are mirrored in
// Python by repro_torch.kernels.flash_attention.ws_keys, ws_tiles,
// ws_qtile_order and ws_block_items (tested on the CPU).

#include <cmath>
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums (the encoder: the CUDA driver's)

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::ceil_div;
using namespace repro::sm90;
using bf16 = __nv_bfloat16;

constexpr int BQ = 128;                 // queries per work item, 64 a consumer
constexpr int NT = 384;                 // producer + two consumer warpgroups
constexpr int QPANEL = BQ * 128;        // 128 rows x 64 bf16: one Q box
constexpr float NEG_INF = -1e30f;
constexpr uint32_t TURN_BAR = 1;        // named barriers 1, 2: consumer turns
constexpr uint32_t STORE_BAR = 3;       // 3, 4: a consumer's epilogue
constexpr uint32_t CONSUMERS = 256;     // threads of the two consumers

// An instantiation's tiles and its shared-memory layout (see the table above)
template <int D>
struct Cfg {
  static constexpr int BKV = D <= 128 ? 128 : 64;   // keys per K / V tile
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int NQ = D == 256 ? 1 : 2;       // Q buffers
  static constexpr int KPANEL = BKV * 128;          // BKV rows x 64 bf16
  static constexpr int Q_TILE = (D / 64) * QPANEL;  // 128 rows x D
  static constexpr int KV_TILE = (D / 64) * KPANEL; // BKV rows x D
  static constexpr int Q_OFF = 0;       // buffer b at + b * Q_TILE; consumer
                                        // w's rows at + w * 8K in a panel
  static constexpr int K_OFF = NQ * Q_TILE;         // stage s at + s * KV_TILE
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  // q_full of each Q buffer, q_empty of each, then k_full, k_empty, v_full,
  // v_empty of each stage
  static constexpr int N_BARS = 2 * NQ + 4 * STAGES;
  static constexpr int BYTES = BAR_OFF + 8 * N_BARS + 1024;  // + alignment
  static_assert(BYTES <= 232448, "shared memory of one block");
};

struct Strides {
  long long b, h, s;                    // elements; the last dim is contiguous
};

// What the kernel walks: the work items are (batch, head, query tile);
// `peak` splits the query tiles into a part whose weight rises strictly
// (0..peak) and one whose weight never rises (peak+1..nqt-1).
struct Sched {
  int B, Hq, group, Sq, Skv, causal, window;
  int nqt, nkb, peak, n_items;
  int d;                                // the true head dim (<= the template's)
};

// KV tiles [kb_begin, kb_end) (of BKV keys) of query tile qt: the tiles
// holding at least one key that some query of the tile may see; none when
// the window of the tile's first query starts past the last key.
template <int BKV>
__host__ __device__ __forceinline__ int kb_begin(const Sched& sc, int qt) {
  if (!sc.window) return 0;
  const int first = qt * BQ - sc.window + 1;
  if (first >= sc.Skv) return sc.nkb;
  return first > 0 ? first / BKV : 0;
}
template <int BKV>
__host__ __device__ __forceinline__ int kb_end(const Sched& sc, int qt) {
  if (!sc.causal) return sc.nkb;
  const int end = qt * BQ + BQ < sc.Sq ? qt * BQ + BQ : sc.Sq;
  const int e = (end - 1) / BKV + 1;    // past the tile's last query's key
  return e < sc.nkb ? e : sc.nkb;
}
template <int BKV>
__host__ __device__ __forceinline__ int weight(const Sched& sc, int qt) {
  const int w = kb_end<BKV>(sc, qt) - kb_begin<BKV>(sc, qt);
  return w > 0 ? w : 0;
}

// The query tiles heaviest first: the weight rises strictly up to `peak`
// and never rises after it, so the order is a merge of tiles peak, peak-1,
// ..., 0 with tiles peak+1, ..., nqt-1, the first list winning ties.
// Each thread that needs the order walks it, one rank at a time.
template <int BKV>
struct Order {
  int a = 0, c = 0;                     // taken from each list
  int rank = -1, qt = 0;
  __device__ __forceinline__ void advance(const Sched& sc, int r) {
    while (rank < r) {
      const int ny = sc.nqt - 1 - sc.peak;
      bool first = a <= sc.peak;
      if (first && c < ny)
        first = weight<BKV>(sc, sc.peak - a) >=
                weight<BKV>(sc, sc.peak + 1 + c);
      if (first) {
        qt = sc.peak - a;
        ++a;
      } else {
        qt = sc.peak + 1 + c;
        ++c;
      }
      ++rank;
    }
  }
};

// A work item as the producer walks it.
struct Item {
  int b, h, qt, kb0, kb1;
};

// 2^x on the special function unit (inputs are <= 0 here; results that
// would be denormal flush to zero, as exp of a masked score does anyway)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int R>
__device__ __forceinline__ void fence_u32(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// S = Q K^T over the D / 16 steps of the head dim (issued, not waited for);
// Q's 64-wide panels QPANEL bytes apart, K's KPANEL
template <int D, int KPANEL, int NS>
__device__ __forceinline__ void issue_qk(float (&s)[NS], uint32_t sQ,
                                         uint32_t sK) {
  wgmma_fence();
  wgmma_ss_set<0>(s, desc128(sQ, 16, 1024), desc128(sK, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint32_t off = 32 * (kk & 3);
    wgmma_ss<0>(s, desc128(sQ + (kk >> 2) * QPANEL + off, 16, 1024),
                desc128(sK + (kk >> 2) * KPANEL + off, 16, 1024));
  }
  wgmma_commit();
}

// O += P V over the BKV / 16 steps of 16 keys (issued, not waited for); V
// is an MN-major operand, its 64-wide panels KPANEL bytes apart
template <int KPANEL, int NK, int R>
__device__ __forceinline__ void issue_pv(float (&o)[R],
                                         const uint32_t (&pa)[NK][4],
                                         uint32_t sV) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    wgmma_rs(o, pa[kk], desc128(sV + 2048 * kk, KPANEL, 1024));
  wgmma_commit();
}

// Which columns c (0..BKV-1) of a tile starting at key k0 the two rows of
// this thread may see: lo[hh] < c <= hi[hh]; edge: some element of the
// warpgroup's 64 rows is masked (the tile crosses the diagonal, the window
// edge or the end).
template <int BKV>
__device__ __forceinline__ bool tile_mask(int (&lo)[2], int (&hi)[2],
                                          const Sched& sc, int k0, int qw,
                                          int r_lo, int wt) {
  const int cb = k0 + 2 * (wt & 3);     // key of this thread's column 0
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int q_pos = qw + r_lo + 8 * hh;
    hi[hh] = sc.Skv - 1 - cb;
    if (sc.causal) hi[hh] = min(hi[hh], q_pos - cb);
    lo[hh] = sc.window ? q_pos - sc.window - cb : -1;
  }
  return (k0 + BKV > sc.Skv) || (sc.causal && k0 + BKV - 1 > qw) ||
         (sc.window && k0 <= qw + 63 - sc.window);
}

// element n (0..BKV/4-1) of row half hh: its accumulator index and its
// column offset from the thread's column 0
__device__ __forceinline__ constexpr int el(int hh, int n) {
  return 4 * (n >> 1) + 2 * hh + (n & 1);
}
__device__ __forceinline__ constexpr int el_col(int n) {
  return 8 * (n >> 1) + (n & 1);
}

// The online softmax of one 64 x BKV score tile in place (s becomes p; a
// thread holds NS = BKV / 2 scores, NS / 2 of each of its two rows); alpha
// is the factor the rows' earlier sums are to be scaled by. A masked score
// is -1e30; while every score of a row so far is masked (m = -1e30) the
// exponent's scale is 0, so each p of the row is 1, as the TPU kernel's exp
// gives; otherwise a masked p underflows to 0.
template <int NS>
__device__ __forceinline__ void online_softmax(float (&s)[NS],
                                               float (&m_run)[2],
                                               float (&l_run)[2],
                                               float (&alpha)[2], bool edge,
                                               const int (&lo)[2],
                                               const int (&hi)[2],
                                               float scale_log2) {
  constexpr int N = NS / 2;             // scores of a row
  if (edge) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const int c = el_col(n);
        s[el(hh, n)] = (c > lo[hh] && c <= hi[hh]) ? s[el(hh, n)] : NEG_INF;
      }
  }
  // the two rows side by side, so that their chains interleave
  float m[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx[N / 4];
#pragma unroll
    for (int t = 0; t < N / 4; ++t)
      mx[t] = fmaxf(fmaxf(s[el(hh, 4 * t)], s[el(hh, 4 * t + 1)]),
                    fmaxf(s[el(hh, 4 * t + 2)], s[el(hh, 4 * t + 3)]));
#pragma unroll
    for (int w = N / 8; w >= 1; w >>= 1)
#pragma unroll
      for (int t = 0; t < w; ++t) mx[t] = fmaxf(mx[t], mx[t + w]);
    m[hh] = mx[0];
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
  float cs[2], mc[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float m_new = fmaxf(m_run[hh], m[hh]);
    alpha[hh] = exp2_fast((m_run[hh] - m_new) * scale_log2);
    m_run[hh] = m_new;
    const bool none = m_new == NEG_INF;
    cs[hh] = none ? 0.f : scale_log2;
    mc[hh] = none ? 0.f : m_new * scale_log2;
  }
  float sum[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = el(hh, n);
      s[i] = exp2_fast(fmaf(s[i], cs[hh], -mc[hh]));
      sum[hh][n & 3] += s[i];
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    l_run[hh] = l_run[hh] * alpha[hh] +
                ((sum[hh][0] + sum[hh][1]) + (sum[hh][2] + sum[hh][3]));
}

// P (bf16) in the A-fragment layout: keys 16 kk .. 16 kk + 15 are the
// accumulator's column blocks 2 kk and 2 kk + 1
template <int NK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[NK][4],
                                       const float (&s)[8 * NK]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// O scaled by the rows' factors; from D = 128 on (64 or more registers of
// O) skipped by a warp whose rows' maxima all stayed (every factor exactly
// 1), which is most tiles past the first few (at D = 64 the vote cost more
// than it saved on the card)
template <int R>
__device__ __forceinline__ void rescale(float (&o)[R], const float (&alpha)[2]) {
  if (R >= 64 && !__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
    return;
#pragma unroll
  for (int i = 0; i < R; ++i) o[i] *= alpha[(i >> 1) & 1];
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_attention_ws_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to,
                          bf16* __restrict__ O, const Sched sc,
                          const Strides os, const float scale_log2) {
  using C = Cfg<D>;
  constexpr int BKV = C::BKV, NQ = C::NQ, STAGES = C::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = smem_base_1k(smem_raw);
  const uint32_t bars = base + C::BAR_OFF;
  auto q_full = [&](int qb) { return bars + 8 * qb; };
  auto q_empty = [&](int qb) { return bars + 8 * (NQ + qb); };
  const uint32_t kv_bars = bars + 16 * NQ;
  auto k_full = [&](int st) { return kv_bars + 32 * st; };
  auto k_empty = [&](int st) { return kv_bars + 8 + 32 * st; };
  auto v_full = [&](int st) { return kv_bars + 16 + 32 * st; };
  auto v_empty = [&](int st) { return kv_bars + 24 + 32 * st; };
  const int bh = sc.B * sc.Hq;
  // the items of this block: rounds of gridDim.x items, this block's item
  // of each round counted from the front and from the back in turn
  auto item_of = [&](int round) {
    return round * (int)gridDim.x +
           ((round & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x
                        : (int)blockIdx.x);
  };
  const int rounds = ceil_div(sc.n_items, gridDim.x);

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < NQ; ++qb) {
      mbar_init(q_full(qb), 1);
      // two Q buffers: one arrival per consumer once its epilogue's store
      // has read the buffer; one: one per consumer warp once its last S
      // product has landed
      mbar_init(q_empty(qb), NQ == 1 ? 8 : 2);
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(k_empty(st), 8);
      mbar_init(v_full(st), 1);
      mbar_init(v_empty(st), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // ---- producer: one thread issues every copy ----
    setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    tma_prefetch_map(&tq);
    tma_prefetch_map(&tk);
    tma_prefetch_map(&tv);
    // the next work item that visits a KV tile (an item with none only
    // writes zeros, which its consumers do alone)
    Order<BKV> ord;
    int round = 0;
    auto next_item = [&](Item& it) {
      for (; round < rounds; ++round) {
        const int item = item_of(round);
        if (item >= sc.n_items) continue;
        ord.advance(sc, item / bh);
        const int rem = item % bh;
        it.b = rem / sc.Hq;
        it.h = rem % sc.Hq;
        it.qt = ord.qt;
        it.kb0 = kb_begin<BKV>(sc, ord.qt);
        it.kb1 = kb_end<BKV>(sc, ord.qt);
        if (it.kb0 < it.kb1) {
          ++round;
          return true;
        }
      }
      return false;
    };
    unsigned kv_it = 0, q_it = 0;
    // Q of item `it` into the next buffer; with `now` false, only if the
    // buffer is already free (the consumers are done with it)
    auto load_q = [&](const Item& it, bool now) {
      const int qb = q_it % NQ;
      const uint32_t parity = ((q_it / NQ) & 1) ^ 1;
      if (!now && !mbar_test(q_empty(qb), parity)) return false;
      mbar_wait(q_empty(qb), parity);
      mbar_arrive_expect_tx(q_full(qb), C::Q_TILE);
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
        tma_load_4d(base + C::Q_OFF + qb * C::Q_TILE + p * QPANEL, &tq,
                    q_full(qb), 64 * p, it.qt * BQ, it.h, it.b);
      ++q_it;
      return true;
    };
    Item cur, nxt;
    bool have = next_item(cur);
    if (have) load_q(cur, true);
    while (have) {
      const bool have_next = next_item(nxt);
      bool q_next = !have_next;          // the next item's Q issued
      const int kvh = cur.h / sc.group;
      for (int kb = cur.kb0; kb < cur.kb1; ++kb, ++kv_it) {
        const int st = kv_it % STAGES;
        const uint32_t ph = (kv_it / STAGES) & 1;
        mbar_wait(k_empty(st), ph ^ 1);
        mbar_arrive_expect_tx(k_full(st), C::KV_TILE);
#pragma unroll
        for (int p = 0; p < D / 64; ++p)
          tma_load_4d(base + C::K_OFF + st * C::KV_TILE + p * C::KPANEL, &tk,
                      k_full(st), 64 * p, kb * BKV, kvh, cur.b);
        mbar_wait(v_empty(st), ph ^ 1);
        mbar_arrive_expect_tx(v_full(st), C::KV_TILE);
#pragma unroll
        for (int p = 0; p < D / 64; ++p)
          tma_load_4d(base + C::V_OFF + st * C::KV_TILE + p * C::KPANEL, &tv,
                      v_full(st), 64 * p, kb * BKV, kvh, cur.b);
        // the next item's Q, into the other buffer, as soon as the
        // consumers free it (as they start this item), without holding up
        // this item's tiles
        if (!q_next) q_next = load_q(nxt, false);
      }
      if (!q_next) load_q(nxt, true);
      cur = nxt;
      have = have_next;
    }
  } else {
    // ---- consumers: 64 query rows each ----
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int wt = threadIdx.x & 127;
    const bool lane0 = (threadIdx.x & 31) == 0;
    const int r_lo = 16 * (wt >> 5) + ((wt & 31) >> 2);  // rows r_lo, r_lo + 8
    const uint32_t my_turn = TURN_BAR + cw, other_turn = TURN_BAR + (cw ^ 1);
    if (cw == 1) bar_arrive(other_turn, CONSUMERS);  // consumer 0 goes first
    Order<BKV> ord;
    unsigned kv_it = 0, q_it = 0;
    int stored = -1;      // the Q buffer an epilogue's TMA store may still read
    for (int round = 0; round < rounds; ++round) {
      const int item = item_of(round);
      if (item >= sc.n_items) continue;
      ord.advance(sc, item / bh);
      const int rem = item % bh, b = rem / sc.Hq, h = rem % sc.Hq;
      const int kb0 = kb_begin<BKV>(sc, ord.qt), kb1 = kb_end<BKV>(sc, ord.qt);
      const int qw = ord.qt * BQ + 64 * cw;
      float m_run[2] = {NEG_INF, NEG_INF};
      float l_run[2] = {0.f, 0.f};       // this thread's share of the row sum
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      bf16* op = O + b * os.b + h * os.h;

      if (kb0 >= kb1) {
        // no key to see (a window past the keys): zeros, as the kernel of
        // csrc/flash_attention_tc.cu writes
#pragma unroll
        for (int i = 0; i < D / 2; i += 2) {
          const int row = qw + r_lo + 8 * ((i >> 1) & 1);
          if (row < sc.Sq && acc_col(wt, i) < sc.d)
            *reinterpret_cast<__nv_bfloat162*>(op + row * os.s +
                                               acc_col(wt, i)) =
                __floats2bfloat162_rn(0.f, 0.f);
        }
        continue;
      }
      const int qb = q_it % NQ;
      mbar_wait(q_full(qb), (q_it / NQ) & 1);
      ++q_it;
      if (NQ == 2 && wt == 0 && stored >= 0) {  // the last epilogue's store
        bulk_wait_read<0>();            // read its buffer: the producer may
        mbar_arrive(q_empty(stored));   // refill it
        stored = -1;
      }
      // one Q buffer: free it as soon as this warp's last S has landed
      auto q_read = [&](int kb) {
        if (NQ == 1 && kb == kb1 - 1 && lane0) mbar_arrive(q_empty(qb));
      };
      const uint32_t sQ = base + C::Q_OFF + qb * C::Q_TILE + cw * 64 * 128;
      {
        float s[BKV / 2], alpha[2];
        int lo[2], hi[2];
        uint32_t pa[BKV / 16][4];
        int st = kv_it % STAGES;
        uint32_t ph = (kv_it / STAGES) & 1;
        // the first tile: S alone
        mbar_wait(k_full(st), ph);
        bar_sync(my_turn, CONSUMERS);
        issue_qk<D, C::KPANEL>(s, sQ, base + C::K_OFF + st * C::KV_TILE);
        bar_arrive(other_turn, CONSUMERS);
        wgmma_wait<0>();
        fence_regs(s);
        if (lane0) mbar_arrive(k_empty(st));
        q_read(kb0);
        bool edge = tile_mask<BKV>(lo, hi, sc, kb0 * BKV, qw, r_lo, wt);
        online_softmax(s, m_run, l_run, alpha, edge, lo, hi, scale_log2);
        pack_p(pa, s);
        for (int kb = kb0 + 1; kb < kb1; ++kb) {
          const int pst = st;
          const uint32_t pph = ph;
          ++kv_it;
          st = kv_it % STAGES;
          ph = (kv_it / STAGES) & 1;
          mbar_wait(k_full(st), ph);
          bar_sync(my_turn, CONSUMERS);
          issue_qk<D, C::KPANEL>(s, sQ, base + C::K_OFF + st * C::KV_TILE);
          rescale(o, alpha);
          mbar_wait(v_full(pst), pph);
          issue_pv<C::KPANEL>(o, pa, base + C::V_OFF + pst * C::KV_TILE);
          bar_arrive(other_turn, CONSUMERS);
          wgmma_wait<1>();               // S_j landed; P V may still run
          fence_regs(s);
          if (lane0) mbar_arrive(k_empty(st));
          q_read(kb);
          edge = tile_mask<BKV>(lo, hi, sc, kb * BKV, qw, r_lo, wt);
          online_softmax(s, m_run, l_run, alpha, edge, lo, hi, scale_log2);
          wgmma_wait<0>();
          fence_regs(o);
          fence_u32(pa);
          if (lane0) mbar_arrive(v_empty(pst));
          pack_p(pa, s);
        }
        rescale(o, alpha);
        mbar_wait(v_full(st), ph);
        issue_pv<C::KPANEL>(o, pa, base + C::V_OFF + st * C::KV_TILE);
        wgmma_wait<0>();
        fence_regs(o);
        fence_u32(pa);
        if (lane0) mbar_arrive(v_empty(st));
        ++kv_it;
      }

      // epilogue: O / l, rounded once to bf16; rows past Sq and columns
      // past the true head dim are not stored
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
        l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 2);
        l_run[hh] = 1.f / fmaxf(l_run[hh], 1e-20f);
      }
      if constexpr (NQ == 1) {
        // straight from the registers (the Q buffer is the next item's)
#pragma unroll
        for (int i = 0; i < D / 2; i += 2) {
          const int hh = (i >> 1) & 1;
          const int row = qw + r_lo + 8 * hh, col = acc_col(wt, i);
          if (row < sc.Sq && col < sc.d)
            *reinterpret_cast<__nv_bfloat162*>(op + row * os.s + col) =
                __floats2bfloat162_rn(o[i] * l_run[hh], o[i + 1] * l_run[hh]);
        }
      } else {
        // over this consumer's rows of its Q buffer (every product that
        // read them is done), then one TMA store of them
#pragma unroll
        for (int i = 0; i < D / 2; i += 2) {
          const int hh = (i >> 1) & 1;
          const int row = r_lo + 8 * hh, col = acc_col(wt, i);
          st_shared_u32(sQ + (col >> 6) * QPANEL +
                            swz128(row, (col & 63) >> 3) + 2 * (col & 7),
                        pack_bf16(o[i] * l_run[hh], o[i + 1] * l_run[hh]));
        }
        fence_proxy_async();
        bar_sync(STORE_BAR + cw, 128);
        if (wt == 0) {
#pragma unroll
          for (int p = 0; p < D / 64; ++p)
            tma_store_4d(&to, sQ + p * QPANEL, 64 * p, qw, h, b);
          bulk_commit();
          stored = qb;
        }
      }
    }
    if (wt == 0) bulk_wait<0>();
    // consumer 1 handed over one turn more than consumer 0 took: take it,
    // so that no arrival is left on a named barrier
    if (cw == 0) bar_sync(my_turn, CONSUMERS);
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
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over (D, S, H, B) of a bf16 tensor, boxes of 64 x rows x 1 x 1
// with the 128-byte swizzle. A dim of size 1 is never stepped along, so its
// stride is set to one TMA accepts whatever the tensor says.
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int H, int B,
              long long ss, long long sh, long long sb, int rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(S > 1 ? ss : D) * 2,
                                 (cuuint64_t)(H > 1 ? sh : D) * 2,
                                 (cuuint64_t)(B > 1 ? sb : D) * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The schedule of instantiation D, its tensor maps, and the launch
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int d, const long long* st,
           int causal, int window, int blocks, cudaStream_t stream) {
  using C = Cfg<D>;
  Sched sc{B, Hq, Hq / Hkv, Sq, Skv, causal ? 1 : 0, window,
           ceil_div(Sq, BQ), ceil_div(Skv, C::BKV), 0, 0, d};
  if ((long long)sc.nqt * B * Hq >= (1ll << 31)) return -1;
  sc.n_items = sc.nqt * B * Hq;
  while (sc.peak + 1 < sc.nqt &&
         weight<C::BKV>(sc, sc.peak + 1) > weight<C::BKV>(sc, sc.peak))
    ++sc.peak;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, d, Sq, Hq, B, st[2], st[1], st[0], BQ) ||
      !make_map(&tk, k, d, Skv, Hkv, B, st[5], st[4], st[3], C::BKV) ||
      !make_map(&tv, v, d, Skv, Hkv, B, st[8], st[7], st[6], C::BKV) ||
      !make_map(&to, o, d, Sq, Hq, B, st[11], st[10], st[9], 64))
    return -2;
  if (blocks > sc.n_items) blocks = sc.n_items;
  const Strides os{st[9], st[10], st[11]};
  auto kernel = flash_attention_ws_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  // 1/sqrt of the true head dim, not of the template's
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  kernel<<<blocks, NT, C::BYTES, stream>>>(
      tq, tk, tv, to, static_cast<bf16*>(o), sc, os, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes): enqueues one kernel on the given
// stream, does not synchronise, allocates nothing, returns the cudaError_t
// of the launch (0 on success); -1: arguments the kernel does not take; -2:
// the CUDA driver refused a tensor map. The arguments of flash_attention_tc_launch
// and `blocks`, the persistent grid (at most one block an SM: the wrapper
// passes min(work items, SMs)). Logical shapes q, o: (B, Hq, Sq, D) and k, v:
// (B, Hkv, Skv, D), bf16, each addressed through its (batch, head, seq)
// strides in elements with the last dim contiguous; pointers 16-byte aligned,
// strides multiples of 8; head dims the multiples of 8 from 8 to 256.
extern "C" int flash_attention_ws_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long q_b, long long q_h,
    long long q_s, long long k_b, long long k_h, long long k_s, long long v_b,
    long long v_h, long long v_s, long long o_b, long long o_h, long long o_s,
    int causal, int window, int blocks, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1 ||
      blocks < 1 || D < 8 || D > 256 || D % 8 != 0 || window < 0)
    return -1;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return -1;
  const long long st[12] = {q_b, q_h, q_s, k_b, k_h, k_s,
                            v_b, v_h, v_s, o_b, o_h, o_s};
  for (long long x : st)
    if (x % 8) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the narrowest instantiation that holds the head dim
  if (D <= 64)
    return launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal, window,
                      blocks, s);
  if (D <= 128)
    return launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal, window,
                       blocks, s);
  if (D <= 192)
    return launch<192>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal, window,
                       blocks, s);
  return launch<256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal, window,
                     blocks, s);
}
