// Hopper (sm_90a) building blocks shared by the tensor-core kernels:
// 16-byte asynchronous copies into shared memory, the 128-byte swizzle,
// wgmma matrix descriptors, the warpgroup products themselves, and for the
// warp-specialised kernels mbarriers, TMA tile loads and stores, named
// barriers and setmaxnreg.
//
// Shared-memory tiles all have one shape here: rows of 128 bytes (64 bf16),
// eight rows to a 1024-byte swizzle atom, the 16-byte chunk c of row r
// stored at chunk c ^ (r % 8). A wider operand is a row of such panels.
// Tile bases are 1024-byte aligned, so the swizzle the copies write is the
// one the tensor cores read back from the address bits.
//
//   K-major operand (the reduction dim contiguous: X of X@W, Q, K):
//     rows are the M or N index, 64 reduction elements per panel; a k16
//     step advances the start address by 32 bytes inside a panel; SBO is
//     the 1024 bytes between groups of eight rows.
//   MN-major operand (the output dim contiguous: W and A of X@W, V):
//     rows are the reduction index, 64 output elements per panel; a k16
//     step advances by 16 rows (2048 bytes); SBO is the 1024 bytes between
//     groups of eight rows, LBO the stride between 64-wide panels; the
//     instruction's transpose bit says MN-major, so nothing is transposed
//     in memory.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from global to shared memory; with ok == false nothing is
// read and the 16 bytes are written as zeros (the ragged edges).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Writes through the generic proxy (cp.async, st.shared) made visible to
// the tensor cores, which read shared memory through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a panel of
// 128-byte rows, 128-byte swizzle.
__device__ __forceinline__ uint32_t swz128(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 in bits
// 62-63; base offset 0 since every tile is 1024-byte aligned.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous product (call after wgmma_wait).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of m64nNk16 (f32): thread t of the warpgroup holds, for
// i < N/2, the element (row, col) with
//   row = 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2)
//   col = 8 * (i / 4) + 2 * (t % 4) + i % 2.
__device__ __forceinline__ int acc_row(int tid, int i) {
  return 16 * (tid >> 5) + ((tid & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int tid, int i) {
  return 8 * (i >> 2) + 2 * (tid & 3) + (i & 1);
}

#define REPRO_F8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_F32 REPRO_F8(0), REPRO_F8(8), REPRO_F8(16), REPRO_F8(24)
#define REPRO_F64 \
  REPRO_F32, REPRO_F8(32), REPRO_F8(40), REPRO_F8(48), REPRO_F8(56)
#define REPRO_F96 \
  REPRO_F64, REPRO_F8(64), REPRO_F8(72), REPRO_F8(80), REPRO_F8(88)
#define REPRO_F128 \
  REPRO_F96, REPRO_F8(96), REPRO_F8(104), REPRO_F8(112), REPRO_F8(120)

#define REPRO_R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define REPRO_R16                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15}"
#define REPRO_R32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"
#define REPRO_R64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define REPRO_R96                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "    \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "    \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "    \
  "%93, %94, %95}"
#define REPRO_R128                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "    \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "    \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "    \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "    \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "   \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "   \
  "%127}"

// D (64 x N, f32) += A (64 x 16, shared, K-major) * B (16 x N, shared);
// TB = 0: B is K-major, TB = 1: B is MN-major. N = 64 or 128.
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_R32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : REPRO_F32
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// D (64 x 16 / 64 x 32, f32) += A (64 x 16, shared, K-major) * B (16 x N,
// shared): the narrow products of X @ A beside X @ W (N = 16 reads the first
// 16 columns, N = 32 the first 32, of a 64-wide MN-major panel).
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " REPRO_R8
      ", %8, %9, p, 1, 1, 0, %11;\n}\n"
      : REPRO_F8(0)
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REPRO_R16
      ", %16, %17, p, 1, 1, 0, %19;\n}\n"
      : REPRO_F8(0), REPRO_F8(8)
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// D (64 x 256, f32) += A (64 x 16, shared, K-major) * B (16 x 256, shared).
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " REPRO_R128
      ", %128, %129, p, 1, 1, 0, %131;\n}\n"
      : REPRO_F128
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// D (64 x 64, f32) = A * B, the same product without reading D first.
#define REPRO_W8(i)                                                  \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]),        \
      "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])
template <int TB>
__device__ __forceinline__ void wgmma_ss_set(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_R32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : REPRO_W8(0), REPRO_W8(8), REPRO_W8(16), REPRO_W8(24)
      : "l"(da), "l"(db), "r"(0), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_R64
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : REPRO_F64
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// D (64 x 128, f32) = A * B, without reading D first.
template <int TB>
__device__ __forceinline__ void wgmma_ss_set(float (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_R64
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : REPRO_W8(0), REPRO_W8(8), REPRO_W8(16), REPRO_W8(24), REPRO_W8(32),
        REPRO_W8(40), REPRO_W8(48), REPRO_W8(56)
      : "l"(da), "l"(db), "r"(0), "n"(TB));
}
#undef REPRO_W8

// D (64 x N, f32) += A (64 x 16, bf16 in registers, the mma fragment
// layout) * B (16 x N, shared, MN-major). N = 64, 128, 192 or 256.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " REPRO_R96
      ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : REPRO_F96
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " REPRO_R128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : REPRO_F128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 8, tf32 in registers: per warp the 16-row
// fragment of mma.sync m16n8k8, a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4)) * B (8 x 64, tf32, shared, K-major: tf32 operands
// take no transpose).
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " REPRO_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : REPRO_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef REPRO_F8
#undef REPRO_F32
#undef REPRO_F64
#undef REPRO_F96
#undef REPRO_F128
#undef REPRO_R8
#undef REPRO_R16
#undef REPRO_R32
#undef REPRO_R64
#undef REPRO_R96
#undef REPRO_R128

// Dynamic shared memory rounded up to the next 1024-byte boundary (the
// launch asks for 1 KB more than the tiles need).
__device__ __forceinline__ uint32_t smem_base_1k(const void* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// ---- mbarriers: a 64-bit word in shared memory that counts arrivals and,
// for TMA, the bytes still to land; a phase completes when both reach zero,
// and waiters poll the parity of the phase they wait for.

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the other threads and to the
// TMA unit (call once after the inits, before a block-wide barrier).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One arrival on the barrier at offset `bar` of CTA `cta` of the cluster
// (this CTA's own, or a peer's).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      :: "r"(bar), "r"(cta) : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Whether the phase of parity `parity` has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// ---- TMA: one thread asks for a box of a tensor (described by a
// CUtensorMap in kernel parameter space) to be copied into shared memory;
// the bytes are counted down on `bar`. Coordinates are in elements,
// innermost first; parts of the box outside the tensor are written as
// zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The same for a 2-D map (c0 innermost).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// The same box written into the shared memory of every CTA of the cluster
// named in `mask` (bit i: CTA rank i), at the same offset `dst`, each
// CTA's bytes counted down on its own barrier at offset `bar`.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst,
                                                      const void* map,
                                                      uint32_t bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask),
         "r"(c0), "r"(c1)
      : "memory");
}

// The reverse: a box of shared memory written to the tensor (parts of the
// box outside the tensor are not written), in a bulk group of this thread.
__device__ __forceinline__ void tma_store_4d(const void* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N bulk groups of this thread still read shared
// memory (the source may be written again)...
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// ... or are still in flight at all.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- named barriers (ids 1..15; 0 is __syncthreads): `threads` of the
// block, a multiple of 32, meet; bar_arrive counts in without waiting.
__device__ __forceinline__ void bar_sync(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t id, uint32_t threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- thread block clusters: this CTA's rank in its cluster, and a barrier
// of every thread of every CTA of the cluster (all must reach it).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---- register budgets of a warp-specialised block: a warpgroup gives up
// (dec) or takes (inc) registers; all four of its warps execute it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

}  // namespace sm90
}  // namespace repro
