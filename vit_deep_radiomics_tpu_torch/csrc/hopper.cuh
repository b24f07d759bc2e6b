// Hopper (sm_90a) building blocks shared by the port's TMA + wgmma kernels
// (K1, K2, K3, K4, the K5 backward and K7 in bf16, K8 in int8): shared-memory
// addresses, mbarriers, named barriers, TMA tensor and bulk copies, wgmma
// descriptors and instructions (bf16 with fp32 accumulators, s8 with s32),
// the cluster pieces K7's C 1536 body uses (rank, cluster barrier, remote
// mbarrier arrivals, TMA multicast, bulk copies between blocks), and the
// runtime lookup of cuTensorMapEncodeTiled (no link against libcuda) with
// the tile maps it encodes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vdr {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Without blocking: has the barrier's phase of the given parity completed?
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Thread block clusters (K7 at C 1536): this block's rank in its cluster,
// the cluster-wide barrier (every thread of every block: arrive with
// release, wait with acquire), the shared::cluster address of a
// shared-memory location in the block of another rank, and an arrival on
// an mbarrier at such an address.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}

// Named barriers among the consumer warpgroups (id 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One 64 x 64 box of a 3-D (col, row, batch) tensor map into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (tiles 1024-aligned).
// K is K-major (64 key rows of 128 bytes): SBO 1024 between 8-row groups,
// LBO unused (16). V is an MN-major operand (key rows of 64 contiguous
// head-dim values): its 64 columns are one swizzle atom wide, so only the
// 1024-byte step between 8-key groups is used; it is given as both offsets.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching wgmma operands before wgmma.wait_group:
// accumulators are not read early, A fragments stay live (their registers
// are not reused while the product reads them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[i][k])::"memory");
}

// The asm templates below number their operands: the fp32 accumulators D
// come first, %0 .. %(N/2 - 1), as the prefix VDR_R<N/2> of one list of
// placeholders, bound by VDR_D<N/2>.
#define VDR_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define VDR_F8(d, i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define VDR_F32(d, i) \
  VDR_F8(d, i), VDR_F8(d, i + 8), VDR_F8(d, i + 16), VDR_F8(d, i + 24)
#define VDR_D8(d) VDR_F8(d, 0)
#define VDR_D16(d) VDR_F8(d, 0), VDR_F8(d, 8)
#define VDR_D24(d) VDR_F8(d, 0), VDR_F8(d, 8), VDR_F8(d, 16)
#define VDR_D32(d) VDR_F32(d, 0)
#define VDR_D64(d) VDR_F32(d, 0), VDR_F32(d, 32)
#define VDR_D52(d) VDR_F32(d, 0), VDR_F8(d, 32), VDR_F8(d, 40), VDR_F4(d, 48)
#define VDR_D104(d) VDR_F32(d, 0), VDR_F32(d, 32), VDR_F32(d, 64), VDR_F8(d, 96)
#define VDR_D112(d)                                               \
  VDR_F32(d, 0), VDR_F32(d, 32), VDR_F32(d, 64), VDR_F8(d, 96), \
      VDR_F8(d, 104)
#define VDR_D128(d) VDR_F32(d, 0), VDR_F32(d, 32), VDR_F32(d, 64), VDR_F32(d, 96)
#define VDR_R8_0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define VDR_R8_1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define VDR_R8_2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define VDR_R8_3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define VDR_R8_4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define VDR_R8_5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define VDR_R8_6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define VDR_R8_7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define VDR_R8_8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define VDR_R8_9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define VDR_R8_10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define VDR_R8_11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define VDR_R8_12 "%96, %97, %98, %99, %100, %101, %102, %103"
#define VDR_R8_13 "%104, %105, %106, %107, %108, %109, %110, %111"
#define VDR_R8_14 "%112, %113, %114, %115, %116, %117, %118, %119"
#define VDR_R8_15 "%120, %121, %122, %123, %124, %125, %126, %127"
#define VDR_R8 "{" VDR_R8_0 "}"
#define VDR_R16 "{" VDR_R8_0 ", " VDR_R8_1 "}"
#define VDR_R24 "{" VDR_R8_0 ", " VDR_R8_1 ", " VDR_R8_2 "}"
#define VDR_R32 "{" VDR_R8_0 ", " VDR_R8_1 ", " VDR_R8_2 ", " VDR_R8_3 "}"
#define VDR_R64                                                         \
  "{" VDR_R8_0 ", " VDR_R8_1 ", " VDR_R8_2 ", " VDR_R8_3 ", " VDR_R8_4 \
  ", " VDR_R8_5 ", " VDR_R8_6 ", " VDR_R8_7 "}"
#define VDR_R52                                                         \
  "{" VDR_R8_0 ", " VDR_R8_1 ", " VDR_R8_2 ", " VDR_R8_3 ", " VDR_R8_4 \
  ", " VDR_R8_5 ", %48, %49, %50, %51}"
#define VDR_R104                                                           \
  "{" VDR_R8_0 ", " VDR_R8_1 ", " VDR_R8_2 ", " VDR_R8_3 ", " VDR_R8_4    \
  ", " VDR_R8_5 ", " VDR_R8_6 ", " VDR_R8_7 ", " VDR_R8_8 ", " VDR_R8_9 \
  ", " VDR_R8_10 ", " VDR_R8_11 ", " VDR_R8_12 "}"
#define VDR_R112                                                          \
  "{" VDR_R8_0 ", " VDR_R8_1 ", " VDR_R8_2 ", " VDR_R8_3 ", " VDR_R8_4   \
  ", " VDR_R8_5 ", " VDR_R8_6 ", " VDR_R8_7 ", " VDR_R8_8 ", " VDR_R8_9 \
  ", " VDR_R8_10 ", " VDR_R8_11 ", " VDR_R8_12 ", " VDR_R8_13 "}"
#define VDR_R128                                                          \
  "{" VDR_R8_0 ", " VDR_R8_1 ", " VDR_R8_2 ", " VDR_R8_3 ", " VDR_R8_4   \
  ", " VDR_R8_5 ", " VDR_R8_6 ", " VDR_R8_7 ", " VDR_R8_8 ", " VDR_R8_9 \
  ", " VDR_R8_10 ", " VDR_R8_11 ", " VDR_R8_12 ", " VDR_R8_13          \
  ", " VDR_R8_14 ", " VDR_R8_15 "}"

// Wgmma<N>: D(64xN, fp32) (+)= A(64x16) * B(16xN), bf16 in, for the widths
// the kernels use (K2 and the K5 backward: 64; K3: 48 and 64 for its
// scores, 64 for PV; K1: 64 for PV, 208 and 256 for its scores, K3's
// window mode also 224 (the first 14 grid rows of a 16 x 16 window); K4:
// 64 and 208 for its scores, 64 and 104 for dP's key chunks, 16 and 64 for
// phase B's query chunks; K7: 64 for the first product's hidden columns, 128
// for the second's output columns; the K6 bf16 dq: 16, 32, 48 and 64 for
// its key tiles).
// ss reads A and B from shared memory, both K-major; rs takes A from
// registers, with B K-major (TransB 0: K, E) or MN-major (1: V). T0 .. T6
// spell the numbers of the operands after D, %(N/2) .. %(N/2 + 6).
template <int N>
struct Wgmma;

#define VDR_WGMMA(N, R, D, T0, T1, T2, T3, T4, T5, T6)                      \
  template <>                                                               \
  struct Wgmma<N> {                                                         \
    static __device__ __forceinline__ void ss(float (&d)[N / 2],            \
                                              uint64_t da, uint64_t db,     \
                                              int accumulate) {             \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " T2 ", 0;\n"          \
                   "wgmma.mma_async.sync.aligned.m64n" #N                   \
                   "k16.f32.bf16.bf16 " R ", " T0 ", " T1                   \
                   ", p, 1, 1, 0, 0;\n}\n"                                  \
                   : D(d)                                                   \
                   : "l"(da), "l"(db), "r"(accumulate));                    \
    }                                                                       \
    template <int TransB>                                                   \
    static __device__ __forceinline__ void rs(float (&d)[N / 2],            \
                                              const uint32_t (&a)[4],       \
                                              uint64_t db, int accumulate) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " T5 ", 0;\n"          \
                   "wgmma.mma_async.sync.aligned.m64n" #N                   \
                   "k16.f32.bf16.bf16 " R ", {" T0 ", " T1 ", " T2 ", " T3  \
                   "}, " T4 ", p, 1, 1, " T6 ";\n}\n"                       \
                   : D(d)                                                   \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),   \
                     "r"(accumulate), "n"(TransB));                         \
    }                                                                       \
  };

VDR_WGMMA(16, VDR_R8, VDR_D8, "%8", "%9", "%10", "%11", "%12", "%13", "%14")
VDR_WGMMA(32, VDR_R16, VDR_D16, "%16", "%17", "%18", "%19", "%20", "%21",
          "%22")
VDR_WGMMA(48, VDR_R24, VDR_D24, "%24", "%25", "%26", "%27", "%28", "%29",
          "%30")
VDR_WGMMA(64, VDR_R32, VDR_D32, "%32", "%33", "%34", "%35", "%36", "%37",
          "%38")
VDR_WGMMA(128, VDR_R64, VDR_D64, "%64", "%65", "%66", "%67", "%68", "%69",
          "%70")
VDR_WGMMA(104, VDR_R52, VDR_D52, "%52", "%53", "%54", "%55", "%56", "%57",
          "%58")
VDR_WGMMA(208, VDR_R104, VDR_D104, "%104", "%105", "%106", "%107", "%108",
          "%109", "%110")
VDR_WGMMA(224, VDR_R112, VDR_D112, "%112", "%113", "%114", "%115", "%116",
          "%117", "%118")
VDR_WGMMA(256, VDR_R128, VDR_D128, "%128", "%129", "%130", "%131", "%132",
          "%133", "%134")

// WgmmaS8<N>: D(64xN, s32) (+)= A(64x32) * B(32xN), s8 in (K8: N 128).
// Both operands come from shared memory, K-major: integer wgmma takes no
// transpose and no scale of A or B, only the accumulate predicate. T0 ..
// T2 spell the numbers of the operands after D.
#define VDR_I8(d, i)                                                      \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),             \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define VDR_I32(d, i) \
  VDR_I8(d, i), VDR_I8(d, i + 8), VDR_I8(d, i + 16), VDR_I8(d, i + 24)
#define VDR_DI64(d) VDR_I32(d, 0), VDR_I32(d, 32)

template <int N>
struct WgmmaS8;

#define VDR_WGMMA_S8(N, R, D, T0, T1, T2)                                 \
  template <>                                                             \
  struct WgmmaS8<N> {                                                     \
    static __device__ __forceinline__ void ss(int (&d)[N / 2],            \
                                              uint64_t da, uint64_t db,   \
                                              int accumulate) {           \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " T2 ", 0;\n"       \
                   "wgmma.mma_async.sync.aligned.m64n" #N                 \
                   "k32.s32.s8.s8 " R ", " T0 ", " T1 ", p;\n}\n"          \
                   : D(d)                                                 \
                   : "l"(da), "l"(db), "r"(accumulate));                  \
    }                                                                     \
  };

VDR_WGMMA_S8(128, VDR_R64, VDR_DI64, "%64", "%65", "%66")

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One box of a 2-D (col, row) tensor map into shared memory; completion is
// counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// The same box written into the shared memory of every block of the
// cluster whose bit is set in `mask`, at the same offset, each completion
// counted on the barrier at `bar`'s offset in that block.
__device__ __forceinline__ void tma_load_2d_mc(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int col,
                                               int row, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "h"(mask)
      : "memory");
}

// `bytes` (a multiple of 16) of this block's shared memory at `src` into
// another block of the cluster: `dst` and `bar` are shared::cluster
// addresses in that block (map_rank), the completion counted on `bar`.
__device__ __forceinline__ void bulk_copy_to_rank(uint32_t dst, uint32_t src,
                                                  int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One box of shared memory out to a 2-D tensor map (a bulk group).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until every committed bulk store has read its shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// wait until every committed bulk store is done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Make this thread's ordinary shared-memory writes visible to the async
// proxy (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no link
// against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// 3-D map (width columns, rows, batches) of a row-major bf16 tensor, boxes
// of 64 columns (128 bytes: the 128-byte swizzle) x box_rows rows x one
// batch; rows past `rows` read as zeros, so a box never reads the next
// batch's rows.
inline bool tensor_map_3d(CUtensorMap* map, const void* ptr, int width,
                          int rows, int batches, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows,
                              (cuuint64_t)batches};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)rows * width * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 2-D map (width columns, rows) of a row-major tensor of `elem_bytes`-byte
// elements (bf16, int8 or int32), boxes of box_cols x box_rows with the
// 128-byte swizzle (box_cols * elem_bytes <= 128). Loads past the edges
// read zeros; stores past them are clipped.
inline bool tensor_map_2d_sw128(CUtensorMap* map, CUtensorMapDataType type,
                                int elem_bytes, const void* ptr, int width,
                                int rows, int box_cols, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The SM count of the current device (persistent grids).
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

// The 64-key tile visited at step j: in order, or (kHalves: a key grid 128
// keys wide, two tiles a grid row) the n_even even tiles first (grid
// columns 0-63), then the odd ones (64-127), so that one register set of
// bias_w columns serves each half. Used by the K5 forward and dq kernels.
template <bool kHalves>
__device__ __forceinline__ int key_tile(int j, int n_even) {
  if constexpr (kHalves) return j < n_even ? 2 * j : 2 * (j - n_even) + 1;
  return j;
}

// The same map with 64 x 64 boxes.
inline bool tensor_map_64(CUtensorMap* map, const void* ptr, int width,
                          int rows, int batches) {
  return tensor_map_3d(map, ptr, width, rows, batches, 64);
}

}  // namespace sm90
}  // namespace vdr
