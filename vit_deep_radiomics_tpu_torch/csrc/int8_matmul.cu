// K8: the s8 x s8 -> s32 matrix product of the `int8` policy.
//
// Replaces: vit_deep_radiomics_tpu/ops/quant.py::int8_matmul_pallas
// (`_s8_matmul_kernel`, the Pallas TPU kernel of the same contraction that
// the JAX package's `int8_dot_prequant` computes with an XLA dot_general).
//
// Computes out[m, n] = sum_k x[m, k] * w[n, k] exactly in int32, for
// x (M, K) int8 row-major and w (N, K) int8 row-major (the layout of a
// torch Linear weight), out (M, N) int32. M, N and K are multiples of 128
// (the wrapper checks; JAX's contract). |acc| <= 127^2 * K stays far inside
// int32 for the backbone's K <= 3072.
//
// What bounds it on an H100 SXM (3.35 TB/s, 1979 TOP/s int8): at the
// main path's largest call, 16384 x 768 by 3072 x 768 (the MLP's first
// layer at batch 4), the product is 77.3 GOP (0.039 ms at the int8 peak)
// against 215 MB of compulsory traffic, the int32 output mostly (0.064 ms):
// bytes bound it. The int32 output (4 bytes per element, against 2 for a
// bf16 product) is the contract of the function. At K 768 an output tile
// has only 6 K slabs of 128 bytes of work before its store, so the store
// and its overlap with the next tile's products decide the time.
//
// What the design does about it:
//  * persistent blocks, one per SM, walk a queue of 128 x 128 output tiles
//    (the N tiles of one row block next to each other, so the blocks that
//    run at once share their x rows in L2);
//  * a producer warpgroup (one thread) loads 128-byte K slabs of x and w as
//    they lie, with the 128-byte swizzle, by TMA into a ring of kStages
//    stages on mbarriers; it runs ahead into the next tile while the
//    consumers store this one;
//  * two consumer warpgroups, 64 rows each, run
//    wgmma.mma_async.m64nNk32.s32.s8.s8 on the ring (both operands K-major
//    in shared memory, which integer wgmma requires), one group a slab in
//    flight;
//  * the epilogue stages each warpgroup's int32 tile in shared memory in
//    32-column boxes with the 128-byte swizzle (conflict-free 8-byte
//    writes) and stores it by TMA, which drains while the next tile's
//    products run; the staging is reused only after the store has read it
//    (cp.async.bulk.wait_group.read).
// One body takes every call: M and N are multiples of the tile.

#include "hopper.cuh"

namespace {
using namespace vdr::sm90;

constexpr int kBM = 128;              // rows a tile (two warpgroups of 64)
constexpr int kBN = 128;              // columns a tile (wgmma N)
constexpr int kBK = 128;              // K bytes a slab (the swizzle width)
constexpr int kStages = 5;            // ring depth
constexpr int kConsumers = kBM / 64;
constexpr int kThreads = 128 * (kConsumers + 1);  // + a producer warpgroup
constexpr int kATile = kBM * kBK;     // bytes of x a stage
constexpr int kStage = kATile + kBN * kBK;
constexpr int kBox = 64 * 128;        // one 64 x 32 int32 box of the output
constexpr int kStaging = 64 * kBN * 4;  // a warpgroup's int32 tile
constexpr size_t kSmem =
    1024 + (size_t)kStages * kStage + (size_t)kConsumers * kStaging;
constexpr int kErrTensorMap = -2;     // cuTensorMapEncodeTiled failed
static_assert(kSmem <= 227 * 1024, "K8's ring and staging exceed 227 KB");
static_assert(kBM == 128 && kBN == 128, "K8's tiles are the contract's 128");

struct Params {
  int M, N, K;
};

__global__ void __launch_bounds__(kThreads, 1)
    s8_hopper_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap tout,
                     const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(base);
  unsigned char* staging = base + kStages * kStage;

  const int tiles_n = p.N / kBN;
  const int tiles = (p.M / kBM) * tiles_n;
  const int n_slabs = p.K / kBK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int step = gridDim.x;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every load ----
    if (threadIdx.x == kConsumers * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += step) {
        const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
        for (int s = 0; s < n_slabs; ++s, ++it) {
          const int st = it % kStages;
          mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[st], kStage);
          tma_load_2d(ring + st * kStage, &tx, &full[st], s * kBK, m0);
          tma_load_2d(ring + st * kStage + kATile, &tw, &full[st], s * kBK,
                      n0);
        }
      }
    }
    return;
  }

  // ---- consumers: rows 64 wg .. 64 wg + 63 of each tile ----
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, c = lane % 4;
  const int r_lo = warp * 16 + g;  // this thread's rows in the warpgroup's
  unsigned char* stg = staging + wg * kStaging;
  int acc[kBN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += step) {
    const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
    for (int s = 0; s < n_slabs; ++s, ++it) {
      const int st = it % kStages;
      mbar_wait(&full[st], (it / kStages) & 1);
      const uint32_t a = ring + st * kStage + wg * 64 * kBK;
      const uint64_t da = desc_sw128(a, 16, 1024);
      const uint64_t db = desc_sw128(ring + st * kStage + kATile, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        WgmmaS8<kBN>::ss(acc, da + 2 * kk, db + 2 * kk, s > 0 || kk > 0);
      wgmma_commit();
      // the slab before this one is done: hand its stage back
      wgmma_wait<1>();
      if (s > 0) mbar_arrive(&empty[(it - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[(it - 1) % kStages]);

    const int row0 = m0 + wg * 64;
    // the previous tile's store has read the staging
    if (t == 0) bulk_wait_read();
    bar_sync(1 + wg, 128);
    // element (r, col): box col / 32, 16-byte chunk (col % 32) / 4 of row
    // r, stored at chunk ^ (r % 8)
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const int chunk = (i % 4) * 2 + (c >> 1);
      unsigned char* box = stg + (i / 4) * kBox + (c & 1) * 8;
      *reinterpret_cast<int2*>(box + r_lo * 128 + ((chunk ^ g) << 4)) =
          make_int2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<int2*>(box + (r_lo + 8) * 128 + ((chunk ^ g) << 4)) =
          make_int2(acc[4 * i + 2], acc[4 * i + 3]);
    }
    fence_proxy_async();
    bar_sync(1 + wg, 128);
    if (t == 0) {
      for (int j = 0; j < kBN / 32; ++j)
        tma_store_2d(&tout, smem_u32(stg + j * kBox), n0 + 32 * j, row0);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait();
}

}  // namespace

extern "C" {

const char* vdr_error_string(int err) {
  if (err == kErrTensorMap) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (M, N) int32 = x (M, K) int8 @ w (N, K)^T int8. Returns 0 on
// success, a cudaError_t after a failed launch, cudaErrorInvalidValue for
// a shape whose M, N or K is not a positive multiple of 128, or -2 when a
// TMA descriptor cannot be made.
int vdr_int8_matmul(const void* x, const void* w, void* out, int M, int N,
                    int K, void* stream) {
  if (M % 128 || N % 128 || K % 128 || M <= 0 || N <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw, tout;
  if (!tensor_map_2d_sw128(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, K, M,
                           kBK, kBM) ||
      !tensor_map_2d_sw128(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N,
                           kBK, kBN) ||
      !tensor_map_2d_sw128(&tout, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, out, N,
                           M, 32, 64))
    return kErrTensorMap;
  const cudaError_t err = cudaFuncSetAttribute(
      s8_hopper_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M / kBM) * (N / kBN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  const Params p{M, N, K};
  s8_hopper_kernel<<<grid, kThreads, kSmem,
                     static_cast<cudaStream_t>(stream)>>>(tx, tw, tout, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
