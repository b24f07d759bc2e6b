// K8: the s8 x s8 -> s32 matrix product of the `int8` policy.
//
// Replaces: vit_deep_radiomics_tpu/ops/quant.py::int8_matmul_pallas
// (`_s8_matmul_kernel`, the Pallas TPU kernel of the same contraction that
// the JAX package's `int8_dot_prequant` computes with an XLA dot_general).
//
// Computes out[m, n] = sum_k x[m, k] * w[n, k] exactly in int32, for
// x (M, K) int8 row-major and w (N, K) int8 row-major (the layout of a
// torch Linear weight; the "col" operand of the tensor-core instruction),
// out (M, N) int32. M, N and K are multiples of 128 (the wrapper checks;
// JAX's contract), so no tile is ragged. |acc| <= 127^2 * K stays far
// inside int32 for the backbone's K <= 3072.
//
// What bounds it on an H100 SXM (3.35 TB/s, 1979 TOP/s int8): at the
// main path's largest call, 16384 x 768 by 3072 x 768 (the MLP's first
// layer at batch 4), the product is 77.3 GOP (0.039 ms at the int8 peak)
// against 215 MB of compulsory traffic, the int32 output mostly (0.064 ms):
// bytes bound it. The int32 output (4 bytes per element, against 2 for a
// bf16 product) is the contract of the function.
//
// What the design does about it: 128 x 128 output tiles per block of 8
// warps (each warp 64 x 32), K in 64-byte slabs staged in shared memory
// by cp.async with two stages, so the next slab loads while the tensor
// cores run mma.sync.m16n8k32 (s8 in, s32 accumulate) on this one; each
// operand byte is read from device memory once per output tile row or
// column. Rows of the staged slabs are padded to 80 bytes, so the
// fragment loads of the 8 rows of an mma group hit 32 distinct banks.
// A first version: wgmma and TMA come later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;  // block tile (bytes of K)
constexpr int kLD = kBK + 16;                  // padded smem row, bytes
constexpr int kThreads = 256;                  // 8 warps: 2 (M) x 4 (N)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D = A(16x32, row) * B(32x8, col) + C, s8 inputs, s32 accumulate.
// Fragments (PTX ISA, mma.m16n8k32 with .s8), lane = 4*g + c:
//   A: a0 = (g, 4c..4c+3), a1 = (g+8, 4c..), a2 = (g, 16+4c..),
//      a3 = (g+8, 16+4c..)
//   B: b0 = (k 4c..4c+3, n g), b1 = (k 16+4c.., n g)
//   C: c0,c1 = (g, 2c..2c+1), c2,c3 = (g+8, 2c..2c+1)
__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One K slab of both operands into shared memory: 128 rows x 64 bytes
// each, 16 bytes per cp.async, 2 + 2 copies per thread.
__device__ __forceinline__ void load_slab(const int8_t* x, const int8_t* w,
                                          int K, int m0, int n0, int k0,
                                          int8_t* as, int8_t* bs) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads;  // 0..511
    const int r = idx / (kBK / 16), c16 = (idx % (kBK / 16)) * 16;
    cp_async16(as + r * kLD + c16, x + (size_t)(m0 + r) * K + k0 + c16);
    cp_async16(bs + r * kLD + c16, w + (size_t)(n0 + r) * K + k0 + c16);
  }
}

__global__ void __launch_bounds__(kThreads)
    s8_matmul_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w, int32_t* __restrict__ out,
                     int N, int K) {
  __shared__ __align__(16) int8_t as[2][kBM * kLD];
  __shared__ __align__(16) int8_t bs[2][kBN * kLD];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int n_slabs = K / kBK;
  load_slab(x, w, K, m0, n0, 0, as[0], bs[0]);
  cp_async_commit();
  for (int t = 0; t < n_slabs; ++t) {
    if (t + 1 < n_slabs) {
      load_slab(x, w, K, m0, n0, (t + 1) * kBK, as[(t + 1) & 1],
                bs[(t + 1) & 1]);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* a_s = as[t & 1];
    const int8_t* b_s = bs[t & 1];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* br = b_s + (wn + j * 8 + g) * kLD + ks + 4 * c;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(br);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(br + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* ar = a_s + (wm + i * 16 + g) * kLD + ks + 4 * c;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(ar);
        af[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * kLD);
        af[2] = *reinterpret_cast<const uint32_t*>(ar + 16);
        af[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * kLD + 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8_16832(acc[i][j], af, bf[j]);
      }
    }
    __syncthreads();  // the slab is overwritten by the load after next
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + wm + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + 2 * c;
      *reinterpret_cast<int2*>(out + (size_t)r * N + col) =
          make_int2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<int2*>(out + (size_t)(r + 8) * N + col) =
          make_int2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

}  // namespace

extern "C" {

const char* vdr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (M, N) int32 = x (M, K) int8 @ w (N, K)^T int8. Returns 0 on
// success, a cudaError_t after a failed launch, or cudaErrorInvalidValue
// for a shape that is not a multiple of the 128 x 128 x 64 tiles.
int vdr_int8_matmul(const void* x, const void* w, void* out, int M, int N,
                    int K, void* stream) {
  if (M % kBM || N % kBN || K % kBK || M <= 0 || N <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(N / kBN, M / kBM);
  s8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
