// K7: fused LayerNorm -> MLP -> residual, the second half of a ViT block.
//
// Replaces: vit_deep_radiomics_tpu/ops/mlp_fused.py::fused_ln_mlp_residual
// (`_kernel`, the Pallas TPU kernel behind VDR_FUSED_MLP=1).
//
// Computes, per row of x (rows, C):
//   y   = LN(x) with fp32 statistics, rounded to x's type
//   h   = y . w1^T + b1             (fp32 accumulator, fp32 bias)
//   g   = gelu_tanh(h) in fp32, rounded to x's type
//   o   = g . w2^T + b2             (fp32 accumulator), rounded to x's type
//   o   = o * ls                    (x's type; only with a layerscale)
//   out = x + o                     (x's type)
// the cast points of the JAX kernel. w1 is (H, C) and w2 (C, H), the
// layouts of torch Linear weights; LN scale/bias and b1/b2 are fp32.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at SAM
// ViT-B/16's rows at batch 4 (16384 x 768, hidden 3072) it does 154.6
// GFLOP (0.156 ms at the bf16 peak) against 59 MB of compulsory traffic
// (x in, out, both weights once: 0.018 ms): operations bound it.
//
// What the design does about it: the (rows, H) hidden activation never
// leaves the chip. A block takes 32 rows, normalises them once into shared
// memory, then walks the hidden dimension in chunks of 32: the chunk's w1
// rows and w2 columns are staged in shared memory, h = y . w1 runs on the
// tensor cores (mma.sync.m16n8k16, bf16 in, fp32 accumulate; one 16 x 8
// tile per warp), the GELU'd chunk goes back to shared memory in bf16, and
// o += g . w2 accumulates in registers. The (32 x C) fp32 output
// accumulator is split over the 8 warps by output column (C / 8 columns
// each: 96 registers a thread at C = 768), the design constraint of the
// kernel. The staged tiles take 163 KB at C = 768, above 48 KB, so the
// block opts in and that call's error is returned. fp32 inputs (the JAX
// tests' type; not on the card's main path) run the same schedule on the
// CUDA cores with 16-row blocks and 16-wide chunks. First version: the
// weight chunks load synchronously and every block re-reads all of w1 and
// w2 from L2; a load pipeline comes later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct MlpParams {
  const void* x;          // (rows, C)
  const float* ln_scale;  // (C,)
  const float* ln_bias;   // (C,)
  const void* w1;         // (H, C)
  const float* b1;        // (H,)
  const void* w2;         // (C, H)
  const float* b2;        // (C,)
  const void* ls;         // (C,) or nullptr
  void* out;              // (rows, C)
  int rows, H;
  float eps;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// round to T and back: the cast points of the JAX kernel
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

// JAX's tanh GELU: x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;
  const float inner = k * (x + 0.044715f * (x * x * x));
  return x * (0.5f * (1.f + tanhf(inner)));
}

// LayerNorm of `nrows` rows starting at row0 into ys (row stride ld),
// rounded to T; one warp per row, rows past p.rows are zero.
template <typename T, int C>
__device__ void layer_norm_rows(const MlpParams& p, int row0, int nrows,
                                T* ys, int ld) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const T* x = static_cast<const T*>(p.x);
  for (int r = warp; r < nrows; r += nwarps) {
    const int row = row0 + r;
    T* dst = ys + r * ld;
    if (row >= p.rows) {
      for (int c = lane; c < C; c += 32) dst[c] = from_f32<T>(0.f);
      continue;
    }
    const T* src = x + (size_t)row * C;
    float v[C / 32];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      v[i] = to_f32(src[lane + 32 * i]);
      sum += v[i];
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / C;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const float d = v[i] - mean;
      sq += d * d;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float inv = 1.f / sqrtf(sq / C + p.eps);
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      dst[c] = from_f32<T>((v[i] - mean) * inv * p.ln_scale[c] +
                           p.ln_bias[c]);
    }
  }
}

// Epilogue of one output element: o = T(acc + b2), * ls, + x.
template <typename T>
__device__ __forceinline__ T finish(const MlpParams& p, int row, int col,
                                    float acc, int C) {
  float o = rnd<T>(acc + p.b2[col]);
  if (p.ls != nullptr) o = rnd<T>(o * to_f32(static_cast<const T*>(p.ls)[col]));
  const float xv = to_f32(static_cast<const T*>(p.x)[(size_t)row * C + col]);
  return from_f32<T>(xv + o);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kRows = 32, kChunk = 32, kThreads = 256;

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int C>
struct Bf16Layout {
  static constexpr int LDY = C + 8;        // ys and w1s row (elements)
  static constexpr int LDW2 = kChunk + 8;  // w2s row
  static constexpr int LDG = kChunk + 8;   // gs row
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) *
      ((size_t)kRows * LDY + (size_t)kChunk * LDY + (size_t)C * LDW2 +
       (size_t)kRows * LDG);
};

// Fragments (PTX ISA, mma.m16n8k16 .bf16), lane = 4*g + c:
//   A (16x16): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..), a2 = (g, 2c+8..),
//              a3 = (g+8, 2c+8..)
//   B (16x8):  b0 = (k 2c..2c+1, n g), b1 = (k 2c+8..2c+9, n g)
//   C (16x8):  c0,c1 = (g, 2c..2c+1), c2,c3 = (g+8, 2c..2c+1)
template <int C>
__global__ void __launch_bounds__(kThreads)
    mlp_bf16_kernel(MlpParams p) {
  using L = Bf16Layout<C>;
  constexpr int NT = C / 64;  // output n8 tiles per warp (C / 8 columns)
  extern __shared__ __align__(16) char smem_raw[];
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* w1s = ys + kRows * L::LDY;
  __nv_bfloat16* w2s = w1s + kChunk * L::LDY;
  __nv_bfloat16* gs = w2s + C * L::LDW2;
  const __nv_bfloat16* w1 = static_cast<const __nv_bfloat16*>(p.w1);
  const __nv_bfloat16* w2 = static_cast<const __nv_bfloat16*>(p.w2);

  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  layer_norm_rows<__nv_bfloat16, C>(p, row0, kRows, ys, L::LDY);

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const int hm = warp / 4, hn = warp % 4;  // this warp's h tile
  const int ocol0 = warp * (C / 8);        // this warp's output columns

  for (int h0 = 0; h0 < p.H; h0 += kChunk) {
    __syncthreads();  // ys ready (first pass); w1s/w2s/gs free (later)
    // w1 rows h0..h0+31 (contiguous), w2 columns h0..h0+31 of every row
    for (int i = threadIdx.x; i < kChunk * (C / 8); i += kThreads) {
      const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
      *reinterpret_cast<uint4*>(w1s + r * L::LDY + c8) =
          *reinterpret_cast<const uint4*>(w1 + (size_t)(h0 + r) * C + c8);
    }
    for (int i = threadIdx.x; i < C * (kChunk / 8); i += kThreads) {
      const int r = i / (kChunk / 8), c8 = (i % (kChunk / 8)) * 8;
      *reinterpret_cast<uint4*>(w2s + r * L::LDW2 + c8) =
          *reinterpret_cast<const uint4*>(w2 + (size_t)r * p.H + h0 + c8);
    }
    __syncthreads();
    // h tile (16 rows x 8 hidden units) over the full C
    float h[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int k0 = 0; k0 < C; k0 += 16) {
      const __nv_bfloat16* ar = ys + (hm * 16 + g) * L::LDY + k0 + 2 * c;
      const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * L::LDY), ld32(ar + 8),
                             ld32(ar + 8 * L::LDY + 8)};
      const __nv_bfloat16* br = w1s + (hn * 8 + g) * L::LDY + k0 + 2 * c;
      const uint32_t b[2] = {ld32(br), ld32(br + 8)};
      mma_bf16_16816(h, a, b);
    }
    {
      const int col = hn * 8 + 2 * c;
      const float bb0 = p.b1[h0 + col], bb1 = p.b1[h0 + col + 1];
      __nv_bfloat16* g0 = gs + (hm * 16 + g) * L::LDG + col;
      *reinterpret_cast<__nv_bfloat162*>(g0) = __floats2bfloat162_rn(
          gelu_tanh(h[0] + bb0), gelu_tanh(h[1] + bb1));
      *reinterpret_cast<__nv_bfloat162*>(g0 + 8 * L::LDG) =
          __floats2bfloat162_rn(gelu_tanh(h[2] + bb0),
                                gelu_tanh(h[3] + bb1));
    }
    __syncthreads();
    // acc += g (32 x 32) . w2 chunk, this warp's C / 8 columns
#pragma unroll
    for (int ks = 0; ks < kChunk; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* ar = gs + (i * 16 + g) * L::LDG + ks + 2 * c;
        a[i][0] = ld32(ar);
        a[i][1] = ld32(ar + 8 * L::LDG);
        a[i][2] = ld32(ar + 8);
        a[i][3] = ld32(ar + 8 * L::LDG + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* br =
            w2s + (ocol0 + j * 8 + g) * L::LDW2 + ks + 2 * c;
        const uint32_t b[2] = {ld32(br), ld32(br + 8)};
        mma_bf16_16816(acc[0][j], a[0], b);
        mma_bf16_16816(acc[1][j], a[1], b);
      }
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + i * 16 + g + 8 * half;
      if (row >= p.rows) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = ocol0 + j * 8 + 2 * c;
        __nv_bfloat162 v;
        v.x = finish<__nv_bfloat16>(p, row, col, acc[i][j][2 * half], C);
        v.y = finish<__nv_bfloat16>(p, row, col + 1, acc[i][j][2 * half + 1],
                                    C);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * C + col) = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, 16 rows per block, 16-wide hidden chunks
// ---------------------------------------------------------------------------

constexpr int kRowsF = 16, kChunkF = 16;

template <int C>
struct F32Layout {
  static constexpr int LDW1 = C + 1;  // odd stride: the 16 w1 rows a warp
                                      // reads at once sit on distinct banks
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)kRowsF * C + (size_t)kChunkF * LDW1 +
                       (size_t)kChunkF * C + (size_t)kRowsF * kChunkF);
};

template <int C>
__global__ void __launch_bounds__(kThreads) mlp_f32_kernel(MlpParams p) {
  constexpr int CPT = (C + kThreads - 1) / kThreads;  // columns per thread
  extern __shared__ __align__(16) char smem_raw[];
  float* ys = reinterpret_cast<float*>(smem_raw);  // [row][C]
  float* w1s = ys + kRowsF * C;                    // [hidden][LDW1]
  float* w2s = w1s + kChunkF * F32Layout<C>::LDW1;  // [hidden][C] (w2^T)
  float* gs = w2s + kChunkF * C;                   // [row][hidden]
  const float* w1 = static_cast<const float*>(p.w1);
  const float* w2 = static_cast<const float*>(p.w2);
  const int row0 = blockIdx.x * kRowsF;
  layer_norm_rows<float, C>(p, row0, kRowsF, ys, C);

  float acc[kRowsF][CPT];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;
  const int hr = threadIdx.x / kChunkF, hc = threadIdx.x % kChunkF;

  for (int h0 = 0; h0 < p.H; h0 += kChunkF) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunkF * C; i += kThreads) {
      const int r = i / C, col = i % C;
      w1s[r * F32Layout<C>::LDW1 + col] = w1[(size_t)(h0 + r) * C + col];
    }
    for (int i = threadIdx.x; i < C * kChunkF; i += kThreads) {
      const int n = i / kChunkF, k = i % kChunkF;
      w2s[k * C + n] = w2[(size_t)n * p.H + h0 + k];
    }
    __syncthreads();
    float hv = 0.f;
    for (int k = 0; k < C; ++k) hv = fmaf(ys[hr * C + k], w1s[hc * F32Layout<C>::LDW1 + k], hv);
    gs[hr * kChunkF + hc] = gelu_tanh(hv + p.b1[h0 + hc]);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunkF; ++k) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = threadIdx.x + j * kThreads;
        if (col < C) {
          const float w = w2s[k * C + col];
#pragma unroll
          for (int r = 0; r < kRowsF; ++r)
            acc[r][j] = fmaf(gs[r * kChunkF + k], w, acc[r][j]);
        }
      }
    }
  }
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    const int row = row0 + r;
    if (row >= p.rows) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = threadIdx.x + j * kThreads;
      if (col < C) out[(size_t)row * C + col] = finish<float>(p, row, col,
                                                              acc[r][j], C);
    }
  }
}

template <int C>
int launch(const MlpParams& p, int dtype, cudaStream_t stream) {
  if (dtype != 0) {
    if (p.H % kChunk) return (int)cudaErrorInvalidValue;
    const size_t smem = Bf16Layout<C>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        mlp_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_bf16_kernel<C><<<(p.rows + kRows - 1) / kRows, kThreads, smem,
                         stream>>>(p);
  } else {
    if (p.H % kChunkF) return (int)cudaErrorInvalidValue;
    const size_t smem = F32Layout<C>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        mlp_f32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_f32_kernel<C><<<(p.rows + kRowsF - 1) / kRowsF, kThreads, smem,
                        stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vdr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns 0 on success, a cudaError_t after a failed launch, or -1 for a
// width C without a build (384, 768 and 1024 are built). dtype: 0 = fp32,
// 1 = bf16. H must be a multiple of 32 (bf16) or 16 (fp32).
int vdr_fused_ln_mlp_residual(const void* x, const float* ln_scale,
                              const float* ln_bias, const void* w1,
                              const float* b1, const void* w2,
                              const float* b2, const void* ls, void* out,
                              int rows, int C, int H, float eps, int dtype,
                              void* stream) {
  const MlpParams p{x, ln_scale, ln_bias, w1, b1, w2, b2, ls, out, rows, H,
                    eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 384: return launch<384>(p, dtype, s);
    case 768: return launch<768>(p, dtype, s);
    case 1024: return launch<1024>(p, dtype, s);
    default: return -1;
  }
}

}  // extern "C"
