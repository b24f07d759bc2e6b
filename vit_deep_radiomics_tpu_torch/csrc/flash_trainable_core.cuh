// Shared core of K6, the generic trainable flash attention of `parity`
// fine-tuning: forward with the lse residual (flash_attention_fwd.cu), dq
// with both bias gradients (flash_attention_bwd_dq.cu), and dk/dv
// (flash_attention_bwd_dkv.cu), over per-head fp32 q, k, v (B, H, S, D),
// D = 64, with an optional decomposed bias bias_h (B, H, S, kh), bias_w
// (B, H, S, kw) (kh * kw == S, any kw) or an optional kv_len (B,) padding
// mask.
//
// The score, in log2 units, is rebuilt by every kernel exactly as the
// forward built it:
//     s = (dot_lo + dot_hi) + (bias_h[i, j / kw] * log2e + bias_w[i, j % kw] * log2e)
// with q pre-multiplied by D^-1/2 * log2(e) (one rounding), dot_lo the
// sequential FMA chain over head dims 0..31 and dot_hi over 32..63. The two
// halves live in the two lanes of a lane pair and are joined by one
// shuffle; the other products and sums are written with __fmul_rn /
// __fadd_rn, which nvcc never contracts into an FMA. So exp2(s - lse) in
// the backward is the forward's P, and keys j >= kv_len get P = 0 (the
// kv_len mask at -1e30 of the JAX kernels).
//
// Everything is fp32 on the CUDA cores (FMA): `parity` must not round to
// TF32, which the tensor cores' fp32 path does. No result crosses blocks
// and no atomics are used: each output element is written by one thread
// after a sum in a fixed order, so two runs give the same bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vdr {
namespace k6 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;
constexpr int D = 64;         // the one head dim built
constexpr int HD = D / 2;     // head dims per lane of a pair
constexpr int LDS = D + 4;    // shared row: [dims 0..31][4 pad][dims 32..63]
constexpr int ROWS = 64;      // query rows (forward, dq) or keys (dkv) a block
constexpr int TILE = 64;      // keys (forward, dq) or queries (dkv) a tile
constexpr int THREADS = 2 * ROWS;
constexpr int BS = ROWS + 1;  // row stride of [term][row] staging

struct Params {
  const float* q;        // (B, H, S, D)
  const float* k;        // (B, H, S, D)
  const float* v;        // (B, H, S, D)
  const float* bias_h;   // (B, H, S, kh) or nullptr
  const float* bias_w;   // (B, H, S, kw) or nullptr
  const int* kv_len;     // (B,) or nullptr
  const float* dout;     // (B, H, S, D)  backward
  const float* lse;      // (B, H, S)     backward: log2 log-sum-exp
  const float* delta;    // (B, H, S)     backward: sum_d dO * O
  float* out;            // (B, H, S, D)  forward
  float* lse_out;        // (B, H, S)     forward
  float* dq;             // (B, H, S, D)
  float* dk;             // (B, H, S, D)
  float* dv;             // (B, H, S, D)
  float* dbh;            // (B, H, S, kh) or nullptr
  float* dbw;            // (B, H, S, kw) or nullptr
  int B, H, S, kh, kw;
  float scale;           // D^-1/2
  float scale_log2;      // D^-1/2 * log2(e)
};

// Shared-memory column of this lane's half: the 4-word pad puts the two
// halves of a row on distinct banks.
__device__ __forceinline__ int half_col(int half) { return half * (HD + 4); }

__device__ __forceinline__ int valid_keys(const Params& p, int b) {
  return p.kv_len != nullptr ? min(p.S, max(p.kv_len[b], 0)) : p.S;
}

// Copy `rows` rows of D fp32 (row stride D) into a padded shared tile
// [nalloc][LDS], zero past `rows`; kScale multiplies each value by s with
// one rounding (the forward's pre-scaled q).
template <bool kScale>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int rows, int nalloc, float s) {
  for (int i = threadIdx.x; i < nalloc * (D / 4); i += blockDim.x) {
    const int r = i / (D / 4), d4 = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      x = *reinterpret_cast<const float4*>(src + (size_t)r * D + d4);
      if (kScale) {
        x.x = __fmul_rn(x.x, s);
        x.y = __fmul_rn(x.y, s);
        x.z = __fmul_rn(x.z, s);
        x.w = __fmul_rn(x.w, s);
      }
    }
    *reinterpret_cast<float4*>(dst + r * LDS + d4 + (d4 >= HD ? 4 : 0)) = x;
  }
}

// This lane's half of a row, from global memory into registers.
template <bool kScale>
__device__ __forceinline__ void load_half(float (&dst)[HD], const float* row,
                                          bool valid, float s) {
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) x = reinterpret_cast<const float4*>(row)[i];
    if (kScale) {
      x.x = __fmul_rn(x.x, s);
      x.y = __fmul_rn(x.y, s);
      x.z = __fmul_rn(x.z, s);
      x.w = __fmul_rn(x.w, s);
    }
    dst[4 * i] = x.x;
    dst[4 * i + 1] = x.y;
    dst[4 * i + 2] = x.z;
    dst[4 * i + 3] = x.w;
  }
}

__device__ __forceinline__ void store_half(float* row, const float (&src)[HD],
                                           float s) {
#pragma unroll
  for (int i = 0; i < HD / 4; ++i)
    reinterpret_cast<float4*>(row)[i] =
        make_float4(src[4 * i] * s, src[4 * i + 1] * s, src[4 * i + 2] * s,
                    src[4 * i + 3] * s);
}

// One lane's half of a dot product: the sequential FMA chain over its 32
// dims, a in registers, b a 16-byte aligned shared half row.
__device__ __forceinline__ float half_dot(const float (&a)[HD],
                                          const float* b) {
  float acc = 0.f;
  const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) {
    const float4 x = b4[i];
    acc = fmaf(a[4 * i], x.x, acc);
    acc = fmaf(a[4 * i + 1], x.y, acc);
    acc = fmaf(a[4 * i + 2], x.z, acc);
    acc = fmaf(a[4 * i + 3], x.w, acc);
  }
  return acc;
}

// acc += w * b over this lane's 32 dims (b a shared half row).
__device__ __forceinline__ void half_axpy(float (&acc)[HD], float w,
                                          const float* b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) {
    const float4 x = b4[i];
    acc[4 * i] = fmaf(w, x.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(w, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(w, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(w, x.w, acc[4 * i + 3]);
  }
}

// The whole dot product from the two halves of a lane pair (lo + hi and
// hi + lo are the same IEEE sum). Every lane of the warp must call it.
__device__ __forceinline__ float join(float part) {
  return __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 1));
}

// The score with its bias terms (each already times log2(e)).
__device__ __forceinline__ float with_bias(float dot, float th, float tw) {
  return __fadd_rn(dot, __fadd_rn(th, tw));
}

// A bias value as every kernel stages it.
__device__ __forceinline__ float bias_log2(float x) {
  return __fmul_rn(x, kLog2e);
}

// Stage the bias terms of query rows [row0, row0 + ROWS) as [term][row]
// (stride BS): term t < kh the grid-row term, kh + c the grid-column term.
__device__ __forceinline__ void stage_bias_rows(const Params& p, size_t bh,
                                                int row0, float* bias_s) {
  const int nrows = min(ROWS, p.S - row0);
  const float* bhp = p.bias_h + (bh * p.S + row0) * p.kh;
  const float* bwp = p.bias_w + (bh * p.S + row0) * p.kw;
  for (int i = threadIdx.x; i < ROWS * p.kh; i += blockDim.x) {
    const int r = i / p.kh, t = i % p.kh;
    bias_s[t * BS + r] = r < nrows ? bias_log2(bhp[i]) : 0.f;
  }
  for (int i = threadIdx.x; i < ROWS * p.kw; i += blockDim.x) {
    const int r = i / p.kw, t = i % p.kw;
    bias_s[(p.kh + t) * BS + r] = r < nrows ? bias_log2(bwp[i]) : 0.f;
  }
}

inline const char* error_string(int err) {
  if (err == -1) return "head dim has no kernel build (D=64 only)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch over (ceil(S / ROWS), H, B) blocks of THREADS threads. Returns the
// CUDA error of the attribute call or of the launch (0 on success).
template <typename Kernel>
int launch(Kernel kernel, const Params& p, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + ROWS - 1) / ROWS, p.H, p.B);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace k6
}  // namespace vdr
