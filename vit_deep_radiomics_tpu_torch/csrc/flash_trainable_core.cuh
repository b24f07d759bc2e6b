// Shared core of K6's fp32 build, the generic trainable flash attention of
// `parity` fine-tuning: forward with the lse residual
// (flash_attention_fwd.cu, on the register-tiled body of
// f32_tiled_forward.cuh), dq with both bias gradients
// (flash_attention_bwd_dq.cu), and dk/dv (flash_attention_bwd_dkv.cu),
// over per-head fp32 q, k, v (B, H, S, D), D = 64, with an optional
// decomposed bias bias_h (B, H, S, kh), bias_w (B, H, S, kw) (kh * kw ==
// S, any kw) or an optional kv_len (B,) padding mask. The same three
// sources build K6 on bf16 operands (`fast` fine-tuning where no fused
// kernel takes a grid) from the mma.sync bodies of
// flash_trainable_bf16.cuh.
//
// The score, in log2 units, is rebuilt by every kernel exactly as the
// forward built it:
//     s = (dot_lo + dot_hi) + (bias_h[i, j / kw] * log2e + bias_w[i, j % kw] * log2e)
// with q pre-multiplied by D^-1/2 * log2(e) (one rounding), dot_lo the
// sequential FMA chain over head dims 0..31 and dot_hi over 32..63, joined
// by one __fadd_rn, both chains in one thread (bwd::score_tile, which the
// forward's tiled body calls too). The other products and sums are written
// with __fmul_rn / __fadd_rn, which nvcc never contracts into an FMA. So
// exp2(s - lse) in the backward is the forward's P. Keys j >= kv_len score
// -1e30, the JAX kernels' mask value: P = 0, except on a row whose kv_len
// is 0, where every key scores -1e30, the lse is -1e30 and P = 1 (the
// plain version and JAX).
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
constexpr int HD = D / 2;     // head dims of one score chain
constexpr int ROWS = 64;      // query rows (forward, dq) or keys (dkv) a block

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

__device__ __forceinline__ int valid_keys(const Params& p, int b) {
  return p.kv_len != nullptr ? min(p.S, max(p.kv_len[b], 0)) : p.S;
}

// The score with its bias terms (each already times log2(e)).
__device__ __forceinline__ float with_bias(float dot, float th, float tw) {
  return __fadd_rn(dot, __fadd_rn(th, tw));
}

// A bias value as every kernel stages it.
__device__ __forceinline__ float bias_log2(float x) {
  return __fmul_rn(x, kLog2e);
}

inline const char* error_string(int err) {
  if (err == -1) return "head dim has no kernel build (D=64 only)";
  if (err == -2) return "bias grid of more than 320 terms (Kh + Kw) in bf16";
  if (err == -3) return "cuTensorMapEncodeTiled failed";
  if (err == -4)
    return "bias_w not 16-byte aligned (the bf16 K6 dkv's bulk copy at Kw 2 "
           "mod 4)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ---------------------------------------------------------------------------
// The backward's register-tiled core (flash_attention_bwd_dkv.cu and
// flash_attention_bwd_dq.cu). A block of NT threads owns ROWS rows (keys in
// dkv, queries in dq) and walks the other side in tiles of kCols columns,
// staged by cp.async in padded rows of LD floats. Thread t = 8 ty + tx
// computes the scores of rows ty + 16 i (i < 4) against columns tx + 8 j,
// and accumulates rows 4 ty .. 4 ty + 3, dims 4 tx .. 4 tx + 3 and
// 32 + 4 tx .. 35 + 4 tx of the products. Within a warp these reads hit 4
// (rows) and 8 (columns) distinct 16-byte words on distinct banks.
namespace bwd {

constexpr int NT = 128;          // threads a block
constexpr int TX = 8;            // threads along a tile's columns
constexpr int TY = NT / TX;      // threads along the block's rows
constexpr int TR = ROWS / TY;    // score rows a thread
constexpr int LD = D + 4;        // row stride of a staged (row, D) tile
constexpr int LP = ROWS + 4;     // row stride of a [column][row] P or dS tile
constexpr float kPastS = -2e30f; // score of a key past S: P = 0 even on a
                                 // kv_len 0 row, whose lse is -1e30

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying R rows of D fp32 (row stride D) into dst [R][LD]; rows
// at or past n are zero-filled.
template <int R>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int n) {
  for (int i = threadIdx.x; i < R * (D / 4); i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    cp_async16(dst + r * LD + c, src + (size_t)(r < n ? r : 0) * D + c,
               r < n);
  }
}

// Start copying R fp32 values into dst, zero at or past n.
template <int R>
__device__ __forceinline__ void copy_vec(float* dst, const float* src,
                                         int n) {
  for (int i = threadIdx.x; i < R; i += NT)
    cp_async4(dst + i, src + (i < n ? i : 0), i < n);
}

// acc[i][j] = the sequential FMA chain over dims [D0, D0 + N) of row
// ty + TY i of a and row tx + TX j of b (both [rows][LD]), from 0.
template <int D0, int N, int TC>
__device__ __forceinline__ void chain(float (&acc)[TR][TC], const float* a,
                                      const float* b) {
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
#pragma unroll 4   // unrolled fully, dkv's loads run ahead into a spill
  for (int d = D0; d < D0 + N; d += 4) {
    float4 x[TR], y[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i) x[i] = ld4(a + (ty + TY * i) * LD + d);
#pragma unroll
    for (int j = 0; j < TC; ++j) y[j] = ld4(b + (tx + TX * j) * LD + d);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// The forward's dot products of a micro-tile (one of a and b pre-scaled q,
// the other k): the chains over dims 0..31 and 32..63, joined by one
// __fadd_rn. fmaf(k, q, c) and fmaf(q, k, c) are the same IEEE operation.
template <int TC>
__device__ __forceinline__ void score_tile(float (&s)[TR][TC],
                                           const float* a, const float* b) {
  float hi[TR][TC];
  chain<0, HD>(s, a, b);
  chain<HD, HD>(hi, a, b);
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) s[i][j] = __fadd_rn(s[i][j], hi[i][j]);
}

// dP of a micro-tile (dO against v), one chain over all dims.
template <int TC>
__device__ __forceinline__ void dp_tile(float (&dp)[TR][TC], const float* a,
                                        const float* b) {
  chain<0, D>(dp, a, b);
}

// Store a thread's micro-tile x as the [column][row] tile dst (stride LP).
template <int TC>
__device__ __forceinline__ void store_cols(float* dst,
                                           const float (&x)[TR][TC]) {
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) dst[(tx + TX * j) * LP + ty + TY * i] = x[i][j];
}

// acc[i][4 h + e] += sum over the KC columns c of x[c][4 ty + i] *
// y[c][4 tx + 32 h + e]: x a [column][row] tile (stride LP), y a staged
// (column, D) tile (stride LD).
template <int KC>
__device__ __forceinline__ void accumulate(float (&acc)[4][8],
                                           const float* x, const float* y) {
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
#pragma unroll 8
  for (int c = 0; c < KC; ++c) {
    const float4 a = ld4(x + c * LP + 4 * ty);
    const float4 b0 = ld4(y + c * LD + 4 * tx);
    const float4 b1 = ld4(y + c * LD + 32 + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(av[i], bv[e], acc[i][e]);
  }
}

// Write rows 4 ty + i (< n) of a (rows, D) output at out, times s.
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[4][8], int n,
                                           float s) {
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= n) continue;
    *reinterpret_cast<float4*>(out + (size_t)r * D + 4 * tx) = make_float4(
        acc[i][0] * s, acc[i][1] * s, acc[i][2] * s, acc[i][3] * s);
    *reinterpret_cast<float4*>(out + (size_t)r * D + 32 + 4 * tx) =
        make_float4(acc[i][4] * s, acc[i][5] * s, acc[i][6] * s,
                    acc[i][7] * s);
  }
}

// Launch over (ceil(S / ROWS), H, B) blocks of NT threads; the CUDA error
// of the attribute call or of the launch (0 on success).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Params& p, size_t smem, void* stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + ROWS - 1) / ROWS, p.H, p.B);
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(p, args...);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace k6
}  // namespace vdr
