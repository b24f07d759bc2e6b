// Shared pieces of the port's trainable attention kernels (K4 window
// backward, K5 dq and dkv): the gradient operands, and mma.sync fragment
// loads for bf16 m16n8k16 tiles. The score recompute reuses the forward's
// pieces in flash_attention_core.cuh (AttnParams, tile coordinates, bias
// staging, key tables), so that a recomputed score is the forward's own:
// q pre-scaled by D^-1/2 * log2(e) and rounded to bf16 once, the bias
// terms pre-multiplied by log2(e) in fp32.
//
// Backward formulas (natural units; P the softmax, O the forward output):
//     D  = sum_d dO * O        dP = dO V^T        dS = P * (dP - D)
//     dq = scale dS K          dk = scale dS^T Q   dv = P^T dO
//     dbias_h[i, r] = sum over keys j of grid row r of dS[i, j]
//     dbias_w[i, c] = sum over keys j of grid column c of dS[i, j]
// Products take bf16 operands (P and dS rounded to bf16, as the JAX
// kernels do) with fp32 accumulation; the bias gradients sum dS in fp32.
#pragma once

#include "flash_attention_core.cuh"

namespace vdr {

using bf16 = __nv_bfloat16;

struct GradParams {
  const bf16* dout;    // (B, S, H*D) upstream gradient of the output
  const bf16* out;     // (B, S, H*D) forward output (K4 only)
  const float* lse;    // (B, H, S) log2 log-sum-exp (K5 only)
  const float* delta;  // (B, H, S) D = sum_d dO * O (K5 only)
  bf16* dq;            // (B, S, H*D)
  bf16* dkv;           // (B, S, 2*H*D)
  bf16* dbh;           // (B, H, S, kh) or nullptr
  bf16* dbw;           // (B, H, S, kw) or nullptr
  float scale;         // D^-1/2
};

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 scaled in fp32 and rounded back: the forward's pre-scaled q.
__device__ __forceinline__ uint32_t ld_pair_scaled(const bf16* p, float s) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return pack_bf16(__low2float(v) * s, __high2float(v) * s);
}

// A fragment (16 x 64, four k16 steps) of a row-major bf16 matrix: this
// thread's rows r_lo and r_hi = r_lo + 8 (rows >= nrows read as zero),
// columns 2c.. of each k16 step. kScale multiplies by s in fp32 first.
template <bool kScale>
__device__ __forceinline__ void load_a64(uint32_t a[4][4], const bf16* base,
                                         size_t ld, int r_lo, int r_hi,
                                         int nrows, int c, float s) {
  auto ld2 = [&](int r, int d) -> uint32_t {
    if (r >= nrows) return 0u;
    const bf16* ptr = base + (size_t)r * ld + d;
    return kScale ? ld_pair_scaled(ptr, s) : ld_pair(ptr);
  };
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    a[kt][0] = ld2(r_lo, kt * 16 + 2 * c);
    a[kt][1] = ld2(r_hi, kt * 16 + 2 * c);
    a[kt][2] = ld2(r_lo, kt * 16 + 2 * c + 8);
    a[kt][3] = ld2(r_hi, kt * 16 + 2 * c + 8);
  }
}

// B fragment of M^T where M is row-major with the mma's n index on its
// rows (keys of K in Q K^T): p points at M[n0 + g][k0 + 2c].
__device__ __forceinline__ void ld_b_rows(uint32_t b[2], const bf16* p) {
  b[0] = ld_pair(p);
  b[1] = ld_pair(p + 8);
}

// The same with the forward's pre-scaled q: Q^T as the B operand of
// K Q^T, scaled by s in fp32 and rounded to bf16 as the forward did.
__device__ __forceinline__ void ld_b_rows_scaled(uint32_t b[2], const bf16* p,
                                                 float s) {
  b[0] = ld_pair_scaled(p, s);
  b[1] = ld_pair_scaled(p + 8, s);
}

// B fragment of a row-major M with the mma's k index on its rows (V in
// P V): p points at M[k0 + 2c][n0 + g], ld is M's row stride.
__device__ __forceinline__ void ld_b_cols(uint32_t b[2], const bf16* p,
                                          int ld) {
  __nv_bfloat162 b0, b1;
  b0.x = p[0];
  b0.y = p[ld];
  b1.x = p[8 * ld];
  b1.y = p[9 * ld];
  b[0] = *reinterpret_cast<uint32_t*>(&b0);
  b[1] = *reinterpret_cast<uint32_t*>(&b1);
}

// Two adjacent 16x8 accumulator tiles as one 16x16 bf16 A fragment.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float x[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// Store this thread's part of a 16 x 64 fp32 accumulator, times s, as bf16
// into a row-major matrix (rows >= nrows are skipped).
__device__ __forceinline__ void store_c64(bf16* base, size_t ld,
                                          const float acc[8][4], int r_lo,
                                          int r_hi, int nrows, int c,
                                          float s) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int d = dt * 8 + 2 * c;
    if (r_lo < nrows)
      *reinterpret_cast<__nv_bfloat162*>(base + (size_t)r_lo * ld + d) =
          __floats2bfloat162_rn(acc[dt][0] * s, acc[dt][1] * s);
    if (r_hi < nrows)
      *reinterpret_cast<__nv_bfloat162*>(base + (size_t)r_hi * ld + d) =
          __floats2bfloat162_rn(acc[dt][2] * s, acc[dt][3] * s);
  }
}

// Copy `rows` rows of 64 bf16 (row stride ld in global memory) into a
// padded shared tile [nalloc][LD], zero-filling rows past `rows`.
template <int LD>
__device__ __forceinline__ void load_tile64(bf16* dst, const bf16* src,
                                            size_t ld, int rows,
                                            int nalloc) {
  for (int i = threadIdx.x; i < nalloc * 8; i += blockDim.x) {
    const int r = i / 8, d8 = (i % 8) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + d8);
    *reinterpret_cast<uint4*>(dst + r * LD + d8) = v;
  }
}

inline const char* error_string(int err) {
  if (err == -1) return "head dim has no kernel build (D=64 only)";
  if (err == -2) return "key-grid width not taken by this kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace vdr
