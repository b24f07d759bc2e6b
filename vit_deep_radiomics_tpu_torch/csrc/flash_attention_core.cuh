// Shared core of the port's fused attention kernels (K1 window mode, K2
// global mode, and K2's trainable twin, the K5 forward): the first bf16
// loop, which K1, K2 and the K5 forward keep for the shapes their Hopper
// kernels do not take (their fp32 calls take f32_tiled_forward.cuh).
// It reads q from the split projection q (B, S, H*D) and
// k/v from kv (B, S, 2*H*D) (k in columns [0, H*D), v in [H*D, 2*H*D)), add
// the decomposed relative-position bias
//     bias_h[b, h, i, key / kw] + bias_w[b, h, i, key % kw]
// (per-head layout (B, H, S, kh) and (B, H, S, kw)), and write the output
// in projection-ready layout (B, S, H*D).
//
// The token axis is cut into independent segments of `seg` tokens: a query
// attends only to the keys of its own segment. K1 uses one 14x14 window per
// segment (seg = 196), K2 one segment over the whole sequence (seg = S).
//
// Algorithm: online-softmax flash attention in log2 units. Scores, the
// running max, the running sum and the accumulator are fp32; the max is
// kept (no "nomax" variant), so the result is the exact softmax up to
// rounding. One warp per 16 query rows, QK^T and PV on the tensor cores
// with mma.sync.m16n8k16 (bf16 in, fp32 accumulate), the score fragments
// turned into the PV operand in registers (no shared-memory round trip for
// P).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vdr {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;  // finite: keeps fully masked rows finite
// A key at or past kv_len, in log2 units: the plain version's -1e30 score
// times log2(e), bit for bit, so that a row with no valid key gets the
// plain version's lse and its backward P of 1 per key.
constexpr float kMaskedLog2 = kNegInf * kLog2e;
// Keys past the segment in a ragged tile: below every masked key, so they
// never join a row's sums (and the running max starts here).
constexpr float kPastEnd = 2.f * kNegInf;

struct AttnParams {
  const void* q;       // (B, S, H*D)
  const void* kv;      // (B, S, 2*H*D)
  const void* bias_h;  // (B, H, S, kh) or nullptr
  const void* bias_w;  // (B, H, S, kw) or nullptr
  const int* kv_len;   // (B,) valid keys per batch row, or nullptr
  void* out;           // (B, S, H*D)
  int B, S, H;
  int seg;             // tokens per independent attention segment
  int kh, kw;          // decomposed bias grid (kh * kw == seg when biased)
  float scale_log2;    // D^-1/2 * log2(e)
  float* lse = nullptr;  // (B, H, S) log2 log-sum-exp residual, or nullptr
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Block coordinates shared by both loops: grid = (query tiles per segment,
// H, B * segments per row).
struct Tile {
  int b, h, seg0, row0;
  int n_keys;  // keys visited
  bool none;   // kv_len 0: every key visited is masked
};

__device__ __forceinline__ Tile tile_of(const AttnParams& p, int bq) {
  Tile t;
  const int n_seg = p.S / p.seg;
  t.b = blockIdx.z / n_seg;
  t.seg0 = (blockIdx.z % n_seg) * p.seg;
  t.h = blockIdx.y;
  t.row0 = blockIdx.x * bq;
  t.n_keys = p.seg;
  t.none = false;
  if (p.kv_len != nullptr) {
    // with no valid key every key of the segment is visited, all masked,
    // so the row averages V as the plain version does; the mma loops
    // replace such a row's scores once a tile, so the code per score is
    // that of a row with valid keys
    const int lim = min(p.seg, max(p.kv_len[t.b], 0));
    t.none = lim == 0;
    if (lim > 0) t.n_keys = lim;
  }
  return t;
}

// Row stride of the staged bias: BQ + 4 words puts the 4 lanes of an mma
// group (keys 2 apart) on distinct banks in the bf16 loop.
template <int BQ>
__host__ __device__ constexpr int bias_stride() {
  return BQ + 4;
}

// Stage this tile's bias rows in shared memory, transposed to [term][row]
// and pre-multiplied by log2(e): term t < kh is the grid-row term, term
// kh + c the grid-column term. The source rows are contiguous in global
// memory, so the read is coalesced.
template <typename T, int BQ>
__device__ __forceinline__ void stage_bias(const AttnParams& p, const Tile& t,
                                           float* bias_s) {
  const int nrows = min(BQ, p.seg - t.row0);
  const size_t row_base =
      ((size_t)t.b * p.H + t.h) * p.S + t.seg0 + t.row0;
  const T* bh = static_cast<const T*>(p.bias_h) + row_base * p.kh;
  const T* bw = static_cast<const T*>(p.bias_w) + row_base * p.kw;
  for (int i = threadIdx.x; i < BQ * p.kh; i += blockDim.x) {
    const int r = i / p.kh, c = i % p.kh;
    bias_s[c * bias_stride<BQ>() + r] =
        r < nrows ? to_f32(bh[i]) * kLog2e : 0.f;
  }
  for (int i = threadIdx.x; i < BQ * p.kw; i += blockDim.x) {
    const int r = i / p.kw, c = i % p.kw;
    bias_s[(p.kh + c) * bias_stride<BQ>() + r] =
        r < nrows ? to_f32(bw[i]) * kLog2e : 0.f;
  }
}

// Bias terms of the tile's keys, computed once per tile instead of two
// integer divisions per score: .x = key / kw, .y = kh + key % kw.
template <int BK>
__device__ __forceinline__ void stage_key_terms(const AttnParams& p, int k0,
                                                int2* ktab) {
  for (int j = threadIdx.x; j < BK; j += blockDim.x) {
    const int key = k0 + j;
    ktab[j] = p.bias_h != nullptr ? make_int2(key / p.kw, p.kh + key % p.kw)
                                  : make_int2(0, 0);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, one warp per 16 query rows
// ---------------------------------------------------------------------------
//
// kLse (K5 forward, the trainable twin of K2) also writes each row's
// log2 log-sum-exp m + log2(l) to p.lse for the backward.

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x16, row) * B(16x8, col) + C, bf16 inputs, fp32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment coordinates (PTX ISA, mma.m16n8k16 with .bf16): lane = 4*g + c.
//   A (16x16): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..), a2 = (g, 2c+8..),
//              a3 = (g+8, 2c+8..)
//   B (16x8):  b0 = (k 2c..2c+1, n g), b1 = (k 2c+8..2c+9, n g)
//   C (16x8):  c0,c1 = (g, 2c..2c+1), c2,c3 = (g+8, 2c..2c+1)
// Two adjacent C tiles (16x16 of P) are exactly one A fragment for PV.
//
// Shared memory holds the K and V tiles as bf16 rows padded by 8 elements
// (16 bytes) so the fragment loads of the 8 rows of a group hit distinct
// banks.
template <int D, int BQ, int BK, bool kLse = false>
__device__ void attend_rows_bf16(const AttnParams& p, char* smem_raw) {
  constexpr int LD = D + 8;           // padded row length (elements)
  constexpr int NT = BK / 8;          // n8 score tiles per key tile
  constexpr int DT = D / 8;           // n8 output tiles
  const Tile t = tile_of(p, BQ);
  const int C = p.H * D;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + BK * LD;
  int2* ktab = reinterpret_cast<int2*>(vs + BK * LD);    // [BK]
  float* bias_s = reinterpret_cast<float*>(ktab + BK);    // [kh + kw][BS]
  constexpr int BS = bias_stride<BQ>();
  const bool has_bias = p.bias_h != nullptr;
  const bool add_bias = has_bias && !t.none;
  if (has_bias) stage_bias<__nv_bfloat16, BQ>(p, t, bias_s);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int wrow = warp * 16;               // warp's first row in the tile
  const int r_lo = t.row0 + wrow + g;       // this thread's two rows
  const int r_hi = r_lo + 8;
  const bool warp_live = t.row0 + wrow < p.seg;

  // Q fragment (16 x D), pre-scaled by D^-1/2 * log2(e) in fp32 and
  // rounded to bf16 once.
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
    const size_t base = ((size_t)t.b * p.S + t.seg0) * C + t.h * D;
    auto ld2 = [&](int r, int d) -> uint32_t {
      if (r >= p.seg) return 0u;
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
          q + base + (size_t)r * C + d);
      return pack_bf16(__low2float(v) * p.scale_log2,
                       __high2float(v) * p.scale_log2);
    };
#pragma unroll
    for (int kt = 0; kt < D / 16; ++kt) {
      qa[kt][0] = ld2(r_lo, kt * 16 + 2 * c);
      qa[kt][1] = ld2(r_hi, kt * 16 + 2 * c);
      qa[kt][2] = ld2(r_lo, kt * 16 + 2 * c + 8);
      qa[kt][3] = ld2(r_hi, kt * 16 + 2 * c + 8);
    }
  }

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_lo = kPastEnd, m_hi = kPastEnd, l_lo = 0.f, l_hi = 0.f;
  const __nv_bfloat16* kv = static_cast<const __nv_bfloat16*>(p.kv);
  const int lrow_lo = wrow + g, lrow_hi = lrow_lo + 8;  // rows in bias_s

  for (int k0 = 0; k0 < t.n_keys; k0 += BK) {
    const int nk = min(BK, t.n_keys - k0);
    __syncthreads();
    // K/V tile: 16-byte vector loads, zero-filled past the ragged edge.
    for (int i = threadIdx.x; i < BK * (D / 8); i += blockDim.x) {
      const int j = i / (D / 8), d8 = (i % (D / 8)) * 8;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = kk;
      if (j < nk) {
        const __nv_bfloat16* row =
            kv + ((size_t)t.b * p.S + t.seg0 + k0 + j) * (2 * C) + t.h * D;
        kk = *reinterpret_cast<const uint4*>(row + d8);
        vv = *reinterpret_cast<const uint4*>(row + C + d8);
      }
      *reinterpret_cast<uint4*>(ks + j * LD + d8) = kk;
      *reinterpret_cast<uint4*>(vs + j * LD + d8) = vv;
    }
    stage_key_terms<BK>(p, k0, ktab);
    __syncthreads();
    if (!warp_live) continue;

    // S = Q K^T for this warp's 16 rows and the tile's BK keys.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < D / 16; ++kt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * LD + kt * 16 + 2 * c;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(kr);
        b[1] = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_bf16_16816(s[nt], qa[kt], b);
      }
    }
    // a kv_len 0 row: every key scores as masked, with no bias
    if (t.none) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = kMaskedLog2;
    }
    // bias, ragged-edge mask, row max
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * c + (e & 1);
        float v = s[nt][e];
        if (j >= nk) {
          v = kPastEnd;
        } else if (add_bias) {
          const int2 kt = ktab[j];
          const int lr = e < 2 ? lrow_lo : lrow_hi;
          v += bias_s[kt.x * BS + lr] + bias_s[kt.y * BS + lr];
        }
        s[nt][e] = v;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
    // the 4 lanes of a group share a row
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float a_lo = exp2f(m_lo - mx_lo), a_hi = exp2f(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      o[i][0] *= a_lo;
      o[i][1] *= a_lo;
      o[i][2] *= a_hi;
      o[i][3] *= a_hi;
    }
    // P = exp2(S - m) in fp32 for the row sums, bf16 for the PV product
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = exp2f(s[nt][0] - m_lo), p1 = exp2f(s[nt][1] - m_lo);
      const float p2 = exp2f(s[nt][2] - m_hi), p3 = exp2f(s[nt][3] - m_hi);
      l_lo += p0 + p1;
      l_hi += p2 + p3;
      pa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    // O += P V: k = key (16 per step), n = head dim (8 per tile)
#pragma unroll
    for (int kt = 0; kt < NT / 2; ++kt) {
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* v0 = vs + (kt * 16 + 2 * c) * LD + dt * 8 + g;
        __nv_bfloat162 b0, b1;
        b0.x = v0[0];
        b0.y = v0[LD];
        b1.x = v0[8 * LD];
        b1.y = v0[9 * LD];
        uint32_t b[2] = {*reinterpret_cast<uint32_t*>(&b0),
                         *reinterpret_cast<uint32_t*>(&b1)};
        mma_bf16_16816(o[dt], pa[kt], b);
      }
    }
  }
  if (!warp_live) return;
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / (l_lo > 0.f ? l_lo : 1.f);
  const float inv_hi = 1.f / (l_hi > 0.f ? l_hi : 1.f);
  if constexpr (kLse) {
    if (c == 0) {
      float* lse = p.lse + ((size_t)t.b * p.H + t.h) * p.S + t.seg0;
      if (r_lo < p.seg) lse[r_lo] = m_lo + log2f(l_lo > 0.f ? l_lo : 1.f);
      if (r_hi < p.seg) lse[r_hi] = m_hi + log2f(l_hi > 0.f ? l_hi : 1.f);
    }
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  const size_t base = ((size_t)t.b * p.S + t.seg0) * C + t.h * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int d = dt * 8 + 2 * c;
    if (r_lo < p.seg)
      *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)r_lo * C + d) =
          __floats2bfloat162_rn(o[dt][0] * inv_lo, o[dt][1] * inv_lo);
    if (r_hi < p.seg)
      *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)r_hi * C + d) =
          __floats2bfloat162_rn(o[dt][2] * inv_hi, o[dt][3] * inv_hi);
  }
}

template <int D, int BQ, int BK>
constexpr size_t smem_bytes_bf16(int kh, int kw) {
  return (size_t)2 * BK * (D + 8) * sizeof(__nv_bfloat16) +
         (size_t)BK * sizeof(int2) +
         (size_t)(kh + kw) * bias_stride<BQ>() * sizeof(float);
}

template <int D, int BQ, int BK, bool kLse = false>
__global__ void __launch_bounds__(BQ * 2) attn_bf16_kernel(AttnParams p) {
  extern __shared__ __align__(16) char smem_bf16[];
  attend_rows_bf16<D, BQ, BK, kLse>(p, smem_bf16);
}

// Launch the bf16 kernel; kLse also writes the residual to p.lse. Returns
// the CUDA error of the launch (0 on success).
template <int D, int BQ, int BK, bool kLse>
int launch_bf16(const AttnParams& p, cudaStream_t stream) {
  const size_t smem = smem_bytes_bf16<D, BQ, BK>(p.kh, p.kw);
  auto kern = attn_bf16_kernel<D, BQ, BK, kLse>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((p.seg + BQ - 1) / BQ, p.H, p.B * (p.S / p.seg));
  kern<<<grid, (BQ / 16) * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace vdr
