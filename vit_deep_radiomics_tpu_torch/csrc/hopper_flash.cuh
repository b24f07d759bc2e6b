// The consumer side of the port's TMA + wgmma flash forwards, K2 and the
// K5 forward (global_fwd_hopper.cuh) and K3 (flash_attention.cu): Q's A
// fragments from a swizzled tile, the two products of one key tile, the
// online softmax in log2 units over the score registers of a warpgroup's
// 64 rows, and the stores of O and of the lse.
//
// A key tile holds NK keys (a multiple of 16, at most 64: it lies inside
// one key-grid row of 64 keys). A thread holds rows g and g + 8 of its
// warp's 16 (lane = 4 g + c) and, for each n8 chunk i of the tile, keys
// 8 i + 2 c and 8 i + 2 c + 1: s[4 i], s[4 i + 1] for row g, s[4 i + 2],
// s[4 i + 3] for row g + 8 (the wgmma accumulator layout).
#pragma once

#include "flash_attention_core.cuh"
#include "hopper.cuh"

namespace vdr {
namespace sm90 {

constexpr int kFlashD = 64;   // head dim (the only build)

// Q's A fragments (rows g, g + 8 of the warp's 16; k 2c.., 2c + 8..) from
// a 64 x 64 TMA tile with the 128-byte swizzle: 16-byte chunk k/8 of row r
// sits at chunk (k/8) ^ (r % 8)
__device__ __forceinline__ void q_frags(uint32_t (&qa)[kFlashD / 16][4],
                                        const unsigned char* tile, int warp,
                                        int g, int c) {
  const int rl = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < kFlashD / 16; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = rl + (f & 1) * 8, chunk = 2 * kk + f / 2;
      qa[kk][f] = *reinterpret_cast<const uint32_t*>(
          tile + r * 128 + ((chunk ^ (r & 7)) * 16) + 4 * c);
    }
}

// S = Q K^T for one key tile (4 k16 steps: 32 bytes along D); K is the
// tile's NK key rows of 128 bytes
template <int NK>
__device__ __forceinline__ void qk_tile(float (&s)[NK / 2],
                                        const uint32_t (&qa)[kFlashD / 16][4],
                                        uint32_t k_tile) {
  const uint64_t dk = desc_sw128(k_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < kFlashD / 16; ++kk)
    Wgmma<NK>::template rs<0>(s, qa[kk], dk + 2 * kk, kk > 0);
}

// O += P V for one key tile (16 keys = two 1024-byte 8-key groups a step)
template <int NK>
__device__ __forceinline__ void pv_tile(float (&o)[32],
                                        const uint32_t (&pa)[NK / 16][4],
                                        uint32_t v_tile) {
#pragma unroll
  for (int kt = 0; kt < NK / 16; ++kt)
    Wgmma<64>::rs<1>(o, pa[kt], desc_sw128(v_tile + kt * 2048, 1024, 1024),
                     1);
}

// Online-softmax state of a thread's two rows (log2 units). The max used
// for the exponentials moves only when a row's max grows by more than
// kRescaleLog2, so probabilities stay below 2^kRescaleLog2 and O is
// rescaled only on the tiles where some row's max jumped; a_lo/a_hi are
// the last tile's rescale factors (1 when the max stayed).
constexpr float kRescaleLog2 = 8.f;
struct Rows {
  float m_lo, m_hi, l_lo, l_hi, a_lo, a_hi;
};

// Scores of one tile -> probabilities in place: scale, the thread's
// bias_w columns of this tile (bw; NW 0: no bias), the kv_len mask on the
// ragged tile (keys >= lim score -1e30, keys past the end, the zero rows
// TMA reads beyond the tensor, below it), the row max with the tile's
// bias_h scalar added, exp2(s + bias_h - m) and the row sums. key0 is
// element 0's key. kPreScaled (the K5 forward): the scores come from a
// pre-scaled Q^, so `scale` is not applied, and masked keys score
// -1e30 log2 e, as the K5 backward rebuilds them.
template <int NK, int NW, bool kPreScaled = false>
__device__ __forceinline__ void tile_probs(float (&s)[NK / 2],
                                           const float (&bw)[NK / 8][4],
                                           float scale, float bh_lo,
                                           float bh_hi, int key0, bool ragged,
                                           int lim, int end, Rows& st) {
  constexpr int NS = NK / 2;
  constexpr float kMasked = kPreScaled ? vdr::kMaskedLog2 : vdr::kNegInf;
  // the max starts at or below the masked score, so that a tile of masked
  // keys has the masked score as its max
  constexpr float kMax0 = kPreScaled ? vdr::kPastEnd : vdr::kNegInf;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if constexpr (kPreScaled) {
      if (NW > 0) s[i] += bw[i / 4][i % 4];
    } else {
      s[i] = NW > 0 ? fmaf(s[i], scale, bw[i / 4][i % 4]) : s[i] * scale;
    }
  }
  if (ragged) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int key = key0 + (i / 4) * 8 + (i & 1);
      if (key >= lim) s[i] = key < end ? kMasked : vdr::kPastEnd;
    }
  }
  float mx_lo = kMax0, mx_hi = kMax0;
#pragma unroll
  for (int i = 0; i < NS / 4; ++i) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * i], s[4 * i + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  // the 4 lanes of a group share a row
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  mx_lo += bh_lo;
  mx_hi += bh_hi;
  st.a_lo = st.a_hi = 1.f;
  if (mx_lo > st.m_lo + kRescaleLog2) {
    st.a_lo = fast_exp2(st.m_lo - mx_lo);
    st.m_lo = mx_lo;
    st.l_lo *= st.a_lo;
  }
  if (mx_hi > st.m_hi + kRescaleLog2) {
    st.a_hi = fast_exp2(st.m_hi - mx_hi);
    st.m_hi = mx_hi;
    st.l_hi *= st.a_hi;
  }
  // a row with every key masked keeps m = -1e30 and takes p = 1 for each
  const float mb_lo = st.m_lo - bh_lo, mb_hi = st.m_hi - bh_hi;
#pragma unroll
  for (int i = 0; i < NS / 4; ++i) {
    s[4 * i] = fast_exp2(s[4 * i] - mb_lo);
    s[4 * i + 1] = fast_exp2(s[4 * i + 1] - mb_lo);
    s[4 * i + 2] = fast_exp2(s[4 * i + 2] - mb_hi);
    s[4 * i + 3] = fast_exp2(s[4 * i + 3] - mb_hi);
    st.l_lo += s[4 * i] + s[4 * i + 1];
    st.l_hi += s[4 * i + 2] + s[4 * i + 3];
  }
}

// Probabilities -> bf16 A fragments of PV: two n8 score chunks are one
// k16 A fragment (rows g and g + 8, keys 2c.. and 2c + 8..).
template <int NK>
__device__ __forceinline__ void pack_probs(const float (&s)[NK / 2],
                                           uint32_t (&pa)[NK / 16][4]) {
#pragma unroll
  for (int i = 0; i < NK / 8; ++i) {
    pa[i / 2][(i & 1) * 2] = vdr::pack_bf16(s[4 * i], s[4 * i + 1]);
    pa[i / 2][(i & 1) * 2 + 1] = vdr::pack_bf16(s[4 * i + 2], s[4 * i + 3]);
  }
}

// Rescale O by the last tile's factors when some row's max moved.
__device__ __forceinline__ void rescale(float (&o)[32], const Rows& st) {
  if (__any_sync(0xffffffffu, st.a_lo < 1.f || st.a_hi < 1.f)) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[4 * i] *= st.a_lo;
      o[4 * i + 1] *= st.a_lo;
      o[4 * i + 2] *= st.a_hi;
      o[4 * i + 3] *= st.a_hi;
    }
  }
}

// O / l of the thread's rows R_lo, R_hi (rows at or past n_rows are not
// written) into bf16 rows ld elements apart; the l > 0 guard stays.
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ld,
                                           int R_lo, int R_hi, int n_rows,
                                           int c, const float (&o)[32],
                                           const Rows& st) {
  float l_lo = st.l_lo, l_hi = st.l_hi;
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / (l_lo > 0.f ? l_lo : 1.f);
  const float inv_hi = 1.f / (l_hi > 0.f ? l_hi : 1.f);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = i * 8 + 2 * c;
    if (R_lo < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + R_lo * ld + d) =
          __floats2bfloat162_rn(o[4 * i] * inv_lo, o[4 * i + 1] * inv_lo);
    if (R_hi < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + R_hi * ld + d) =
          __floats2bfloat162_rn(o[4 * i + 2] * inv_hi,
                                o[4 * i + 3] * inv_hi);
  }
}

// The log2 log-sum-exp m + log2(l) of the thread's rows R_lo, R_hi into
// lse (rows at or past n_rows are not written), l summed over the quad as
// store_rows sums it; one lane of the quad writes. A row with no valid key
// keeps the old loop's rule, m + log2(l > 0 ? l : 1).
__device__ __forceinline__ void store_lse(float* lse, int R_lo, int R_hi,
                                          int n_rows, int c, const Rows& st) {
  float l_lo = st.l_lo, l_hi = st.l_hi;
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  if (c == 0) {
    if (R_lo < n_rows) lse[R_lo] = st.m_lo + log2f(l_lo > 0.f ? l_lo : 1.f);
    if (R_hi < n_rows) lse[R_hi] = st.m_hi + log2f(l_hi > 0.f ? l_hi : 1.f);
  }
}

}  // namespace sm90
}  // namespace vdr
