// K3: generic (B, H, S, D) flash attention forward.
//
// Replaces: vit_deep_radiomics_tpu/ops/attention.py::flash_attention
// (`_flash_kernel`, the Pallas TPU kernel that the backbone's `_flash`
// path runs for the grids and head layouts the fused kernels refuse, e.g.
// SAM's global layers at 768 px: a 48 x 48 grid padded to 48 x 64 keys).
//
// Computes, per (batch, head) and query row i,
//     softmax_j(q_i . k_j D^-1/2 + bias_h[i, row(j)] + bias_w[i, col(j)]) v
// over head-major q (B, H, Sq, D), k and v (B, H, Sk, D), out (B, H, Sq, D):
//  * the decomposed bias is optional; key j sits at (row, col) = (j / Kw,
//    j % Kw) of the key grid, or, in window mode, at the same place of its
//    own window (j % window_tokens), bias_h being per window (Kh * Kw ==
//    window_tokens);
//  * keys past kv_len[b], keys outside the (kh_valid, kw_valid) sub-grid of
//    a padded key grid, and (window mode) keys of another window get the
//    score -1e30, as in JAX: a row with no valid key averages V over the
//    keys it was given;
//  * window mode: the token axis is a concatenation of windows of
//    window_tokens tokens, each attending only to itself.
// Online softmax in log2 units with the running max kept (JAX's K3 has no
// nomax mode); scores, max, sums and the accumulator are fp32.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the
// SAM @768 path's shape (4 x 12 heads, the 2304 query rows its caller
// keeps, 3072 keys of 64 on the 48 x 64 padded grid, 2304 of them valid)
// the valid work is 65 GFLOP (0.066 ms at the bf16 peak) against about 91
// MB of compulsory traffic (0.027 ms): operations bound it.
//
// What the design does about it. The (Sq, Sk) scores are never written.
//  * bf16 at D = 64 outside window mode, with no bias or a bias on key-grid
//    rows of 64 keys (SAM @768's global layers), takes K2's Hopper design
//    over the head-major layout: one producer thread brings Q once and K/V
//    tiles into a 4-stage ring on mbarriers by TMA (128-byte swizzle; 3-D
//    maps of 64 columns x rows x B*H, so a box never crosses into the next
//    head: a ragged Sq reads zeros and its rows are not stored); three
//    consumer warpgroups of 64 query rows run S = Q K^T with Q's A
//    fragments in registers and O += P V with P from the score registers,
//    issuing QK^T of tile j with PV of tile j-1 and taking turns on named
//    barriers (hopper_flash.cuh holds the pieces K2 and K3 share). With the
//    bias a tile is one key-grid row's valid columns rounded up to 16: the
//    48 of 64 at @768, a box of 48 key rows and wgmma N = 48 for the
//    scores, K = 48 for PV; grid rows past kh_valid are never loaded.
//    bias_w stays in registers (times log2 e, -1e30 on a tile's columns
//    past kw_valid), bias_h is one scalar a row and tile from a table
//    staged once. The softmax is online in log2 units with the max kept
//    (moved lazily, by more than 2^8) and the l > 0 guard. Without a bias
//    64-key tiles run to kv_len (all of Sk when a row has no valid key).
//  * fp32 at D = 64 (the `parity` @768 path) takes the register-tiled
//    CUDA-core forward of f32_tiled_forward.cuh (64 query rows a block, K/V
//    tiles by cp.async, 4 x 4 score and 4 x 8 output micro-tiles a thread).
//    In window mode one (batch, window, head) is a problem: blocks of 64
//    rows of one window over that window's keys, only the kv_grid's valid
//    cells visited (196 of 256 keys at SAM's 16 x 16 windows with 14 x 14
//    valid). Operations bound it there: at 100 windows of 16 x 16 tokens
//    and 12 heads, 11.8 GFLOP of valid work at 67 TFLOP/s fp32 (0.176 ms)
//    against about 0.09 ms of traffic.
//  * bf16 at D = 64 in window mode (windows of at most 256 tokens, at most
//    47 bias terms: Kh + Kw <= 47, 1/scale a power of two) takes K1's
//    whole-window body (window_hopper.cuh) over the head-major layout: one
//    (batch, window, head) an item, done whole by a persistent block; TMA
//    boxes of the window's `window_tokens` query rows and of its first
//    kh_valid key-grid rows (2-D maps of the (B*H*S, 64) views, the item at
//    row (b*H + h)*S + w*window_tokens); one wgmma for the scores and one for
//    the bias against the expand matrix E, whose mask term carries -1e30
//    outside the kv_grid sub-grid; a one-pass softmax; every query row of
//    the window, its padding rows too, stored by TMA. Memory bounds it: at
//    100 windows of 16 x 16 tokens (14 x 14 valid) and 12 heads the
//    function needs about 156 MB (q and the output whole, K and V at the
//    valid keys, the bias terms of valid keys: 0.047 ms) for 11.8 GFLOP of
//    valid work (0.012 ms).
//  * The rest (D 32/128, bf16 at other key grids or with a bias and
//    kv_len) keeps the first loops: keys stream through shared memory in
//    64-key tiles, zero-filled past the end; the block's bias rows are staged
//    once, transposed and times log2(e); a per-tile table gives each key
//    its bias terms and its mask state. Key tiles past kv_len or past the
//    valid rows of the key grid are skipped when every row keeps a valid
//    key (their weights are exact zeros). bf16 runs QK^T and PV on
//    mma.sync.m16n8k16 (one warp per 16 query rows, 128-row blocks), fp32
//    on the CUDA cores one thread per row (two for D = 128). The head dim
//    is a template parameter, built for D = 32, 64 and 128 (fp32 for 32 and
//    128 only: the tiled body takes every fp32 call at 64).
// vdr_flash_attention_route reports the body.

#include <limits>

#include "f32_tiled_forward.cuh"
#include "flash_attention_core.cuh"
#include "hopper_flash.cuh"
#include "window_hopper.cuh"

namespace {
using namespace vdr::sm90;

using vdr::kLog2e;
using vdr::kNegInf;

constexpr int kBlockK = 64;
constexpr int kRowsF32 = 64;
constexpr int kRowsBf16 = 128;
// the tiled fp32 body: keys a K/V tile (32: a 4 x 4 score micro-tile a
// thread; 64: 4 x 8), tile buffers (2: the next tile loads during this
// one) and P in the tile's K buffer (1). One buffer with P in K takes 70 KB
// of shared memory at Kw 64, three blocks an SM; two buffers and a P tile
// of its own (96 KB, two blocks) ran 4-5% slower on an H100 (PERF.md)
constexpr int kF32Cols = 32;
constexpr int kF32Stages = 1;
constexpr int kF32PInK = 1;
// 1: with kv_grid, visit only each grid row's valid columns
constexpr int kF32SkipCols = 1;
// 1: fp32 window mode at D 64 takes the tiled body; 0: the loops (whose fp32
// instance at D 64 is built only then)
constexpr int kF32WindowTiled = 1;
// a key outside the block's range: weight exactly 0, even in a row whose
// every key is masked
constexpr float kAbsent = -std::numeric_limits<float>::infinity();

struct FlashParams {
  const void* q;       // (B, H, Sq, D)
  const void* k;       // (B, H, Sk, D)
  const void* v;       // (B, H, Sk, D)
  const void* bias_h;  // (B, H, Sq, kh) or nullptr
  const void* bias_w;  // (B, H, Sq, kw) or nullptr
  const int* kv_len;   // (B,) or nullptr
  void* out;           // (B, H, Sq, D)
  int B, H, Sq, Sk;
  int kh, kw;              // bias grid (0 without bias)
  int kh_valid, kw_valid;  // valid key sub-grid (0: no kv_grid mask)
  int window;              // window_tokens (0: global)
  float scale_log2;        // scale * log2(e)
};

// A block's query rows and the keys it visits.
struct Range {
  int b, h, row0, k_begin, k_end, kvl;
  size_t head;  // b * H + h
};

__device__ __forceinline__ Range range_of(const FlashParams& p, int bq) {
  Range t;
  t.b = blockIdx.z;
  t.h = blockIdx.y;
  t.head = (size_t)t.b * p.H + t.h;
  t.row0 = blockIdx.x * bq;
  t.kvl = p.kv_len != nullptr ? p.kv_len[t.b] : p.Sk;
  if (p.window) {
    const int last = min(t.row0 + bq, p.Sq) - 1;
    t.k_begin = (t.row0 / p.window) * p.window;
    t.k_end = min(p.Sk, (last / p.window + 1) * p.window);
  } else {
    t.k_begin = 0;
    t.k_end = p.Sk;
    // keys past kv_len or past the grid's valid rows are masked in every
    // row; when every row keeps a valid key (kv_len >= 1; the wrapper
    // refuses an empty kv_grid) their weights are exact zeros: skip them
    if (p.kv_len == nullptr || t.kvl >= 1) {
      if (p.kv_len != nullptr) t.k_end = min(t.k_end, t.kvl);
      if (p.kh_valid) t.k_end = min(t.k_end, p.kh_valid * p.kw);
    }
  }
  return t;
}

// Key table entry: .x, .y the bias terms (grid row, kh + grid column), .z
// the mask state (0 valid, 1 masked to -1e30, 2 absent), .w the window.
__device__ __forceinline__ int4 key_term(const FlashParams& p, const Range& t,
                                         int key) {
  if (key >= t.k_end) return make_int4(0, 0, 2, 0);
  const int local = p.window ? key % p.window : key;
  int4 e = make_int4(0, 0, 0, p.window ? key / p.window : 0);
  if (p.bias_h != nullptr) {
    e.x = local / p.kw;
    e.y = p.kh + local % p.kw;
  }
  if (p.kv_len != nullptr && key >= t.kvl) e.z = 1;
  if (p.kh_valid &&
      (local / p.kw >= p.kh_valid || local % p.kw >= p.kw_valid))
    e.z = 1;
  return e;
}

template <int BK>
__device__ __forceinline__ void stage_keys(const FlashParams& p,
                                           const Range& t, int k0,
                                           int4* ktab) {
  for (int j = threadIdx.x; j < BK; j += blockDim.x)
    ktab[j] = key_term(p, t, k0 + j);
}

// The block's bias rows in shared memory, [term][row] and times log2(e):
// term t < kh the grid-row term, kh + c the grid-column term.
template <typename T, int BQ>
__device__ __forceinline__ void stage_bias(const FlashParams& p,
                                           const Range& t, float* bias_s) {
  constexpr int BS = vdr::bias_stride<BQ>();
  const int nrows = min(BQ, p.Sq - t.row0);
  const size_t row_base = t.head * p.Sq + t.row0;
  const T* bh = static_cast<const T*>(p.bias_h) + row_base * p.kh;
  const T* bw = static_cast<const T*>(p.bias_w) + row_base * p.kw;
  for (int i = threadIdx.x; i < BQ * p.kh; i += blockDim.x) {
    const int r = i / p.kh, c = i % p.kh;
    bias_s[c * BS + r] = r < nrows ? vdr::to_f32(bh[i]) * kLog2e : 0.f;
  }
  for (int i = threadIdx.x; i < BQ * p.kw; i += blockDim.x) {
    const int r = i / p.kw, c = i % p.kw;
    bias_s[(p.kh + c) * BS + r] = r < nrows ? vdr::to_f32(bw[i]) * kLog2e
                                            : 0.f;
  }
}

// A score after bias and masks (log2 units).
template <int BS>
__device__ __forceinline__ float finish_score(float s, int4 kt, int qwin,
                                              const float* bias_s, int lr,
                                              bool has_bias) {
  if (kt.z == 2) return kAbsent;
  if (kt.z == 1 || kt.w != qwin) return kNegInf;
  return has_bias ? s + (bias_s[kt.x * BS + lr] + bias_s[kt.y * BS + lr])
                  : s;
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, one thread per query row (two for D = 128)
// ---------------------------------------------------------------------------

template <int D>
struct F32Shape {
  static constexpr int TPR = D > 64 ? D / 64 : 1;  // threads per row
  static constexpr int DS = D / TPR;               // head dims per thread
};

template <int D, int BQ, int BK>
__device__ void flash_rows_f32(const FlashParams& p, float* smem) {
  constexpr int TPR = F32Shape<D>::TPR, DS = F32Shape<D>::DS;
  constexpr int CH = 16;  // keys per online-softmax step
  constexpr int BS = vdr::bias_stride<BQ>();
  const Range t = range_of(p, BQ);
  float* ks = smem;                                    // [BK][D]
  float* vs = ks + BK * D;                             // [BK][D]
  int4* ktab = reinterpret_cast<int4*>(vs + BK * D);  // [BK]
  float* bias_s = reinterpret_cast<float*>(ktab + BK);
  const bool has_bias = p.bias_h != nullptr;
  if (has_bias) stage_bias<float, BQ>(p, t, bias_s);

  const int lr = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int r = t.row0 + lr;
  const bool valid = r < p.Sq;
  const int qwin = p.window ? r / p.window : 0;
  const float* qrow = static_cast<const float*>(p.q) +
                      (t.head * p.Sq + (valid ? r : 0)) * D + part * DS;
  float q[DS], acc[DS];
#pragma unroll
  for (int d = 0; d < DS; ++d) {
    q[d] = valid ? qrow[d] * p.scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const float* kb = static_cast<const float*>(p.k) + t.head * p.Sk * D;
  const float* vb = static_cast<const float*>(p.v) + t.head * p.Sk * D;

  for (int k0 = t.k_begin; k0 < t.k_end; k0 += BK) {
    const int nk = min(BK, t.k_end - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < BK * (D / 4); i += blockDim.x) {
      const int j = i / (D / 4), d4 = (i % (D / 4)) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (j < nk) {
        kk = *reinterpret_cast<const float4*>(kb + (size_t)(k0 + j) * D + d4);
        vv = *reinterpret_cast<const float4*>(vb + (size_t)(k0 + j) * D + d4);
      }
      *reinterpret_cast<float4*>(ks + j * D + d4) = kk;
      *reinterpret_cast<float4*>(vs + j * D + d4) = vv;
    }
    stage_keys<BK>(p, t, k0, ktab);
    __syncthreads();
    for (int c0 = 0; c0 < nk; c0 += CH) {
      float s[CH];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = c0 + jj;
        float v = kAbsent;
        if (j < nk) {  // the same for every thread of the block
          const float* kr = ks + j * D + part * DS;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < DS; ++d) dot = fmaf(q[d], kr[d], dot);
          if (TPR == 2) dot += __shfl_xor_sync(0xffffffffu, dot, 1);
          v = finish_score<BS>(dot, ktab[j], qwin, bias_s, lr, has_bias);
        }
        s[jj] = v;
        mx = fmaxf(mx, v);
      }
      const float alpha = exp2f(m - mx);
      m = mx;
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DS; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = c0 + jj;
        if (j < nk) {
          const float pj = exp2f(s[jj] - m);
          l += pj;
          const float* vr = vs + j * D + part * DS;
#pragma unroll
          for (int d = 0; d < DS; ++d) acc[d] = fmaf(pj, vr[d], acc[d]);
        }
      }
    }
  }
  if (valid) {
    float* orow = static_cast<float*>(p.out) + (t.head * p.Sq + r) * D +
                  part * DS;
    const float inv = 1.f / (l > 0.f ? l : 1.f);
#pragma unroll
    for (int d = 0; d < DS; ++d) orow[d] = acc[d] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, one warp per 16 query rows (fragment layouts as in
// flash_attention_core.cuh)
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK>
__device__ void flash_rows_bf16(const FlashParams& p, char* smem_raw) {
  constexpr int LD = D + 8;   // padded K/V row (elements)
  constexpr int NT = BK / 8;  // n8 score tiles per key tile
  constexpr int DT = D / 8;   // n8 output tiles
  constexpr int BS = vdr::bias_stride<BQ>();
  const Range t = range_of(p, BQ);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + BK * LD;
  int4* ktab = reinterpret_cast<int4*>(vs + BK * LD);   // [BK]
  float* bias_s = reinterpret_cast<float*>(ktab + BK);  // [kh + kw][BS]
  const bool has_bias = p.bias_h != nullptr;
  if (has_bias) stage_bias<__nv_bfloat16, BQ>(p, t, bias_s);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int wrow = warp * 16;
  const int r_lo = t.row0 + wrow + g, r_hi = r_lo + 8;
  const int lrow_lo = wrow + g, lrow_hi = lrow_lo + 8;
  const int qwin_lo = p.window ? r_lo / p.window : 0;
  const int qwin_hi = p.window ? r_hi / p.window : 0;
  const bool warp_live = t.row0 + wrow < p.Sq;

  // Q fragment (16 x D), scaled by scale * log2(e) in fp32, rounded once
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* q =
        static_cast<const __nv_bfloat16*>(p.q) + t.head * p.Sq * D;
    auto ld2 = [&](int r, int d) -> uint32_t {
      if (r >= p.Sq) return 0u;
      const __nv_bfloat162 v =
          *reinterpret_cast<const __nv_bfloat162*>(q + (size_t)r * D + d);
      return vdr::pack_bf16(__low2float(v) * p.scale_log2,
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
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + t.head * p.Sk * D;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + t.head * p.Sk * D;

  for (int k0 = t.k_begin; k0 < t.k_end; k0 += BK) {
    const int nk = min(BK, t.k_end - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < BK * (D / 8); i += blockDim.x) {
      const int j = i / (D / 8), d8 = (i % (D / 8)) * 8;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = kk;
      if (j < nk) {
        kk = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + j) * D + d8);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + j) * D + d8);
      }
      *reinterpret_cast<uint4*>(ks + j * LD + d8) = kk;
      *reinterpret_cast<uint4*>(vs + j * LD + d8) = vv;
    }
    stage_keys<BK>(p, t, k0, ktab);
    __syncthreads();
    if (!warp_live) continue;

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
        vdr::mma_bf16_16816(s[nt], qa[kt], b);
      }
    }
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * c + (e & 1);
        s[nt][e] = j < nk ? finish_score<BS>(s[nt][e], ktab[j],
                                             e < 2 ? qwin_lo : qwin_hi,
                                             bias_s,
                                             e < 2 ? lrow_lo : lrow_hi,
                                             has_bias)
                          : kAbsent;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
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
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = exp2f(s[nt][0] - m_lo), p1 = exp2f(s[nt][1] - m_lo);
      const float p2 = exp2f(s[nt][2] - m_hi), p3 = exp2f(s[nt][3] - m_hi);
      l_lo += p0 + p1;
      l_hi += p2 + p3;
      pa[nt / 2][(nt & 1) * 2 + 0] = vdr::pack_bf16(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = vdr::pack_bf16(p2, p3);
    }
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
        vdr::mma_bf16_16816(o[dt], pa[kt], b);
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
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + t.head * p.Sq * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int d = dt * 8 + 2 * c;
    if (r_lo < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r_lo * D + d) =
          __floats2bfloat162_rn(o[dt][0] * inv_lo, o[dt][1] * inv_lo);
    if (r_hi < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r_hi * D + d) =
          __floats2bfloat162_rn(o[dt][2] * inv_hi, o[dt][3] * inv_hi);
  }
}

template <int D>
__global__ void __launch_bounds__(kRowsF32 * F32Shape<D>::TPR)
    flash_f32_kernel(FlashParams p) {
  extern __shared__ __align__(16) float smem_k3_f32[];
  flash_rows_f32<D, kRowsF32, kBlockK>(p, smem_k3_f32);
}

template <int D>
__global__ void __launch_bounds__(kRowsBf16 * 2)
    flash_bf16_kernel(FlashParams p) {
  extern __shared__ __align__(16) char smem_k3_bf16[];
  flash_rows_bf16<D, kRowsBf16, kBlockK>(p, smem_k3_bf16);
}

template <int D>
int launch(const FlashParams& p, int dtype, cudaStream_t stream) {
  const size_t bias_bytes = (size_t)(p.kh + p.kw) * sizeof(float);
  const size_t keys = (size_t)kBlockK * sizeof(int4);
  dim3 grid;
  cudaError_t err;
  if (dtype != 0) {
    const size_t smem = (size_t)2 * kBlockK * (D + 8) * 2 + keys +
                        bias_bytes * vdr::bias_stride<kRowsBf16>();
    err = cudaFuncSetAttribute(flash_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    grid = dim3((p.Sq + kRowsBf16 - 1) / kRowsBf16, p.H, p.B);
    flash_bf16_kernel<D><<<grid, kRowsBf16 * 2, smem, stream>>>(p);
  } else if constexpr (D == vdr::tiled::D && kF32WindowTiled) {
    return -1;   // the tiled body takes every fp32 call at D 64
  } else {
    const size_t smem = (size_t)2 * kBlockK * D * 4 + keys +
                        bias_bytes * vdr::bias_stride<kRowsF32>();
    err = cudaFuncSetAttribute(flash_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    grid = dim3((p.Sq + kRowsF32 - 1) / kRowsF32, p.H, p.B);
    flash_f32_kernel<D><<<grid, kRowsF32 * F32Shape<D>::TPR, smem, stream>>>(
        p);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, D = 64, outside window mode: the Hopper kernel (K2's design over
// the head-major layout)
// ---------------------------------------------------------------------------

constexpr int kConsumers = 3;              // consumer warpgroups
constexpr int kBQ = 64 * kConsumers;       // query rows per block
// K/V ring depth (4 ran 2% faster than K2's 6 at SAM @768 on an H100,
// PERF.md)
constexpr int kStages = 4;
constexpr int kQTile = 64 * kFlashD * 2;   // one 64-row bf16 Q tile (8 KB)
constexpr int kThreads = 128 * (kConsumers + 1);  // + 1 producer WG
// registers a thread after setmaxnreg: the producer gives its share to the
// consumers (64 K registers an SM, one block)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;
constexpr int kBiasLd = kBQ + 1;           // bias_h table row (bank skew)
// 1: a key-grid row's tile is its valid columns rounded up to 16 (SAM
// @768's 48 of 64); 0: all 64 columns, the masked ones through bias_w
constexpr int kSkipCols = 1;
constexpr int kErrTensorMap = -2;          // cuTensorMapEncodeTiled failed

struct HopperParams {
  const __nv_bfloat16* bias_h;  // (B, H, Sq, kh) or nullptr
  const __nv_bfloat16* bias_w;  // (B, H, Sq, kw) or nullptr
  const int* kv_len;            // (B,) or nullptr (never with the bias)
  __nv_bfloat16* out;           // (B, H, Sq, D)
  int H, Sq, Sk, kh, kw;
  int n_rows;                   // with the bias: grid rows visited
  int cols;                     // with the bias: valid columns of a row
  float scale_log2;             // D^-1/2 * log2(e)
};

// NK: keys a tile (48 or 64), each a K/V TMA box of NK rows. With the bias
// (Kw 64) tile j is the first NK keys of key-grid row j, for the grid's
// valid rows; columns >= cols of a tile score -1e30 through bias_w. Without
// it tile j is keys 64 j .. 64 j + 63 up to kv_len (or Sk), as in K2.
template <int NK, bool kBias>
__global__ void __launch_bounds__(kThreads, 1)
    k3_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const HopperParams p) {
  constexpr int kKTile = NK * kFlashD * 2;  // NK rows of 128 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], qbar;
  // the swizzled tiles need 1024-byte alignment in the shared window (an
  // NK-row tile is NK / 8 swizzle atoms of 1024 bytes)
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_addr = smem_u32(base);               // kConsumers Q
  const uint32_t k_addr = q_addr + kConsumers * kQTile;  // kStages K
  const uint32_t v_addr = k_addr + kStages * kKTile;     // kStages V
  float* bias_s = reinterpret_cast<float*>(
      base + kConsumers * kQTile + 2 * kStages * kKTile);  // [row][kBiasLd]

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kBQ;
  const int head = b * p.H + h;
  // keys j < lim are valid; with none valid every key is visited, all
  // masked, so the row averages V as the plain version does
  int lim = p.Sk;
  if (p.kv_len != nullptr) lim = min(p.Sk, max(p.kv_len[b], 0));
  const int n_tiles =
      kBias ? p.n_rows : ((lim > 0 ? lim : p.Sk) + NK - 1) / NK;
  // key rows between two tiles' first keys
  const int stride = kBias ? p.kw : NK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * 128);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(&qbar, kConsumers * kQTile);
      for (int w = 0; w < kConsumers; ++w)
        tma_load(q_addr + w * kQTile, &tq, &qbar, 0, row0 + 64 * w, head);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * kKTile);
        tma_load(k_addr + st * kKTile, &tk, &full[st], 0, j * stride, head);
        tma_load(v_addr + st * kKTile, &tv, &full[st], 0, j * stride, head);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, c = lane % 4;
    const int r_lo = wg * 64 + warp * 16 + g;  // this thread's rows in the
    const int r_hi = r_lo + 8;                 // block (and + row0: global)
    const size_t head_row = (size_t)head * p.Sq;

    // bias_w of the thread's rows and tile columns, times log2(e); columns
    // at or past `cols` are masked (-1e30)
    float bw[NK / 8][4];
    if constexpr (kBias) {
      // bias_h of this warpgroup's rows, transposed to [grid row][row]
      for (int i = t; i < 64 * p.n_rows; i += 128) {
        const int r = wg * 64 + i / p.n_rows, kr = i % p.n_rows;
        const int R = row0 + r;
        bias_s[kr * kBiasLd + r] =
            R < p.Sq
                ? __bfloat162float(p.bias_h[(head_row + R) * p.kh + kr]) *
                      vdr::kLog2e
                : 0.f;
      }
#pragma unroll
      for (int i = 0; i < NK / 8; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int R = row0 + (half ? r_hi : r_lo), col = i * 8 + 2 * c;
          float lo = 0.f, hi = 0.f;
          if (R < p.Sq) {
            const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
                p.bias_w + (head_row + R) * p.kw + col);
            lo = __low2float(v) * vdr::kLog2e;
            hi = __high2float(v) * vdr::kLog2e;
          }
          bw[i][2 * half] = col < p.cols ? lo : vdr::kNegInf;
          bw[i][2 * half + 1] = col + 1 < p.cols ? hi : vdr::kNegInf;
        }
      }
      bar_sync(1 + wg, 128);
    }

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    Rows st{vdr::kNegInf, vdr::kNegInf, 0.f, 0.f, 1.f, 1.f};
    float s[NK / 2];
    uint32_t pa[NK / 16][4];
    // this tile's scores -> probabilities, in place
    auto probs = [&](int j) {
      if constexpr (kBias)
        tile_probs<NK, 1>(s, bw, p.scale_log2, bias_s[j * kBiasLd + r_lo],
                          bias_s[j * kBiasLd + r_hi], 0, false, 0, 0, st);
      else
        tile_probs<NK, 0>(s, bw, p.scale_log2, 0.f, 0.f, j * NK + 2 * c,
                          j * NK + NK > lim, lim, p.Sk, st);
    };
    // ping-pong: the warpgroups issue their products in turn, each after
    // the one before it, so one's softmax runs under the others' products
    // (named barriers 1 .. kConsumers serve the bias staging above)
    const int my_bar = 1 + kConsumers + wg;
    const int next_bar = 1 + kConsumers + (wg + 1) % kConsumers;
    if (wg == kConsumers - 1) bar_arrive(next_bar, 256);
    mbar_wait(&qbar, 0);
    uint32_t qa[kFlashD / 16][4];
    q_frags(qa, base + wg * kQTile, warp, g, c);

    // software pipeline: QK^T of tile j and PV of tile j-1 are issued
    // together; the softmax of tile j runs while PV(j-1) is on the tensor
    // cores, and O is rescaled once PV(j-1) has landed
    mbar_wait(&full[0], 0);
    bar_sync(my_bar, 256);
    wgmma_fence();
    qk_tile<NK>(s, qa, k_addr);
    wgmma_commit();
    bar_arrive(next_bar, 256);
    wgmma_wait<0>();
    fence_regs(s);
    probs(0);
    pack_probs<NK>(s, pa);
    for (int j = 1; j < n_tiles; ++j) {
      const int cur = j % kStages, prev = (j - 1) % kStages;
      mbar_wait(&full[cur], (j / kStages) & 1);
      bar_sync(my_bar, 256);
      wgmma_fence();
      qk_tile<NK>(s, qa, k_addr + cur * kKTile);
      wgmma_commit();
      pv_tile<NK>(o, pa, v_addr + prev * kKTile);
      wgmma_commit();
      bar_arrive(next_bar, 256);
      wgmma_wait<1>();
      fence_regs(s);
      probs(j);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(&empty[prev]);
      rescale(o, st);
      pack_probs<NK>(s, pa);
    }
    const int last = (n_tiles - 1) % kStages;
    bar_sync(my_bar, 256);
    wgmma_fence();
    pv_tile<NK>(o, pa, v_addr + last * kKTile);
    wgmma_commit();
    // every last sync is matched: the last warpgroup's initial arrive
    // stands in for its final one
    if (wg != kConsumers - 1) bar_arrive(next_bar, 256);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&empty[last]);

    store_rows(p.out + head_row * kFlashD, kFlashD, row0 + r_lo,
               row0 + r_hi, p.Sq, c, o, st);
  }
}

size_t hopper_smem(int nk, int n_rows) {
  return 1024 + (size_t)kConsumers * kQTile +
         (size_t)2 * kStages * nk * kFlashD * 2 +
         (size_t)n_rows * kBiasLd * sizeof(float);
}

// The keys a tile of the Hopper kernel takes for a call (48 or 64), or 0
// when the call keeps the loops: bf16 at D 64 outside window mode, with no
// bias (kv_len or not) or a bias on key-grid rows of 64 keys (no kv_len)
// whose valid columns, rounded up to 16, are 48 or 64.
int hopper_keys(int D, int window, int dtype, bool biased, bool kv_len,
                int kh, int kw, int kh_valid, int kw_valid) {
  if (dtype == 0 || D != kFlashD || window) return 0;
  if (!biased) return 64;
  if (kv_len || kw != 64) return 0;
  const int cols = kh_valid ? kw_valid : kw;
  const int nk = kSkipCols ? (cols + 15) / 16 * 16 : 64;
  if (nk != 48 && nk != 64) return 0;
  return hopper_smem(nk, kh_valid ? kh_valid : kh) <= 227 * 1024 ? nk : 0;
}

template <int NK, bool kBias>
int launch_hopper(const FlashParams& fp, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int bh = fp.B * fp.H;
  if (!tensor_map_3d(&tq, fp.q, kFlashD, fp.Sq, bh, 64) ||
      !tensor_map_3d(&tk, fp.k, kFlashD, fp.Sk, bh, NK) ||
      !tensor_map_3d(&tv, fp.v, kFlashD, fp.Sk, bh, NK))
    return kErrTensorMap;
  HopperParams p;
  p.bias_h = static_cast<const __nv_bfloat16*>(fp.bias_h);
  p.bias_w = static_cast<const __nv_bfloat16*>(fp.bias_w);
  p.kv_len = fp.kv_len;
  p.out = static_cast<__nv_bfloat16*>(fp.out);
  p.H = fp.H;
  p.Sq = fp.Sq;
  p.Sk = fp.Sk;
  p.kh = fp.kh;
  p.kw = fp.kw;
  p.n_rows = fp.kh_valid ? fp.kh_valid : fp.kh;
  p.cols = fp.kh_valid ? fp.kw_valid : fp.kw;
  p.scale_log2 = fp.scale_log2;
  const size_t smem = hopper_smem(NK, kBias ? p.n_rows : 0);
  auto kern = k3_hopper_kernel<NK, kBias>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((fp.Sq + kBQ - 1) / kBQ, fp.H, fp.B);
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, D = 64, window mode: K1's whole-window body (window_hopper.cuh,
// head-major)
// ---------------------------------------------------------------------------

// 1: an item loads only its window's first kh_valid key-grid rows (224 of
// 256 keys at SAM's 16 x 16 windows with 14 x 14 valid: the keys past
// them weigh exact zeros, every row keeping a valid key); 0: every key of
// the window
constexpr int kWinCutRows = 1;

template <int N>
__global__ void __launch_bounds__(win::kThreads, 1)
    k3_window_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tout,
                     const win::WinParams p) {
  win::window_body<N, true>(&tq, &tk, &tv, &tout, p);
}

// Whether the whole-window body takes a call, its parameters, N and shared
// memory: window mode with the bias (the wrapper requires it and kv_grid)
// and no kv_len, bf16, D 64, windows of at most 256 tokens, kh + kw + 1 <=
// 16 * win::kBiasSteps terms, 1/scale a power of two (window_hopper.cuh's
// plan).
bool window_plan(int B, int H, int Sq, int Sk, int D, int window, int dtype,
                 bool biased, bool kv_len, int kh, int kw, int kh_valid,
                 int kw_valid, float scale, win::WinParams* wp, int* n,
                 size_t* smem) {
  if (!window || !biased || kv_len || Sq != Sk || kh < 1 || kw < 1 ||
      kh * kw != window)
    return false;
  // a kv_grid past the grid masks nothing there
  kh_valid = kh_valid ? min(kh_valid, kh) : kh;
  kw_valid = kw_valid ? min(kw_valid, kw) : kw;
  if (kh_valid < 1 || kw_valid < 1) return false;
  const int keys = kWinCutRows ? kh_valid * kw : window;
  *n = keys > 208 && keys <= 224 ? 224 : win::hopper_width(keys);
  if (!win::hopper_plan(B, Sq, H, D, window, keys, *n, kh, kw, true, scale,
                        dtype, wp, smem))
    return false;
  wp->kh_valid = kh_valid;
  wp->kw_valid = kw_valid;
  return true;
}

int launch_window(const FlashParams& fp, win::WinParams p, int n,
                  size_t smem, cudaStream_t stream) {
  p.bias_h = static_cast<const __nv_bfloat16*>(fp.bias_h);
  p.bias_w = static_cast<const __nv_bfloat16*>(fp.bias_w);
  CUtensorMap tq, tk, tv, tout;
  const int rows = fp.B * fp.H * fp.Sq;
  if (!win::tensor_map_2d(&tq, fp.q, win::kD, rows, fp.window) ||
      !win::tensor_map_2d(&tk, fp.k, win::kD, rows, p.keys) ||
      !win::tensor_map_2d(&tv, fp.v, win::kD, rows, p.keys) ||
      !win::tensor_map_2d(&tout, fp.out, win::kD, rows, fp.window))
    return kErrTensorMap;
  switch (n) {
    case 64:
      return win::launch(k3_window_kernel<64>, p.n_items, smem, stream, tq,
                         tk, tv, tout, p);
    case 208:
      return win::launch(k3_window_kernel<208>, p.n_items, smem, stream, tq,
                         tk, tv, tout, p);
    case 224:
      return win::launch(k3_window_kernel<224>, p.n_items, smem, stream, tq,
                         tk, tv, tout, p);
    default:
      return win::launch(k3_window_kernel<256>, p.n_items, smem, stream, tq,
                         tk, tv, tout, p);
  }
}

// ---------------------------------------------------------------------------
// fp32, D = 64: the register-tiled forward
// ---------------------------------------------------------------------------

// Whether the tiled body takes a call: fp32 at D 64, and in window mode with
// the bias and no kv_len (the wrapper requires the one and refuses the
// other there).
bool tiled_takes(int D, int window, int dtype, bool biased, bool kv_len) {
  return dtype == 0 && D == vdr::tiled::D &&
         (window == 0 || (kF32WindowTiled && biased && !kv_len));
}

template <bool kBias>
__global__ void __launch_bounds__(vdr::tiled::NT, 2)
    k3_tiled_kernel(const FlashParams p) {
  extern __shared__ __align__(16) float smem_k3_tiled[];
  const vdr::tiled::Problem pr = vdr::tiled::k3_problem(
      static_cast<const float*>(p.q), static_cast<const float*>(p.k),
      static_cast<const float*>(p.v), static_cast<const float*>(p.bias_h),
      static_cast<const float*>(p.bias_w), p.kv_len,
      static_cast<float*>(p.out), p.H, p.Sq, p.Sk, p.kh, p.kw, p.kh_valid,
      p.kw_valid, kF32SkipCols != 0, p.scale_log2, blockIdx.z, blockIdx.y);
  vdr::tiled::forward<kF32Cols, kF32Stages, kF32PInK != 0, kBias>(
      pr, blockIdx.x * vdr::tiled::ROWS, smem_k3_tiled);
}

// Window mode: block x is a 64-row block of one window (window_block), y
// the head, z the batch row.
__global__ void __launch_bounds__(vdr::tiled::NT, 2)
    k3_win_tiled_kernel(const FlashParams p) {
  extern __shared__ __align__(16) float smem_k3_win[];
  const vdr::tiled::Block blk = vdr::tiled::window_block(blockIdx.x, p.window);
  const vdr::tiled::Problem pr = vdr::tiled::k3_problem(
      static_cast<const float*>(p.q), static_cast<const float*>(p.k),
      static_cast<const float*>(p.v), static_cast<const float*>(p.bias_h),
      static_cast<const float*>(p.bias_w), nullptr,
      static_cast<float*>(p.out), p.H, p.Sq, p.Sk, p.kh, p.kw, p.kh_valid,
      p.kw_valid, kF32SkipCols != 0, p.scale_log2, blockIdx.z, blockIdx.y,
      p.window, blk.w);
  vdr::tiled::forward<kF32Cols, kF32Stages, kF32PInK != 0, true>(
      pr, blk.row0, smem_k3_win);
}

template <typename Kernel>
int launch_tiled(Kernel kern, bool biased, dim3 grid, const FlashParams& p,
                 cudaStream_t stream) {
  const size_t smem =
      sizeof(float) *
      vdr::tiled::smem_floats<kF32Cols, kF32Stages, kF32PInK != 0>(
          biased ? p.kh : 0, biased ? p.kw : 0);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, vdr::tiled::NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_tiled(const FlashParams& p, cudaStream_t stream) {
  constexpr int R = vdr::tiled::ROWS;
  if (p.window)
    return launch_tiled(k3_win_tiled_kernel, true,
                        dim3(p.Sq / p.window * ((p.window + R - 1) / R), p.H,
                             p.B),
                        p, stream);
  const dim3 grid((p.Sq + R - 1) / R, p.H, p.B);
  return p.bias_h != nullptr
             ? launch_tiled(k3_tiled_kernel<true>, true, grid, p, stream)
             : launch_tiled(k3_tiled_kernel<false>, false, grid, p, stream);
}

}  // namespace

extern "C" {

const char* vdr_error_string(int err) {
  if (err == kErrTensorMap) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The body a call with these arguments runs: 0 the loops above, 1 the
// Hopper kernel, 2 the register-tiled fp32 forward, 3 the whole-window body
// (window mode).
int vdr_flash_attention_route(int D, int window, int dtype, int biased,
                              int kv_len, int kh, int kw, int kh_valid,
                              int kw_valid, float scale) {
  if (tiled_takes(D, window, dtype, biased != 0, kv_len != 0)) return 2;
  win::WinParams wp;
  int n = 0;
  size_t smem = 0;
  if (window_plan(1, 1, window, window, D, window, dtype, biased != 0,
                  kv_len != 0, kh, kw, kh_valid, kw_valid, scale, &wp, &n,
                  &smem))
    return 3;
  return hopper_keys(D, window, dtype, biased != 0, kv_len != 0, kh, kw,
                     kh_valid, kw_valid)
             ? 1
             : 0;
}

// Returns 0 on success, a cudaError_t after a failed launch, -1 for a head
// dim without a build (32, 64 and 128 are built), or -2 when a TMA
// descriptor cannot be made. dtype: 0 = fp32,
// 1 = bf16; kh_valid = kw_valid = 0 without a kv_grid mask, window = 0
// outside window mode.
int vdr_flash_attention(const void* q, const void* k, const void* v,
                        const void* bias_h, const void* bias_w,
                        const int* kv_len, void* out, int B, int H, int Sq,
                        int Sk, int D, int kh, int kw, int kh_valid,
                        int kw_valid, int window, float scale, int dtype,
                        void* stream) {
  const FlashParams p{q,  k,  v,        bias_h,   bias_w, kv_len,
                      out, B, H,        Sq,       Sk,     kh,
                      kw, kh_valid, kw_valid, window, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled_takes(D, window, dtype, bias_h != nullptr, kv_len != nullptr))
    return launch_tiled(p, s);
  win::WinParams wp;
  int n = 0;
  size_t smem = 0;
  if (window_plan(B, H, Sq, Sk, D, window, dtype, bias_h != nullptr,
                  kv_len != nullptr, kh, kw, kh_valid, kw_valid, scale, &wp,
                  &n, &smem))
    return launch_window(p, wp, n, smem, s);
  switch (hopper_keys(D, window, dtype, bias_h != nullptr, kv_len != nullptr,
                      kh, kw, kh_valid, kw_valid)) {
    case 48: return launch_hopper<48, true>(p, s);
    case 64: return bias_h != nullptr ? launch_hopper<64, true>(p, s)
                                      : launch_hopper<64, false>(p, s);
    default: break;
  }
  switch (D) {
    case 32: return launch<32>(p, dtype, s);
    case 64: return launch<64>(p, dtype, s);
    case 128: return launch<128>(p, dtype, s);
    default: return -1;
  }
}

}  // extern "C"
