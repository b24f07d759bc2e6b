// K6 on bf16 operands: the bodies of the forward with the lse residual
// (flash_attention_fwd.cu), dq with both bias gradients
// (flash_attention_bwd_dq.cu) and dk/dv (flash_attention_bwd_dkv.cu) for
// per-head bf16 q, k, v (B, H, S, D), D = 64, with an optional decomposed
// fp32 bias bias_h (B, H, S, kh), bias_w (B, H, S, kw) (kh * kw == S, any kw
// with kh + kw <= kMaxTerms) or an optional kv_len (B,). The fp32 builds of
// the same three kernels are the register-tiled bodies of
// flash_trainable_core.cuh and f32_tiled_forward.cuh.
//
// The rounding points are those of the JAX kernels on bf16 q
// (vit_deep_radiomics_tpu/ops/attention_grad.py: _fwd_kernel,
// _recompute_p_ds, _bwd_dq_kernel, _bwd_dkv_kernel), which the plain
// versions in ops/attention_grad.py write out:
//   Q^   = bf16(q * c), c = bf16(D^-1/2 * log2 e) (JAX's weak-typed constant
//          takes q's dtype), formed in fp32 (exact) and rounded once;
//   t(x) = bf16(x * log2 e) for each bias term, the two terms of a key added
//          in fp32 before they join the score;
//   s    = Q^ k^T (bf16 products, fp32 sums) + (t(bias_h) + t(bias_w)), keys
//          at or past kv_len at -1e30 (a kv_len 0 row: every key, so the
//          lse is -1e30 and the backward's P is 1 per key, as in JAX);
//   the forward rounds P = exp2(s - m) to bf16 for P V and sums the
//          unrounded P for l;
//   dP = dO V^T on bf16 operands, dS = P (dP - D) in fp32, rounded to bf16
//          before dq, dk and the bias sums; P rounded to bf16 before dv.
// All three kernels rebuild a score with the same mma.sync sequence (four
// k16 steps from zero, dims in the same order) and the same fp32 steps, so
// exp2(s - lse) in the backward is the forward's P.
//
// The products run on the tensor cores as mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate), one warp per 16 rows of a 64-row block, 64-column
// tiles staged in shared memory by plain 16-byte loads. The bias sums of
// dq are taken in a fixed order with no atomics (so two runs give the same
// bits): dS of a tile goes to shared memory once, and one thread per
// (query row, grid rows) and one per (query row, grid columns) walk its
// keys in ascending order, which serves any kw: at SAM @768's Kw 48 a
// 64-key tile spans two grid rows.
//
// Everything a body does is CUDA-core arithmetic, shuffles, barriers and
// the warp's mma (vdr::mma_bf16_16816 of flash_attention_core.cuh), with
// control flow uniform over the block around every mma and shuffle, so the
// bodies also run on the CPU under a g++ stand-in for those
// (tests/test_torch_k6_bf16_shim.py), as does bwd_route, the choice
// between the backward's bodies here and its TMA + wgmma bodies
// (flash_trainable_hopper.cuh: no bias, or a key grid whose width is a
// multiple of 4 from 16 to 128, every SAM ViT-B/16 global grid that
// fast fine-tuning hands to K6 from 576 px up), with the Hopper bodies'
// tiling.
#pragma once

#include "flash_attention_core.cuh"

namespace vdr {
namespace k6b {

using bf16 = __nv_bfloat16;

constexpr int D = 64;        // the one head dim built
constexpr int ROWS = 64;     // a block's rows: queries (forward, dq), keys (dkv)
constexpr int COLS = 64;     // a tile's columns: keys (forward, dq), queries (dkv)
constexpr int NT = 128;      // threads a block: 4 warps of 16 rows
constexpr int LD = D + 8;    // bf16 row stride of a staged (row, D) tile
constexpr int BS = 68;       // float stride of a [term][row] table (64 + 4)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;   // a key at or past kv_len (JAX's mask)
constexpr float kPastS = -2e30f;    // a key past S: P = 0 on every row
// bias terms (kh + kw) the staged tables take; dq's shared memory at the
// limit (a [term][row] table, dbias_w sums of up to kMaxTerms columns)
// stays under 227 KB
constexpr int kMaxTerms = 320;
constexpr int kErrTerms = -2;

struct Params {
  const bf16* q;        // (B, H, S, D)
  const bf16* k;        // (B, H, S, D)
  const bf16* v;        // (B, H, S, D)
  const float* bias_h;  // (B, H, S, kh) or nullptr
  const float* bias_w;  // (B, H, S, kw) or nullptr
  const int* kv_len;    // (B,) or nullptr
  const bf16* dout;     // (B, H, S, D)  backward
  const float* lse;     // (B, H, S)     backward: log2 log-sum-exp
  const float* delta;   // (B, H, S)     backward: sum_d dO * O
  bf16* out;            // (B, H, S, D)  forward
  float* lse_out;       // (B, H, S)     forward
  bf16* dq;             // (B, H, S, D)
  bf16* dk;             // (B, H, S, D)
  bf16* dv;             // (B, H, S, D)
  float* dbh;           // (B, H, S, kh) or nullptr
  float* dbw;           // (B, H, S, kw) or nullptr
  int B, H, S, kh, kw;
  float scale;          // D^-1/2
  float scale_log2;     // bf16(D^-1/2 * log2 e), held as a float
};

// What the bf16 bodies take: with a bias, a grid of at most kMaxTerms
// terms (kh + kw).
__host__ __device__ inline bool takes(bool has_bias, int kh, int kw) {
  return !has_bias || kh + kw <= kMaxTerms;
}

// The body the bf16 backward (dq and dkv alike) runs for a call:
// kRouteHopper, the TMA + wgmma bodies of flash_trainable_hopper.cuh (no
// bias, or a key grid whose width is a multiple of 4 from 16 to
// kHopperMaxKw keys, so that a row of fp32 bias_w is whole 16-byte units
// as TMA needs, and of at most kHopperMaxKh rows, whose bias_h terms dq
// stages in one table), else kRouteMma, the mma.sync bodies below, or
// kErrTerms for a grid they refuse too. The forward keeps the mma.sync
// body whatever the shape.
constexpr int kRouteMma = 1, kRouteHopper = 2;
constexpr int kHopperMaxKw = 128;
constexpr int kHopperMaxKh = 128;
constexpr int kHopperKwStep = 4;   // the widths built: 16, 20, ... 128
__host__ __device__ constexpr bool hopper_kw(int kw) {
  return kw % kHopperKwStep == 0 && kw >= 16 && kw <= kHopperMaxKw;
}
__host__ __device__ inline int bwd_route(bool has_bias, int kh, int kw) {
  if (!has_bias || (hopper_kw(kw) && kh <= kHopperMaxKh))
    return kRouteHopper;
  return takes(has_bias, kh, kw) ? kRouteMma : kErrTerms;
}

// The Hopper bodies' tiling of a key grid kw wide (with a bias; here so
// that the CPU tests hold it without the card).
// dq takes each grid row in hopper_dq_passes(kw) passes, pass u a key
// tile of hopper_dq_tile(kw) keys (a k16 step multiple) from grid column
// u * tile; the tile's columns past the row's end are masked (per column
// pair: at Kw 4 mod 8 a pass can end inside an 8-column chunk). A pass of
// 64 live columns spilled its scores, dP, bias_w terms and dbias_w sums
// (132-236 bytes), and a first pass with masked columns before a second
// one serialized the wgmma pipeline (ptxas C7511), so one pass up to Kw 56
// (16, 32, 48 or 64 keys: Kw 56 has 56 live in 64), else ceil(Kw / 48)
// passes of at most 48 keys, every pass but the last whole: Kw 64 two of
// 32, Kw 60 two of 32 (28 live in the second), Kw 68-96 two of 48, Kw
// 100-128 three of 48. Calls with no bias take 48 consecutive keys a tile.
constexpr int kHopperNoBiasTile = 48;
__host__ __device__ constexpr int hopper_dq_passes(int kw) {
  return kw <= 56 ? 1 : (kw + 47) / 48;
}
__host__ __device__ constexpr int hopper_dq_tile(int kw) {
  return ((kw + hopper_dq_passes(kw) - 1) / hopper_dq_passes(kw) + 15) /
         16 * 16;
}
// dkv: the grid rows a block of 128 aligned keys spans, and the bf16 row of
// the staged bias_w terms, whose 16-byte chunks lie an odd number apart so
// that the 8 rows an ldmatrix reads fall in distinct banks. An 8-key block
// of a thread's warp reads its keys' terms from one 16-byte chunk of a
// query's row. At Kw 0 mod 8 the row holds the Kw terms once (padded by 8
// where Kw / 8 is even) and a block starts at column key % Kw. At Kw 4
// mod 8 a block starting at column Kw - 4 runs into the next grid row's
// columns 0-3, and one starting at 4 mod 8 is not 16-byte aligned; there
// the row holds the Kw terms twice (2 Kw columns: Kw / 4 chunks, odd) and
// a block starts at column key % (2 Kw), a multiple of 8: in even grid rows
// the first copy's column (a block at Kw - 4 reads on into the second
// copy's 0-3), in odd ones the second copy's.
__host__ __device__ constexpr int hopper_dkv_hrows(int kw) {
  return 127 / kw + 2;
}
__host__ __device__ constexpr int hopper_term_ld(int kw) {
  return kw % 8 ? 2 * kw : (kw / 8) % 2 ? kw : kw + 8;
}
__host__ __device__ constexpr int hopper_term_period(int kw) {
  return kw % 8 ? 2 * kw : kw;
}
// dkv's stage (kw 0: no bias): raw q, dO and Q^ (three 8 KB tiles), then
// with a bias the tile's fp32 bias_w rows, their bf16 terms, and fp32 lse,
// D and (bias) the bias_h terms of the block's grid rows, 64 queries each;
// the stages are as many as fit beside the K and V tiles, at most
// kHopperDkvMaxStages and at least 2 (Kw 0 mod 8: 4 up to 56, 3 up to 96, 2
// beyond; Kw 4 mod 8, whose doubled terms cost 128 Kw bytes more a stage:
// 4 up to 44, 3 up to 76, 2 beyond).
constexpr int kHopperDkvMaxStages = 4;
constexpr int kHopperTile = 64 * 64 * 2;
constexpr int kHopperSmemMax = 232448 - 256;   // 227 KB less the barriers
__host__ __device__ constexpr int hopper_term_off(int kw) {
  return 3 * kHopperTile + 64 * kw * 4;
}
__host__ __device__ constexpr int hopper_small_off(int kw) {
  return kw ? hopper_term_off(kw) + 64 * hopper_term_ld(kw) * 2
            : 3 * kHopperTile;
}
__host__ __device__ constexpr int hopper_stage_bytes(int kw) {
  return (hopper_small_off(kw) + (2 + (kw ? hopper_dkv_hrows(kw) : 0)) *
                                     64 * 4 + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr size_t hopper_dkv_smem_at(int kw, int stages) {
  return 1024 + (size_t)4 * kHopperTile +
         (size_t)stages * hopper_stage_bytes(kw);
}
__host__ __device__ constexpr int hopper_dkv_stages(int kw) {
  int n = kHopperDkvMaxStages;
  while (n > 2 && hopper_dkv_smem_at(kw, n) > kHopperSmemMax) --n;
  return n;
}
__host__ __device__ constexpr size_t hopper_dkv_smem(int kw) {
  return hopper_dkv_smem_at(kw, hopper_dkv_stages(kw));
}
// dq: Q^ and dO of both warpgroups, a ring of kHopperDqStages K/V tiles of
// the key tile's rows, and the [grid row][query] bias_h table.
constexpr int kHopperDqStages = 6;
constexpr int kHopperBiasLd = 2 * 64 + 1;
__host__ __device__ constexpr size_t hopper_dq_smem(int kw, int kh) {
  const int tile = kw ? hopper_dq_tile(kw) : kHopperNoBiasTile;
  return 1024 + (size_t)4 * kHopperTile +
         (size_t)2 * kHopperDqStages * tile * 128 +
         (size_t)kh * kHopperBiasLd * sizeof(float);
}

// Shared memory of each body (bytes), `terms` = kh + kw with a bias, else 0.
__host__ __device__ inline size_t fwd_smem(int terms) {
  return 2 * COLS * LD * sizeof(bf16) + COLS * sizeof(int2) +
         (size_t)terms * BS * sizeof(float);
}
__host__ __device__ inline size_t dq_smem(int terms, int kw) {
  return fwd_smem(terms) +
         (terms ? (size_t)(COLS + kw) * BS * sizeof(float) : 0);
}
__host__ __device__ inline size_t dkv_smem(int terms) {
  return 2 * COLS * LD * sizeof(bf16) + 2 * COLS * sizeof(float) +
         (size_t)terms * BS * sizeof(float);
}

__device__ __forceinline__ int valid_keys(const Params& p, int b) {
  return p.kv_len != nullptr ? min(p.S, max(p.kv_len[b], 0)) : p.S;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// A bias term as the JAX kernels stage it: times log2(e) in fp32, rounded
// to bf16.
__device__ __forceinline__ float term(float x) {
  return round_bf16(__fmul_rn(x, kLog2e));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 times s (a bf16 value: the product is exact in fp32), rounded
// to bf16: a pair of Q^.
__device__ __forceinline__ uint32_t ld_pair_scaled(const bf16* p, float s) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return pack_bf16(__fmul_rn(__low2float(v), s),
                   __fmul_rn(__high2float(v), s));
}

// The A fragments (16 x 64, four k16 steps) of rows r_lo and r_lo + 8 of a
// row-major (rows, D) bf16 matrix (rows at or past n read as zero); kScale
// forms Q^ with s.
template <bool kScale>
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* base,
                                       int r_lo, int n, int c, float s) {
  auto ld2 = [&](int r, int d) -> uint32_t {
    if (r >= n) return 0u;
    const bf16* ptr = base + (size_t)r * D + d;
    return kScale ? ld_pair_scaled(ptr, s) : ld_pair(ptr);
  };
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    a[kt][0] = ld2(r_lo, kt * 16 + 2 * c);
    a[kt][1] = ld2(r_lo + 8, kt * 16 + 2 * c);
    a[kt][2] = ld2(r_lo, kt * 16 + 2 * c + 8);
    a[kt][3] = ld2(r_lo + 8, kt * 16 + 2 * c + 8);
  }
}

// The B fragment of M^T for a row-major staged tile M whose rows are the
// mma's n index (k in Q^ k^T): p points at M[n0 + g][k0 + 2c].
__device__ __forceinline__ void ld_b_rows(uint32_t (&b)[2], const bf16* p) {
  b[0] = ld_pair(p);
  b[1] = ld_pair(p + 8);
}

// The same with Q^ formed from a staged raw q tile.
__device__ __forceinline__ void ld_b_rows_scaled(uint32_t (&b)[2],
                                                 const bf16* p, float s) {
  b[0] = ld_pair_scaled(p, s);
  b[1] = ld_pair_scaled(p + 8, s);
}

// The B fragment of a staged row-major tile M whose rows are the mma's k
// index (v in P v): p points at M[k0 + 2c][n0 + g].
__device__ __forceinline__ void ld_b_cols(uint32_t (&b)[2], const bf16* p) {
  __nv_bfloat162 b0, b1;
  b0.x = p[0];
  b0.y = p[LD];
  b1.x = p[8 * LD];
  b1.y = p[9 * LD];
  b[0] = *reinterpret_cast<uint32_t*>(&b0);
  b[1] = *reinterpret_cast<uint32_t*>(&b1);
}

// Two adjacent 16 x 8 accumulator tiles as one 16 x 16 bf16 A fragment
// (round to nearest even).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// Stage COLS rows of a (rows, D) bf16 matrix into dst [COLS][LD]; rows at
// or past n are zero.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int n) {
  for (int i = threadIdx.x; i < COLS * (D / 8); i += NT) {
    const int r = i / (D / 8), d8 = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) v = *reinterpret_cast<const uint4*>(src + (size_t)r * D + d8);
    *reinterpret_cast<uint4*>(dst + r * LD + d8) = v;
  }
}

// The bias terms t(x) of 64 rows from row0 of head bh, as a [term][row]
// table: term j < kh the grid-row term, kh + c the grid-column term; rows at
// or past n are zero. Each source row is contiguous, so the reads are
// coalesced.
__device__ __forceinline__ void stage_terms(float* tab, const Params& p,
                                            size_t bh, int row0, int n) {
  const float* bh_rows = p.bias_h + (bh * p.S + row0) * p.kh;
  const float* bw_rows = p.bias_w + (bh * p.S + row0) * p.kw;
  for (int i = threadIdx.x; i < ROWS * p.kh; i += NT) {
    const int r = i / p.kh, j = i % p.kh;
    tab[j * BS + r] = r < n ? term(bh_rows[i]) : 0.f;
  }
  for (int i = threadIdx.x; i < ROWS * p.kw; i += NT) {
    const int r = i / p.kw, j = i % p.kw;
    tab[(p.kh + j) * BS + r] = r < n ? term(bw_rows[i]) : 0.f;
  }
}

// The table rows of the grid-row and grid-column terms of keys k0 ..
// k0 + COLS - 1 (keys past S take row 0: they are masked).
__device__ __forceinline__ void stage_keys(int2* ktab, const Params& p,
                                           int k0) {
  for (int j = threadIdx.x; j < COLS; j += NT) {
    const int key = k0 + j;
    ktab[j] = key < p.S ? make_int2(key / p.kw, p.kh + key % p.kw)
                        : make_int2(0, 0);
  }
}

// A score from its dot product: the key's two bias terms joined in fp32 and
// added; keys at or past the valid count masked after the bias (JAX), keys
// past S below every mask.
__device__ __forceinline__ float finish(float dot, bool bias, float th,
                                        float tw, int key, int n_valid,
                                        int S) {
  if (key >= S) return kPastS;
  if (key >= n_valid) return kNegInf;
  return bias ? __fadd_rn(dot, __fadd_rn(th, tw)) : dot;
}

// S = Q^ k^T for the warp's 16 rows and 8 keys (n8 tile nt of a staged
// key tile): four k16 steps from zero, the sequence every body uses.
__device__ __forceinline__ void score_n8(float (&s)[4],
                                         const uint32_t (&qa)[4][4],
                                         const bf16* ks, int nt, int g,
                                         int c) {
  s[0] = s[1] = s[2] = s[3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    uint32_t b[2];
    ld_b_rows(b, ks + (nt * 8 + g) * LD + kt * 16 + 2 * c);
    mma_bf16_16816(s, qa[kt], b);
  }
}

// ---------------------------------------------------------------------------
// Forward: 64 query rows of one (batch, head) a block, online softmax over
// 64-key tiles.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void forward(const Params& p, int b, int h,
                                        int row0, char* smem) {
  bf16* ks = reinterpret_cast<bf16*>(smem);            // [COLS][LD]
  bf16* vs = ks + COLS * LD;                            // [COLS][LD]
  int2* ktab = reinterpret_cast<int2*>(vs + COLS * LD);  // [COLS]
  float* tab = reinterpret_cast<float*>(ktab + COLS);   // [terms][BS]
  const size_t bh = (size_t)b * p.H + h;
  const size_t base = bh * p.S * D;
  const int nrows = min(ROWS, p.S - row0);
  const int n_valid = valid_keys(p, b);
  const int lim = n_valid == 0 ? p.S : n_valid;   // keys visited
  const bool bias = p.bias_h != nullptr;
  if (bias) stage_terms(tab, p, bh, row0, nrows);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int lr_lo = warp * 16 + g, lr_hi = lr_lo + 8;
  uint32_t qa[4][4];
  load_a<true>(qa, p.q + base, row0 + lr_lo, p.S, c, p.scale_log2);

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_lo = kPastS, m_hi = kPastS, l_lo = 0.f, l_hi = 0.f;

  for (int k0 = 0; k0 < lim; k0 += COLS) {
    const int nk = min(COLS, p.S - k0);
    __syncthreads();
    stage_rows(ks, p.k + base + (size_t)k0 * D, nk);
    stage_rows(vs, p.v + base + (size_t)k0 * D, nk);
    if (bias) stage_keys(ktab, p, k0);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) score_n8(s[nt], qa, ks, nt, g, c);
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * c + (e & 1), key = k0 + j;
        const int lr = e < 2 ? lr_lo : lr_hi;
        float th = 0.f, tw = 0.f;
        if (bias && key < p.S) {
          const int2 kt = ktab[j];
          th = tab[kt.x * BS + lr];
          tw = tab[kt.y * BS + lr];
        }
        s[nt][e] = finish(s[nt][e], bias, th, tw, key, n_valid, p.S);
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
    for (int i = 0; i < 8; ++i) {
      o[i][0] *= a_lo;
      o[i][1] *= a_lo;
      o[i][2] *= a_hi;
      o[i][3] *= a_hi;
    }
    // P in fp32 for the row sums, rounded to bf16 for P v
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - m_lo), p1 = exp2f(s[nt][1] - m_lo);
      const float p2 = exp2f(s[nt][2] - m_hi), p3 = exp2f(s[nt][3] - m_hi);
      l_lo += p0 + p1;
      l_hi += p2 + p3;
      pa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    // O += P v: k = the tile's keys (16 a step), n = head dims (8 a tile)
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        uint32_t bv[2];
        ld_b_cols(bv, vs + (kt * 16 + 2 * c) * LD + dt * 8 + g);
        mma_bf16_16816(o[dt], pa[kt], bv);
      }
    }
  }
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float sl_lo = l_lo > 0.f ? l_lo : 1.f, sl_hi = l_hi > 0.f ? l_hi : 1.f;
  const int r_lo = row0 + lr_lo, r_hi = row0 + lr_hi;
  if (c == 0) {
    float* lse = p.lse_out + bh * p.S;
    if (r_lo < p.S) lse[r_lo] = m_lo + log2f(sl_lo);
    if (r_hi < p.S) lse[r_hi] = m_hi + log2f(sl_hi);
  }
  bf16* out = p.out + base;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int d = dt * 8 + 2 * c;
    if (r_lo < p.S)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r_lo * D + d) =
          __floats2bfloat162_rn(o[dt][0] / sl_lo, o[dt][1] / sl_lo);
    if (r_hi < p.S)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r_hi * D + d) =
          __floats2bfloat162_rn(o[dt][2] / sl_hi, o[dt][3] / sl_hi);
  }
}

// ---------------------------------------------------------------------------
// dq and both bias gradients: 64 query rows a block, 64-key tiles.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void dq(const Params& p, int b, int h, int row0,
                                   char* smem) {
  bf16* ks = reinterpret_cast<bf16*>(smem);            // [COLS][LD]
  bf16* vs = ks + COLS * LD;                            // [COLS][LD]
  int2* ktab = reinterpret_cast<int2*>(vs + COLS * LD);  // [COLS]
  float* tab = reinterpret_cast<float*>(ktab + COLS);   // [terms][BS]
  const bool bias = p.bias_h != nullptr;
  const int terms = bias ? p.kh + p.kw : 0;
  float* dss = tab + terms * BS;       // [COLS][BS] dS^T of a tile (bias)
  float* dbw_s = dss + COLS * BS;      // [kw][BS] dbias_w sums (bias)
  const size_t bh = (size_t)b * p.H + h;
  const size_t base = bh * p.S * D;
  const int nrows = min(ROWS, p.S - row0);
  const int n_valid = valid_keys(p, b);
  const int lim = n_valid == 0 ? p.S : n_valid;
  if (bias) {
    stage_terms(tab, p, bh, row0, nrows);
    for (int i = threadIdx.x; i < p.kw * BS; i += NT) dbw_s[i] = 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int lr_lo = warp * 16 + g, lr_hi = lr_lo + 8;
  const int r_lo = row0 + lr_lo, r_hi = row0 + lr_hi;
  uint32_t qa[4][4], da[4][4];
  load_a<true>(qa, p.q + base, r_lo, p.S, c, p.scale_log2);
  load_a<false>(da, p.dout + base, r_lo, p.S, c, 1.f);
  const float* lse = p.lse + bh * p.S;
  const float* dl = p.delta + bh * p.S;
  const float lse_lo = r_lo < p.S ? lse[r_lo] : 0.f;
  const float lse_hi = r_hi < p.S ? lse[r_hi] : 0.f;
  const float dl_lo = r_lo < p.S ? dl[r_lo] : 0.f;
  const float dl_hi = r_hi < p.S ? dl[r_hi] : 0.f;

  // the bias sums: thread qr of role 0 sums its row's dS over each grid
  // row, role 1 over each grid column; (brow, bcol) is the grid cell of the
  // next key
  const int qr = threadIdx.x % ROWS, role = threadIdx.x / ROWS;
  const size_t dbh_row = (bh * p.S + row0 + qr) * p.kh;
  int brow = 0, bcol = 0;
  float bacc = 0.f;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < lim; k0 += COLS) {
    const int nk = min(COLS, p.S - k0);
    __syncthreads();
    stage_rows(ks, p.k + base + (size_t)k0 * D, nk);
    stage_rows(vs, p.v + base + (size_t)k0 * D, nk);
    if (bias) stage_keys(ktab, p, k0);
    __syncthreads();

#pragma unroll
    for (int kc = 0; kc < COLS / 16; ++kc) {
      if (kc * 16 >= nk) break;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int nt = 2 * kc + u;
        score_n8(s[u], qa, ks, nt, g, c);
        dp[u][0] = dp[u][1] = dp[u][2] = dp[u][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          uint32_t bv[2];
          ld_b_rows(bv, vs + (nt * 8 + g) * LD + kt * 16 + 2 * c);
          mma_bf16_16816(dp[u], da[kt], bv);
        }
      }
      float ds[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = (2 * kc + u) * 8 + 2 * c + (e & 1), key = k0 + j;
          const bool lo = e < 2;
          const int lr = lo ? lr_lo : lr_hi;
          float th = 0.f, tw = 0.f;
          if (bias && key < p.S) {
            const int2 kt = ktab[j];
            th = tab[kt.x * BS + lr];
            tw = tab[kt.y * BS + lr];
          }
          const float sv = finish(s[u][e], bias, th, tw, key, n_valid, p.S);
          const float pv = exp2f(sv - (lo ? lse_lo : lse_hi));
          ds[u][e] = round_bf16(pv * (dp[u][e] - (lo ? dl_lo : dl_hi)));
          if (bias) dss[j * BS + lr] = ds[u][e];
        }
      }
      // dq += dS k: k = the chunk's 16 keys, n = head dims
      uint32_t a[4];
      c_to_a(a, ds);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        uint32_t bk[2];
        ld_b_cols(bk, ks + (kc * 16 + 2 * c) * LD + dt * 8 + g);
        mma_bf16_16816(acc[dt], a, bk);
      }
    }
    if (!bias) continue;
    __syncthreads();
    // the tile's keys below S in ascending order
    for (int j = 0; j < nk; ++j) {
      const float x = dss[j * BS + qr];
      if (role == 0)
        bacc += x;
      else
        dbw_s[bcol * BS + qr] += x;
      if (++bcol == p.kw) {
        bcol = 0;
        if (role == 0 && qr < nrows) p.dbh[dbh_row + brow] = bacc;
        bacc = 0.f;
        ++brow;
      }
    }
  }
  bf16* dqo = p.dq + base;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int d = dt * 8 + 2 * c;
    if (r_lo < p.S)
      *reinterpret_cast<__nv_bfloat162*>(dqo + (size_t)r_lo * D + d) =
          __floats2bfloat162_rn(acc[dt][0] * p.scale, acc[dt][1] * p.scale);
    if (r_hi < p.S)
      *reinterpret_cast<__nv_bfloat162*>(dqo + (size_t)r_hi * D + d) =
          __floats2bfloat162_rn(acc[dt][2] * p.scale, acc[dt][3] * p.scale);
  }
  if (!bias) return;
  // grid rows cut short or never reached (keys past kv_len): their dS is 0
  if (role == 0 && qr < nrows) {
    if (bcol) p.dbh[dbh_row + brow++] = bacc;
    for (; brow < p.kh; ++brow) p.dbh[dbh_row + brow] = 0.f;
  }
  __syncthreads();
  float* dbw = p.dbw + (bh * p.S + row0) * p.kw;
  for (int i = threadIdx.x; i < nrows * p.kw; i += NT)
    dbw[i] = dbw_s[(i % p.kw) * BS + i / p.kw];
}

// ---------------------------------------------------------------------------
// dk and dv: 64 keys of one (batch, head) a block, 64-query tiles.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void dkv(const Params& p, int b, int h, int key0,
                                    char* smem) {
  bf16* qs = reinterpret_cast<bf16*>(smem);            // [COLS][LD] raw q
  bf16* dos = qs + COLS * LD;                           // [COLS][LD] dO
  float* lse_s = reinterpret_cast<float*>(dos + COLS * LD);  // [COLS]
  float* dl_s = lse_s + COLS;                           // [COLS]
  float* tab = dl_s + COLS;                             // [terms][BS]
  const bool bias = p.bias_h != nullptr;
  const size_t bh = (size_t)b * p.H + h;
  const size_t base = bh * p.S * D;
  const int n_valid = valid_keys(p, b);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int key_lo = key0 + warp * 16 + g, key_hi = key_lo + 8;
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  // keys all at or past a non-zero kv_len: P = 0 on every row, so dk and
  // dv are zero; with kv_len 0 every key takes P = 1 and is visited
  const bool live = n_valid == 0 || key0 < n_valid;
  uint32_t ka[4][4], va[4][4];
  load_a<false>(ka, p.k + base, key_lo, p.S, c, 1.f);
  load_a<false>(va, p.v + base, key_lo, p.S, c, 1.f);
  // this thread's keys' rows of the bias table
  int th_lo = 0, th_hi = 0, tw_lo = 0, tw_hi = 0;
  if (bias) {
    if (key_lo < p.S) th_lo = key_lo / p.kw, tw_lo = p.kh + key_lo % p.kw;
    if (key_hi < p.S) th_hi = key_hi / p.kw, tw_hi = p.kh + key_hi % p.kw;
  }

  for (int q0 = 0; live && q0 < p.S; q0 += COLS) {
    const int nq = min(COLS, p.S - q0);
    __syncthreads();
    stage_rows(qs, p.q + base + (size_t)q0 * D, nq);
    stage_rows(dos, p.dout + base + (size_t)q0 * D, nq);
    for (int i = threadIdx.x; i < COLS; i += NT) {
      lse_s[i] = i < nq ? p.lse[bh * p.S + q0 + i] : 0.f;
      dl_s[i] = i < nq ? p.delta[bh * p.S + q0 + i] : 0.f;
    }
    if (bias) stage_terms(tab, p, bh, q0, nq);
    __syncthreads();

#pragma unroll
    for (int qc = 0; qc < COLS / 16; ++qc) {
      if (qc * 16 >= nq) break;
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int nt = 2 * qc + u;
        st[u][0] = st[u][1] = st[u][2] = st[u][3] = 0.f;
        dpt[u][0] = dpt[u][1] = dpt[u][2] = dpt[u][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          uint32_t bq[2], bd[2];
          ld_b_rows_scaled(bq, qs + (nt * 8 + g) * LD + kt * 16 + 2 * c,
                           p.scale_log2);
          mma_bf16_16816(st[u], ka[kt], bq);
          ld_b_rows(bd, dos + (nt * 8 + g) * LD + kt * 16 + 2 * c);
          mma_bf16_16816(dpt[u], va[kt], bd);
        }
      }
      float pt[2][4], dst[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (2 * qc + u) * 8 + 2 * c + (e & 1);
          const bool lo = e < 2;
          const int key = lo ? key_lo : key_hi;
          float th = 0.f, tw = 0.f;
          if (bias) {
            th = tab[(lo ? th_lo : th_hi) * BS + i];
            tw = tab[(lo ? tw_lo : tw_hi) * BS + i];
          }
          const float sv = finish(st[u][e], bias, th, tw, key, n_valid, p.S);
          const float pv = i < nq ? exp2f(sv - lse_s[i]) : 0.f;
          pt[u][e] = pv;
          dst[u][e] = pv * (dpt[u][e] - dl_s[i]);
        }
      }
      // dv += P^T dO, dk += dS^T q: k = the chunk's 16 queries
      uint32_t pa[4], sa[4];
      c_to_a(pa, pt);
      c_to_a(sa, dst);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        uint32_t bb[2];
        ld_b_cols(bb, dos + (qc * 16 + 2 * c) * LD + dt * 8 + g);
        mma_bf16_16816(dv[dt], pa, bb);
        ld_b_cols(bb, qs + (qc * 16 + 2 * c) * LD + dt * 8 + g);
        mma_bf16_16816(dk[dt], sa, bb);
      }
    }
  }
  bf16* dko = p.dk + base;
  bf16* dvo = p.dv + base;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int d = dt * 8 + 2 * c;
    if (key_lo < p.S) {
      *reinterpret_cast<__nv_bfloat162*>(dko + (size_t)key_lo * D + d) =
          __floats2bfloat162_rn(dk[dt][0] * p.scale, dk[dt][1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvo + (size_t)key_lo * D + d) =
          __floats2bfloat162_rn(dv[dt][0], dv[dt][1]);
    }
    if (key_hi < p.S) {
      *reinterpret_cast<__nv_bfloat162*>(dko + (size_t)key_hi * D + d) =
          __floats2bfloat162_rn(dk[dt][2] * p.scale, dk[dt][3] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvo + (size_t)key_hi * D + d) =
          __floats2bfloat162_rn(dv[dt][2], dv[dt][3]);
    }
  }
}

#ifdef __CUDACC__
// The bf16 value of D^-1/2 * log2(e) that Q^ is formed with.
inline float scale_log2_bf16(float scale) {
  return __bfloat162float(__float2bfloat16(scale * kLog2e));
}

// Launch a body's kernel over (ceil(S / 64), H, B) blocks of NT threads;
// the CUDA error of the attribute call or of the launch (0 on success).
template <typename Kernel>
int launch(Kernel kernel, const Params& p, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + ROWS - 1) / ROWS, p.H, p.B);
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
#endif

}  // namespace k6b
}  // namespace vdr
