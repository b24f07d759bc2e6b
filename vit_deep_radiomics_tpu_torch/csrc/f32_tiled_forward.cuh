// The register-tiled fp32 attention forward shared by K1
// (fused_window_attention.cu), K2 (fused_global_attention.cu), K3
// (flash_attention.cu) and the K6 forward (flash_attention_fwd.cu): the
// body of their `parity` calls at D = 64 (K3 in window mode too, one
// (batch, window, head) a problem; K6 always, with its log2 lse residual).
//
// Computes, for one (batch, head) and its query rows i,
//     out_i = sum_j p_ij v_j / sum_j p_ij,  p_ij = exp2(s_ij - m_i)
//     s_ij  = (q_i . D^-1/2 log2 e) . k_j + bias_h[i, j / Kw] log2 e
//                                         + bias_w[i, j % Kw] log2 e
// over the visited keys, in log2 units with the running max kept. The
// block visits n_visit key slots; slot j is key (j / gw) Kw + j % gw of the
// (Kh, Kw) key grid, so gw = Kw visits keys 0 .. n_visit - 1 and gw < Kw
// skips each grid row's columns from gw on. A key at or past n_valid, or
// outside the (kh_valid, kw_valid) sub-grid of the key grid, scores
// `masked` instead; a slot past n_visit (a ragged last tile) scores
// `absent`. The callers' rules differ only
// in those numbers (k1_problem, k2_problem, k3_problem, k6_problem below):
// K1 takes K2's, and each window is a problem of its own; K2 masks to
// -1e30 log2 e and drops keys past the segment at -2e30; K3 masks to -1e30
// and drops keys past its range at -inf; K6 masks to -1e30 and drops
// slots past its range at -2e30. So a row with no valid key averages V
// over the keys it visits, as the plain versions do.
//
// K6's scores must be the bits its two backward kernels rebuild
// (flash_trainable_core.cuh): the dot product as two FMA chains, dims
// 0..31 and 32..63, joined by one __fadd_rn (bwd::score_tile, kSplit), and
// the bias as dot + (bias_h log2 e + bias_w log2 e). Every product and sum
// of the bias and of the pre-scaled q is written with __fmul_rn /
// __fadd_rn, which nvcc never contracts into an FMA; the same IEEE
// expressions as before for K2 and K3, whose single chain stays. With
// p.lse set the body also writes lse_i = m_i + log2(l_i) per row.
//
// K6 also sums each tile's P V in an accumulator of its own and folds it
// into O with one fmaf(O, alpha, tile) (kTileSum). Its backward takes
// D = sum_d dO O from this output, and dS = P (dP - D) is sensitive to a
// bias in O along O: summed key by key over 4096 keys, the small P v
// terms that fall below half an ulp of the running O are dropped, and on
// real activations (V with a common direction) they are dropped along O.
// The lane partials of l lose almost nothing, so O came out about 2e-6
// small on average and the global layers' bias gradients 1e-4 off
// (PERF.md, PR 11). Summed a tile at a time, O loses what l loses.
//
// What bounds it on an H100 SXM (67 TFLOP/s fp32 on the CUDA cores, no
// tensor cores: `parity` must not round to TF32): 4 S_q S_k D FLOP per
// (batch, head) against about 4 S D words. At K2's `parity` @1024 shape (4
// x 12 heads x 4096 tokens) that is 206 GFLOP, 3.08 ms, against 0.06 ms of
// traffic; at K3's @768 shape (4 x 12 x 3072 tokens, 2304 valid) 116 GFLOP
// handed to it, 1.73 ms, 0.97 ms on the valid keys. The first loops (one
// thread a query row, every FMA's other operand a shared-memory broadcast)
// ran at about 21% of that rate: the load/store pipe paced them.
//
// What the design does about it: register tiles, as an SGEMM, on the
// helpers of the K6 backward (flash_trainable_core.cuh, namespace bwd,
// used as they are). A block of 128 threads owns 64 query rows, staged
// once in shared memory pre-scaled by D^-1/2 log2 e (one rounding). K and V
// tiles of kCols keys arrive by cp.async (16 bytes, zero-filled past the
// end), into one buffer or two (the next while the current one is used;
// the callers take one, with P in the tile's K buffer: less shared memory,
// so three blocks share an SM, which hides the copies better). Thread
// t = 8 ty + tx scores rows ty + 16 i (i < 4) against keys tx + 8 j (j <
// kCols / 8) as sequential FMA chains over float4 loads, adds the bias
// terms from the staged [term][row] rows, and takes each row's max across
// the row's 8 lanes (one warp) by shuffles. P goes to shared memory as a
// [key][row] tile, and each thread accumulates O for rows 4 ty .. 4 ty + 3
// and dims 4 tx .. 4 tx + 3, 32 + 4 tx .. 35 + 4 tx (a 4 x 8 register
// tile). Score rows (ty + 16 i) are not accumulator rows (4 ty + i), so a
// row's rescale factor reaches its accumulator through shared memory with
// P, and its sum the same way at the end (each lane keeps a partial sum;
// they are joined once). No atomics: two runs give the same bits.
#pragma once

#include <math.h>

#include "flash_trainable_core.cuh"

namespace vdr {
namespace tiled {

using k6::bwd::accumulate;
using k6::bwd::chain;
using k6::bwd::cp_async16;
using k6::bwd::cp_async_commit;
using k6::bwd::cp_async_wait_all;
using k6::bwd::ld4;
using k6::bwd::score_tile;
using k6::bwd::store_cols;

constexpr int D = k6::D;          // 64, the one head dim built
constexpr int ROWS = k6::ROWS;    // 64 query rows a block
constexpr int NT = k6::bwd::NT;   // 128 threads a block
constexpr int TX = k6::bwd::TX;   // 8 lanes along a tile's keys
constexpr int TY = k6::bwd::TY;   // 16 along the block's rows
constexpr int TR = k6::bwd::TR;   // 4 score rows a thread
constexpr int LD = k6::bwd::LD;   // row stride of a staged (row, D) tile
constexpr int LP = k6::bwd::LP;   // row stride of the [key][row] P tile
// row stride of the [term][row] bias: the 8 keys and 4 rows a warp reads at
// once sit on 32 distinct banks (bank 4 c + r for grid column c, row r)
constexpr int BS = ROWS + 4;
static_assert(ROWS == TY * TR && LP == ROWS + 4 && LP == LD,
              "the bwd helpers' shape; P fits a K tile");

using k6::kLog2e;

// One (batch, head) of a call, in the caller's layout.
struct Problem {
  const float* q;       // query row 0, rows ldq floats apart
  const float* k;       // key 0, rows ldkv floats apart
  const float* v;       // value 0, rows ldkv floats apart
  float* out;           // output row 0, rows ldo floats apart
  float* lse;           // (n_rows) log2 log-sum-exp of each row, or nullptr
  const float* bias_h;  // (n_rows, kh) of this (batch, head), or nullptr
  const float* bias_w;  // (n_rows, kw), or nullptr
  long long ldq, ldkv, ldo;
  int n_rows;           // query rows
  int kh, kw;           // key grid (kw 1 without bias or grid)
  int gw;               // columns a grid row visits (kw, or kw_valid)
  int n_visit;          // key slots visited: [0, n_visit)
  int n_valid;          // keys scored: [0, n_valid) (and inside the grid)
  int kh_valid, kw_valid;  // valid key sub-grid (0: no grid mask)
  float masked;         // the score of a visited key that is not scored
  float absent;         // the score of a slot past n_visit (<= masked): the
                        // running max starts at `masked`
  float scale_log2;     // D^-1/2 * log2(e)
};

// K2 (q (B, S, H*D), kv (B, S, 2*H*D), out (B, S, H*D), per-head bias
// (B, H, S, kh|kw)): keys at or past kv_len score -1e30 log2 e (JAX's mask
// in log2 units) and are not visited unless kv_len is 0, when every key of
// the row is visited at that score; keys past S score -2e30.
__host__ __device__ inline Problem k2_problem(
    const float* q, const float* kv, const float* bias_h,
    const float* bias_w, const int* kv_len, float* out, int S, int H,
    int kh, int kw, float scale_log2, int b, int h) {
  const long long C = (long long)H * D;
  Problem p;
  p.q = q + (long long)b * S * C + h * D;
  p.k = kv + (long long)b * S * 2 * C + h * D;
  p.v = p.k + C;
  p.out = out + (long long)b * S * C + h * D;
  p.lse = nullptr;
  const long long head = (long long)b * H + h;
  p.bias_h = bias_h != nullptr ? bias_h + head * S * kh : nullptr;
  p.bias_w = bias_h != nullptr ? bias_w + head * S * kw : nullptr;
  p.ldq = p.ldo = C;
  p.ldkv = 2 * C;
  p.n_rows = S;
  p.kh = bias_h != nullptr ? kh : 0;
  p.kw = p.gw = bias_h != nullptr ? kw : 1;
  int lim = S;
  if (kv_len != nullptr) {
    lim = kv_len[b] < 0 ? 0 : kv_len[b];
    lim = lim < S ? lim : S;
  }
  p.n_visit = lim > 0 ? lim : S;
  p.n_valid = lim;
  p.kh_valid = p.kw_valid = 0;
  p.masked = -1e30f * kLog2e;
  p.absent = 2.f * -1e30f;
  p.scale_log2 = scale_log2;
  return p;
}

// K1 (the layouts of K2; the token axis a concatenation of windows of T
// tokens, each attending to itself): one (window w, head) is a problem of
// T rows and T keys, every one scored, with K2's mask values (slots past T
// in a ragged last tile score -2e30).
__host__ __device__ inline Problem k1_problem(
    const float* q, const float* kv, const float* bias_h,
    const float* bias_w, float* out, int S, int H, int T, int kh, int kw,
    float scale_log2, int b, int w, int h) {
  const long long C = (long long)H * D;
  const long long tok = (long long)b * S + (long long)w * T;
  Problem p;
  p.q = q + tok * C + h * D;
  p.k = kv + tok * 2 * C + h * D;
  p.v = p.k + C;
  p.out = out + tok * C + h * D;
  p.lse = nullptr;
  const long long row = ((long long)b * H + h) * S + (long long)w * T;
  p.bias_h = bias_h != nullptr ? bias_h + row * kh : nullptr;
  p.bias_w = bias_h != nullptr ? bias_w + row * kw : nullptr;
  p.ldq = p.ldo = C;
  p.ldkv = 2 * C;
  p.n_rows = p.n_visit = p.n_valid = T;
  p.kh = bias_h != nullptr ? kh : 0;
  p.kw = p.gw = bias_h != nullptr ? kw : 1;
  p.kh_valid = p.kw_valid = 0;
  p.masked = -1e30f * kLog2e;
  p.absent = 2.f * -1e30f;
  p.scale_log2 = scale_log2;
  return p;
}

// K3 (head-major q (B, H, Sq, D), k/v (B, H, Sk, D), out like q; bias
// (B, H, Sq, kh|kw)): keys at or past kv_len and keys outside the
// (kh_valid, kw_valid) sub-grid score -1e30; when every row keeps a valid
// key (kv_len >= 1; the wrapper refuses an empty kv_grid) the keys past
// kv_len and past the grid's valid rows are not visited, nor, with
// skip_cols, the columns past kw_valid (their weights are exact zeros too:
// SAM @768's 48 x 48 grid padded to 48 x 64 visits 2304 keys, not 3072);
// keys past the range score -inf. In window mode (win > 0 tokens a window,
// Sq == Sk, no kv_len, kh * kw == win) the problem is window w of the
// (batch, head): its win query rows and its own win keys, the bias rows of
// those queries (SAM's 16 x 16 windows with 14 x 14 valid visit 196 keys
// of 256).
__host__ __device__ inline Problem k3_problem(
    const float* q, const float* k, const float* v, const float* bias_h,
    const float* bias_w, const int* kv_len, float* out, int H, int Sq,
    int Sk, int kh, int kw, int kh_valid, int kw_valid, bool skip_cols,
    float scale_log2, int b, int h, int win = 0, int w = 0) {
  const long long head = (long long)b * H + h;
  // the first query row and key of the problem, rows of the (B*H*S, D)
  // views
  const long long row = head * Sq + (long long)w * win;
  const long long key0 = head * Sk + (long long)w * win;
  if (win) Sq = Sk = win;
  Problem p;
  p.q = q + row * D;
  p.k = k + key0 * D;
  p.v = v + key0 * D;
  p.out = out + row * D;
  p.lse = nullptr;
  p.bias_h = bias_h != nullptr ? bias_h + row * kh : nullptr;
  p.bias_w = bias_h != nullptr ? bias_w + row * kw : nullptr;
  p.ldq = p.ldkv = p.ldo = D;
  p.n_rows = Sq;
  p.kh = bias_h != nullptr ? kh : 0;
  p.kw = p.gw = bias_h != nullptr ? kw : 1;
  // a kv_grid wider than the grid masks no column (and a row visits no
  // more than its kw columns)
  p.kh_valid = kh_valid;
  p.kw_valid = kw_valid < kw ? kw_valid : kw;
  const int kvl = kv_len != nullptr ? kv_len[b] : Sk;
  p.n_valid = kvl < 0 ? 0 : (kvl < Sk ? kvl : Sk);
  p.n_visit = Sk;
  if (kv_len == nullptr || kvl >= 1) {
    p.n_visit = p.n_valid;
    if (kh_valid && kh_valid * kw < p.n_visit) p.n_visit = kh_valid * kw;
    if (skip_cols && kh_valid) {
      // the valid cells of the keys below n_visit: whole grid rows, then
      // the start of one more
      const int rows = p.n_visit / kw, rest = p.n_visit - rows * kw;
      p.gw = p.kw_valid;
      p.n_visit = rows * p.kw_valid + (rest < p.kw_valid ? rest : p.kw_valid);
    }
  }
  p.masked = -1e30f;
  p.absent = -INFINITY;
  p.scale_log2 = scale_log2;
  return p;
}

// The window and the first row of block x of a window-mode launch: block x
// is the 64-row block x % n of window x / n, n = ceil(win / ROWS) blocks a
// window (a ragged last block of a window is bounded by its n_rows); win
// 0: one window of every row.
struct Block {
  int w, row0;
};
__host__ __device__ inline Block window_block(int x, int win) {
  if (win == 0) return {0, x * ROWS};
  const int n = (win + ROWS - 1) / ROWS;
  return {x / n, (x % n) * ROWS};
}

// K6 (head-major q, k, v, out (B, H, S, D); bias (B, H, S, kh|kw); lse
// (B, H, S)): keys at or past kv_len score -1e30 (already log2 units, as
// the backward's mask) and are not visited unless kv_len is 0, when every
// key of the row is visited at that score (P = 1 on each, out the mean of
// V, lse -1e30 + log2(S)); slots past S score -2e30 (bwd::kPastS), below
// the running max's start.
__host__ __device__ inline Problem k6_problem(
    const float* q, const float* k, const float* v, const float* bias_h,
    const float* bias_w, const int* kv_len, float* out, float* lse, int H,
    int S, int kh, int kw, float scale_log2, int b, int h) {
  const long long head = (long long)b * H + h;
  Problem p;
  p.q = q + head * S * D;
  p.k = k + head * S * D;
  p.v = v + head * S * D;
  p.out = out + head * S * D;
  p.lse = lse + head * S;
  p.bias_h = bias_h != nullptr ? bias_h + head * S * kh : nullptr;
  p.bias_w = bias_h != nullptr ? bias_w + head * S * kw : nullptr;
  p.ldq = p.ldkv = p.ldo = D;
  p.n_rows = S;
  p.kh = bias_h != nullptr ? kh : 0;
  p.kw = p.gw = bias_h != nullptr ? kw : 1;
  int lim = S;
  if (kv_len != nullptr) {
    lim = kv_len[b] < 0 ? 0 : kv_len[b];
    lim = lim < S ? lim : S;
  }
  p.n_visit = lim > 0 ? lim : S;
  p.n_valid = lim;
  p.kh_valid = p.kw_valid = 0;
  p.masked = k6::kNegInf;
  p.absent = k6::bwd::kPastS;
  p.scale_log2 = scale_log2;
  return p;
}

// Start copying the rows of key slots [j0, j0 + R) (D fp32 each, ld floats
// apart from key 0 at src) into dst [R][LD]; slots at or past n are
// zero-filled.
template <int R>
__device__ __forceinline__ void copy_keys(float* dst, const float* src,
                                          const Problem& p, int j0, int n) {
  for (int i = threadIdx.x; i < R * (D / 4); i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const int j = j0 + (r < n ? r : 0);
    const int key = (j / p.gw) * p.kw + j % p.gw;
    cp_async16(dst + r * LD + c, src + key * p.ldkv + c, r < n);
  }
}

template <int kCols, int kStages, bool kPInK>
__host__ __device__ constexpr int smem_floats(int kh, int kw) {
  return ROWS * LD + kStages * 2 * kCols * LD + (kPInK ? 0 : kCols * LP) +
         ROWS +
         (kh + kw) * BS;
}

// The forward of query rows [row0, row0 + ROWS) of one (batch, head).
// kCols keys a tile (32 or 64: a 4 x kCols/8 score micro-tile), kStages
// tile buffers (1 or 2), kPInK: P takes the place of the tile's K once
// every score is made (one barrier more a tile, one [kCols][LP] tile less
// of shared memory), kBias: p.bias_h is set, kSplit: the dot product as
// K6's two joined chains, kTileSum: each tile's P V summed on its own.
template <int kCols, int kStages, bool kPInK, bool kBias, bool kSplit = false,
          bool kTileSum = false>
__device__ void forward(const Problem& p, int row0, float* smem) {
  constexpr int TC = kCols / TX;
  constexpr int kStage = 2 * kCols * LD;   // floats of one K + V buffer
  float* qs = smem;                        // [ROWS][LD] pre-scaled q
  float* stages = qs + ROWS * LD;          // kStages x (k, v) [kCols][LD]
  float* ps = stages + kStages * kStage;   // [kCols][LP] P^T (or in K)
  float* row_s = ps + (kPInK ? 0 : kCols * LP);  // [ROWS] rescale, sums
  float* bias_s = row_s + ROWS;            // [kh + kw][BS] bias * log2(e)
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const int nrows = min(ROWS, p.n_rows - row0);
  const int nt = (p.n_visit + kCols - 1) / kCols;

  auto fetch = [&](int t) {
    float* st = stages + (kStages == 2 ? (t & 1) : 0) * kStage;
    const int j0 = t * kCols, n = min(kCols, p.n_visit - j0);
    copy_keys<kCols>(st, p.k, p, j0, n);
    copy_keys<kCols>(st + kCols * LD, p.v, p, j0, n);
  };
  if (kStages == 2 && nt > 0) fetch(0);
  cp_async_commit();

  // the block's rows: q times D^-1/2 log2(e), the bias terms times
  // log2(e); zero past the last row
  for (int i = threadIdx.x; i < ROWS * (D / 4); i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) {
      x = ld4(p.q + (row0 + r) * p.ldq + c);
      x.x = __fmul_rn(x.x, p.scale_log2);
      x.y = __fmul_rn(x.y, p.scale_log2);
      x.z = __fmul_rn(x.z, p.scale_log2);
      x.w = __fmul_rn(x.w, p.scale_log2);
    }
    *reinterpret_cast<float4*>(qs + r * LD + c) = x;
  }
  if (kBias) {
    const float* bh = p.bias_h + (long long)row0 * p.kh;
    const float* bw = p.bias_w + (long long)row0 * p.kw;
    for (int i = threadIdx.x; i < ROWS * p.kh; i += NT) {
      const int r = i / p.kh, c = i % p.kh;
      bias_s[c * BS + r] = r < nrows ? __fmul_rn(bh[i], kLog2e) : 0.f;
    }
    for (int i = threadIdx.x; i < ROWS * p.kw; i += NT) {
      const int r = i / p.kw, c = i % p.kw;
      bias_s[(p.kh + c) * BS + r] =
          r < nrows ? __fmul_rn(bw[i], kLog2e) : 0.f;
    }
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  float m[TR], l[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = p.masked;
    l[i] = 0.f;
  }
  const bool grid = p.kh_valid > 0;

  for (int t = 0; t < nt; ++t) {
    float* st = stages + (kStages == 2 ? (t & 1) : 0) * kStage;
    float* pt = kPInK ? st : ps;
    if (kStages == 1) {
      __syncthreads();   // the last tile's products are done with it
      fetch(t);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();
    // the next tile loads during this one (its buffer's last readers, the
    // tile before, finished before the barrier above)
    if (kStages == 2 && t + 1 < nt) {
      fetch(t + 1);
      cp_async_commit();
    }
    float s[TR][TC] = {};   // zero for the probe without the products
    if constexpr (kSplit)
      score_tile(s, qs, st);
    else
      chain<0, D>(s, qs, st);

    // each of this thread's keys: scored (with its bias rows' offsets), or
    // its fixed score
    bool ok[TC];
    float fixed[TC];
    int ho[TC], wo[TC];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int slot = t * kCols + tx + TX * j;
      const int kr = slot / p.gw, kc = slot - kr * p.gw;
      const int key = kr * p.kw + kc;
      ok[j] = key < p.n_valid &&
              !(grid && (kr >= p.kh_valid || kc >= p.kw_valid));
      fixed[j] = slot < p.n_visit ? p.masked : p.absent;
      ho[j] = ok[j] ? kr * BS : 0;
      wo[j] = ok[j] ? (p.kh + kc) * BS : 0;
    }
    float alpha[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = ty + TY * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        float x = s[i][j];
        if (kBias)
          x = __fadd_rn(x, __fadd_rn(bias_s[ho[j] + row],
                                     bias_s[wo[j] + row]));
        x = ok[j] ? x : fixed[j];
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 8 lanes of a row are lanes 8 (ty % 4) .. + 7 of one warp
#pragma unroll
      for (int o = 1; o < TX; o *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      alpha[i] = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        s[i][j] = exp2f(s[i][j] - mx);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha[i] + sum;   // this lane's keys only
    }
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < TR; ++i) row_s[ty + TY * i] = alpha[i];
    }
    if (kPInK) __syncthreads();   // every score of the tile is made
    store_cols(pt, s);
    __syncthreads();
    // O rows 4 ty .. 4 ty + 3: rescale, then O += P V
    const float4 a = ld4(row_s + 4 * ty);
    const float av[4] = {a.x, a.y, a.z, a.w};
    if constexpr (kTileSum) {
      float tile[4][8] = {};
      accumulate<kCols>(tile, pt, st + kCols * LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[i][e] = fmaf(acc[i][e], av[i], tile[i][e]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] *= av[i];
      accumulate<kCols>(acc, pt, st + kCols * LD);
    }
  }

  // each row's sum over its 8 lanes, to the accumulator's rows
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int o = 1; o < TX; o *= 2)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
  __syncthreads();   // every thread has read the last rescale factors
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = ty + TY * i;
      row_s[row] = l[i];
      // the lane that holds the row's max and its joined sum
      if (p.lse != nullptr && row < nrows)
        p.lse[row0 + row] = m[i] + log2f(l[i]);
    }
  }
  __syncthreads();
  const float4 ls = ld4(row_s + 4 * ty);
  const float lv[4] = {ls.x, ls.y, ls.z, ls.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= nrows) continue;
    const float inv = 1.f / (lv[i] > 0.f ? lv[i] : 1.f);
    float* o = p.out + (row0 + r) * p.ldo;
    *reinterpret_cast<float4*>(o + 4 * tx) =
        make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv,
                    acc[i][3] * inv);
    *reinterpret_cast<float4*>(o + 32 + 4 * tx) =
        make_float4(acc[i][4] * inv, acc[i][5] * inv, acc[i][6] * inv,
                    acc[i][7] * inv);
  }
}

}  // namespace tiled
}  // namespace vdr
