// K6's bf16 backward on Hopper: the TMA + wgmma bodies of dq (with both
// bias gradients, flash_attention_bwd_dq.cu) and dk/dv
// (flash_attention_bwd_dkv.cu) for per-head bf16 q, k, v (B, H, S, D),
// D = 64, with no bias or a decomposed fp32 bias on a key grid of Kh <= 128
// rows whose width Kw is a multiple of 4 from 16 to 128 (SAM ViT-B/16's
// global layers under fast fine-tuning: Kw 36, 40, 44, 48, 52, 56 and 60 at
// 576, 640, ... 960 px, 72, 80 and 96 at 1152, 1280 and 1536), kv_len or
// not.
// k6b::bwd_route (flash_trainable_bf16.cuh) says which calls they take,
// and the k6b::hopper_* functions there give their tiling; the others keep
// the mma.sync bodies there.
//
// Replaces: vit_deep_radiomics_tpu/ops/attention_grad.py::_bwd_dq_kernel
// and ::_bwd_dkv_kernel (flash_attention_trainable's backward, Pallas TPU
// kernels), at the rounding points of flash_trainable_bf16.cuh's header:
// Q^ = bf16(q * bf16(D^-1/2 log2 e)), each bias term t(x) = bf16(x log2 e)
// and a key's two terms added in fp32 before they join the score, keys at
// or past kv_len at -1e30 (a kv_len 0 row: every key, so P = 1), P =
// exp2(s - lse) rounded to bf16 before dV, dS = P (dP - D) rounded to bf16
// before dq, dk and both bias sums, the bias gradients fp32.
//
// What bounds them on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at SAM
// @768's shape (2 x 12 heads x 2304 tokens) dq does 6 S^2 D H B = 49 GFLOP
// (0.050 ms) and dkv 8 S^2 D H B = 65 GFLOP (0.066 ms) against about 30 MB
// of compulsory traffic: compute-bound, and only wgmma reaches that rate.
// Beside its products each tile carries an exponential, the bias and (dq)
// the bias sums per score, which have to run under the products.
//
// dq, query-major: one producer thread keeps K and V tiles of kNK keys in
// flight by TMA (128-byte swizzle) in a ring of kDqStages stages on
// full/empty mbarriers; two consumer warpgroups own 64 query rows each,
// whose q (scaled in place into Q^) and dO tiles arrive once and stay as
// the K-major A operands of S = Q^ K^T and dP = dO V^T (wgmma N = kNK).
// With a bias a grid row is taken in one pass, or in two or three
// (k6b::hopper_dq_passes, hopper_dq_tile), every tile of pass u starting at
// grid column u * tile, so each thread keeps its rows' bias_w terms and
// dbias_w sums of the pass in registers, reloads the terms and stores the
// sums once between passes, reads one bias_h term per row and tile from a
// table staged once, and stores one dbias_h row sum per tile (quad
// shuffles, one lane; a later pass adds its share to the earlier ones').
// The instance is built for the grid's width, so the columns a tile holds
// past the row (Kw 40 in 48 keys: the next grid row's first keys, or TMA's
// zeros past S) are masked to P = 0 at compile time and add nothing to dQ
// += dS K; where a pass ends inside an 8-column chunk (Kw 4 mod 8) the
// lanes of that chunk mask by their column pair. dS rounded in its fp32 registers is the register A operand of
// that product; dQ of tile j-1 is issued with the scores of tile j, and
// the warpgroups issue in turn.
//
// dkv, key-major: two consumer warpgroups own 64 keys each (wgmma M = 64),
// whose K and V tiles arrive once; per 64-query tile one producer warp
// brings q, dO and the tile's fp32 bias_w rows by TMA and writes lse, D
// and the bias_h terms of the grid rows the block's 128 keys span
// (k6b::hopper_dkv_hrows) by plain loads; the instance is built for the
// grid's width, so its stage layout and ring depth (4 stages up to Kw 56,
// 3 up to 96, 2 beyond: as many as fit) are constants. The consumers form
// Q^ and the bf16 bias_w terms (exact: t(x) is a bf16 value) once per tile
// for the whole block, half each, one tile ahead of their use where the
// ring has three stages or more; ldmatrix.trans reads a key's terms for the
// two queries a thread holds in one register, at the 16-byte chunk of the
// block's first key (k6b::hopper_term_ld: at Kw 4 mod 8 each query's terms
// are staged twice over, so that a block that wraps a grid row, or starts
// at 4 mod 8, reads 8 consecutive terms at an aligned column). P^T and
// dS^T, rounded in registers,
// are the A operands of dV += P^T dO and dK += dS^T q (the raw q; dk is
// scaled at the end), issued with the next tile's scores.
//
// Every output element is written once by one thread after sums in a fixed
// order: no atomics, the same bits on every run.
#pragma once

#include <type_traits>

#include "attention_bwd_core.cuh"
#include "flash_trainable_bf16.cuh"
#include "hopper_flash.cuh"

namespace vdr {
namespace k6h {

using bf16 = __nv_bfloat16;
using namespace vdr::sm90;
using k5h::kTile;   // one 64 x 64 bf16 tile, 8 KB

constexpr int kConsumers = 2;         // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kConsumerRegs = k5h::consumer_regs(kConsumers);
constexpr int kErrTensorMap = -3;

// dq
constexpr int kDqStages = k6b::kHopperDqStages;   // K/V ring depth
constexpr int kDqRows = 64 * kConsumers;           // query rows a block
constexpr int kBiasLd = k6b::kHopperBiasLd;        // bias_h table row (skew)
static_assert(kBiasLd == kDqRows + 1, "one bias_h term a query row");

// dkv: a stage holds raw q, dO, Q^ (swizzled tiles), then with a bias the
// tile's fp32 bias_w rows and their bf16 terms; then fp32 lse, D and (bias)
// the bias_h terms [hrows][64] (offsets: k6b::hopper_*_off)
constexpr int kKeys = 64 * kConsumers;      // keys a block
constexpr int kRawOff = 3 * kTile;
static_assert(kTile == k6b::kHopperTile, "the stage layout's tile");

struct Params {
  const float* bias_h;  // (B, H, S, kh) or nullptr
  const float* bias_w;  // (B, H, S, kw) or nullptr
  const int* kv_len;    // (B,) or nullptr
  const float* lse;     // (B, H, S) log2 log-sum-exp
  const float* delta;   // (B, H, S) sum_d dO * O
  bf16* dq;             // (B, H, S, D)
  float* dbh;           // (B, H, S, kh) or nullptr
  float* dbw;           // (B, H, S, kw) or nullptr
  bf16* dk;             // (B, H, S, D)
  bf16* dv;             // (B, H, S, D)
  int H, S, kh, kw;     // kh, kw: the key grid (bias), else 0
  float scale_log2;     // bf16(D^-1/2 log2 e): Q^ = bf16(q * scale_log2)
  float scale;          // D^-1/2
};

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// Keys j < lim are valid; with none valid (kv_len 0) every key of the row
// is visited at -1e30, so P = 1 from the residual.
struct Keys {
  int n_keys;   // keys visited
  bool none;    // a kv_len 0 row
};
__device__ __forceinline__ Keys keys_of(const Params& p, int b) {
  const int lim =
      p.kv_len != nullptr ? min(p.S, max(p.kv_len[b], 0)) : p.S;
  return {lim > 0 ? lim : p.S, lim == 0};
}

// S = Q^ K^T and dP = dO V^T for one kNK-key tile: all four operands
// K-major in shared memory, four k16 steps along D.
template <int kNK>
__device__ __forceinline__ void dq_scores(float (&s)[kNK / 2],
                                          float (&dp)[kNK / 2], uint32_t qhat,
                                          uint32_t dout, uint32_t k_tile,
                                          uint32_t v_tile) {
  const uint64_t aq = desc_sw128(qhat, 16, 1024);
  const uint64_t ad = desc_sw128(dout, 16, 1024);
  const uint64_t bk = desc_sw128(k_tile, 16, 1024);
  const uint64_t bv = desc_sw128(v_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<kNK>::ss(s, aq + 2 * kk, bk + 2 * kk, kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<kNK>::ss(dp, ad + 2 * kk, bv + 2 * kk, kk > 0);
}

// ---------------------------------------------------------------------------
// dq and both bias gradients: 128 query rows of one (batch, head) a block,
// on a key grid kKw keys wide (no bias: tiles of kKw = 48 consecutive keys)
// ---------------------------------------------------------------------------
template <int U>
using Pass = std::integral_constant<int, U>;

// f(Pass<U>{}), f(Pass<U + 1>{}), ... f(Pass<N - 1>{})
template <int U, int N, class F>
__device__ __forceinline__ void for_passes(F&& f) {
  if constexpr (U < N) {
    f(Pass<U>{});
    for_passes<U + 1, N>(f);
  }
}

// The columns of a grid row kw wide that pass u takes (tiles of nk keys):
// the tile's columns past them are the next row's keys, masked.
__host__ __device__ constexpr int pass_cols(int kw, int nk, int u) {
  return nk < kw - u * nk ? nk : kw - u * nk;
}

template <bool kBias, int kKw>
__global__ void __launch_bounds__(kThreads, 1)
    dq_hopper_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo, const Params p) {
  // a grid row in kPasses key tiles of kNK keys, pass u from grid column
  // u * kNK (k6b::hopper_dq_passes, hopper_dq_tile)
  constexpr int kPasses = kBias ? k6b::hopper_dq_passes(kKw) : 1;
  constexpr int kNK = kBias ? k6b::hopper_dq_tile(kKw) : kKw;
  constexpr int kKTile = kNK * 64 * 2;   // a K or V tile
  static_assert(kNK % 16 == 0 && kKw % 4 == 0, "k16 tiles, 4-key pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kDqStages], empty[kDqStages], qbar;
  // the swizzled tiles need 1024-byte alignment in the shared window
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t qd_addr = smem_u32(base);    // per warpgroup: Q^, dO
  const uint32_t ring = qd_addr + 2 * kConsumers * kTile;  // K, V stages
  float* bh_s = reinterpret_cast<float*>(
      base + 2 * kConsumers * kTile + 2 * kDqStages * kKTile);  // [kh][Ld]

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kDqRows;
  const int head = b * p.H + h;
  const Keys ks = keys_of(p, b);
  // tile j: pass j / n_rows over grid row j % n_rows
  const int n_rows = (ks.n_keys + kKw - 1) / kKw;   // grid rows visited
  const int n_tiles = n_rows * kPasses;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kDqStages; ++i) {
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     k5h::kProducerRegs)
                 : "memory");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(&qbar, 2 * kConsumers * kTile);
      for (int w = 0; w < kConsumers; ++w) {
        tma_load(qd_addr + 2 * w * kTile, &tq, &qbar, 0, row0 + 64 * w, head);
        tma_load(qd_addr + (2 * w + 1) * kTile, &tdo, &qbar, 0,
                 row0 + 64 * w, head);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kDqStages, u = j / n_rows;
        const int key = (j - u * n_rows) * kKw + u * kNK;
        mbar_wait(&empty[st], ((j / kDqStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * kKTile);
        tma_load(ring + 2 * st * kKTile, &tk, &full[st], 0, key, head);
        tma_load(ring + (2 * st + 1) * kKTile, &tv, &full[st], 0, key,
                 head);
      }
    }
    return;
  }
  // ---- consumers: 64 query rows per warpgroup, the key tiles stream ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
               : "memory");
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, c = lane % 4;
  const int r_lo = wg * 64 + warp * 16 + g, r_hi = r_lo + 8;   // in block
  const int R_lo = row0 + r_lo, R_hi = row0 + r_hi;
  const size_t head_row = (size_t)head * p.S;
  // rows past S: P = 0 from an lse of +inf (their q and dO read zeros)
  const float l_lo = R_lo < p.S ? p.lse[head_row + R_lo] : inf();
  const float l_hi = R_hi < p.S ? p.lse[head_row + R_hi] : inf();
  const float d_lo = R_lo < p.S ? p.delta[head_row + R_lo] : 0.f;
  const float d_hi = R_hi < p.S ? p.delta[head_row + R_hi] : 0.f;
  const bool add = kBias && !ks.none;

  // this thread's bias_w terms (rows g, g + 8; columns 8i + 2c.. of the
  // pass) and dbias_w sums, the same columns in every tile of a pass; a
  // tile's columns past the pass's kCols (the next pass's or the next grid
  // row's keys) are known at compile time: 8-column chunks at or past
  // kCols, and with kCols 4 mod 8 the upper half of the chunk it ends in,
  // lanes c = 2, 3 (live(8i, kCols) for the pair 8i + 2c, 8i + 2c + 1);
  // at Kw 0 mod 8 every pass ends on a chunk
  auto live = [&](int chunk0, int cols) {
    if constexpr (kKw % 8 == 0)
      return chunk0 < cols;
    else
      return chunk0 + 8 <= cols || (chunk0 < cols && 2 * c < cols - chunk0);
  };
  float bw[kNK / 2], dbw[kNK / 2];
#pragma unroll
  for (int i = 0; i < kNK / 2; ++i) bw[i] = dbw[i] = 0.f;
  auto load_bw = [&](auto pass) {
    constexpr int kCols = pass_cols(kKw, kNK, decltype(pass)::value);
#pragma unroll
    for (int i = 0; i < kNK / 8; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int R = half ? R_hi : R_lo;
        float2 v = make_float2(0.f, 0.f);
        if (live(8 * i, kCols) && R < p.S) {
          v = *reinterpret_cast<const float2*>(
              p.bias_w + (head_row + R) * kKw +
              decltype(pass)::value * kNK + 8 * i + 2 * c);
          v = make_float2(k6b::term(v.x), k6b::term(v.y));
        }
        bw[4 * i + 2 * half] = v.x;
        bw[4 * i + 2 * half + 1] = v.y;
      }
    }
  };
  // the dbias_w sums of a pass, stored and cleared
  auto store_dbw = [&](auto pass) {
    constexpr int kCols = pass_cols(kKw, kNK, decltype(pass)::value);
#pragma unroll
    for (int i = 0; i < kNK / 8; ++i) {
      const int col = decltype(pass)::value * kNK + 8 * i + 2 * c;
      if (live(8 * i, kCols)) {
        if (R_lo < p.S)
          *reinterpret_cast<float2*>(p.dbw + (head_row + R_lo) * kKw + col) =
              make_float2(dbw[4 * i], dbw[4 * i + 1]);
        if (R_hi < p.S)
          *reinterpret_cast<float2*>(p.dbw + (head_row + R_hi) * kKw + col) =
              make_float2(dbw[4 * i + 2], dbw[4 * i + 3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dbw[4 * i + e] = 0.f;
    }
  };
  if constexpr (kBias) {
    // bias_h terms of this warpgroup's 64 rows, as [grid row][row]
    for (int i = t; i < 64 * p.kh; i += 128) {
      const int r = wg * 64 + i / p.kh, kr = i % p.kh;
      const int R = row0 + r;
      bh_s[kr * kBiasLd + r] =
          R < p.S ? k6b::term(p.bias_h[(head_row + R) * p.kh + kr]) : 0.f;
    }
    load_bw(Pass<0>{});
  }
  // Q^ in place: the warpgroup scales its own q tile
  const uint32_t q_addr = qd_addr + 2 * wg * kTile, do_addr = q_addr + kTile;
  mbar_wait(&qbar, 0);
  k5h::scale_tile(base + 2 * wg * kTile, base + 2 * wg * kTile, p.scale_log2,
                  t, 128);
  fence_proxy_async();
  bar_sync(1 + wg, 128);

  float dq[32], s[kNK / 2], dp[kNK / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  uint32_t da[kNK / 16][4];
  float* dbh_lo = kBias && R_lo < p.S ? p.dbh + (head_row + R_lo) * p.kh
                                      : nullptr;
  float* dbh_hi = kBias && R_hi < p.S ? p.dbh + (head_row + R_hi) * p.kh
                                      : nullptr;
  // tile j's scores -> dS in dp (bias, exponentials, masks), and its bias
  // gradients; tile j is pass `pass` over grid row j - pass * n_rows
  auto tile_math = [&](int j, auto pass) {
    constexpr int kU = decltype(pass)::value;
    constexpr int kCols = pass_cols(kKw, kNK, kU);
    const int r = j - kU * n_rows, key0 = r * kKw + kU * kNK;
    if (ks.none) {
#pragma unroll
      for (int i = 0; i < kNK / 2; ++i) s[i] = k6b::kNegInf;
    } else if (add) {
      const float th_lo = bh_s[r * kBiasLd + r_lo];
      const float th_hi = bh_s[r * kBiasLd + r_hi];
#pragma unroll
      for (int i = 0; i < kNK / 2; ++i)
        if ((i / 4) * 8 < kCols)
          s[i] = __fadd_rn(s[i], __fadd_rn((i & 2) ? th_hi : th_lo, bw[i]));
    }
#pragma unroll
    for (int i = 0; i < kNK / 2; ++i)
      s[i] = live((i / 4) * 8, kCols)
                 ? fast_exp2(s[i] - ((i & 2) ? l_hi : l_lo))
                 : 0.f;
    // keys at or past the visited count (kv_len; zero rows past S) P = 0,
    // on the tiles that reach it
    if (key0 + kCols > ks.n_keys) {
#pragma unroll
      for (int i = 0; i < kNK / 2; ++i)
        if (key0 + (i / 4) * 8 + 2 * c + (i & 1) >= ks.n_keys) s[i] = 0.f;
    }
    [[maybe_unused]] float lo = 0.f, hi = 0.f;
#pragma unroll
    for (int i = 0; i < kNK / 2; ++i) {
      const bool row_lo = (i & 2) == 0;
      const float ds =
          k6b::round_bf16(s[i] * (dp[i] - (row_lo ? d_lo : d_hi)));
      dp[i] = ds;
      if constexpr (kBias) {
        if ((i / 4) * 8 < kCols) {
          dbw[i] += ds;
          if (row_lo)
            lo += ds;
          else
            hi += ds;
        }
      }
    }
    if constexpr (kBias) {
      lo += __shfl_xor_sync(0xffffffffu, lo, 1);
      lo += __shfl_xor_sync(0xffffffffu, lo, 2);
      hi += __shfl_xor_sync(0xffffffffu, hi, 1);
      hi += __shfl_xor_sync(0xffffffffu, hi, 2);
      // the second pass adds its share to the first's (this lane's store)
      if (c == 0) {
        if (dbh_lo != nullptr) dbh_lo[r] = kU ? dbh_lo[r] + lo : lo;
        if (dbh_hi != nullptr) dbh_hi[r] = kU ? dbh_hi[r] + hi : hi;
      }
    }
  };
  // ping-pong: a warpgroup issues its products after the one before it
  // (named barriers 1 .. kConsumers serve the set-up above)
  const int my_bar = 1 + kConsumers + wg;
  const int next_bar = 1 + kConsumers + (wg + 1) % kConsumers;
  auto issue_wait = [&] { bar_sync(my_bar, 256); };
  auto issue_done = [&] { bar_arrive(next_bar, 256); };
  auto k_of = [&](int j) { return ring + 2 * (j % kDqStages) * kKTile; };
  // software pipeline: the scores of tile j are issued with dQ of tile
  // j-1, and tile j's exponentials run while that is on the tensor cores
  auto step = [&](int j, auto pass) {
    const uint32_t cur = k_of(j);
    mbar_wait(&full[j % kDqStages], (j / kDqStages) & 1);
    issue_wait();
    wgmma_fence();
    dq_scores<kNK>(s, dp, q_addr, do_addr, cur, cur + kKTile);
    wgmma_commit();
    pv_tile<kNK>(dq, da, k_of(j - 1));   // dQ += dS K
    wgmma_commit();
    issue_done();
    wgmma_wait<1>();
    fence_regs(s);
    fence_regs(dp);
    tile_math(j, pass);
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(da);
    mbar_arrive(&empty[(j - 1) % kDqStages]);
    pack_probs<kNK>(dp, da);
  };
  if (wg == kConsumers - 1) issue_done();
  mbar_wait(&full[0], 0);
  issue_wait();
  wgmma_fence();
  dq_scores<kNK>(s, dp, q_addr, do_addr, ring, ring + kKTile);
  wgmma_commit();
  issue_done();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  tile_math(0, Pass<0>{});
  pack_probs<kNK>(dp, da);
  for (int j = 1; j < n_rows; ++j) step(j, Pass<0>{});
  // each later pass: the previous pass's dbias_w sums out, its bias_w
  // terms in, between two loops over one step
  for_passes<1, kPasses>([&](auto pass) {
    constexpr int kU = decltype(pass)::value;
    store_dbw(Pass<kU - 1>{});
    load_bw(pass);
    for (int j = kU * n_rows; j < (kU + 1) * n_rows; ++j) step(j, pass);
  });
  issue_wait();
  wgmma_fence();
  pv_tile<kNK>(dq, da, k_of(n_tiles - 1));
  wgmma_commit();
  // every sync is matched: the last warpgroup's first arrive stands in for
  // its final one
  if (wg != kConsumers - 1) issue_done();
  wgmma_wait<0>();
  fence_regs(dq);
  mbar_arrive(&empty[(n_tiles - 1) % kDqStages]);

  bf16* out = p.dq + head_row * 64;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = 8 * i + 2 * c;
    if (R_lo < p.S)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)R_lo * 64 + d) =
          __floats2bfloat162_rn(dq[4 * i] * p.scale, dq[4 * i + 1] * p.scale);
    if (R_hi < p.S)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)R_hi * 64 + d) =
          __floats2bfloat162_rn(dq[4 * i + 2] * p.scale,
                                dq[4 * i + 3] * p.scale);
  }
  if constexpr (kBias) {
    store_dbw(Pass<kPasses - 1>{});
    // grid rows past the visited tiles (every key masked): zero
    for (int kr = n_rows + c; kr < p.kh; kr += 4) {
      if (dbh_lo != nullptr) dbh_lo[kr] = 0.f;
      if (dbh_hi != nullptr) dbh_hi[kr] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// dk and dv: 128 keys of one (batch, head) a block
// ---------------------------------------------------------------------------

// The tile's bias terms added to the thread's scores S^T (keys g, g + 8 of
// its warp; queries 8i + 2c, 8i + 2c + 1): bias_h from the stage's [grid
// row][query] table at the keys' rows hr_lo/hr_hi among the block's, bias_w
// by ldmatrix.trans from the [query][kLd] bf16 terms at the 8-column chunks
// col_lo/col_hi of the warp's two 8-key blocks (k6b::hopper_term_ld: the
// chunk holds the block's 8 keys' terms, also where the block wraps a grid
// row). The sum is the forward's: s + (th + tw).
template <int kLd>
__device__ __forceinline__ void add_bias(float (&s)[32], const float* th,
                                         uint32_t tw, int hr_lo, int hr_hi,
                                         int col_lo, int col_hi, int lane,
                                         int c) {
  const int m = lane >> 3, rr = lane & 7;
  const int col = (m & 1) ? col_hi : col_lo;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    // matrices (query block 2n + m/2, key block m % 2)
    const int qr = 8 * (2 * n + (m >> 1)) + rr;
    uint32_t r[4];
    k5h::ldmatrix_x4_trans(r, tw + (qr * kLd + col) * 2);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = 2 * n + u;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 hv = *reinterpret_cast<const float2*>(
            th + (half ? hr_hi : hr_lo) * 64 + 8 * i + 2 * c);
        const __nv_bfloat162 w =
            *reinterpret_cast<const __nv_bfloat162*>(&r[2 * u + half]);
        float& s0 = s[4 * i + 2 * half];
        float& s1 = s[4 * i + 2 * half + 1];
        s0 = __fadd_rn(s0, __fadd_rn(hv.x, __low2float(w)));
        s1 = __fadd_rn(s1, __fadd_rn(hv.y, __high2float(w)));
      }
    }
  }
}

// On a key grid kKw keys wide (kBias; 0 without a bias). The query-tile
// ring has kStages stages (k6b::hopper_dkv_stages): with three or more Q^
// of tile j+1 is made while tile j's products run, before tile j-1's stage
// is released; with two, after it.
template <bool kBias, int kKw>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_hopper_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tbw, const Params p) {
  // the stage layout of the grid (k6b::hopper_*)
  constexpr int kStages = k6b::hopper_dkv_stages(kKw);
  constexpr int kStageBytes = k6b::hopper_stage_bytes(kKw);
  constexpr int kSmall = k6b::hopper_small_off(kKw);
  constexpr int kTermOff = kBias ? k6b::hopper_term_off(kKw) : 0;
  constexpr int kTermLd = kBias ? k6b::hopper_term_ld(kKw) : 0;
  constexpr int kHRows = kBias ? k6b::hopper_dkv_hrows(kKw) : 0;
  // a block's first term column is its first key mod kPeriod (Kw, or 2 Kw
  // where the terms are staged twice)
  constexpr int kPeriod = kBias ? k6b::hopper_term_period(kKw) : 1;
  constexpr bool kTwice = kBias && kPeriod != kKw;
  static_assert(!kBias || (kTermLd % 8 == 0 && (kTermLd / 8) % 2 == 1 &&
                           kTermLd >= kPeriod),
                "16-byte rows an odd number of chunks apart");
  static_assert(kStages >= 2, "a stage in use and one being filled");
  static_assert(kBias == (kKw > 0), "a grid width with a bias alone");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages],
      qready[kStages], kvbar;
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t kv_addr = smem_u32(base);      // per warpgroup: K, V
  unsigned char* stages = base + 2 * kConsumers * kTile;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kKeys;
  const int head = b * p.H + h;
  const size_t head_row = (size_t)head * p.S;
  const Keys ks = keys_of(p, b);
  const int n_tiles = (p.S + 63) / 64;

  if (k0 >= ks.n_keys) {
    // every key of the block is masked: zero gradients, no work
    for (int i = threadIdx.x; i < kKeys * 16; i += kThreads) {
      const int key = k0 + i / 16, col = (i % 16) * 8;
      if (key < p.S)
        *reinterpret_cast<uint4*>((col < 64 ? p.dk : p.dv) +
                                  (head_row + key) * 64 + col % 64) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], kConsumers * 128);
      mbar_init(&qready[i], kConsumers * 128);
    }
    mbar_init(&kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int kr0 = kBias ? k0 / kKw : 0;   // the block's first grid row
  if (wg == kConsumers) {
    // ---- producer: one warp, TMA for the tiles, plain loads for the rest
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     k5h::kProducerRegs)
                 : "memory");
    if (threadIdx.x >= kConsumers * 128 + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(&kvbar, 2 * kConsumers * kTile);
      for (int w = 0; w < kConsumers; ++w) {
        tma_load(kv_addr + 2 * w * kTile, &tk, &kvbar, 0, k0 + 64 * w, head);
        tma_load(kv_addr + (2 * w + 1) * kTile, &tv, &kvbar, 0, k0 + 64 * w,
                 head);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages, q0 = j * 64;
      mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
      unsigned char* sp = stages + st * kStageBytes;
      float* sm = reinterpret_cast<float*>(sp + kSmall);
      for (int i = lane; i < 64; i += 32) {
        const int q = q0 + i;
        const bool in = q < p.S;
        sm[i] = in ? p.lse[head_row + q] : inf();
        sm[64 + i] = in ? p.delta[head_row + q] : 0.f;
        if constexpr (kBias) {
#pragma unroll
          for (int r = 0; r < kHRows; ++r) {
            const int kr = kr0 + r;
            sm[128 + 64 * r + i] =
                in && kr < p.kh
                    ? k6b::term(p.bias_h[(head_row + q) * p.kh + kr])
                    : 0.f;
          }
        }
      }
      if (lane == 0) {
        const uint32_t sa = smem_u32(sp);
        mbar_expect_tx(&full[st], 2 * kTile + 64 * kKw * 4);
        tma_load(sa, &tq, &full[st], 0, q0, head);
        tma_load(sa + kTile, &tdo, &full[st], 0, q0, head);
        if constexpr (kBias)
          tma_load(sa + kRawOff, &tbw, &full[st], 0, q0, head);
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }
  // ---- consumers: 64 keys per warpgroup, the query tiles stream ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
               : "memory");
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int c = lane % 4;
  const int wkey = k0 + 64 * wg + 16 * warp;   // the warp's first key
  const int key_lo = wkey + lane / 4, key_hi = key_lo + 8;
  const bool ragged = k0 + 64 * wg + 64 > ks.n_keys;
  const bool lo_ok = key_lo < ks.n_keys, hi_ok = key_hi < ks.n_keys;
  const bool add = kBias && !ks.none;
  // the keys' grid rows among the block's and the warp's bias_w chunks
  const int hr_lo = kBias ? key_lo / kKw - kr0 : 0;
  const int hr_hi = kBias ? key_hi / kKw - kr0 : 0;
  const int col_lo = kBias ? wkey % kPeriod : 0;
  const int col_hi = kBias ? (wkey + 8) % kPeriod : 0;
  const uint32_t k_tile = kv_addr + 2 * wg * kTile, v_tile = k_tile + kTile;
  auto stage = [&](int j) { return stages + (j % kStages) * kStageBytes; };
  auto stage_at = [&](int j) { return smem_u32(stage(j)); };
  // Q^ and the bias_w terms of tile j: both warpgroups make half of each
  // and say so on qready (no wait: a warpgroup waits only before its
  // scores)
  auto make_qhat = [&](int j) {
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    unsigned char* st = stage(j);
    k5h::scale_tile(st + 2 * kTile, st, p.scale_log2, threadIdx.x,
                    kConsumers * 128);
    if constexpr (kBias) {
      const float4* raw = reinterpret_cast<const float4*>(st + kRawOff);
      for (int k = threadIdx.x; k < 16 * kKw; k += kConsumers * 128) {
        const int q = k / (kKw / 4), col = (k % (kKw / 4)) * 4;
        const float4 v = raw[k];
        const uint2 w = make_uint2(
            pack_bf16(__fmul_rn(v.x, kLog2e), __fmul_rn(v.y, kLog2e)),
            pack_bf16(__fmul_rn(v.z, kLog2e), __fmul_rn(v.w, kLog2e)));
        *reinterpret_cast<uint2*>(st + kTermOff + (q * kTermLd + col) * 2) =
            w;
        if constexpr (kTwice)
          *reinterpret_cast<uint2*>(st + kTermOff +
                                    (q * kTermLd + kKw + col) * 2) = w;
      }
    }
    fence_proxy_async();
    mbar_arrive(&qready[j % kStages]);
  };

  float dk[32], dv[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pa[4][4], sa[4][4];
  // tile j's scores -> P^T and dS^T in place (bias, exponentials, masks)
  auto tile_math = [&](int j) {
    const float* sm = reinterpret_cast<const float*>(stage(j) + kSmall);
    if (ks.none) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = k6b::kNegInf;
    }
    if (add)
      add_bias<kTermLd>(s, sm + 128, stage_at(j) + kTermOff, hr_lo, hr_hi,
                        col_lo, col_hi, lane, c);
    k5h::probs_ds(s, dp, sm, sm + 64, c, ragged, lo_ok, hi_ok);
  };
  // software pipeline: the scores of tile j are issued with the products
  // of tile j-1, and tile j's exponentials run while those are on the
  // tensor cores; Q^ of tile j+1 is made meanwhile (two stages: once tile
  // j-1's stage is free)
  make_qhat(0);
  mbar_wait(&kvbar, 0);
  const uint32_t first = stage_at(0);
  mbar_wait(&qready[0], 0);
  wgmma_fence();
  k5h::product_ss(s, k_tile, first + 2 * kTile);    // S^T = K Q^T
  k5h::product_ss(dp, v_tile, first + kTile);       // dP^T = V dO^T
  wgmma_commit();
  if (n_tiles > 1) make_qhat(1);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  tile_math(0);
  k5h::pack_a(s, pa);
  k5h::pack_a(dp, sa);
  for (int j = 1; j < n_tiles; ++j) {
    const uint32_t cur = stage_at(j), prev = stage_at(j - 1);
    mbar_wait(&qready[j % kStages], (j / kStages) & 1);
    wgmma_fence();
    k5h::product_ss(s, k_tile, cur + 2 * kTile);
    k5h::product_ss(dp, v_tile, cur + kTile);
    wgmma_commit();
    k5h::product_rs(dv, pa, prev + kTile);   // dV += P^T dO
    k5h::product_rs(dk, sa, prev);           // dK += dS^T q
    wgmma_commit();
    if (kStages > 2 && j + 1 < n_tiles) make_qhat(j + 1);
    wgmma_wait<1>();
    fence_regs(s);
    fence_regs(dp);
    tile_math(j);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);
    fence_regs(sa);
    mbar_arrive(&empty[(j - 1) % kStages]);
    if (kStages == 2 && j + 1 < n_tiles) make_qhat(j + 1);
    k5h::pack_a(s, pa);
    k5h::pack_a(dp, sa);
  }
  const uint32_t last = stage_at(n_tiles - 1);
  wgmma_fence();
  k5h::product_rs(dv, pa, last + kTile);
  k5h::product_rs(dk, sa, last);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  mbar_arrive(&empty[(n_tiles - 1) % kStages]);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = 8 * i + 2 * c;
    if (key_lo < p.S) {
      const size_t o = (head_row + key_lo) * 64 + d;
      *reinterpret_cast<__nv_bfloat162*>(p.dk + o) = __floats2bfloat162_rn(
          dk[4 * i] * p.scale, dk[4 * i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + o) =
          __floats2bfloat162_rn(dv[4 * i], dv[4 * i + 1]);
    }
    if (key_hi < p.S) {
      const size_t o = (head_row + key_hi) * 64 + d;
      *reinterpret_cast<__nv_bfloat162*>(p.dk + o) = __floats2bfloat162_rn(
          dk[4 * i + 2] * p.scale, dk[4 * i + 3] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + o) =
          __floats2bfloat162_rn(dv[4 * i + 2], dv[4 * i + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// 3-D map (kw columns, S rows, B·H heads) of the fp32 bias_w, boxes of
// the 64 rows of a query tile, no swizzle (rows of kw * 4 bytes, a multiple
// of 16 for every width the Hopper bodies take); rows past S read as
// zeros.
inline bool bias_map(CUtensorMap* map, const float* ptr, int S, int heads,
                     int kw) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)kw, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)kw * 4,
                                 (cuuint64_t)S * kw * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kw, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<float*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor maps of q, dO (64-row boxes) and k, v (`key_rows`-row boxes)
// over (64 columns, S rows, B·H heads).
inline bool qkv_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                     const void* v, const void* dout, int S, int heads,
                     int key_rows) {
  return tensor_map_3d(&m[0], q, 64, S, heads, 64) &&
         tensor_map_3d(&m[1], k, 64, S, heads, key_rows) &&
         tensor_map_3d(&m[2], v, 64, S, heads, key_rows) &&
         tensor_map_3d(&m[3], dout, 64, S, heads, 64);
}

// One kernel over (blocks, H, B) blocks of kThreads threads; the CUDA
// error of the attribute call or of the launch (0 on success). The C
// entries (flash_attention_bwd_dq.cu, flash_attention_bwd_dkv.cu) each
// instantiate their own kernel.
template <typename Kernel, typename... Maps>
int launch(Kernel kern, size_t smem, int blocks, int B, const Params& p,
           cudaStream_t stream, const Maps&... maps) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(blocks, p.H, B), kThreads, smem, stream>>>(maps..., p);
  return (int)cudaGetLastError();
}

}  // namespace k6h
}  // namespace vdr
