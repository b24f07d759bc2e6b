// K5 backward, dq: query gradient and both decomposed-bias gradients of
// trainable global attention.
//
// Replaces: vit_deep_radiomics_tpu/ops/attention_grad.py::_fgt_dq_kernel
// (global_attention_trainable's backward, a Pallas TPU kernel).
//
// FlashAttention-2 style: a block owns query rows of one (batch, head) and
// loops over the keys in 64-key tiles. Each score tile is recomputed
// exactly as the forward computed it (csrc/global_attention_fwd_lse.cu: q
// scaled by D^-1/2 log2 e in fp32 and rounded to bf16 once, the bias terms
// times log2 e in fp32, masked keys at -1e30 log2 e), P = exp2(s - lse)
// from the forward's residual, dP = dO V^T, dS = P * (dP - D) with
// D = sum_d dO * O precomputed per row; then
//     dq += dS K                     (dS rounded to bf16)
//     dbias_h[i, key row]  = sum of dS over the row's keys
//     dbias_w[i, key col] += dS, kept per key position in registers
// and dq is scaled by D^-1/2 and stored once. The bias gradients need a
// key-grid width kw in {8, 16, 32, 64, 128}: a 64-key tile then holds
// whole grid rows, so every key keeps its grid column across tiles, or
// (Kw 128) half of one.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the
// fine-tuning path's shapes (2 x 4096 tokens x 12 heads of 64) it does
// 6 S^2 D H B = 155 GFLOP (QK^T, dO V^T, dS K; 0.156 ms at the bf16 peak)
// against about 101 MB of compulsory traffic (0.030 ms): compute-bound.
// Only wgmma reaches that rate, and each 64 x 64 tile also carries 32
// exponentials, the bias and its gradients per thread, which have to run
// under the products.
//
// What the design does about it (bf16 calls with no bias or Kw = 64 or
// 128: the fast path of SAM's global layers at 1024 and 2048 px and of
// DINOv2's kv_len layers):
//  * warp specialisation: one producer thread keeps 64-key K and V tiles in
//    flight by TMA (128-byte swizzle) in a ring of kStages stages guarded
//    by full/empty mbarriers; tiles wholly past kv_len are never loaded;
//  * two consumer warpgroups own 64 query rows each; their q and dO tiles
//    come once by TMA, q is scaled in place into Q^, and both stay in
//    shared memory as the K-major A operands of S = Q^ K^T and dP = dO V^T
//    (wgmma, K and V K-major B);
//  * dS is formed in the fp32 dP registers and rounded to bf16 in place as
//    the register A operand of dQ += dS K (K MN-major B); dQ of tile j-1
//    is issued with the scores of tile j, so tile j's exponentials and
//    bias sums run while it is on the tensor cores, and the warpgroups
//    issue their products in turn (named barriers), so one's exponentials
//    also run under the other's products;
//  * the bias: a 64-key tile is one grid row, so each thread keeps its
//    rows' bias_w columns in registers for the whole loop and reads one
//    bias_h scalar per row and tile from a table staged once; dbias_w is a
//    per-position register accumulator across tiles, dbias_h one row sum
//    per tile (quad shuffles) stored by one lane: no atomics;
//  * Kw 128: tiles 2r and 2r + 1 are grid row r, columns 0-63 and 64-127.
//    A second set of bias_w terms and dbias_w sums (64 registers) would
//    not fit the consumers' 168 registers (ptxas gives every thread of a
//    384-thread launch that many, whatever setmaxnreg asks), and keeping
//    one half in shared memory would read and write 80 bytes a thread per
//    odd tile beside the products' operands. So the producer streams the
//    even tiles first and then the odd ones: one set of bias_w columns is
//    live at a time, swapped once (the even half's dbias_w stored, the odd
//    half's bias_w loaded), and the even tile's dbias_h row sums wait in
//    the thread's own fp32 slots of a [grid row][row] table (Kh x 516
//    bytes beside the bias_h table, 211 KB at Kh 128) until the odd tile
//    adds its own, even + odd, and one lane stores the row;
//  * kv_len: the ragged tile masks by one flag per tile, a kv_len 0 row
//    scores every key at -1e30 log2 e by one flag per block; rows and
//    keys past S read zeros (TMA fill), rows past S an lse of +inf.
// Every output element is written once by one thread, after sums in a
// fixed order: the same bits on every run. Biased calls with Kw in
// {8, 16, 32}, or Kw 128 on a grid of more than k5h::kMaxGridRows rows,
// keep the first loops below (mma.sync, synchronously staged K/V tiles,
// the bias read per score from shared memory; at Kw 128 they fold the
// tile's dbias_w sums into the grid's columns every tile);
// vdr_global_attention_bwd_route reports the choice, which the C entry
// makes by shape alone.

#include "attention_bwd_core.cuh"

namespace {
using vdr::bf16;

// ---------------------------------------------------------------------------
// First loops (mma.sync): biased calls the Hopper body does not take
// ---------------------------------------------------------------------------

constexpr int D = 64;
constexpr int BQ = 64;   // query rows per block (4 warps x 16)
constexpr int BK = 64;   // keys per tile
constexpr int LD = D + 8;
constexpr int NT = BK / 8;
constexpr int BS = vdr::bias_stride<BQ>();

// Row stride of the dbias_w staging: a tile's key positions (Kw <= 64,
// folded by column at the end) or the grid's columns (Kw 128)
__host__ __device__ inline int dbw_stride(int kw) { return kw > BK ? kw : BK; }

size_t smem_bytes(int kh, int kw, bool has_bias) {
  size_t n = 2 * BK * LD * sizeof(bf16) + BK * sizeof(int2);
  if (has_bias)
    n += ((size_t)(kh + kw) * BS + (size_t)BQ * kh +
          (size_t)BQ * dbw_stride(kw)) * sizeof(float);
  return n;
}

__global__ void __launch_bounds__(BQ * 2)
    dq_kernel(vdr::AttnParams p, vdr::GradParams gp) {
  using namespace vdr;
  extern __shared__ __align__(16) char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);            // [BK][LD]
  bf16* vs = ks + BK * LD;                               // [BK][LD]
  int2* ktab = reinterpret_cast<int2*>(vs + BK * LD);    // [BK]
  float* bias_s = reinterpret_cast<float*>(ktab + BK);   // [kh + kw][BS]
  float* dbh_s = bias_s + (p.kh + p.kw) * BS;            // [BQ][kh]
  float* dbw_s = dbh_s + BQ * p.kh;             // [BQ][dbw_stride(kw)]
  const int ldw = dbw_stride(p.kw);

  const Tile t = tile_of(p, BQ);
  const int C = p.H * D;
  const bool has_bias = p.bias_h != nullptr;
  const bool add_bias = has_bias && !t.none;
  if (has_bias) {
    stage_bias<bf16, BQ>(p, t, bias_s);
    for (int i = threadIdx.x; i < BQ * p.kh; i += blockDim.x) dbh_s[i] = 0.f;
    if (p.kw > BK)
      for (int i = threadIdx.x; i < BQ * ldw; i += blockDim.x) dbw_s[i] = 0.f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int lrow_lo = warp * 16 + g, lrow_hi = lrow_lo + 8;
  const int r_lo = t.row0 + lrow_lo, r_hi = r_lo + 8;
  const bool warp_live = t.row0 + warp * 16 < p.seg;
  const size_t rowbase = ((size_t)t.b * p.S + t.seg0) * C + t.h * D;
  const size_t resbase = ((size_t)t.b * p.H + t.h) * p.S + t.seg0;

  uint32_t qa[4][4], da[4][4];
  load_a64<true>(qa, static_cast<const bf16*>(p.q) + rowbase, C, r_lo, r_hi,
                 p.seg, c, p.scale_log2);
  load_a64<false>(da, gp.dout + rowbase, C, r_lo, r_hi, p.seg, c, 1.f);
  const float lse_lo = r_lo < p.seg ? gp.lse[resbase + r_lo] : 0.f;
  const float lse_hi = r_hi < p.seg ? gp.lse[resbase + r_hi] : 0.f;
  const float dl_lo = r_lo < p.seg ? gp.delta[resbase + r_lo] : 0.f;
  const float dl_hi = r_hi < p.seg ? gp.delta[resbase + r_hi] : 0.f;

  float dq[8][4], dbw_acc[NT][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < NT; ++i)
    dbw_acc[i][0] = dbw_acc[i][1] = dbw_acc[i][2] = dbw_acc[i][3] = 0.f;
  const bf16* kv = static_cast<const bf16*>(p.kv);

  for (int k0 = 0; k0 < t.n_keys; k0 += BK) {
    const int nk = min(BK, t.n_keys - k0);
    __syncthreads();
    const bf16* kbase = kv + ((size_t)t.b * p.S + t.seg0 + k0) * (2 * C) +
                        t.h * D;
    load_tile64<LD>(ks, kbase, 2 * C, nk, BK);
    load_tile64<LD>(vs, kbase + C, 2 * C, nk, BK);
    stage_key_terms<BK>(p, k0, ktab);
    __syncthreads();
    if (!warp_live) continue;

#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      if (kc * 16 >= nk) break;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int nt = 2 * kc + u;
        s[u][0] = s[u][1] = s[u][2] = s[u][3] = 0.f;
        dp[u][0] = dp[u][1] = dp[u][2] = dp[u][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          uint32_t b[2];
          ld_b_rows(b, ks + (nt * 8 + g) * LD + kt * 16 + 2 * c);
          mma_bf16_16816(s[u], qa[kt], b);
          ld_b_rows(b, vs + (nt * 8 + g) * LD + kt * 16 + 2 * c);
          mma_bf16_16816(dp[u], da[kt], b);
        }
      }
      // a kv_len 0 row: every key scores as masked, with no bias (once a
      // chunk, as in the forward)
      if (t.none) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
          s[u][0] = s[u][1] = s[u][2] = s[u][3] = kMaskedLog2;
      }
      float ds[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = (2 * kc + u) * 8 + 2 * c + (e & 1);
          const bool lo = e < 2;
          float pv = 0.f;
          if (j < nk) {
            float v = s[u][e];
            if (add_bias) {
              const int2 kt = ktab[j];
              const int lr = lo ? lrow_lo : lrow_hi;
              v += bias_s[kt.x * BS + lr] + bias_s[kt.y * BS + lr];
            }
            pv = exp2f(v - (lo ? lse_lo : lse_hi));
          }
          ds[u][e] = pv * (dp[u][e] - (lo ? dl_lo : dl_hi));
        }
      }
      if (has_bias) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int nt = 2 * kc + u;
#pragma unroll
          for (int e = 0; e < 4; ++e) dbw_acc[nt][e] += ds[u][e];
          // the n8 tile's 8 keys share one grid row (kw % 8 == 0)
          float slo = ds[u][0] + ds[u][1], shi = ds[u][2] + ds[u][3];
          slo += __shfl_xor_sync(0xffffffffu, slo, 1);
          slo += __shfl_xor_sync(0xffffffffu, slo, 2);
          shi += __shfl_xor_sync(0xffffffffu, shi, 1);
          shi += __shfl_xor_sync(0xffffffffu, shi, 2);
          const int krow = (k0 + nt * 8) / p.kw;
          if (c == 0 && krow < p.kh) {
            dbh_s[lrow_lo * p.kh + krow] += slo;
            dbh_s[lrow_hi * p.kh + krow] += shi;
          }
        }
      }
      // dq += dS K: k = the chunk's 16 keys, n = head dim
      uint32_t a[4];
      c_to_a(a, ds);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        uint32_t b[2];
        ld_b_cols(b, ks + (kc * 16 + 2 * c) * LD + dt * 8 + g, LD);
        mma_bf16_16816(dq[dt], a, b);
      }
    }
    // Kw 128: the tile is half a grid row, columns k0 % kw ..; fold its
    // per-position sums into the grid columns (each thread its own)
    if (has_bias && p.kw > BK) {
      const int col0 = k0 % p.kw;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lr = e < 2 ? lrow_lo : lrow_hi;
          dbw_s[lr * ldw + col0 + nt * 8 + 2 * c + (e & 1)] += dbw_acc[nt][e];
          dbw_acc[nt][e] = 0.f;
        }
      }
    }
  }
  if (warp_live)
    store_c64(gp.dq + rowbase, C, dq, r_lo, r_hi, p.seg, c, gp.scale);
  if (!has_bias) return;

  // dbias_w: with 64 % kw == 0 key position j of a tile has grid column
  // j % kw in every tile; fold the per-position sums through shared memory
  // (Kw 128 folded them per tile above)
  if (p.kw <= BK) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = e < 2 ? lrow_lo : lrow_hi;
        dbw_s[lr * BK + nt * 8 + 2 * c + (e & 1)] = dbw_acc[nt][e];
      }
    }
  }
  __syncthreads();
  const int nrows = min(BQ, p.seg - t.row0);
  const size_t brow = resbase + t.row0;
  for (int i = threadIdx.x; i < nrows * p.kh; i += blockDim.x)
    gp.dbh[brow * p.kh + i] = __float2bfloat16(dbh_s[i]);
  for (int i = threadIdx.x; i < nrows * p.kw; i += blockDim.x) {
    const int r = i / p.kw, col = i % p.kw;
    float sum = 0.f;
    for (int j = col; j < ldw; j += p.kw) sum += dbw_s[r * ldw + j];
    gp.dbw[brow * p.kw + i] = __float2bfloat16(sum);
  }
}

// ---------------------------------------------------------------------------
// Hopper kernel: a TMA producer warp + wgmma consumer warpgroups
// ---------------------------------------------------------------------------

using namespace vdr::sm90;
using vdr::k5h::kTile;

constexpr int kConsumers = 2;              // consumer warpgroups
constexpr int kStages = 4;                 // K/V ring depth
constexpr int kRows = 64 * kConsumers;     // query rows per block
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int kConsumerRegs = vdr::k5h::consumer_regs(kConsumers);
constexpr int kBiasLd = kRows + 1;         // bias_h table row (bank skew)

struct HopperParams {
  const bf16* bias_h;   // (B, H, S, kh) or nullptr
  const bf16* bias_w;   // (B, H, S, kw) or nullptr
  const int* kv_len;    // (B,) or nullptr
  const float* lse;     // (B, H, S)
  const float* delta;   // (B, H, S)
  bf16* dq;             // (B, S, H*D)
  bf16* dbh;            // (B, H, S, kh) or nullptr
  bf16* dbw;            // (B, H, S, kw) or nullptr
  int S, H, kh, kw;
  float scale_log2;     // D^-1/2 * log2(e): Q^ = bf16(q * scale_log2)
  float scale;          // D^-1/2
};

// S = Q^ K^T and dP = dO V^T for one key tile
__device__ __forceinline__ void scores_tile(float (&s)[32], float (&dp)[32],
                                            uint32_t qhat, uint32_t dout,
                                            uint32_t k_tile,
                                            uint32_t v_tile) {
  vdr::k5h::product_ss(s, qhat, k_tile);
  vdr::k5h::product_ss(dp, dout, v_tile);
}

// The tile's bias terms added to the thread's scores (rows g, g + 8;
// keys 8i + 2c..): bias_w from registers, bias_h one scalar per row; the
// sum is the forward's, s + (bias_h term + bias_w term).
__device__ __forceinline__ void add_bias(float (&s)[32], const float (&bw)[32],
                                         float bh_lo, float bh_hi) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
    s[i] += __fadd_rn((i & 2) ? bh_hi : bh_lo, bw[i]);
}

// Scores -> P (in s) and dP -> dS (in dp), in place; on the tile that
// crosses the valid end (`ragged`) keys at or past it take P = 0.
__device__ __forceinline__ void probs_ds(float (&s)[32], float (&dp)[32],
                                         float l_lo, float l_hi, float d_lo,
                                         float d_hi, bool ragged, int key0,
                                         int n_keys) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool lo = (i & 2) == 0;
    float p = fast_exp2(s[i] - (lo ? l_lo : l_hi));
    if (ragged && key0 + (i / 4) * 8 + (i & 1) >= n_keys) p = 0.f;
    s[i] = p;
    dp[i] = p * (dp[i] - (lo ? d_lo : d_hi));
  }
}

// The bias gradients of one tile from dS in registers: dbias_w per key
// position, summed across the tiles of one set of grid columns; dbias_h
// the tile's row sums (quad shuffles), stored by the lane with c == 0 at
// grid row kr of the thread's rows (dbh_lo, dbh_hi; nullptr past S). With
// kHalves (Kw 128) tile kt is half of grid row kr: an even tile whose odd
// partner is still to come (kt + 1 < n_tiles) leaves its sums in the
// thread's slots part[0] (row lo) and part[8] (row hi) of the grid row's
// table row, and the odd tile stores them plus its own.
template <bool kHalves>
__device__ __forceinline__ void bias_grads(const float (&ds)[32],
                                           float (&dbw)[32], bf16* dbh_lo,
                                           bf16* dbh_hi, int kr, int c,
                                           float* part, int kt,
                                           int n_tiles) {
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dbw[i] += ds[i];
    if (i & 2)
      hi += ds[i];
    else
      lo += ds[i];
  }
  lo += __shfl_xor_sync(0xffffffffu, lo, 1);
  lo += __shfl_xor_sync(0xffffffffu, lo, 2);
  hi += __shfl_xor_sync(0xffffffffu, hi, 1);
  hi += __shfl_xor_sync(0xffffffffu, hi, 2);
  if (c == 0) {
    if constexpr (kHalves) {
      if ((kt & 1) == 0 && kt + 1 < n_tiles) {
        part[0] = lo;
        part[8] = hi;
        return;
      }
      if (kt & 1) {
        lo = part[0] + lo;
        hi = part[8] + hi;
      }
    }
    if (dbh_lo != nullptr) dbh_lo[kr] = __float2bfloat16(lo);
    if (dbh_hi != nullptr) dbh_hi[kr] = __float2bfloat16(hi);
  }
}

// kBoxes: 0 without a bias; with the decomposed bias, the 64-column
// halves of a grid row, 1 (Kw 64) or 2 (Kw 128).
template <int kBoxes>
__global__ void __launch_bounds__(kThreads, 1)
    dq_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tkv,
                     const __grid_constant__ CUtensorMap tdo,
                     const HopperParams p) {
  constexpr bool kBias = kBoxes > 0, kHalves = kBoxes > 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], qbar;
  // the swizzled tiles need 1024-byte alignment in the shared window
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t qd_addr = smem_u32(base);    // per warpgroup: Q^, dO
  const uint32_t ring = qd_addr + 2 * kConsumers * kTile;  // K, V stages
  float* bh_s = reinterpret_cast<float*>(
      base + (2 * kConsumers + 2 * kStages) * kTile);      // [kh][kBiasLd]
  // Kw 128: the even tiles' dbias_h row sums, [kh][kBiasLd]
  float* dbh_s = bh_s + p.kh * kBiasLd;

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows;
  const int C = p.H * 64;
  // keys j < lim are valid; with none valid every key of the row is
  // visited, all masked (P = 1 per key from the residual)
  const int lim = p.kv_len != nullptr ? min(p.S, max(p.kv_len[b], 0)) : p.S;
  const int n_keys = lim > 0 ? lim : p.S;
  const bool none = lim == 0;
  const int n_tiles = (n_keys + 63) / 64;
  const int n_even = (n_tiles + 1) / 2;   // Kw 128: the tiles of columns 0-63

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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     vdr::k5h::kProducerRegs)
                 : "memory");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(&qbar, 2 * kConsumers * kTile);
      for (int w = 0; w < kConsumers; ++w) {
        tma_load(qd_addr + 2 * w * kTile, &tq, &qbar, h * 64, row0 + 64 * w,
                 b);
        tma_load(qd_addr + (2 * w + 1) * kTile, &tdo, &qbar, h * 64,
                 row0 + 64 * w, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
        const int key0 = key_tile<kHalves>(j, n_even) * 64;
        mbar_expect_tx(&full[st], 2 * kTile);
        tma_load(ring + 2 * st * kTile, &tkv, &full[st], h * 64, key0, b);
        tma_load(ring + (2 * st + 1) * kTile, &tkv, &full[st], C + h * 64,
                 key0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup, the key tiles stream ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, c = lane % 4;
    const int r_lo = wg * 64 + warp * 16 + g, r_hi = r_lo + 8;  // in block
    const int R_lo = row0 + r_lo, R_hi = row0 + r_hi;
    const size_t res_row = ((size_t)b * p.H + h) * p.S;
    const float inf = __int_as_float(0x7f800000);
    // rows past S: P = 0 from an lse of +inf (their q and dO read zeros)
    const float l_lo = R_lo < p.S ? p.lse[res_row + R_lo] : inf;
    const float l_hi = R_hi < p.S ? p.lse[res_row + R_hi] : inf;
    const float d_lo = R_lo < p.S ? p.delta[res_row + R_lo] : 0.f;
    const float d_hi = R_hi < p.S ? p.delta[res_row + R_hi] : 0.f;
    const bool add = kBias && !none;

    float bw[32], dbw[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) bw[i] = dbw[i] = 0.f;
    if constexpr (kBias) {
      // bias_h of this warpgroup's 64 rows, transposed to [grid row][row]
      for (int i = t; i < 64 * p.kh; i += 128) {
        const int r = wg * 64 + i / p.kh, kr = i % p.kh;
        const int R = row0 + r;
        bh_s[kr * kBiasLd + r] =
            R < p.S ? vdr::k5h::term(p.bias_h[(res_row + R) * p.kh + kr])
                    : 0.f;
      }
    }
    // bias_w: a 64-key tile is one grid row (or, Kw 128, the half of one
    // at columns col0..), so key 8i + 2c.. of every tile takes the same
    // columns
    auto load_bw = [&](int col0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int R = half ? R_hi : R_lo;
          if (R < p.S) {
            const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
                p.bias_w + (res_row + R) * p.kw + col0 + i * 8 + 2 * c);
            bw[4 * i + 2 * half] = vdr::k5h::term(__low2bfloat16(v));
            bw[4 * i + 2 * half + 1] = vdr::k5h::term(__high2bfloat16(v));
          }
        }
      }
    };
    auto store_dbw = [&](int col0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = col0 + 8 * i + 2 * c;
        if (R_lo < p.S)
          *reinterpret_cast<__nv_bfloat162*>(
              p.dbw + (res_row + R_lo) * p.kw + col) =
              __floats2bfloat162_rn(dbw[4 * i], dbw[4 * i + 1]);
        if (R_hi < p.S)
          *reinterpret_cast<__nv_bfloat162*>(
              p.dbw + (res_row + R_hi) * p.kw + col) =
              __floats2bfloat162_rn(dbw[4 * i + 2], dbw[4 * i + 3]);
      }
    };
    if constexpr (kBias) load_bw(0);
    // Q^ in place: the warpgroup scales its own q tile
    const uint32_t q_addr = qd_addr + 2 * wg * kTile, do_addr = q_addr + kTile;
    mbar_wait(&qbar, 0);
    vdr::k5h::scale_tile(base + 2 * wg * kTile, base + 2 * wg * kTile,
                         p.scale_log2, t, 128);
    fence_proxy_async();
    bar_sync(1 + wg, 128);

    float dq[32], s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    uint32_t da[4][4];
    bf16* dbh_lo = nullptr;
    bf16* dbh_hi = nullptr;
    if (kBias && R_lo < p.S) dbh_lo = p.dbh + (res_row + R_lo) * p.kh;
    if (kBias && R_hi < p.S) dbh_hi = p.dbh + (res_row + R_hi) * p.kh;
    // step j's scores -> P and dS in place (bias, exponentials, masks), and
    // its bias gradients
    auto tile_math = [&](int j) {
      if (none) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = vdr::kMaskedLog2;
      }
      const int kt = key_tile<kHalves>(j, n_even);
      const int kr = kt * 64 / p.kw;
      const float* bh = bh_s + kr * kBiasLd;
      if (add) add_bias(s, bw, bh[r_lo], bh[r_hi]);
      const bool ragged = (kt + 1) * 64 > n_keys;
      probs_ds(s, dp, l_lo, l_hi, d_lo, d_hi, ragged, kt * 64 + 2 * c,
               n_keys);
      if constexpr (kBias)
        bias_grads<kHalves>(dp, dbw, dbh_lo, dbh_hi, kr, c,
                            dbh_s + kr * kBiasLd + r_lo, kt, n_tiles);
    };
    // Kw 128, at the first odd tile: the even half's dbias_w goes out and
    // the odd half's bias_w comes in
    auto next_half = [&] {
      store_dbw(0);
#pragma unroll
      for (int i = 0; i < 32; ++i) dbw[i] = 0.f;
      load_bw(64);
    };
    // ping-pong: a warpgroup issues its products after the one before it
    // (named barriers 1 .. kConsumers serve the set-up above)
    const int my_bar = 1 + kConsumers + wg;
    const int next_bar = 1 + kConsumers + (wg + 1) % kConsumers;
    auto issue_wait = [&] { bar_sync(my_bar, 256); };
    auto issue_done = [&] { bar_arrive(next_bar, 256); };
    // software pipeline: the scores of tile j are issued with dQ of tile
    // j-1, and tile j's exponentials run while that is on the tensor cores
    if (wg == kConsumers - 1) issue_done();
    mbar_wait(&full[0], 0);
    issue_wait();
    wgmma_fence();
    scores_tile(s, dp, q_addr, do_addr, ring, ring + kTile);
    wgmma_commit();
    issue_done();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    tile_math(0);
    vdr::k5h::pack_a(dp, da);
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % kStages;
      const uint32_t cur = ring + 2 * st * kTile;
      const uint32_t prev = ring + 2 * ((j - 1) % kStages) * kTile;
      if constexpr (kHalves) {
        if (j == n_even) next_half();
      }
      mbar_wait(&full[st], (j / kStages) & 1);
      issue_wait();
      wgmma_fence();
      scores_tile(s, dp, q_addr, do_addr, cur, cur + kTile);
      wgmma_commit();
      vdr::k5h::product_rs(dq, da, prev);
      wgmma_commit();
      issue_done();
      wgmma_wait<1>();
      fence_regs(s);
      fence_regs(dp);
      tile_math(j);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(da);
      mbar_arrive(&empty[(j - 1) % kStages]);
      vdr::k5h::pack_a(dp, da);
    }
    const uint32_t last = ring + 2 * ((n_tiles - 1) % kStages) * kTile;
    issue_wait();
    wgmma_fence();
    vdr::k5h::product_rs(dq, da, last);
    wgmma_commit();
    // every sync is matched: the last warpgroup's first arrive stands in
    // for its final one
    if (wg != kConsumers - 1) issue_done();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(&empty[(n_tiles - 1) % kStages]);

    bf16* out = p.dq + (size_t)b * p.S * C + h * 64;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = 8 * i + 2 * c;
      if (R_lo < p.S)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)R_lo * C + d) =
            __floats2bfloat162_rn(dq[4 * i] * p.scale,
                                  dq[4 * i + 1] * p.scale);
      if (R_hi < p.S)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)R_hi * C + d) =
            __floats2bfloat162_rn(dq[4 * i + 2] * p.scale,
                                  dq[4 * i + 3] * p.scale);
    }
    if constexpr (kHalves) {
      // one tile visited: no odd half, whose columns take zeros
      if (n_tiles == 1) next_half();
      store_dbw(64);
    } else if constexpr (kBias) {
      store_dbw(0);
    }
    if constexpr (kBias) {
      // grid rows past the visited tiles (all keys masked): zero
      for (int kr = (kHalves ? n_even : n_tiles) + c; kr < p.kh; kr += 4) {
        if (dbh_lo != nullptr) dbh_lo[kr] = __float2bfloat16(0.f);
        if (dbh_hi != nullptr) dbh_hi[kr] = __float2bfloat16(0.f);
      }
    }
  }
}

// kh tables of bias_h terms and (Kw 128) of the even tiles' dbias_h sums
size_t hopper_smem(int kh, int tables) {
  return 1024 + (size_t)(2 * kConsumers + 2 * kStages) * kTile +
         (size_t)tables * kh * kBiasLd * sizeof(float);
}

int launch_hopper(const void* q, const void* kv, const void* dout,
                  const HopperParams& p, int B, cudaStream_t stream) {
  CUtensorMap tq, tkv, tdo;
  const int C = p.H * 64;
  if (!tensor_map_64(&tq, q, C, p.S, B) ||
      !tensor_map_64(&tkv, kv, 2 * C, p.S, B) ||
      !tensor_map_64(&tdo, dout, C, p.S, B))
    return vdr::k5h::kErrTensorMap;
  const int boxes = p.bias_h != nullptr ? p.kw / 64 : 0;
  const size_t smem = hopper_smem(p.kh, boxes);
  auto kern = boxes == 2   ? dq_hopper_kernel<2>
              : boxes == 1 ? dq_hopper_kernel<1>
                           : dq_hopper_kernel<0>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + kRows - 1) / kRows, p.H, B);
  kern<<<grid, kThreads, smem, stream>>>(tq, tkv, tdo, p);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" {

const char* vdr_error_string(int err) { return vdr::error_string(err); }

// 1 when a call with these arguments runs the Hopper kernel, 0 when it
// runs the first loops (the same choice as the dkv kernel's).
int vdr_global_attention_bwd_route(int S, int H, int D, int kh, int kw,
                                   int biased) {
  return vdr::k5h::takes(D, biased != 0, kh, kw) ? 1 : 0;
}

// bf16 only. Returns 0 on success, a cudaError_t after a failed launch, -1
// for a head dim other than 64, -2 for a bias with kw not in
// {8,16,32,64,128},
// -3 when a TMA descriptor cannot be made.
int vdr_global_attention_bwd_dq(const void* q, const void* kv,
                                const void* bias_h, const void* bias_w,
                                const int* kv_len, const void* dout,
                                const float* lse, const float* delta,
                                void* dq, void* dbh, void* dbw, int B, int S,
                                int H, int D, int kh, int kw, float scale,
                                void* stream) {
  if (D != 64) return -1;
  const bool has_bias = bias_h != nullptr;
  if (has_bias && !vdr::k5h::bias_width_ok(kw)) return -2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vdr::k5h::takes(D, has_bias, kh, kw)) {
    const HopperParams hp{static_cast<const bf16*>(bias_h),
                          static_cast<const bf16*>(bias_w),
                          kv_len,
                          lse,
                          delta,
                          static_cast<bf16*>(dq),
                          static_cast<bf16*>(dbh),
                          static_cast<bf16*>(dbw),
                          S,
                          H,
                          kh,
                          kw,
                          scale * vdr::kLog2e,
                          scale};
    return launch_hopper(q, kv, dout, hp, B, st);
  }
  vdr::AttnParams p{q, kv, bias_h, bias_w, kv_len, nullptr, B, S,
                    H, S,  kh,     kw,     scale * vdr::kLog2e};
  vdr::GradParams gp{static_cast<const bf16*>(dout), nullptr, lse, delta,
                     static_cast<bf16*>(dq), nullptr,
                     static_cast<bf16*>(dbh), static_cast<bf16*>(dbw),
                     scale};
  const size_t smem = smem_bytes(kh, kw, has_bias);
  cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  dq_kernel<<<grid, BQ * 2, smem, st>>>(p, gp);
  return (int)cudaGetLastError();
}

}  // extern "C"
