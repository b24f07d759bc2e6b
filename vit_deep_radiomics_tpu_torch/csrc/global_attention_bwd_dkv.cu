// K5 backward, dkv: key and value gradients of trainable global attention.
//
// Replaces: vit_deep_radiomics_tpu/ops/attention_grad.py::_fgt_dkv_kernel
// (global_attention_trainable's backward, a Pallas TPU kernel).
//
// FlashAttention-2 style: a block owns keys of one (batch, head) and loops
// over the queries in 64-row tiles. Per tile it recomputes the transposed
// scores S^T = K (q D^-1/2 log2 e)^T plus the bias, as the forward computed
// them (q scaled in fp32 and rounded to bf16 once, the bias terms times
// log2 e in fp32, masked keys at -1e30 log2 e), P^T = exp2(S^T - lse),
// dP^T = V dO^T and dS^T = P^T * (dP^T - D); then
//     dv += P^T dO      dk += dS^T Q
// with P and dS rounded to bf16. dk is scaled by D^-1/2 at the end, and
// dk, dv are written into dkv (B, S, 2*H*D) in the projection layout (k
// columns [0, H*D), v columns [H*D, 2*H*D)).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the
// fine-tuning path's shapes (2 x 4096 tokens x 12 heads of 64) it does
// 8 S^2 D H B = 206 GFLOP (four 64-deep products per (key, query) pair;
// 0.208 ms at the bf16 peak) against about 101 MB of compulsory traffic
// (0.030 ms): compute-bound. Only wgmma reaches that rate, and at D = 64
// each 64 x 64 tile carries 32 exponentials and the bias per thread
// besides its four products, so that work has to run under the products.
//
// What the design does about it (bf16 calls with no bias or Kw = 64: the
// fast path of SAM's global layers and of DINOv2's kv_len layers):
//  * warp specialisation: one producer warp brings each query tile's q,
//    dO and bias_w rows by TMA (128-byte swizzle) into a ring of kStages
//    stages guarded by full/empty mbarriers, and stages lse, D and the
//    warpgroups' bias_h columns (times log2 e) beside them by plain loads;
//  * two consumer warpgroups own 64 keys each; their K and V tiles come
//    once by TMA and stay in shared memory as the K-major A operands of
//    S^T = K Q^T and dP^T = V dO^T (wgmma, Q^ and dO K-major B);
//  * Q^, the forward's pre-scaled q, is written once per tile into a
//    second swizzled buffer, half by each warpgroup (fence.proxy.async,
//    then an arrival on the stage's qready mbarrier, which a warpgroup
//    waits on just before its scores), one tile ahead of its use;
//  * P^T and dS^T are formed in the fp32 score registers and rounded to
//    bf16 in place as the register A operands of dV += P^T dO and
//    dK += dS^T Q (dO and raw q MN-major B); the products of tile j-1 are
//    issued with the scores of tile j, so tile j's exponentials run while
//    they are on the tensor cores, and the Q^ exchange staggers the two
//    warpgroups (an explicit ping-pong of their issue measured slower);
//  * the bias: a 64-key warpgroup lies inside one grid row, so bias_h is
//    one staged scalar per query, and ldmatrix.trans reads bias_w from its
//    [query][key] rows with one 32-bit register for the two queries a
//    thread holds per key;
//  * kv_len: a block wholly past it writes zeros; the ragged warpgroup
//    masks its keys by one flag; a kv_len 0 row scores every key at
//    -1e30 log2 e by one flag per block; queries past S read zeros (TMA
//    fill) and an lse of +inf, so P = 0 there.
// Every output element is written once by one thread: no atomics, the
// same bits on every run. Biased calls with Kw in {8, 16, 32, 128} keep
// the first loops below (mma.sync, one synchronously staged query tile, the
// bias read per score from shared memory; at Kw 128 a block's 64 keys are
// half of one grid row); vdr_global_attention_bwd_route
// reports the choice, which the C entry makes by shape alone.

#include "attention_bwd_core.cuh"

namespace {
using vdr::bf16;

// ---------------------------------------------------------------------------
// First loops (mma.sync): biased calls with Kw in {8, 16, 32, 128}
// ---------------------------------------------------------------------------

constexpr int D = 64;
constexpr int BK = 64;   // keys per block (4 warps x 16)
constexpr int BQ = 64;   // queries per tile
constexpr int LD = D + 8;
constexpr int BS = BQ + 4;   // row stride of the staged bias terms

// grid rows a block's 64 keys span: 64 / kw, or one (Kw 128, half a row)
__host__ __device__ inline int block_grid_rows(int kw) {
  return kw > BK ? 1 : BK / kw;
}

size_t smem_bytes(int kw, bool has_bias) {
  size_t n = 2 * BQ * LD * sizeof(bf16) + 2 * BQ * sizeof(float);
  if (has_bias) n += (size_t)(block_grid_rows(kw) + kw) * BS * sizeof(float);
  return n;
}

__global__ void __launch_bounds__(BK * 2)
    dkv_kernel(vdr::AttnParams p, vdr::GradParams gp) {
  using namespace vdr;
  extern __shared__ __align__(16) char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);              // [BQ][LD]
  bf16* dos = qs + BQ * LD;                               // [BQ][LD]
  float* lse_s = reinterpret_cast<float*>(dos + BQ * LD);  // [BQ]
  float* dl_s = lse_s + BQ;                               // [BQ]
  float* bias_s = dl_s + BQ;   // [BK / kw grid rows + kw grid cols][BS]

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BK;
  const int C = p.H * D;
  // keys j >= lim are masked; with none valid every key is visited, all
  // masked (P = 1 per key from the residual, as in the plain version)
  const int lim = p.kv_len != nullptr ? min(p.S, max(p.kv_len[b], 0)) : p.S;
  const int n_keys = lim > 0 ? lim : p.S;
  const bool has_bias = p.bias_h != nullptr;
  const bool add_bias = has_bias && lim > 0;
  const int nkr = has_bias ? block_grid_rows(p.kw) : 0;  // grid rows here
  const int krow0 = has_bias ? k0 / p.kw : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const bool warp_live = k0 + warp * 16 < n_keys;

  const bf16* kv = static_cast<const bf16*>(p.kv) + (size_t)b * p.S * 2 * C +
                   h * D;
  uint32_t ka[4][4], va[4][4];
  load_a64<false>(ka, kv, 2 * C, key_lo, key_hi, p.S, c, 1.f);
  load_a64<false>(va, kv + C, 2 * C, key_lo, key_hi, p.S, c, 1.f);
  // bias term rows of this thread's two keys in bias_s
  const int th_lo = has_bias ? key_lo / p.kw - krow0 : 0;
  const int th_hi = has_bias ? key_hi / p.kw - krow0 : 0;
  const int tw_lo = has_bias ? nkr + key_lo % p.kw : 0;
  const int tw_hi = has_bias ? nkr + key_hi % p.kw : 0;

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const bf16* q = static_cast<const bf16*>(p.q) + (size_t)b * p.S * C + h * D;
  const bf16* dout = gp.dout + (size_t)b * p.S * C + h * D;
  const size_t resbase = ((size_t)b * p.H + h) * p.S;

  for (int q0 = 0; q0 < p.S; q0 += BQ) {
    const int nq = min(BQ, p.S - q0);
    __syncthreads();
    load_tile64<LD>(qs, q + (size_t)q0 * C, C, nq, BQ);
    load_tile64<LD>(dos, dout + (size_t)q0 * C, C, nq, BQ);
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
      lse_s[i] = i < nq ? gp.lse[resbase + q0 + i] : 0.f;
      dl_s[i] = i < nq ? gp.delta[resbase + q0 + i] : 0.f;
    }
    if (has_bias) {
      // grid-row terms of the block's keys and all grid-column terms for
      // the tile's queries, times log2(e) (the forward's stage_bias)
      const size_t qrow = resbase + q0;
      for (int i = threadIdx.x; i < BQ * nkr; i += blockDim.x) {
        const int r = i % BQ, t = i / BQ;
        bias_s[t * BS + r] =
            r < nq && krow0 + t < p.kh
                ? to_f32(static_cast<const bf16*>(p.bias_h)
                             [(qrow + r) * p.kh + krow0 + t]) * kLog2e
                : 0.f;
      }
      for (int i = threadIdx.x; i < BQ * p.kw; i += blockDim.x) {
        const int r = i / p.kw, t = i % p.kw;
        bias_s[(nkr + t) * BS + r] =
            r < nq ? to_f32(static_cast<const bf16*>(p.bias_w)
                                [(qrow + r) * p.kw + t]) * kLog2e
                   : 0.f;
      }
    }
    __syncthreads();
    if (!warp_live) continue;

#pragma unroll
    for (int qc = 0; qc < BQ / 16; ++qc) {
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
      // a kv_len 0 row: every key scores as masked, with no bias (once a
      // chunk, so the code per score is that of a row with valid keys)
      if (lim == 0) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
          st[u][0] = st[u][1] = st[u][2] = st[u][3] = kMaskedLog2;
      }
      float pt[2][4], dst[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (2 * qc + u) * 8 + 2 * c + (e & 1);
          const bool lo = e < 2;
          float pv = 0.f;
          if (i < nq && (lo ? key_lo : key_hi) < n_keys) {
            float v = st[u][e];
            if (add_bias)
              v += bias_s[(lo ? th_lo : th_hi) * BS + i] +
                   bias_s[(lo ? tw_lo : tw_hi) * BS + i];
            pv = exp2f(v - lse_s[i]);
          }
          pt[u][e] = pv;
          dst[u][e] = pv * (dpt[u][e] - dl_s[i]);
        }
      }
      uint32_t pa[4], sa[4];
      c_to_a(pa, pt);
      c_to_a(sa, dst);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        uint32_t b2[2];
        ld_b_cols(b2, dos + (qc * 16 + 2 * c) * LD + dt * 8 + g, LD);
        mma_bf16_16816(dv[dt], pa, b2);
        ld_b_cols(b2, qs + (qc * 16 + 2 * c) * LD + dt * 8 + g, LD);
        mma_bf16_16816(dk[dt], sa, b2);
      }
    }
  }
  bf16* dkv = gp.dkv + (size_t)b * p.S * 2 * C + h * D;
  store_c64(dkv, 2 * C, dk, key_lo, key_hi, p.S, c, gp.scale);
  store_c64(dkv + C, 2 * C, dv, key_lo, key_hi, p.S, c, 1.f);
}

// ---------------------------------------------------------------------------
// Hopper kernel: a TMA producer warp + wgmma consumer warpgroups
// ---------------------------------------------------------------------------

using namespace vdr::sm90;
using vdr::k5h::kTile;

constexpr int kConsumers = 2;              // consumer warpgroups
constexpr int kStages = 4;                 // query-tile ring depth
constexpr int kKeys = 64 * kConsumers;     // keys per block
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int kConsumerRegs = vdr::k5h::consumer_regs(kConsumers);
// a stage: the raw q tile, dO, the scaled copy Q^ and the bias_w rows
constexpr int kStageBytes = 4 * kTile;
// and in fp32: lse, D, and each warpgroup's bias_h column (log2 units)
constexpr int kSmallFloats = (2 + kConsumers) * 64;
static_assert(kStages >= 3, "Q^ of tile j+1 is made before tile j-1's "
                            "stage is released");

struct HopperParams {
  const bf16* bias_h;   // (B, H, S, kh) or nullptr
  const int* kv_len;    // (B,) or nullptr
  const float* lse;     // (B, H, S)
  const float* delta;   // (B, H, S)
  bf16* dkv;            // (B, S, 2*H*D)
  int S, H, kh, kw;
  float scale_log2;     // D^-1/2 * log2(e): Q^ = bf16(q * scale_log2)
  float scale;          // D^-1/2
};

// S^T = K Q^T and dP^T = V dO^T for one query tile
__device__ __forceinline__ void scores_tile(float (&s)[32], float (&dp)[32],
                                            uint32_t k_tile, uint32_t v_tile,
                                            uint32_t qhat, uint32_t dout) {
  vdr::k5h::product_ss(s, k_tile, qhat);
  vdr::k5h::product_ss(dp, v_tile, dout);
}

// dV += P^T dO and dK += dS^T Q (raw q) for one query tile
__device__ __forceinline__ void grads_tile(float (&dv)[32], float (&dk)[32],
                                           const uint32_t (&pa)[4][4],
                                           const uint32_t (&sa)[4][4],
                                           uint32_t dout, uint32_t q) {
  vdr::k5h::product_rs(dv, pa, dout);
  vdr::k5h::product_rs(dk, sa, q);
}

// The tile's bias terms added to the thread's scores S^T (keys g, g + 8 of
// its warp; queries 8i + 2c, 8i + 2c + 1): bias_h of the warpgroup's grid
// row per query from the staged column, bias_w from the TMA'd [query][key]
// rows by ldmatrix.trans, one 32-bit register for the two queries of a key.
// The sum is the forward's: s + (bias_h term + bias_w term).
__device__ __forceinline__ void add_bias(float (&s)[32], const float* bh,
                                         uint32_t bw_tile, int warp, int lane,
                                         int c) {
  const int m = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    // matrices (query block 2n + m/2, key block 2 warp + m % 2)
    const int qr = 8 * (2 * n + (m >> 1)) + rr, kb = 2 * warp + (m & 1);
    uint32_t r[4];
    vdr::k5h::ldmatrix_x4_trans(r, bw_tile + qr * 128 + ((kb ^ rr) << 4));
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = 2 * n + u;
      const float2 h = *reinterpret_cast<const float2*>(bh + 8 * i + 2 * c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat162 w =
            *reinterpret_cast<const __nv_bfloat162*>(&r[2 * u + half]);
        s[4 * i + 2 * half] +=
            __fadd_rn(h.x, vdr::k5h::term(__low2bfloat16(w)));
        s[4 * i + 2 * half + 1] +=
            __fadd_rn(h.y, vdr::k5h::term(__high2bfloat16(w)));
      }
    }
  }
}

// Scores -> P^T (in s) and dP^T -> dS^T (in dp), in place: P = exp2(s -
// lse) with the forward's lse (+inf past S: P = 0), dS = P (dP - D); keys
// at or past the valid end take P = 0 (a warpgroup-wide flag, `ragged`).
__device__ __forceinline__ void probs_ds(float (&s)[32], float (&dp)[32],
                                         const float* lse, const float* dl,
                                         int c, bool ragged, bool lo_ok,
                                         bool hi_ok) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * i + 2 * c);
    const float2 d = *reinterpret_cast<const float2*>(dl + 8 * i + 2 * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = fast_exp2(s[4 * i + e] - ((e & 1) ? l.y : l.x));
      if (ragged && !(e < 2 ? lo_ok : hi_ok)) p = 0.f;
      s[4 * i + e] = p;
      dp[4 * i + e] = p * (dp[4 * i + e] - ((e & 1) ? d.y : d.x));
    }
  }
}

// kBias: the decomposed bias with a 64-key grid row (Kw = 64).
template <bool kBias>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tkv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tbw,
                      const HopperParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages],
      qready[kStages], kvbar;
  // the swizzled tiles need 1024-byte alignment in the shared window
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t kv_addr = smem_u32(base);       // per warpgroup: K, V
  unsigned char* stages = base + 2 * kConsumers * kTile;
  float* small = reinterpret_cast<float*>(stages + kStages * kStageBytes);

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kKeys;
  const int C = p.H * 64;
  // keys j >= lim are masked; with none valid every key of the row is
  // visited, all masked (P = 1 per key from the residual)
  const int lim = p.kv_len != nullptr ? min(p.S, max(p.kv_len[b], 0)) : p.S;
  const int n_keys = lim > 0 ? lim : p.S;
  const bool none = lim == 0;
  const int n_tiles = (p.S + 63) / 64;
  bf16* dkv = p.dkv + (size_t)b * p.S * 2 * C + h * 64;

  if (k0 >= n_keys) {
    // every key of the block is masked: zero gradients, no work
    for (int i = threadIdx.x; i < kKeys * 16; i += kThreads) {
      const int key = k0 + i / 16, col = (i % 16) * 8;
      if (key < p.S)
        *reinterpret_cast<uint4*>(dkv + (size_t)key * 2 * C +
                                  (col < 64 ? col : C + col - 64)) =
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
  const size_t res_row = ((size_t)b * p.H + h) * p.S;
  if (wg == kConsumers) {
    // ---- producer: one warp, TMA for the tiles, plain loads for the rest
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     vdr::k5h::kProducerRegs)
                 : "memory");
    if (threadIdx.x >= kConsumers * 128 + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(&kvbar, 2 * kConsumers * kTile);
      for (int w = 0; w < kConsumers; ++w) {
        tma_load(kv_addr + 2 * w * kTile, &tkv, &kvbar, h * 64, k0 + 64 * w,
                 b);
        tma_load(kv_addr + (2 * w + 1) * kTile, &tkv, &kvbar, C + h * 64,
                 k0 + 64 * w, b);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages, q0 = j * 64;
      mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
      float* sm = small + st * kSmallFloats;
      for (int i = lane; i < 64; i += 32) {
        const int q = q0 + i;
        const bool in = q < p.S;
        sm[i] = in ? p.lse[res_row + q] : __int_as_float(0x7f800000);
        sm[64 + i] = in ? p.delta[res_row + q] : 0.f;
        if constexpr (kBias) {
          for (int w = 0; w < kConsumers; ++w) {
            const int kr = (k0 + 64 * w) / p.kw;
            sm[128 + 64 * w + i] =
                in && kr < p.kh
                    ? vdr::k5h::term(p.bias_h[(res_row + q) * p.kh + kr])
                    : 0.f;
          }
        }
      }
      if (lane == 0) {
        const uint32_t sa = smem_u32(stages + st * kStageBytes);
        mbar_expect_tx(&full[st], (kBias ? 3 : 2) * kTile);
        tma_load(sa, &tq, &full[st], h * 64, q0, b);
        tma_load(sa + kTile, &tdo, &full[st], h * 64, q0, b);
        if constexpr (kBias)
          tma_load(sa + 3 * kTile, &tbw, &full[st], 0, q0, b * p.H + h);
      } else {
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // ---- consumers: 64 keys per warpgroup, the query tiles stream ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int c = lane % 4;
    const int key_lo = k0 + 64 * wg + 16 * warp + lane / 4;
    const int key_hi = key_lo + 8;
    const bool ragged = k0 + 64 * wg + 64 > n_keys;
    const bool lo_ok = key_lo < n_keys, hi_ok = key_hi < n_keys;
    const bool add = kBias && !none;
    const uint32_t k_tile = kv_addr + 2 * wg * kTile, v_tile = k_tile + kTile;
    auto stage = [&](int j) { return stages + (j % kStages) * kStageBytes; };
    auto stage_at = [&](int j) { return smem_u32(stage(j)); };
    // Q^ of tile j: both warpgroups scale half of the raw tile each and
    // say so on qready (no wait: a warpgroup waits only before its scores)
    auto make_qhat = [&](int j) {
      mbar_wait(&full[j % kStages], (j / kStages) & 1);
      unsigned char* st = stage(j);
      vdr::k5h::scale_tile(st + 2 * kTile, st, p.scale_log2, threadIdx.x,
                           kConsumers * 128);
      fence_proxy_async();
      mbar_arrive(&qready[j % kStages]);
    };

    float dk[32], dv[32], s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    uint32_t pa[4][4], sa[4][4];
    // tile j's scores -> P^T and dS^T in place (bias, exponentials, masks)
    auto tile_math = [&](int j) {
      const float* sm = small + (j % kStages) * kSmallFloats;
      if (none) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = vdr::kMaskedLog2;
      }
      const uint32_t bw_tile = stage_at(j) + 3 * kTile;
      if (add) add_bias(s, sm + 128 + 64 * wg, bw_tile, warp, lane, c);
      probs_ds(s, dp, sm, sm + 64, c, ragged, lo_ok, hi_ok);
    };
    // software pipeline: the scores of tile j are issued with the products
    // of tile j-1, and tile j's exponentials run while those are on the
    // tensor cores; Q^ of tile j+1 is made meanwhile
    make_qhat(0);
    mbar_wait(&kvbar, 0);
    const uint32_t first = stage_at(0);
    mbar_wait(&qready[0], 0);
    wgmma_fence();
    scores_tile(s, dp, k_tile, v_tile, first + 2 * kTile, first + kTile);
    wgmma_commit();
    if (n_tiles > 1) make_qhat(1);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    tile_math(0);
    vdr::k5h::pack_a(s, pa);
    vdr::k5h::pack_a(dp, sa);
    for (int j = 1; j < n_tiles; ++j) {
      const uint32_t cur = stage_at(j), prev = stage_at(j - 1);
      mbar_wait(&qready[j % kStages], (j / kStages) & 1);
      wgmma_fence();
      scores_tile(s, dp, k_tile, v_tile, cur + 2 * kTile, cur + kTile);
      wgmma_commit();
      grads_tile(dv, dk, pa, sa, prev + kTile, prev);
      wgmma_commit();
      if (j + 1 < n_tiles) make_qhat(j + 1);
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
      vdr::k5h::pack_a(s, pa);
      vdr::k5h::pack_a(dp, sa);
    }
    const uint32_t last = stage_at(n_tiles - 1);
    wgmma_fence();
    grads_tile(dv, dk, pa, sa, last + kTile, last);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    mbar_arrive(&empty[(n_tiles - 1) % kStages]);

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = 8 * i + 2 * c;
      if (key_lo < p.S) {
        bf16* row = dkv + (size_t)key_lo * 2 * C + d;
        *reinterpret_cast<__nv_bfloat162*>(row) = __floats2bfloat162_rn(
            dk[4 * i] * p.scale, dk[4 * i + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(row + C) =
            __floats2bfloat162_rn(dv[4 * i], dv[4 * i + 1]);
      }
      if (key_hi < p.S) {
        bf16* row = dkv + (size_t)key_hi * 2 * C + d;
        *reinterpret_cast<__nv_bfloat162*>(row) = __floats2bfloat162_rn(
            dk[4 * i + 2] * p.scale, dk[4 * i + 3] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(row + C) =
            __floats2bfloat162_rn(dv[4 * i + 2], dv[4 * i + 3]);
      }
    }
  }
}

size_t hopper_smem() {
  return 1024 + (size_t)(2 * kConsumers + kStages * 4) * kTile +
         (size_t)kStages * kSmallFloats * sizeof(float);
}

int launch_hopper(const void* q, const void* kv, const void* bias_w,
                  const void* dout, const HopperParams& p, int B,
                  cudaStream_t stream) {
  CUtensorMap tq, tkv, tdo, tbw;
  const int C = p.H * 64;
  if (!tensor_map_64(&tq, q, C, p.S, B) ||
      !tensor_map_64(&tkv, kv, 2 * C, p.S, B) ||
      !tensor_map_64(&tdo, dout, C, p.S, B))
    return vdr::k5h::kErrTensorMap;
  const bool bias = p.bias_h != nullptr;
  if (bias && !tensor_map_64(&tbw, bias_w, p.kw, p.S, B * p.H))
    return vdr::k5h::kErrTensorMap;
  if (!bias) tbw = tdo;   // never read
  const size_t smem = hopper_smem();
  auto kern = bias ? dkv_hopper_kernel<true> : dkv_hopper_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + kKeys - 1) / kKeys, p.H, B);
  kern<<<grid, kThreads, smem, stream>>>(tq, tkv, tdo, tbw, p);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" {

const char* vdr_error_string(int err) { return vdr::error_string(err); }

// 1 when a call with these arguments runs the Hopper kernel, 0 when it
// runs the first loops (the same choice as the dq kernel's).
int vdr_global_attention_bwd_route(int S, int H, int D, int kh, int kw,
                                   int biased) {
  return vdr::k5h::takes(D, biased != 0, kh, kw) ? 1 : 0;
}

// bf16 only. Returns 0 on success, a cudaError_t after a failed launch, -1
// for a head dim other than 64, -2 for a bias with kw not in
// {8,16,32,64,128},
// -3 when a TMA descriptor cannot be made.
int vdr_global_attention_bwd_dkv(const void* q, const void* kv,
                                 const void* bias_h, const void* bias_w,
                                 const int* kv_len, const void* dout,
                                 const float* lse, const float* delta,
                                 void* dkv, int B, int S, int H, int D,
                                 int kh, int kw, float scale, void* stream) {
  if (D != 64) return -1;
  const bool has_bias = bias_h != nullptr;
  if (has_bias && !vdr::k5h::bias_width_ok(kw)) return -2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vdr::k5h::takes(D, has_bias, kh, kw)) {
    const HopperParams hp{static_cast<const bf16*>(bias_h), kv_len, lse,
                          delta, static_cast<bf16*>(dkv), S, H, kh, kw,
                          scale * vdr::kLog2e, scale};
    return launch_hopper(q, kv, bias_w, dout, hp, B, st);
  }
  vdr::AttnParams p{q, kv, bias_h, bias_w, kv_len, nullptr, B, S,
                    H, S,  kh,     kw,     scale * vdr::kLog2e};
  vdr::GradParams gp{static_cast<const bf16*>(dout), nullptr, lse, delta,
                     nullptr, static_cast<bf16*>(dkv), nullptr, nullptr,
                     scale};
  const size_t smem = smem_bytes(kw, has_bias);
  cudaFuncSetAttribute(dkv_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((S + BK - 1) / BK, H, B);
  dkv_kernel<<<grid, BK * 2, smem, st>>>(p, gp);
  return (int)cudaGetLastError();
}

}  // extern "C"
