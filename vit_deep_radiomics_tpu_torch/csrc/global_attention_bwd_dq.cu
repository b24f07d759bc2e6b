// K5 backward, dq: query gradient and both decomposed-bias gradients of
// trainable global attention.
//
// Replaces: vit_deep_radiomics_tpu/ops/attention_grad.py::_fgt_dq_kernel
// (global_attention_trainable's backward, a Pallas TPU kernel).
//
// FlashAttention-2 style: a block owns 64 query rows of one (batch, head)
// and loops over the keys in 64-key tiles. Each score tile is recomputed
// exactly as the forward computed it (csrc/global_attention_fwd_lse.cu),
// P = exp2(s - lse) from the forward's residual, dP = dO V^T,
// dS = P * (dP - D) with D = sum_d dO * O precomputed per row; then
//     dq += dS K                     (tensor cores, dS rounded to bf16)
//     dbias_h[i, key row]  += sum of dS over the tile's n8 key groups
//     dbias_w[i, key col]  += dS, kept per key position in registers
// and dq is scaled by D^-1/2 and stored once. The bias gradients need a
// key-grid width kw in {8, 16, 32, 64}: an 8-key mma tile then lies in one
// grid row and a 64-key tile holds whole rows, so every key keeps its grid
// column across tiles.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the
// fine-tuning path's shapes (2 x 4096 tokens x 12 heads of 64) it does
// 6 S^2 D H B = 155 GFLOP (QK^T, dO V^T, dS K; 0.156 ms at the bf16 peak)
// against about 101 MB of compulsory traffic (0.030 ms): compute-bound.
//
// What the design does about it: the (S, S) score, probability and dS
// tiles never leave registers; all three products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate), dS goes from the score
// fragments straight into the dS K operand, and the bias gradients are
// reduced with warp shuffles and per-thread registers, not atomics.

#include "attention_bwd_core.cuh"

namespace {
using vdr::bf16;
constexpr int D = 64;
constexpr int BQ = 64;   // query rows per block (4 warps x 16)
constexpr int BK = 64;   // keys per tile
constexpr int LD = D + 8;
constexpr int NT = BK / 8;
constexpr int BS = vdr::bias_stride<BQ>();

size_t smem_bytes(int kh, int kw, bool has_bias) {
  size_t n = 2 * BK * LD * sizeof(bf16) + BK * sizeof(int2);
  if (has_bias)
    n += ((size_t)(kh + kw) * BS + (size_t)BQ * kh + BQ * BK) * sizeof(float);
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
  float* dbw_s = dbh_s + BQ * p.kh;                      // [BQ][BK]

  const Tile t = tile_of(p, BQ);
  const int C = p.H * D;
  const bool has_bias = p.bias_h != nullptr;
  const bool add_bias = has_bias && !t.none;
  if (has_bias) {
    stage_bias<bf16, BQ>(p, t, bias_s);
    for (int i = threadIdx.x; i < BQ * p.kh; i += blockDim.x) dbh_s[i] = 0.f;
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
  }
  if (warp_live)
    store_c64(gp.dq + rowbase, C, dq, r_lo, r_hi, p.seg, c, gp.scale);
  if (!has_bias) return;

  // dbias_w: key position j of a tile has grid column j % kw in every
  // tile (64 % kw == 0); fold the per-position sums through shared memory
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lr = e < 2 ? lrow_lo : lrow_hi;
      dbw_s[lr * BK + nt * 8 + 2 * c + (e & 1)] = dbw_acc[nt][e];
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
    for (int j = col; j < BK; j += p.kw) sum += dbw_s[r * BK + j];
    gp.dbw[brow * p.kw + i] = __float2bfloat16(sum);
  }
}

}  // namespace

extern "C" {

const char* vdr_error_string(int err) { return vdr::error_string(err); }

// bf16 only. Returns 0 on success, a cudaError_t after a failed launch, -1
// for a head dim other than 64, -2 for a bias with kw not in {8,16,32,64}.
int vdr_global_attention_bwd_dq(const void* q, const void* kv,
                                const void* bias_h, const void* bias_w,
                                const int* kv_len, const void* dout,
                                const float* lse, const float* delta,
                                void* dq, void* dbh, void* dbw, int B, int S,
                                int H, int D, int kh, int kw, float scale,
                                void* stream) {
  if (D != 64) return -1;
  const bool has_bias = bias_h != nullptr;
  if (has_bias && (kw % 8 != 0 || BK % kw != 0)) return -2;
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
  dq_kernel<<<grid, BQ * 2, smem, static_cast<cudaStream_t>(stream)>>>(p, gp);
  return (int)cudaGetLastError();
}

}  // extern "C"
