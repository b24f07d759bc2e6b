// K5 backward, dkv: key and value gradients of trainable global attention.
//
// Replaces: vit_deep_radiomics_tpu/ops/attention_grad.py::_fgt_dkv_kernel
// (global_attention_trainable's backward, a Pallas TPU kernel).
//
// FlashAttention-2 style: a block owns 64 keys of one (batch, head), each
// warp 16 of them with their K and V rows held as mma A fragments, and
// loops over the queries in 64-row tiles. Per tile it recomputes the
// transposed scores S^T = K (q D^-1/2 log2 e)^T plus the bias, as the
// forward computed them, P^T = exp2(S^T - lse), dP^T = V dO^T and
// dS^T = P^T * (dP^T - D); then
//     dv += P^T dO      dk += dS^T Q
// on the tensor cores, with P and dS rounded to bf16. dk is scaled by
// D^-1/2 at the end, and dk, dv are written into dkv (B, S, 2*H*D) in the
// projection layout (k columns [0, H*D), v columns [H*D, 2*H*D)).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the
// fine-tuning path's shapes (2 x 4096 tokens x 12 heads of 64) it does
// 8 S^2 D H B = 206 GFLOP (QK^T, V dO^T, P^T dO, dS^T Q; 0.208 ms at the
// bf16 peak) against about 101 MB of compulsory traffic (0.030 ms):
// compute-bound.
//
// What the design does about it: the score tiles never leave registers,
// all four products run on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulate), P^T and dS^T go from the score fragments straight into
// the next products' A operands, and the query tile (q, dO, lse, D and the
// tile's bias terms) is staged once in shared memory for all 4 warps.

#include "attention_bwd_core.cuh"

namespace {
using vdr::bf16;
constexpr int D = 64;
constexpr int BK = 64;   // keys per block (4 warps x 16)
constexpr int BQ = 64;   // queries per tile
constexpr int LD = D + 8;
constexpr int BS = BQ + 4;   // row stride of the staged bias terms

size_t smem_bytes(int kw, bool has_bias) {
  size_t n = 2 * BQ * LD * sizeof(bf16) + 2 * BQ * sizeof(float);
  if (has_bias) n += (size_t)(BK / kw + kw) * BS * sizeof(float);
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
  const int nkr = has_bias ? BK / p.kw : 0;   // grid rows of the key block
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

}  // namespace

extern "C" {

const char* vdr_error_string(int err) { return vdr::error_string(err); }

// bf16 only. Returns 0 on success, a cudaError_t after a failed launch, -1
// for a head dim other than 64, -2 for a bias with kw not in {8,16,32,64}.
int vdr_global_attention_bwd_dkv(const void* q, const void* kv,
                                 const void* bias_h, const void* bias_w,
                                 const int* kv_len, const void* dout,
                                 const float* lse, const float* delta,
                                 void* dkv, int B, int S, int H, int D,
                                 int kh, int kw, float scale, void* stream) {
  if (D != 64) return -1;
  const bool has_bias = bias_h != nullptr;
  if (has_bias && (kw % 8 != 0 || BK % kw != 0)) return -2;
  vdr::AttnParams p{q, kv, bias_h, bias_w, kv_len, nullptr, B, S,
                    H, S,  kh,     kw,     scale * vdr::kLog2e};
  vdr::GradParams gp{static_cast<const bf16*>(dout), nullptr, lse, delta,
                     nullptr, static_cast<bf16*>(dkv), nullptr, nullptr,
                     scale};
  const size_t smem = smem_bytes(kw, has_bias);
  cudaFuncSetAttribute(dkv_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((S + BK - 1) / BK, H, B);
  dkv_kernel<<<grid, BK * 2, smem, static_cast<cudaStream_t>(stream)>>>(p,
                                                                        gp);
  return (int)cudaGetLastError();
}

}  // extern "C"
