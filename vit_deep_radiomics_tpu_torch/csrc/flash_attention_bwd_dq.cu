// K6 backward, dq: query gradient and both decomposed-bias gradients of
// trainable flash attention over per-head fp32 (B, H, S, D).
//
// Replaces: vit_deep_radiomics_tpu/ops/attention_grad.py::_bwd_dq_kernel
// (flash_attention_trainable's backward, a Pallas TPU kernel).
//
// A block owns 64 query rows of one (batch, head), two lanes a row, each
// lane holding half of the row's pre-scaled q, of dO and of the dq
// accumulator, and loops over the keys in 64-key tiles. Per key it rebuilds
// the forward's score (flash_trainable_core.cuh), P = exp2(s - lse) from
// the forward's residual, dP = dO v^T and dS = P (dP - D) with D = sum_d
// dO O per row; then
//     dq += dS k                     (natural units; times D^-1/2 at the end)
//     dbias_h[i, j / kw] += dS       (lane 0 of the pair)
//     dbias_w[i, j % kw] += dS       (lane 1 of the pair)
// The bias sums sit in shared memory, [term][row], each owned by one lane
// and summed over the keys in order, so any key-grid width works (SAM's
// 14-wide windows cut across every key tile) without atomics.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 on the CUDA
// cores): 6 S^2 D FLOP per (batch, head) (q k^T, dO v^T, dS k) against
// about 7 S D words. At the `parity` path's shapes that is operations:
// SAM's global layers (2 x 12 x 4096 tokens) 155 GFLOP, 2.31 ms; SAM's
// windowed layers (50 x 12 x 196 tokens) 8.9 GFLOP, 0.13 ms, against
// 0.053 ms of traffic; DINOv2 ViT-B/14 (2 x 12 x 1536 tokens, 1370 valid
// keys) 46 GFLOP.
//
// What the design does about it: the score, P and dS stay in registers;
// K/V tiles are shared-memory broadcasts read as 16-byte vectors; four
// keys' dot-product chains run side by side. fp32 on the CUDA cores.

#include "flash_trainable_core.cuh"

namespace {
using namespace vdr::k6;

constexpr int G = 4;   // keys whose chains run side by side

size_t smem_bytes(int kh, int kw) {
  return (size_t)(2 * TILE * LDS + 2 * (kh + kw) * BS) * sizeof(float);
}

__global__ void __launch_bounds__(THREADS) dq_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // [TILE][LDS]
  float* vs = ks + TILE * LDS;               // [TILE][LDS]
  float* bias_s = vs + TILE * LDS;           // [kh + kw][BS]
  float* dbias_s = bias_s + (p.kh + p.kw) * BS;  // [kh + kw][BS]

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * ROWS;
  const int lr = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int r = row0 + lr;
  const bool valid = r < p.S;
  const size_t bh = (size_t)b * p.H + h;
  const size_t base = bh * p.S * D;
  const int n_keys = valid_keys(p, b);
  const bool has_bias = p.bias_h != nullptr;
  if (has_bias) {
    stage_bias_rows(p, bh, row0, bias_s);
    for (int i = threadIdx.x; i < (p.kh + p.kw) * BS; i += blockDim.x)
      dbias_s[i] = 0.f;
  }

  float q[HD], dout[HD], dq[HD];
  const size_t roff = base + (size_t)r * D + half * HD;
  load_half<true>(q, p.q + roff, valid, p.scale_log2);
  load_half<false>(dout, p.dout + roff, valid, 1.f);
#pragma unroll
  for (int d = 0; d < HD; ++d) dq[d] = 0.f;
  const float lse = valid ? p.lse[bh * p.S + r] : 0.f;
  const float dl = valid ? p.delta[bh * p.S + r] : 0.f;
  const int hc = half_col(half);

  for (int k0 = 0; k0 < n_keys; k0 += TILE) {
    const int nk = min(TILE, n_keys - k0);
    __syncthreads();
    load_rows<false>(ks, p.k + base + (size_t)k0 * D, nk, TILE, 1.f);
    load_rows<false>(vs, p.v + base + (size_t)k0 * D, nk, TILE, 1.f);
    __syncthreads();
    for (int j0 = 0; j0 < nk; j0 += G) {
      float s[G], dp[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s[g] = half_dot(q, ks + (j0 + g) * LDS + hc);
        dp[g] = half_dot(dout, vs + (j0 + g) * LDS + hc);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s[g] = join(s[g]);
        dp[g] = join(dp[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = j0 + g, key = k0 + j;
        float ds = 0.f;
        if (j < nk && valid) {
          float sv = s[g];
          int kr = 0, kc = 0;
          if (has_bias) {
            kr = key / p.kw;
            kc = key - kr * p.kw;
            sv = with_bias(sv, bias_s[kr * BS + lr],
                           bias_s[(p.kh + kc) * BS + lr]);
          }
          ds = exp2f(sv - lse) * (dp[g] - dl);
          if (has_bias) {
            if (half == 0)
              dbias_s[kr * BS + lr] += ds;
            else
              dbias_s[(p.kh + kc) * BS + lr] += ds;
          }
        }
        half_axpy(dq, ds, ks + j * LDS + hc);
      }
    }
  }
  if (valid) store_half(p.dq + roff, dq, p.scale);
  if (!has_bias) return;
  __syncthreads();
  const int nrows = min(ROWS, p.S - row0);
  const size_t brow = bh * p.S + row0;
  for (int i = threadIdx.x; i < nrows * p.kh; i += blockDim.x)
    p.dbh[brow * p.kh + i] = dbias_s[(i % p.kh) * BS + i / p.kh];
  for (int i = threadIdx.x; i < nrows * p.kw; i += blockDim.x)
    p.dbw[brow * p.kw + i] = dbias_s[(p.kh + i % p.kw) * BS + i / p.kw];
}

}  // namespace

extern "C" {

const char* vdr_error_string(int err) { return vdr::k6::error_string(err); }

// fp32 only. Returns 0 on success, a cudaError_t after a failed attribute
// call or launch, or -1 for a head dim other than 64.
int vdr_flash_attention_bwd_dq(const float* q, const float* k,
                               const float* v, const float* bias_h,
                               const float* bias_w, const int* kv_len,
                               const float* dout, const float* lse,
                               const float* delta, float* dq, float* dbh,
                               float* dbw, int B, int H, int S, int D, int kh,
                               int kw, float scale, void* stream) {
  if (D != vdr::k6::D) return -1;
  vdr::k6::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias_h = bias_h;
  p.bias_w = bias_w;
  p.kv_len = kv_len;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dbh = dbh;
  p.dbw = dbw;
  p.B = B;
  p.H = H;
  p.S = S;
  p.kh = bias_h != nullptr ? kh : 0;
  p.kw = bias_h != nullptr ? kw : 1;
  p.scale = scale;
  p.scale_log2 = scale * vdr::k6::kLog2e;
  return vdr::k6::launch(dq_kernel, p, smem_bytes(p.kh, bias_h ? kw : 0),
                         stream);
}

}  // extern "C"
