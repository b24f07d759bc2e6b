// K6 backward, dkv: key and value gradients of trainable flash attention
// over per-head fp32 (B, H, S, D).
//
// Replaces: vit_deep_radiomics_tpu/ops/attention_grad.py::_bwd_dkv_kernel
// (flash_attention_trainable's backward, a Pallas TPU kernel).
//
// A block owns 64 keys of one (batch, head), two lanes a key, each lane
// holding half of the key's k and v rows and of its dk and dv
// accumulators, and loops over the queries in 64-row tiles. A tile stages
// the queries' pre-scaled q (for the score), q (for dk), dO, lse, D and
// bias terms in shared memory once for the block. Per query it rebuilds
// the forward's score (flash_trainable_core.cuh), P = exp2(s - lse),
// dP = dO v^T, dS = P (dP - D); then
//     dv += P dO        dk += dS q     (dk times D^-1/2 at the end)
// Keys at or past kv_len get P = 0, so their dk and dv are zero.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 on the CUDA
// cores): 8 S^2 D FLOP per (batch, head) (q k^T, dO v^T, P^T dO, dS^T q)
// against about 7 S D words. At the `parity` path's shapes that is
// operations: SAM's global layers (2 x 12 x 4096 tokens) 206 GFLOP,
// 3.08 ms; SAM's windowed layers (50 x 12 x 196 tokens) 11.8 GFLOP,
// 0.18 ms, against 0.053 ms of traffic; DINOv2 ViT-B/14 (2 x 12 x 1536
// tokens, 1370 valid keys) 62 GFLOP.
//
// What the design does about it: the score, P and dS stay in registers;
// the query tile is read from shared memory as broadcasts, 16-byte vectors;
// four queries' dot-product chains run side by side; the bias terms of a
// query are staged [query][term], so the lanes of a warp (16 keys) read
// distinct banks. fp32 on the CUDA cores.

#include "flash_trainable_core.cuh"

namespace {
using namespace vdr::k6;

constexpr int G = 4;   // queries whose chains run side by side

size_t smem_bytes(int kh, int kw) {
  return (size_t)(3 * TILE * LDS + 2 * TILE + TILE * (kh + kw)) *
         sizeof(float);
}

__global__ void __launch_bounds__(THREADS) dkv_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* qs_s = smem;                     // [TILE][LDS] pre-scaled q
  float* q_s = qs_s + TILE * LDS;         // [TILE][LDS] q
  float* do_s = q_s + TILE * LDS;         // [TILE][LDS] dO
  float* lse_s = do_s + TILE * LDS;       // [TILE]
  float* dl_s = lse_s + TILE;             // [TILE]
  float* bias_s = dl_s + TILE;            // [TILE][kh + kw]

  const int b = blockIdx.z, h = blockIdx.y;
  const int key = blockIdx.x * ROWS + (threadIdx.x >> 1);
  const int half = threadIdx.x & 1;
  const bool in_range = key < p.S;
  const bool live = key < valid_keys(p, b);
  const size_t bh = (size_t)b * p.H + h;
  const size_t base = bh * p.S * D;
  const bool has_bias = p.bias_h != nullptr;
  const int bt = p.kh + p.kw;             // bias terms per staged query
  const int th = has_bias ? key / p.kw : 0;
  const int tw = has_bias ? p.kh + key % p.kw : 0;

  float kk[HD], vv[HD], dk[HD], dv[HD];
  const size_t koff = base + (size_t)key * D + half * HD;
  load_half<false>(kk, p.k + koff, in_range, 1.f);
  load_half<false>(vv, p.v + koff, in_range, 1.f);
#pragma unroll
  for (int d = 0; d < HD; ++d) dk[d] = dv[d] = 0.f;
  const int hc = half_col(half);

  for (int q0 = 0; q0 < p.S; q0 += TILE) {
    const int nq = min(TILE, p.S - q0);
    __syncthreads();
    load_rows<true>(qs_s, p.q + base + (size_t)q0 * D, nq, TILE,
                    p.scale_log2);
    load_rows<false>(q_s, p.q + base + (size_t)q0 * D, nq, TILE, 1.f);
    load_rows<false>(do_s, p.dout + base + (size_t)q0 * D, nq, TILE, 1.f);
    for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
      lse_s[i] = i < nq ? p.lse[bh * p.S + q0 + i] : 0.f;
      dl_s[i] = i < nq ? p.delta[bh * p.S + q0 + i] : 0.f;
    }
    if (has_bias) {
      const float* bhp = p.bias_h + (bh * p.S + q0) * p.kh;
      const float* bwp = p.bias_w + (bh * p.S + q0) * p.kw;
      for (int i = threadIdx.x; i < TILE * p.kh; i += blockDim.x) {
        const int r = i / p.kh, t = i % p.kh;
        bias_s[r * bt + t] = r < nq ? bias_log2(bhp[i]) : 0.f;
      }
      for (int i = threadIdx.x; i < TILE * p.kw; i += blockDim.x) {
        const int r = i / p.kw, t = i % p.kw;
        bias_s[r * bt + p.kh + t] = r < nq ? bias_log2(bwp[i]) : 0.f;
      }
    }
    __syncthreads();
    for (int i0 = 0; i0 < nq; i0 += G) {
      float s[G], dp[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s[g] = half_dot(kk, qs_s + (i0 + g) * LDS + hc);
        dp[g] = half_dot(vv, do_s + (i0 + g) * LDS + hc);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s[g] = join(s[g]);
        dp[g] = join(dp[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int i = i0 + g;
        float pv = 0.f;
        if (i < nq && live) {
          float sv = s[g];
          if (has_bias)
            sv = with_bias(sv, bias_s[i * bt + th], bias_s[i * bt + tw]);
          pv = exp2f(sv - lse_s[i]);
        }
        const float ds = pv * (dp[g] - dl_s[i]);
        half_axpy(dv, pv, do_s + i * LDS + hc);
        half_axpy(dk, ds, q_s + i * LDS + hc);
      }
    }
  }
  if (!in_range) return;
  store_half(p.dk + koff, dk, p.scale);
  store_half(p.dv + koff, dv, 1.f);
}

}  // namespace

extern "C" {

const char* vdr_error_string(int err) { return vdr::k6::error_string(err); }

// fp32 only. Returns 0 on success, a cudaError_t after a failed attribute
// call or launch, or -1 for a head dim other than 64.
int vdr_flash_attention_bwd_dkv(const float* q, const float* k,
                                const float* v, const float* bias_h,
                                const float* bias_w, const int* kv_len,
                                const float* dout, const float* lse,
                                const float* delta, float* dk, float* dv,
                                int B, int H, int S, int D, int kh, int kw,
                                float scale, void* stream) {
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
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.H = H;
  p.S = S;
  p.kh = bias_h != nullptr ? kh : 0;
  p.kw = bias_h != nullptr ? kw : 1;
  p.scale = scale;
  p.scale_log2 = scale * vdr::k6::kLog2e;
  return vdr::k6::launch(dkv_kernel, p, smem_bytes(p.kh, bias_h ? kw : 0),
                         stream);
}

}  // extern "C"
