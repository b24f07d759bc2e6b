// K6 forward: trainable flash attention over per-head fp32 (B, H, S, D)
// with the log2 log-sum-exp residual for the backward.
//
// Replaces: vit_deep_radiomics_tpu/ops/attention_grad.py::_fwd_kernel
// (flash_attention_trainable's forward, a Pallas TPU kernel).
//
// A block owns 64 query rows of one (batch, head), two lanes a row, each
// lane holding half of the row's pre-scaled q and of its fp32 accumulator,
// and loops over the keys in 64-key tiles staged in shared memory, with an
// online softmax in log2 units (running max, running sum). It writes
// out = sum_j P_ij v_j and lse_i = m_i + log2(l_i). The score is the one
// of flash_trainable_core.cuh, which both backward kernels rebuild.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 on the CUDA
// cores): 4 S^2 D FLOP per (batch, head) against 5 S D words. At the
// `parity` path's shapes that is operations in every case: SAM's global
// layers (2 x 12 x 4096 tokens) 103 GFLOP, 1.54 ms, against 0.05 ms of
// traffic; SAM's windowed layers (50 x 12 x 196 tokens, bias 14 x 14)
// 5.9 GFLOP, 0.088 ms, against 0.040 ms; DINOv2 ViT-B/14 (2 x 12 x 1536
// tokens, 1370 valid keys) 31 GFLOP, 0.46 ms.
//
// What the design does about it: the (S, S) scores never leave registers;
// K/V tiles are read from shared memory as broadcasts, 16-byte vectors, so
// each FMA needs a quarter of a shared load; 16 keys' score chains run
// side by side for instruction-level parallelism. fp32 stays on the CUDA
// cores (TF32 would round it). Faster versions (a cp.async ring, larger
// tiles) are later work.

#include "flash_trainable_core.cuh"

namespace {
using namespace vdr::k6;

constexpr int CH = 16;   // keys per online-softmax step

size_t smem_bytes(int kh, int kw) {
  return (size_t)(2 * TILE * LDS + (kh + kw) * BS) * sizeof(float);
}

__global__ void __launch_bounds__(THREADS) fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // [TILE][LDS]
  float* vs = ks + TILE * LDS;       // [TILE][LDS]
  float* bias_s = vs + TILE * LDS;   // [kh + kw][BS]

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * ROWS;
  const int lr = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int r = row0 + lr;
  const bool valid = r < p.S;
  const size_t bh = (size_t)b * p.H + h;
  const size_t base = bh * p.S * D;
  // A kv_len 0 row: every key scores -1e30 (the plain version, JAX), so P
  // is 1 on all S keys. Visit them with q = 0 and no bias (every score 0,
  // the same P) and write the plain lse, -1e30 + log2(S).
  const int n_keys = valid_keys(p, b);
  const bool none = n_keys == 0;
  const int lim = none ? p.S : n_keys;
  const bool has_bias = p.bias_h != nullptr && !none;
  if (has_bias) stage_bias_rows(p, bh, row0, bias_s);

  float q[HD], acc[HD];
  load_half<true>(q, p.q + base + (size_t)r * D + half * HD, valid && !none,
                  p.scale_log2);
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;
  const int hc = half_col(half);

  for (int k0 = 0; k0 < lim; k0 += TILE) {
    const int nk = min(TILE, lim - k0);
    __syncthreads();
    load_rows(ks, p.k + base + (size_t)k0 * D, nk, TILE);
    load_rows(vs, p.v + base + (size_t)k0 * D, nk, TILE);
    __syncthreads();
    for (int c0 = 0; c0 < nk; c0 += CH) {
      float s[CH];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = c0 + jj;
        float v = join(half_dot(q, ks + j * LDS + hc));
        if (j < nk) {
          if (has_bias) {
            const int key = k0 + j, kr = key / p.kw;
            v = with_bias(v, bias_s[kr * BS + lr],
                          bias_s[(p.kh + key - kr * p.kw) * BS + lr]);
          }
        } else {
          v = kNegInf;
        }
        s[jj] = v;
        mx = fmaxf(mx, v);
      }
      const float alpha = exp2f(m - mx);
      m = mx;
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        if (c0 + jj < nk) {
          const float pj = exp2f(s[jj] - m);
          l += pj;
          half_axpy(acc, pj, vs + (c0 + jj) * LDS + hc);
        }
      }
    }
  }
  if (!valid) return;
  const float safe_l = l > 0.f ? l : 1.f;
  store_half(p.out + base + (size_t)r * D + half * HD, acc, 1.f / safe_l);
  if (half == 0)
    p.lse_out[bh * p.S + r] = (none ? kNegInf : m) + log2f(safe_l);
}

}  // namespace

extern "C" {

const char* vdr_error_string(int err) { return vdr::k6::error_string(err); }

// fp32 only. Returns 0 on success, a cudaError_t after a failed attribute
// call or launch, or -1 for a head dim other than 64.
int vdr_flash_attention_fwd(const float* q, const float* k, const float* v,
                            const float* bias_h, const float* bias_w,
                            const int* kv_len, float* out, float* lse, int B,
                            int H, int S, int D, int kh, int kw, float scale,
                            void* stream) {
  if (D != vdr::k6::D) return -1;
  vdr::k6::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias_h = bias_h;
  p.bias_w = bias_w;
  p.kv_len = kv_len;
  p.out = out;
  p.lse_out = lse;
  p.B = B;
  p.H = H;
  p.S = S;
  p.kh = bias_h != nullptr ? kh : 0;
  p.kw = bias_h != nullptr ? kw : 1;
  p.scale = scale;
  p.scale_log2 = scale * vdr::k6::kLog2e;
  return vdr::k6::launch(fwd_kernel, p, smem_bytes(p.kh, bias_h ? kw : 0),
                         stream);
}

}  // extern "C"
