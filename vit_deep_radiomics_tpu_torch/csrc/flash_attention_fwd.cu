// K6 forward: trainable flash attention over per-head fp32 (B, H, S, D)
// with the log2 log-sum-exp residual for the backward.
//
// Replaces: vit_deep_radiomics_tpu/ops/attention_grad.py::_fwd_kernel
// (flash_attention_trainable's forward, a Pallas TPU kernel).
//
// Writes out = sum_j P_ij v_j / sum_j P_ij and lse_i = m_i + log2(l_i) in
// log2 units, with an optional decomposed bias (bias_h (B, H, S, kh),
// bias_w (B, H, S, kw), kh * kw = S, any kw) or an optional kv_len (B,).
// The score is the one of flash_trainable_core.cuh, which both backward
// kernels rebuild bit for bit from this lse.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 on the CUDA
// cores; `parity` must not round to TF32): 4 S_k S D FLOP per (batch,
// head) on the S_k keys a row scores, against about 4 S D words. At the
// `parity` path's shapes that is operations in every case: SAM's global
// layers (2 x 12 x 4096 tokens) 103 GFLOP, 1.54 ms, against 0.05 ms of
// traffic; SAM's windowed layers (50 x 12 x 196 tokens, bias 14 x 14)
// 5.9 GFLOP, 0.088 ms, against 0.040 ms; DINOv2 ViT-B/14 (2 x 12 x 1536
// tokens, 1370 valid keys) 12.9 GFLOP, 0.193 ms. The first loop (two
// lanes a query row, each holding half of q and of the accumulator, every
// K and V element a shared-memory broadcast operand of one FMA, 64-key
// tiles with no asynchronous copy) ran at about 24% of that rate: the
// load/store pipe paced it.
//
// What the design does about it: the register-tiled CUDA-core body of K2's
// and K3's fp32 forwards (f32_tiled_forward.cuh), with K6's problem
// (k6_problem: head-major rows, K6's masks) and K6's score (the two FMA
// chains of bwd::score_tile joined by one __fadd_rn, the bias added as
// the backward adds it), the lse written by the lane that holds each
// row's max and joined sum, and each tile's P V summed on its own before
// it joins O (kF32TileSum: the backward's D = sum dO O needs an O without
// a bias along itself; f32_tiled_forward.cuh). A block of 128 threads owns
// 64 query rows; 32-key K/V tiles arrive by cp.async into one buffer, P is
// written over the tile's K (70 KB of shared memory at Kw 64: three blocks
// an SM); each thread scores a 4 x 4 micro-tile and accumulates a 4 x 8
// tile of O. No atomics: two runs give the same bits.

#include "f32_tiled_forward.cuh"
#include "flash_trainable_bf16.cuh"

namespace {

// the tiled fp32 body: keys a K/V tile (32: a 4 x 4 score micro-tile a
// thread; 64: 4 x 8), tile buffers (2: the next tile loads during this
// one) and P in the tile's K buffer (1), as K2 ships them; each tile's
// P V summed on its own (1)
constexpr int kF32Cols = 32;
constexpr int kF32Stages = 1;
constexpr int kF32PInK = 1;
constexpr int kF32TileSum = 1;

template <bool kBias>
__global__ void __launch_bounds__(vdr::tiled::NT, 2)
    k6_tiled_kernel(const vdr::k6::Params p) {
  extern __shared__ __align__(16) float smem_k6[];
  const vdr::tiled::Problem pr = vdr::tiled::k6_problem(
      p.q, p.k, p.v, p.bias_h, p.bias_w, p.kv_len, p.out, p.lse_out, p.H,
      p.S, p.kh, p.kw, p.scale_log2, blockIdx.z, blockIdx.y);
  vdr::tiled::forward<kF32Cols, kF32Stages, kF32PInK != 0, kBias, true,
                      kF32TileSum != 0>(pr, blockIdx.x * vdr::tiled::ROWS,
                                        smem_k6);
}

template <bool kBias>
int launch_tiled(const vdr::k6::Params& p, void* stream) {
  const size_t smem =
      sizeof(float) *
      vdr::tiled::smem_floats<kF32Cols, kF32Stages, kF32PInK != 0>(
          kBias ? p.kh : 0, kBias ? p.kw : 0);
  return vdr::k6::bwd::launch(k6_tiled_kernel<kBias>, p, smem, stream);
}

// bf16: the mma.sync body of flash_trainable_bf16.cuh
__global__ void __launch_bounds__(vdr::k6b::NT)
    k6_mma_fwd_kernel(const vdr::k6b::Params p) {
  extern __shared__ __align__(16) char smem_mma[];
  vdr::k6b::forward(p, blockIdx.z, blockIdx.y, blockIdx.x * vdr::k6b::ROWS,
                    smem_mma);
}

}  // namespace

extern "C" {

const char* vdr_error_string(int err) { return vdr::k6::error_string(err); }

// fp32. Returns 0 on success, a cudaError_t after a failed attribute call
// or launch, or -1 for a head dim other than 64.
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
  return bias_h != nullptr ? launch_tiled<true>(p, stream)
                           : launch_tiled<false>(p, stream);
}

// bf16 q, k, v and out; fp32 bias, lse. Returns 0 on success, a cudaError_t
// after a failed attribute call or launch, -1 for a head dim other than 64,
// or -2 for a bias grid of more than vdr::k6b::kMaxTerms terms.
int vdr_flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                 const float* bias_h, const float* bias_w,
                                 const int* kv_len, void* out, float* lse,
                                 int B, int H, int S, int D, int kh, int kw,
                                 float scale, void* stream) {
  using vdr::k6b::bf16;
  if (D != vdr::k6b::D) return -1;
  const bool bias = bias_h != nullptr;
  if (!vdr::k6b::takes(bias, kh, kw)) return vdr::k6b::kErrTerms;
  vdr::k6b::Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.bias_h = bias_h;
  p.bias_w = bias_w;
  p.kv_len = kv_len;
  p.out = static_cast<bf16*>(out);
  p.lse_out = lse;
  p.B = B;
  p.H = H;
  p.S = S;
  p.kh = bias ? kh : 0;
  p.kw = bias ? kw : 1;
  p.scale = scale;
  p.scale_log2 = vdr::k6b::scale_log2_bf16(scale);
  return vdr::k6b::launch(k6_mma_fwd_kernel, p,
                          vdr::k6b::fwd_smem(bias ? kh + kw : 0), stream);
}

// The body the K6 forward runs for a call (dtype 0 fp32, 1 bf16): 0 the
// register-tiled CUDA-core body (fp32), 1 the mma.sync body (bf16); -1 for
// a head dim other than 64, -2 for a bf16 bias grid of more than
// vdr::k6b::kMaxTerms terms. The backward's is
// vdr_flash_attention_bwd_route (flash_attention_bwd_dq.cu).
int vdr_flash_attention_route(int dtype, int D, int has_bias, int kh,
                              int kw) {
  if (D != vdr::k6::D) return -1;
  if (dtype == 0) return 0;
  return vdr::k6b::takes(has_bias != 0, kh, kw) ? 1 : vdr::k6b::kErrTerms;
}

}  // extern "C"
