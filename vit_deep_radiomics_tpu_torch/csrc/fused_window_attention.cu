// K1: fused window attention for SAM's windowed layers.
//
// Replaces: vit_deep_radiomics_tpu/ops/attention.py::_fused_window_kernel
// (window mode of flash_attention_fused_qkv, the Pallas TPU kernel).
//
// Computes, for each window and head,
//     softmax(q k^T D^-1/2 + bias_h[q, j / kw] + bias_w[q, j % kw]) v
// with q (B, S, H*D), kv (B, S, 2*H*D), per-head bias (B, H, S, kh) and
// (B, H, S, kw), output (B, S, H*D); the token axis is a concatenation of
// windows of `window_tokens` tokens (196 = 14x14 for SAM ViT-B/16).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the
// extraction path's shapes (100 windows x 196 tokens x 12 heads of 64) the
// call does 11.8 GFLOP (0.012 ms at the bf16 peak) and must move about
// 134 MB (q, kv, both bias arrays and the output once: 0.040 ms), so it is
// memory-bound: what counts is keeping whole-line copies in flight while
// the SM computes, and reading each byte once.
//
// What the design does about it (bf16, windows of at most 256 tokens): the
// whole-window body of window_hopper.cuh, which K3's window mode shares.
// One (window, head) is one work item, done whole by a persistent block
// (one an SM: two items in shared memory): a producer thread brings the
// next item's Q, K and V by TMA (boxes of 64 columns x exactly
// `window_tokens` rows) and its bias rows by bulk copy while two consumer
// warpgroups score all of the window's keys with one wgmma of N = the
// window padded to 64/208/256 keys, add the decomposed bias as one more
// wgmma against a constant expand matrix E (as JAX's kernel expands its
// bias with one-hot matrices; its mask term on the keys past the window),
// run a one-pass softmax with the max kept, O += P V with P in registers,
// and store the normalised output by TMA.
// The fp32 (`parity`) path takes the register-tiled CUDA-core forward of
// f32_tiled_forward.cuh, one (window, head) a problem (k1_problem): 64
// query rows a block (196 = 3 x 64 + 4), 32-key K/V tiles by cp.async
// into two buffers (7 tiles, 28 slots of the last absent), 4 x 4 score
// and 4 x 8 output micro-tiles a thread, fp32 FMAs only (67 TFLOP/s
// bounds it: 11.8 GFLOP, 0.176 ms at the extraction path's shape; the
// fourth, 4-row block of a window costs about a fifth of the time, PERF.md).
// bf16 windows of more than 256 tokens, bias grids of more than
// 47 terms (Kh + Kw; every square window of at most 256 tokens has at most
// 32) and scales whose inverse is not a power of two keep the first
// mma.sync loop of flash_attention_core.cuh (112-key tiles, an online
// softmax). The C entry chooses by dtype and shape alone, and
// vdr_fused_window_route reports the choice.

#include <math.h>

#include "f32_tiled_forward.cuh"
#include "flash_attention_core.cuh"
#include "hopper.cuh"
#include "window_hopper.cuh"

namespace {
using namespace vdr::sm90;
using bf16 = __nv_bfloat16;

// the first loop: 196 = 112 + 84, two query tiles and two key tiles per
// window
constexpr int kBlockK = 112;
constexpr int kRowsBf16 = 112;
// the tiled fp32 body: keys a K/V tile (32: a 4 x 4 score micro-tile a
// thread; 64: 4 x 8), tile buffers (2: the next tile loads during this
// one) and P in the tile's K buffer (1). Two buffers ran 3-5% faster than
// one at SAM's windows on an H100 (PERF.md), as for the K6 forward's
// windowed calls; K2 and K3 take one
constexpr int kF32Cols = 32;
constexpr int kF32Stages = 2;
constexpr int kF32PInK = 1;

// ---------------------------------------------------------------------------
// Hopper kernel: persistent blocks, a TMA producer, wgmma consumers
// (window_hopper.cuh, token-major)
// ---------------------------------------------------------------------------

constexpr int kErrTensorMap = -2;       // cuTensorMapEncodeTiled failed

template <int N>
__global__ void __launch_bounds__(win::kThreads, 1)
    k1_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tkv,
                     const __grid_constant__ CUtensorMap tout,
                     const win::WinParams p) {
  win::window_body<N, false>(&tq, &tkv, &tkv, &tout, p);
}

// Whether the Hopper kernel takes the call (window_hopper.cuh's plan with
// every key of the window loaded), its parameters, window width and shared
// memory.
bool hopper_plan(int B, int S, int H, int D, int window, int kh, int kw,
                 bool biased, float scale, int dtype, win::WinParams* wp,
                 int* n, size_t* smem) {
  *n = win::hopper_width(window);
  return win::hopper_plan(B, S, H, D, window, window, *n, kh, kw, biased,
                          scale, dtype, wp, smem);
}

// ---------------------------------------------------------------------------
// fp32: the register-tiled CUDA-core forward (f32_tiled_forward.cuh)
// ---------------------------------------------------------------------------

// blockIdx: x the window's 64-row block, y window * H + head, z the batch
// row.
template <bool kBias>
__global__ void __launch_bounds__(vdr::tiled::NT, 2)
    k1_tiled_kernel(const vdr::AttnParams p) {
  extern __shared__ __align__(16) float smem_tiled[];
  const vdr::tiled::Problem pr = vdr::tiled::k1_problem(
      static_cast<const float*>(p.q), static_cast<const float*>(p.kv),
      static_cast<const float*>(p.bias_h),
      static_cast<const float*>(p.bias_w), static_cast<float*>(p.out), p.S,
      p.H, p.seg, p.kh, p.kw, p.scale_log2, blockIdx.z, blockIdx.y / p.H,
      blockIdx.y % p.H);
  vdr::tiled::forward<kF32Cols, kF32Stages, kF32PInK != 0, kBias>(
      pr, blockIdx.x * vdr::tiled::ROWS, smem_tiled);
}

template <bool kBias>
int launch_tiled(const vdr::AttnParams& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) *
      vdr::tiled::smem_floats<kF32Cols, kF32Stages, kF32PInK != 0>(
          kBias ? p.kh : 0, kBias ? p.kw : 0);
  auto kern = k1_tiled_kernel<kBias>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.seg + vdr::tiled::ROWS - 1) / vdr::tiled::ROWS,
            (p.S / p.seg) * p.H, p.B);
  kern<<<grid, vdr::tiled::NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vdr_error_string(int err) {
  if (err == kErrTensorMap) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The body a call with these arguments runs: 0 the first loop of
// flash_attention_core.cuh, 1 the Hopper kernel, 2 the register-tiled fp32
// forward.
int vdr_fused_window_route(int S, int H, int D, int window_tokens, int kh,
                           int kw, int biased, float scale, int dtype) {
  if (dtype == 0) return 2;
  win::WinParams p;
  int n = 0;
  size_t smem = 0;
  return hopper_plan(1, S, H, D, window_tokens, kh, kw, biased != 0, scale,
                     dtype, &p, &n, &smem)
             ? 1
             : 0;
}

// Returns 0 on success, a cudaError_t after a failed launch, -1 for a head
// dim other than 64, the only one built (every config has D = 64), or -2
// when a TMA descriptor cannot be made.
int vdr_fused_window_attention(const void* q, const void* kv,
                               const void* bias_h, const void* bias_w,
                               void* out, int B, int S, int H, int D,
                               int window_tokens, int kh, int kw, float scale,
                               int dtype, void* stream) {
  if (D != win::kD) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const vdr::AttnParams a{q,  kv, bias_h, bias_w, nullptr, out, B,  S,
                          H,  window_tokens, kh, kw, scale * vdr::kLog2e};
  if (dtype == 0)
    return bias_h != nullptr ? launch_tiled<true>(a, st)
                             : launch_tiled<false>(a, st);
  win::WinParams p;
  int n = 0;
  size_t smem = 0;
  if (!hopper_plan(B, S, H, D, window_tokens, kh, kw, bias_h != nullptr,
                   scale, dtype, &p, &n, &smem))
    return vdr::launch_bf16<64, kRowsBf16, kBlockK, false>(a, st);
  p.bias_h = static_cast<const bf16*>(bias_h);
  p.bias_w = static_cast<const bf16*>(bias_w);
  CUtensorMap tq, tkv, tout;
  if (!win::tensor_map_2d(&tq, q, H * D, B * S, window_tokens) ||
      !win::tensor_map_2d(&tkv, kv, 2 * H * D, B * S, window_tokens) ||
      !win::tensor_map_2d(&tout, out, H * D, B * S, window_tokens))
    return kErrTensorMap;
  switch (n) {
    case 64:
      return win::launch(k1_hopper_kernel<64>, p.n_items, smem, st, tq, tkv,
                         tout, p);
    case 208:
      return win::launch(k1_hopper_kernel<208>, p.n_items, smem, st, tq, tkv,
                         tout, p);
    default:
      return win::launch(k1_hopper_kernel<256>, p.n_items, smem, st, tq, tkv,
                         tout, p);
  }
}

}  // extern "C"
