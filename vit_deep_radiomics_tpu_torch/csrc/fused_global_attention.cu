// K2: fused global attention for SAM's global layers.
//
// Replaces: vit_deep_radiomics_tpu/ops/attention.py::_fused_global_kernel
// (global and nobias modes of flash_attention_fused_qkv, the Pallas TPU
// kernel).
//
// Computes online-softmax flash attention over all S keys of a batch row,
//     softmax(q k^T D^-1/2 + bias_h[q, j / Kw] + bias_w[q, j % Kw]) v
// with the decomposed bias optional (Kh * Kw == S) and an optional kv_len
// key-padding mask (keys j >= kv_len[b] are excluded). Layouts: q
// (B, S, H*D), kv (B, S, 2*H*D), per-head bias (B, H, S, Kh) and
// (B, H, S, Kw), output (B, S, H*D).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the
// extraction path's shapes (4 images x 4096 tokens x 12 heads of 64) the
// call does 206 GFLOP (0.208 ms at the bf16 peak) against about 151 MB of
// compulsory traffic (0.045 ms), so it is compute-bound. At D = 64 the
// exponentials weigh as much as the products: a 64-key tile of 64 rows
// costs 256 cycles of an SM's tensor cores for QK^T and PV together and
// 256 cycles of its 16 exp2 units, so the softmax has to run under other
// rows' products. Every 192-row block streams all of its head's K and V
// from L2, and the products read their B operand from shared memory.
//
// What the design does about it (bf16, the `fast` path): the Hopper body
// of global_fwd_hopper.cuh, shared with the K5 forward, without the lse:
// one TMA producer thread keeps 64-key K and V tiles in flight in a
// 6-stage ring on mbarriers; three consumer warpgroups of 64 query rows
// run wgmma (Q's A fragments in registers, P from the score registers),
// issue in turns on named barriers so one's softmax runs under the
// others' products, keep a lazily rescaled online softmax in log2 units
// and the bias_w columns in registers (Kw 64 or 128), and read bias_h from
// a table staged once per block; tiles past kv_len are never loaded.
// The fp32 (`parity`) path takes the register-tiled CUDA-core forward of
// f32_tiled_forward.cuh (64 query rows a block, K/V tiles by cp.async,
// 4 x 4 score and 4 x 8 output micro-tiles a thread; fp32 FMAs only, with
// any Kw, no bias, or kv_len). A biased bf16 call whose Kw is not 64 or 128
// (or whose bias table would not fit in shared memory) keeps the earlier
// mma.sync loop of flash_attention_core.cuh. The C entry chooses by dtype
// and shape alone; vdr_fused_global_route reports the choice.

#include "f32_tiled_forward.cuh"
#include "flash_attention_core.cuh"
#include "global_fwd_hopper.cuh"

namespace {
using namespace vdr::sm90;

constexpr int kBlockK = 64;
constexpr int kRowsBf16 = 128;
// the tiled fp32 body: keys a K/V tile (32: a 4 x 4 score micro-tile a
// thread; 64: 4 x 8), tile buffers (2: the next tile loads during this
// one) and P in the tile's K buffer (1). One buffer with P in K takes 70 KB
// of shared memory at Kw 64, three blocks an SM; two buffers and a P tile
// of its own (96 KB, two blocks) ran 4-5% slower on an H100 (PERF.md)
constexpr int kF32Cols = 32;
constexpr int kF32Stages = 1;
constexpr int kF32PInK = 1;

// ---------------------------------------------------------------------------
// Hopper kernel (global_fwd_hopper.cuh): TMA producer + kConsumers wgmma
// consumer warpgroups, a kStages-deep K/V ring; Kw 64 or 128 (two bias_w
// register sets), no lse
// ---------------------------------------------------------------------------

constexpr int kConsumers = 3;              // consumer warpgroups
constexpr int kStages = 6;                 // K/V ring depth
using HopperCfg = gfwd::Config<kConsumers, kStages, 2, false>;
constexpr int kErrTensorMap = -2;          // cuTensorMapEncodeTiled failed

// The calls the Hopper kernel takes: bf16, and no bias or a key grid whose
// rows are 64 or 128 keys wide with a bias_h table that fits.
bool hopper_takes(int dtype, bool biased, int kh, int kw) {
  if (dtype == 0) return false;
  return !biased || gfwd::takes_bias<HopperCfg>(kh, kw);
}

// ---------------------------------------------------------------------------
// fp32: the register-tiled CUDA-core forward (f32_tiled_forward.cuh)
// ---------------------------------------------------------------------------

template <bool kBias>
__global__ void __launch_bounds__(vdr::tiled::NT, 2)
    k2_tiled_kernel(const vdr::AttnParams p) {
  extern __shared__ __align__(16) float smem_tiled[];
  const vdr::tiled::Problem pr = vdr::tiled::k2_problem(
      static_cast<const float*>(p.q), static_cast<const float*>(p.kv),
      static_cast<const float*>(p.bias_h),
      static_cast<const float*>(p.bias_w), p.kv_len,
      static_cast<float*>(p.out), p.S, p.H, p.kh, p.kw, p.scale_log2,
      blockIdx.z, blockIdx.y);
  vdr::tiled::forward<kF32Cols, kF32Stages, kF32PInK != 0, kBias>(
      pr, blockIdx.x * vdr::tiled::ROWS, smem_tiled);
}

template <bool kBias>
int launch_tiled(const vdr::AttnParams& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) *
      vdr::tiled::smem_floats<kF32Cols, kF32Stages, kF32PInK != 0>(
          kBias ? p.kh : 0, kBias ? p.kw : 0);
  auto kern = k2_tiled_kernel<kBias>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + vdr::tiled::ROWS - 1) / vdr::tiled::ROWS, p.H, p.B);
  kern<<<grid, vdr::tiled::NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vdr_error_string(int err) {
  if (err == kErrTensorMap) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The body a call with these arguments runs: 0 the mma.sync loop of
// flash_attention_core.cuh, 1 the Hopper kernel, 2 the register-tiled fp32
// forward.
int vdr_fused_global_route(int kh, int kw, int biased, int dtype) {
  if (dtype == 0) return 2;
  return hopper_takes(dtype, biased != 0, kh, kw) ? 1 : 0;
}

// Returns 0 on success, a cudaError_t after a failed launch, -1 for a head
// dim other than 64, the only one built (every config has D = 64), or -2
// when a TMA descriptor cannot be made.
int vdr_fused_global_attention(const void* q, const void* kv,
                               const void* bias_h, const void* bias_w,
                               const int* kv_len, void* out, int B, int S,
                               int H, int D, int kh, int kw, float scale,
                               int dtype, void* stream) {
  if (D != 64) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const vdr::AttnParams ap{q,  kv, bias_h, bias_w, kv_len, out, B, S,
                           H,  S,  kh,     kw,     scale * vdr::kLog2e};
  if (dtype == 0)
    return bias_h != nullptr ? launch_tiled<true>(ap, st)
                             : launch_tiled<false>(ap, st);
  if (!hopper_takes(dtype, bias_h != nullptr, kh, kw))
    return vdr::launch_bf16<64, kRowsBf16, kBlockK, false>(ap, st);
  const gfwd::Params p{static_cast<const __nv_bfloat16*>(bias_h),
                       static_cast<const __nv_bfloat16*>(bias_w),
                       kv_len,
                       static_cast<__nv_bfloat16*>(out),
                       nullptr,
                       S,
                       H,
                       kh,
                       kw,
                       scale * vdr::kLog2e};
  return gfwd::launch<HopperCfg>(q, kv, p, B, st, kErrTensorMap);
}

}  // extern "C"
