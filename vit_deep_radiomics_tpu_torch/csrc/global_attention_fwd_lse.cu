// K5 forward: trainable global attention for SAM's global layers.
//
// Replaces: vit_deep_radiomics_tpu/ops/attention_grad.py::_fgt_fwd_kernel
// (the forward of global_attention_trainable, a Pallas TPU kernel).
//
// Computes K2's function (online-softmax flash attention over all S keys
// with the decomposed bias or a kv_len mask, max softmax) and also writes
// each row's log-sum-exp in log2 units, lse (B, H, S) fp32, for the
// backward (csrc/global_attention_bwd_dq.cu, global_attention_bwd_dkv.cu).
// The inference path keeps launching K2, which writes no residual.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the
// fine-tuning path's shapes (2 images x 4096 tokens x 12 heads of 64) it
// does 4 S^2 D H B = 103 GFLOP (0.104 ms at the bf16 peak) against about
// 76 MB of compulsory traffic (0.023 ms): compute-bound.
//
// What the design does about it: K2's tensor-core loop itself
// (flash_attention_core.cuh, mma.sync bf16 with fp32 accumulate, 128-row
// query tiles, 64-key tiles, P kept in registers), instantiated with the
// residual store; the residual costs 4 bytes per row and head.

#include "flash_attention_core.cuh"

namespace {
constexpr int kBlockK = 64;
constexpr int kRows = 128;
}  // namespace

extern "C" {

const char* vdr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bf16 only. Returns 0 on success, a cudaError_t after a failed launch, or
// -1 for a head dim other than 64.
int vdr_global_attention_fwd_lse(const void* q, const void* kv,
                                 const void* bias_h, const void* bias_w,
                                 const int* kv_len, void* out, float* lse,
                                 int B, int S, int H, int D, int kh, int kw,
                                 float scale, void* stream) {
  if (D != 64) return -1;
  vdr::AttnParams p{q, kv, bias_h, bias_w, kv_len, out, B, S,
                    H, S,  kh,     kw,     scale * vdr::kLog2e, lse};
  return vdr::launch_bf16<64, kRows, kBlockK, true>(
      p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
