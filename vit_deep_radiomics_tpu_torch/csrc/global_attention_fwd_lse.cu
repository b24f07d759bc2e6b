// K5 forward: trainable global attention for SAM's global layers and
// DINOv2's kv_len layers under `fast` fine-tuning.
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
// 76 MB of compulsory traffic (0.023 ms): compute-bound, with as many
// exponentials as K2 per product.
//
// What the design does about it: bf16 calls with no bias or a key grid 64
// keys wide (the calls the backward's Hopper bodies take) run K2's Hopper
// body, global_fwd_hopper.cuh, with its lse store (Config::kLse): one TMA
// producer thread and a 4-stage K/V ring on mbarriers, three wgmma
// consumer warpgroups of 64 query rows issuing in turns, the online
// softmax lazily rescaled, bias_w in registers and a staged bias_h table.
// The lse is m + log2(l) of each row's lazily moved max and its sum, 4
// bytes a row and head written from registers. The backward rebuilds
// P = exp2(s - lse) from its own scores, so this forward scores as it
// does: Q^ = bf16(q D^-1/2 log2 e) formed once in the A fragments, the
// bias terms times log2 e in fp32, masked keys at -1e30 log2 e; a forward
// that scaled the fp32 Q K^T instead would hand the backward an lse its
// P rows do not sum to. Biased calls with Kw in {8, 16, 32, 128} keep the
// first mma.sync loop of flash_attention_core.cuh (synchronously staged
// K/V tiles, the bias read per score from shared memory through a key
// table, so a 64-key tile may hold half a grid row), as the backward keeps
// its loops for them. vdr_global_attention_fwd_route reports the
// choice, which the C entry makes by shape alone.

#include "attention_bwd_core.cuh"
#include "global_fwd_hopper.cuh"

namespace {
using namespace vdr::sm90;

// the first loop: query rows a block, keys a tile
constexpr int kBlockK = 64;
constexpr int kRows = 128;
// the Hopper body: consumer warpgroups (64 query rows each) and K/V ring
// depth. On an H100 (PERF.md): two consumer warpgroups ran 19% slower at
// SAM's shape and at DINOv2's kv_len rows; 3, 4 and K2's 6 stages within
// 1% of each other
constexpr int kConsumers = 3;
constexpr int kStages = 4;
using HopperCfg = gfwd::Config<kConsumers, kStages, 1, true>;
// the Hopper body takes the K5 backward's calls (k5h::takes: head dim 64,
// and no bias or a key grid 64 keys wide of at most kMaxGridRows rows), so
// that the three K5 kernels route alike; each such bias_h table fits
static_assert(gfwd::smem_bytes<HopperCfg>(vdr::k5h::kMaxGridRows) <=
                  227 * 1024,
              "the bias_h table of every grid the route takes fits");

}  // namespace

extern "C" {

const char* vdr_error_string(int err) { return vdr::error_string(err); }

// 1 when a call with these arguments runs the Hopper body, 0 when it runs
// the first loop (the K5 backward's choice).
int vdr_global_attention_fwd_route(int S, int H, int D, int kh, int kw,
                                   int biased) {
  return vdr::k5h::takes(D, biased != 0, kh, kw) ? 1 : 0;
}

// bf16 only. Returns 0 on success, a cudaError_t after a failed launch, -1
// for a head dim other than 64, -2 for a bias with kw not in
// {8,16,32,64,128},
// -3 when a TMA descriptor cannot be made.
int vdr_global_attention_fwd_lse(const void* q, const void* kv,
                                 const void* bias_h, const void* bias_w,
                                 const int* kv_len, void* out, float* lse,
                                 int B, int S, int H, int D, int kh, int kw,
                                 float scale, void* stream) {
  if (D != 64) return -1;
  const bool has_bias = bias_h != nullptr;
  if (has_bias && !vdr::k5h::bias_width_ok(kw)) return -2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vdr::k5h::takes(D, has_bias, kh, kw)) {
    const gfwd::Params p{static_cast<const __nv_bfloat16*>(bias_h),
                         static_cast<const __nv_bfloat16*>(bias_w),
                         kv_len,
                         static_cast<__nv_bfloat16*>(out),
                         lse,
                         S,
                         H,
                         kh,
                         kw,
                         scale * vdr::kLog2e};
    return gfwd::launch<HopperCfg>(q, kv, p, B, st,
                                   vdr::k5h::kErrTensorMap);
  }
  vdr::AttnParams p{q, kv, bias_h, bias_w, kv_len, out, B, S,
                    H, S,  kh,     kw,     scale * vdr::kLog2e, lse};
  return vdr::launch_bf16<64, kRows, kBlockK, true>(p, st);
}

}  // extern "C"
