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
// What the design does about it (bf16, the `fast` path):
//  * warp specialisation: one producer thread keeps 64-key K and V tiles in
//    flight with TMA (cp.async.bulk.tensor, 128-byte swizzle) in a ring of
//    6 shared-memory stages guarded by mbarriers; the copies never wait on
//    the products;
//  * three consumer warpgroups of 64 query rows run wgmma: S = Q K^T with
//    Q's A fragments held in registers (loaded once from the TMA tile) and
//    K read from shared memory, and O += P V with P taken from the score
//    registers (rounded to bf16 in place) and V read from shared memory as
//    an MN-major operand. Each warpgroup issues QK^T of tile j together
//    with PV of tile j-1 and runs tile j's softmax while PV is on the
//    tensor cores; the warpgroups take turns to issue (named barriers), so
//    one's softmax runs under the others' products;
//  * the softmax stays online in log2 units in fp32 registers with a
//    running max that moves only when a row's max grows by more than 2^8
//    (O is rescaled on those tiles alone); masked scores are -1e30 and the
//    l > 0 guard stays, so a row with no valid key averages V over its S
//    keys, as the plain version does;
//  * the bias without per-score lookups: Kw is 64 or 128, so a 64-key tile
//    lies inside one key-grid row. Each thread keeps its rows' bias_w
//    columns in registers (Kw / 64 sets of 16 per row), and reads one
//    bias_h scalar per row and tile from a table staged once per block;
//    both are pre-multiplied by log2(e);
//  * kv_len: tiles wholly past kv_len are never loaded, the ragged tile is
//    masked; rows past S read zeros (TMA fills out-of-bounds boxes).
// The consumer pieces (Q fragments, the products of a tile, the softmax,
// the store) are in hopper_flash.cuh, shared with K3's Hopper kernel.
// The fp32 (`parity`) path takes the register-tiled CUDA-core forward of
// f32_tiled_forward.cuh (64 query rows a block, K/V tiles by cp.async,
// 4 x 4 score and 4 x 8 output micro-tiles a thread; fp32 FMAs only, with
// any Kw, no bias, or kv_len). A biased bf16 call whose Kw is not 64 or 128
// (or whose bias table would not fit in shared memory) keeps the earlier
// mma.sync loop of flash_attention_core.cuh. The C entry chooses by dtype
// and shape alone; vdr_fused_global_route reports the choice.

#include "f32_tiled_forward.cuh"
#include "flash_attention_core.cuh"
#include "hopper_flash.cuh"

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
// Hopper kernel: TMA producer + three wgmma consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kD = kFlashD;                // head dim (the only build)
constexpr int kConsumers = 3;              // consumer warpgroups
constexpr int kBQ = 64 * kConsumers;       // query rows per block
constexpr int kBK = 64;                    // keys per tile
constexpr int kStages = 6;                 // K/V ring depth
constexpr int kTile = 64 * kD * 2;         // one 64 x 64 bf16 tile (8 KB)
constexpr int kThreads = 128 * (kConsumers + 1);  // + 1 producer WG
// registers a thread after setmaxnreg: the producer gives its share to the
// consumers (64 K registers an SM, one block)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;
constexpr int kBiasLd = kBQ + 1;           // bias_h table row (bank skew)
constexpr int kMaxBiasW = 2;               // bias_w register sets (Kw/64)
constexpr int kErrTensorMap = -2;          // cuTensorMapEncodeTiled failed

struct HopperParams {
  const __nv_bfloat16* bias_h;  // (B, H, S, kh) or nullptr
  const __nv_bfloat16* bias_w;  // (B, H, S, kw) or nullptr
  const int* kv_len;            // (B,) or nullptr
  __nv_bfloat16* out;           // (B, S, H*D)
  int S, H, kh, kw;
  float scale_log2;             // D^-1/2 * log2(e)
};

// NW: bias_w register sets, Kw / 64 (0 = no bias).
template <int NW>
__global__ void __launch_bounds__(kThreads, 1)
    k2_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tkv,
                     const HopperParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], qbar;
  // the swizzled tiles need 1024-byte alignment in the shared window
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_addr = smem_u32(base);             // kConsumers Q tiles
  const uint32_t k_addr = q_addr + kConsumers * kTile;  // kStages K tiles
  const uint32_t v_addr = k_addr + kStages * kTile;     // kStages V tiles
  float* bias_s = reinterpret_cast<float*>(
      base + (kConsumers + 2 * kStages) * kTile);       // [kh][kBiasLd]

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kBQ;
  const int C = p.H * kD;
  // keys j < lim are valid; with none valid every key of the row is
  // visited, all masked, so the row averages V as the plain version does
  int lim = p.S;
  if (p.kv_len != nullptr) lim = min(p.S, max(p.kv_len[b], 0));
  const int n_tiles = ((lim > 0 ? lim : p.S) + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * 128);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(&qbar, kConsumers * kTile);
      for (int w = 0; w < kConsumers; ++w)
        tma_load(q_addr + w * kTile, &tq, &qbar, h * kD, row0 + 64 * w, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * kTile);
        tma_load(k_addr + st * kTile, &tkv, &full[st], h * kD, j * kBK, b);
        tma_load(v_addr + st * kTile, &tkv, &full[st], C + h * kD, j * kBK,
                 b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, c = lane % 4;
    const int r_lo = wg * 64 + warp * 16 + g;  // this thread's rows in the
    const int r_hi = r_lo + 8;                 // block (and + row0: global)
    const size_t head_row = ((size_t)b * p.H + h) * p.S;

    float bw[NW > 0 ? NW : 1][8][4];
    if constexpr (NW > 0) {
      // bias_h of this warpgroup's 64 rows, transposed to [grid row][row]
      for (int i = t; i < 64 * p.kh; i += 128) {
        const int r = wg * 64 + i / p.kh, kr = i % p.kh;
        const int R = row0 + r;
        bias_s[kr * kBiasLd + r] =
            R < p.S ? __bfloat162float(p.bias_h[(head_row + R) * p.kh + kr]) *
                          vdr::kLog2e
                    : 0.f;
      }
      // bias_w: column set w covers columns 64w .. 64w + 63 of the grid row
#pragma unroll
      for (int w = 0; w < NW; ++w) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int R = row0 + (half ? r_hi : r_lo);
            float lo = 0.f, hi = 0.f;
            if (R < p.S) {
              const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
                  p.bias_w + (head_row + R) * p.kw + w * 64 + i * 8 + 2 * c);
              lo = __low2float(v) * vdr::kLog2e;
              hi = __high2float(v) * vdr::kLog2e;
            }
            bw[w][i][2 * half] = lo;
            bw[w][i][2 * half + 1] = hi;
          }
        }
      }
      bar_sync(1 + wg, 128);
    }

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    Rows st{vdr::kNegInf, vdr::kNegInf, 0.f, 0.f, 1.f, 1.f};
    float s[32];
    uint32_t pa[4][4];
    // this tile's scores -> probabilities, in place
    auto probs = [&](int j) {
      const int k0 = j * kBK;
      float bh_lo = 0.f, bh_hi = 0.f;
      int set = 0;
      if constexpr (NW > 0) {
        const int kr = k0 / p.kw;
        bh_lo = bias_s[kr * kBiasLd + r_lo];
        bh_hi = bias_s[kr * kBiasLd + r_hi];
        set = (k0 % p.kw) / 64;
      }
      const bool ragged = k0 + kBK > lim;
      // a constant register-set index in each branch: no local memory
      if (NW == 2 && set)
        tile_probs<kBK, NW>(s, bw[NW == 2 ? 1 : 0], p.scale_log2, bh_lo,
                            bh_hi, k0 + 2 * c, ragged, lim, p.S, st);
      else
        tile_probs<kBK, NW>(s, bw[0], p.scale_log2, bh_lo, bh_hi, k0 + 2 * c,
                            ragged, lim, p.S, st);
    };
    // ping-pong: the warpgroups issue their products in turn, each after
    // the one before it, so one's softmax runs under the others' products
    // (named barriers 1 .. kConsumers serve the bias staging above)
    const int my_bar = 1 + kConsumers + wg;
    const int next_bar = 1 + kConsumers + (wg + 1) % kConsumers;
    if (wg == kConsumers - 1) bar_arrive(next_bar, 256);
    mbar_wait(&qbar, 0);
    uint32_t qa[kD / 16][4];
    q_frags(qa, base + wg * kTile, warp, g, c);

    // software pipeline: QK^T of tile j and PV of tile j-1 are issued
    // together; the softmax of tile j runs while PV(j-1) is on the tensor
    // cores, and O is rescaled once PV(j-1) has landed
    mbar_wait(&full[0], 0);
    bar_sync(my_bar, 256);
    wgmma_fence();
    qk_tile<kBK>(s, qa, k_addr);
    wgmma_commit();
    bar_arrive(next_bar, 256);
    wgmma_wait<0>();
    fence_regs(s);
    probs(0);
    pack_probs<kBK>(s, pa);
    for (int j = 1; j < n_tiles; ++j) {
      const int cur = j % kStages, prev = (j - 1) % kStages;
      mbar_wait(&full[cur], (j / kStages) & 1);
      bar_sync(my_bar, 256);
      wgmma_fence();
      qk_tile<kBK>(s, qa, k_addr + cur * kTile);
      wgmma_commit();
      pv_tile<kBK>(o, pa, v_addr + prev * kTile);
      wgmma_commit();
      bar_arrive(next_bar, 256);
      wgmma_wait<1>();
      fence_regs(s);
      probs(j);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(&empty[prev]);
      rescale(o, st);
      pack_probs<kBK>(s, pa);
    }
    const int last = (n_tiles - 1) % kStages;
    bar_sync(my_bar, 256);
    wgmma_fence();
    pv_tile<kBK>(o, pa, v_addr + last * kTile);
    wgmma_commit();
    // every last sync is matched: the last warpgroup's initial arrive
    // stands in for its final one
    if (wg != kConsumers - 1) bar_arrive(next_bar, 256);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&empty[last]);

    store_rows(p.out + (size_t)b * p.S * C + h * kD, C, row0 + r_lo,
               row0 + r_hi, p.S, c, o, st);
  }
}


size_t hopper_smem(int kh) {
  return 1024 + (size_t)(kConsumers + 2 * kStages) * kTile +
         (size_t)kh * kBiasLd * sizeof(float);
}

// The calls the Hopper kernel takes: bf16, and no bias or a key grid whose
// rows are 64 or 128 keys wide with a bias_h table that fits.
bool hopper_takes(int dtype, bool biased, int kh, int kw) {
  if (dtype == 0) return false;
  if (!biased) return true;
  return kw % 64 == 0 && kw / 64 <= kMaxBiasW &&
         hopper_smem(kh) <= 227 * 1024;
}

template <int NW>
int launch_hopper(const CUtensorMap& tq, const CUtensorMap& tkv,
                  const HopperParams& p, int B, cudaStream_t stream) {
  const size_t smem = hopper_smem(NW > 0 ? p.kh : 0);
  auto kern = k2_hopper_kernel<NW>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + kBQ - 1) / kBQ, p.H, B);
  kern<<<grid, kThreads, smem, stream>>>(tq, tkv, p);
  return (int)cudaGetLastError();
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
  CUtensorMap tq, tkv;
  if (!tensor_map_64(&tq, q, H * D, S, B) ||
      !tensor_map_64(&tkv, kv, 2 * H * D, S, B))
    return kErrTensorMap;
  const HopperParams p{static_cast<const __nv_bfloat16*>(bias_h),
                       static_cast<const __nv_bfloat16*>(bias_w),
                       kv_len,
                       static_cast<__nv_bfloat16*>(out),
                       S,
                       H,
                       kh,
                       kw,
                       scale * vdr::kLog2e};
  if (bias_h == nullptr) return launch_hopper<0>(tq, tkv, p, B, st);
  if (kw == 64) return launch_hopper<1>(tq, tkv, p, B, st);
  return launch_hopper<2>(tq, tkv, p, B, st);
}

}  // extern "C"
