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
// What the design does about it (bf16, windows of at most 256 tokens):
//  * one (window, head) is one work item, done whole: a persistent block
//    (one an SM: two items in shared memory) walks over items; one thread
//    of a producer warpgroup brings the next item's Q, K and V by TMA
//    (boxes of 64 columns x exactly `window_tokens` rows, 128-byte
//    swizzle, so no copy touches the next window) and its bias rows by bulk
//    copy into the second buffer while two consumer warpgroups (setmaxnreg)
//    compute the current one, then stores the output by TMA from shared
//    memory;
//  * each warpgroup takes 64-row query tiles (196 rows -> 4 tiles) and
//    scores all of the window's keys with one wgmma of N = the window
//    padded to 64/208/256 keys, Q and K read from shared memory;
//  * the decomposed bias is one more wgmma into the same scores:
//    [bias_h | bias_w | 1] (registers, K = the 28 terms and a mask term,
//    padded to 16) times a constant expand matrix E built once per block
//    (E[t][j] = 1/scale where key j takes term t, the mask term -1e30 /
//    (scale log2 e) on the keys past the window, whose K and V rows are
//    zero), as JAX's kernel expands its bias with one-hot matrices;
//  * the softmax is one pass with the max kept, in fp32, in log2 units
//    (row max, exp2, row sum; no running max and no rescale of O); P is
//    rounded to bf16 in registers and O += P V reads V from shared memory;
//    the l > 0 guard stays;
//  * the output tile is normalised, written over the tile's own Q rows in
//    shared memory, and stored by TMA (rows past the window never leave).
// The fp32 (`parity`) path takes the register-tiled CUDA-core forward of
// f32_tiled_forward.cuh, one (window, head) a problem (k1_problem): 64
// query rows a block (196 = 3 x 64 + 4), 32-key K/V tiles by cp.async
// into two buffers (7 tiles, 28 slots of the last absent), 4 x 4 score
// and 4 x 8 output micro-tiles a thread, fp32 FMAs only (67 TFLOP/s
// bounds it: 11.8 GFLOP, 0.176 ms at the extraction path's shape; the
// fourth, 4-row block of a window costs about a fifth of the time, PERF.md).
// bf16 windows of more than 256 tokens, bias grids of more than
// 63 terms and scales whose inverse is not a power of two keep the first
// mma.sync loop of flash_attention_core.cuh (112-key tiles, an online
// softmax). The C entry chooses by dtype and shape alone, and
// vdr_fused_window_route reports the choice.

#include <math.h>

#include "f32_tiled_forward.cuh"
#include "flash_attention_core.cuh"
#include "hopper.cuh"

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
// ---------------------------------------------------------------------------

constexpr int kD = 64;                  // head dim (the only build)
constexpr int kConsumers = 2;           // consumer warpgroups
constexpr int kBuffers = 2;             // work items in shared memory
constexpr int kTerms = 64;              // a row of E^T: bias terms, mask
constexpr int kThreads = 128 * (kConsumers + 1);  // + a producer warpgroup
// registers a thread after setmaxnreg: the producer gives its share to the
// consumers (64 K registers an SM, one block)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs =
    (65536 / 128 - kProducerRegs) / kConsumers / 8 * 8 > 248
        ? 248
        : (65536 / 128 - kProducerRegs) / kConsumers / 8 * 8;
constexpr int kTileBytes = 64 * kD * 2;          // 64 rows of one head
constexpr int kSmemMax = 227 * 1024;
constexpr int kErrTensorMap = -2;       // cuTensorMapEncodeTiled failed

struct WinParams {
  const bf16* bias_h;  // (B, H, S, kh) or nullptr
  const bf16* bias_w;  // (B, H, S, kw) or nullptr
  int S, H, win, n_items, n_tiles, kh, kw, nbuf;
  int bias_bulk;       // the bias rows arrive by bulk copy (16-byte lines)
  int q_bytes, kv_bytes, bh_bytes, buf_bytes;  // one buffer: Q/O, K, V,
                                               // bias_h, bias_w
  float scale_log2;    // scale * log2(e)
  float inv_scale;     // 1 / scale, a power of two
};

// S = Q K^T over all of the window's keys (4 k16 steps along D), then
// S += [bias terms | mask term] E (nb k16 steps); one commit group.
template <int N>
__device__ __forceinline__ void qk_products(float (&s)[N / 2],
                                            uint32_t (&ba)[kTerms / 16][4],
                                            int nb, uint32_t q_addr,
                                            uint32_t k_addr,
                                            uint32_t e_addr) {
  const uint64_t dq = desc_sw128(q_addr, 16, 1024);
  const uint64_t dk = desc_sw128(k_addr, 16, 1024);
  const uint64_t de = desc_sw128(e_addr, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    Wgmma<N>::ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
#pragma unroll
  for (int kb = 0; kb < kTerms / 16; ++kb)
    if (kb < nb) Wgmma<N>::template rs<0>(s, ba[kb], de + 2 * kb, 1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(s[i])::"memory");
  fence_regs(ba);
}

// One pass over the row: max (the 4 lanes of a group share a row), then
// p = exp2((s - max) * scale log2 e) in fp32, the row sums, and P rounded
// to bf16 as the A fragments of PV (two n8 score chunks make one k16
// fragment).
template <int N>
__device__ __forceinline__ void softmax_rows(const float (&s)[N / 2],
                                             uint32_t (&pa)[N / 16][4],
                                             float sl, float& l_lo,
                                             float& l_hi) {
  float mx_lo = s[0], mx_hi = s[2];
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * i], s[4 * i + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  const float mb_lo = mx_lo * sl, mb_hi = mx_hi * sl;
  l_lo = l_hi = 0.f;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const float p0 = fast_exp2(fmaf(s[4 * i], sl, -mb_lo));
    const float p1 = fast_exp2(fmaf(s[4 * i + 1], sl, -mb_lo));
    const float p2 = fast_exp2(fmaf(s[4 * i + 2], sl, -mb_hi));
    const float p3 = fast_exp2(fmaf(s[4 * i + 3], sl, -mb_hi));
    l_lo += p0 + p1;
    l_hi += p2 + p3;
    pa[i / 2][(i & 1) * 2] = vdr::pack_bf16(p0, p1);
    pa[i / 2][(i & 1) * 2 + 1] = vdr::pack_bf16(p2, p3);
  }
}

// O = P V: k = the window's keys (16 a step: two 1024-byte 8-key groups of
// the MN-major V), n = the head dim.
template <int N>
__device__ __forceinline__ void pv_products(float (&o)[32],
                                            uint32_t (&pa)[N / 16][4],
                                            uint32_t v_addr) {
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt)
    Wgmma<64>::rs<1>(o, pa[kt], desc_sw128(v_addr + kt * 2048, 1024, 1024),
                     1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
}

// One 64-row query tile of the item in buffer `bp`: scores, softmax, PV,
// and the normalised output written over the tile's Q rows (swizzled as
// TMA wrote them: 16-byte chunk k of row r sits at chunk k ^ (r % 8)).
template <int N>
__device__ __forceinline__ void attend_tile(const WinParams& p,
                                            unsigned char* bp,
                                            uint32_t e_addr, int tile,
                                            const bf16* bh, const bf16* bw,
                                            int warp, int g, int c) {
  const int rl = warp * 16 + g;          // rows rl and rl + 8 of the tile
  const int r_lo = tile * 64 + rl, r_hi = r_lo + 8;  // rows of the window
  const int nt = p.kh + p.kw;            // the mask term
  const int nb = nt / 16 + 1;            // k16 steps of terms 0 .. nt
  const bf16 one = __float2bfloat16(1.f), zero = __float2bfloat16(0.f);
  auto term = [&](int r, int tt) -> bf16 {
    if (tt == nt) return one;
    if (tt > nt || r >= p.win) return zero;
    return tt < p.kh ? bh[r * p.kh + tt] : bw[r * p.kw + tt - p.kh];
  };
  // A fragments of the bias step kb: terms 16kb + 2c (+1) and + 8 (+9) of
  // rows r_lo (a0, a2) and r_hi (a1, a3)
  uint32_t ba[kTerms / 16][4];
#pragma unroll
  for (int kb = 0; kb < kTerms / 16; ++kb)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = (f & 1) ? r_hi : r_lo, tt = 16 * kb + 2 * c + (f >> 1) * 8;
      __nv_bfloat162 v;
      v.x = term(r, tt);
      v.y = term(r, tt + 1);
      ba[kb][f] = *reinterpret_cast<uint32_t*>(&v);
    }
  const uint32_t q_addr = smem_u32(bp + tile * kTileBytes);
  const uint32_t k_addr = smem_u32(bp + p.q_bytes);
  const uint32_t v_addr = k_addr + p.kv_bytes;
  float s[N / 2];
  qk_products<N>(s, ba, nb, q_addr, k_addr, e_addr);
  uint32_t pa[N / 16][4];
  float l_lo, l_hi;
  softmax_rows<N>(s, pa, p.scale_log2, l_lo, l_hi);
  float o[32];
  pv_products<N>(o, pa, v_addr);

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / (l_lo > 0.f ? l_lo : 1.f);
  const float inv_hi = 1.f / (l_hi > 0.f ? l_hi : 1.f);
  unsigned char* ot = bp + tile * kTileBytes;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = ((i ^ g) * 16) + 4 * c;
    *reinterpret_cast<uint32_t*>(ot + rl * 128 + col) =
        vdr::pack_bf16(o[4 * i] * inv_lo, o[4 * i + 1] * inv_lo);
    *reinterpret_cast<uint32_t*>(ot + (rl + 8) * 128 + col) =
        vdr::pack_bf16(o[4 * i + 2] * inv_hi, o[4 * i + 3] * inv_hi);
  }
}

// E^T (key j, term t; rows of 128 bytes, swizzled) and zero rows past the
// window in every buffer's Q, K and V, once per block. TMA writes only the
// window's rows, so the K and V zeros stay; Q's rows past the window are
// overwritten by attend_tile's output and hold a previous item's values
// from then on, which is harmless: a row's scores, softmax and output
// depend on that row alone, and rows past the window are never stored.
template <int N>
__device__ __forceinline__ void init_block(const WinParams& p,
                                           unsigned char* base,
                                           unsigned char* bufs) {
  const int nt = p.kh + p.kw;
  const bf16 one = __float2bfloat16(p.inv_scale);
  const bf16 zero = __float2bfloat16(0.f);
  const bf16 mask = __float2bfloat16(vdr::kNegInf / p.scale_log2);
  for (int i = threadIdx.x; i < N * 8; i += 128 * kConsumers) {
    const int j = i / 8, chunk = i % 8;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int tt = chunk * 8 + e;
      const bool on = j < p.win && ((tt < p.kh && j / p.kw == tt) ||
                                    (tt >= p.kh && tt < nt &&
                                     j % p.kw == tt - p.kh));
      v[e] = tt == nt ? (j < p.win ? zero : mask) : (on ? one : zero);
    }
    *reinterpret_cast<uint4*>(base + j * 128 + ((chunk ^ (j & 7)) * 16)) =
        *reinterpret_cast<const uint4*>(v);
  }
  const int pad_q = p.q_bytes - p.win * 128, pad_kv = p.kv_bytes - p.win * 128;
  for (int b = 0; b < p.nbuf; ++b) {
    unsigned char* q0 = bufs + b * p.buf_bytes + p.win * 128;
    unsigned char* k0 = bufs + b * p.buf_bytes + p.q_bytes + p.win * 128;
    for (int i = 16 * threadIdx.x; i < pad_q; i += 16 * 128 * kConsumers)
      *reinterpret_cast<uint4*>(q0 + i) = make_uint4(0, 0, 0, 0);
    for (int i = 16 * threadIdx.x; i < pad_kv; i += 16 * 128 * kConsumers) {
      *reinterpret_cast<uint4*>(k0 + i) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(k0 + p.kv_bytes + i) = make_uint4(0, 0, 0, 0);
    }
  }
}

// Window rows of head h in the per-head bias layout (B, H, S, K): the
// first of the window's rows, (b * H + h) * S + token.
__device__ __forceinline__ size_t bias_row(const WinParams& p, int item) {
  const int row = (item / p.H) * p.win;   // in the (B * S) token rows
  return ((size_t)(row / p.S) * p.H + item % p.H) * p.S + row % p.S;
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    k1_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tkv,
                     const __grid_constant__ CUtensorMap tout,
                     const WinParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kBuffers], done[kBuffers];
  // the swizzled tiles need 1024-byte alignment in the shared window
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bufs = base + N * 128;      // after E^T
  // the items of this block: blockIdx.x, + gridDim.x, ... (grid <= items)
  const int n_mine = (p.n_items - 1 - (int)blockIdx.x) / gridDim.x + 1;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.nbuf; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&done[i], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (threadIdx.x != 128 * kConsumers) return;
    const int C = p.H * kD;
    auto load = [&](int k) {
      const int item = blockIdx.x + k * gridDim.x, buf = k % p.nbuf;
      const int h = item % p.H, row = (item / p.H) * p.win;
      const uint32_t q_dst = smem_u32(bufs + buf * p.buf_bytes);
      const uint32_t k_dst = q_dst + p.q_bytes, v_dst = k_dst + p.kv_bytes;
      int bytes = 3 * p.win * kD * 2;
      if (p.bias_bulk) bytes += p.win * (p.kh + p.kw) * 2;
      mbar_expect_tx(&full[buf], bytes);
      tma_load_2d(q_dst, &tq, &full[buf], h * kD, row);
      tma_load_2d(k_dst, &tkv, &full[buf], h * kD, row);
      tma_load_2d(v_dst, &tkv, &full[buf], C + h * kD, row);
      if (p.bias_bulk) {
        const size_t r = bias_row(p, item);
        bulk_load(v_dst + p.kv_bytes, p.bias_h + r * p.kh,
                  p.win * p.kh * 2, &full[buf]);
        bulk_load(v_dst + p.kv_bytes + p.bh_bytes, p.bias_w + r * p.kw,
                  p.win * p.kw * 2, &full[buf]);
      }
    };
    for (int k = 0; k < min(n_mine, p.nbuf); ++k) load(k);
    for (int k = 0; k < n_mine; ++k) {
      const int item = blockIdx.x + k * gridDim.x, buf = k % p.nbuf;
      mbar_wait(&done[buf], (k / p.nbuf) & 1);
      tma_store_2d(&tout, smem_u32(bufs + buf * p.buf_bytes),
                   (item % p.H) * kD, (item / p.H) * p.win);
      bulk_commit();
      if (k + p.nbuf < n_mine) {
        bulk_wait_read();          // the output has left the buffer
        load(k + p.nbuf);
      }
    }
    bulk_wait();
    return;
  }

  // ---- consumers: 64-row query tiles, the block's i-th tile (counted
  // over its items) to warpgroup i % kConsumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
               : "memory");
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, c = lane % 4;
  init_block<N>(p, base, bufs);
  fence_proxy_async();
  bar_sync(1, 128 * kConsumers);
  for (int k = 0; k < n_mine; ++k) {
    const int item = blockIdx.x + k * gridDim.x, buf = k % p.nbuf;
    unsigned char* bp = bufs + buf * p.buf_bytes;
    const bf16 *bh = nullptr, *bw = nullptr;
    if (p.bias_h != nullptr) {
      if (p.bias_bulk) {
        bh = reinterpret_cast<const bf16*>(bp + p.q_bytes + 2 * p.kv_bytes);
        bw = reinterpret_cast<const bf16*>(bp + p.q_bytes + 2 * p.kv_bytes +
                                           p.bh_bytes);
      } else {
        const size_t r = bias_row(p, item);
        bh = p.bias_h + r * p.kh;
        bw = p.bias_w + r * p.kw;
      }
    }
    mbar_wait(&full[buf], (k / p.nbuf) & 1);
    const int first = (wg - k * p.n_tiles % kConsumers + kConsumers) %
                      kConsumers;
    for (int tile = first; tile < p.n_tiles; tile += kConsumers)
      attend_tile<N>(p, bp, smem_u32(base), tile, bh, bw, warp, g, c);
    fence_proxy_async();
    mbar_arrive(&done[buf]);
  }
}

// Keys a window pads to: the N of the score wgmma (0: no Hopper instance).
// SAM's 14 x 14 windows take 208 at every image size; 64 and 256 serve
// 8 x 8 and 16 x 16 windows, and the windows between pad to the next.
int hopper_width(int win) {
  return win <= 64 ? 64 : win <= 208 ? 208 : win <= 256 ? 256 : 0;
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Whether the Hopper kernel takes the call, and its parameters, window
// width and shared memory: bf16, D = 64, windows of at most 256 tokens, at
// most 63 bias terms, and a scale whose inverse is a power of two (so that
// E's 1/scale is exact in bf16).
bool hopper_plan(int B, int S, int H, int D, int win, int kh, int kw,
                 bool biased, float scale, int dtype, WinParams* wp, int* n,
                 size_t* smem) {
  if (dtype == 0 || D != kD || win < 1 || S % win != 0) return false;
  *n = hopper_width(win);
  if (*n == 0 || !(scale > 0.f)) return false;
  int e = 0;
  const float inv = 1.f / scale;
  if (frexpf(inv, &e) != 0.5f) return false;
  if (!biased) kh = kw = 0;
  if (kh + kw + 1 > kTerms) return false;
  WinParams p{};
  p.S = S;
  p.H = H;
  p.win = win;
  p.n_items = B * (S / win) * H;
  p.n_tiles = (win + 63) / 64;
  p.kh = kh;
  p.kw = kw;
  p.bias_bulk = biased && (win * kh * 2) % 16 == 0 && (win * kw * 2) % 16 == 0;
  p.q_bytes = p.n_tiles * kTileBytes;
  p.kv_bytes = *n * 128;
  p.bh_bytes = p.bias_bulk ? win * kh * 2 : 0;
  const int bw_bytes = p.bias_bulk ? win * kw * 2 : 0;
  p.buf_bytes =
      round_up(p.q_bytes + 2 * p.kv_bytes + p.bh_bytes + bw_bytes, 1024);
  p.scale_log2 = scale * vdr::kLog2e;
  p.inv_scale = inv;
  auto bytes = [&](int nbuf) {
    return (size_t)1024 + (size_t)*n * 128 + (size_t)nbuf * p.buf_bytes;
  };
  p.nbuf = kBuffers;
  while (p.nbuf > 1 && bytes(p.nbuf) > (size_t)kSmemMax) --p.nbuf;
  if (bytes(p.nbuf) > (size_t)kSmemMax) return false;
  *smem = bytes(p.nbuf);
  *wp = p;
  return true;
}

// 2-D map (width columns, rows) of a row-major bf16 tensor: boxes of 64
// columns (one head, 128 bytes: the 128-byte swizzle) x box_rows rows.
bool tensor_map_2d(CUtensorMap* map, const void* ptr, int width, int rows,
                   int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
int launch_hopper(const CUtensorMap& tq, const CUtensorMap& tkv,
                  const CUtensorMap& tout, const WinParams& p, size_t smem,
                  cudaStream_t stream) {
  auto kern = k1_hopper_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int grid = min(p.n_items, sms * per_sm);
  kern<<<grid, kThreads, smem, stream>>>(tq, tkv, tout, p);
  return (int)cudaGetLastError();
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
  WinParams p;
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
  if (D != kD) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const vdr::AttnParams a{q,  kv, bias_h, bias_w, nullptr, out, B,  S,
                          H,  window_tokens, kh, kw, scale * vdr::kLog2e};
  if (dtype == 0)
    return bias_h != nullptr ? launch_tiled<true>(a, st)
                             : launch_tiled<false>(a, st);
  WinParams p;
  int n = 0;
  size_t smem = 0;
  if (!hopper_plan(B, S, H, D, window_tokens, kh, kw, bias_h != nullptr,
                   scale, dtype, &p, &n, &smem))
    return vdr::launch_bf16<64, kRowsBf16, kBlockK, false>(a, st);
  p.bias_h = static_cast<const bf16*>(bias_h);
  p.bias_w = static_cast<const bf16*>(bias_w);
  CUtensorMap tq, tkv, tout;
  if (!tensor_map_2d(&tq, q, H * D, B * S, window_tokens) ||
      !tensor_map_2d(&tkv, kv, 2 * H * D, B * S, window_tokens) ||
      !tensor_map_2d(&tout, out, H * D, B * S, window_tokens))
    return kErrTensorMap;
  switch (n) {
    case 64: return launch_hopper<64>(tq, tkv, tout, p, smem, st);
    case 208: return launch_hopper<208>(tq, tkv, tout, p, smem, st);
    default: return launch_hopper<256>(tq, tkv, tout, p, smem, st);
  }
}

}  // extern "C"
