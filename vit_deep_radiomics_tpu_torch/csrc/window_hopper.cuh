// The whole-window Hopper attention body that K1 (fused_window_attention.cu:
// token-major q (B, S, H*D) and packed kv (B, S, 2*H*D)) and K3's window
// mode (flash_attention.cu: head-major q, k and v, (B, H, S, D)) share.
//
// One work item is one (batch, window, head), item = (b * windows + w) * H
// + h, done whole by a persistent block (one an SM):
//  * one thread of a producer warpgroup brings the next item's Q, K and V
//    by TMA (boxes of 64 columns x exactly `win` query rows and `keys` key
//    rows, 128-byte swizzle, so no copy touches the next window) and its
//    bias rows by bulk copy into the second buffer while two consumer
//    warpgroups (setmaxnreg) compute the current one, then stores the
//    output by TMA from shared memory;
//  * each warpgroup takes 64-row query tiles (196 rows -> 4 tiles) and
//    scores all of the item's keys with one wgmma of N = the keys padded
//    to 64/208/224/256, Q and K read from shared memory;
//  * the decomposed bias is kBiasSteps more k16 wgmma steps into the same
//    scores, issued unconditionally: [bias_h | bias_w | 1] (registers, K =
//    the kh + kw terms and a mask term, zeros past it) times a constant
//    expand matrix E built once per block (E[t][j] = 1/scale where key j
//    takes term t; the mask term -1e30 / (scale log2 e) on the masked
//    keys: past the window's keys, whose K and V rows are zero, and,
//    head-major, outside the kv_grid sub-grid);
//  * the softmax is one pass with the max kept, in fp32, in log2 units
//    (row max, exp2, row sum; no running max and no rescale of O); P is
//    rounded to bf16 in registers and O += P V reads V from shared memory;
//    the l > 0 guard stays;
//  * the output tile is normalised, written over the tile's own Q rows in
//    shared memory, and stored by TMA (rows past the window never leave).
// The layout enters only where the producer addresses its boxes and where
// E's mask term and the zero key rows are set (kHeadMajor).
#pragma once

#include <math.h>

#include "flash_attention_core.cuh"
#include "hopper.cuh"

namespace vdr {
namespace sm90 {
namespace win {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                  // head dim (the only build)
constexpr int kConsumers = 2;           // consumer warpgroups
constexpr int kBuffers = 2;             // work items in shared memory
// bias k16 steps of E, issued unconditionally (a step in a branch makes
// ptxas inject warpgroup.arrive, C7519): at most 16 * kBiasSteps - 1 bias
// terms. Three take every square window of at most 256 tokens (16 x 16:
// 32 terms); four ran 4-6% slower in K1 and up to 4% in K3's window mode
// (PERF.md)
constexpr int kBiasSteps = 3;
constexpr int kThreads = 128 * (kConsumers + 1);  // + a producer warpgroup
// registers a thread after setmaxnreg: the producer gives its share to the
// consumers (64 K registers an SM, one block)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs =
    (65536 / 128 - kProducerRegs) / kConsumers / 8 * 8 > 248
        ? 248
        : (65536 / 128 - kProducerRegs) / kConsumers / 8 * 8;
constexpr int kTileBytes = 64 * kD * 2;          // 64 rows of one head
// the shared memory a block may take, less the static barriers
constexpr int kSmemMax = 227 * 1024 - 64;

struct WinParams {
  const bf16* bias_h;  // (B, H, S, kh) or nullptr
  const bf16* bias_w;  // (B, H, S, kw) or nullptr
  int S, H, win, n_items, n_tiles, kh, kw, nbuf;
  int bias_bulk;       // the bias rows arrive by bulk copy (16-byte lines)
  int q_bytes, kv_bytes, bh_bytes, buf_bytes;  // one buffer: Q/O, K, V,
                                               // bias_h, bias_w
  float scale_log2;    // scale * log2(e)
  float inv_scale;     // 1 / scale, a power of two
  // head-major only: the key rows an item loads (all of the window's, or
  // its first kh_valid grid rows) and the valid key sub-grid
  int keys, kh_valid, kw_valid;
};

// S = Q K^T over all of the item's keys (4 k16 steps along D), then S +=
// [bias terms | mask term] E in kBiasSteps k16 steps, each A fragment
// built by frag(kb, a) after QK^T is issued, so that its loads run under
// the products. At N 256 the scores take 128 registers a thread: one bias
// step is in flight at a time, its fragment dead at the wait, or the
// kernel spills.
template <int N, typename Frag>
__device__ __forceinline__ void qk_products(float (&s)[N / 2],
                                            const Frag& frag, uint32_t q_addr,
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
  for (int kb = 0; kb < kBiasSteps; ++kb) {
    uint32_t a[1][4];
    frag(kb, a[0]);
    wgmma_fence();
    Wgmma<N>::template rs<0>(s, a[0], de + 2 * kb, 1);
    if constexpr (N > 224) {
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(a);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(s[i])::"memory");
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

// O = P V: k = the item's keys (16 a step: two 1024-byte 8-key groups of
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
  const bf16 one = __float2bfloat16(1.f), zero = __float2bfloat16(0.f);
  auto term = [&](int r, int tt) -> bf16 {
    if (tt == nt) return one;
    if (tt > nt || r >= p.win) return zero;
    return tt < p.kh ? bh[r * p.kh + tt] : bw[r * p.kw + tt - p.kh];
  };
  // A fragment of the bias step kb: terms 16kb + 2c (+1) and + 8 (+9) of
  // rows r_lo (a0, a2) and r_hi (a1, a3)
  auto frag = [&](int kb, uint32_t (&a)[4]) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = (f & 1) ? r_hi : r_lo, tt = 16 * kb + 2 * c + (f >> 1) * 8;
      __nv_bfloat162 v;
      v.x = term(r, tt);
      v.y = term(r, tt + 1);
      a[f] = *reinterpret_cast<uint32_t*>(&v);
    }
  };
  const uint32_t q_addr = smem_u32(bp + tile * kTileBytes);
  const uint32_t k_addr = smem_u32(bp + p.q_bytes);
  const uint32_t v_addr = k_addr + p.kv_bytes;
  float s[N / 2];
  qk_products<N>(s, frag, q_addr, k_addr, e_addr);
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
// loaded rows in every buffer's Q, K and V, once per block. TMA writes
// only the window's query rows and the item's key rows, so the K and V
// zeros stay; Q's rows past the window are overwritten by attend_tile's
// output and hold a previous item's values from then on, which is
// harmless: a row's scores, softmax and output depend on that row alone,
// and rows past the window are never stored. A key is masked past the
// window (token-major) or past the loaded rows and the kv_grid columns
// (head-major).
template <int N, bool kHeadMajor>
__device__ __forceinline__ void init_block(const WinParams& p,
                                           unsigned char* base,
                                           unsigned char* bufs) {
  const int nt = p.kh + p.kw;
  const bf16 one = __float2bfloat16(p.inv_scale);
  const bf16 zero = __float2bfloat16(0.f);
  const bf16 mask = __float2bfloat16(vdr::kNegInf / p.scale_log2);
  for (int i = threadIdx.x; i < N * 8; i += 128 * kConsumers) {
    const int j = i / 8, chunk = i % 8;
    bool valid = j < p.win;
    if constexpr (kHeadMajor)
      valid = j < p.keys && j / p.kw < p.kh_valid && j % p.kw < p.kw_valid;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int tt = chunk * 8 + e;
      const bool on = j < p.win && ((tt < p.kh && j / p.kw == tt) ||
                                    (tt >= p.kh && tt < nt &&
                                     j % p.kw == tt - p.kh));
      v[e] = tt == nt ? (valid ? zero : mask) : (on ? one : zero);
    }
    *reinterpret_cast<uint4*>(base + j * 128 + ((chunk ^ (j & 7)) * 16)) =
        *reinterpret_cast<const uint4*>(v);
  }
  const int kv_rows = kHeadMajor ? p.keys : p.win;
  const int pad_q = p.q_bytes - p.win * 128;
  const int pad_kv = p.kv_bytes - kv_rows * 128;
  for (int b = 0; b < p.nbuf; ++b) {
    unsigned char* q0 = bufs + b * p.buf_bytes + p.win * 128;
    unsigned char* k0 = bufs + b * p.buf_bytes + p.q_bytes + kv_rows * 128;
    for (int i = 16 * threadIdx.x; i < pad_q; i += 16 * 128 * kConsumers)
      *reinterpret_cast<uint4*>(q0 + i) = make_uint4(0, 0, 0, 0);
    for (int i = 16 * threadIdx.x; i < pad_kv; i += 16 * 128 * kConsumers) {
      *reinterpret_cast<uint4*>(k0 + i) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(k0 + p.kv_bytes + i) = make_uint4(0, 0, 0, 0);
    }
  }
}

// Window rows of head h in the per-head layout (B, H, S, K): the first of
// the window's rows, (b * H + h) * S + token. Head-major q, k, v and out
// start their item at the same row of their (B * H * S, 64) view.
__device__ __forceinline__ size_t bias_row(const WinParams& p, int item) {
  const int row = (item / p.H) * p.win;   // in the (B * S) token rows
  return ((size_t)(row / p.S) * p.H + item % p.H) * p.S + row % p.S;
}

// The kernel's body. Token-major: tq and tout map (B * S, H * 64) and tk =
// tv maps kv (B * S, 2 * H * 64), item (b, w, h) at column h * 64 (V: H *
// 64 + h * 64), row b * S + w * win. Head-major: tq, tk, tv and tout each
// map (B * H * S, 64), the item at column 0, row bias_row.
template <int N, bool kHeadMajor>
__device__ __forceinline__ void window_body(const CUtensorMap* tq,
                                            const CUtensorMap* tk,
                                            const CUtensorMap* tv,
                                            const CUtensorMap* tout,
                                            const WinParams& p) {
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
      const int h = item % p.H;
      const int row = kHeadMajor ? (int)bias_row(p, item)
                                 : (item / p.H) * p.win;
      const uint32_t q_dst = smem_u32(bufs + buf * p.buf_bytes);
      const uint32_t k_dst = q_dst + p.q_bytes, v_dst = k_dst + p.kv_bytes;
      int bytes = (kHeadMajor ? p.win + 2 * p.keys : 3 * p.win) * kD * 2;
      if (p.bias_bulk) bytes += p.win * (p.kh + p.kw) * 2;
      mbar_expect_tx(&full[buf], bytes);
      tma_load_2d(q_dst, tq, &full[buf], kHeadMajor ? 0 : h * kD, row);
      tma_load_2d(k_dst, tk, &full[buf], kHeadMajor ? 0 : h * kD, row);
      tma_load_2d(v_dst, tv, &full[buf], kHeadMajor ? 0 : C + h * kD, row);
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
      tma_store_2d(tout, smem_u32(bufs + buf * p.buf_bytes),
                   kHeadMajor ? 0 : (item % p.H) * kD,
                   kHeadMajor ? (int)bias_row(p, item) : (item / p.H) * p.win);
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
  init_block<N, kHeadMajor>(p, base, bufs);
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

// Keys an item pads to: the N of the score wgmma (0: no instance). SAM's
// 14 x 14 windows take 208 at every image size; 64 and 256 serve 8 x 8 and
// 16 x 16 windows, and the counts between pad to the next.
inline int hopper_width(int keys) {
  return keys <= 64 ? 64 : keys <= 208 ? 208 : keys <= 256 ? 256 : 0;
}

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Whether the body takes the call, and its parameters and shared memory,
// for windows of `win` tokens whose items load `keys` key rows into an N
// of `n`: bf16, D = 64, at most 16 * kBiasSteps - 1 bias terms, and a
// scale whose inverse is a power of two (so that E's 1/scale is exact in bf16). The bias rows are
// staged by bulk copy where their lines allow; where kBuffers items do not
// fit with them staged (256-token windows), the consumers read them from
// device memory instead, before fewer buffers are tried (at 16 x 16
// windows two buffers and the rows from device memory ran 8-15% faster
// than one buffer and the rows staged in K3's window mode, 17% in K1,
// PERF.md).
inline bool hopper_plan(int B, int S, int H, int D, int win, int keys, int n,
                        int kh, int kw, bool biased, float scale, int dtype,
                        WinParams* wp, size_t* smem) {
  if (dtype == 0 || D != kD || win < 1 || S % win != 0) return false;
  if (n == 0 || keys < 1 || keys > n || !(scale > 0.f)) return false;
  int e = 0;
  const float inv = 1.f / scale;
  if (frexpf(inv, &e) != 0.5f) return false;
  if (!biased) kh = kw = 0;
  if (kh + kw + 1 > 16 * kBiasSteps) return false;
  WinParams p{};
  p.S = S;
  p.H = H;
  p.win = win;
  p.keys = keys;
  p.kh_valid = kh;
  p.kw_valid = kw;
  p.n_items = B * (S / win) * H;
  p.n_tiles = (win + 63) / 64;
  p.kh = kh;
  p.kw = kw;
  p.bias_bulk = biased && (win * kh * 2) % 16 == 0 && (win * kw * 2) % 16 == 0;
  p.q_bytes = p.n_tiles * kTileBytes;
  p.kv_bytes = n * 128;
  p.scale_log2 = scale * vdr::kLog2e;
  p.inv_scale = inv;
  auto layout = [&]() {
    p.bh_bytes = p.bias_bulk ? win * kh * 2 : 0;
    const int bw_bytes = p.bias_bulk ? win * kw * 2 : 0;
    p.buf_bytes =
        round_up(p.q_bytes + 2 * p.kv_bytes + p.bh_bytes + bw_bytes, 1024);
  };
  auto bytes = [&](int nbuf) {
    return (size_t)1024 + (size_t)n * 128 + (size_t)nbuf * p.buf_bytes;
  };
  layout();
  p.nbuf = kBuffers;
  if (p.bias_bulk && bytes(p.nbuf) > (size_t)kSmemMax) {
    p.bias_bulk = 0;
    layout();
  }
  while (p.nbuf > 1 && bytes(p.nbuf) > (size_t)kSmemMax) --p.nbuf;
  if (bytes(p.nbuf) > (size_t)kSmemMax) return false;
  *smem = bytes(p.nbuf);
  *wp = p;
  return true;
}

// 2-D map (width columns, rows) of a row-major bf16 tensor: boxes of 64
// columns (one head, 128 bytes: the 128-byte swizzle) x box_rows rows.
inline bool tensor_map_2d(CUtensorMap* map, const void* ptr, int width,
                          int rows, int box_rows) {
  return tensor_map_2d_sw128(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr,
                             width, rows, 64, box_rows);
}

// Launch a persistent kernel of the body (one block an SM, or as many as
// there are items).
template <typename Kernel, typename... Args>
int launch(Kernel kern, int n_items, size_t smem, cudaStream_t stream,
           const Args&... args) {
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
  const int grid = min(n_items, sms * per_sm);
  kern<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace win
}  // namespace sm90
}  // namespace vdr
