// The Hopper body of the port's global-attention forwards: K2
// (fused_global_attention.cu, inference) and the K5 forward
// (global_attention_fwd_lse.cu, `fast` fine-tuning), one kernel template.
//
// Computes, per (batch row, head) and 64 * kConsumers query rows,
//     softmax(q k^T D^-1/2 + bias_h[q, j / Kw] + bias_w[q, j % Kw]) v
// over all S keys, with the decomposed bias optional (Kw = 64 NW) and an
// optional kv_len key-padding mask. Layouts: q (B, S, H*D), kv
// (B, S, 2*H*D), per-head bias (B, H, S, Kh) and (B, H, S, Kw), output
// (B, S, H*D). Config::kLse (the K5 forward) also writes each row's
// log-sum-exp in log2 units, lse (B, H, S) fp32, and scores as the K5
// backward rebuilds a score (global_attention_bwd_dq.cu,
// global_attention_bwd_dkv.cu): Q^ = bf16(q * D^-1/2 * log2 e) formed once,
// S = Q^ K^T, the bias terms times log2 e in fp32 (never contracted), keys
// at or past kv_len at -1e30 log2 e. K2 multiplies the fp32 Q K^T by
// D^-1/2 log2 e instead, and masks at -1e30.
//
// The design (bf16, D 64):
//  * warp specialisation: one producer thread keeps 64-key K and V tiles in
//    flight with TMA (cp.async.bulk.tensor, 128-byte swizzle) in a ring of
//    kStages shared-memory stages guarded by mbarriers; the copies never
//    wait on the products;
//  * kConsumers consumer warpgroups of 64 query rows run wgmma: S = Q K^T
//    with Q's A fragments held in registers (loaded once from the TMA tile)
//    and K read from shared memory, and O += P V with P taken from the
//    score registers (rounded to bf16 in place) and V read from shared
//    memory as an MN-major operand. Each warpgroup issues QK^T of tile j
//    together with PV of tile j-1 and runs tile j's softmax while PV is on
//    the tensor cores; the warpgroups take turns to issue (named barriers),
//    so one's softmax runs under the others' products;
//  * the softmax stays online in log2 units in fp32 registers with a
//    running max that moves only when a row's max grows by more than 2^8
//    (O is rescaled on those tiles alone); the l > 0 guard stays, so a row
//    with no valid key averages V over its S keys, as the plain version
//    does (K2: masked scores and the first max at -1e30; kLse: masked
//    scores at -1e30 log2 e and the first max below them, so such a row
//    gets the plain version's lse, -1e30 log2 e + log2 S);
//  * the bias without per-score lookups: Kw is 64 or 128, so a 64-key
//    tile lies inside one key-grid row. Each thread keeps its rows' bias_w
//    columns in registers, and reads one bias_h scalar per row and tile
//    from a table staged once per block; both are pre-multiplied by
//    log2(e). At Kw 128 an instance keeps both column sets (K2), or keeps
//    one and visits the even key tiles (grid columns 0-63) before the odd
//    ones (64-127), swapping the set once between them (the K5 forward,
//    whose registers hold no second set); an online softmax does not
//    depend on the order in which it visits the keys;
//  * kv_len: tiles wholly past kv_len are never loaded, the ragged tile is
//    masked; rows past S read zeros (TMA fills out-of-bounds boxes) and are
//    never stored.
// The consumer pieces (Q fragments, the products of a tile, the softmax,
// the store) are in hopper_flash.cuh, shared with K3's Hopper kernel.
#pragma once

#include "hopper_flash.cuh"

namespace vdr {
namespace sm90 {
namespace gfwd {

// Consumers: consumer warpgroups (64 query rows each); Stages: K/V ring
// depth; BiasSets: the bias_w register sets of a Kw 128 instance, 2 (both
// halves of a grid row) or 1 (the even key tiles before the odd ones, the
// set swapped once); Lse: the K5 forward's scoring and lse store.
template <int Consumers, int Stages, int BiasSets, bool Lse>
struct Config {
  static constexpr int kConsumers = Consumers;
  static constexpr int kStages = Stages;
  static constexpr int kBiasSets = BiasSets;
  static constexpr bool kLse = Lse;
  static constexpr int kBQ = 64 * Consumers;          // query rows a block
  static constexpr int kThreads = 128 * (Consumers + 1);  // + 1 producer WG
  static constexpr int kBiasLd = kBQ + 1;             // bias_h row (skew)
};

constexpr int kD = kFlashD;                // head dim (the only build)
constexpr int kBK = 64;                    // keys per tile
constexpr int kTile = 64 * kD * 2;         // one 64 x 64 bf16 tile (8 KB)
// registers a thread after setmaxnreg: the producer gives its share to the
// consumers (64 K registers an SM, one block)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;

struct Params {
  const __nv_bfloat16* bias_h;  // (B, H, S, kh) or nullptr
  const __nv_bfloat16* bias_w;  // (B, H, S, kw) or nullptr
  const int* kv_len;            // (B,) or nullptr
  __nv_bfloat16* out;           // (B, S, H*D)
  float* lse;                   // (B, H, S) log2 units (kLse), or nullptr
  int S, H, kh, kw;
  float scale_log2;             // D^-1/2 * log2(e)
};

// A bias term in log2 units; kLse as the K5 backward stages it (a product
// never contracted into a later add)
template <bool kLse>
__device__ __forceinline__ float bias_term(float x) {
  return kLse ? __fmul_rn(x, vdr::kLog2e) : x * vdr::kLog2e;
}

// Q's A fragments scaled by s in fp32 and rounded to bf16 once (Q^): the
// scores the K5 backward rebuilds (q_frags' layout)
__device__ __forceinline__ void q_frags_scaled(
    uint32_t (&qa)[kFlashD / 16][4], const unsigned char* tile, int warp,
    int g, int c, float s) {
  q_frags(qa, tile, warp, g, c);
#pragma unroll
  for (int kk = 0; kk < kFlashD / 16; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
          &qa[kk][f]);
      qa[kk][f] = vdr::pack_bf16(__low2float(v) * s, __high2float(v) * s);
    }
}

// NW: bias_w register sets, Kw / 64 (0 = no bias). Halves (NW 1 at Kw
// 128): the even key tiles first, then the odd ones, on one set.
template <int NW, class Cfg, bool Halves = false>
__global__ void __launch_bounds__(Cfg::kThreads, 1)
    global_fwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tkv,
                             const Params p) {
  constexpr int kConsumers = Cfg::kConsumers, kStages = Cfg::kStages;
  constexpr int kBQ = Cfg::kBQ, kBiasLd = Cfg::kBiasLd;
  constexpr bool kLse = Cfg::kLse;
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
  const int n_even = (n_tiles + 1) / 2;  // Halves: the tiles of columns 0-63

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
        const int key0 = key_tile<Halves>(j, n_even) * kBK;
        mbar_expect_tx(&full[st], 2 * kTile);
        tma_load(k_addr + st * kTile, &tkv, &full[st], h * kD, key0, b);
        tma_load(v_addr + st * kTile, &tkv, &full[st], C + h * kD, key0, b);
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
    // bias_w columns col0 .. col0 + 63 of the thread's rows into set w
    auto load_bw = [&](int w, int col0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int R = row0 + (half ? r_hi : r_lo);
          float lo = 0.f, hi = 0.f;
          if (R < p.S) {
            const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
                p.bias_w + (head_row + R) * p.kw + col0 + i * 8 + 2 * c);
            lo = bias_term<kLse>(__low2float(v));
            hi = bias_term<kLse>(__high2float(v));
          }
          bw[w][i][2 * half] = lo;
          bw[w][i][2 * half + 1] = hi;
        }
      }
    };
    if constexpr (NW > 0) {
      // bias_h of this warpgroup's 64 rows, transposed to [grid row][row]
      for (int i = t; i < 64 * p.kh; i += 128) {
        const int r = wg * 64 + i / p.kh, kr = i % p.kh;
        const int R = row0 + r;
        bias_s[kr * kBiasLd + r] =
            R < p.S ? bias_term<kLse>(__bfloat162float(
                          p.bias_h[(head_row + R) * p.kh + kr]))
                    : 0.f;
      }
      // bias_w: column set w covers columns 64w .. 64w + 63 of the grid row
      // (Halves: set 0 the even tiles' columns first)
#pragma unroll
      for (int w = 0; w < NW; ++w) load_bw(w, 64 * w);
      bar_sync(1 + wg, 128);
    }

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    // kLse: the first max below the masked score, so that a row with no
    // valid key moves it there and takes p = 1 per key
    constexpr float kM0 = kLse ? vdr::kPastEnd : vdr::kNegInf;
    Rows st{kM0, kM0, 0.f, 0.f, 1.f, 1.f};
    float s[32];
    uint32_t pa[4][4];
    // step j's scores (key tile kt) -> probabilities, in place
    auto probs = [&](int j) {
      const int kt = key_tile<Halves>(j, n_even), k0 = kt * kBK;
      float bh_lo = 0.f, bh_hi = 0.f;
      int set = 0;
      if constexpr (NW > 0) {
        const int kr = Halves ? kt / 2 : k0 / p.kw;
        bh_lo = bias_s[kr * kBiasLd + r_lo];
        bh_hi = bias_s[kr * kBiasLd + r_hi];
        if constexpr (!Halves) set = (k0 % p.kw) / 64;
      }
      const bool ragged = k0 + kBK > lim;
      // a constant register-set index in each branch: no local memory
      if (NW == 2 && set)
        tile_probs<kBK, NW, Cfg::kLse>(s, bw[NW == 2 ? 1 : 0],
                                       p.scale_log2, bh_lo, bh_hi,
                                       k0 + 2 * c, ragged, lim, p.S, st);
      else
        tile_probs<kBK, NW, Cfg::kLse>(s, bw[0], p.scale_log2, bh_lo, bh_hi,
                                       k0 + 2 * c, ragged, lim, p.S, st);
    };
    // ping-pong: the warpgroups issue their products in turn, each after
    // the one before it, so one's softmax runs under the others' products
    // (named barriers 1 .. kConsumers serve the bias staging above)
    const int my_bar = 1 + kConsumers + wg;
    const int next_bar = 1 + kConsumers + (wg + 1) % kConsumers;
    if (wg == kConsumers - 1) bar_arrive(next_bar, 256);
    mbar_wait(&qbar, 0);
    uint32_t qa[kD / 16][4];
    if constexpr (kLse)
      q_frags_scaled(qa, base + wg * kTile, warp, g, c, p.scale_log2);
    else
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
    auto step = [&](int j) {
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
    };
    if constexpr (Halves) {
      // the even tiles, then the odd ones, whose bias_w columns come in
      // between the two loops (no product in flight, none issued under the
      // branch, and no reload code inside either loop)
      for (int j = 1; j < n_even; ++j) step(j);
      if (n_even < n_tiles) load_bw(0, 64);
      for (int j = n_even; j < n_tiles; ++j) step(j);
    } else {
      for (int j = 1; j < n_tiles; ++j) step(j);
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
    if constexpr (kLse)
      store_lse(p.lse + head_row, row0 + r_lo, row0 + r_hi, p.S, c, st);
  }
}

template <class Cfg>
constexpr size_t smem_bytes(int kh) {
  return 1024 + (size_t)(Cfg::kConsumers + 2 * Cfg::kStages) * kTile +
         (size_t)kh * Cfg::kBiasLd * sizeof(float);
}

// The bias grids an instance takes: rows of 64 or 128 keys (two bias_w
// register sets, or one and the halves order), and a bias_h table that
// fits.
template <class Cfg>
bool takes_bias(int kh, int kw) {
  return (kw == 64 || kw == 128) && smem_bytes<Cfg>(kh) <= 227 * 1024;
}

template <int NW, class Cfg, bool Halves = false>
int launch_nw(const CUtensorMap& tq, const CUtensorMap& tkv, const Params& p,
              int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<Cfg>(NW > 0 ? p.kh : 0);
  auto kern = global_fwd_hopper_kernel<NW, Cfg, Halves>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + Cfg::kBQ - 1) / Cfg::kBQ, p.H, B);
  kern<<<grid, Cfg::kThreads, smem, stream>>>(tq, tkv, p);
  return (int)cudaGetLastError();
}

// Launch on q (B, S, H*64) and kv (B, S, 2*H*64), bf16, for a call the
// caller has checked (no bias, or takes_bias<Cfg>). Returns 0, a
// cudaError_t, or err_map when a TMA descriptor cannot be made.
template <class Cfg>
int launch(const void* q, const void* kv, const Params& p, int B,
           cudaStream_t stream, int err_map) {
  CUtensorMap tq, tkv;
  if (!tensor_map_64(&tq, q, p.H * kD, p.S, B) ||
      !tensor_map_64(&tkv, kv, 2 * p.H * kD, p.S, B))
    return err_map;
  if (p.bias_h == nullptr) return launch_nw<0, Cfg>(tq, tkv, p, B, stream);
  if (p.kw == 128) {
    if constexpr (Cfg::kBiasSets >= 2)
      return launch_nw<2, Cfg>(tq, tkv, p, B, stream);
    else
      return launch_nw<1, Cfg, true>(tq, tkv, p, B, stream);
  }
  return launch_nw<1, Cfg>(tq, tkv, p, B, stream);
}

}  // namespace gfwd
}  // namespace sm90
}  // namespace vdr
