// K4: backward of trainable window attention for SAM's windowed layers.
//
// Replaces: vit_deep_radiomics_tpu/ops/attention_grad.py::_window_bwd_kernel
// (the backward of window_attention_trainable, a Pallas TPU kernel).
//
// The token axis is a concatenation of independent windows of `win` tokens
// (196 = 14 x 14 for SAM ViT-B/16). Per (window, head), with the softmax
// recomputed exactly (max kept) as the forward (K1) computed it:
//     D  = sum_d dO * O        dP = dO V^T        dS = P * (dP - D)
//     dq = D^-1/2 dS K         dk = D^-1/2 dS^T Q  dv = P^T dO
//     dbias_h[i, r], dbias_w[i, c]: sums of dS over the keys of grid row r,
//                                   grid column c
// written as dq (B, S, H*D), dkv (B, S, 2*H*D), dbias_h (B, H, S, kh) and
// dbias_w (B, H, S, kw), each element once: no accumulation across blocks,
// no atomics.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the
// fine-tuning path's shapes (50 windows x 196 tokens x 12 heads of 64) the
// minimal work is 10 S^2 D per window and head = 14.7 GFLOP (0.015 ms)
// against about 134 MB of compulsory traffic (q, kv, both bias arrays, O
// and dO read, dq, dkv and both bias gradients written: 0.040 ms), so it
// is memory-bound. The first loops (4 warps a (window, head) block, plain
// loads then compute then stores, mma.sync, the bias gradients summed in
// shared memory by the lanes of a row in turns; 108 KB, two blocks an SM)
// ran at 24x that bound.
//
// What the design does about it (bf16, windows of at most 208 tokens, at
// most 63 bias terms, 1/scale a power of two: every SAM config, whose
// windows are 14 x 14 at every image size), the shape of K1's Hopper
// forward:
//  * one (window, head) is one work item, done whole; persistent blocks
//    (one an SM) of two warpgroups walk over the items. One thread brings
//    Q, K, V and dO of an item by TMA: 3-D tensor maps (64 columns, the
//    window's rows, the windows), boxes of 64 columns x the padded window
//    (64 or 208 rows) with 128-byte swizzle, so rows past the window read
//    as zeros and no copy touches the next window; the item's bias rows
//    come with them by bulk copy. The next item's copies start once both
//    warpgroups are done with the current one (one item fills 176 KB at
//    208 keys; a second buffer of Q and dO, which fits there, measured no
//    faster). No producer warpgroup: at 384 threads ptxas holds every
//    thread to 168 registers whatever setmaxnreg asks, and phase A spilled
//    there; at 256 threads the kernel takes 244 (N = 208) with no spill;
//  * the decomposed bias is a product, as in K1: a bias tile [query][64
//    terms] (bias_h, bias_w, a mask term 1, zeros), built by the warpgroups
//    from the staged bias rows once per item, times the constant expand
//    matrix E (E^T [key][term]: 1/scale where key j takes term t, the mask
//    term -1e30 / (scale log2 e) on keys past the window), so the
//    recomputed scores are K1's forward's up to rounding;
//  * phase A (query-major: 64-row query tiles, alternating between the
//    warpgroups): S = Q K^T + bias E over all the window's keys, one wgmma
//    chain of N = the window padded to 64 or 208 keys; the softmax in one
//    pass in fp32 (row max, exp2, row sum; P normalised in registers, the
//    row's log2 lse kept in shared memory for phase B); D from dO (shared
//    memory) and O (global, loaded under the score products); dP = dO V^T
//    in key chunks (N = 104 at 208 keys) and dS = P (dP - D) in place in
//    P's registers; dS rounded to bf16 as the register A operand of
//    dq = dS K and of the bias gradients dS E (JAX: ds_c @ expands.T),
//    both on wgmma;
//  * phase B (key-major: 64-key tiles, alternating): per 64-query chunk
//    (16 for the last rows of a 208-row window), S^T = K Q^T + E^T bias^T
//    and dP^T = V dO^T on wgmma, P^T from the rows' lse, dS^T =
//    P^T (dP^T - D), then dv += P^T dO and dk += dS^T Q with P^T and dS^T
//    as register A operands. Phase B recomputes the scores: staging P and
//    dS of a window in bf16 would take 2 x 256 x 208 x 2 bytes = 213 KB;
//  * outputs go from registers to device memory once, rows past the
//    window dropped. Every sum runs in a fixed order: two runs give the
//    same bits.
// Windows of more than 208 tokens, more than 63 bias terms and other
// scales keep the first loops below (a 256-key instance, 16 x 16 windows,
// held 128 score registers and spilled 52-188 bytes however D and dP were
// placed); vdr_window_attention_bwd_route reports the choice, which the C
// entry makes by shape alone.

#include <math.h>

#include "attention_bwd_core.cuh"

namespace {
using vdr::bf16;

// ---------------------------------------------------------------------------
// First loops (mma.sync): windows of more than 208 tokens or more than 63
// bias terms, and scales whose inverse is not a power of two. K1 takes its
// first loops for the same calls, so these recompute the scores as those
// do: q pre-scaled by D^-1/2 log2 e and rounded to bf16 once, the bias
// terms times log2 e in fp32. One block owns one (window, head): phase A
// (a warp owns 16 query rows) recomputes each row's softmax, D, dP, dS,
// dq and the bias gradients (summed in shared memory, the lanes that
// share a row taking turns); phase B (a warp owns 16 keys) recomputes S^T
// and P^T from phase A's residuals, dk and dv.
// ---------------------------------------------------------------------------

constexpr int D = 64;
constexpr int LD = D + 8;
constexpr int NW = 4;   // warps per block

struct Layout {
  int sp, bs, nt;   // padded rows, bias-term stride, bias terms (kh + kw)
  size_t tiles, ktab, bias, dbias, res, total;
};

__host__ __device__ inline Layout layout(int seg, int kh, int kw) {
  Layout l;
  l.sp = (seg + 15) / 16 * 16;
  l.bs = l.sp + 4;
  l.nt = kh + kw;
  l.tiles = 0;                                              // [2][sp][LD]
  l.ktab = l.tiles + 2 * (size_t)l.sp * LD * sizeof(bf16);  // [sp] int2
  l.bias = l.ktab + (size_t)l.sp * sizeof(int2);            // [nt][bs]
  l.dbias = l.bias + (size_t)l.nt * l.bs * sizeof(float);   // [sp][nt]
  l.res = l.dbias + (size_t)l.sp * l.nt * sizeof(float);    // [2][sp]
  l.total = l.res + 2 * (size_t)l.sp * sizeof(float);
  return l;
}

__global__ void __launch_bounds__(NW * 32)
    window_bwd_kernel(vdr::AttnParams p, vdr::GradParams gp) {
  using namespace vdr;
  extern __shared__ __align__(16) char smem[];
  const Layout L = layout(p.seg, p.kh, p.kw);
  bf16* tile0 = reinterpret_cast<bf16*>(smem + L.tiles);   // K, then Q
  bf16* tile1 = tile0 + L.sp * LD;                          // V, then dO
  int2* ktab = reinterpret_cast<int2*>(smem + L.ktab);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  float* dbias_s = reinterpret_cast<float*>(smem + L.dbias);
  float* lse_s = reinterpret_cast<float*>(smem + L.res);
  float* dl_s = lse_s + L.sp;

  const int seg = p.seg, sp = L.sp, bs = L.bs, nt_terms = L.nt;
  const Tile t = tile_of(p, sp);   // one block per (window, head)
  const int C = p.H * D;
  const bool has_bias = p.bias_h != nullptr;
  const size_t rowbase = ((size_t)t.b * p.S + t.seg0) * C + t.h * D;
  const bf16* q = static_cast<const bf16*>(p.q) + rowbase;
  const bf16* kv = static_cast<const bf16*>(p.kv) +
                   ((size_t)t.b * p.S + t.seg0) * (2 * C) + t.h * D;
  const bf16* dout = gp.dout + rowbase;
  const bf16* out = gp.out + rowbase;

  // K and V of the window, the key table and the bias terms (all rows)
  load_tile64<LD>(tile0, kv, 2 * C, seg, sp);
  load_tile64<LD>(tile1, kv + C, 2 * C, seg, sp);
  for (int j = threadIdx.x; j < sp; j += blockDim.x)
    ktab[j] = has_bias && j < seg ? make_int2(j / p.kw, p.kh + j % p.kw)
                                  : make_int2(0, 0);
  if (has_bias) {
    const size_t brow = ((size_t)t.b * p.H + t.h) * p.S + t.seg0;
    const bf16* bh = static_cast<const bf16*>(p.bias_h) + brow * p.kh;
    const bf16* bw = static_cast<const bf16*>(p.bias_w) + brow * p.kw;
    for (int i = threadIdx.x; i < sp * p.kh; i += blockDim.x) {
      const int r = i / p.kh, col = i % p.kh;
      bias_s[col * bs + r] = r < seg ? to_f32(bh[i]) * kLog2e : 0.f;
    }
    for (int i = threadIdx.x; i < sp * p.kw; i += blockDim.x) {
      const int r = i / p.kw, col = i % p.kw;
      bias_s[(p.kh + col) * bs + r] = r < seg ? to_f32(bw[i]) * kLog2e : 0.f;
    }
    for (int i = threadIdx.x; i < sp * nt_terms; i += blockDim.x)
      dbias_s[i] = 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int nstrips = sp / 16;

  // ---- phase A: query rows; softmax residuals, dq and the bias grads ----
  for (int strip = warp; strip < nstrips; strip += NW) {
    const int r_lo = strip * 16 + g, r_hi = r_lo + 8;
    uint32_t qa[4][4], da[4][4];
    load_a64<true>(qa, q, C, r_lo, r_hi, seg, c, p.scale_log2);
    load_a64<false>(da, dout, C, r_lo, r_hi, seg, c, 1.f);
    // D = sum_d dO * O: this lane's 16 columns, then the row's 4 lanes
    float dl_lo = 0.f, dl_hi = 0.f;
#pragma unroll
    for (int d = c * 16; d < c * 16 + 16; d += 2) {
      if (r_lo < seg) {
        const float2 o = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(out + r_lo * C + d));
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + r_lo * C + d));
        dl_lo += o.x * x.x + o.y * x.y;
      }
      if (r_hi < seg) {
        const float2 o = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(out + r_hi * C + d));
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + r_hi * C + d));
        dl_hi += o.x * x.x + o.y * x.y;
      }
    }
    dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, 1);
    dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, 2);
    dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, 1);
    dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, 2);

    // scores of 16 keys (two n8 tiles) from k0 for this strip
    auto scores = [&](int k0, float s[2][4]) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        s[u][0] = s[u][1] = s[u][2] = s[u][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          uint32_t b[2];
          ld_b_rows(b, tile0 + (k0 + u * 8 + g) * LD + kt * 16 + 2 * c);
          mma_bf16_16816(s[u], qa[kt], b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + u * 8 + 2 * c + (e & 1);
          float v = s[u][e];
          if (j >= seg) {
            v = kNegInf;
          } else if (has_bias) {
            const int2 kt = ktab[j];
            const int r = e < 2 ? r_lo : r_hi;
            v += bias_s[kt.x * bs + r] + bias_s[kt.y * bs + r];
          }
          s[u][e] = v;
        }
      }
    };

    // pass 1: exact row max and sum (log2 units), as the forward's
    float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
    for (int k0 = 0; k0 < sp; k0 += 16) {
      float s[2][4];
      scores(k0, s);
      float mx_lo = fmaxf(m_lo, fmaxf(fmaxf(s[0][0], s[0][1]),
                                      fmaxf(s[1][0], s[1][1])));
      float mx_hi = fmaxf(m_hi, fmaxf(fmaxf(s[0][2], s[0][3]),
                                      fmaxf(s[1][2], s[1][3])));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      l_lo *= exp2f(m_lo - mx_lo);
      l_hi *= exp2f(m_hi - mx_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        l_lo += exp2f(s[u][0] - m_lo) + exp2f(s[u][1] - m_lo);
        l_hi += exp2f(s[u][2] - m_hi) + exp2f(s[u][3] - m_hi);
      }
    }
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
    const float lse_lo = m_lo + log2f(l_lo), lse_hi = m_hi + log2f(l_hi);
    if (c == 0) {
      lse_s[r_lo] = lse_lo;
      lse_s[r_hi] = lse_hi;
      dl_s[r_lo] = dl_lo;
      dl_s[r_hi] = dl_hi;
    }

    // pass 2: dS, dq and the bias gradients
    float dq[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
    for (int k0 = 0; k0 < sp; k0 += 16) {
      float s[2][4], dp[2][4], ds[2][4];
      scores(k0, s);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        dp[u][0] = dp[u][1] = dp[u][2] = dp[u][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          uint32_t b[2];
          ld_b_rows(b, tile1 + (k0 + u * 8 + g) * LD + kt * 16 + 2 * c);
          mma_bf16_16816(dp[u], da[kt], b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          const float pv = exp2f(s[u][e] - (lo ? lse_lo : lse_hi));
          ds[u][e] = pv * (dp[u][e] - (lo ? dl_lo : dl_hi));
        }
        if (has_bias) {
          // the 4 lanes of a row group take turns, so every row's sums
          // run in one fixed order (reproducible, no atomics); keys j and
          // j+1 (j even) share one add when they share a grid row
          for (int turn = 0; turn < 4; ++turn) {
            if (c == turn) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int r = half ? r_hi : r_lo;
                const int j = k0 + u * 8 + 2 * c;
                const float d0 = ds[u][2 * half], d1 = ds[u][2 * half + 1];
                if (r >= seg || j >= seg) continue;
                float* row = dbias_s + r * nt_terms;
                const int2 t0 = ktab[j];
                row[t0.y] += d0;
                if (j + 1 < seg) {
                  const int2 t1 = ktab[j + 1];
                  row[t1.y] += d1;
                  if (t1.x == t0.x) {
                    row[t0.x] += d0 + d1;
                  } else {
                    row[t0.x] += d0;
                    row[t1.x] += d1;
                  }
                } else {
                  row[t0.x] += d0;
                }
              }
            }
            __syncwarp();
          }
        }
      }
      uint32_t a[4];
      c_to_a(a, ds);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        uint32_t b[2];
        ld_b_cols(b, tile0 + (k0 + 2 * c) * LD + dt * 8 + g, LD);
        mma_bf16_16816(dq[dt], a, b);
      }
    }
    store_c64(gp.dq + rowbase, C, dq, r_lo, r_hi, seg, c, gp.scale);
  }
  __syncthreads();

  // ---- phase B: keys; dk and dv ----
  load_tile64<LD>(tile0, q, C, seg, sp);      // Q (unscaled)
  load_tile64<LD>(tile1, dout, C, seg, sp);   // dO
  __syncthreads();
  for (int strip = warp; strip < nstrips; strip += NW) {
    const int key_lo = strip * 16 + g, key_hi = key_lo + 8;
    uint32_t ka[4][4], va[4][4];
    load_a64<false>(ka, kv, 2 * C, key_lo, key_hi, seg, c, 1.f);
    load_a64<false>(va, kv + C, 2 * C, key_lo, key_hi, seg, c, 1.f);
    const int2 kt_lo = ktab[key_lo], kt_hi = ktab[key_hi];
    float dk[8][4], dv[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
      dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
    }
    for (int q0 = 0; q0 < sp; q0 += 16) {
      float st[2][4], dpt[2][4], pt[2][4], dst[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        st[u][0] = st[u][1] = st[u][2] = st[u][3] = 0.f;
        dpt[u][0] = dpt[u][1] = dpt[u][2] = dpt[u][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          uint32_t bq[2], bd[2];
          ld_b_rows_scaled(
              bq, tile0 + (q0 + u * 8 + g) * LD + kt * 16 + 2 * c,
              p.scale_log2);
          mma_bf16_16816(st[u], ka[kt], bq);
          ld_b_rows(bd, tile1 + (q0 + u * 8 + g) * LD + kt * 16 + 2 * c);
          mma_bf16_16816(dpt[u], va[kt], bd);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q0 + u * 8 + 2 * c + (e & 1);
          const bool lo = e < 2;
          float pv = 0.f;
          if (i < seg && (lo ? key_lo : key_hi) < seg) {
            float v = st[u][e];
            if (has_bias) {
              const int2 kt = lo ? kt_lo : kt_hi;
              v += bias_s[kt.x * bs + i] + bias_s[kt.y * bs + i];
            }
            pv = exp2f(v - lse_s[i]);
          }
          pt[u][e] = pv;
          dst[u][e] = pv * (dpt[u][e] - dl_s[i]);
        }
      }
      uint32_t pa[4], sa[4];
      c_to_a(pa, pt);
      c_to_a(sa, dst);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        uint32_t b[2];
        ld_b_cols(b, tile1 + (q0 + 2 * c) * LD + dt * 8 + g, LD);
        mma_bf16_16816(dv[dt], pa, b);
        ld_b_cols(b, tile0 + (q0 + 2 * c) * LD + dt * 8 + g, LD);
        mma_bf16_16816(dk[dt], sa, b);
      }
    }
    bf16* dkv = gp.dkv + ((size_t)t.b * p.S + t.seg0) * (2 * C) + t.h * D;
    store_c64(dkv, 2 * C, dk, key_lo, key_hi, seg, c, gp.scale);
    store_c64(dkv + C, 2 * C, dv, key_lo, key_hi, seg, c, 1.f);
  }

  // ---- the bias gradients, in the bias layout ----
  if (!has_bias) return;
  __syncthreads();
  const size_t brow = ((size_t)t.b * p.H + t.h) * p.S + t.seg0;
  for (int i = threadIdx.x; i < seg * p.kh; i += blockDim.x)
    gp.dbh[brow * p.kh + i] =
        __float2bfloat16(dbias_s[(i / p.kh) * nt_terms + i % p.kh]);
  for (int i = threadIdx.x; i < seg * p.kw; i += blockDim.x)
    gp.dbw[brow * p.kw + i] =
        __float2bfloat16(dbias_s[(i / p.kw) * nt_terms + p.kh + i % p.kw]);
}


// ---------------------------------------------------------------------------
// Hopper body: persistent blocks of two wgmma warpgroups, TMA copies
// ---------------------------------------------------------------------------

using namespace vdr::sm90;

constexpr int kD = 64;                   // head dim (the only build)
constexpr int kConsumers = 2;            // warpgroups a block
constexpr int kThreads = 128 * kConsumers;
// the bias rows come by bulk copy with the item's tiles (1) when 16-byte
// aligned, else straight from device memory into the bias tile (0)
constexpr int kBiasBulk = 1;
constexpr int kTerms = 64;               // a row of E^T and of the bias tile
constexpr int kTile = 64 * kD * 2;       // 64 rows of one head (8 KB)
constexpr int kMaxRows = 256;            // rows of lse and D (4 tiles)
constexpr int kSmemMax = 227 * 1024;
constexpr int kErrTensorMap = -3;        // cuTensorMapEncodeTiled failed

struct HopperParams {
  const bf16* bias_h;  // (B, H, S, kh) or nullptr
  const bf16* bias_w;  // (B, H, S, kw) or nullptr
  const bf16* out;     // (B, S, H*D) the forward's output
  bf16* dq;            // (B, S, H*D)
  bf16* dkv;           // (B, S, 2*H*D)
  bf16* dbh;           // (B, H, S, kh) or nullptr
  bf16* dbw;           // (B, H, S, kw) or nullptr
  int S, H, win, n_items, n_tiles, kh, kw;
  int rows;            // rows a tile buffer holds: the keys of the scores
  int bias_bulk;       // the bias rows arrive by bulk copy
  int raw_h, raw_w;    // their bytes: win * kh * 2, win * kw * 2
  float scale;         // D^-1/2
  float scale_log2;    // scale * log2(e)
  float inv_scale;     // 1 / scale, a power of two
};

// Shared memory after the 1024-byte aligned base: E^T, the bias tile, K,
// V, Q and dO (rows x 128 bytes each, swizzled as TMA writes them), room
// for the rows a 64-row tile reads past the last buffer, lse and D per
// query row (fp32), then the item's bias rows as they lie in device memory
// (bias_bulk). A 64-row tile past `rows` reads the next buffer's first
// rows: they only feed output rows past the window, which are never
// stored.
__host__ __device__ inline int slack_rows(int rows) {
  return (rows + 63) / 64 * 64 - rows;
}

__host__ __device__ inline size_t smem_bytes(int rows, int raw_bytes) {
  return 1024 + (size_t)6 * rows * 128 + (size_t)slack_rows(rows) * 128 +
         2 * kMaxRows * sizeof(float) + raw_bytes;
}

// The regions by shared-window address (32 bits each: what stays live in
// registers through the phases); generic pointers are made where used.
struct Smem {
  uint32_t e, cat, k, v, q, dout, lse, dl, raw;
};

__device__ __forceinline__ Smem smem_of(unsigned char* base,
                                        const HopperParams& p) {
  const uint32_t b = smem_u32(base), t = p.rows * 128;
  Smem s;
  s.e = b;
  s.cat = b + t;
  s.k = b + 2 * t;
  s.v = b + 3 * t;
  s.q = b + 4 * t;
  s.dout = b + 5 * t;
  s.lse = b + 6 * t + slack_rows(p.rows) * 128;
  s.dl = s.lse + kMaxRows * 4;
  s.raw = s.dl + kMaxRows * 4;
  return s;
}

// A generic pointer to the shared-window address a.
template <typename T>
__device__ __forceinline__ T* at(uint32_t a) {
  return static_cast<T*>(__cvta_shared_to_generic(a));
}

// Descriptor of k16 step kt of an MN-major B operand (rows of 128 bytes,
// the k index on the rows: K and E^T in phase A, dO and Q in phase B).
__device__ __forceinline__ uint64_t mn_desc(uint32_t base, int kt) {
  return desc_sw128(base + kt * 2048, 1024, 1024);
}

// The swizzled 16-byte chunk `chunk` of row r of a 128-byte-row tile.
__device__ __forceinline__ int chunk_at(int r, int chunk) {
  return r * 128 + ((chunk ^ (r & 7)) * 16);
}

// First of the item's rows in the per-head bias layout (B, H, S, K).
__device__ __forceinline__ size_t bias_row(const HopperParams& p, int item) {
  const int row = (item / p.H) * p.win;   // in the (B * S) token rows
  return ((size_t)(row / p.S) * p.H + item % p.H) * p.S + row % p.S;
}

// E^T (key j, term t), once per block: 1/scale where key j (< win) takes
// term t; the mask term nt = kh + kw: 0 on the window's keys, -1e30 /
// (scale log2 e) past it.
__device__ void build_expand(const HopperParams& p, unsigned char* e) {
  const int nt = p.kh + p.kw;
  const bf16 one = __float2bfloat16(p.inv_scale);
  const bf16 zero = __float2bfloat16(0.f);
  const bf16 mask = __float2bfloat16(vdr::kNegInf / p.scale_log2);
  for (int i = threadIdx.x; i < p.rows * 8; i += kThreads) {
    const int j = i / 8, chunk = i % 8;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int tt = chunk * 8 + x;
      const bool on = j < p.win && ((tt < p.kh && j / p.kw == tt) ||
                                    (tt >= p.kh && tt < nt &&
                                     j % p.kw == tt - p.kh));
      v[x] = tt == nt ? (j < p.win ? zero : mask) : (on ? one : zero);
    }
    *reinterpret_cast<uint4*>(e + chunk_at(j, chunk)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// The item's bias tile [query r][term t]: bias_h, then bias_w, then the
// mask term 1 (on every row), zeros; rows past the window hold only the 1.
// The bias rows are read from shared memory (bias_bulk) or device memory.
__device__ void build_bias_tile(const HopperParams& p, const Smem& sm,
                                int item, unsigned char* cat) {
  const int nt = p.kh + p.kw;
  const bf16* bh = nullptr;
  const bf16* bw = nullptr;
  if (p.bias_bulk) {
    bh = at<const bf16>(sm.raw);
    bw = at<const bf16>(sm.raw + p.raw_h);
  } else if (p.bias_h != nullptr) {
    const size_t r0 = bias_row(p, item);
    bh = p.bias_h + r0 * p.kh;
    bw = p.bias_w + r0 * p.kw;
  }
  const bf16 one = __float2bfloat16(1.f), zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < p.rows * 8; i += kThreads) {
    const int r = i / 8, chunk = i % 8;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int tt = chunk * 8 + x;
      bf16 val = tt == nt ? one : zero;
      if (r < p.win && tt < nt)
        val = tt < p.kh ? bh[r * p.kh + tt] : bw[r * p.kw + tt - p.kh];
      v[x] = val;
    }
    *reinterpret_cast<uint4*>(cat + chunk_at(r, chunk)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator values (rows g, g + 8; columns 8i + 2c, + 1) as bf16 A
// fragments of a product whose k index is the accumulator's column.
template <int N>
__device__ __forceinline__ void pack_rows(const float (&s)[N / 2],
                                          uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    a[i / 2][(i & 1) * 2] = vdr::pack_bf16(s[4 * i], s[4 * i + 1]);
    a[i / 2][(i & 1) * 2 + 1] = vdr::pack_bf16(s[4 * i + 2], s[4 * i + 3]);
  }
}

// Phase A, one 64-row query tile of the item: scores and softmax, D, dP in
// key chunks (N = 208: two of 104), dS, then dq and the bias gradients,
// stored.
template <int N>
__device__ __forceinline__ void query_tile(const HopperParams& p,
                                           const Smem& sm, int item,
                                           int tile) {
  constexpr int PW = N == 208 ? 104 : 64;   // keys of one dP chunk
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, c = lane % 4;
  const int rl = warp * 16 + g;
  const int r_lo = tile * 64 + rl, r_hi = r_lo + 8;   // rows of the window
  const int h = item % p.H, C = p.H * kD;
  const size_t row0 = (size_t)(item / p.H) * p.win;   // flat token row
  const float sl = p.scale_log2;

  // O of this lane's 16 dims of both rows, for D, under the score products
  uint4 o_lo[2], o_hi[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    o_lo[x] = o_hi[x] = make_uint4(0, 0, 0, 0);
    if (r_lo < p.win)
      o_lo[x] = *reinterpret_cast<const uint4*>(
          p.out + (row0 + r_lo) * C + h * kD + 16 * c + 8 * x);
    if (r_hi < p.win)
      o_hi[x] = *reinterpret_cast<const uint4*>(
          p.out + (row0 + r_hi) * C + h * kD + 16 * c + 8 * x);
  }

  // S = Q K^T + bias E over the window's N keys
  float s[N / 2];
  {
    const uint64_t dqa = desc_sw128(sm.q + tile * kTile, 16, 1024);
    const uint64_t dkb = desc_sw128(sm.k, 16, 1024);
    const uint64_t dca = desc_sw128(sm.cat + tile * kTile, 16, 1024);
    const uint64_t deb = desc_sw128(sm.e, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      Wgmma<N>::ss(s, dqa + 2 * kk, dkb + 2 * kk, kk > 0);
#pragma unroll
    for (int kb = 0; kb < kTerms / 16; ++kb)
      Wgmma<N>::ss(s, dca + 2 * kb, deb + 2 * kb, 1);
    wgmma_commit();
  }
  // D = sum_d dO * O of rows r_lo, r_hi: this lane's 16 dims, then the
  // row's 4 lanes
  float dl_lo = 0.f, dl_hi = 0.f;
  {
    const unsigned char* dob = at<const unsigned char>(sm.dout + tile * kTile);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const uint4 a = *reinterpret_cast<const uint4*>(
          dob + chunk_at(rl, 2 * c + x));
      const uint4 b = *reinterpret_cast<const uint4*>(
          dob + chunk_at(rl + 8, 2 * c + x));
      const uint32_t av[4] = {a.x, a.y, a.z, a.w};
      const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
      const uint32_t ol[4] = {o_lo[x].x, o_lo[x].y, o_lo[x].z, o_lo[x].w};
      const uint32_t oh[4] = {o_hi[x].x, o_hi[x].y, o_hi[x].z, o_hi[x].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 d0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&av[e]));
        const float2 o0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ol[e]));
        const float2 d1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&bv[e]));
        const float2 o1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&oh[e]));
        dl_lo = fmaf(d0.x, o0.x, fmaf(d0.y, o0.y, dl_lo));
        dl_hi = fmaf(d1.x, o1.x, fmaf(d1.y, o1.y, dl_hi));
      }
    }
  }
  dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, 1);
  dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, 2);
  dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, 1);
  dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, 2);
  wgmma_wait<0>();
  fence_acc(s);

  // softmax in one pass: P = exp2((s - max) scale log2 e) / l in place
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
  float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    s[4 * i] = fast_exp2(fmaf(s[4 * i], sl, -mb_lo));
    s[4 * i + 1] = fast_exp2(fmaf(s[4 * i + 1], sl, -mb_lo));
    s[4 * i + 2] = fast_exp2(fmaf(s[4 * i + 2], sl, -mb_hi));
    s[4 * i + 3] = fast_exp2(fmaf(s[4 * i + 3], sl, -mb_hi));
    l_lo += s[4 * i] + s[4 * i + 1];
    l_hi += s[4 * i + 2] + s[4 * i + 3];
  }
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    s[4 * i] *= inv_lo;
    s[4 * i + 1] *= inv_lo;
    s[4 * i + 2] *= inv_hi;
    s[4 * i + 3] *= inv_hi;
  }
  if (c == 0) {
    // phase B's residuals; rows past the window take P^T = 0 there
    float* lse = at<float>(sm.lse);
    float* dl = at<float>(sm.dl);
    lse[r_lo] = r_lo < p.win ? mb_lo + log2f(l_lo) : INFINITY;
    lse[r_hi] = r_hi < p.win ? mb_hi + log2f(l_hi) : INFINITY;
    dl[r_lo] = dl_lo;
    dl[r_hi] = dl_hi;
  }

  // dP = dO V^T in key chunks, dS = P (dP - D) in place
  const uint64_t ddo = desc_sw128(sm.dout + tile * kTile, 16, 1024);
#pragma unroll
  for (int hc = 0; hc < N / PW; ++hc) {
    float dp[PW / 2];
    const uint64_t dvb = desc_sw128(sm.v + hc * PW * 128, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      Wgmma<PW>::ss(dp, ddo + 2 * kk, dvb + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int i = 0; i < PW / 8; ++i) {
      const int x = 4 * (hc * PW / 8 + i);   // the same keys' P
      s[x] *= dp[4 * i] - dl_lo;
      s[x + 1] *= dp[4 * i + 1] - dl_lo;
      s[x + 2] *= dp[4 * i + 2] - dl_hi;
      s[x + 3] *= dp[4 * i + 3] - dl_hi;
    }
  }

  // dq = dS K, stored; then the bias gradients dS E (times scale: E holds
  // 1/scale), one product at a time
  uint32_t da[N / 16][4];
  pack_rows<N>(s, da);
  const float sc = p.scale;
  {
    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < N / 16; ++kt)
      Wgmma<64>::rs<1>(dq, da[kt], mn_desc(sm.k, kt), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dq);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r_hi : r_lo;
      if (r >= p.win) continue;
      bf16* dst = p.dq + (row0 + r) * C + h * kD;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<uint32_t*>(dst + 8 * i + 2 * c) = vdr::pack_bf16(
            dq[4 * i + 2 * half] * sc, dq[4 * i + 2 * half + 1] * sc);
    }
  }
  float db[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) db[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < N / 16; ++kt)
    Wgmma<64>::rs<1>(db, da[kt], mn_desc(sm.e, kt), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(db);
  fence_regs(da);
  if (p.bias_h == nullptr) return;
  const size_t br = bias_row(p, item);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r_hi : r_lo;
    if (r >= p.win) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tt = 8 * i + 2 * c + e;
        const bf16 v = __float2bfloat16(db[4 * i + 2 * half + e] * sc);
        if (tt < p.kh)
          p.dbh[(br + r) * p.kh + tt] = v;
        else if (tt < p.kh + p.kw)
          p.dbw[(br + r) * p.kw + tt - p.kh] = v;
      }
  }
}

// Phase B, the NQ queries from q0 of one 64-key tile: S^T and dP^T, P^T
// from the rows' lse, dS^T, then dv += P^T dO and dk += dS^T Q.
template <int NQ>
__device__ __forceinline__ void key_chunk(const Smem& sm, float sl, int q0,
                                          uint64_t dka, uint64_t dva,
                                          uint64_t dea, float (&dk)[32],
                                          float (&dv)[32]) {
  const int c = threadIdx.x % 4;
  float st[NQ / 2], dpt[NQ / 2];
  const uint64_t dqb = desc_sw128(sm.q + q0 * 128, 16, 1024);
  const uint64_t dcb = desc_sw128(sm.cat + q0 * 128, 16, 1024);
  const uint64_t ddb = desc_sw128(sm.dout + q0 * 128, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    Wgmma<NQ>::ss(st, dka + 2 * kk, dqb + 2 * kk, kk > 0);
#pragma unroll
  for (int kb = 0; kb < kTerms / 16; ++kb)
    Wgmma<NQ>::ss(st, dea + 2 * kb, dcb + 2 * kb, 1);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    Wgmma<NQ>::ss(dpt, dva + 2 * kk, ddb + 2 * kk, kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(st);
  fence_acc(dpt);
#pragma unroll
  for (int i = 0; i < NQ / 8; ++i) {
    const int qi = q0 + 8 * i + 2 * c;   // this lane's two queries
    const float2 L = *at<const float2>(sm.lse + 4 * qi);
    const float2 Dl = *at<const float2>(sm.dl + 4 * qi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lse = (e & 1) ? L.y : L.x;
      const float dd = (e & 1) ? Dl.y : Dl.x;
      const float pv = fast_exp2(fmaf(st[4 * i + e], sl, -lse));
      st[4 * i + e] = pv;
      dpt[4 * i + e] = pv * (dpt[4 * i + e] - dd);
    }
  }
  uint32_t pa[NQ / 16][4], sa[NQ / 16][4];
  pack_rows<NQ>(st, pa);
  pack_rows<NQ>(dpt, sa);
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < NQ / 16; ++kt) {
    Wgmma<64>::rs<1>(dv, pa[kt], mn_desc(sm.dout + q0 * 128, kt), 1);
    Wgmma<64>::rs<1>(dk, sa[kt], mn_desc(sm.q + q0 * 128, kt), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(dv);
  fence_acc(dk);
  fence_regs(pa);
  fence_regs(sa);
}

// Phase B, one 64-key tile of the item over its query rows (64-query
// chunks, then 16-query ones, up to the buffers' rows or the query tiles'
// end: past the window P^T is 0); dk and dv stored.
__device__ __forceinline__ void key_tile(const HopperParams& p,
                                         const Smem& sm, int item,
                                         int ktile) {
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, c = lane % 4;
  const int h = item % p.H, C = p.H * kD;
  const size_t row0 = (size_t)(item / p.H) * p.win;
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  const uint64_t dka = desc_sw128(sm.k + ktile * kTile, 16, 1024);
  const uint64_t dva = desc_sw128(sm.v + ktile * kTile, 16, 1024);
  const uint64_t dea = desc_sw128(sm.e + ktile * kTile, 16, 1024);
  const int qrows = min(p.rows, 64 * p.n_tiles);   // rows with an lse
  int q0 = 0;
  for (; q0 + 64 <= qrows; q0 += 64)
    key_chunk<64>(sm, p.scale_log2, q0, dka, dva, dea, dk, dv);
  for (; q0 < qrows; q0 += 16)
    key_chunk<16>(sm, p.scale_log2, q0, dka, dva, dea, dk, dv);
  const float sc = p.scale;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = ktile * 64 + warp * 16 + g + 8 * half;
    if (key >= p.win) continue;
    bf16* dst = p.dkv + (row0 + key) * 2 * C + h * kD;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<uint32_t*>(dst + 8 * i + 2 * c) = vdr::pack_bf16(
          dk[4 * i + 2 * half] * sc, dk[4 * i + 2 * half + 1] * sc);
      *reinterpret_cast<uint32_t*>(dst + C + 8 * i + 2 * c) =
          vdr::pack_bf16(dv[4 * i + 2 * half], dv[4 * i + 2 * half + 1]);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    k4_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tkv,
                     const __grid_constant__ CUtensorMap tdo,
                     const HopperParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full;
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Smem sm = smem_of(base, p);
  // the items of this block: blockIdx.x, + gridDim.x, ... (grid <= items)
  const int n_mine = (p.n_items - 1 - (int)blockIdx.x) / gridDim.x + 1;
  const int C = p.H * kD;

  // one thread issues every copy of item k, once the block is done with
  // item k - 1
  auto load = [&](int k) {
    const int item = blockIdx.x + k * gridDim.x;
    const int col = (item % p.H) * kD, w = item / p.H;
    mbar_expect_tx(&full, 4 * p.rows * 128 +
                              (p.bias_bulk ? p.raw_h + p.raw_w : 0));
    tma_load(sm.q, &tq, &full, col, 0, w);
    tma_load(sm.k, &tkv, &full, col, 0, w);
    tma_load(sm.v, &tkv, &full, C + col, 0, w);
    tma_load(sm.dout, &tdo, &full, col, 0, w);
    if (p.bias_bulk) {
      const size_t r = bias_row(p, item);
      bulk_load(sm.raw, p.bias_h + r * p.kh, p.raw_h, &full);
      bulk_load(sm.raw + p.raw_h, p.bias_w + r * p.kw, p.raw_w, &full);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(&full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load(0);
  }
  const int wg = threadIdx.x / 128;
  build_expand(p, base);
  for (int k = 0; k < n_mine; ++k) {
    const int item = blockIdx.x + k * gridDim.x;
    mbar_wait(&full, k & 1);
    build_bias_tile(p, sm, item, base + p.rows * 128);
    fence_proxy_async();
    __syncthreads();
    for (int tile = wg; tile < p.n_tiles; tile += kConsumers)
      query_tile<N>(p, sm, item, tile);
    __syncthreads();   // every row's lse and D
    for (int tile = wg; tile < p.n_tiles; tile += kConsumers)
      key_tile(p, sm, item, tile);
    fence_proxy_async();
    __syncthreads();   // both warpgroups are done with the item's tiles
    if (threadIdx.x == 0 && k + 1 < n_mine) load(k + 1);
  }
}

// Keys a window pads to: the N of the score wgmma (0: no Hopper instance).
// SAM's 14 x 14 windows take 208; 64 serves 8 x 8 windows and smaller.
int hopper_width(int win) { return win <= 64 ? 64 : win <= 208 ? 208 : 0; }

// Whether the Hopper body takes the call, and its parameters and shared
// memory: D = 64, windows of at most 208 tokens, at most 63 bias terms,
// and a scale whose inverse is a power of two (E's 1/scale exact in bf16).
bool hopper_plan(int B, int S, int H, int D, int win, int kh, int kw,
                 bool biased, float scale, HopperParams* hp, int* n,
                 size_t* smem) {
  if (D != kD || win < 1 || S % win != 0) return false;
  *n = hopper_width(win);
  if (*n == 0 || !(scale > 0.f)) return false;
  int e = 0;
  const float inv = 1.f / scale;
  if (frexpf(inv, &e) != 0.5f) return false;
  if (!biased) kh = kw = 0;
  if (kh + kw + 1 > kTerms) return false;
  HopperParams p{};
  p.S = S;
  p.H = H;
  p.win = win;
  p.n_items = B * (S / win) * H;
  p.n_tiles = (win + 63) / 64;
  p.kh = kh;
  p.kw = kw;
  p.rows = *n;
  p.raw_h = win * kh * 2;
  p.raw_w = win * kw * 2;
  p.bias_bulk = kBiasBulk && biased && p.raw_h % 16 == 0 &&
                p.raw_w % 16 == 0;
  if (smem_bytes(p.rows, p.raw_h + p.raw_w) > (size_t)kSmemMax)
    return false;
  p.scale = scale;
  p.scale_log2 = scale * vdr::kLog2e;
  p.inv_scale = inv;
  *smem = smem_bytes(p.rows, p.bias_bulk ? p.raw_h + p.raw_w : 0);
  *hp = p;
  return true;
}

// 3-D map (width columns, win rows, windows) of a row-major bf16 tensor:
// boxes of 64 columns (one head, 128 bytes: the 128-byte swizzle) x
// box_rows rows of one window; rows past the window read as zeros.
bool tensor_map_win(CUtensorMap* map, const void* ptr, int width, int win,
                    int windows, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)win,
                              (cuuint64_t)windows};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)win * width * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
int launch_hopper(const CUtensorMap& tq, const CUtensorMap& tkv,
                  const CUtensorMap& tdo, const HopperParams& p, size_t smem,
                  cudaStream_t stream) {
  auto kern = k4_hopper_kernel<N>;
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
  kern<<<grid, kThreads, smem, stream>>>(tq, tkv, tdo, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vdr_error_string(int err) { return vdr::error_string(err); }

// 1 when a call with these arguments runs the Hopper body, 0 when it runs
// the first loops.
int vdr_window_attention_bwd_route(int S, int H, int D, int window_tokens,
                                   int kh, int kw, int biased, float scale) {
  HopperParams p;
  int n = 0;
  size_t smem = 0;
  return hopper_plan(1, S, H, D, window_tokens, kh, kw, biased != 0, scale,
                     &p, &n, &smem)
             ? 1
             : 0;
}

// bf16 only. Returns 0 on success, a cudaError_t after a failed launch
// (a window whose loops' tiles do not fit shared memory is refused there),
// -1 for a head dim other than 64, or -3 when a TMA descriptor cannot be
// made.
int vdr_window_attention_bwd(const void* q, const void* kv,
                             const void* bias_h, const void* bias_w,
                             const void* out, const void* dout, void* dq,
                             void* dkv, void* dbh, void* dbw, int B, int S,
                             int H, int D, int window_tokens, int kh, int kw,
                             float scale, void* stream) {
  if (D != 64) return -1;
  if (bias_h == nullptr) kh = kw = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  HopperParams hp;
  int n = 0;
  size_t hsmem = 0;
  if (hopper_plan(B, S, H, D, window_tokens, kh, kw, bias_h != nullptr,
                  scale, &hp, &n, &hsmem)) {
    hp.bias_h = static_cast<const bf16*>(bias_h);
    hp.bias_w = static_cast<const bf16*>(bias_w);
    hp.out = static_cast<const bf16*>(out);
    hp.dq = static_cast<bf16*>(dq);
    hp.dkv = static_cast<bf16*>(dkv);
    hp.dbh = static_cast<bf16*>(dbh);
    hp.dbw = static_cast<bf16*>(dbw);
    const int windows = B * (S / window_tokens);
    CUtensorMap tq, tkv, tdo;
    if (!tensor_map_win(&tq, q, H * D, window_tokens, windows, hp.rows) ||
        !tensor_map_win(&tkv, kv, 2 * H * D, window_tokens, windows,
                        hp.rows) ||
        !tensor_map_win(&tdo, dout, H * D, window_tokens, windows, hp.rows))
      return kErrTensorMap;
    return n == 64 ? launch_hopper<64>(tq, tkv, tdo, hp, hsmem, st)
                   : launch_hopper<208>(tq, tkv, tdo, hp, hsmem, st);
  }
  vdr::AttnParams p{q,  kv, bias_h, bias_w, nullptr, nullptr, B,
                    S,  H,  window_tokens, kh, kw, scale * vdr::kLog2e};
  vdr::GradParams gp{static_cast<const bf16*>(dout),
                     static_cast<const bf16*>(out), nullptr, nullptr,
                     static_cast<bf16*>(dq), static_cast<bf16*>(dkv),
                     static_cast<bf16*>(dbh), static_cast<bf16*>(dbw), scale};
  const size_t smem = layout(window_tokens, kh, kw).total;
  const cudaError_t err = cudaFuncSetAttribute(
      window_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(1, H, B * (S / window_tokens));
  window_bwd_kernel<<<grid, NW * 32, smem, st>>>(p, gp);
  return (int)cudaGetLastError();
}

}  // extern "C"
