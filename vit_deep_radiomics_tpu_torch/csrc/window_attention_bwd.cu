// K4: backward of trainable window attention for SAM's windowed layers.
//
// Replaces: vit_deep_radiomics_tpu/ops/attention_grad.py::_window_bwd_kernel
// (the backward of window_attention_trainable, a Pallas TPU kernel).
//
// The token axis is a concatenation of independent windows of `seg` tokens
// (196 = 14 x 14 for SAM ViT-B/16). One block owns one (window, head) and
// makes one pass over it, writing dq (B, S, H*D), dkv (B, S, 2*H*D) and
// the bias gradients dbias_h (B, H, S, kh), dbias_w (B, H, S, kw) with no
// accumulation across blocks:
//   phase A, query-major (a warp owns 16 query rows): recompute the exact
//     softmax of the row over the window's keys as K1 computed it (the
//     forward, csrc/fused_window_attention.cu: q pre-scaled and rounded to
//     bf16, bias times log2(e), running max), D = sum_d dO * O, then
//     dP = dO V^T, dS = P * (dP - D), dq = D^-1/2 dS K, and the bias
//     gradients as group sums of dS in shared memory (a window's grid rows
//     and columns cut across the mma tiles; the lanes that share a row
//     take turns, so the sums are reproducible);
//   phase B, key-major (a warp owns 16 keys): recompute S^T and P^T from
//     phase A's residuals in shared memory, dk = D^-1/2 dS^T Q, dv = P^T dO.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the
// fine-tuning path's shapes (50 windows x 196 tokens x 12 heads of 64) the
// minimal work is 10 S^2 D per window and head = 14.7 GFLOP (0.015 ms)
// against about 135 MB of compulsory traffic (q, kv, both bias arrays, O
// and dO read, dq, dkv and both bias gradients written: 0.040 ms), so it
// is memory-bound.
//
// What the design does about it: every input byte is read from device
// memory once per (window, head) block and every output written once; the
// 196 x 196 score, probability and dS matrices stay in registers. K, V and
// then Q, dO of the window sit in one reused shared-memory region, and the
// exact recompute trades 3 extra score products (1.6x the minimal work) for
// needing no residual from the forward. 196 is not a multiple of 16: rows
// and keys past the window are zero-filled and masked.

#include "attention_bwd_core.cuh"

namespace {
using vdr::bf16;
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

}  // namespace

extern "C" {

const char* vdr_error_string(int err) { return vdr::error_string(err); }

// bf16 only. Returns 0 on success, a cudaError_t after a failed launch
// (a window whose tiles do not fit shared memory is refused there), or -1
// for a head dim other than 64.
int vdr_window_attention_bwd(const void* q, const void* kv,
                             const void* bias_h, const void* bias_w,
                             const void* out, const void* dout, void* dq,
                             void* dkv, void* dbh, void* dbw, int B, int S,
                             int H, int D, int window_tokens, int kh, int kw,
                             float scale, void* stream) {
  if (D != 64) return -1;
  if (bias_h == nullptr) kh = kw = 0;
  vdr::AttnParams p{q,  kv, bias_h, bias_w, nullptr, nullptr, B,
                    S,  H,  window_tokens, kh, kw, scale * vdr::kLog2e};
  vdr::GradParams gp{static_cast<const bf16*>(dout),
                     static_cast<const bf16*>(out), nullptr, nullptr,
                     static_cast<bf16*>(dq), static_cast<bf16*>(dkv),
                     static_cast<bf16*>(dbh), static_cast<bf16*>(dbw), scale};
  const size_t smem = layout(window_tokens, kh, kw).total;
  cudaFuncSetAttribute(window_bwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(1, H, B * (S / window_tokens));
  window_bwd_kernel<<<grid, NW * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(p, gp);
  return (int)cudaGetLastError();
}

}  // extern "C"
