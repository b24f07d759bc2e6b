// K6 backward, dkv: key and value gradients of trainable flash attention
// over per-head fp32 (B, H, S, D).
//
// Replaces: vit_deep_radiomics_tpu/ops/attention_grad.py::_bwd_dkv_kernel
// (flash_attention_trainable's backward, a Pallas TPU kernel).
//
// A block owns 64 keys of one (batch, head) and walks the queries in tiles
// of kCols. Per tile it rebuilds the forward's scores S^T (keys x queries,
// flash_trainable_core.cuh), takes P^T = exp2(S^T - lse), dP^T = V dO^T and
// dS^T = P^T (dP^T - D) in registers, puts P^T and dS^T in shared memory
// once, then
//     dv += P^T dO        dk += dS^T q     (dk times D^-1/2 at the end)
// Keys at or past kv_len score -1e30 (P = 0; on a kv_len 0 row, P = 1).
// A block whose keys all lie past a non-zero kv_len writes zeros.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 on the CUDA
// cores): 8 S^2 D FLOP per (batch, head) (q k^T, dO v^T, P^T dO, dS^T q)
// against about 7 S D words. At the `parity` path's shapes that is
// operations: SAM's global layers (2 x 12 x 4096 tokens) 206 GFLOP,
// 3.08 ms; SAM's windowed layers (50 x 12 x 196 tokens) 11.8 GFLOP,
// 0.18 ms, against 0.053 ms of traffic; DINOv2 ViT-B/14 (2 x 12 x 1536
// tokens, 1370 valid keys) 25.9 GFLOP, 0.39 ms. So the CUDA cores' FMA
// rate is the roof, and the first design (two lanes a key, every FMA's
// other operand streamed from shared memory, 255 registers and a spill,
// synchronous tiles) ran at 16% of it: the load/store pipe paced it.
//
// What this design does about it: register tiles, as an SGEMM. Each thread
// computes a 4 x 4 micro-tile of S^T and dP^T (8 shared 16-byte loads feed
// 64 FMAs) and owns 4 keys x 8 dims of dk and dv (3 loads feed 32 FMAs per
// product); the two score chains of the forward run in one thread, so no
// shuffle. The next query tile (q, dO, lse, D, the bias terms these keys
// take, by 16-byte copies where aligned) arrives by cp.async into the
// second of two buffers while the current tile's products run; q is
// pre-scaled once per tile into its own buffer for the score. About 111 KB
// of shared memory at Kw = 64 and 228 registers a thread (the score chains
// unrolled by 4: fully unrolled they spill), so two blocks (8 warps) share
// an SM; the 4 x 4 micro-tile's shared loads and the per-tile steps hold it
// to about 43% of the FMA rate (PERF.md, the probe's ablations).
//
// The library yardstick, PyTorch's fp32 SDPA backward (memory-efficient
// backend), runs its products on the tensor cores as 3xTF32
// (OpMultiplyAddFastF32); this kernel keeps `parity`'s fp32 FMA contract.

#include "flash_trainable_bf16.cuh"
#include "flash_trainable_core.cuh"
#include "flash_trainable_hopper.cuh"

namespace {
using namespace vdr::k6;
using namespace vdr::k6::bwd;

constexpr int kCols = 32;    // queries a tile
constexpr int kStages = 2;   // tile buffers
constexpr int TC = kCols / TX;
// The bias terms of a query row are staged as [kCols][LB]: nh grid-row
// terms at [0, nh) (rows key0 / kw onwards) and nw grid-column terms at
// [W0, W0 + nw) (all kw columns, or with kw > ROWS the block's own). LB is
// 4 modulo 32, so a warp's reads (8 queries, 4 keys) hit distinct banks.
__host__ __device__ int w0_of(int nh) { return round4(nh); }
__host__ __device__ int lb_of(int nh, int nw) {
  return nw ? (w0_of(nh) + nw + 27) / 32 * 32 + 4 : 0;
}

__host__ __device__ int stage_floats(int lb) {
  return 2 * kCols * LD + 2 * kCols + kCols * lb;
}

size_t smem_bytes(int lb) {
  return (size_t)(2 * ROWS * LD + kStages * stage_floats(lb) + kCols * LD +
                  2 * kCols * LP) *
         sizeof(float);
}

__global__ void __launch_bounds__(NT, 2) dkv_kernel(Params p, int nh,
                                                     int nw) {
  extern __shared__ __align__(16) float smem[];
  const int w0 = w0_of(nh), lb = lb_of(nh, nw), sf = stage_floats(lb);
  float* ks = smem;                        // [ROWS][LD] k
  float* vs = ks + ROWS * LD;              // [ROWS][LD] v
  float* stages = vs + ROWS * LD;          // kStages x (q, dO, lse, D, bias)
  float* qs = stages + kStages * sf;       // [kCols][LD] pre-scaled q
  float* ps = qs + kCols * LD;             // [kCols][LP] P^T
  float* dss = ps + kCols * LP;            // [kCols][LP] dS^T

  const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * ROWS;
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const size_t bh = (size_t)b * p.H + h;
  const size_t base = bh * p.S * D;
  const int nrows = min(ROWS, p.S - key0);
  const int n_keys = valid_keys(p, b);
  if (n_keys > 0 && key0 >= n_keys) {
    for (int i = threadIdx.x; i < nrows * D; i += NT) {
      p.dk[base + (size_t)key0 * D + i] = 0.f;
      p.dv[base + (size_t)key0 * D + i] = 0.f;
    }
    return;
  }
  const bool has_bias = p.bias_h != nullptr;
  const bool mask_keys = key0 + ROWS > n_keys;   // one flag a block
  const int th0 = has_bias ? key0 / p.kw : 0;

  // This thread's score rows: keys key0 + ty + TY i, their staged bias
  // terms (a key past S takes the last key's; it writes nothing).
  int hs[TR], ws[TR];
  bool dead[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int key = key0 + ty + TY * i, kc = min(key, p.S - 1);
    dead[i] = key >= n_keys;
    hs[i] = has_bias ? kc / p.kw - th0 : 0;
    ws[i] = has_bias ? w0 + (p.kw <= ROWS ? kc % p.kw : kc - key0) : 0;
  }
  // The grid columns staged: from col0 on; by 16-byte copies where every
  // query's run of them is 16-byte aligned and does not wrap.
  const int col0 = p.kw <= ROWS ? 0 : key0 % p.kw;
  const bool vec = p.kw % 4 == 0 && col0 % 4 == 0 && nw % 4 == 0 &&
                   col0 + nw <= p.kw;

  auto fetch = [&](int t, float* st) {
    const int q0 = t * kCols, nq = min(kCols, p.S - q0);
    copy_rows<kCols>(st, p.q + base + (size_t)q0 * D, nq);
    copy_rows<kCols>(st + kCols * LD, p.dout + base + (size_t)q0 * D, nq);
    copy_vec<kCols>(st + 2 * kCols * LD, p.lse + bh * p.S + q0, nq);
    copy_vec<kCols>(st + 2 * kCols * LD + kCols, p.delta + bh * p.S + q0,
                    nq);
    if (!has_bias) return;
    float* bs = st + 2 * kCols * LD + 2 * kCols;
    const size_t row0 = bh * p.S + q0;
    for (int i = threadIdx.x; i < kCols * nh; i += NT) {
      const int c = i / nh, slot = i % nh;
      const size_t row = row0 + (c < nq ? c : 0);
      cp_async4(bs + c * lb + slot,
                p.bias_h + row * p.kh + min(th0 + slot, p.kh - 1), c < nq);
    }
    if (vec) {
      const int n4 = nw / 4;
      for (int i = threadIdx.x; i < kCols * n4; i += NT) {
        const int c = i / n4, w = (i % n4) * 4;
        const size_t row = row0 + (c < nq ? c : 0);
        cp_async16(bs + c * lb + w0 + w, p.bias_w + row * p.kw + col0 + w,
                   c < nq);
      }
    } else {
      for (int i = threadIdx.x; i < kCols * nw; i += NT) {
        const int c = i / nw, w = i % nw;
        const size_t row = row0 + (c < nq ? c : 0);
        cp_async4(bs + c * lb + w0 + w,
                  p.bias_w + row * p.kw + (col0 + w) % p.kw, c < nq);
      }
    }
  };

  // P^T = exp2(S^T - lse) and dS^T = P^T (dP^T - D), in place.
  auto p_ds = [&](float (&s)[TR][TC], float (&dp)[TR][TC], const float* st) {
    const float* lse_s = st + 2 * kCols * LD;
    const float* dl_s = lse_s + kCols;
    const float* bs = dl_s + kCols;
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int c = tx + TX * j;
        float sv = s[i][j];
        if (has_bias)
          sv = with_bias(sv, bias_log2(bs[c * lb + hs[i]]),
                         bias_log2(bs[c * lb + ws[i]]));
        if (mask_keys && dead[i]) sv = kNegInf;
        const float pv = exp2f(sv - lse_s[c]);
        dp[i][j] = pv * (dp[i][j] - dl_s[c]);
        s[i][j] = pv;
      }
  };

  copy_rows<ROWS>(ks, p.k + base + (size_t)key0 * D, nrows);
  copy_rows<ROWS>(vs, p.v + base + (size_t)key0 * D, nrows);
  if (kStages == 2) fetch(0, stages);
  cp_async_commit();

  float dk[4][8], dv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) dk[i][e] = dv[i][e] = 0.f;
  const int nt = (p.S + kCols - 1) / kCols;
  for (int t = 0; t < nt; ++t) {
    float* st = stages + (kStages == 2 ? (t & 1) : 0) * sf;
    if (kStages == 1) {
      __syncthreads();
      fetch(t, st);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();
    for (int i = threadIdx.x; i < kCols * (D / 4); i += NT) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 x = ld4(st + r * LD + c);
      x.x = __fmul_rn(x.x, p.scale_log2);
      x.y = __fmul_rn(x.y, p.scale_log2);
      x.z = __fmul_rn(x.z, p.scale_log2);
      x.w = __fmul_rn(x.w, p.scale_log2);
      *reinterpret_cast<float4*>(qs + r * LD + c) = x;
    }
    __syncthreads();
    float s[TR][TC] = {}, dp[TR][TC] = {};  // zero for the no_scores probe
    score_tile(s, ks, qs);
    dp_tile(dp, vs, st + kCols * LD);
    p_ds(s, dp, st);
    store_cols(ps, s);
    store_cols(dss, dp);
    // the next tile loads during the products (its buffer's last readers
    // finished before this tile's first barrier)
    if (kStages == 2 && t + 1 < nt) {
      fetch(t + 1, stages + ((t + 1) & 1) * sf);
      cp_async_commit();
    }
    __syncthreads();
    accumulate<kCols>(dv, ps, st + kCols * LD);
    accumulate<kCols>(dk, dss, st);
  }
  store_rows(p.dk + base + (size_t)key0 * D, dk, nrows, p.scale);
  store_rows(p.dv + base + (size_t)key0 * D, dv, nrows, 1.f);
}

// bf16: the mma.sync body of flash_trainable_bf16.cuh
__global__ void __launch_bounds__(vdr::k6b::NT)
    dkv_mma_kernel(const vdr::k6b::Params p) {
  extern __shared__ __align__(16) char smem_mma[];
  vdr::k6b::dkv(p, blockIdx.z, blockIdx.y, blockIdx.x * vdr::k6b::ROWS,
                smem_mma);
}


// bf16 with no bias or a key grid the Hopper bodies take: the dkv body
// built for the grid's width (its stage layout and ring depth)
template <bool kBias, int kKw>
int dkv_hopper_at(const vdr::k6h::Params& p, const CUtensorMap (&m)[4],
                  const CUtensorMap& tbw, int B, cudaStream_t stream) {
  namespace h = vdr::k6h;
  return h::launch(h::dkv_hopper_kernel<kBias, kKw>,
                   vdr::k6b::hopper_dkv_smem(kKw),
                   (p.S + h::kKeys - 1) / h::kKeys, B, p, stream, m[0], m[1],
                   m[2], m[3], tbw);
}

// the instance of width p.kw among kKw, kKw + 4, ... kHopperMaxKw
template <int kKw>
int dkv_hopper_kw(const vdr::k6h::Params& p, const CUtensorMap (&m)[4],
                  const CUtensorMap& tbw, int B, cudaStream_t stream) {
  if constexpr (kKw > vdr::k6b::kHopperMaxKw) {
    return vdr::k6b::kErrTerms;
  } else {
    constexpr int kNext = kKw + vdr::k6b::kHopperKwStep;
    return p.kw == kKw ? dkv_hopper_at<true, kKw>(p, m, tbw, B, stream)
                       : dkv_hopper_kw<kNext>(p, m, tbw, B, stream);
  }
}

int dkv_hopper(const void* q, const void* k, const void* v, const void* dout,
               const vdr::k6h::Params& p, int B, cudaStream_t stream) {
  namespace h = vdr::k6h;
  CUtensorMap m[4], tbw;
  if (!h::qkv_maps(m, q, k, v, dout, p.S, B * p.H, 64))
    return h::kErrTensorMap;
  const bool bias = p.bias_h != nullptr;
  if (bias && !h::bias_map(&tbw, p.bias_w, p.S, B * p.H, p.kw))
    return h::kErrTensorMap;
  if (!bias) {
    tbw = m[3];   // never read
    return dkv_hopper_at<false, 0>(p, m, tbw, B, stream);
  }
  return dkv_hopper_kw<16>(p, m, tbw, B, stream);
}
}  // namespace

extern "C" {

const char* vdr_error_string(int err) { return vdr::k6::error_string(err); }

// fp32. Returns 0 on success, a cudaError_t after a failed attribute call
// or launch, or -1 for a head dim other than 64.
int vdr_flash_attention_bwd_dkv(const float* q, const float* k,
                                const float* v, const float* bias_h,
                                const float* bias_w, const int* kv_len,
                                const float* dout, const float* lse,
                                const float* delta, float* dk, float* dv,
                                int B, int H, int S, int D, int kh, int kw,
                                float scale, void* stream) {
  if (D != vdr::k6::D) return -1;
  vdr::k6::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias_h = bias_h;
  p.bias_w = bias_w;
  p.kv_len = kv_len;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.H = H;
  p.S = S;
  p.kh = bias_h != nullptr ? kh : 0;
  p.kw = bias_h != nullptr ? kw : 1;
  p.scale = scale;
  p.scale_log2 = scale * vdr::k6::kLog2e;
  int nh = 0, nw = 0;
  if (bias_h != nullptr) {
    nh = (vdr::k6::ROWS - 1) / kw + 2;   // grid rows 64 keys can span
    nh = nh < kh ? nh : kh;
    nw = kw < vdr::k6::ROWS ? kw : vdr::k6::ROWS;
  }
  return vdr::k6::bwd::launch(dkv_kernel, p, smem_bytes(lb_of(nh, nw)),
                              stream, nh, nw);
}

// bf16 q, k, v, dO, dk and dv; fp32 bias, lse and delta: the Hopper body
// of flash_trainable_hopper.cuh or the mma.sync one, as
// vdr_flash_attention_bwd_route (flash_attention_bwd_dq.cu) says; the code
// of the body launched is written to *body unless it is null. Returns 0 on
// success, a cudaError_t after a failed attribute call or launch, -1 for a
// head dim other than 64, -2 for a bias grid of more than
// vdr::k6b::kMaxTerms terms, or -3 when a TMA descriptor cannot be made.
int vdr_flash_attention_bwd_dkv_bf16(const void* q, const void* k,
                                     const void* v, const float* bias_h,
                                     const float* bias_w, const int* kv_len,
                                     const void* dout, const float* lse,
                                     const float* delta, void* dk, void* dv,
                                     int B, int H, int S, int D, int kh,
                                     int kw, float scale, void* stream,
                                     int* body) {
  using vdr::k6b::bf16;
  if (D != vdr::k6b::D) return -1;
  const bool bias = bias_h != nullptr;
  const int route = vdr::k6b::bwd_route(bias, kh, kw);
  if (route < 0) return route;
  if (body != nullptr) *body = route;
  if (route == vdr::k6b::kRouteHopper) {
    vdr::k6h::Params hp{};
    hp.bias_h = bias_h;
    hp.bias_w = bias_w;
    hp.kv_len = kv_len;
    hp.lse = lse;
    hp.delta = delta;
    hp.dk = static_cast<bf16*>(dk);
    hp.dv = static_cast<bf16*>(dv);
    hp.H = H;
    hp.S = S;
    hp.kh = bias ? kh : 0;
    hp.kw = bias ? kw : 0;
    hp.scale_log2 = vdr::k6b::scale_log2_bf16(scale);
    hp.scale = scale;
    return dkv_hopper(q, k, v, dout, hp, B,
                      static_cast<cudaStream_t>(stream));
  }
  vdr::k6b::Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.bias_h = bias_h;
  p.bias_w = bias_w;
  p.kv_len = kv_len;
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.B = B;
  p.H = H;
  p.S = S;
  p.kh = bias ? kh : 0;
  p.kw = bias ? kw : 1;
  p.scale = scale;
  p.scale_log2 = vdr::k6b::scale_log2_bf16(scale);
  return vdr::k6b::launch(dkv_mma_kernel, p,
                          vdr::k6b::dkv_smem(bias ? kh + kw : 0), stream);
}

}  // extern "C"
