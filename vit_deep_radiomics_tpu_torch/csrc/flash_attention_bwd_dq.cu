// K6 backward, dq: query gradient and both decomposed-bias gradients of
// trainable flash attention over per-head fp32 (B, H, S, D).
//
// Replaces: vit_deep_radiomics_tpu/ops/attention_grad.py::_bwd_dq_kernel
// (flash_attention_trainable's backward, a Pallas TPU kernel).
//
// A block owns 64 query rows of one (batch, head) and walks the keys in
// tiles of kCols. Per tile it rebuilds the forward's scores S
// (flash_trainable_core.cuh), takes P = exp2(S - lse), dP = dO V^T and
// dS = P (dP - D) in registers, with D = sum_d dO O per row, puts dS in
// shared memory once, then
//     dq += dS k                     (natural units; times D^-1/2 at the end)
//     dbias_h[i, r] = sum of dS[i, j] over the keys j of grid row r
//     dbias_w[i, c] = sum of dS[i, j] over the keys j of grid column c
// The bias sums are taken in a fixed order with no atomics, so any
// key-grid width works (SAM's 14-wide windows cut across every key tile).
// Where Kw is a multiple of kCols (SAM's global 64), a tile lies in one grid
// row and its keys in distinct columns: each thread adds its dS to the
// column sums in shared memory and, through a fixed shuffle tree, to its
// rows' running grid-row sums, written once a grid row is complete.
// Otherwise they are read back from the dS tile by one thread per (query,
// grid rows) and one per (query, grid columns), keys in ascending order.
// Keys at or past kv_len score -1e30; a kv_len 0 row visits every key at
// that score (P = 1, the plain version and JAX), keys past S -2e30.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 on the CUDA
// cores): 6 S^2 D FLOP per (batch, head) (q k^T, dO v^T, dS k) against
// about 7 S D words. At the `parity` path's shapes that is operations:
// SAM's global layers (2 x 12 x 4096 tokens) 155 GFLOP, 2.31 ms; SAM's
// windowed layers (50 x 12 x 196 tokens) 8.9 GFLOP, 0.13 ms, against
// 0.053 ms of traffic; DINOv2 ViT-B/14 (2 x 12 x 1536 tokens, 1370 valid
// keys) 19.4 GFLOP, 0.29 ms. The first design (two lanes a query row,
// every FMA's other operand streamed from shared memory, 254 registers,
// synchronous tiles) ran at 19% of the FMA rate: the load/store pipe paced
// it.
//
// What this design does about it: register tiles, as an SGEMM. Each thread
// computes a 4 x 4 micro-tile of S and dP (8 shared 16-byte loads feed 64
// FMAs) and owns 4 rows x 8 dims of dq (3 loads feed 32 FMAs); the two
// score chains of the forward run in one thread, so no shuffle. The next
// key tile (k, v, the grid-row bias terms it needs) arrives by cp.async
// into the second of two buffers while the current tile's products run.
// About 111 KB of shared memory at Kw = 64, so two blocks (8 warps) share
// an SM: with so few warps the 4 x 4 micro-tile's shared loads and the
// per-score steps (bias, exp2, the bias sums) still hold it to about 40%
// of the FMA rate (PERF.md, the probe's ablations).
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

constexpr int kCols = 32;    // keys a tile
constexpr int kStages = 2;   // tile buffers
constexpr int TC = kCols / TX;
constexpr int BSR = ROWS + 1;   // stride of a [term][row] bias array

__host__ __device__ int stage_floats(int nht) {
  return round4(2 * kCols * LD + nht * BSR);
}

size_t smem_bytes(int kw, int nht) {
  return (size_t)(2 * ROWS * LD + 2 * ROWS + 2 * round4(kw * BSR) +
                  kStages * stage_floats(nht) + kCols * LP) *
         sizeof(float);
}

// kw grid columns (0 without a bias); nht grid-row terms staged per key
// tile, the most a tile of kCols keys can span.
__global__ void __launch_bounds__(NT, 2) dq_kernel(Params p, int kw,
                                                    int nht) {
  extern __shared__ __align__(16) float smem[];
  const int sf = stage_floats(nht);
  float* qs = smem;                        // [ROWS][LD] pre-scaled q
  float* dos = qs + ROWS * LD;             // [ROWS][LD] dO
  float* lse_s = dos + ROWS * LD;          // [ROWS]
  float* dl_s = lse_s + ROWS;              // [ROWS]
  float* bw_s = dl_s + ROWS;               // [kw][BSR] bias_w * log2(e)
  float* dbw_s = bw_s + round4(kw * BSR);  // [kw][BSR] dbias_w sums
  float* stages = dbw_s + round4(kw * BSR);  // kStages x (k, v, bias_h)
  float* dss = stages + kStages * sf;      // [kCols][LP] dS^T

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * ROWS;
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const size_t bh = (size_t)b * p.H + h;
  const size_t base = bh * p.S * D;
  const int nrows = min(ROWS, p.S - row0);
  const int n_keys = valid_keys(p, b);
  const int lim = n_keys == 0 ? p.S : n_keys;   // keys visited
  const bool has_bias = p.bias_h != nullptr;
  const bool tile_bias = has_bias && kw % kCols == 0;
  float hsum[TR] = {};   // grid-row sums of this thread's rows (tile_bias)

  auto fetch = [&](int t, float* st) {
    const int k0 = t * kCols, nk = min(kCols, p.S - k0);
    copy_rows<kCols>(st, p.k + base + (size_t)k0 * D, nk);
    copy_rows<kCols>(st + kCols * LD, p.v + base + (size_t)k0 * D, nk);
    if (!has_bias) return;
    const int kr0 = k0 / kw;
    float* bs = st + 2 * kCols * LD;
    for (int i = threadIdx.x; i < ROWS * nht; i += NT) {
      const int r = i / nht, slot = i % nht;
      const bool ok = r < nrows && kr0 + slot < p.kh;
      const size_t row = bh * p.S + row0 + (ok ? r : 0);
      cp_async4(bs + slot * BSR + r,
                p.bias_h + row * p.kh + (ok ? kr0 + slot : 0), ok);
    }
  };

  // P = exp2(S - lse) and dS = P (dP - D), in place in dp. A tile that
  // holds a key at or past kv_len (every tile of a kv_len 0 row) or past S
  // masks its scores; the others take no test.
  auto p_ds = [&](float (&s)[TR][TC], float (&dp)[TR][TC], const float* st,
                  int k0) {
    const float* bhs = st + 2 * kCols * LD;
    const bool edge = k0 + kCols > n_keys;
    int hs[TC], wc[TC];
    if (has_bias) {
      const int kr0 = k0 / kw, c0 = k0 - kr0 * kw;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        int c = c0 + tx + TX * j, r = 0;
        while (c >= kw) {
          c -= kw;
          ++r;
        }
        hs[j] = r;
        wc[j] = c;
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int row = ty + TY * i, key = k0 + tx + TX * j;
        float sv = s[i][j];
        if (has_bias && (!edge || key < p.S))
          sv = with_bias(sv, bias_log2(bhs[hs[j] * BSR + row]),
                         bw_s[wc[j] * BSR + row]);
        if (edge) sv = key >= p.S ? kPastS : key >= n_keys ? kNegInf : sv;
        dp[i][j] = exp2f(sv - lse_s[row]) * (dp[i][j] - dl_s[row]);
      }
    if (!tile_bias) return;
    // Kw a multiple of kCols: the tile lies in one grid row and its keys in
    // distinct grid columns, so each thread adds its own dS to the column
    // sums and, through a fixed shuffle tree over the 8 lanes of a row, to
    // the running sums of its rows' grid row.
    const int c0 = k0 % kw;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = ty + TY * i;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        dbw_s[(c0 + tx + TX * j) * BSR + row] += dp[i][j];
        rs += dp[i][j];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      hsum[i] += rs;
    }
  };

  // Write the grid-row sums of this thread's rows as grid row r.
  auto put_rows = [&](int r) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = ty + TY * i;
      if (tx == 0 && row < nrows)
        p.dbh[(bh * p.S + row0 + row) * p.kh + r] = hsum[i];
      hsum[i] = 0.f;
    }
  };

  if (kStages == 2) fetch(0, stages);
  cp_async_commit();
  // The block's rows: q pre-scaled (one rounding, as the forward), dO, lse,
  // D, bias_w times log2(e); zero past S.
  for (int i = threadIdx.x; i < ROWS * (D / 4); i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (r < nrows) {
      const size_t o = base + (size_t)(row0 + r) * D + c;
      x = ld4(p.q + o);
      y = ld4(p.dout + o);
      x.x = __fmul_rn(x.x, p.scale_log2);
      x.y = __fmul_rn(x.y, p.scale_log2);
      x.z = __fmul_rn(x.z, p.scale_log2);
      x.w = __fmul_rn(x.w, p.scale_log2);
    }
    *reinterpret_cast<float4*>(qs + r * LD + c) = x;
    *reinterpret_cast<float4*>(dos + r * LD + c) = y;
  }
  for (int i = threadIdx.x; i < ROWS; i += NT) {
    lse_s[i] = i < nrows ? p.lse[bh * p.S + row0 + i] : 0.f;
    dl_s[i] = i < nrows ? p.delta[bh * p.S + row0 + i] : 0.f;
  }
  for (int i = threadIdx.x; i < ROWS * kw; i += NT) {
    const int r = i / kw, c = i % kw;
    bw_s[c * BSR + r] =
        r < nrows ? bias_log2(p.bias_w[(bh * p.S + row0) * kw + i]) : 0.f;
    dbw_s[c * BSR + r] = 0.f;
  }

  // The bias sums of this thread: query row qr, grid rows (role 0) or
  // grid columns (role 1); (brow, bcol) is the next key's grid cell.
  const int qr = threadIdx.x % ROWS, role = threadIdx.x / ROWS;
  const size_t dbh_row = (bh * p.S + row0 + qr) * p.kh;
  int brow = 0, bcol = 0;
  float bacc = 0.f;
  auto bias_sums = [&](int k0) {
    const int nk = min(kCols, p.S - k0);   // keys past S have no cell
    for (int c = 0; c < nk; ++c) {
      const float ds = dss[c * LP + qr];
      if (role == 0) {
        bacc += ds;
      } else {
        dbw_s[bcol * BSR + qr] += ds;
      }
      if (++bcol == kw) {
        bcol = 0;
        if (role == 0 && qr < nrows) p.dbh[dbh_row + brow] = bacc;
        bacc = 0.f;
        ++brow;
      }
    }
  };

  float dq[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) dq[i][e] = 0.f;
  const int nt = (lim + kCols - 1) / kCols;
  for (int t = 0; t < nt; ++t) {
    float* st = stages + (kStages == 2 ? (t & 1) : 0) * sf;
    if (kStages == 1) {
      __syncthreads();
      fetch(t, st);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();
    float s[TR][TC] = {}, dp[TR][TC] = {};  // zero for the no_scores probe
    score_tile(s, qs, st);
    dp_tile(dp, dos, st + kCols * LD);
    p_ds(s, dp, st, t * kCols);
    store_cols(dss, dp);
    // the next tile loads during the products (its buffer's last readers
    // finished before this tile's first barrier)
    if (kStages == 2 && t + 1 < nt) {
      fetch(t + 1, stages + ((t + 1) & 1) * sf);
      cp_async_commit();
    }
    __syncthreads();
    accumulate<kCols>(dq, dss, st);
    if (tile_bias && (t + 1) * kCols % kw == 0) put_rows(t * kCols / kw);
    if (has_bias && !tile_bias) bias_sums(t * kCols);
  }
  store_rows(p.dq + base + (size_t)row0 * D, dq, nrows, p.scale);
  if (!has_bias) return;
  // grid rows cut short or never reached (keys past kv_len): their dS is 0
  if (tile_bias) {
    int r = nt * kCols / kw;
    if (nt * kCols % kw) put_rows(r++);
    for (; r < p.kh; ++r) put_rows(r);
  } else if (role == 0 && qr < nrows) {
    if (bcol) p.dbh[dbh_row + brow++] = bacc;
    for (; brow < p.kh; ++brow) p.dbh[dbh_row + brow] = 0.f;
  }
  __syncthreads();
  const size_t brow0 = (bh * p.S + row0) * kw;
  for (int i = threadIdx.x; i < nrows * kw; i += NT)
    p.dbw[brow0 + i] = dbw_s[(i % kw) * BSR + i / kw];
}

// bf16: the mma.sync body of flash_trainable_bf16.cuh
__global__ void __launch_bounds__(vdr::k6b::NT)
    dq_mma_kernel(const vdr::k6b::Params p) {
  extern __shared__ __align__(16) char smem_mma[];
  vdr::k6b::dq(p, blockIdx.z, blockIdx.y, blockIdx.x * vdr::k6b::ROWS,
               smem_mma);
}


// bf16 with no bias or a key grid the Hopper bodies take: the dq body
// built for the grid's width (tiles of 48 keys with no bias)
template <bool kBias, int kKw>
int dq_hopper_at(const vdr::k6h::Params& p, const CUtensorMap (&m)[4], int B,
                 cudaStream_t stream) {
  namespace h = vdr::k6h;
  return h::launch(h::dq_hopper_kernel<kBias, kKw>,
                   vdr::k6b::hopper_dq_smem(kBias ? kKw : 0, p.kh),
                   (p.S + h::kDqRows - 1) / h::kDqRows, B, p, stream, m[0],
                   m[1], m[2], m[3]);
}

// the instance of width p.kw among kKw, kKw + 4, ... kHopperMaxKw
template <int kKw>
int dq_hopper_kw(const vdr::k6h::Params& p, const CUtensorMap (&m)[4], int B,
                 cudaStream_t stream) {
  if constexpr (kKw > vdr::k6b::kHopperMaxKw) {
    return vdr::k6b::kErrTerms;
  } else {
    constexpr int kNext = kKw + vdr::k6b::kHopperKwStep;
    return p.kw == kKw ? dq_hopper_at<true, kKw>(p, m, B, stream)
                       : dq_hopper_kw<kNext>(p, m, B, stream);
  }
}

int dq_hopper(const void* q, const void* k, const void* v, const void* dout,
              const vdr::k6h::Params& p, int B, cudaStream_t stream) {
  namespace h = vdr::k6h;
  const bool bias = p.bias_h != nullptr;
  const int tile =
      bias ? vdr::k6b::hopper_dq_tile(p.kw) : vdr::k6b::kHopperNoBiasTile;
  CUtensorMap m[4];
  if (!h::qkv_maps(m, q, k, v, dout, p.S, B * p.H, tile))
    return h::kErrTensorMap;
  if (!bias)
    return dq_hopper_at<false, vdr::k6b::kHopperNoBiasTile>(p, m, B, stream);
  return dq_hopper_kw<16>(p, m, B, stream);
}
}  // namespace

extern "C" {

const char* vdr_error_string(int err) { return vdr::k6::error_string(err); }

// The body the K6 backward kernels (dq and dkv alike: the dkv source has
// no entry of its own) run for a call (dtype 0 fp32, 1 bf16): 0 the
// register-tiled CUDA-core bodies (fp32), 1 the mma.sync bodies, 2 the
// Hopper bodies (bf16); -1 for a head dim other than 64, -2 for a bf16 bias
// grid of more than vdr::k6b::kMaxTerms terms.
int vdr_flash_attention_bwd_route(int dtype, int D, int has_bias, int kh,
                                  int kw) {
  if (D != vdr::k6::D) return -1;
  if (dtype == 0) return 0;
  return vdr::k6b::bwd_route(has_bias != 0, kh, kw);
}

// fp32. Returns 0 on success, a cudaError_t after a failed attribute call
// or launch, or -1 for a head dim other than 64.
int vdr_flash_attention_bwd_dq(const float* q, const float* k,
                               const float* v, const float* bias_h,
                               const float* bias_w, const int* kv_len,
                               const float* dout, const float* lse,
                               const float* delta, float* dq, float* dbh,
                               float* dbw, int B, int H, int S, int D, int kh,
                               int kw, float scale, void* stream) {
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
  p.dq = dq;
  p.dbh = dbh;
  p.dbw = dbw;
  p.B = B;
  p.H = H;
  p.S = S;
  p.kh = bias_h != nullptr ? kh : 0;
  p.kw = bias_h != nullptr ? kw : 1;
  p.scale = scale;
  p.scale_log2 = scale * vdr::k6::kLog2e;
  const int bkw = bias_h != nullptr ? kw : 0;
  int nht = 0;
  if (bias_h != nullptr) {
    nht = (kCols - 1) / kw + 2;   // grid rows a key tile can span
    nht = nht < kh ? nht : kh;
  }
  return vdr::k6::bwd::launch(dq_kernel, p, smem_bytes(bkw, nht), stream,
                              bkw, nht);
}

// bf16 q, k, v, dO and dq; fp32 bias, lse, delta and bias gradients: the
// Hopper body of flash_trainable_hopper.cuh or the mma.sync one, as
// vdr_flash_attention_bwd_route says; the code of the body launched is
// written to *body unless it is null. Returns 0 on success, a cudaError_t
// after a failed attribute call or launch, -1 for a head dim other than
// 64, -2 for a bias grid of more than vdr::k6b::kMaxTerms terms, or -3 when
// a TMA descriptor cannot be made.
int vdr_flash_attention_bwd_dq_bf16(const void* q, const void* k,
                                    const void* v, const float* bias_h,
                                    const float* bias_w, const int* kv_len,
                                    const void* dout, const float* lse,
                                    const float* delta, void* dq, float* dbh,
                                    float* dbw, int B, int H, int S, int D,
                                    int kh, int kw, float scale,
                                    void* stream, int* body) {
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
    hp.dq = static_cast<bf16*>(dq);
    hp.dbh = dbh;
    hp.dbw = dbw;
    hp.H = H;
    hp.S = S;
    hp.kh = bias ? kh : 0;
    hp.kw = bias ? kw : 0;
    hp.scale_log2 = vdr::k6b::scale_log2_bf16(scale);
    hp.scale = scale;
    return dq_hopper(q, k, v, dout, hp, B,
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
  p.dq = static_cast<bf16*>(dq);
  p.dbh = dbh;
  p.dbw = dbw;
  p.B = B;
  p.H = H;
  p.S = S;
  p.kh = bias ? kh : 0;
  p.kw = bias ? kw : 1;
  p.scale = scale;
  p.scale_log2 = vdr::k6b::scale_log2_bf16(scale);
  return vdr::k6b::launch(
      dq_mma_kernel, p,
      vdr::k6b::dq_smem(bias ? kh + kw : 0, bias ? kw : 0), stream);
}

}  // extern "C"
