// Shared pieces of the port's trainable attention kernels (K4 window
// backward, K5 dq and dkv): the gradient operands, and mma.sync fragment
// loads for bf16 m16n8k16 tiles. The score recompute reuses the forward's
// pieces in flash_attention_core.cuh (AttnParams, tile coordinates, bias
// staging, key tables), so that a recomputed score is the forward's own:
// q pre-scaled by D^-1/2 * log2(e) and rounded to bf16 once, the bias
// terms pre-multiplied by log2(e) in fp32.
//
// Backward formulas (natural units; P the softmax, O the forward output):
//     D  = sum_d dO * O        dP = dO V^T        dS = P * (dP - D)
//     dq = scale dS K          dk = scale dS^T Q   dv = P^T dO
//     dbias_h[i, r] = sum over keys j of grid row r of dS[i, j]
//     dbias_w[i, c] = sum over keys j of grid column c of dS[i, j]
// Products take bf16 operands (P and dS rounded to bf16, as the JAX
// kernels do) with fp32 accumulation; the bias gradients sum dS in fp32.
#pragma once

#include "flash_attention_core.cuh"
#include "hopper.cuh"

namespace vdr {

using bf16 = __nv_bfloat16;

struct GradParams {
  const bf16* dout;    // (B, S, H*D) upstream gradient of the output
  const bf16* out;     // (B, S, H*D) forward output (K4 only)
  const float* lse;    // (B, H, S) log2 log-sum-exp (K5 only)
  const float* delta;  // (B, H, S) D = sum_d dO * O (K5 only)
  bf16* dq;            // (B, S, H*D)
  bf16* dkv;           // (B, S, 2*H*D)
  bf16* dbh;           // (B, H, S, kh) or nullptr
  bf16* dbw;           // (B, H, S, kw) or nullptr
  float scale;         // D^-1/2
};

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 scaled in fp32 and rounded back: the forward's pre-scaled q.
__device__ __forceinline__ uint32_t ld_pair_scaled(const bf16* p, float s) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return pack_bf16(__low2float(v) * s, __high2float(v) * s);
}

// A fragment (16 x 64, four k16 steps) of a row-major bf16 matrix: this
// thread's rows r_lo and r_hi = r_lo + 8 (rows >= nrows read as zero),
// columns 2c.. of each k16 step. kScale multiplies by s in fp32 first.
template <bool kScale>
__device__ __forceinline__ void load_a64(uint32_t a[4][4], const bf16* base,
                                         size_t ld, int r_lo, int r_hi,
                                         int nrows, int c, float s) {
  auto ld2 = [&](int r, int d) -> uint32_t {
    if (r >= nrows) return 0u;
    const bf16* ptr = base + (size_t)r * ld + d;
    return kScale ? ld_pair_scaled(ptr, s) : ld_pair(ptr);
  };
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    a[kt][0] = ld2(r_lo, kt * 16 + 2 * c);
    a[kt][1] = ld2(r_hi, kt * 16 + 2 * c);
    a[kt][2] = ld2(r_lo, kt * 16 + 2 * c + 8);
    a[kt][3] = ld2(r_hi, kt * 16 + 2 * c + 8);
  }
}

// B fragment of M^T where M is row-major with the mma's n index on its
// rows (keys of K in Q K^T): p points at M[n0 + g][k0 + 2c].
__device__ __forceinline__ void ld_b_rows(uint32_t b[2], const bf16* p) {
  b[0] = ld_pair(p);
  b[1] = ld_pair(p + 8);
}

// The same with the forward's pre-scaled q: Q^T as the B operand of
// K Q^T, scaled by s in fp32 and rounded to bf16 as the forward did.
__device__ __forceinline__ void ld_b_rows_scaled(uint32_t b[2], const bf16* p,
                                                 float s) {
  b[0] = ld_pair_scaled(p, s);
  b[1] = ld_pair_scaled(p + 8, s);
}

// B fragment of a row-major M with the mma's k index on its rows (V in
// P V): p points at M[k0 + 2c][n0 + g], ld is M's row stride.
__device__ __forceinline__ void ld_b_cols(uint32_t b[2], const bf16* p,
                                          int ld) {
  __nv_bfloat162 b0, b1;
  b0.x = p[0];
  b0.y = p[ld];
  b1.x = p[8 * ld];
  b1.y = p[9 * ld];
  b[0] = *reinterpret_cast<uint32_t*>(&b0);
  b[1] = *reinterpret_cast<uint32_t*>(&b1);
}

// Two adjacent 16x8 accumulator tiles as one 16x16 bf16 A fragment.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float x[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// Store this thread's part of a 16 x 64 fp32 accumulator, times s, as bf16
// into a row-major matrix (rows >= nrows are skipped).
__device__ __forceinline__ void store_c64(bf16* base, size_t ld,
                                          const float acc[8][4], int r_lo,
                                          int r_hi, int nrows, int c,
                                          float s) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int d = dt * 8 + 2 * c;
    if (r_lo < nrows)
      *reinterpret_cast<__nv_bfloat162*>(base + (size_t)r_lo * ld + d) =
          __floats2bfloat162_rn(acc[dt][0] * s, acc[dt][1] * s);
    if (r_hi < nrows)
      *reinterpret_cast<__nv_bfloat162*>(base + (size_t)r_hi * ld + d) =
          __floats2bfloat162_rn(acc[dt][2] * s, acc[dt][3] * s);
  }
}

// Copy `rows` rows of 64 bf16 (row stride ld in global memory) into a
// padded shared tile [nalloc][LD], zero-filling rows past `rows`.
template <int LD>
__device__ __forceinline__ void load_tile64(bf16* dst, const bf16* src,
                                            size_t ld, int rows,
                                            int nalloc) {
  for (int i = threadIdx.x; i < nalloc * 8; i += blockDim.x) {
    const int r = i / 8, d8 = (i % 8) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + d8);
    *reinterpret_cast<uint4*>(dst + r * LD + d8) = v;
  }
}

inline const char* error_string(int err) {
  if (err == -1) return "head dim has no kernel build (D=64 only)";
  if (err == -2) return "key-grid width not taken by this kernel";
  if (err == -3) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ---------------------------------------------------------------------------
// The Hopper bodies of the K5 backward (TMA + wgmma), shared by
// global_attention_bwd_dkv.cu and global_attention_bwd_dq.cu
// ---------------------------------------------------------------------------
namespace k5h {

constexpr int kD = 64;                 // head dim (the only build)
constexpr int kTile = 64 * kD * 2;     // one 64 x 64 bf16 tile (8 KB)
constexpr int kErrTensorMap = -3;
// bias_h grid rows the dq kernel's staged table takes (Kh * 512 bytes)
constexpr int kMaxGridRows = 128;

// The calls the Hopper bodies take (both kernels alike, so the route is
// one): head dim 64, and no bias or a key grid 64 keys wide, so that a
// 64-key tile is one grid row; the others keep the mma.sync loops.
__host__ __device__ inline bool takes(int D, bool has_bias, int kh, int kw) {
  return D == kD && (!has_bias || (kw == 64 && kh <= kMaxGridRows));
}

// The key-grid widths the three K5 kernels take with a bias: an 8-key mma
// tile lies in one grid row, and a 64-key tile holds whole grid rows (Kw
// 8..64) or half of one (Kw 128, which the mma.sync loops take).
__host__ __device__ inline bool bias_width_ok(int kw) {
  return kw == 8 || kw == 16 || kw == 32 || kw == 64 || kw == 128;
}

// Registers a thread under setmaxnreg in a block of `consumers` consumer
// warpgroups and one producer warpgroup. ptxas gives every thread of the
// launch 65536 / threads registers (rounded down to 8, so 168 at 384
// threads); the producer drops to kProducerRegs and the consumers take the
// rest of the block's share.
constexpr int kProducerRegs = 40;
__host__ __device__ constexpr int consumer_regs(int consumers) {
  return ((65536 / (128 * (consumers + 1)) / 8 * 8) * 128 * (consumers + 1) -
          128 * kProducerRegs) /
         (128 * consumers) / 8 * 8;
}

// A 64 x 64 product over D (4 k16 steps), both operands K-major 64 x 64
// tiles in shared memory: D(rows of a, rows of b) = a b^T.
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a,
                                           uint32_t b) {
  const uint64_t da = sm90::desc_sw128(a, 16, 1024);
  const uint64_t db = sm90::desc_sw128(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    sm90::Wgmma<64>::ss(d, da + 2 * kk, db + 2 * kk, kk > 0);
}

// d += A B, A from registers (64 rows x 64 k, four k16 fragments), B a
// 64 x 64 tile with its k index on the rows (MN-major, as V in P V).
__device__ __forceinline__ void product_rs(float (&d)[32],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt)
    sm90::Wgmma<64>::rs<1>(d, a[kt], sm90::desc_sw128(b + kt * 2048, 1024, 1024),
                           1);
}

// An accumulator (rows g, g + 8; columns 8i + 2c..) as bf16 A fragments
// of the next product, whose k index is the accumulator's column.
__device__ __forceinline__ void pack_a(const float (&s)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i / 2][(i & 1) * 2] = pack_bf16(s[4 * i], s[4 * i + 1]);
    a[i / 2][(i & 1) * 2 + 1] = pack_bf16(s[4 * i + 2], s[4 * i + 3]);
  }
}

// A swizzled 64 x 64 bf16 tile scaled by s in fp32 and rounded to bf16
// (the forward's pre-scaled q): the swizzle permutes 16-byte chunks, so
// chunk k of dst is chunk k of src scaled; threads `part` of `parts` take
// every parts-th chunk.
__device__ __forceinline__ void scale_tile(unsigned char* dst,
                                           const unsigned char* src, float s,
                                           int part, int parts) {
  for (int k = part; k < kTile / 16; k += parts) {
    const uint4 v = reinterpret_cast<const uint4*>(src)[k];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      o[i] = pack_bf16(__low2float(x) * s, __high2float(x) * s);
    }
    reinterpret_cast<uint4*>(dst)[k] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// Four 8 x 8 bf16 matrices, transposed: lane 8m + r gives the address of
// row r of matrix m; register m holds (row 2c, col g), (row 2c + 1, col g)
// of matrix m.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A bias term as the forward stages it: bf16 widened, times log2(e), in
// fp32 and never contracted into a later add.
__device__ __forceinline__ float term(__nv_bfloat16 x) {
  return __fmul_rn(__bfloat162float(x), kLog2e);
}

}  // namespace k5h

}  // namespace vdr
