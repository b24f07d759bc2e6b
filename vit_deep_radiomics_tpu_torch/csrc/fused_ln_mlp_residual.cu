// K7: fused LayerNorm -> MLP -> residual, the second half of a ViT block.
//
// Replaces: vit_deep_radiomics_tpu/ops/mlp_fused.py::fused_ln_mlp_residual
// (`_kernel`, the Pallas TPU kernel behind VDR_FUSED_MLP=1).
//
// Computes, per row of x (rows, C):
//   y   = LN(x) with fp32 statistics, rounded to x's type
//   h   = y . w1^T + b1             (fp32 accumulator, fp32 bias)
//   g   = gelu_tanh(h) in fp32, rounded to x's type
//   o   = g . w2^T + b2             (fp32 accumulator), rounded to x's type
//   o   = o * ls                    (x's type; only with a layerscale)
//   out = x + o                     (x's type)
// the cast points of the JAX kernel. w1 is (H, C) and w2 (C, H), the
// layouts of torch Linear weights; LN scale/bias and b1/b2 are fp32.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at SAM
// ViT-B/16's rows at batch 4 (16384 x 768, hidden 3072) it does 154.6
// GFLOP (0.156 ms at the bf16 peak) against 59 MB of compulsory traffic
// (x in, out, both weights once: 0.018 ms): operations bound it. But the
// (rows x 768) fp32 accumulator of the second product is the design
// constraint: 64 rows of it fill 192 registers a thread of two warpgroups,
// so a block holds 64 rows and streams both whole weights (9.4 MB) from L2
// for every 64 rows, and shared memory (the 96 KB y tile beside the ring)
// caps the weight bytes in flight: the stream's latency holds the body.
//
// What the Hopper body does about it (bf16, C = 768, H a multiple of 128:
// SAM ViT-B/16 and DINOv2 ViT-B/14; vdr_fused_ln_mlp_residual_route says
// "hopper"):
//  * persistent blocks of two warpgroups (256 threads: 255 registers a
//    thread, where a third, producer warpgroup would hold every thread to
//    168), one 64-row tile at a time;
//  * the tile's rows are normalised once (fp32 statistics) into a bf16,
//    128-byte-swizzled, K-major y tile (96 KB), the A operand of the first
//    product, fenced for the async proxy;
//  * the hidden dimension is walked in chunks of kChunkH (128). Warpgroup
//    w computes hidden units 64 w .. 64 w + 63 of the chunk (wgmma
//    m64n64k16 over the 768 columns of y), adds b1, applies JAX's tanh
//    GELU in registers (tanhf, as the loops and the plain version) and
//    writes its half of the chunk's g tile (bf16,
//    swizzled; two buffers), then both pass a named barrier; for the
//    second product warpgroup w owns output columns 384 w .. 384 w + 383
//    (three m64n128k16 a k step into 192 fp32 accumulators) over the whole
//    g chunk;
//  * the weights come by TMA, in the order each warpgroup uses them, into
//    a ring of kStagesH 16 KB slots per warpgroup on mbarriers (no weight
//    byte is read by both warpgroups). Thread 0 of each warpgroup is its
//    producer: it refills a slot once the warpgroup's wgmma on it is done,
//    and the stream runs on into the next tile's weights;
//  * the epilogue (+ b2, round, x ls, + x re-read) writes the bf16 tile
//    over the now dead y tile and stores it by TMA; rows past `rows` are
//    normalised as zeros and clipped by the store.
// What the cluster body does at C 1536 (bf16, H a multiple of 256: DINOv2
// ViT-g/14, hidden 6144; the route says "cluster"). Its work at ViT-g/14's
// rows at batch 4 (5480 x 1536) is 207 GFLOP (0.209 ms at the bf16 peak)
// against 71 MB of compulsory traffic (0.021 ms): operations bound it. The
// C 768 design does not stretch: a 64-row tile's fp32 output at C 1536 is
// 98,304 values, more than an SM's 65,536 registers, and its bf16 y tile
// alone would take 192 KB of shared memory. So:
//  * a cluster of kClusterC (4) blocks owns a 128-row tile (kRowsC): block
//    `rank` owns output columns 384 rank .. 384 rank + 383, its warpgroup w
//    rows 64 w .. 64 w + 63 of them (three m64n128 accumulators, 192 fp32
//    a thread, the C 768 body's budget). Both warpgroups read every weight
//    slot of their block, so each weight byte is read from L2 once per 128
//    rows (the loops: once per 32);
//  * each 256-unit hidden chunk's first product is split among the four
//    blocks (64 units each: m64n64k16 over the 24 k blocks of y, no
//    operation done twice); a block's bf16 GELU output, its 16 KB piece of
//    the chunk's g tile, reaches the other three blocks by bulk copies
//    between shared memories (cp.async.bulk shared::cta -> shared::cluster,
//    completed on each receiver's `gfull` mbarrier); each receiving
//    warpgroup announces on the sender's `gfree` mbarrier (remote
//    arrivals) when the chunk's second product is done with it, one g
//    tile (64 KB) in all;
//  * y: a LayerNorm prologue (mlp_ln_kernel, the loops' fp32 statistics)
//    writes y once to a bf16 (rows, 1536) scratch that the wrapper
//    allocates, and the body streams y's 64-column k blocks by TMA: each
//    block loads a quarter (32 rows) of the tile's slice and multicasts it
//    to the four (cp.async.bulk.tensor ... multicast::cluster). A y split
//    by K across blocks would keep 96 KB a block resident but add an fp32
//    exchange of partial h and a second sum order; the scratch keeps each
//    h a single wgmma chain over all 1536 columns and costs about 0.4 GB
//    of L2 reads a call;
//  * one ring of kStagesC (3) 48 KB slots carries, per chunk, 12
//    first-product slots (two k blocks: 32 KB of y, 16 KB of the block's
//    w1) and 4 second-product slots (w2: the block's 384 output rows x 64
//    units), each one wgmma group, waited for at once; each warpgroup then
//    releases the slot in all four blocks (lane 0 of its warp r arrives at
//    rank r), so a block's `empty` barrier completes once the cluster is
//    done with it. The second product takes the block's own g piece first,
//    so the other pieces' copies overlap its first step;
//  * no producer warp or warpgroup: in this source ptxas allocates every
//    warp at the launch cap whatever setmaxnreg asks (168 registers at 288
//    or 384 threads), and 224 accumulators do not fit in 168. Thread 0 of
//    each warpgroup produces every other slot, its state one register (the
//    slot's index, placed by the chunk being consumed), issuing at most
//    one slot at the start of each of its waits and polling while the rest
//    of its warp waits at __syncwarp;
//  * the epilogue (+ b2, round, x ls, + x) stores straight from registers;
//    rows past `rows` read y as zeros (the tensor map's edge) and are not
//    stored.
// Budget at ViT-g/14's 5480 rows (43 tiles): 128 rows a weight pass; L2
// reads 1.62 GB of weights (43 x 37.7 MB) + 0.41 GB of y (43 x 24 chunks x
// 384 KB) = 2.0 GB a call; shared memory 64 KB (g) + 3 x 48 KB (ring) +
// 1 KB of alignment = 209 KB a block, one block an SM; 256 threads at 255
// registers (224 accumulators), no spill. Schedule: persistent clusters,
// as many as the card holds at once (cudaOccupancyMaxActiveClusters), each
// walking tiles cid, cid + clusters, ..: 43 tiles on at most 33 clusters
// are two rounds, the second a third full. Predicted before the first card
// run: about 0.55 ms, held by the L2 stream. Measured on an H100 SXM
// (PERF.md): 0.91 ms, 4.4 times its bound and 4 times faster than the
// loops, and not held by L2 or the ring: a call is two rounds of equal
// time whatever the ring depth or the multicast. A 128-row tile takes
// 0.45 ms, 1.2 us a slot against about 0.5 us of tensor and shared-memory
// work: the producers' barrier tests and issues and the remote arrivals
// sit on the warpgroups' path.
// fp32 inputs (the JAX tests' type; not on the card's main path), bf16 at C
// 384 or 1024, and bf16 at C 1536 with H not a multiple of 256 keep the
// first version's loops below: 32-row (bf16, mma.sync) or 16-row (fp32,
// CUDA cores, fp32 FMAs and no TF32) blocks that re-read all of w1 and w2
// from L2 per block. The fp32 loop stages its weight chunks synchronously
// (at C 1536 in 8-unit chunks: its bound at ViT-g/14's rows, 207 GFLOP at
// 67 TFLOP/s, is 3.1 ms; the L2 re-reads, 75 MB a 16-row block, hold it
// further off; PERF.md has its time); the bf16 loop by
// cp.async, each chunk's w1 while the chunk before runs its second product
// and its w2 while its own first product runs. At C 1536 32-unit chunks
// would take 323 KB of shared memory, so its instance keeps 32-row blocks
// with 16-unit chunks (222 KB): two warps share each m16n8 tile of a
// chunk's first product, half of the y columns each, and add their partial
// sums through shared memory; 192 fp32 accumulators a thread (255
// registers, no spill). At ViT-g/14's rows it re-reads 6.5 GB from L2 a
// call: 3.65 ms on an H100 SXM (PERF.md), 17 times its bound.

#include "hopper.cuh"

namespace {

struct MlpParams {
  const void* x;          // (rows, C)
  const float* ln_scale;  // (C,)
  const float* ln_bias;   // (C,)
  const void* w1;         // (H, C)
  const float* b1;        // (H,)
  const void* w2;         // (C, H)
  const float* b2;        // (C,)
  const void* ls;         // (C,) or nullptr
  void* out;              // (rows, C)
  int rows, H;
  float eps;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// round to T and back: the cast points of the JAX kernel
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

// JAX's tanh GELU: x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;
  const float inner = k * (x + 0.044715f * (x * x * x));
  return x * (0.5f * (1.f + tanhf(inner)));
}

// LayerNorm of `nrows` rows starting at row0 into ys (row stride ld),
// rounded to T; one warp per row, rows past p.rows are zero.
template <typename T, int C>
__device__ void layer_norm_rows(const MlpParams& p, int row0, int nrows,
                                T* ys, int ld) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const T* x = static_cast<const T*>(p.x);
  for (int r = warp; r < nrows; r += nwarps) {
    const int row = row0 + r;
    T* dst = ys + r * ld;
    if (row >= p.rows) {
      for (int c = lane; c < C; c += 32) dst[c] = from_f32<T>(0.f);
      continue;
    }
    const T* src = x + (size_t)row * C;
    float v[C / 32];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      v[i] = to_f32(src[lane + 32 * i]);
      sum += v[i];
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / C;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const float d = v[i] - mean;
      sq += d * d;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float inv = 1.f / sqrtf(sq / C + p.eps);
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      dst[c] = from_f32<T>((v[i] - mean) * inv * p.ln_scale[c] +
                           p.ln_bias[c]);
    }
  }
}

// Epilogue of one output element: o = T(acc + b2), * ls, + x.
template <typename T>
__device__ __forceinline__ T finish(const MlpParams& p, int row, int col,
                                    float acc, int C) {
  float o = rnd<T>(acc + p.b2[col]);
  if (p.ls != nullptr) o = rnd<T>(o * to_f32(static_cast<const T*>(p.ls)[col]));
  const float xv = to_f32(static_cast<const T*>(p.x)[(size_t)row * C + col]);
  return from_f32<T>(xv + o);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// the loops' bf16 blocks at C 384, 768 and 1024: 32 rows, 32-unit hidden
// chunks; at C 1536 (DINOv2 ViT-g/14) 32 rows and 16-unit chunks, so that
// the staged y rows and weight chunks fit in shared memory (222 KB)
constexpr int kRows = 32, kChunk = 32, kThreads = 256;
constexpr int kRowsG = 32;
constexpr int kChunkG = 16;

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes global -> shared without a register round trip (L2 only), so a
// thread's copies of a weight chunk are all in flight at once
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   vdr::sm90::smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `kPending` committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// R rows a block, CH hidden units a chunk. The first product of a chunk is
// MT x (CH / 8) m16n8 tiles; with fewer tiles than the 8 warps, KS warps
// share a tile, each over C / KS of the y columns, and add their partial
// sums through shared memory (part: one float4 a lane of every warp).
template <int C, int R, int CH>
struct Bf16Layout {
  static constexpr int MT = R / 16;               // m16 row tiles
  static constexpr int HT = MT * (CH / 8);        // first-product tiles
  static constexpr int KS = (kThreads / 32) / HT; // warps a tile
  static_assert(HT * KS == kThreads / 32 && C % (16 * KS) == 0,
                "the first product's tiles must split over the warps");
  static constexpr int LDY = C + 8;        // ys and w1s row (elements)
  static constexpr int LDW2 = CH + 8;      // w2s row
  static constexpr int LDG = CH + 8;       // gs row
  static constexpr size_t part_bytes =
      KS > 1 ? sizeof(float) * 4 * kThreads : 0;
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) *
          ((size_t)R * LDY + (size_t)CH * LDY + (size_t)C * LDW2 +
           (size_t)R * LDG) +
      part_bytes;
  static_assert(bytes <= 227 * 1024, "K7's loop tiles exceed 227 KB");
};

// Fragments (PTX ISA, mma.m16n8k16 .bf16), lane = 4*g + c:
//   A (16x16): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..), a2 = (g, 2c+8..),
//              a3 = (g+8, 2c+8..)
//   B (16x8):  b0 = (k 2c..2c+1, n g), b1 = (k 2c+8..2c+9, n g)
//   C (16x8):  c0,c1 = (g, 2c..2c+1), c2,c3 = (g+8, 2c..2c+1)
template <int C, int R, int CH>
__global__ void __launch_bounds__(kThreads)
    mlp_bf16_kernel(MlpParams p) {
  using L = Bf16Layout<C, R, CH>;
  constexpr int MT = L::MT, KS = L::KS;
  constexpr int NT = C / 64;  // output n8 tiles per warp (C / 8 columns)
  constexpr int KC = C / KS;  // y columns a warp's first product covers
  extern __shared__ __align__(16) char smem_raw[];
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* w1s = ys + R * L::LDY;
  __nv_bfloat16* w2s = w1s + CH * L::LDY;
  __nv_bfloat16* gs = w2s + C * L::LDW2;
  float* part = reinterpret_cast<float*>(gs + R * L::LDG);  // KS > 1
  const __nv_bfloat16* w1 = static_cast<const __nv_bfloat16*>(p.w1);
  const __nv_bfloat16* w2 = static_cast<const __nv_bfloat16*>(p.w2);

  const int row0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  // this warp's h tile and its share of the y columns
  const int hm = (warp % L::HT) / (CH / 8), hn = warp % (CH / 8);
  const int kbeg = (warp / L::HT) * KC;
  const int ocol0 = warp * (C / 8);        // this warp's output columns

  // w1 rows h0..h0+CH-1 (contiguous) and w2 columns h0..h0+CH-1 of every
  // row, each one cp.async group. A chunk's w1 is fetched while the chunk
  // before runs its second product, its w2 while its own first product
  // runs: at most two groups in flight, waited for in order.
  auto fetch_w1 = [&](int h0) {
    if (h0 < p.H)
      for (int i = threadIdx.x; i < CH * (C / 8); i += kThreads) {
        const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
        cp_async16(w1s + r * L::LDY + c8, w1 + (size_t)(h0 + r) * C + c8);
      }
    cp_async_commit();
  };
  auto fetch_w2 = [&](int h0) {
    if (h0 < p.H)
      for (int i = threadIdx.x; i < C * (CH / 8); i += kThreads) {
        const int r = i / (CH / 8), c8 = (i % (CH / 8)) * 8;
        cp_async16(w2s + r * L::LDW2 + c8, w2 + (size_t)r * p.H + h0 + c8);
      }
    cp_async_commit();
  };
  fetch_w1(0);
  fetch_w2(0);
  layer_norm_rows<__nv_bfloat16, C>(p, row0, R, ys, L::LDY);

  for (int h0 = 0; h0 < p.H; h0 += CH) {
    cp_async_wait<1>();   // this chunk's w1 (its w2 may be in flight)
    __syncthreads();      // ys ready (first pass); w1s complete
    // h tile (16 rows x 8 hidden units) over this warp's KC columns of y
    float h[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int k0 = kbeg; k0 < kbeg + KC; k0 += 16) {
      const __nv_bfloat16* ar = ys + (hm * 16 + g) * L::LDY + k0 + 2 * c;
      const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * L::LDY), ld32(ar + 8),
                             ld32(ar + 8 * L::LDY + 8)};
      const __nv_bfloat16* br = w1s + (hn * 8 + g) * L::LDY + k0 + 2 * c;
      const uint32_t b[2] = {ld32(br), ld32(br + 8)};
      mma_bf16_16816(h, a, b);
    }
    if constexpr (KS > 1) {
      // the tile's first warp adds the others' partial sums, in warp order
      *reinterpret_cast<float4*>(part + 4 * threadIdx.x) =
          make_float4(h[0], h[1], h[2], h[3]);
      __syncthreads();
      if (warp < L::HT) {
#pragma unroll
        for (int s = 1; s < KS; ++s) {
          const float4 o = *reinterpret_cast<const float4*>(
              part + 4 * (threadIdx.x + s * L::HT * 32));
          h[0] += o.x;
          h[1] += o.y;
          h[2] += o.z;
          h[3] += o.w;
        }
      }
    }
    __syncthreads();      // every warp is done with w1s (and part)
    fetch_w1(h0 + CH);
    if (warp < L::HT) {
      const int col = hn * 8 + 2 * c;
      const float bb0 = p.b1[h0 + col], bb1 = p.b1[h0 + col + 1];
      __nv_bfloat16* g0 = gs + (hm * 16 + g) * L::LDG + col;
      *reinterpret_cast<__nv_bfloat162*>(g0) = __floats2bfloat162_rn(
          gelu_tanh(h[0] + bb0), gelu_tanh(h[1] + bb1));
      *reinterpret_cast<__nv_bfloat162*>(g0 + 8 * L::LDG) =
          __floats2bfloat162_rn(gelu_tanh(h[2] + bb0),
                                gelu_tanh(h[3] + bb1));
    }
    cp_async_wait<1>();   // this chunk's w2 (the next w1 may be in flight)
    __syncthreads();
    // acc += g (R x CH) . w2 chunk, this warp's C / 8 columns
#pragma unroll
    for (int ks = 0; ks < CH; ks += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* ar = gs + (i * 16 + g) * L::LDG + ks + 2 * c;
        a[i][0] = ld32(ar);
        a[i][1] = ld32(ar + 8 * L::LDG);
        a[i][2] = ld32(ar + 8);
        a[i][3] = ld32(ar + 8 * L::LDG + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* br =
            w2s + (ocol0 + j * 8 + g) * L::LDW2 + ks + 2 * c;
        const uint32_t b[2] = {ld32(br), ld32(br + 8)};
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16_16816(acc[i][j], a[i], b);
      }
    }
    __syncthreads();      // every warp is done with w2s and gs
    fetch_w2(h0 + CH);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + i * 16 + g + 8 * half;
      if (row >= p.rows) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = ocol0 + j * 8 + 2 * c;
        __nv_bfloat162 v;
        v.x = finish<__nv_bfloat16>(p, row, col, acc[i][j][2 * half], C);
        v.y = finish<__nv_bfloat16>(p, row, col + 1, acc[i][j][2 * half + 1],
                                    C);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * C + col) = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, RF rows per block, CF-wide hidden chunks
// ---------------------------------------------------------------------------

// 16 rows and 16-unit chunks up to C 1024; at C 1536 those tiles would take
// 296 KB of shared memory, so its instance keeps 16-row blocks with 8-unit
// chunks (197 KB) and two threads share each (row, hidden unit) dot
// product, half of the y columns each, added in a fixed order
constexpr int kRowsF = 16, kChunkF = 16, kChunkF1536 = 8;

template <int C, int RF, int CF>
struct F32Layout {
  static constexpr int LDY = C + 1;   // odd strides: the y and w1 rows a
  static constexpr int LDW1 = C + 1;  // warp reads at once sit on distinct
                                      // banks
  static constexpr int PAIRS = RF * CF;           // (row, unit) dot products
  static constexpr int PARTS = kThreads / PAIRS;  // threads a dot product
  static_assert(PARTS * PAIRS == kThreads && C % PARTS == 0,
                "K7's fp32 tiles must split the dot products evenly");
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)RF * LDY + (size_t)CF * LDW1 + (size_t)CF * C +
                       (size_t)PARTS * PAIRS);
};

template <int C, int RF, int CF>
__global__ void __launch_bounds__(kThreads) mlp_f32_kernel(MlpParams p) {
  using L = F32Layout<C, RF, CF>;
  constexpr int CPT = (C + kThreads - 1) / kThreads;  // columns per thread
  constexpr int KP = C / L::PARTS;                    // y columns a part
  extern __shared__ __align__(16) char smem_raw[];
  float* ys = reinterpret_cast<float*>(smem_raw);  // [row][LDY]
  float* w1s = ys + RF * L::LDY;                   // [hidden][LDW1]
  float* w2s = w1s + CF * L::LDW1;                 // [hidden][C] (w2^T)
  float* gs = w2s + CF * C;                        // [part][row][hidden]
  const float* w1 = static_cast<const float*>(p.w1);
  const float* w2 = static_cast<const float*>(p.w2);
  const int row0 = blockIdx.x * RF;
  layer_norm_rows<float, C>(p, row0, RF, ys, L::LDY);

  float acc[RF][CPT];
#pragma unroll
  for (int r = 0; r < RF; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;
  const int pair = threadIdx.x % L::PAIRS, part = threadIdx.x / L::PAIRS;
  const int hr = pair / CF, hc = pair % CF;

  for (int h0 = 0; h0 < p.H; h0 += CF) {
    __syncthreads();
    for (int i = threadIdx.x; i < CF * C; i += kThreads) {
      const int r = i / C, col = i % C;
      w1s[r * L::LDW1 + col] = w1[(size_t)(h0 + r) * C + col];
    }
    for (int i = threadIdx.x; i < C * CF; i += kThreads) {
      const int n = i / CF, k = i % CF;
      w2s[k * C + n] = w2[(size_t)n * p.H + h0 + k];
    }
    __syncthreads();
    float hv = 0.f;
    for (int k = part * KP; k < (part + 1) * KP; ++k)
      hv = fmaf(ys[hr * L::LDY + k], w1s[hc * L::LDW1 + k], hv);
    if constexpr (L::PARTS == 1) {
      gs[pair] = gelu_tanh(hv + p.b1[h0 + hc]);
    } else {
      gs[part * L::PAIRS + pair] = hv;
      __syncthreads();
      if (part == 0) {
        for (int t = 1; t < L::PARTS; ++t) hv += gs[t * L::PAIRS + pair];
        hv = gelu_tanh(hv + p.b1[h0 + hc]);
      }
      __syncthreads();
      if (part == 0) gs[pair] = hv;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < CF; ++k) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = threadIdx.x + j * kThreads;
        if (col < C) {
          const float w = w2s[k * C + col];
#pragma unroll
          for (int r = 0; r < RF; ++r)
            acc[r][j] = fmaf(gs[r * CF + k], w, acc[r][j]);
        }
      }
    }
  }
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int r = 0; r < RF; ++r) {
    const int row = row0 + r;
    if (row >= p.rows) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = threadIdx.x + j * kThreads;
      if (col < C) out[(size_t)row * C + col] = finish<float>(p, row, col,
                                                              acc[r][j], C);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at C = 768: the Hopper body (TMA + wgmma)
// ---------------------------------------------------------------------------

using namespace vdr::sm90;

constexpr int kHC = 768;          // the width the Hopper body takes
constexpr int kRowsH = 64;        // rows a tile (one wgmma M)
constexpr int kChunkH = 128;      // hidden units a chunk
constexpr int kStagesH = 3;       // ring slots a warpgroup
constexpr int kThreadsH = 256;    // two warpgroups
constexpr int kHalf = kChunkH / 2;              // a warpgroup's hidden units
constexpr int kKbSlot = 128 / kHalf;            // y column blocks a w1 slot
constexpr int kW1Slots = kHC / 64 / kKbSlot;    // w1 slots a chunk
constexpr int kW2Slots = 3 * (kChunkH / 64);    // w2 slots a chunk
constexpr int kSlotsChunk = kW1Slots + kW2Slots;
constexpr int kSlot = 16384;                    // bytes a slot
constexpr int kBox = 64 * 128;                  // a 64-row, 128-byte box
constexpr int kYBytes = kRowsH * kHC * 2;       // the y (and out) tile
constexpr int kGBytes = kRowsH * kChunkH * 2;   // one g buffer
constexpr size_t kSmemH =
    1024 + kYBytes + 2 * kGBytes + (size_t)2 * kStagesH * kSlot;
constexpr int kErrTensorMap = -2;   // cuTensorMapEncodeTiled failed
constexpr int kErrNoBuild = -1;     // a width (or dtype) without a build
static_assert(kSmemH <= 227 * 1024, "K7's tiles exceed 227 KB");

// bf16 byte offset of element (r, col) in a row-major tile of 64-column
// boxes with the 128-byte swizzle (64 rows x 128 bytes a box)
__device__ __forceinline__ int swz(int r, int col) {
  return (col / 64) * kBox + r * 128 +
         ((((col % 64) / 8) ^ (r & 7)) << 4) + (col % 8) * 2;
}

// LayerNorm of the tile's 64 rows (fp32 statistics, as layer_norm_rows)
// into the swizzled y tile; 8 rows a warp, 8 columns a lane at a time.
__device__ void layer_norm_tile(const MlpParams& p, int row0,
                                unsigned char* y) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  for (int r = warp; r < kRowsH; r += kThreadsH / 32) {
    const int row = row0 + r;
    uint4 v8[kHC / 256];
    if (row >= p.rows) {
#pragma unroll
      for (int k = 0; k < kHC / 256; ++k)
        *reinterpret_cast<uint4*>(y + swz(r, 8 * (lane + 32 * k))) =
            make_uint4(0, 0, 0, 0);
      continue;
    }
    float v[kHC / 32];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kHC / 256; ++k) {
      v8[k] = *reinterpret_cast<const uint4*>(x + (size_t)row * kHC +
                                              8 * (lane + 32 * k));
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v8[k]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[8 * k + 2 * e] = __low2float(h2[e]);
        v[8 * k + 2 * e + 1] = __high2float(h2[e]);
      }
    }
#pragma unroll
    for (int i = 0; i < kHC / 32; ++i) sum += v[i];
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / kHC;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kHC / 32; ++i) {
      const float d = v[i] - mean;
      sq += d * d;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float inv = 1.f / sqrtf(sq / kHC + p.eps);
#pragma unroll
    for (int k = 0; k < kHC / 256; ++k) {
      const int c0 = 8 * (lane + 32 * k);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 2 * e;
        const __nv_bfloat162 h = __floats2bfloat162_rn(
            (v[8 * k + 2 * e] - mean) * inv * p.ln_scale[c] + p.ln_bias[c],
            (v[8 * k + 2 * e + 1] - mean) * inv * p.ln_scale[c + 1] +
                p.ln_bias[c + 1]);
        w[e] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(y + swz(r, c0)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreadsH, 1)
    mlp_hopper_kernel(const __grid_constant__ CUtensorMap tw1,
                      const __grid_constant__ CUtensorMap tw2,
                      const __grid_constant__ CUtensorMap tout,
                      const MlpParams p) {
  extern __shared__ __align__(16) unsigned char smem_h[];
  __shared__ __align__(8) uint64_t full[2][kStagesH], empty[2][kStagesH];
  unsigned char* base = smem_h + ((1024 - (smem_u32(smem_h) & 1023)) & 1023);
  unsigned char* y = base;                   // 12 boxes: C columns 64 kb..
  unsigned char* gs = base + kYBytes;        // two g buffers
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const uint32_t y_addr = smem_u32(y);
  const uint32_t ring =
      smem_u32(gs + 2 * kGBytes) + wg * kStagesH * kSlot;

  // block b takes tiles b, b + gridDim.x, ..
  const int n_tiles = (p.rows + kRowsH - 1) / kRowsH;
  const int n_chunks = p.H / kChunkH;
  const int my_tiles = blockIdx.x < n_tiles
                           ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1
                           : 0;
  const int total = my_tiles * n_chunks * kSlotsChunk;  // slots a warpgroup

  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w)
      for (int i = 0; i < kStagesH; ++i) {
        mbar_init(&full[w][i], 1);
        mbar_init(&empty[w][i], 4);   // one arrival a warp
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // slot n of this warpgroup's stream (the same for every tile): per chunk
  // kW1Slots slots of w1 (kKbSlot boxes of 64 columns x kHalf hidden
  // rows), then kW2Slots of w2 (64 hidden columns x 128 output rows, two
  // boxes of 64 rows).
  auto load = [&](int n) {
    if (n >= total) return;
    const int st = n % kStagesH, k = n % kSlotsChunk;
    const int h0 = (n / kSlotsChunk % n_chunks) * kChunkH;
    const uint32_t dst = ring + st * kSlot;
    uint64_t* bar = &full[wg][st];
    mbar_expect_tx(bar, kSlot);
    if (k < kW1Slots) {
      for (int b = 0; b < kKbSlot; ++b)
        tma_load_2d(dst + b * kHalf * 128, &tw1, bar, (k * kKbSlot + b) * 64,
                    h0 + wg * kHalf);
    } else {
      const int q = k - kW1Slots;
      for (int b = 0; b < 2; ++b)
        tma_load_2d(dst + b * kBox, &tw2, bar, h0 + (q / 3) * 64,
                    wg * (kHC / 2) + (q % 3) * 128 + 64 * b);
    }
  };
  if (t == 0)
    for (int n = 0; n < kStagesH; ++n) load(n);

  // one wgmma group a slot: `it` slots issued, `rel` handed back; once all
  // but the newest `keep` groups are done their slots are refilled
  int it = 0, rel = 0;
  auto release = [&](int keep) {
    for (; rel < it - keep; ++rel) {
      __syncwarp();
      if (t % 32 == 0) mbar_arrive(&empty[wg][rel % kStagesH]);
      if (t == 0) {
        mbar_wait(&empty[wg][rel % kStagesH], (rel / kStagesH) & 1);
        load(rel + kStagesH);
      }
    }
  };
  auto slot_ready = [&]() {
    const int st = it % kStagesH;
    mbar_wait(&full[wg][st], (it / kStagesH) & 1);
    return ring + st * kSlot;
  };

  const int warp = t / 32, lane = t % 32, g = lane / 4, c = lane % 4;
  const int r_lo = warp * 16 + g;            // and r_lo + 8
  const uint64_t dy = desc_sw128(y_addr, 16, 1024);
  float acc1[kHalf / 2];
  float acc2[3][64];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kRowsH;
    // y is free once both warpgroups' stores of the last tile read it
    if (t == 0) bulk_wait_read();
    bar_sync(1, kThreadsH);
    layer_norm_tile(p, row0, y);
    fence_proxy_async();
    bar_sync(1, kThreadsH);
    for (int j = 0; j < n_chunks; ++j) {
      // h = y . w1[hidden units h0 + kHalf wg ..]^T
#pragma unroll
      for (int s = 0; s < kW1Slots; ++s) {
        const uint32_t slot = slot_ready();
        wgmma_fence();
#pragma unroll
        for (int b = 0; b < kKbSlot; ++b) {
          const uint64_t dw = desc_sw128(slot + b * kHalf * 128, 16, 1024);
          const uint64_t da = dy + ((s * kKbSlot + b) * kBox >> 4);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Wgmma<kHalf>::ss(acc1, da + 2 * kk, dw + 2 * kk,
                             s + b + kk > 0);
        }
        wgmma_commit();
        ++it;
        wgmma_wait<1>();
        release(1);
      }
      wgmma_wait<0>();
      fence_regs(acc1);
      release(0);
      // g = bf16(gelu(h + b1)) into this warpgroup's half of the chunk
      unsigned char* gb = gs + (j & 1) * kGBytes;
      const float* b1 = p.b1 + j * kChunkH + wg * kHalf;
#pragma unroll
      for (int i = 0; i < kHalf / 8; ++i) {
        const int col = wg * kHalf + 8 * i + 2 * c;
        const float bb0 = b1[8 * i + 2 * c], bb1 = b1[8 * i + 2 * c + 1];
        *reinterpret_cast<__nv_bfloat162*>(gb + swz(r_lo, col)) =
            __floats2bfloat162_rn(gelu_tanh(acc1[4 * i] + bb0),
                                  gelu_tanh(acc1[4 * i + 1] + bb1));
        *reinterpret_cast<__nv_bfloat162*>(gb + swz(r_lo + 8, col)) =
            __floats2bfloat162_rn(gelu_tanh(acc1[4 * i + 2] + bb0),
                                  gelu_tanh(acc1[4 * i + 3] + bb1));
      }
      fence_proxy_async();
      bar_sync(1, kThreadsH);   // both halves of g are written
      // out[:, 384 wg + 128 ob ..] += g[:, 64 hb ..] . w2[..]^T
      const uint64_t dg = desc_sw128(smem_u32(gb), 16, 1024);
#pragma unroll
      for (int q = 0; q < kW2Slots; ++q) {
        const int hb = q / 3, ob = q % 3;
        const uint64_t dw = desc_sw128(slot_ready(), 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<128>::ss(acc2[ob], dg + (hb * kBox >> 4) + 2 * kk,
                         dw + 2 * kk, j + hb + kk > 0);
        wgmma_commit();
        ++it;
        wgmma_wait<1>();
        release(1);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc2[0]);
    fence_regs(acc2[1]);
    fence_regs(acc2[2]);
    release(0);
    // out = x + ls * (o + b2), over the dead y tile; this warpgroup's
    // 384 columns are boxes 6 wg .. 6 wg + 5
#pragma unroll
    for (int ob = 0; ob < 3; ++ob)
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r_lo + 8 * half, row = row0 + r;
          const int col = wg * (kHC / 2) + ob * 128 + 8 * i + 2 * c;
          __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
          if (row < p.rows) {
            v.x = finish<__nv_bfloat16>(p, row, col, acc2[ob][4 * i + 2 * half],
                                        kHC);
            v.y = finish<__nv_bfloat16>(p, row, col + 1,
                                        acc2[ob][4 * i + 2 * half + 1], kHC);
          }
          *reinterpret_cast<__nv_bfloat162*>(y + swz(r, col)) = v;
        }
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    if (t == 0) {
      for (int b = 0; b < 6; ++b)
        tma_store_2d(&tout, y_addr + (6 * wg + b) * kBox,
                     (6 * wg + b) * 64, row0);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait();
}

// The calls the Hopper body takes: bf16 at C 768, H a multiple of its chunk.
bool hopper_takes(int C, int H, int dtype) {
  return dtype == 1 && C == kHC && H > 0 && H % kChunkH == 0;
}

int launch_hopper(const MlpParams& p, cudaStream_t stream) {
  CUtensorMap tw1, tw2, tout;
  if (!tensor_map_2d_sw128(&tw1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.w1,
                           kHC, p.H, 64, kHalf) ||
      !tensor_map_2d_sw128(&tw2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.w2,
                           p.H, kHC, 64, 64) ||
      !tensor_map_2d_sw128(&tout, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.out,
                           kHC, p.rows, 64, kRowsH))
    return kErrTensorMap;
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_hopper_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemH);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (p.rows + kRowsH - 1) / kRowsH;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  mlp_hopper_kernel<<<grid, kThreadsH, kSmemH, stream>>>(tw1, tw2, tout, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at C = 1536: the cluster body (TMA multicast + wgmma + DSMEM)
// ---------------------------------------------------------------------------

constexpr int kCC = 1536;           // the width the cluster body takes
constexpr int kClusterC = 4;        // blocks a cluster: the output's quarters
constexpr int kColsC = kCC / kClusterC;    // 384 output columns a block
constexpr int kWgsC = 2;            // warpgroups a block, stacked by rows
constexpr int kRowsC = 64 * kWgsC;  // rows a tile: a weight pass
constexpr int kChunkC = 256;        // hidden units a chunk, 64 a block
constexpr int kStagesC = 3;         // ring slots
constexpr int kMulticast = 1;       // y multicast (0: each block loads all)
constexpr int kThreadsC = 128 * kWgsC;
constexpr int kUnitsC = kChunkC / kClusterC;   // a block's units of a chunk
constexpr int kKbSlotC = 2;                    // k blocks a first-product slot
constexpr int kW1SlotsC = kCC / 64 / kKbSlotC; // first-product slots a chunk
constexpr int kObC = kColsC / 128;             // n128 blocks a warpgroup
constexpr int kStepsC = kW1SlotsC + kChunkC / 64;   // slots a chunk
constexpr int kYRowsC = kRowsC / kClusterC;    // rows of y a block loads
constexpr int kYPartC = kRowsC * 128;          // the tile's y, one k block
constexpr int kW1PartC = kUnitsC * 128;        // w1, one k block
constexpr int kW2PartC = 128 * 128;            // w2: 128 outputs x 64 units
constexpr int kSlotC =
    kKbSlotC * (kYPartC + kW1PartC) > kObC * kW2PartC
        ? kKbSlotC * (kYPartC + kW1PartC)
        : kObC * kW2PartC;
constexpr int kPieceC = kRowsC * kUnitsC * 2;  // a block's piece of g
constexpr int kGBytesC = kClusterC * kPieceC;  // the chunk's g tile
constexpr size_t kSmemC = 1024 + kGBytesC + (size_t)kStagesC * kSlotC;
constexpr int kErrNoScratch = -3;   // the cluster body without its y scratch
static_assert(kSmemC <= 227 * 1024, "K7's cluster tiles exceed 227 KB");
static_assert(kUnitsC == 64 && kColsC % 128 == 0 && kYRowsC % 8 == 0 &&
                  kClusterC == 4 && kCC % (64 * kKbSlotC) == 0,
              "the cluster body's tiles (a warpgroup's warp r releases a "
              "slot in rank r)");

// bf16(lo), bf16(hi) into 4 bytes of shared memory at a 32-bit address
__device__ __forceinline__ void st_shared_bf16x2(uint32_t addr, float lo,
                                                 float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<const uint32_t*>(&v))
               : "memory");
}

// LayerNorm of every row into the y scratch (rows, C) in bf16, the A
// operand the cluster body streams: 8 rows a block, one a warp.
__global__ void __launch_bounds__(256) mlp_ln_kernel(const MlpParams p,
                                                     __nv_bfloat16* y) {
  const int row0 = blockIdx.x * 8;
  const int n = p.rows - row0 < 8 ? p.rows - row0 : 8;
  layer_norm_rows<__nv_bfloat16, kCC>(p, row0, n, y + (size_t)row0 * kCC,
                                      kCC);
}

// Clusters of kClusterC blocks own 128-row tiles: block `rank` owns output
// columns 384 rank .. 384 rank + 383 (warpgroup w rows 64 w .. 64 w + 63 of
// them) and, of each 256-unit hidden chunk, units 64 rank .. 64 rank + 63
// of the first product; the header says how the ring, the producers and
// the g exchange work.
__global__ void __launch_bounds__(kThreadsC, 2 / kWgsC)
    mlp_wide_hopper_kernel(const __grid_constant__ CUtensorMap ty,
                           const __grid_constant__ CUtensorMap tw1,
                           const __grid_constant__ CUtensorMap tw2,
                           const MlpParams p) {
  extern __shared__ __align__(16) unsigned char smem_c[];
  __shared__ __align__(8) uint64_t full[kStagesC], empty[kStagesC];
  __shared__ __align__(8) uint64_t gfull, gfree;
  const uint32_t g_addr =
      smem_u32(smem_c) + ((1024 - (smem_u32(smem_c) & 1023)) & 1023);
  const uint32_t ring = g_addr + kGBytesC;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  // thread 0 of each warpgroup produces every kWgsC-th slot
  const bool producer = threadIdx.x % 128 == 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStagesC; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWgsC * kClusterC);   // each warpgroup, each block
    }
    mbar_init(&gfull, 1);
    mbar_init(&gfree, kWgsC * (kClusterC - 1));  // the other blocks' ones
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // no arrival or multicast reaches an uninitialised barrier

  // cluster q takes tiles q, q + clusters, ..; the chunk being consumed is
  // chunk j of `tile`, chunk jj of the stream: slots 16 jj .. 16 jj + 15
  int tile = blockIdx.x / kClusterC, j = 0, jj = 0;
  // `it` slots consumed; a producer's next slot `issued` is one whose
  // release has not been seen yet, so it lies in the chunk being consumed
  // or the next one (the ring is shorter than a chunk)
  int it = 0, issued = wg;
  // a producer issues its next slot once the slot's release has completed
  // (at most one a call: each call tests one barrier)
  auto pump = [&]() {
    const int n = issued, st = n % kStagesC;
    if (n >= kStagesC && !mbar_test(&empty[st], (n / kStagesC - 1) & 1))
      return;
    int pt = tile, pj = j;
    if (n / kStepsC != jj && ++pj == p.H / kChunkC) {
      pj = 0;
      pt += gridDim.x / kClusterC;
    }
    if (pt * kRowsC >= p.rows) return;
    const uint32_t rank = cluster_rank();
    const uint32_t dst = ring + st * kSlotC;
    const int k = n % kStepsC, h0 = pj * kChunkC;
    if (k < kW1SlotsC) {
      mbar_expect_tx(&full[st], kKbSlotC * (kYPartC + kW1PartC));
#pragma unroll 1
      for (int b = 0; b < kKbSlotC; ++b) {
        const int col = 64 * (k * kKbSlotC + b);
        const uint32_t yd = dst + b * kYPartC;
        if (kMulticast) {
          tma_load_2d_mc(yd + rank * kYRowsC * 128, &ty, &full[st], col,
                         pt * kRowsC + rank * kYRowsC,
                         (1u << kClusterC) - 1);
        } else {
          for (int q = 0; q < kClusterC; ++q)
            tma_load_2d(yd + q * kYRowsC * 128, &ty, &full[st], col,
                        pt * kRowsC + q * kYRowsC);
        }
        tma_load_2d(dst + kKbSlotC * kYPartC + b * kW1PartC, &tw1,
                    &full[st], col, h0 + rank * kUnitsC);
      }
    } else {
      // the block's own units first: hidden block (rank + i) % 4
      const int hb = (rank + k - kW1SlotsC) % (kChunkC / 64);
      mbar_expect_tx(&full[st], kObC * kW2PartC);
#pragma unroll 1
      for (int ob = 0; ob < kObC; ++ob)
        tma_load_2d(dst + ob * kW2PartC, &tw2, &full[st], h0 + 64 * hb,
                    rank * kColsC + 128 * ob);
    }
    issued = n + kWgsC;
  };
  // every wait starts with a producer's refill (a wait follows each
  // release), then it polls the barrier, issuing meanwhile, while the rest
  // of its warp waits for it at __syncwarp (a lane suspended in try_wait
  // beside it would hold it back until the suspension times out). One
  // call site a wait keeps the producer's registers out of the products'.
  auto wait_bar = [&](uint64_t* bar, uint32_t parity) {
    if (producer)
      for (;;) {
        pump();
        if (mbar_test(bar, parity)) break;
      }
    __syncwarp();
    mbar_wait(bar, parity);   // every thread's own acquire
  };
  if (producer)
    for (int i = 0; i < kStagesC; ++i) pump();

  // one wgmma group a slot, waited for at once: each warpgroup then
  // releases the slot in every block of the cluster, lane 0 of its warp r
  // to rank r (the warpgroup's wait covers its four warps' shares)
  const int to_rank = threadIdx.x % 128 / 32;
  auto slot_ready = [&]() {
    wait_bar(&full[it % kStagesC], (it / kStagesC) & 1);
    return ring + (it % kStagesC) * kSlotC;
  };
  auto release = [&]() {
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0)
      mbar_arrive_cluster(
          map_rank(smem_u32(&empty[it % kStagesC]), to_rank));
    ++it;
  };

  float h1[kUnitsC / 2];
  float acc[kObC][64];
  for (; tile * kRowsC < p.rows; tile += gridDim.x / kClusterC) {
    for (j = 0; j < p.H / kChunkC; ++j, ++jj) {
      // h = y . w1[units h0 + 64 rank ..]^T over the 24 k blocks
#pragma unroll 1
      for (int s = 0; s < kW1SlotsC; ++s) {
        const uint32_t slot = slot_ready();
        wgmma_fence();
#pragma unroll
        for (int b = 0; b < kKbSlotC; ++b) {
          const uint64_t da =
              desc_sw128(slot + b * kYPartC + wg * kBox, 16, 1024);
          const uint64_t dw = desc_sw128(
              slot + kKbSlotC * kYPartC + b * kW1PartC, 16, 1024);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Wgmma<kUnitsC>::ss(h1, da + 2 * kk, dw + 2 * kk,
                               s + b + kk > 0);
        }
        release();
        // the chunk before's second product is done: its g may be replaced
        if (s == 0 && jj > 0 && lane == 0 && to_rank != (int)cluster_rank())
          mbar_arrive_cluster(map_rank(smem_u32(&gfree), to_rank));
      }
      fence_regs(h1);
      // g = bf16(gelu(h + b1)) into this block's piece, once every block
      // has read the chunk before's g
      if (jj > 0) wait_bar(&gfree, (jj - 1) & 1);
      {
        const uint32_t rank = cluster_rank();
        const uint32_t piece = g_addr + rank * kPieceC + wg * kBox;
        const float* b1 = p.b1 + j * kChunkC + rank * kUnitsC;
        const int r_lo = (threadIdx.x % 128) / 32 * 16 + lane / 4;
#pragma unroll
        for (int i = 0; i < kUnitsC / 8; ++i) {
          const int col = 8 * i + 2 * (lane % 4);
          const float bb0 = b1[col], bb1 = b1[col + 1];
          st_shared_bf16x2(piece + swz(r_lo, col),
                           gelu_tanh(h1[4 * i] + bb0),
                           gelu_tanh(h1[4 * i + 1] + bb1));
          st_shared_bf16x2(piece + swz(r_lo + 8, col),
                           gelu_tanh(h1[4 * i + 2] + bb0),
                           gelu_tanh(h1[4 * i + 3] + bb1));
        }
      }
      fence_proxy_async();
      bar_sync(1, kThreadsC);   // the block's piece is written
      if (threadIdx.x == 0) {
        const uint32_t rank = cluster_rank();
        const uint32_t piece = g_addr + rank * kPieceC;
        mbar_expect_tx(&gfull, (kClusterC - 1) * kPieceC);
        for (uint32_t r = 1; r < kClusterC; ++r) {
          const uint32_t to = (rank + r) % kClusterC;
          bulk_copy_to_rank(map_rank(piece, to), piece, kPieceC,
                            map_rank(smem_u32(&gfull), to));
        }
      }
      // out[:, 384 rank + 128 ob ..] += g[:, 64 hb ..] . w2[..]^T, hidden
      // block hb = rank (this block's piece) first, the others once they
      // have arrived
#pragma unroll 1
      for (int i = 0; i < kChunkC / 64; ++i) {
        if (i == 1) wait_bar(&gfull, jj & 1);
        const uint32_t slot = slot_ready();
        const uint64_t dg = desc_sw128(
            g_addr + (cluster_rank() + i) % kClusterC * kPieceC + wg * kBox,
            16, 1024);
        wgmma_fence();
#pragma unroll
        for (int ob = 0; ob < kObC; ++ob) {
          const uint64_t dw = desc_sw128(slot + ob * kW2PartC, 16, 1024);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Wgmma<128>::ss(acc[ob], dg + 2 * kk, dw + 2 * kk,
                           j + i + kk > 0);
        }
        release();
      }
    }
#pragma unroll
    for (int ob = 0; ob < kObC; ++ob) fence_regs(acc[ob]);
    // out = x + ls * (o + b2), this warpgroup's 64 rows, straight to memory
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    const int col0 = cluster_rank() * kColsC + 2 * (lane % 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = tile * kRowsC + threadIdx.x / 32 * 16 + lane / 4 +
                      8 * half;
      if (row >= p.rows) continue;
#pragma unroll
      for (int ob = 0; ob < kObC; ++ob)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int col = col0 + ob * 128 + 8 * i;
          __nv_bfloat162 v;
          v.x = finish<__nv_bfloat16>(p, row, col, acc[ob][4 * i + 2 * half],
                                      kCC);
          v.y = finish<__nv_bfloat16>(p, row, col + 1,
                                      acc[ob][4 * i + 2 * half + 1], kCC);
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * kCC + col) =
              v;
        }
    }
  }
  cluster_sync();   // no block leaves while another may still reach it
}

// The calls the cluster body takes: bf16 at C 1536, H a multiple of its
// chunk (DINOv2 ViT-g/14's 6144).
bool cluster_takes(int C, int H, int dtype) {
  return dtype == 1 && C == kCC && H > 0 && H % kChunkC == 0;
}

int launch_cluster(const MlpParams& p, void* y, cudaStream_t stream) {
  if (y == nullptr) return kErrNoScratch;
  CUtensorMap ty, tw1, tw2;
  if (!tensor_map_2d_sw128(&ty, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y, kCC,
                           p.rows, 64, kYRowsC) ||
      !tensor_map_2d_sw128(&tw1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.w1,
                           kCC, p.H, 64, kUnitsC) ||
      !tensor_map_2d_sw128(&tw2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.w2,
                           p.H, kCC, 64, 128))
    return kErrTensorMap;
  mlp_ln_kernel<<<(p.rows + 7) / 8, 256, 0, stream>>>(
      p, static_cast<__nv_bfloat16*>(y));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(mlp_wide_hopper_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemC);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreadsC);
  cfg.dynamicSmemBytes = kSmemC;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // persistent clusters: as many as the card holds at once, at most one a
  // tile
  cfg.gridDim = dim3(kClusterC);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, mlp_wide_hopper_kernel,
                                       &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (p.rows + kRowsC - 1) / kRowsC;
  cfg.gridDim = dim3(kClusterC * (tiles < clusters ? tiles : clusters));
  err = cudaLaunchKernelEx(&cfg, mlp_wide_hopper_kernel, ty, tw1, tw2, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int C, int R, int CH>
int launch_bf16(const MlpParams& p, cudaStream_t stream) {
  if (p.H % CH) return (int)cudaErrorInvalidValue;
  const size_t smem = Bf16Layout<C, R, CH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bf16_kernel<C, R, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlp_bf16_kernel<C, R, CH><<<(p.rows + R - 1) / R, kThreads, smem,
                              stream>>>(p);
  return (int)cudaGetLastError();
}

template <int C, int RF, int CF>
int launch_f32(const MlpParams& p, cudaStream_t stream) {
  if (p.H % CF) return (int)cudaErrorInvalidValue;
  const size_t smem = F32Layout<C, RF, CF>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_f32_kernel<C, RF, CF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlp_f32_kernel<C, RF, CF><<<(p.rows + RF - 1) / RF, kThreads, smem,
                              stream>>>(p);
  return (int)cudaGetLastError();
}

template <int C>
int launch(const MlpParams& p, int dtype, cudaStream_t stream) {
  return dtype != 0 ? launch_bf16<C, kRows, kChunk>(p, stream)
                    : launch_f32<C, kRowsF, kChunkF>(p, stream);
}

}  // namespace

extern "C" {

const char* vdr_error_string(int err) {
  if (err == kErrTensorMap) return "cuTensorMapEncodeTiled failed";
  if (err == kErrNoScratch) return "the cluster body needs its y scratch";
  if (err == kErrNoBuild) return "no K7 build for this width and dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The body a call with these arguments runs: 1 the Hopper body, 2 the
// cluster body, 0 the loops.
int vdr_fused_ln_mlp_residual_route(int C, int H, int dtype) {
  return hopper_takes(C, H, dtype) ? 1 : cluster_takes(C, H, dtype) ? 2 : 0;
}

// Returns 0 on success, a cudaError_t after a failed launch, -1 for a
// width C without a build (384, 768, 1024 and 1536 are built in both
// dtypes), -2 when a TMA descriptor cannot be made, or -3 for the cluster
// body without `y`. dtype: 0 = fp32, 1 = bf16. H must be a multiple of 32
// (bf16; 16 at C 1536) or 16 (fp32; 8 at C 1536); bf16 at C 768 with H a
// multiple of 128 takes the Hopper body, bf16 at C 1536 with H a multiple
// of 256 the cluster body (which needs `y`, a (rows, 1536) bf16 scratch
// for the LayerNorm's output; other calls ignore it), every other call
// the loops.
int vdr_fused_ln_mlp_residual(const void* x, const float* ln_scale,
                              const float* ln_bias, const void* w1,
                              const float* b1, const void* w2,
                              const float* b2, const void* ls, void* out,
                              void* y, int rows, int C, int H, float eps,
                              int dtype, void* stream) {
  const MlpParams p{x, ln_scale, ln_bias, w1, b1, w2, b2, ls, out, rows, H,
                    eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hopper_takes(C, H, dtype)) return launch_hopper(p, s);
  if (cluster_takes(C, H, dtype)) return launch_cluster(p, y, s);
  switch (C) {
    case 384: return launch<384>(p, dtype, s);
    case 768: return launch<768>(p, dtype, s);
    case 1024: return launch<1024>(p, dtype, s);
    case 1536:
      return dtype != 0 ? launch_bf16<1536, kRowsG, kChunkG>(p, s)
                        : launch_f32<1536, kRowsF, kChunkF1536>(p, s);
    default: return kErrNoBuild;
  }
}

}  // extern "C"
