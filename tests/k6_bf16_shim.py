"""A g++ stand-in for K6's bf16 bodies (``csrc/flash_trainable_bf16.cuh``):
the sources, their build, calls on CPU tensors, and the gaps of the
mma.sync bodies and of the plain versions to the fp64 oracle of their
rounding points.

The bodies use CUDA-core arithmetic, shuffles, barriers and the warp's
``mma.sync.m16n8k16`` only, with control flow uniform over the block around
each mma and shuffle. So they also compile with g++ under a stand-in for
``flash_attention_core.cuh`` and the CUDA types: a block runs as 128
``std::thread``s, ``__syncthreads`` is a ``std::barrier``, a shuffle and an
mma go through block-wide arrays between two barriers (the mma reads the
bf16 A and B fragments of its warp's 32 lanes as the PTX ISA lays them out
and sums the 16 exact products in fp32), and bf16 rounding is to nearest
even. ``tests/test_torch_k6_bf16_shim.py`` holds the bodies to the plain
versions through it, and the shape predicates (``k6b::bwd_route``,
``k6b::fwd_route`` and the Hopper bodies' tiling) to their closed forms.

Run as a script it measures, over seeds, each output's gap to the oracle
(``ops/attention_grad.py``'s plain versions with ``acc=torch.float64``:
the same bf16 rounding points, every other sum in fp64) for the bodies and
for the plain versions, at 14 x 14 bf16 windows or SAM ViT-B/16 @640's
global shape (a 40 x 40 grid)::

    python tests/k6_bf16_shim.py --shape window --seeds 5 --batch 4 --heads 2
    python tests/k6_bf16_shim.py --shape sam640 --seeds 5 --batch 1 --heads 1
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from vit_deep_radiomics_tpu_torch.ops import attention_grad as G  # noqa: E402
from vit_deep_radiomics_tpu_torch.utils import cuda_build  # noqa: E402

CORE_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
struct dim3 { unsigned x = 0, y = 0, z = 0; };
struct int2 { int x, y; };
inline int2 make_int2(int x, int y) { return {x, y}; }
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
struct __nv_bfloat16 { uint16_t bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = uint32_t(h.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float __low2float(__nv_bfloat162 v) { return __bfloat162float(v.x); }
inline float __high2float(__nv_bfloat162 v) { return __bfloat162float(v.y); }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
extern thread_local dim3 threadIdx, blockIdx, blockDim;
struct BlockSync {
  std::barrier<> bar;
  float shfl[128];
  uint32_t a[128][4], b[128][2];
  explicit BlockSync(int n) : bar(n) {}
};
extern thread_local BlockSync* tl_block;
inline void __syncthreads() { tl_block->bar.arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  __syncthreads();
  tl_block->shfl[threadIdx.x] = v;
  __syncthreads();
  return tl_block->shfl[threadIdx.x ^ m];
}
namespace vdr {
inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  std::memcpy(&u, &v, 4);
  return u;
}
inline float half_of(uint32_t w, int hi) {
  return __bfloat162float({uint16_t(hi ? w >> 16 : w & 0xffffu)});
}
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 over the 32 lanes of the
// caller's warp: lane 4g + c holds A (g, 2c..), (g + 8, 2c..), (g, 2c + 8..),
// (g + 8, 2c + 8..), B (k 2c.., n g), (k 2c + 8.., n g), C (g, 2c..),
// (g + 8, 2c..)
inline void mma_bf16_16816(float c[4], const uint32_t a[4],
                           const uint32_t b[2]) {
  BlockSync* bs = tl_block;
  const int t = threadIdx.x, w0 = t & ~31, g = (t & 31) / 4, cc = t & 3;
  __syncthreads();
  for (int i = 0; i < 4; ++i) bs->a[t][i] = a[i];
  bs->b[t][0] = b[0];
  bs->b[t][1] = b[1];
  __syncthreads();
  for (int e = 0; e < 4; ++e) {
    const int m = g + (e >= 2 ? 8 : 0), n = 2 * cc + (e & 1);
    float sum = 0.f;
    for (int k = 0; k < 16; ++k) {
      const float av = half_of(
          bs->a[w0 + (m % 8) * 4 + (k % 8) / 2][(k < 8 ? 0 : 2) + (m >= 8)],
          k % 2);
      const float bv =
          half_of(bs->b[w0 + n * 4 + (k % 8) / 2][k < 8 ? 0 : 1], k % 2);
      sum += av * bv;
    }
    c[e] += sum;
  }
}
}  // namespace vdr
"""

RUNNER_CPP = r"""
#include "flash_trainable_bf16.cuh"
#include <thread>
#include <vector>
thread_local dim3 threadIdx, blockIdx, blockDim;
thread_local BlockSync* tl_block;
using namespace vdr::k6b;

template <class Body>
static void run_grid(const Params& p, size_t smem_bytes, Body body) {
  for (int z = 0; z < p.B; ++z)
    for (int y = 0; y < p.H; ++y)
      for (int x = 0; x < (p.S + ROWS - 1) / ROWS; ++x) {
        std::vector<float> smem(smem_bytes / 4 + 4, NAN);
        BlockSync bs(NT);
        std::vector<std::thread> th;
        for (int t = 0; t < NT; ++t)
          th.emplace_back([&, t] {
            threadIdx = {(unsigned)t, 0, 0};
            blockIdx = {(unsigned)x, (unsigned)y, (unsigned)z};
            blockDim = {NT, 1, 1};
            tl_block = &bs;
            body(reinterpret_cast<char*>(smem.data()), z, y, x * ROWS);
          });
        for (auto& t : th) t.join();
      }
}

static Params make(const void* q, const void* k, const void* v,
                   const float* bh, const float* bw, const int* kv_len,
                   int B, int H, int S, int kh, int kw, float scale) {
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.bias_h = bh;
  p.bias_w = bw;
  p.kv_len = kv_len;
  p.B = B;
  p.H = H;
  p.S = S;
  p.kh = bh ? kh : 0;
  p.kw = bh ? kw : 1;
  p.scale = scale;
  p.scale_log2 = round_bf16(scale * kLog2e);
  return p;
}

extern "C" {
void run_fwd(const void* q, const void* k, const void* v, const float* bh,
             const float* bw, const int* kv_len, void* out, float* lse,
             int B, int H, int S, int kh, int kw, float scale) {
  Params p = make(q, k, v, bh, bw, kv_len, B, H, S, kh, kw, scale);
  p.out = static_cast<bf16*>(out);
  p.lse_out = lse;
  run_grid(p, fwd_smem(bh ? kh + kw : 0),
           [&](char* sm, int b, int h, int r0) { vdr::k6b::forward(p, b, h, r0, sm); });
}
void run_dq(const void* q, const void* k, const void* v, const float* bh,
            const float* bw, const int* kv_len, const void* dout,
            const float* lse, const float* delta, void* dq, float* dbh,
            float* dbw, int B, int H, int S, int kh, int kw, float scale) {
  Params p = make(q, k, v, bh, bw, kv_len, B, H, S, kh, kw, scale);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<bf16*>(dq);
  p.dbh = dbh;
  p.dbw = dbw;
  run_grid(p, dq_smem(bh ? kh + kw : 0, bh ? kw : 0),
           [&](char* sm, int b, int h, int r0) { vdr::k6b::dq(p, b, h, r0, sm); });
}
void run_dkv(const void* q, const void* k, const void* v, const float* bh,
             const float* bw, const int* kv_len, const void* dout,
             const float* lse, const float* delta, void* dk, void* dv, int B,
             int H, int S, int kh, int kw, float scale) {
  Params p = make(q, k, v, bh, bw, kv_len, B, H, S, kh, kw, scale);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  run_grid(p, dkv_smem(bh ? kh + kw : 0),
           [&](char* sm, int b, int h, int r0) { vdr::k6b::dkv(p, b, h, r0, sm); });
}
}
"""

ROUTE_CPP = r"""
#include "flash_trainable_bf16.cuh"
thread_local dim3 threadIdx, blockIdx, blockDim;
thread_local BlockSync* tl_block;
using namespace vdr::k6b;
extern "C" {
int route(int has_bias, int kh, int kw) {
  return bwd_route(has_bias != 0, kh, kw);
}
int fwd(int has_bias, int kh, int kw) {
  return fwd_route(has_bias != 0, kh, kw);
}
int fwd_tile(int kw) { return hopper_fwd_tile(kw); }
int fwd_passes(int kw) { return hopper_fwd_passes(kw); }
long long fwd_smem(int kw, int kh) {
  return (long long)hopper_fwd_smem(kw, kh);
}
int tile(int kw) { return hopper_dq_tile(kw); }
int passes(int kw) { return hopper_dq_passes(kw); }
int hrows(int kw) { return hopper_dkv_hrows(kw); }
int term_ld(int kw) { return hopper_term_ld(kw); }
int term_period(int kw) { return hopper_term_period(kw); }
int term_key_major(int kw) { return hopper_term_key_major(kw); }
int term_bytes(int kw) { return hopper_term_bytes(kw); }
int stage_bytes(int kw) { return hopper_stage_bytes(kw); }
int stages(int kw) { return hopper_dkv_stages(kw); }
long long dkv_smem(int kw) { return (long long)hopper_dkv_smem(kw); }
long long dq_smem(int kw, int kh) { return (long long)hopper_dq_smem(kw, kh); }
}
"""

D = 64
SCALE = D ** -0.5


def build(out_dir: Path, kind: str = "bodies") -> ctypes.CDLL:
    """Build the bodies (``kind`` "bodies": ``run_fwd``, ``run_dq``,
    ``run_dkv``) or the shape predicates ("route") with g++ into
    ``out_dir`` and load them. Raises if there is no g++ or it fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ (C++20) is needed to build the bodies "
                                "for the CPU")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "flash_attention_core.cuh").write_text(CORE_H)
    shutil.copy(cuda_build.CSRC_DIR / "flash_trainable_bf16.cuh", out_dir)
    src = out_dir / f"{kind}.cpp"
    src.write_text(RUNNER_CPP if kind == "bodies" else ROUTE_CPP)
    so = out_dir / f"{kind}.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1" if kind == "bodies" else "-O0", "-shared",
         "-fPIC", f"-I{out_dir}", "-o", str(so), str(src), "-lpthread"],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if kind == "bodies":
        lib.run_fwd.argtypes = [P] * 8 + [I] * 5 + [F]
        lib.run_dq.argtypes = [P] * 12 + [I] * 5 + [F]
        lib.run_dkv.argtypes = [P] * 11 + [I] * 5 + [F]
        for fn in (lib.run_fwd, lib.run_dq, lib.run_dkv):
            fn.restype = None
    else:
        for name in ("route", "fwd", "tile", "passes", "fwd_tile",
                     "fwd_passes", "hrows", "term_ld", "term_period",
                     "term_key_major", "term_bytes", "stage_bytes",
                     "stages"):
            getattr(lib, name).restype = I
        lib.route.argtypes = lib.fwd.argtypes = [I] * 3
        for name in ("tile", "passes", "fwd_tile", "fwd_passes", "hrows",
                     "term_ld", "term_period", "term_key_major",
                     "term_bytes", "stage_bytes", "stages", "dkv_smem"):
            getattr(lib, name).argtypes = [I]
        lib.dkv_smem.restype = ctypes.c_longlong
        for name in ("dq_smem", "fwd_smem"):
            getattr(lib, name).argtypes = [I, I]
            getattr(lib, name).restype = ctypes.c_longlong
    return lib


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _grid(bh, bw):
    return (bh.shape[-1], bw.shape[-1]) if bh is not None else (0, 0)


def forward(lib, q, k, v, bh, bw, kl, scale=SCALE):
    """(out, lse) of the bodies' forward on CPU tensors."""
    b, h, s, _ = q.shape
    out = torch.full_like(q, float("nan"))
    lse = torch.full((b, h, s), float("nan"))
    lib.run_fwd(*(_ptr(x) for x in (q, k, v, bh, bw, kl)), _ptr(out),
                _ptr(lse), b, h, s, *_grid(bh, bw), scale)
    return out, lse


def backward(lib, q, k, v, bh, bw, kl, dout, lse, delta, scale=SCALE):
    """(dq, dbias_h, dbias_w, dk, dv) of the bodies' dq and dkv."""
    b, h, s, _ = q.shape
    kh, kw = _grid(bh, bw)
    dq = torch.full_like(q, float("nan"))
    dk, dv = torch.full_like(k, float("nan")), torch.full_like(v, float("nan"))
    dbh = torch.full_like(bh, float("nan")) if kh else None
    dbw = torch.full_like(bw, float("nan")) if kh else None
    ptrs = [_ptr(x) for x in (q, k, v, bh, bw, kl, dout, lse, delta)]
    lib.run_dq(*ptrs, _ptr(dq), _ptr(dbh), _ptr(dbw), b, h, s, kh, kw, scale)
    lib.run_dkv(*ptrs, _ptr(dk), _ptr(dv), b, h, s, kh, kw, scale)
    return dq, dbh, dbw, dk, dv


# the shapes of the measurement: (tokens, Kh, Kw), bias factors normal
# times 0.3 and q, k, v, dO normal, as chip_smoke.py's k6_inputs draws them
SHAPES = {"window": (196, 14, 14), "sam576": (1296, 36, 36),
          "sam640": (1600, 40, 40)}


def inputs(seed, b, h, s, kh, kw):
    """((q, k, v, bias_h, bias_w, None), dO) from numpy's generator."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32)).to(dtype)

    q, k, v, dout = (t(b, h, s, D) for _ in range(4))
    return (q, k, v, t(b, h, s, kh, scale=0.3, dtype=torch.float32),
            t(b, h, s, kw, scale=0.3, dtype=torch.float32), None), dout


def measure(lib, shape, seed, b, h):
    """``utils/kernel_probe.py``'s ``k6_oracle_gaps`` for the bodies at one
    seed: each
    output's and the plain version's distance to the fp64 oracle of their
    rounding points, the backward of all three fed the bodies' lse and D."""
    from vit_deep_radiomics_tpu_torch.utils import kernel_probe as kp

    s, kh, kw = SHAPES[shape]
    args, dout = inputs(seed, b, h, s, kh, kw)
    fwd = forward(lib, *args)
    rest = (dout, fwd[1], G.flash_attention_delta(fwd[0], dout))
    bwd = backward(lib, *args, *rest)
    return kp.k6_oracle_gaps(torch, G, args, dout, fwd, bwd, SCALE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), default="window")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--heads", type=int, default=2)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp))
        for seed in range(a.first_seed, a.first_seed + a.seeds):
            res = measure(lib, a.shape, seed, a.batch, a.heads)
            print(json.dumps({"shape": a.shape, "seed": seed,
                              "batch": a.batch, "heads": a.heads,
                              "gaps": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
