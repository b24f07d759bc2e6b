"""K6's bf16 bodies (``csrc/flash_trainable_bf16.cuh``: the forward with
the lse residual, dq with both bias gradients, dk/dv) run on the CPU against
the port's plain versions.

The bodies use CUDA-core arithmetic, shuffles, barriers and the warp's
``mma.sync.m16n8k16`` only, with control flow uniform over the block around
each mma and shuffle. So they also compile with g++ under a stand-in for
``flash_attention_core.cuh`` and the CUDA types: a block runs as 128
``std::thread``s, ``__syncthreads`` is a ``std::barrier``, a shuffle and an
mma go through block-wide arrays between two barriers (the mma reads the
bf16 A and B fragments of its warp's 32 lanes as the PTX ISA lays them out
and sums the 16 exact products in fp32), and bf16 rounding is to nearest
even. That checks the bodies' indexing, fragment layouts, masks, the bias
table and key table (a 48-wide key grid, whose 64-key tiles span two grid
rows; a 7-wide one, ragged everywhere), the kv_len rules (a row with no
valid key, a valid count inside a tile) and the fixed-order bias sums,
without the card. The card's own checks are in
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py`` phase 10.

Both sides are given the same bf16 inputs and, for the backward, the same
lse and delta (the plain forward's). The outputs are bf16 on both sides
after fp32 sums in other orders, so a rounding may flip: |kernel - plain|
<= RTOL·|plain| + ATOL with RTOL one bf16 step (2^-7) and ATOL 1.5e-3,
about 1.5 times the largest gap measured here beyond RTOL (9.6e-4, out);
the fp32 lse within 2e-6 (measured 9.5e-7) and the fp32 bias gradients
within 1e-3 (measured 4.9e-4: where a sum order flips the bf16 rounding of
one dS term).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from vit_deep_radiomics_tpu_torch.ops import attention_grad as G
from vit_deep_radiomics_tpu_torch.utils import cuda_build

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

D = 64
SCALE = D ** -0.5
RTOL, ATOL = 2.0 ** -7, 1.5e-3
LSE_ATOL, DBIAS_ATOL = 2e-6, 1e-3

# (B, H, S, Kh, Kw, kv_len): a 48-wide key grid over three key tiles (each
# spanning two grid rows), a 7 x 7 grid (one ragged block and tile), kv_len
# with a row that has no valid key over a ragged S, and a bias with a
# valid count inside a tile
CASES = {"grid_4x48": (1, 2, 192, 4, 48, None),
         "grid_7x7": (2, 1, 49, 7, 7, None),
         "kv_len_zero_row": (2, 1, 130, 0, 0, (0, 70)),
         "grid_10x10_kv_len": (2, 1, 100, 10, 10, (37, 100))}


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the bodies for the CPU")
    d = tmp_path_factory.mktemp("k6_bf16_shim")
    (d / "flash_attention_core.cuh").write_text(CORE_H)
    shutil.copy(cuda_build.CSRC_DIR / "flash_trainable_bf16.cuh", d)
    (d / "runner.cpp").write_text(RUNNER_CPP)
    so = d / "k6b.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", f"-I{d}", "-o",
         str(so), str(d / "runner.cpp"), "-lpthread"],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.run_fwd.argtypes = [P] * 8 + [I] * 5 + [F]
    lib.run_dq.argtypes = [P] * 12 + [I] * 5 + [F]
    lib.run_dkv.argtypes = [P] * 11 + [I] * 5 + [F]
    for fn in (lib.run_fwd, lib.run_dq, lib.run_dkv):
        fn.restype = None
    return lib


ROUTE_CPP = r"""
#include "flash_trainable_bf16.cuh"
thread_local dim3 threadIdx, blockIdx, blockDim;
thread_local BlockSync* tl_block;
extern "C" int route(int has_bias, int kh, int kw) {
  return vdr::k6b::bwd_route(has_bias != 0, kh, kw);
}
"""


@pytest.fixture(scope="module")
def route_lib(tmp_path_factory):
    """The bf16 backward's shape predicate (``k6b::bwd_route``) built alone
    under the same stand-in."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the predicate for the CPU")
    d = tmp_path_factory.mktemp("k6_bf16_route")
    (d / "flash_attention_core.cuh").write_text(CORE_H)
    shutil.copy(cuda_build.CSRC_DIR / "flash_trainable_bf16.cuh", d)
    (d / "route.cpp").write_text(ROUTE_CPP)
    so = d / "route.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O0", "-shared", "-fPIC", f"-I{d}", "-o",
         str(so), str(d / "route.cpp"), "-lpthread"],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.route.argtypes = [ctypes.c_int] * 3
    lib.route.restype = ctypes.c_int
    return lib


# (has_bias, Kh, Kw) -> the code of the body the bf16 backward runs: 2 the
# Hopper bodies (TMA + wgmma), 1 the mma.sync bodies, -2 refused
ROUTES = {"sam768": ((1, 48, 48), 2),
          "kw48_kh5": ((1, 5, 48), 2),
          "kw48_kh128": ((1, 128, 48), 2),
          "no_bias": ((0, 0, 0), 2),
          "kw48_kh129": ((1, 129, 48), 1),
          "kw7": ((1, 7, 7), 1),
          "kw14": ((1, 14, 14), 1),
          "kw64": ((1, 64, 64), 1),
          "kw49": ((1, 48, 49), 1),
          "kw48_kh272": ((1, 272, 48), 1),
          "over_320_terms": ((1, 273, 48), -2),
          "kw400": ((1, 1, 400), -2)}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_bwd_route_takes_the_hopper_bodies_at_kw48(route_lib, case):
    """SAM @768's grid (Kh = Kw = 48) and calls with no bias go to the
    Hopper bodies, other key-grid widths (and Kw 48 past 128 grid rows,
    whose bias_h table would not fit dq's shared memory) to the mma.sync
    bodies, and grids of more than 320 terms are refused."""
    args, want = ROUTES[case]
    assert route_lib.route(*args) == want


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _inputs(case):
    b, h, s, kh, kw, kv_len = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))

    def t(*shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32)).to(dtype)

    q, k, v, dout = (t(b, h, s, D) for _ in range(4))
    bh = t(b, h, s, kh, scale=0.5, dtype=torch.float32) if kh else None
    bw = t(b, h, s, kw, scale=0.5, dtype=torch.float32) if kh else None
    kl = torch.tensor(kv_len, dtype=torch.int32) if kv_len else None
    return (q, k, v, bh, bw, kl), dout


def _close(got, want, name, rtol=RTOL, atol=ATOL):
    got, want = got.float(), want.float()
    gap = ((got - want).abs() - rtol * want.abs()).max().item()
    assert torch.isfinite(got).all() and gap <= atol, (name, gap)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_plain(shim, case):
    args, _ = _inputs(case)
    q, k, v, bh, bw, kl = args
    b, h, s, _ = q.shape
    out = torch.full_like(q, float("nan"))
    lse = torch.full((b, h, s), float("nan"))
    shim.run_fwd(*(_ptr(x) for x in args), _ptr(out), _ptr(lse), b, h, s,
                 bh.shape[-1] if bh is not None else 0,
                 bw.shape[-1] if bw is not None else 0, SCALE)
    want_out, want_lse = G.flash_attention_fwd_plain(*args, scale=SCALE)
    _close(out, want_out, "out")
    _close(lse, want_lse, "lse", rtol=0.0, atol=LSE_ATOL)
    if kl is not None and int(kl[0]) == 0:
        assert (lse[0] == -1e30).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_plain(shim, case):
    args, dout = _inputs(case)
    q, k, v, bh, bw, kl = args
    b, h, s, _ = q.shape
    kh = bh.shape[-1] if bh is not None else 0
    kw = bw.shape[-1] if bw is not None else 0
    out, lse = G.flash_attention_fwd_plain(*args, scale=SCALE)
    rest = (dout, lse, G.flash_attention_delta(out, dout))
    dq = torch.full_like(q, float("nan"))
    dk, dv = torch.full_like(k, float("nan")), torch.full_like(v, float("nan"))
    dbh = torch.full_like(bh, float("nan")) if kh else None
    dbw = torch.full_like(bw, float("nan")) if kh else None
    ptrs = [_ptr(x) for x in (*args, *rest)]
    shim.run_dq(*ptrs, _ptr(dq), _ptr(dbh), _ptr(dbw), b, h, s, kh, kw,
                SCALE)
    shim.run_dkv(*ptrs, _ptr(dk), _ptr(dv), b, h, s, kh, kw, SCALE)
    want_dq, want_dbh, want_dbw = G.flash_attention_bwd_dq_plain(
        *args, *rest, scale=SCALE)
    want_dk, want_dv = G.flash_attention_bwd_dkv_plain(*args, *rest,
                                                       scale=SCALE)
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        _close(got, want, name)
    if kh:
        _close(dbh, want_dbh, "dbias_h", rtol=0.0, atol=DBIAS_ATOL)
        _close(dbw, want_dbw, "dbias_w", rtol=0.0, atol=DBIAS_ATOL)
    if kl is not None:
        # keys past a non-zero kv_len get no gradient; a kv_len 0 row's
        # keys all take P = 1
        n = int(kl[1])
        assert not dk[1, :, n:].float().any() and \
            not dv[1, :, n:].float().any()
        if int(kl[0]) == 0:
            assert dv[0].float().abs().max() > 0
