"""The register-tiled fp32 forward of K1, K2, K3 and the K6 forward
(``csrc/f32_tiled_forward.cuh``) run on the CPU against the port's plain
versions.

The body uses CUDA-core instructions only (FMAs, shuffles, barriers and
cp.async), so it also compiles with g++ under a small stand-in for the CUDA
runtime: a block runs as 128 ``std::thread``s, ``__syncthreads`` is a
``std::barrier``, a shuffle goes through a block-wide array between two
barriers, and cp.async is a synchronous copy. That checks the body's
indexing, its masks and its callers' problem builders (``k1_problem``,
``k2_problem``, ``k3_problem``, ``k6_problem`` with K6's split score chains
and its lse store; K3 also in window mode, on the grid of
``window_block``s) at the tile shape and buffer count the four sources ship
with, without the card; one window-mode case also against JAX's kernel in
interpret mode. The card's own checks are in
``tests/test_torch_cuda_kernels.py``.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from vit_deep_radiomics_tpu_torch.ops import attention as A
from vit_deep_radiomics_tpu_torch.ops import attention_grad as G
from vit_deep_radiomics_tpu_torch.utils import cuda_build

RUNTIME_H = r"""
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
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) alignas(n)
struct dim3 { unsigned x = 0, y = 0, z = 0; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
extern thread_local dim3 threadIdx, blockIdx, blockDim;
struct BlockSync {
  std::barrier<> bar;
  float shfl[128];
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
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
typedef void* cudaStream_t;
"""

RUNNER_CPP = r"""
#include "cuda_runtime.h"
#include <thread>
#include <vector>
thread_local dim3 threadIdx, blockIdx, blockDim;
thread_local BlockSync* tl_block;
#include "f32_tiled_forward.cuh"
using namespace vdr::tiled;

// block (x, y, z) runs the problem make(z, y, w) from row row0, (w, row0)
// = window_block(x, win): x the 64-row block outside window mode
template <bool kSplit = false, class Make>
static void run_grid(int gx, int gy, int gz, int kh, int kw, bool bias,
                     Make make, int win = 0) {
  const size_t nf = smem_floats<COLS, STAGES, PINK>(kh, kw);
  for (int z = 0; z < gz; ++z)
    for (int y = 0; y < gy; ++y)
      for (int x = 0; x < gx; ++x) {
        std::vector<float> smem(nf, NAN);
        BlockSync bs(NT);
        std::vector<std::thread> th;
        for (int t = 0; t < NT; ++t)
          th.emplace_back([&, t] {
            threadIdx = {(unsigned)t, 0, 0};
            blockIdx = {(unsigned)x, (unsigned)y, (unsigned)z};
            blockDim = {NT, 1, 1};
            tl_block = &bs;
            const Block blk = window_block(x, win);
            const Problem p = make(z, y, blk.w);
            if (bias)
              forward<COLS, STAGES, PINK, true, kSplit, kSplit>(
                  p, blk.row0, smem.data());
            else
              forward<COLS, STAGES, PINK, false, kSplit, kSplit>(
                  p, blk.row0, smem.data());
          });
        for (auto& t : th) t.join();
      }
}

extern "C" {
void run_k1(const float* q, const float* kv, const float* bh,
            const float* bw, float* out, int B, int S, int H, int T, int kh,
            int kw, float scale_log2) {
  run_grid((T + ROWS - 1) / ROWS, (S / T) * H, B, bh ? kh : 0, bh ? kw : 0,
           bh != nullptr, [&](int b, int y, int) {
             return k1_problem(q, kv, bh, bw, out, S, H, T, kh, kw,
                               scale_log2, b, y / H, y % H);
           });
}
void run_k2(const float* q, const float* kv, const float* bh,
            const float* bw, const int* kv_len, float* out, int B, int S,
            int H, int kh, int kw, float scale_log2) {
  run_grid((S + ROWS - 1) / ROWS, H, B, bh ? kh : 0, bh ? kw : 0,
           bh != nullptr, [&](int b, int h, int) {
             return k2_problem(q, kv, bh, bw, kv_len, out, S, H, kh, kw,
                               scale_log2, b, h);
           });
}
// win > 0: window mode, flash_attention.cu's grid (Sq / win windows of
// ceil(win / ROWS) blocks)
void run_k3(const float* q, const float* k, const float* v, const float* bh,
            const float* bw, const int* kv_len, float* out, int B, int H,
            int Sq, int Sk, int kh, int kw, int khv, int kwv, int win,
            float scale_log2) {
  const int gx = win ? Sq / win * ((win + ROWS - 1) / ROWS)
                     : (Sq + ROWS - 1) / ROWS;
  run_grid(gx, H, B, bh ? kh : 0, bh ? kw : 0, bh != nullptr,
           [&](int b, int h, int w) {
             return k3_problem(q, k, v, bh, bw, kv_len, out, H, Sq, Sk, kh,
                               kw, khv, kwv, SKIP, scale_log2, b, h, win, w);
           }, win);
}
void run_k6(const float* q, const float* k, const float* v, const float* bh,
            const float* bw, const int* kv_len, float* out, float* lse,
            int B, int H, int S, int kh, int kw, float scale_log2) {
  run_grid<true>((S + ROWS - 1) / ROWS, H, B, bh ? kh : 0, bh ? kw : 0,
                 bh != nullptr, [&](int b, int h, int) {
                   return k6_problem(q, k, v, bh, bw, kv_len, out, lse, H,
                                     S, kh, kw, scale_log2, b, h);
                 });
}
}
"""

# cp.async becomes a synchronous copy (zero past the end); the launch
# helpers (CUDA launch syntax) are not needed
_CP_ASYNC = {
    "cp_async16": "if (valid) std::memcpy(dst, src, 16); "
                  "else std::memset(dst, 0, 16);",
    "cp_async4": "if (valid) std::memcpy(dst, src, 4); "
                 "else std::memset(dst, 0, 4);",
    "cp_async_commit": "",
    "cp_async_wait_all": "",
}


def _cpu_core_header(text: str) -> str:
    for name, body in _CP_ASYNC.items():
        text, n = re.subn(
            rf"(void {name}\([^)]*\) \{{).*?\n\}}", rf"\1 {body} }}", text,
            flags=re.S)
        assert n == 1, name
    text, n = re.subn(r"\n(// Launch over .*?\n)?(template <typename Kernel"
                      r"[^\n]*\n)int launch\(.*?\n\}\n", "\n", text,
                      flags=re.S)
    assert n == 1
    text, n = re.subn(r"inline const char\* error_string.*?\n\}\n", "", text,
                      flags=re.S)
    assert n == 1 and "asm" not in text and "<<<" not in text
    return text


def _shipped(source: str) -> dict:
    """The constants a source instantiates the body with (K2 has no
    column skip)."""
    text = (cuda_build.CSRC_DIR / source).read_text()
    found = {name: re.search(rf"constexpr int {name} = (\d+);", text)
             for name in ("kF32Cols", "kF32Stages", "kF32PInK",
                          "kF32SkipCols")}
    return {name: int(m.group(1)) if m else 0 for name, m in found.items()}


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """name -> the body built for the CPU with that source's constants; K3
    also with its column skip turned the other way ("k3_other"), K6 with
    the constants of ``flash_attention_fwd.cu``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the body for the CPU")
    d = tmp_path_factory.mktemp("tiled_shim")
    (d / "cuda_runtime.h").write_text(RUNTIME_H)
    (d / "flash_trainable_core.cuh").write_text(_cpu_core_header(
        (cuda_build.CSRC_DIR / "flash_trainable_core.cuh").read_text()))
    shutil.copy(cuda_build.CSRC_DIR / "f32_tiled_forward.cuh", d)
    (d / "runner.cpp").write_text(RUNNER_CPP)
    libs, procs = {}, {}
    k3 = _shipped("flash_attention.cu")
    for name, c in (("k1", _shipped("fused_window_attention.cu")),
                    ("k2", _shipped("fused_global_attention.cu")),
                    ("k3", k3),
                    ("k3_other", dict(k3, kF32SkipCols=1 - k3[
                        "kF32SkipCols"])),
                    ("k6", _shipped("flash_attention_fwd.cu"))):
        so = d / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", f"-I{d}",
             f"-DCOLS={c['kF32Cols']}", f"-DSTAGES={c['kF32Stages']}",
             f"-DPINK={'true' if c['kF32PInK'] else 'false'}",
             f"-DSKIP={'true' if c['kF32SkipCols'] else 'false'}", "-o",
             str(so), str(d / "runner.cpp"), "-lpthread"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(so))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.run_k1.argtypes = [P] * 5 + [I] * 6 + [F]
        lib.run_k2.argtypes = [P] * 6 + [I] * 5 + [F]
        lib.run_k3.argtypes = [P] * 7 + [I] * 9 + [F]
        lib.run_k6.argtypes = [P] * 8 + [I] * 5 + [F]
        lib.run_k1.restype = lib.run_k2.restype = None
        lib.run_k3.restype = lib.run_k6.restype = None
        libs[name] = lib
    return libs


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale)
                            .astype(np.float32))


HEADS, D = 2, 64
LOG2E = 1.4426950408889634

# K1: (B, windows a batch row, Kh, Kw, bias): SAM's 14 x 14 windows (rows
# ragged at 196 = 3 x 64 + 4, keys in 7 tiles of 32 with 28 slots absent),
# a 7 x 7 window (one 64-row block, two key tiles), and 14 x 14 windows
# without a bias
K1_CASES = {"win_14x14": (2, 2, 14, 14, True),
            "win_7x7": (2, 3, 7, 7, True),
            "win_14x14_no_bias": (1, 2, 14, 14, False)}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_tiled_body_matches_plain(shim, rng, case):
    """K1's fp32 calls on the tiled body (``k1_problem``: one (window,
    head) a problem, read from and written to the fused layouts) against
    ``fused_window_attention_plain``, 2e-5: the fp32 sums' order alone."""
    b, n_win, kh, kw, biased = K1_CASES[case]
    t_win = kh * kw
    s, c = n_win * t_win, HEADS * D
    q, kv = _t(rng, b, s, c), _t(rng, b, s, 2 * c)
    bh = _t(rng, b, HEADS, s, kh, scale=0.5) if biased else None
    bw = _t(rng, b, HEADS, s, kw, scale=0.5) if biased else None
    out = torch.full_like(q, float("nan"))
    shim["k1"].run_k1(_ptr(q), _ptr(kv), _ptr(bh), _ptr(bw), _ptr(out), b, s,
                      HEADS, t_win, kh if biased else 0,
                      kw if biased else 0, D ** -0.5 * LOG2E)
    want = A.fused_window_attention_plain(q, kv, bh, bw, num_heads=HEADS,
                                          window_tokens=t_win,
                                          scale=D ** -0.5)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-5, rtol=0)


# K2: (B, S, Kh, Kw, kv_len): ragged S, key-grid rows of 14, 20 and 64 keys,
# no bias, kv_len with a row that has no valid key, bias and kv_len together
K2_CASES = {"s40_kw20": (1, 40, 2, 20, None),
            "s200_kw20": (2, 200, 10, 20, None),
            "s196_kw14": (1, 196, 14, 14, None),
            "s128_kw64": (1, 128, 2, 64, None),
            "nobias_s200": (2, 200, 0, 0, None),
            "kv_len_zero_row": (2, 200, 0, 0, (0, 150)),
            "bias_kv_len": (2, 60, 3, 20, (0, 31))}


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_tiled_body_matches_plain(shim, rng, case):
    b, s, kh, kw, kv_len = K2_CASES[case]
    c = HEADS * D
    q, kv = _t(rng, b, s, c), _t(rng, b, s, 2 * c)
    bh = _t(rng, b, HEADS, s, kh, scale=0.5) if kh else None
    bw = _t(rng, b, HEADS, s, kw, scale=0.5) if kh else None
    kl = torch.tensor(kv_len, dtype=torch.int32) if kv_len else None
    out = torch.full_like(q, float("nan"))
    shim["k2"].run_k2(_ptr(q), _ptr(kv), _ptr(bh), _ptr(bw), _ptr(kl),
                      _ptr(out), b, s, HEADS, kh, kw, D ** -0.5 * LOG2E)
    want = A.fused_global_attention_plain(q, kv, bh, bw, kl,
                                          num_heads=HEADS, scale=D ** -0.5)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-5, rtol=0)


# K3: (B, Sq, Kh, Kw, kv_grid, kv_len, window_tokens): padded grids whose
# valid columns stop short of Kw (48 of 64; 13 of 20, across tiles), Sq !=
# Sk, kv_len with a row that has no valid key, kv_grid and kv_len together
# (kv_len 20 ends inside a grid row's valid columns, 29 inside its masked
# ones), a kv_grid wider and taller than the grid (nothing masked); window
# mode: two 16 x 16 windows with 14 x 14 valid (SAM's grouped layout: 196
# keys visited of 256), 8 x 8 windows with 7 x 6 valid, unpadded 14 x 14
# windows (196 rows: a ragged last 64-row block) and an odd count of them
K3_CASES = {"grid_3x64_48": (1, 192, 3, 64, (3, 48), None, None),
            "grid_sq100": (1, 100, 3, 64, (2, 48), None, None),
            "grid_5x20_13": (2, 70, 5, 20, (4, 13), None, None),
            "bias_5x20": (1, 64, 5, 20, None, None, None),
            "kv_len_zero_row": (2, 40, 0, 130, None, (0, 3), None),
            "grid_kv_len": (2, 48, 6, 8, (4, 6), (0, 20), None),
            "grid_kv_len_masked_end": (2, 48, 6, 8, (4, 6), (29, 7), None),
            "grid_wider_than_keys": (1, 48, 6, 8, (9, 11), None, None),
            "window_16x16_14x14": (1, 512, 16, 16, (14, 14), None, 256),
            "window_8x8_7x6": (2, 192, 8, 8, (7, 6), None, 64),
            "window_14x14": (1, 392, 14, 14, (14, 14), None, 196),
            "window_14x14_odd": (2, 588, 14, 14, (13, 12), None, 196),
            "window_8x8_wide_grid": (1, 128, 8, 8, (9, 10), None, 64)}


def _k3_inputs(rng, b, sq, kh, kw, kv_len, win):
    sk = sq if win else kh * kw if kh else kw
    q, k, v = _t(rng, b, HEADS, sq, D), _t(rng, b, HEADS, sk, D), \
        _t(rng, b, HEADS, sk, D)
    bh = _t(rng, b, HEADS, sq, kh, scale=0.5) if kh else None
    bw = _t(rng, b, HEADS, sq, kw, scale=0.5) if kh else None
    kl = torch.tensor(kv_len, dtype=torch.int32) if kv_len else None
    return q, k, v, bh, bw, kl


def _run_k3(lib, q, k, v, bh, bw, kl, grid, win):
    b, _, sq, _ = q.shape
    kh, kw = (bh.shape[-1], bw.shape[-1]) if bh is not None else (0, 0)
    out = torch.full_like(q, float("nan"))
    khv, kwv = grid or (0, 0)
    lib.run_k3(_ptr(q), _ptr(k), _ptr(v), _ptr(bh), _ptr(bw), _ptr(kl),
               _ptr(out), b, HEADS, sq, k.shape[2], kh, kw, khv, kwv,
               win or 0, D ** -0.5 * LOG2E)
    return out


@pytest.mark.parametrize("build", ["k3", "k3_other"])
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_tiled_body_matches_plain(shim, rng, case, build):
    """K3's fp32 calls on the tiled body (``k3_problem``; in window mode one
    (batch, window, head) a problem on flash_attention.cu's grid of
    ``window_block``s) against ``flash_attention_plain``, 2e-5: the fp32
    sums' order alone, every query row of a window stored."""
    b, sq, kh, kw, grid, kv_len, win = K3_CASES[case]
    args = _k3_inputs(rng, b, sq, kh, kw, kv_len, win)
    out = _run_k3(shim[build], *args, grid, win)
    want = A.flash_attention_plain(*args, kv_grid=grid, window_tokens=win,
                                   scale=D ** -0.5)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-5, rtol=0)


def test_k3_tiled_window_matches_jax(shim, rng):
    """Window mode on the tiled body (two 8 x 8 windows with 7 x 6 valid, two
    heads, fp32) against JAX's ``flash_attention`` in interpret mode with
    ``window_tokens``, 2e-5."""
    import jax.numpy as jnp

    from vit_deep_radiomics_tpu.ops.attention import flash_attention

    grid, win = (7, 6), 64
    args = _k3_inputs(rng, 1, 2 * win, 8, 8, None, win)
    out = _run_k3(shim["k3"], *args, grid, win)
    want = flash_attention(*(jnp.asarray(t.numpy()) for t in args[:5]),
                           kv_grid=grid, window_tokens=win, block_q=win,
                           block_k=win, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want, np.float32),
                               atol=2e-5, rtol=0)


# K6: (B, S, Kh, Kw, kv_len): SAM's 14 x 14 windows (rows ragged at 196 =
# 3 x 64 + 4, keys in 7 tiles of 32 with 28 slots absent), a 16 x 16 grid,
# and kv_len with a row that has no valid key and a ragged last tile (150
# keys: 4 tiles of 32 and 22)
K6_CASES = {"grid_14x14": (2, 196, 14, 14, None),
            "grid_16x16": (1, 256, 16, 16, None),
            "kv_len_zero_row": (2, 200, 0, 0, (0, 150))}


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_k6_tiled_body_matches_plain(shim, rng, case):
    """The K6 forward on the tiled body (``k6_problem``, the split score
    chains, the lse store) against ``flash_attention_fwd_plain``: out
    within 2e-5 and the log2 lse within 1e-5, the fp32 sums' order alone;
    a kv_len 0 row's lse is -1e30 on both sides, exactly."""
    b, s, kh, kw, kv_len = K6_CASES[case]
    q, k, v = (_t(rng, b, HEADS, s, D) for _ in range(3))
    bh = _t(rng, b, HEADS, s, kh, scale=0.5) if kh else None
    bw = _t(rng, b, HEADS, s, kw, scale=0.5) if kh else None
    kl = torch.tensor(kv_len, dtype=torch.int32) if kv_len else None
    out = torch.full_like(q, float("nan"))
    lse = torch.full((b, HEADS, s), float("nan"))
    shim["k6"].run_k6(_ptr(q), _ptr(k), _ptr(v), _ptr(bh), _ptr(bw),
                      _ptr(kl), _ptr(out), _ptr(lse), b, HEADS, s, kh, kw,
                      D ** -0.5 * LOG2E)
    want_out, want_lse = G.flash_attention_fwd_plain(q, k, v, bh, bw, kl,
                                                     scale=D ** -0.5)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-5,
                               rtol=0)
    if kv_len and kv_len[0] == 0:
        assert torch.equal(lse[0], want_lse[0])
